"""Random parameter initialisation, from a seeded `torch.Generator`.

Builds the same tree (names, shapes, layer stacking) as the JAX package's
`*_init` functions (sam_audio_tpu/models/*.py, ops/nn.py, ops/conv.py), with
torch's default Linear/Conv1d ranges. The numbers differ from JAX's; a test
that compares the two stacks bridges one tree through
checkpoint.params_from_numpy instead.
"""

from __future__ import annotations

import math

import torch

from sam_audio_tpu_torch.config import (
    DACVAEConfig,
    SAMAudioConfig,
    T5EncoderConfig,
    TransformerConfig,
)


class _Init:
    def __init__(self, generator: torch.Generator, device, dtype=torch.float32):
        self.g, self.device, self.dtype = generator, device, dtype

    def uniform(self, shape, scale):
        u = torch.rand(shape, generator=self.g, device=self.device, dtype=self.dtype)
        return u * (2 * scale) - scale

    def normal(self, shape, std=1.0):
        return torch.randn(shape, generator=self.g, device=self.device,
                           dtype=self.dtype) * std

    def const(self, shape, value):
        return torch.full(shape, float(value), device=self.device, dtype=self.dtype)

    def linear(self, i, o, bias=True):
        s = 1.0 / math.sqrt(i)
        p = {"weight": self.uniform((o, i), s)}
        if bias:
            p["bias"] = self.uniform((o,), s)
        return p

    def conv(self, i, o, k, bias=True):
        s = 1.0 / math.sqrt(i * k)
        p = {"weight": self.uniform((o, i, k), s)}
        if bias:
            p["bias"] = self.uniform((o,), s)
        return p

    def conv_t(self, i, o, k):
        s = 1.0 / math.sqrt(o * k)
        return {"weight": self.uniform((i, o, k), s), "bias": self.uniform((o,), s)}

    def rms(self, d):
        return {"weight": self.const((d,), 1.0)}

    def affine(self, d):  # layernorm / groupnorm
        return {"weight": self.const((d,), 1.0), "bias": self.const((d,), 0.0)}

    def snake(self, c):
        return {"alpha": self.const((1, c, 1), 1.0)}

    def projection(self, i, o, non_linearity, bias):
        p = {"w1": self.linear(i, o, bias), "w2": self.linear(o, o, bias)}
        if non_linearity == "swiglu":
            p["w3"] = self.linear(i, o, bias)
        return p


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def dit_init(cfg: TransformerConfig, ini: _Init):
    hd, dim = cfg.head_dim, cfg.dim

    def attention():
        p = {n: ini.linear(dim, cfg.n_heads * hd, cfg.fc_bias)
             for n in ("wq", "wk", "wv")}
        p["wo"] = ini.linear(cfg.n_heads * hd, dim, cfg.fc_bias)
        if cfg.qk_norm:
            p["q_norm"] = ini.rms(hd)
            p["k_norm"] = ini.rms(hd)
        return p

    def block():
        hidden = cfg.ffn_hidden_dim
        ff = {"w1": ini.linear(dim, hidden, cfg.fc_bias),
              "w2": ini.linear(hidden, dim, cfg.fc_bias)}
        if cfg.non_linearity == "swiglu":
            ff["w3"] = ini.linear(dim, hidden, cfg.fc_bias)
        return {
            "attention": attention(), "cross_attention": attention(),
            "feed_forward": ff,
            "attention_norm": ini.rms(dim), "ffn_norm": ini.rms(dim),
            "scale_shift_table": ini.normal((6, dim), 1.0 / math.sqrt(dim)),
        }

    def conv_block(i, o):
        return {"groupnorm": ini.affine(i), "project": ini.conv(i, o, 3)}

    p = {
        "layers": _stack([block() for _ in range(cfg.n_layers)]),
        "norm": ini.rms(dim),
        "output": ini.linear(dim, cfg.out_channels, cfg.fc_bias),
        "x_embedder": {"block1": conv_block(dim, dim), "block2": conv_block(dim, dim)},
        "y_embedder": {"projection": ini.projection(
            cfg.context_dim, dim, cfg.context_non_linearity, cfg.fc_bias)},
        "t_embedder": {"projection": ini.projection(
            cfg.frequency_embedding_dim, dim, cfg.timestep_non_linearity,
            cfg.fc_bias)},
        "t_block": ini.linear(dim, 6 * dim, cfg.t_block_bias),
        "final_layer_scale_shift_table": ini.normal((2, dim), 1.0 / math.sqrt(dim)),
    }
    if cfg.context_norm:
        p["y_embedder"]["norm"] = ini.rms(cfg.context_dim)
    if cfg.in_channels is not None:
        p["data_proj"] = ini.linear(cfg.in_channels, dim)
    return p


def _t5_init(cfg: T5EncoderConfig, ini: _Init):
    inner = cfg.num_heads * cfg.head_dim

    def block():
        return {
            "attn": {"q": ini.linear(cfg.dim, inner, False),
                     "k": ini.linear(cfg.dim, inner, False),
                     "v": ini.linear(cfg.dim, inner, False),
                     "o": ini.linear(inner, cfg.dim, False),
                     "layer_norm": ini.rms(cfg.dim)},
            "ff": {"wi": ini.linear(cfg.dim, cfg.d_ff, False),
                   "wo": ini.linear(cfg.d_ff, cfg.dim, False),
                   "layer_norm": ini.rms(cfg.dim)},
        }

    return {
        "token_embedding": {"weight": ini.normal((cfg.vocab_size, cfg.dim))},
        "relative_attention_bias": {"weight": ini.normal(
            (cfg.relative_attention_num_buckets, cfg.num_heads))},
        "blocks": _stack([block() for _ in range(cfg.num_layers)]),
        "final_layer_norm": ini.rms(cfg.dim),
    }


def t5_encoder_init(cfg: T5EncoderConfig, generator: torch.Generator, device):
    return _t5_init(cfg, _Init(generator, device))


def dacvae_init(cfg: DACVAEConfig, ini: _Init):
    def res_unit(d):
        return {"snake1": ini.snake(d), "conv1": ini.conv(d, d, 7),
                "snake2": ini.snake(d), "conv2": ini.conv(d, d, 1)}

    d = cfg.encoder_dim
    enc = {"conv_in": ini.conv(1, d, 7), "blocks": []}
    for stride in cfg.encoder_rates:
        enc["blocks"].append({"res": [res_unit(d) for _ in range(3)],
                              "snake": ini.snake(d),
                              "conv": ini.conv(d, 2 * d, 2 * stride)})
        d *= 2
    enc["snake_out"] = ini.snake(d)
    enc["conv_out"] = ini.conv(d, cfg.latent_dim, 3)

    d = cfg.decoder_dim
    dec = {"conv_in": ini.conv(cfg.latent_dim, d, 7), "blocks": []}
    for stride in cfg.decoder_rates:
        dec["blocks"].append({"snake": ini.snake(d),
                              "conv_t": ini.conv_t(d, d // 2, 2 * stride),
                              "res": [res_unit(d // 2) for _ in range(3)]})
        d //= 2
    dec["snake_out"] = ini.snake(d)
    dec["conv_out"] = ini.conv(d, 1, 7)
    return {
        "encoder": enc,
        "in_proj": ini.conv(cfg.latent_dim, 2 * cfg.codebook_dim, 1),
        "out_proj": ini.conv(cfg.codebook_dim, cfg.latent_dim, 1),
        "decoder": dec,
    }


def htsat_init(cfg, ini: _Init):
    """models/htsat.py's tree: stages and their blocks are lists."""
    from sam_audio_tpu_torch.ops.mel import mel_filterbank

    def block(c, nh):
        return {"norm1": ini.affine(c), "qkv": ini.linear(c, 3 * c),
                "proj": ini.linear(c, c),
                "relative_position_bias_table": ini.normal(
                    ((2 * cfg.window_size - 1) ** 2, nh), 0.02),
                "norm2": ini.affine(c), "fc1": ini.linear(c, int(c * cfg.mlp_ratio)),
                "fc2": ini.linear(int(c * cfg.mlp_ratio), c)}

    fb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax,
                        mel_scale="slaney", norm="slaney")
    p = {"melW": torch.as_tensor(fb, device=ini.device),
         "bn0": {"weight": ini.const((cfg.n_mels,), 1.0), "bias": ini.const((cfg.n_mels,), 0.0),
                 "mean": ini.const((cfg.n_mels,), 0.0), "var": ini.const((cfg.n_mels,), 1.0)},
         "patch_embed": {"proj": {"weight": ini.normal((cfg.embed_dim, 1, cfg.patch_size,
                                                        cfg.patch_size), 0.02),
                                  "bias": ini.const((cfg.embed_dim,), 0.0)},
                         "norm": ini.affine(cfg.embed_dim)},
         "stages": [],
         "norm": ini.affine(cfg.out_dim)}
    for li, depth in enumerate(cfg.depths):
        c = cfg.embed_dim * 2 ** li
        stage = {"blocks": [block(c, cfg.num_heads[li]) for _ in range(depth)]}
        if li < len(cfg.depths) - 1:
            stage["downsample"] = {"norm": ini.affine(4 * c),
                                   "reduction": ini.linear(4 * c, 2 * c, bias=False)}
        p["stages"].append(stage)
    return p


def roberta_init(cfg, ini: _Init):
    """models/roberta.py's tree, layers stacked on axis 0."""
    h, m = cfg.hidden_size, cfg.intermediate_size

    def layer():
        return {"attn": {n: ini.linear(h, h) for n in ("wq", "wk", "wv", "wo")},
                "attn_ln": ini.affine(h), "fc1": ini.linear(h, m),
                "fc2": ini.linear(m, h), "ffn_ln": ini.affine(h)}

    return {"word_embeddings": {"weight": ini.normal((cfg.vocab_size, h))},
            "position_embeddings": {"weight": ini.normal((cfg.max_position_embeddings, h))},
            "token_type_embeddings": {"weight": ini.normal((cfg.type_vocab_size, h))},
            "emb_ln": ini.affine(h),
            "layers": _stack([layer() for _ in range(cfg.num_layers)]),
            "pooler": ini.linear(h, h)}


def clap_init(cfg, generator: torch.Generator, device):
    """The CLAP scorer's tree (models/clap.py), random, fp32."""
    ini = _Init(generator, device)

    def mlp(i, o):
        return {"fc1": ini.linear(i, o), "fc2": ini.linear(o, o)}

    return {"audio_branch": htsat_init(cfg.htsat, ini),
            "text_branch": roberta_init(cfg.roberta, ini),
            "audio_projection": mlp(cfg.htsat.out_dim, cfg.embed_dim),
            "text_projection": mlp(cfg.text_hidden, cfg.embed_dim),
            "logit_scale_a": ini.const((), math.log(1 / 0.07)),
            "logit_scale_t": ini.const((), math.log(1 / 0.07))}


def sam_audio_init(cfg: SAMAudioConfig, generator: torch.Generator, device):
    """The full SAMAudio parameter tree (fp32), random."""
    ini = _Init(generator, device)
    dim = cfg.transformer.dim
    embed = ini.normal((cfg.num_anchors + 1, cfg.anchor_embedding_dim))
    embed[cfg.num_anchors] = 0.0  # padding_idx row
    return {
        "audio_codec": dacvae_init(cfg.audio_codec, ini),
        "transformer": dit_init(cfg.transformer, ini),
        "proj": ini.linear(cfg.in_channels, dim),
        "align_masked_video": {"conv": ini.linear(cfg.vision_encoder.dim, dim),
                               "layer_norm": ini.affine(dim),
                               "gate": ini.const((1,), 0.0)},
        "embed_anchors": {"embed": {"weight": embed},
                          "gate": ini.const((1,), 0.0),
                          "proj": ini.linear(cfg.anchor_embedding_dim, dim, False)},
        "memory_proj": ini.linear(cfg.text_encoder.dim, dim),
        "text_encoder": _t5_init(cfg.text_encoder, ini),
    }
