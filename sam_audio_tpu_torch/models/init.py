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
    ModernBertTextConfig,
    PEAVTransformerConfig,
    PerceptionEncoderConfig,
    SAMAudioConfig,
    SAMAudioJudgeConfig,
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


def dacvae_init(cfg: DACVAEConfig, ini: _Init, with_decoder: bool = True):
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
    if not with_decoder:   # the judge's codec encodes only
        return {"encoder": enc, "in_proj": ini.conv(cfg.latent_dim, 2 * cfg.codebook_dim, 1)}

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


def _peav_layer(cfg: PEAVTransformerConfig, ini: _Init):
    h = cfg.hidden_size
    mlp = int(cfg.mlp_ratio * h)
    return {"ln1": ini.affine(h),
            "attn": {n: ini.linear(h, h) for n in ("wq", "wk", "wv", "wo")},
            "ln2": ini.affine(h),
            "mlp": {"fc1": ini.linear(h, mlp), "fc2": ini.linear(mlp, h)}}


def peav_init(cfg: PEAVTransformerConfig, ini: _Init):
    """models/peav.py's default tree (pre-LN, fc1/fc2 MLP), layers stacked."""
    return {"layers": _stack([_peav_layer(cfg, ini) for _ in range(cfg.num_layers)]),
            "final_norm": ini.affine(cfg.hidden_size)}


def modernbert_init(cfg: ModernBertTextConfig, ini: _Init):
    """models/modernbert.py's tree: bias-free norms, layers a list, no
    attention norm in layer 0."""
    h = cfg.hidden_size

    def layer(i):
        p = {"attn": {"Wqkv": ini.linear(h, 3 * h, False), "Wo": ini.linear(h, h, False)},
             "mlp": {"Wi": ini.linear(h, 2 * cfg.intermediate_size, False),
                     "Wo": ini.linear(cfg.intermediate_size, h, False)},
             "mlp_norm": ini.rms(h)}
        if i:
            p["attn_norm"] = ini.rms(h)
        return p

    return {"embeddings": {"tok_embeddings": {"weight": ini.normal((cfg.vocab_size, h))},
                           "norm": ini.rms(h)},
            "layers": [layer(i) for i in range(cfg.num_hidden_layers)],
            "final_norm": ini.rms(h)}


def judge_init(cfg: SAMAudioJudgeConfig, generator: torch.Generator, device):
    """The judge's tree (models/judge.py), random, fp32: an encoder-only
    DAC-VAE, two PE-AV towers, ModernBERT and the fusion projections."""
    ini = _Init(generator, device)
    h = cfg.transformer.hidden_size
    bn = cfg.bottleneck_dim
    return {
        "audio_codec": dacvae_init(cfg.audio_codec, ini, with_decoder=False),
        "data_proj": ini.linear(cfg.audio_codec.codebook_dim, h),
        "transformer": peav_init(cfg.transformer, ini),
        "finetune_transformer": peav_init(cfg.finetune_transformer, ini),
        "text_model": modernbert_init(cfg.text_model, ini),
        "cat_audio_proj": ini.linear(2 * h, bn),
        "text_proj1": ini.linear(cfg.text_model.hidden_size, h, False),
        "text_proj2": ini.linear(h, bn),
        "layer_norm": ini.affine(bn),
        "proj_audio_and_text": ini.linear(2 * bn, bn),
        "finetune_data_proj": ini.linear(bn, cfg.finetune_transformer.hidden_size),
        "head": ini.linear(cfg.finetune_transformer.hidden_size, 4, False),
        "mean": ini.const((4,), 0.0),
        "std": ini.const((4,), 1.0),
    }


def pe_clip_init(cfg: PerceptionEncoderConfig, generator: torch.Generator, device):
    """models/pe_clip.py's tree (PE-Core CLIP image tower), random, fp32:
    layers stacked, the attentive pool, a bias-free output projection."""
    ini = _Init(generator, device)
    w = cfg.width
    mlp = int(w * cfg.mlp_ratio)
    grid = cfg.image_size // cfg.patch_size
    n_tokens = grid * grid + (1 if cfg.use_cls_token else 0)

    def layer():
        return {"ln1": ini.affine(w),
                "attn": {n: ini.linear(w, w) for n in ("wq", "wk", "wv", "wo")},
                "ln2": ini.affine(w),
                "mlp": {"fc1": ini.linear(w, mlp), "fc2": ini.linear(mlp, w)}}

    return {
        "patch_embed": {"weight": ini.normal((w, 3, cfg.patch_size, cfg.patch_size), 0.02)},
        "cls_token": ini.normal((w,), 0.02),
        "pos_embed": ini.normal((n_tokens, w), 0.02),
        "layers": _stack([layer() for _ in range(cfg.vit_layers)]),
        "ln_post": ini.affine(w),
        "attn_pool": {"probe": ini.normal((1, w), 0.02),
                      **{n: ini.linear(w, w) for n in ("wq", "wk", "wv", "wo")},
                      "ln": ini.affine(w)},
        "proj": ini.linear(w, cfg.dim, bias=False),
    }


def imagebind_init(cfg, generator: torch.Generator, device):
    """The light ImageBind towers' tree (models/imagebind.py ImageBindConfig):
    linear patch embeddings, PE-AV trunks, bias-free projections."""
    ini = _Init(generator, device)

    def branch(patch_in, hidden, layers, heads):
        tf = PEAVTransformerConfig(hidden_size=hidden, num_layers=layers, num_heads=heads)
        return {"patch_embed": ini.linear(patch_in, hidden),
                "transformer": peav_init(tf, ini),
                "proj": ini.linear(hidden, cfg.embed_dim, bias=False)}

    return {"audio": branch(cfg.audio_patch ** 2, cfg.audio_hidden, cfg.audio_layers,
                            cfg.audio_heads),
            "vision": branch(3 * cfg.image_patch ** 2, cfg.vision_hidden, cfg.vision_layers,
                             cfg.vision_heads)}


def imagebind_huge_init(cfg, generator: torch.Generator, device, scale: float = 0.02):
    """imagebind_huge's converted tree (models/imagebind.py
    ImageBindHugeConfig), random, fp32: the audio trunk's blocks carry
    torch-MHA bias_kv and layer scale and its stem a norm; the vision trunk
    is plain pre-LN behind a trunk-level LayerNorm, with a Conv3d stem."""
    ini = _Init(generator, device)

    def trunk(dim, layers, heads, bias_kv, layer_scale):
        tf = PEAVTransformerConfig(hidden_size=dim, num_layers=layers, num_heads=heads,
                                   pos="none", act="gelu", layer_norm_eps=cfg.ln_eps)

        def one():
            p = _peav_layer(tf, ini)
            if bias_kv:
                p["attn"]["bias_k"] = ini.normal((dim,), scale)
                p["attn"]["bias_v"] = ini.normal((dim,), scale)
            if layer_scale:
                p["ls1"] = ini.const((dim,), 1e-4)
                p["ls2"] = ini.const((dim,), 1e-4)
            return p

        return {"layers": _stack([one() for _ in range(layers)])}

    gh = (cfg.n_mels - cfg.audio_kernel) // cfg.audio_stride + 1
    gw = (cfg.target_frames - cfg.audio_kernel) // cfg.audio_stride + 1
    g = cfg.image_size // cfg.vision_patch
    audio = {
        "stem": {"weight": ini.normal((cfg.audio_dim, 1, cfg.audio_kernel, cfg.audio_kernel),
                                      scale)},
        "stem_norm": ini.affine(cfg.audio_dim),
        "cls_token": ini.normal((1, 1, cfg.audio_dim), scale),
        "pos_embed": ini.normal((1, gh * gw + 1, cfg.audio_dim), scale),
        "trunk": trunk(cfg.audio_dim, cfg.audio_layers, cfg.audio_heads, True, True),
        "head_norm": ini.affine(cfg.audio_dim),
        "head_proj": {"weight": ini.normal((cfg.embed_dim, cfg.audio_dim), scale)},
    }
    vision = {
        "stem": {"weight": ini.normal((cfg.vision_dim, 3, cfg.vision_frames, cfg.vision_patch,
                                       cfg.vision_patch), scale)},
        "cls_token": ini.normal((1, 1, cfg.vision_dim), scale),
        "pos_embed": ini.normal((1, g * g + 1, cfg.vision_dim), scale),
        "pre_ln": ini.affine(cfg.vision_dim),
        "trunk": trunk(cfg.vision_dim, cfg.vision_layers, cfg.vision_heads, False, False),
        "head_norm": ini.affine(cfg.vision_dim),
        "head_proj": {"weight": ini.normal((cfg.embed_dim, cfg.vision_dim), scale)},
    }
    return {"audio": audio, "vision": vision}


def span_predictor_init(cfg, generator: torch.Generator, device):
    """models/span_predictor.py's native tree (SpanPredictorConfig), random,
    fp32: pre-LN layers stacked on axis 0, each with RoPE self-attention,
    cross-attention and a bias-free SwiGLU FFN of 4 x hidden."""
    ini = _Init(generator, device)
    h = cfg.hidden

    def layer():
        return {"ln1": ini.affine(h),
                "self_attn": {n: ini.linear(h, h) for n in ("wq", "wk", "wv", "wo")},
                "ln_cross": ini.affine(h),
                "cross_attn": {n: ini.linear(h, h) for n in ("wq", "wk", "wv", "wo")},
                "ln2": ini.affine(h),
                "mlp": {"w1": ini.linear(h, 4 * h, False), "w2": ini.linear(4 * h, h, False),
                        "w3": ini.linear(h, 4 * h, False)}}

    return {"audio_embed": ini.linear(cfg.audio_dim, h),
            "text_embed": ini.linear(cfg.text_dim, h),
            "layers": _stack([layer() for _ in range(cfg.n_layers)]),
            "final_norm": ini.affine(h),
            "head": ini.linear(h, 1)}


def peaudioframe_init(cfg, generator: torch.Generator, device):
    """A PEAudioFrame tree (the layout convert.convert_peaudioframe_state_dict
    gives), random, fp32: peav_init's tower of cfg.transformer(), the token
    embedding, the latent projection and the frame head."""
    ini = _Init(generator, device)
    return {"transformer": peav_init(cfg.transformer(), ini),
            "text_embed": {"weight": ini.normal((cfg.vocab_size, cfg.hidden))},
            "data_proj": ini.linear(cfg.audio_dim, cfg.hidden),
            "head": ini.linear(cfg.hidden, 1)}


def center_span_head(predictors, logits, mask, scale: float = 1.0) -> float:
    """For random span heads, whose logits may put every frame on one side of
    the threshold or many next to it: scale each predictor's head by `scale`
    and shift its bias so that the middle third of the valid frames straddles
    the threshold (0 in logits) at the widest gap between neighbouring sorted
    logits. `logits` (numpy, (B, T)) are the heads' output before the change,
    `mask` their valid frames; every predictor gets the same change (new
    tensors: the old ones may share memory with another tree). Returns the
    shift."""
    import numpy as np

    s = np.sort(np.asarray(logits)[np.asarray(mask, bool)] * scale)
    lo, hi = len(s) // 3, 2 * len(s) // 3
    i = lo + int(np.argmax(s[lo + 1: hi + 1] - s[lo: hi]))
    shift = float(s[i] + s[i + 1]) / 2
    for p in predictors:
        head = p.params["head"]
        head["weight"] = head["weight"] * scale
        head["bias"] = head["bias"] * scale - shift
    return shift
