"""Random weights for a configuration, made on the device from the seed.

The tree has the layout the program's checkpoints use (nested dicts; layers
of the DiT, T5 and the vision tower stacked on a leading axis; codec blocks
in lists), so the same tree feeds the program under test and the plain
reference. Every leaf is drawn from one of two large draws (one uniform, one
normal) of a `torch.Generator` on the device and then copied out, so the
draws cost a few calls and the big buffers are freed at once.

Leaf rules: linear and conv weights and biases uniform in +-1/sqrt(fan_in)
(torch's default range; a transposed conv's fan is out * k); in the codec
the convs outside the residual units (all but the decoder's last) times
`init.codec_trunk_gain` and every bias zero with `init.codec_zero_bias`
(a codec driven by its input, not by its biases); norm weights 1
and biases 0, Snake alphas 1, the DiT's adaLN tables normal with the
configuration's `init.adaln_table_std`, embeddings and T5's relative bias
normal(0, 1), the vision tower's patch, class, position and probe tensors
normal(0, 0.02), the gates as the configuration states. A text ranker's
tree follows the same rules, drawn from seed + 2 by its kind's module
(portbench/harness/rankers/).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from portbench.harness.flops import ffn_hidden

# A leaf spec: ("u", shape, bound) uniform in +-bound, ("n", shape, std)
# normal, ("c", shape, value) constant.


def _linear(i: int, o: int, bias: bool = True, stack: Tuple[int, ...] = ()):
    s = 1.0 / math.sqrt(i)
    p = {"weight": ("u", (*stack, o, i), s)}
    if bias:
        p["bias"] = ("u", (*stack, o), s)
    return p


def _conv(i: int, o: int, k: int, bias: bool = True, gain: float = 1.0,
          zero_bias: bool = False):
    s = 1.0 / math.sqrt(i * k)
    p = {"weight": ("u", (o, i, k), gain * s)}
    if bias:
        p["bias"] = ("c", (o,), 0.0) if zero_bias else ("u", (o,), s)
    return p


def _conv_t(i: int, o: int, k: int, gain: float = 1.0, zero_bias: bool = False):
    s = 1.0 / math.sqrt(o * k)
    return {"weight": ("u", (i, o, k), gain * s),
            "bias": ("c", (o,), 0.0) if zero_bias else ("u", (o,), s)}


def _rms(d: int, stack=()):
    return {"weight": ("c", (*stack, d), 1.0)}


def _affine(d: int, stack=()):
    return {"weight": ("c", (*stack, d), 1.0), "bias": ("c", (*stack, d), 0.0)}


def _snake(c: int):
    return {"alpha": ("c", (1, c, 1), 1.0)}


def dit_spec(tf: dict, adaln_std: float):
    dim, n, heads = tf["dim"], tf["n_layers"], tf["n_heads"]
    hd = dim // heads
    L = (n,)
    bias = tf["fc_bias"]

    def attention():
        p = {k: _linear(dim, heads * hd, bias, L) for k in ("wq", "wk", "wv")}
        p["wo"] = _linear(heads * hd, dim, bias, L)
        if tf["qk_norm"]:
            p["q_norm"] = _rms(hd, L)
            p["k_norm"] = _rms(hd, L)
        return p

    hidden = ffn_hidden(tf)
    ff = {"w1": _linear(dim, hidden, bias, L), "w2": _linear(hidden, dim, bias, L)}
    if tf["non_linearity"] == "swiglu":
        ff["w3"] = _linear(dim, hidden, bias, L)

    def projection(i, o, nl):
        p = {"w1": _linear(i, o, bias), "w2": _linear(o, o, bias)}
        if nl == "swiglu":
            p["w3"] = _linear(i, o, bias)
        return p

    def conv_block(i, o):
        return {"groupnorm": _affine(i), "project": _conv(i, o, 3)}

    spec = {
        "layers": {"attention": attention(), "cross_attention": attention(),
                   "feed_forward": ff, "attention_norm": _rms(dim, L),
                   "ffn_norm": _rms(dim, L),
                   "scale_shift_table": ("n", (n, 6, dim), adaln_std)},
        "norm": _rms(dim),
        "output": _linear(dim, tf["out_channels"], bias),
        "x_embedder": {"block1": conv_block(dim, dim), "block2": conv_block(dim, dim)},
        "y_embedder": {"projection": projection(tf["context_dim"], dim,
                                                tf["context_non_linearity"])},
        "t_embedder": {"projection": projection(tf["frequency_embedding_dim"], dim,
                                                tf["timestep_non_linearity"])},
        "t_block": _linear(dim, 6 * dim, tf["t_block_bias"]),
        "final_layer_scale_shift_table": ("n", (2, dim), adaln_std),
    }
    if tf["context_norm"]:
        spec["y_embedder"]["norm"] = _rms(tf["context_dim"])
    if tf.get("in_channels") is not None:
        spec["data_proj"] = _linear(tf["in_channels"], dim)
    return spec


def t5_spec(t5: dict):
    inner = t5["num_heads"] * t5["head_dim"]
    L = (t5["num_layers"],)
    d = t5["dim"]
    return {
        "token_embedding": {"weight": ("n", (t5["vocab_size"], d), 1.0)},
        "relative_attention_bias": {"weight": ("n", (t5["relative_attention_num_buckets"],
                                                     t5["num_heads"]), 1.0)},
        "blocks": {"attn": {"q": _linear(d, inner, False, L), "k": _linear(d, inner, False, L),
                            "v": _linear(d, inner, False, L), "o": _linear(inner, d, False, L),
                            "layer_norm": _rms(d, L)},
                   "ff": {"wi": _linear(d, t5["d_ff"], False, L),
                          "wo": _linear(t5["d_ff"], d, False, L),
                          "layer_norm": _rms(d, L)}},
        "final_layer_norm": _rms(d),
    }


def codec_spec(c: dict, trunk_gain: float = 1.0, zero_bias: bool = False):
    """The DAC-VAE tree. `trunk_gain` scales the convs outside the residual
    units (but the decoder's last) and `zero_bias` zeroes every bias, so that
    the codec passes its input on instead of a bias-driven offset."""
    def conv(i, o, k, gain=trunk_gain):
        return _conv(i, o, k, gain=gain, zero_bias=zero_bias)

    def res_unit(d):
        return {"snake1": _snake(d), "conv1": conv(d, d, 7, 1.0),
                "snake2": _snake(d), "conv2": conv(d, d, 1, 1.0)}

    d = c["encoder_dim"]
    enc = {"conv_in": conv(1, d, 7), "blocks": []}
    for stride in c["encoder_rates"]:
        enc["blocks"].append({"res": [res_unit(d) for _ in range(3)], "snake": _snake(d),
                              "conv": conv(d, 2 * d, 2 * stride)})
        d *= 2
    enc["snake_out"] = _snake(d)
    enc["conv_out"] = conv(d, c["latent_dim"], 3)
    d = c["decoder_dim"]
    dec = {"conv_in": conv(c["latent_dim"], d, 7), "blocks": []}
    for stride in c["decoder_rates"]:
        dec["blocks"].append({"snake": _snake(d),
                              "conv_t": _conv_t(d, d // 2, 2 * stride, trunk_gain, zero_bias),
                              "res": [res_unit(d // 2) for _ in range(3)]})
        d //= 2
    dec["snake_out"] = _snake(d)
    dec["conv_out"] = conv(d, 1, 7, 1.0)
    return {"encoder": enc, "in_proj": conv(c["latent_dim"], 2 * c["codebook_dim"], 1),
            "out_proj": conv(c["codebook_dim"], c["latent_dim"], 1), "decoder": dec}


def sam_audio_spec(cfg: dict):
    init = cfg.get("init", {})
    dim = cfg["transformer"]["dim"]
    return {
        "audio_codec": codec_spec(cfg["audio_codec"], float(init.get("codec_trunk_gain", 1.0)),
                                  bool(init.get("codec_zero_bias", False))),
        "transformer": dit_spec(cfg["transformer"], float(init.get("adaln_table_std", 0.5))),
        "proj": _linear(cfg["in_channels"], dim),
        "align_masked_video": {"conv": _linear(cfg["vision_encoder"]["dim"], dim),
                               "layer_norm": _affine(dim),
                               "gate": ("c", (1,), float(init.get("align_masked_video_gate", 0.0)))},
        "embed_anchors": {"embed": {"weight": ("n", (cfg["num_anchors"] + 1,
                                                    cfg["anchor_embedding_dim"]), 1.0)},
                          "gate": ("c", (1,), float(init.get("embed_anchors_gate", 0.0))),
                          "proj": _linear(cfg["anchor_embedding_dim"], dim, False)},
        "memory_proj": _linear(cfg["text_encoder"]["dim"], dim),
        "text_encoder": t5_spec(cfg["text_encoder"]),
    }


def pe_spec(ve: dict):
    w = ve["width"]
    mlp = int(w * ve["mlp_ratio"])
    L = (ve["vit_layers"],)
    grid = ve["image_size"] // ve["patch_size"]
    n_tokens = grid * grid + (1 if ve["use_cls_token"] else 0)
    p = ve["patch_size"]
    return {
        "patch_embed": {"weight": ("n", (w, 3, p, p), 0.02)},
        "cls_token": ("n", (w,), 0.02),
        "pos_embed": ("n", (n_tokens, w), 0.02),
        "layers": {"ln1": _affine(w, L),
                   "attn": {k: _linear(w, w, True, L) for k in ("wq", "wk", "wv", "wo")},
                   "ln2": _affine(w, L),
                   "mlp": {"fc1": _linear(w, mlp, True, L), "fc2": _linear(mlp, w, True, L)}},
        "ln_post": _affine(w),
        "attn_pool": {"probe": ("n", (1, w), 0.02),
                      **{k: _linear(w, w) for k in ("wq", "wk", "wv", "wo")},
                      "ln": _affine(w)},
        "proj": _linear(w, ve["dim"], False),
    }


def _leaves(spec, prefix=""):
    if isinstance(spec, dict):
        return [kv for k in spec for kv in _leaves(spec[k], f"{prefix}{k}/")]
    if isinstance(spec, list):
        return [kv for i, v in enumerate(spec) for kv in _leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], spec)]


def _build(spec, values: Dict[str, torch.Tensor], prefix=""):
    if isinstance(spec, dict):
        return {k: _build(v, values, f"{prefix}{k}/") for k, v in spec.items()}
    if isinstance(spec, list):
        return [_build(v, values, f"{prefix}{i}/") for i, v in enumerate(spec)]
    return values[prefix[:-1]]


def materialize(spec, seed: int, device, dtype=torch.float32):
    """The tree of `spec` with values drawn from `seed` on `device`: one
    uniform and one normal draw over all leaves, each leaf copied out."""
    leaves = _leaves(spec)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    sizes = {"u": 0, "n": 0}
    for _, (kind, shape, _) in leaves:
        if kind in sizes:
            sizes[kind] += math.prod(shape)
    draws = {"u": torch.rand(sizes["u"], generator=gen, device=device, dtype=dtype),
             "n": torch.randn(sizes["n"], generator=gen, device=device, dtype=dtype)}
    offsets = {"u": 0, "n": 0}
    values: Dict[str, torch.Tensor] = {}
    for path, (kind, shape, arg) in leaves:
        if kind == "c":
            values[path] = torch.full(shape, float(arg), device=device, dtype=dtype)
            continue
        n = math.prod(shape)
        raw = draws[kind][offsets[kind]: offsets[kind] + n].view(shape)
        offsets[kind] += n
        values[path] = (raw * (2 * arg) - arg) if kind == "u" else raw * arg
    del draws
    return _build(spec, values)


def sam_audio_weights(cfg: dict, seed: int, device) -> dict:
    tree = materialize(sam_audio_spec(cfg), seed, device)
    # the padding slot of the anchor vocabulary (<pad> = num_anchors) embeds to zero
    tree["embed_anchors"]["embed"]["weight"][cfg["num_anchors"]] = 0.0
    return tree


def pe_weights(cfg: dict, seed: int, device) -> dict:
    return materialize(pe_spec(cfg["vision_encoder"]), seed + 1, device)

