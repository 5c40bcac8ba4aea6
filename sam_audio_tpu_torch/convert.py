"""Reference checkpoints -> the parameter trees of the port.

Counterpart of the converters of the JAX package (sam_audio_tpu/checkpoint.py,
models/{clap,htsat,roberta,modernbert,pe_clip,imagebind,span_predictor}.py): a torch state
dict (`checkpoint.pt`, or a tower's own `.pt`) becomes the nested tree of
numpy arrays that `checkpoint.params_from_numpy` takes and that the JAX
package's `save_params` / `load_params` write and read. Numpy only: the same
keys, the same storage conventions (layers stacked on axis 0, weight norm
folded, DiT attention heads permuted to the contiguous split, RoPE q/k
channels deinterleaved), and dtypes as the JAX converters give them (float64
stored as float32, int64 as int32).

One difference in the last bit: the weight-norm fold w = g * v / ||v|| sums
||v||^2 in float64 and rounds once, where XLA sums in float32 in an order
numpy cannot reproduce; folded weights agree with the JAX package's to a
couple of float32 ulps, every other leaf bit for bit.

Command line (the towers the port has; no hub, no network):

    python -m sam_audio_tpu_torch.convert --snapshot DIR --out DIR [--t5 T5.pt]
    python -m sam_audio_tpu_torch.convert --judge --snapshot DIR --out DIR
    python -m sam_audio_tpu_torch.convert clap --torch 630k-best.pt --out clap.npz
    python -m sam_audio_tpu_torch.convert imagebind --torch imagebind_huge.pth \\
        --out imagebind.npz
    python -m sam_audio_tpu_torch.convert pe-clip --torch PE-Core-L14-336.pt \\
        --out pe_clip.npz
    python -m sam_audio_tpu_torch.convert span-predictor --torch pe-a-frame-large.pt \\
        --out SNAPSHOT/span_predictor
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys
from typing import Dict, Optional

import numpy as np

# Towers intentionally absent from checkpoint.pt (reference model.py:352-355).
SKIP_REGEX = re.compile(r"(^text_encoder|^visual_ranker|^text_ranker|^span_predictor)")


def _arr(x) -> np.ndarray:
    """A state-dict value as the JAX package stores it (jnp.asarray without
    64-bit mode): float64 -> float32, int64 -> int32."""
    x = np.asarray(x)
    if x.dtype == np.float64:
        return x.astype(np.float32)
    if x.dtype == np.int64:
        return x.astype(np.int32)
    if x.dtype == np.uint64:
        return x.astype(np.uint32)
    return x


def _stack_layer_trees(layers):
    """Stack N per-layer trees leaf-wise onto a leading layer axis."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack_layer_trees([t[k] for t in layers]) for k in first}
    return np.stack(layers)


class _TrackedStateDict(dict):
    """A state dict that records the keys the converters read, so that the
    full-model conversion can check coverage: a renamed or extra module in
    checkpoint.pt must fail loudly, not be dropped. A key counts as read when
    it is indexed, fetched with get(), tested with `in`, or yielded by
    items(), keys(), values() or iteration. `subdict(prefix)` is the view of
    the keys under one prefix, sharing the record, for converters that read
    a tower by iterating over it."""

    def __init__(self, sd, accessed: Optional[set] = None, prefix: str = ""):
        super().__init__(sd)
        self.accessed = set() if accessed is None else accessed
        self._prefix = prefix

    def _read(self, k):
        self.accessed.add(self._prefix + k)

    def __getitem__(self, k):
        self._read(k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        self._read(k)
        return super().get(k, default)

    def __contains__(self, k):
        self._read(k)
        return super().__contains__(k)

    def __iter__(self):
        for k in super().__iter__():
            self._read(k)
            yield k

    def keys(self):
        return list(iter(self))

    def values(self):
        return [v for _, v in self.items()]

    def items(self):
        out = []
        for k, v in super().items():
            self._read(k)
            out.append((k, v))
        return out

    def all_keys(self):
        """The keys, not counted as read (for probing a layout)."""
        return list(super().keys())

    def subdict(self, prefix: str) -> "_TrackedStateDict":
        """The keys under `prefix`, with the prefix stripped."""
        return _TrackedStateDict(
            {k[len(prefix):]: v for k, v in super().items() if k.startswith(prefix)},
            self.accessed, self._prefix + prefix)


def _keys(sd):
    return sd.all_keys() if isinstance(sd, _TrackedStateDict) else list(sd)


def _under(sd, prefix: str) -> Dict[str, np.ndarray]:
    """{key with `prefix` stripped: array} of the keys under `prefix`."""
    if isinstance(sd, _TrackedStateDict):
        return {k: _arr(v) for k, v in sd.subdict(prefix).items()}
    return {k[len(prefix):]: _arr(v) for k, v in sd.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# Conversion helpers (sam_audio_tpu/checkpoint.py:117-238)
# ---------------------------------------------------------------------------


def fold_weight_norm(weight_g, weight_v, dim: int = 0) -> np.ndarray:
    """w = g * v / ||v|| with the norm over all axes but `dim`
    (torch.nn.utils.weight_norm); ||v||^2 is summed in float64."""
    g, v = _arr(weight_g), _arr(weight_v)
    axes = tuple(i for i in range(v.ndim) if i != dim)
    norm = np.sqrt(np.sum(np.square(v.astype(np.float64)), axis=axes, keepdims=True))
    return g * v / norm.astype(v.dtype)


def _get(sd, key: str) -> np.ndarray:
    """A weight, plain (`key`.weight) or weight-normed (weight_g / weight_v,
    or torch >= 2.1's parametrizations)."""
    if f"{key}.weight" in sd:
        return _arr(sd[f"{key}.weight"])
    if f"{key}.weight_v" in sd:
        return fold_weight_norm(sd[f"{key}.weight_g"], sd[f"{key}.weight_v"])
    if f"{key}.parametrizations.weight.original0" in sd:
        return fold_weight_norm(sd[f"{key}.parametrizations.weight.original0"],
                                sd[f"{key}.parametrizations.weight.original1"])
    raise KeyError(key)


def _linear(sd, key, bias=True):
    p = {"weight": _get(sd, key)}
    if bias and f"{key}.bias" in sd:
        p["bias"] = _arr(sd[f"{key}.bias"])
    return p


def _conv(sd, key):
    return _linear(sd, key, bias=True)


def _norm(sd, key, bias=False):
    p = {"weight": _arr(sd[f"{key}.weight"])}
    if bias and f"{key}.bias" in sd:
        p["bias"] = _arr(sd[f"{key}.bias"])
    return p


def _snake(sd, key):
    return {"alpha": _arr(sd[f"{key}.alpha"])}


def permute_attention_heads(weight: np.ndarray, n_heads: int) -> np.ndarray:
    """The reference splits heads stridedly (reshape(B, T, C // H, H),
    transformer.py:121-126): torch out-channel j*H + h is our channel
    h*D + j. Permutes the projection rows."""
    out_dim, in_dim = weight.shape
    d = out_dim // n_heads
    return weight.reshape(d, n_heads, in_dim).transpose(1, 0, 2).reshape(out_dim, in_dim)


def rope_deinterleave_perm(head_dim: int) -> np.ndarray:
    """Moves interleaved rotary pairs (2i, 2i+1) to split halves (i, i + D/2)."""
    return np.concatenate([np.arange(0, head_dim, 2), np.arange(1, head_dim, 2)])


def deinterleave_qk_heads(x: np.ndarray, n_heads: int) -> np.ndarray:
    """Per head, interleaved rotary pairs to split halves, the layout
    ops.rope.apply_rope_half rotates; applied alike to q and k (rows, biases
    and q/k-norm weights), so the attention scores are unchanged.
    x: (H*D, ...) or (H*D,)."""
    d = x.shape[0] // n_heads
    xh = x.reshape(n_heads, d, *x.shape[1:])
    return xh[:, rope_deinterleave_perm(d)].reshape(x.shape)


def _attention(sd, prefix, n_heads, qk_norm=True, rope_deinterleave=False):
    p = {}
    for name in ("wq", "wk", "wv"):
        w = permute_attention_heads(_get(sd, f"{prefix}.{name}"), n_heads)
        if rope_deinterleave and name in ("wq", "wk"):
            w = deinterleave_qk_heads(w, n_heads)
        p[name] = {"weight": w}
        if f"{prefix}.{name}.bias" in sd:
            b = _arr(sd[f"{prefix}.{name}.bias"])
            b = b.reshape(b.shape[0] // n_heads, n_heads).T.reshape(-1)
            if rope_deinterleave and name in ("wq", "wk"):
                b = deinterleave_qk_heads(b, n_heads)
            p[name]["bias"] = b
    p["wo"] = _linear(sd, f"{prefix}.wo")
    if qk_norm and f"{prefix}.q_norm.weight" in sd:
        p["q_norm"] = _norm(sd, f"{prefix}.q_norm")
        p["k_norm"] = _norm(sd, f"{prefix}.k_norm")
        if rope_deinterleave:   # per head-dim channel weights
            for nm in ("q_norm", "k_norm"):
                w = p[nm]["weight"]
                p[nm]["weight"] = w[rope_deinterleave_perm(w.shape[0])]
    return p


def _projection(sd, prefix):
    p = {"w1": _linear(sd, f"{prefix}.w1"), "w2": _linear(sd, f"{prefix}.w2")}
    if f"{prefix}.w3.weight" in sd:
        p["w3"] = _linear(sd, f"{prefix}.w3")
    return p


def _conv_block(sd, prefix):
    return {"groupnorm": _norm(sd, f"{prefix}.groupnorm", bias=True),
            "project": _conv(sd, f"{prefix}.project")}


def _patcher(sd, prefix):
    p = {"block1": _conv_block(sd, f"{prefix}.block.block1"),
         "block2": _conv_block(sd, f"{prefix}.block.block2")}
    if f"{prefix}.block.to_out.weight" in sd:
        p["to_out"] = _conv(sd, f"{prefix}.block.to_out")
    return p


# ---------------------------------------------------------------------------
# SAM-Audio: DiT, DAC-VAE, conditioning (checkpoint.py:246-429)
# ---------------------------------------------------------------------------


def convert_dit(sd, cfg, prefix="transformer"):
    """cfg: TransformerConfig."""
    layers = []
    for i in range(cfg.n_layers):
        lp = f"{prefix}.layers.{i}"
        layers.append({
            # self-attention carries RoPE: q/k deinterleaved for split-half rotary
            "attention": _attention(sd, f"{lp}.attention", cfg.n_heads, cfg.qk_norm,
                                    rope_deinterleave=True),
            "cross_attention": _attention(sd, f"{lp}.cross_attention", cfg.n_heads,
                                          cfg.qk_norm),
            "feed_forward": _projection(sd, f"{lp}.feed_forward"),
            "attention_norm": _norm(sd, f"{lp}.attention_norm"),
            "ffn_norm": _norm(sd, f"{lp}.ffn_norm"),
            "scale_shift_table": _arr(sd[f"{lp}.scale_shift_table"]),
        })
    p = {
        "layers": _stack_layer_trees(layers),
        "norm": _norm(sd, f"{prefix}.norm"),
        "output": _linear(sd, f"{prefix}.output"),
        "x_embedder": _patcher(sd, f"{prefix}.x_embedder"),
        "y_embedder": {"projection": _projection(sd, f"{prefix}.y_embedder.projection")},
        "t_embedder": {"projection": _projection(sd, f"{prefix}.t_embedder.projection")},
        "t_block": _linear(sd, f"{prefix}.t_block"),
        "final_layer_scale_shift_table": _arr(sd[f"{prefix}.final_layer_scale_shift_table"]),
    }
    if f"{prefix}.y_embedder.norm.weight" in sd:
        p["y_embedder"]["norm"] = _norm(sd, f"{prefix}.y_embedder.norm")
    if f"{prefix}.data_proj.weight" in sd:
        p["data_proj"] = _linear(sd, f"{prefix}.data_proj")
    return p


def _residual_unit(sd, prefix):
    return {"snake1": _snake(sd, f"{prefix}.block.0"), "conv1": _conv(sd, f"{prefix}.block.1"),
            "snake2": _snake(sd, f"{prefix}.block.2"), "conv2": _conv(sd, f"{prefix}.block.3")}


def _seq_prefix(sd, base: str) -> str:
    """The Descript-DAC Sequential attribute: `block` (encoder) or `model`
    (decoder); either spelling is accepted. Probing counts no key as read."""
    keys = _keys(sd)
    for name in ("block", "model"):
        probe = f"{base}.{name}.0."
        if any(k.startswith(probe) for k in keys):
            return f"{base}.{name}"
    raise KeyError(f"No Sequential container found under {base}.(block|model)")


def _proj_conv(sd, key):
    """VAE in/out projection: Conv1d k=1 (3-D) or Linear (2-D), both to our
    (out, in, 1) conv layout."""
    p = _linear(sd, key, bias=True)
    if p["weight"].ndim == 2:
        p["weight"] = p["weight"][..., None]
    return p


def convert_dacvae(sd, cfg, prefix="audio_codec", with_decoder=True):
    """cfg: DACVAEConfig. Encoder: <seq>.0 conv_in, <seq>.1..n EncoderBlocks,
    <seq>.n+1 Snake, <seq>.n+2 conv_out; the decoder mirrors it."""
    n_enc = len(cfg.encoder_rates)
    eb = _seq_prefix(sd, f"{prefix}.encoder")
    enc = {"conv_in": _conv(sd, f"{eb}.0"), "blocks": []}
    for i in range(n_enc):
        bp = f"{eb}.{1 + i}.block"
        enc["blocks"].append({"res": [_residual_unit(sd, f"{bp}.{j}") for j in range(3)],
                              "snake": _snake(sd, f"{bp}.3"), "conv": _conv(sd, f"{bp}.4")})
    enc["snake_out"] = _snake(sd, f"{eb}.{n_enc + 1}")
    enc["conv_out"] = _conv(sd, f"{eb}.{n_enc + 2}")
    p = {"encoder": enc, "in_proj": _proj_conv(sd, f"{prefix}.quantizer.in_proj")}
    if with_decoder:
        n_dec = len(cfg.decoder_rates)
        db = _seq_prefix(sd, f"{prefix}.decoder")
        dec = {"conv_in": _conv(sd, f"{db}.0"), "blocks": []}
        for i in range(n_dec):
            bp = f"{db}.{1 + i}.block"
            dec["blocks"].append({"snake": _snake(sd, f"{bp}.0"),
                                  "conv_t": _conv(sd, f"{bp}.1"),
                                  "res": [_residual_unit(sd, f"{bp}.{2 + j}")
                                          for j in range(3)]})
        dec["snake_out"] = _snake(sd, f"{db}.{n_dec + 1}")
        dec["conv_out"] = _conv(sd, f"{db}.{n_dec + 2}")
        p["out_proj"] = _proj_conv(sd, f"{prefix}.quantizer.out_proj")
        p["decoder"] = dec
    return p


def convert_conditioning(sd, cfg):
    """Everything of the SAMAudio state dict but the codec: the DiT and the
    conditioning heads (reference model.py:84-93)."""
    return {
        "transformer": convert_dit(sd, cfg.transformer, "transformer"),
        "proj": _linear(sd, "proj"),
        "align_masked_video": {
            # reference align.py:17-19: Conv1d k=1 == Linear
            "conv": {"weight": _get(sd, "align_masked_video.conv")[..., 0],
                     "bias": _arr(sd["align_masked_video.conv.bias"])},
            "layer_norm": _norm(sd, "align_masked_video.layer_norm", bias=True),
            "gate": _arr(sd["align_masked_video.gate"]),
        },
        "embed_anchors": {
            "embed": {"weight": _arr(sd["embed_anchors.embed.weight"])},
            "gate": _arr(sd["embed_anchors.gate"]),
            "proj": _linear(sd, "embed_anchors.proj"),
        },
        "memory_proj": _linear(sd, "memory_proj"),
    }


def convert_sam_audio_state_dict(sd, cfg, strict: bool = True):
    """checkpoint.pt state dict -> the SAMAudio tree (cfg: SAMAudioConfig).
    With `strict` (default) it raises if a key is neither read by the
    converters nor matched by SKIP_REGEX (towers that load from their own
    repos, reference model.py:352-355)."""
    tracked = _TrackedStateDict(sd)
    params = {"audio_codec": convert_dacvae(tracked, cfg.audio_codec, "audio_codec")}
    params.update(convert_conditioning(tracked, cfg))
    if strict:
        unused = sorted(k for k in sd if k not in tracked.accessed and not SKIP_REGEX.match(k))
        if unused:
            raise ValueError(
                f"convert_sam_audio_state_dict: {len(unused)} checkpoint key(s) were not "
                f"read by the converter and do not match the tower skip policy; a renamed "
                f"or extra module would be dropped. First offenders: {unused[:20]}. Fix the "
                f"layout mapping or pass strict=False to ignore them.")
    return params


def convert_t5_state_dict(sd, cfg):
    """HF T5EncoderModel state dict -> the T5 tree (HF splits heads
    contiguously; no permutation)."""
    blocks = []
    for i in range(cfg.num_layers):
        bp = f"encoder.block.{i}"
        blocks.append({
            "attn": {n: _linear(sd, f"{bp}.layer.0.SelfAttention.{n}", bias=False)
                     for n in ("q", "k", "v", "o")}
            | {"layer_norm": _norm(sd, f"{bp}.layer.0.layer_norm")},
            "ff": {"wi": _linear(sd, f"{bp}.layer.1.DenseReluDense.wi", bias=False),
                   "wo": _linear(sd, f"{bp}.layer.1.DenseReluDense.wo", bias=False),
                   "layer_norm": _norm(sd, f"{bp}.layer.1.layer_norm")},
        })
    emb_key = "shared.weight" if "shared.weight" in sd else "encoder.embed_tokens.weight"
    return {
        "token_embedding": {"weight": _arr(sd[emb_key])},
        "relative_attention_bias": {"weight": _arr(
            sd["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"])},
        "blocks": _stack_layer_trees(blocks),
        "final_layer_norm": _norm(sd, "encoder.final_layer_norm"),
    }


def split_fused_qkv(weight, bias=None):
    """A fused (3*dim, dim) qkv projection (nn.MultiheadAttention in_proj,
    timm qkv) -> {"wq", "wk", "wv"} linears."""
    wq, wk, wv = np.split(_arr(weight), 3, axis=0)
    out = {"wq": {"weight": wq}, "wk": {"weight": wk}, "wv": {"weight": wv}}
    if bias is not None:
        bq, bk, bv = np.split(_arr(bias), 3, axis=0)
        out["wq"]["bias"], out["wk"]["bias"], out["wv"]["bias"] = bq, bk, bv
    return out


# ---------------------------------------------------------------------------
# PE-AV towers (layout sniffing; checkpoint.py:490-732) and the judge
# ---------------------------------------------------------------------------

_PEAV_LAYER_RE = re.compile(
    r"^((?:encoder\.)?(?:transformer\.)?(?:layers|layer|blocks|resblocks|h))\.(\d+)\.")
# (q, k, v, out) projection names relative to a layer root
_PEAV_ATTN_SCHEMES = [
    ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.out_proj"),
    ("attn.q_proj", "attn.k_proj", "attn.v_proj", "attn.out_proj"),
    ("attention.q_proj", "attention.k_proj", "attention.v_proj", "attention.out_proj"),
    ("attention.wq", "attention.wk", "attention.wv", "attention.wo"),
    ("attn.wq", "attn.wk", "attn.wv", "attn.wo"),
    ("attention.self.query", "attention.self.key", "attention.self.value",
     "attention.output.dense"),
]
_PEAV_FUSED_SCHEMES = [("attn.qkv", "attn.proj"), ("attn.Wqkv", "attn.Wo"),
                       ("self_attn.qkv_proj", "self_attn.out_proj")]
# (ln1, ln2, prenorm)
_PEAV_NORM_SCHEMES = [
    ("ln_1", "ln_2", True), ("norm1", "norm2", True), ("norm_1", "norm_2", True),
    ("layer_norm1", "layer_norm2", True), ("self_attn_layer_norm", "final_layer_norm", True),
    ("attention_norm", "ffn_norm", True), ("input_layernorm", "post_attention_layernorm", True),
    ("attention.output.LayerNorm", "output.LayerNorm", False),
]
# 2-tuple = fc1/fc2 (+ the config's activation), 3-tuple = swiglu gate/down/up
_PEAV_MLP_SCHEMES = [
    ("mlp.fc1", "mlp.fc2"), ("fc1", "fc2"), ("mlp.c_fc", "mlp.c_proj"), ("mlp.lin1", "mlp.lin2"),
    ("intermediate.dense", "output.dense"), ("feed_forward.w1", "feed_forward.w2",
                                              "feed_forward.w3"),
    ("mlp.w1", "mlp.w2", "mlp.w3"), ("mlp.gate_proj", "mlp.down_proj", "mlp.up_proj"),
    ("feed_forward.gate_proj", "feed_forward.down_proj", "feed_forward.up_proj"),
]
_PEAV_POS_KEYS = ["pos_embed", "positional_embedding", "pos_emb", "embed_positions.weight",
                  "pos_embedding"]
_PEAV_PRE_NORM_KEYS = ["ln_pre", "layernorm_embedding", "norm_pre", "emb_ln"]
_PEAV_FINAL_NORM_KEYS = ["final_layer_norm", "final_norm", "norm", "ln_post", "ln_final",
                         "layer_norm", "encoder.final_layer_norm", "encoder.norm",
                         "encoder.layer_norm"]
# recomputed buffers: consumed, never reported as unconverted
_PEAV_IGNORE_RE = re.compile(r"(position_ids|attn\.bias|attn\.masked_bias|num_batches_tracked)$")
# rotary buffers: recomputed too, but they switch the tower to "rope"
_PEAV_ROTARY_RE = re.compile(r"(rotary.*\.inv_freq|\binv_freq|freqs_cis)$")


def convert_peav_tower(sd, prefix: str, cfg, arch_overrides: Optional[Dict[str, str]] = None):
    """A perception-models PE-AV `Transformer` state dict (reference
    judge.py:46-47) -> the canonical PE-AV tree, sniffing the block naming
    (fairseq/HF q_proj, timm fused qkv, CLIP resblocks/in_proj, llama
    wq/swiglu, BERT post-LN). Returns (params, arch, unconverted): `arch`
    holds the sniffed PEAVTransformerConfig switches; `unconverted` the keys
    under `prefix` that did not map. A bias-free LayerNorm and an RMSNorm
    have the same keys and are sniffed as rmsnorm; `arch_overrides` (e.g.
    {"norm": "layernorm"}) wins over the sniffing."""
    sub = _under(sd, prefix)
    consumed = set()

    def have(k):
        return k in sub

    def take(k):
        consumed.add(k)
        return sub[k]

    def take_linear(base):
        p = {"weight": take(f"{base}.weight")}
        if have(f"{base}.bias"):
            p["bias"] = take(f"{base}.bias")
        return p

    container, n_layers = None, 0
    for k in sub:
        m = _PEAV_LAYER_RE.match(k)
        if m:
            container = m.group(1)
            n_layers = max(n_layers, int(m.group(2)) + 1)
    if container is None:
        raise ValueError(f"no transformer layer keys under {prefix!r}")

    arch = {"prenorm": True, "act": getattr(cfg, "act", "gelu_tanh"),
            "pos": getattr(cfg, "pos", "sinusoidal")}
    layers = []
    for i in range(n_layers):
        L = f"{container}.{i}"
        lp = {}
        attn = None
        for qn, kn, vn, on in _PEAV_ATTN_SCHEMES:
            if have(f"{L}.{qn}.weight"):
                attn = {"wq": take_linear(f"{L}.{qn}"), "wk": take_linear(f"{L}.{kn}"),
                        "wv": take_linear(f"{L}.{vn}"), "wo": take_linear(f"{L}.{on}")}
                break
        if attn is None:
            for qkvn, on in _PEAV_FUSED_SCHEMES:
                if have(f"{L}.{qkvn}.weight"):
                    attn = split_fused_qkv(take(f"{L}.{qkvn}.weight"),
                                           take(f"{L}.{qkvn}.bias")
                                           if have(f"{L}.{qkvn}.bias") else None)
                    attn["wo"] = take_linear(f"{L}.{on}")
                    break
        if attn is None and have(f"{L}.attn.in_proj_weight"):   # torch MHA (CLIP)
            attn = split_fused_qkv(take(f"{L}.attn.in_proj_weight"),
                                   take(f"{L}.attn.in_proj_bias")
                                   if have(f"{L}.attn.in_proj_bias") else None)
            attn["wo"] = take_linear(f"{L}.attn.out_proj")
        if attn is None:
            raise ValueError(f"unrecognized attention layout in {prefix}{L}")
        for norm_name, slot in (("q_norm", "q_norm"), ("k_norm", "k_norm"),
                                ("q_ln", "q_norm"), ("k_ln", "k_norm")):
            for root in ("attn", "self_attn", "attention"):
                if have(f"{L}.{root}.{norm_name}.weight"):
                    attn[slot] = take_linear(f"{L}.{root}.{norm_name}")
        lp["attn"] = attn

        norms = None
        for n1, n2, prenorm in _PEAV_NORM_SCHEMES:
            if have(f"{L}.{n1}.weight"):
                norms = (take_linear(f"{L}.{n1}"), take_linear(f"{L}.{n2}"))
                arch["prenorm"] = prenorm
                break
        if norms is None:
            raise ValueError(f"unrecognized layer norms in {prefix}{L}")
        lp["ln1"], lp["ln2"] = norms
        # an affine bias means LayerNorm; a bare scale RMSNorm
        arch["norm"] = "layernorm" if "bias" in norms[0] else "rmsnorm"

        mlp = None
        for scheme in _PEAV_MLP_SCHEMES:
            if have(f"{L}.{scheme[0]}.weight"):
                if len(scheme) == 2:
                    mlp = {"fc1": take_linear(f"{L}.{scheme[0]}"),
                           "fc2": take_linear(f"{L}.{scheme[1]}")}
                else:
                    mlp = {"w1": take_linear(f"{L}.{scheme[0]}"),
                           "w2": take_linear(f"{L}.{scheme[1]}"),
                           "w3": take_linear(f"{L}.{scheme[2]}")}
                    arch["act"] = "swiglu"
                break
        if mlp is None:
            raise ValueError(f"unrecognized MLP layout in {prefix}{L}")
        lp["mlp"] = mlp

        for ls_name, slot in (("ls1.gamma", "ls1"), ("ls2.gamma", "ls2"),
                              ("gamma_1", "ls1"), ("gamma_2", "ls2"),
                              ("layer_scale_gamma1", "ls1"), ("layer_scale_gamma2", "ls2")):
            if have(f"{L}.{ls_name}"):
                lp[slot] = take(f"{L}.{ls_name}").reshape(-1)
        # torch MHA add_bias_kv: a learned key/value token (ImageBind's audio trunk)
        for bkv in ("bias_k", "bias_v"):
            for root in ("attn", "self_attn"):
                if have(f"{L}.{root}.{bkv}"):
                    lp["attn"][bkv] = take(f"{L}.{root}.{bkv}").reshape(-1)
        layers.append(lp)

    params = {"layers": _stack_layer_trees(layers)}
    for key in _PEAV_POS_KEYS:
        if have(key):   # a raw nn.Parameter table
            params["pos_embed"] = take(key)
            arch["pos"] = "learned"
            break
        if have(f"{key}.weight"):   # an nn.Embedding table
            params["pos_embed"] = take(f"{key}.weight")
            arch["pos"] = "learned"
            break
    for key in _PEAV_PRE_NORM_KEYS:
        if have(f"{key}.weight"):
            params["ln_pre"] = take_linear(key)
            break
    for key in _PEAV_FINAL_NORM_KEYS:
        if have(f"{key}.weight"):
            params["final_norm"] = take_linear(key)
            break

    # rotary buffers mean a RoPE tower; theta from inv_freq[i] = theta^(-2i/d)
    rope_keys = [k for k in sub if k not in consumed and _PEAV_ROTARY_RE.search(k)]
    if rope_keys and arch["pos"] != "learned":
        arch["pos"] = "rope"
        inv_key = next((k for k in rope_keys if k.endswith("inv_freq")), None)
        if inv_key is not None:
            inv = sub[inv_key].reshape(-1)
            if inv.size >= 2 and 0.0 < float(inv[1]) < 1.0:
                arch["rope_theta"] = float(inv[1] ** (-(2 * inv.size) / 2.0))
    consumed.update(rope_keys)
    consumed.update(k for k in sub if k not in consumed and _PEAV_IGNORE_RE.search(k))
    unconverted = sorted(prefix + k for k in sub if k not in consumed)
    if arch_overrides:
        arch.update(arch_overrides)
    return params, arch, unconverted


def convert_modernbert_state_dict(sd, cfg, prefix=""):
    """HF ModernBertModel state dict -> the ModernBERT tree (layers a list).
    `prefix` e.g. 'text_model.'."""
    def g(k):
        return _arr(sd[prefix + k])

    layers = []
    for i in range(cfg.num_hidden_layers):
        lp = f"layers.{i}"
        layer = {"attn": {"Wqkv": {"weight": g(f"{lp}.attn.Wqkv.weight")},
                          "Wo": {"weight": g(f"{lp}.attn.Wo.weight")}},
                 "mlp": {"Wi": {"weight": g(f"{lp}.mlp.Wi.weight")},
                         "Wo": {"weight": g(f"{lp}.mlp.Wo.weight")}},
                 "mlp_norm": {"weight": g(f"{lp}.mlp_norm.weight")}}
        if i != 0:
            layer["attn_norm"] = {"weight": g(f"{lp}.attn_norm.weight")}
        layers.append(layer)
    return {"embeddings": {"tok_embeddings": {"weight": g("embeddings.tok_embeddings.weight")},
                           "norm": {"weight": g("embeddings.norm.weight")}},
            "layers": layers,
            "final_norm": {"weight": g("final_norm.weight")}}


def convert_judge_state_dict(sd, cfg, return_arch: bool = False,
                             arch_overrides: Optional[Dict[str, str]] = None):
    """Reference SAMAudioJudgeModel state dict -> the judge tree (cfg:
    SAMAudioJudgeConfig; reference judge.py:39-72). Returns (params,
    unconverted), and with return_arch also {tower: sniffed arch} for the
    PEAVTransformerConfig switches."""
    tower, tower_arch, tower_left = convert_peav_tower(sd, "transformer.", cfg.transformer,
                                                       arch_overrides)
    ft, ft_arch, ft_left = convert_peav_tower(sd, "finetune_transformer.",
                                              cfg.finetune_transformer, arch_overrides)
    params = {
        "transformer": tower,
        "finetune_transformer": ft,
        "audio_codec": convert_dacvae(sd, cfg.audio_codec, "audio_codec", with_decoder=False),
        "data_proj": _linear(sd, "data_proj"),
        "text_model": convert_modernbert_state_dict(sd, cfg.text_model, prefix="text_model."),
        "cat_audio_proj": _linear(sd, "cat_audio_proj"),
        "text_proj1": _linear(sd, "text_proj1", bias=False),
        "text_proj2": _linear(sd, "text_proj2"),
        "layer_norm": _norm(sd, "layer_norm", bias=True),
        "proj_audio_and_text": _linear(sd, "proj_audio_and_text"),
        "finetune_data_proj": _linear(sd, "finetune_data_proj"),
        "head": _linear(sd, "head", bias=False),
        "mean": _arr(sd["mean"]),
        "std": _arr(sd["std"]),
    }
    unconverted = sorted(tower_left + ft_left)
    if return_arch:
        return params, unconverted, {"transformer": tower_arch,
                                     "finetune_transformer": ft_arch}
    return params, unconverted


def convert_peaudioframe_state_dict(sd, cfg):
    """A PEAudioFrame checkpoint (reference model.py:96-102) -> the tree of
    models/span_predictor.peaudioframe_forward (cfg: PEAudioFrameConfig;
    JAX: models/span_predictor.py:250-293). The transformer is sniffed by
    `convert_peav_tower` under the first prefix that holds one; the token
    embedding, the latent projection and the frame head are matched by
    their common names. Returns (params, arch, unconverted)."""
    sd = {k[7:] if k.startswith("module.") else k: np.asarray(v) for k, v in sd.items()}
    consumed = set()

    def lin(base):
        p = {"weight": _arr(sd[f"{base}.weight"])}
        consumed.add(f"{base}.weight")
        if f"{base}.bias" in sd:
            p["bias"] = _arr(sd[f"{base}.bias"])
            consumed.add(f"{base}.bias")
        return p

    def find(names):
        return next((n for n in names if f"{n}.weight" in sd), None)

    for prefix in ("transformer.", "audio_encoder.", "encoder.", "model.", ""):
        try:
            tower, arch, left = convert_peav_tower(sd, prefix, cfg)
            break
        except (ValueError, KeyError):
            continue
    else:
        raise ValueError("no PE-AV transformer tower found in the state dict")
    consumed |= {k for k in sd if k.startswith(prefix)} - set(left)
    params = {"transformer": tower}
    for slot, names in (
            ("text_embed", ("text_embed", "token_embedding", "embed_tokens", "text_embedding",
                            "word_embeddings", "text_encoder.embed_tokens")),
            ("data_proj", ("data_proj", "input_proj", "audio_proj", "in_proj", "proj")),
            ("head", ("head", "frame_head", "classifier", "span_head", "fc_out"))):
        base = find(names)
        if base:
            params[slot] = lin(base)
    return params, arch, sorted(set(sd) - consumed)


# ---------------------------------------------------------------------------
# The CLAP ranker's towers (models/{clap,htsat,roberta}.py of the JAX package)
# ---------------------------------------------------------------------------


def convert_htsat_state_dict(sd, cfg, prefix: str = ""):
    """laion_clap HTSAT_Swin_Transformer state dict -> the HTSAT tree. The
    STFT conv buffers, relative_position_index and attn_mask buffers are
    recomputed; the token-semantic head is kept. Returns (params,
    consumed_keys)."""
    consumed = set()

    def g(k):
        consumed.add(prefix + k)
        return _arr(sd[prefix + k])

    def have(k):
        return prefix + k in sd

    def lin(base, bias=True):
        p = {"weight": g(f"{base}.weight")}
        if bias and have(f"{base}.bias"):
            p["bias"] = g(f"{base}.bias")
        return p

    def ln(base):
        return {"weight": g(f"{base}.weight"), "bias": g(f"{base}.bias")}

    params = {
        "melW": g("logmel_extractor.melW"),
        "bn0": {"weight": g("bn0.weight"), "bias": g("bn0.bias"),
                "mean": g("bn0.running_mean"), "var": g("bn0.running_var")},
        "patch_embed": {"proj": lin("patch_embed.proj"), "norm": ln("patch_embed.norm")},
        "stages": [],
        "norm": ln("norm"),
    }
    for li, depth in enumerate(cfg.depths):
        stage = {"blocks": []}
        for j in range(depth):
            B = f"layers.{li}.blocks.{j}"
            stage["blocks"].append({
                "norm1": ln(f"{B}.norm1"), "qkv": lin(f"{B}.attn.qkv"),
                "proj": lin(f"{B}.attn.proj"),
                "relative_position_bias_table": g(f"{B}.attn.relative_position_bias_table"),
                "norm2": ln(f"{B}.norm2"), "fc1": lin(f"{B}.mlp.fc1"),
                "fc2": lin(f"{B}.mlp.fc2"),
            })
            for buf in (f"{B}.attn.relative_position_index", f"{B}.attn_mask"):
                if have(buf):
                    consumed.add(prefix + buf)
        if li < len(cfg.depths) - 1:
            stage["downsample"] = {"norm": ln(f"layers.{li}.downsample.norm"),
                                   "reduction": lin(f"layers.{li}.downsample.reduction",
                                                    bias=False)}
        params["stages"].append(stage)
    if have("tscam_conv.weight"):
        params["tscam_conv"] = lin("tscam_conv")
    if have("head.weight"):
        params["head"] = lin("head")
    for buf in ("spectrogram_extractor.stft.conv_real.weight",
                "spectrogram_extractor.stft.conv_imag.weight", "bn0.num_batches_tracked"):
        if have(buf):
            consumed.add(prefix + buf)
    return params, consumed


def convert_roberta_state_dict(sd, cfg, prefix: str = "", consumed=None):
    """HF RobertaModel state dict -> the RoBERTa tree (layers stacked).
    `consumed`, a set, records the keys read."""
    def g(k):
        if consumed is not None:
            consumed.add(prefix + k)
        return _arr(sd[prefix + k])

    def lin(base):
        p = {"weight": g(f"{base}.weight")}
        if f"{prefix}{base}.bias" in sd:
            p["bias"] = g(f"{base}.bias")
        return p

    def ln(base):
        return {"weight": g(f"{base}.weight"), "bias": g(f"{base}.bias")}

    layers = []
    for i in range(cfg.num_layers):
        L = f"encoder.layer.{i}"
        layers.append({
            "attn": {"wq": lin(f"{L}.attention.self.query"), "wk": lin(f"{L}.attention.self.key"),
                     "wv": lin(f"{L}.attention.self.value"),
                     "wo": lin(f"{L}.attention.output.dense")},
            "attn_ln": ln(f"{L}.attention.output.LayerNorm"),
            "fc1": lin(f"{L}.intermediate.dense"),
            "fc2": lin(f"{L}.output.dense"),
            "ffn_ln": ln(f"{L}.output.LayerNorm"),
        })
    params = {
        "word_embeddings": {"weight": g("embeddings.word_embeddings.weight")},
        "position_embeddings": {"weight": g("embeddings.position_embeddings.weight")},
        "token_type_embeddings": {"weight": g("embeddings.token_type_embeddings.weight")},
        "emb_ln": ln("embeddings.LayerNorm"),
        "layers": _stack_layer_trees(layers),
    }
    if f"{prefix}pooler.dense.weight" in sd:
        params["pooler"] = lin("pooler.dense")
    return params


def convert_clap_state_dict(sd, cfg):
    """laion_clap CLAP state dict -> the CLAP tree (cfg: models.clap.ClapConfig).
    Strips DDP's 'module.' prefix and the stale position_ids buffer
    (reference clap.py:23-27). Returns (params, unconverted)."""
    sd = {k[7:] if k.startswith("module.") else k: v for k, v in sd.items()}
    sd.pop("text_branch.embeddings.position_ids", None)
    audio, consumed = convert_htsat_state_dict(sd, cfg.htsat, prefix="audio_branch.")
    text = convert_roberta_state_dict(sd, cfg.roberta, prefix="text_branch.", consumed=consumed)

    def lin(base):
        consumed.update((f"{base}.weight", f"{base}.bias"))
        return {"weight": _arr(sd[f"{base}.weight"]), "bias": _arr(sd[f"{base}.bias"])}

    params = {
        "audio_branch": audio,
        "text_branch": text,
        "audio_projection": {"fc1": lin("audio_projection.0"), "fc2": lin("audio_projection.2")},
        "text_projection": {"fc1": lin("text_projection.0"), "fc2": lin("text_projection.2")},
    }
    for scale in ("logit_scale_a", "logit_scale_t"):
        if scale in sd:
            params[scale] = _arr(sd[scale])
            consumed.add(scale)
    # laion_clap's text_transform MLP is not on the RoBERTa path; kept so
    # that nothing is dropped without a word
    extras = {k: _arr(sd[k]) for k in sd if k.startswith("text_transform.")}
    if extras:
        params["text_transform_unused"] = extras
        consumed |= set(extras)
    return params, sorted(k for k in sd if k not in consumed)


# ---------------------------------------------------------------------------
# The visual towers: PE-Core CLIP (models/pe_clip.py:190-309) and
# imagebind_huge (models/imagebind.py:572-654)
# ---------------------------------------------------------------------------


def convert_pe_clip_state_dict(sd, cfg, prefix: str = "visual."):
    """PE-Core CLIP image-tower state dict -> the PE tree (reference
    vision_encoder.py:86-90 builds pe.CLIP.from_config("PE-Core-L14-336")).
    Sniffs CLIP/open_clip naming (conv1, class_embedding,
    positional_embedding, transformer.resblocks through convert_peav_tower,
    ln_post, attn_pool, proj) and timm aliases. cfg:
    PerceptionEncoderConfig. Returns (params, unconverted)."""
    from sam_audio_tpu_torch.config import PEAVTransformerConfig

    sub = _under(sd, prefix)
    if not sub:   # the tower is not nested under `visual.`
        sub = {k: _arr(v) for k, v in sd.items()}
        prefix = ""
    consumed = set()

    def g(k):
        consumed.add(k)
        return sub[k]

    def first(*cands):
        return next((c for c in cands if c in sub), None)

    params = {}
    stem = first("conv1.weight", "patch_embed.proj.weight", "patchify.weight")
    if stem is None:
        raise ValueError("no patch-embed conv in the PE-CLIP state dict")
    params["patch_embed"] = {"weight": g(stem)}
    bias = stem.rsplit(".", 1)[0] + ".bias"
    if bias in sub:
        params["patch_embed"]["bias"] = g(bias)
    cls = first("class_embedding", "cls_token")
    if cls is not None:
        params["cls_token"] = g(cls).reshape(-1)
    pos = first("positional_embedding", "pos_embed")
    if pos is not None:
        params["pos_embed"] = g(pos).reshape(-1, cfg.width)

    tower, _, left = convert_peav_tower(
        sub, "", PEAVTransformerConfig(hidden_size=cfg.width, num_layers=cfg.vit_layers,
                                       num_heads=cfg.vit_heads, pos="none"))
    params["layers"] = tower["layers"]
    if "ln_pre" in tower:
        params["ln_pre"] = tower["ln_pre"]
    if "final_norm" in tower:   # ln_post is sniffed as the tower's final norm
        params["ln_post"] = tower["final_norm"]
    consumed |= set(sub) - set(left)
    if "ln_post" not in params:
        post = first("ln_post", "norm", "final_layer_norm")
        if post is not None:
            params["ln_post"] = {"weight": g(f"{post}.weight"), "bias": g(f"{post}.bias")}

    # attentive pooling (PE-Core / SigLIP probe attention)
    for ap_base in ("attn_pool", "attnpool", "attention_pool", "pool"):
        probe = first(f"{ap_base}.probe", f"{ap_base}.query", f"{ap_base}.cls_token")
        if probe is None:
            continue
        ap = {"probe": g(probe).reshape(1, -1)}
        if f"{ap_base}.attn.in_proj_weight" in sub:
            ap.update(split_fused_qkv(g(f"{ap_base}.attn.in_proj_weight"),
                                      g(f"{ap_base}.attn.in_proj_bias")
                                      if f"{ap_base}.attn.in_proj_bias" in sub else None))
            ap["wo"] = {"weight": g(f"{ap_base}.attn.out_proj.weight")}
            if f"{ap_base}.attn.out_proj.bias" in sub:
                ap["wo"]["bias"] = g(f"{ap_base}.attn.out_proj.bias")
        else:
            for role, names in (("wq", ("q", "q_proj", "wq")), ("wk", ("k", "k_proj", "wk")),
                                ("wv", ("v", "v_proj", "wv")),
                                ("wo", ("proj", "out_proj", "wo"))):
                n = first(*(f"{ap_base}.{x}.weight" for x in names))
                if n is None:
                    raise ValueError(f"unrecognized attn_pool in {ap_base}")
                base = n[: -len(".weight")]
                ap[role] = {"weight": g(n)}
                if f"{base}.bias" in sub:
                    ap[role]["bias"] = g(f"{base}.bias")
        ln = first(f"{ap_base}.layernorm.weight", f"{ap_base}.ln.weight",
                   f"{ap_base}.norm.weight")
        if ln is not None:
            base = ln[: -len(".weight")]
            ap["ln"] = {"weight": g(ln), "bias": g(f"{base}.bias")}
        params["attn_pool"] = ap
        break

    proj = first("proj", "head.weight", "projection.weight")
    if proj == "proj":   # CLIP's raw (width, dim) matrix: x @ proj
        params["proj"] = {"weight": np.ascontiguousarray(g("proj").T)}
    elif proj is not None:
        params["proj"] = {"weight": g(proj)}
        if f"{proj[: -len('.weight')]}.bias" in sub:
            params["proj"]["bias"] = g(f"{proj[: -len('.weight')]}.bias")

    ignore = re.compile(r"(rotary|rope|freqs|logit_scale|attn\.bias|position_ids|"
                        r"num_batches_tracked)")
    consumed.update(k for k in sub if k not in consumed and ignore.search(k))
    return params, sorted(prefix + k for k in sub if k not in consumed)


def convert_imagebind_state_dict(sd, cfg):
    """imagebind_huge state dict -> the audio and vision branches (cfg:
    models.imagebind.ImageBindHugeConfig): stem conv (Conv2d for audio,
    Conv3d (D, 3, 2, 14, 14) for vision, kept as stored), optional stem
    norm, cls token, position table, the trunk through convert_peav_tower
    (torch-MHA in_proj + bias_kv, norm_1/norm_2, layer_scale_gamma), the
    trunk's pre-LN, the head (LayerNorm + Linear). The postprocessors
    (Normalize, LogitScaling) cancel in the cosine and are consumed. Other
    modalities are reported in `skipped`. Returns (params, unconverted,
    skipped)."""
    from sam_audio_tpu_torch.config import PEAVTransformerConfig

    sd = {k: _arr(v) for k, v in sd.items()}
    consumed = set()

    def g(k):
        consumed.add(k)
        return sd[k]

    def maybe_ln(params, slot, base):
        if f"{base}.weight" in sd:
            params[slot] = {"weight": g(f"{base}.weight"), "bias": g(f"{base}.bias")}

    params = {}
    for modality in ("audio", "vision"):
        pre = f"modality_preprocessors.{modality}"
        trunk_prefix = f"modality_trunks.{modality}."
        branch = {}
        # PatchEmbedGeneric's proj is a Sequential: audio proj.0, vision proj.1
        # (after PadIm2Video)
        for idx in (0, 1, 2):
            key = f"{pre}.rgbt_stem.proj.{idx}.weight"
            if key in sd:
                branch["stem"] = {"weight": g(key)}
                if f"{pre}.rgbt_stem.proj.{idx}.bias" in sd:
                    branch["stem"]["bias"] = g(f"{pre}.rgbt_stem.proj.{idx}.bias")
                break
        if "stem" not in branch:
            raise ValueError(f"no patch stem for {modality}")
        maybe_ln(branch, "stem_norm", f"{pre}.rgbt_stem.norm_layer")
        branch["cls_token"] = g(f"{pre}.cls_token")
        branch["pos_embed"] = g(f"{pre}.pos_embedding_helper.pos_embed")
        audio = modality == "audio"
        tower, _, left = convert_peav_tower(
            sd, trunk_prefix, PEAVTransformerConfig(
                hidden_size=cfg.audio_dim if audio else cfg.vision_dim,
                num_layers=cfg.audio_layers if audio else cfg.vision_layers,
                num_heads=cfg.audio_heads if audio else cfg.vision_heads,
                pos="none", act="gelu"))
        # the trunk-level pre-LN (SimpleTransformer pre_transformer_layer.0)
        pre_ln_key = f"modality_trunks.{modality}.pre_transformer_layer.0"
        maybe_ln(branch, "pre_ln", pre_ln_key)
        left = [k for k in left if not k.startswith(pre_ln_key)]
        branch["trunk"] = tower
        consumed |= {k for k in sd if k.startswith(trunk_prefix)} - set(left)
        head = f"modality_heads.{modality}"
        branch["head_norm"] = {"weight": g(f"{head}.0.weight"), "bias": g(f"{head}.0.bias")}
        branch["head_proj"] = {"weight": g(f"{head}.2.weight")}
        if f"{head}.2.bias" in sd:
            branch["head_proj"]["bias"] = g(f"{head}.2.bias")
        consumed.update(k for k in sd if k.startswith(f"modality_postprocessors.{modality}"))
        params[modality] = branch

    def is_branch_key(k):
        parts = k.split(".")
        return (parts[0] in ("modality_preprocessors", "modality_trunks", "modality_heads",
                             "modality_postprocessors")
                and len(parts) > 1 and parts[1] in ("audio", "vision"))

    skipped = sorted(k for k in sd if not is_branch_key(k))
    unconverted = sorted(k for k in sd if is_branch_key(k) and k not in consumed)
    return params, unconverted, skipped


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------


def load_torch_state_dict(path: str, key: Optional[str] = None) -> Dict[str, np.ndarray]:
    """A torch checkpoint as numpy (weights only, on the CPU). `key` unwraps
    a container such as laion_clap's {'state_dict': ...}; bfloat16 tensors
    are widened to float32 (numpy has no bfloat16)."""
    import torch

    sd = torch.load(path, weights_only=True, map_location="cpu")
    if key is not None and key in sd:
        sd = sd[key]
    out = {}
    for k, v in sd.items():
        if isinstance(v, torch.Tensor):
            v = v.detach()
            out[k] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        else:
            out[k] = np.asarray(v)
    return out


def _convert_main(args):
    from sam_audio_tpu_torch.checkpoint import save_params
    from sam_audio_tpu_torch.config import SAMAudioConfig

    if not os.path.isdir(args.snapshot):
        raise SystemExit(f"{args.snapshot!r} is not a local snapshot directory "
                         "(config.json + checkpoint.pt); the port reads no hub")
    with open(os.path.join(args.snapshot, "config.json")) as fin:
        cfg = SAMAudioConfig.from_dict(json.load(fin))
    sd = load_torch_state_dict(os.path.join(args.snapshot, "checkpoint.pt"))
    print(f"checkpoint.pt: {len(sd)} tensors")
    params = convert_sam_audio_state_dict(sd, cfg, strict=not args.no_strict)
    if args.t5:
        params["text_encoder"] = convert_t5_state_dict(load_torch_state_dict(args.t5),
                                                       cfg.text_encoder)
    else:
        print("no --t5: the snapshot has no text tower; convert one with --t5 before "
              "real use")
    os.makedirs(args.out, exist_ok=True)
    shutil.copy(os.path.join(args.snapshot, "config.json"), os.path.join(args.out, "config.json"))
    save_params(os.path.join(args.out, "params.npz"), params)
    print(f"wrote {args.out}/params.npz (load with SAMAudio.from_pretrained)")


def _convert_judge(args):
    from sam_audio_tpu_torch.checkpoint import save_params
    from sam_audio_tpu_torch.config import SAMAudioJudgeConfig

    with open(os.path.join(args.snapshot, "config.json")) as fin:
        cfg_dict = json.load(fin)
    cfg = SAMAudioJudgeConfig.from_dict(cfg_dict)
    sd = load_torch_state_dict(os.path.join(args.snapshot, "checkpoint.pt"))
    overrides = dict(kv.split("=", 1) for kv in args.peav_arch.split(",") if kv) or None
    params, unconverted, archs = convert_judge_state_dict(sd, cfg, return_arch=True,
                                                          arch_overrides=overrides)
    if unconverted:
        raise SystemExit(f"unconverted judge keys: {unconverted[:20]}")
    for tower, arch in archs.items():
        print(f"{tower}: sniffed {arch}")
        cfg_dict.setdefault(tower, {}).update(arch)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "config.json"), "w") as fout:
        json.dump(cfg_dict, fout, indent=2)
    save_params(os.path.join(args.out, "params.npz"), params)
    print(f"wrote {args.out}/params.npz (load with SAMAudioJudgeModel.from_pretrained)")


def _convert_tower(kind: str, argv):
    from sam_audio_tpu_torch.checkpoint import save_params

    ap = argparse.ArgumentParser(prog=f"python -m sam_audio_tpu_torch.convert {kind}")
    ap.add_argument("--torch", required=True, help="the torch checkpoint")
    ap.add_argument("--out", required=True, help="the .npz to write")
    args = ap.parse_args(argv)
    if kind == "clap":
        from sam_audio_tpu_torch.models.clap import ClapConfig

        params, unconverted = convert_clap_state_dict(
            load_torch_state_dict(args.torch, key="state_dict"), ClapConfig())
        where = "ClapRankerConfig.checkpoint"
    elif kind == "imagebind":
        from sam_audio_tpu_torch.models.imagebind import ImageBindHugeConfig

        params, unconverted, _ = convert_imagebind_state_dict(
            load_torch_state_dict(args.torch), ImageBindHugeConfig())
        where = "ImageBindRankerConfig.checkpoint"
    else:
        from sam_audio_tpu_torch.config import PerceptionEncoderConfig

        params, unconverted = convert_pe_clip_state_dict(load_torch_state_dict(args.torch),
                                                         PerceptionEncoderConfig())
        where = "PerceptionEncoder.from_pretrained"
    if unconverted:
        raise SystemExit(f"unconverted {kind} keys: {unconverted[:20]}")
    save_params(args.out, params)
    print(f"wrote {args.out} (for {where})")


def _convert_span_predictor(argv):
    """A PEAudioFrame checkpoint -> `--out`/params.npz + config.json (the
    sniffed switches written into the PEAudioFrameConfig), the layout the
    JAX package's scripts/convert_checkpoint.py writes."""
    import dataclasses

    from sam_audio_tpu_torch.checkpoint import save_params
    from sam_audio_tpu_torch.models.span_predictor import PEAudioFrameConfig

    ap = argparse.ArgumentParser(prog="python -m sam_audio_tpu_torch.convert span-predictor")
    ap.add_argument("--torch", required=True, help="the PEAudioFrame torch checkpoint")
    ap.add_argument("--out", required=True,
                    help="the directory to write; place it as <snapshot>/span_predictor/")
    args = ap.parse_args(argv)
    cfg = PEAudioFrameConfig()
    params, arch, unconverted = convert_peaudioframe_state_dict(
        load_torch_state_dict(args.torch), cfg)
    if unconverted:
        raise SystemExit(f"unconverted PEAudioFrame keys: {unconverted[:20]}")
    cfg = dataclasses.replace(cfg, **{k: v for k, v in arch.items()
                                      if k in {f.name for f in dataclasses.fields(cfg)}})
    os.makedirs(args.out, exist_ok=True)
    save_params(os.path.join(args.out, "params.npz"), params)
    with open(os.path.join(args.out, "config.json"), "w") as fout:
        json.dump(dataclasses.asdict(cfg), fout, indent=2)
    print(f"wrote {args.out}/params.npz + config.json (place under <snapshot>/span_predictor/ "
          "for load_sam_audio to attach)")


TOWER_COMMANDS = ("clap", "imagebind", "pe-clip")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "span-predictor":
        return _convert_span_predictor(argv[1:])
    if argv and argv[0] in TOWER_COMMANDS:
        return _convert_tower(argv[0], argv[1:])
    ap = argparse.ArgumentParser(prog="python -m sam_audio_tpu_torch.convert")
    ap.add_argument("--snapshot", required=True,
                    help="local directory with config.json + checkpoint.pt")
    ap.add_argument("--out", required=True, help="the directory to write")
    ap.add_argument("--t5", default=None, help="HF T5 encoder state dict (.pt)")
    ap.add_argument("--no-strict", action="store_true",
                    help="allow checkpoint keys that no converter reads")
    ap.add_argument("--judge", action="store_true",
                    help="the snapshot is a SAMAudioJudge checkpoint")
    ap.add_argument("--peav-arch", default="",
                    help="judge: key=value,... overrides of the sniffed PE-AV switches")
    args = ap.parse_args(argv)
    return _convert_judge(args) if args.judge else _convert_main(args)


if __name__ == "__main__":
    main()
