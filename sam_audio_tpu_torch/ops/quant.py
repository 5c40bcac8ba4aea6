"""Quantized serving modes (opt-in; they trade exactness for footprint).

Counterpart of sam_audio_tpu/ops/quant.py:

  * int8 (W8A8): symmetric per-output-channel int8 weights, scale =
    max|w_row| / 127, quantized once (`quantize_linear`); per-token dynamic
    int8 activations; an int8 x int8 -> int32 product; y = y_i32 * (s_act *
    s_w) + bias (`linear_int8`).
  * int4 (weight storage): symmetric per-(out, group) scales, values in
    [-7, 7], two rows packed per byte (`quantize_linear_int4`); the product
    runs through ops/int4_matmul.matmul_int4, the port's kernel for the TPU's
    `matmul_int4` (`linear_int4`).

Quantizing the same fp32 weights gives the JAX package's w8 / w_scale / w4 /
w4_scale bit for bit: the same order of operations, and both round half to
even. `ops.nn.linear` dispatches here when a parameter dict carries "w8" or
"w4" instead of "weight".
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sam_audio_tpu_torch.ops.int4_matmul import matmul_int4


def quantize_linear(params):
    """{"weight": (..., out, in), ["bias"]} -> {"w8", "w_scale", ["bias"]};
    stacked (L, out, in) weights get (L, out) scales."""
    w = params["weight"].float()
    amax = torch.amax(torch.abs(w), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    out = {"w8": torch.round(w / scale).to(torch.int8), "w_scale": scale.squeeze(-1)}
    if "bias" in params:
        out["bias"] = params["bias"]
    return out


def _int_matmul(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 . (N, K)^T int8 -> (M, N) int32. On the card through
    torch._int_mm, whose shape rule (M > 16, K and N multiples of 8) is met by
    zero padding that is dropped after; on the CPU an int32 matmul."""
    if x8.device.type != "cuda":
        return torch.matmul(x8.to(torch.int32), w8.to(torch.int32).t())
    m, k = x8.shape
    n = w8.shape[0]
    mp, kp, np_ = max(-(-m // 8) * 8, 24), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        x8 = F.pad(x8, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        w8 = F.pad(w8, (0, kp - k, 0, np_ - n))
    return torch._int_mm(x8, w8.t())[:m, :n]


def linear_int8(params, x: torch.Tensor, compute_dtype=None):
    """y = (x8 . w8^T) * (s_act * s_w) + bias, returned in x's dtype (the
    accumulation dtype is fixed by the int8 path, so compute_dtype is
    ignored, as in JAX)."""
    del compute_dtype
    xf = x.float()
    s_act = torch.clamp(torch.amax(torch.abs(xf), dim=-1, keepdim=True), min=1e-12) / 127.0
    x8 = torch.round(xf / s_act).to(torch.int8)
    lead = x8.shape[:-1]
    y = _int_matmul(x8.reshape(-1, x8.shape[-1]), params["w8"])
    y = y.reshape(*lead, y.shape[-1]).float() * (s_act * params["w_scale"].float())
    if "bias" in params:
        y = y + params["bias"].float()
    return y.to(x.dtype)


def quantize_linear_int4(params, group_size: int = 128):
    """{"weight": (..., out, in)} -> {"w4", "w4_scale", ["bias"]}: w4 is
    (..., out/2, in) uint8, row j in the low nibble and row j + out/2 in the
    high nibble; w4_scale is (..., out, in/g) fp32, g being the largest
    divisor of `in` that is <= group_size."""
    w = params["weight"].float()
    shape = w.shape
    assert shape[-2] % 2 == 0, shape
    g = group_size
    while shape[-1] % g != 0:
        g -= 1
    wg = w.reshape(*shape[:-1], shape[-1] // g, g)
    amax = torch.amax(torch.abs(wg), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 7.0
    q = torch.clamp(torch.round(wg / scale), -7, 7).to(torch.int32).reshape(shape)
    half = shape[-2] // 2
    packed = (q[..., :half, :] & 0x0F) | ((q[..., half:, :] & 0x0F) << 4)
    out = {"w4": packed.to(torch.uint8), "w4_scale": scale.squeeze(-1).float()}
    if "bias" in params:
        out["bias"] = params["bias"]
    return out


def linear_int4(params, x: torch.Tensor, compute_dtype=None):
    """y = x . dequant(w4)^T + bias through kernel 4 on the card at every
    token count (the plain version on the CPU). w4 is (out/2, in) at call
    time: the layer loop slices the stacked axis off."""
    dtype = compute_dtype or torch.bfloat16
    lead = x.shape[:-1]
    y = matmul_int4(x.reshape(-1, x.shape[-1]).to(dtype), params["w4"], params["w4_scale"])
    y = y.reshape(*lead, y.shape[-1])
    if "bias" in params:
        y = y + params["bias"].to(y.dtype)
    return y.to(x.dtype)


# (group, name) of the Linears in a stacked DiT layer that get quantized. The
# output head, t_block, the embedders and the Patcher stem stay full precision.
_DIT_LAYER_LINEARS = (
    ("attention", "wq"), ("attention", "wk"), ("attention", "wv"),
    ("attention", "wo"),
    ("cross_attention", "wq"), ("cross_attention", "wk"),
    ("cross_attention", "wv"), ("cross_attention", "wo"),
    ("feed_forward", "w1"), ("feed_forward", "w2"), ("feed_forward", "w3"),
)

_QUANTIZERS = {8: quantize_linear, 4: quantize_linear_int4}


def quantize_dit_params(dit_params, bits: int = 8):
    """Quantize the hot Linears of a DiT tree (stacked layers). Returns a new
    tree; the other leaves are shared, not copied."""
    quant = _QUANTIZERS[bits]
    out = dict(dit_params)
    layers = dict(dit_params["layers"])
    for group, name in _DIT_LAYER_LINEARS:
        if group not in layers:
            continue
        g = dict(layers[group])
        if name in g and "weight" in g[name]:
            g[name] = quant(g[name])
        layers[group] = g
    out["layers"] = layers
    return out


def quantize_sam_audio_params(params, bits: int = 8):
    """Quantize the DiT of a full SAMAudio tree and its input projection;
    the codec, T5 and the towers stay full precision."""
    out = dict(params)
    out["transformer"] = quantize_dit_params(params["transformer"], bits)
    if "proj" in params:
        out["proj"] = _QUANTIZERS[bits](params["proj"])
    return out


def _quantize_flat(d, names):
    """int8 for the {name: linear} entries of a (possibly stacked) dict."""
    out = dict(d)
    for name in names:
        if (name in out and isinstance(out[name], dict) and "weight" in out[name]
                and out[name]["weight"].ndim >= 2):
            out[name] = quantize_linear(out[name])
    return out


def quantize_clap_params(clap_params):
    """int8 for the CLAP scorer: the HTSAT swin blocks (qkv, proj, fc1, fc2)
    and the RoBERTa layers; the mel filterbank, patch embed, norms, position
    tables and projection heads stay full precision."""
    out = dict(clap_params)
    audio = dict(out["audio_branch"])
    audio["stages"] = [
        {**stage, "blocks": [_quantize_flat(blk, ("qkv", "proj", "fc1", "fc2"))
                             for blk in stage["blocks"]]}
        for stage in audio["stages"]
    ]
    out["audio_branch"] = audio
    text = dict(out["text_branch"])
    layers = dict(_quantize_flat(text["layers"], ("fc1", "fc2")))
    layers["attn"] = _quantize_flat(layers["attn"], ("wq", "wk", "wv", "wo"))
    text["layers"] = layers
    out["text_branch"] = text
    return out
