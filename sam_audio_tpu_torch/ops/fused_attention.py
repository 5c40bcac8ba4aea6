"""Fused short-sequence self-attention: q/k RMSNorm + split-half RoPE + SDPA.

Replaces the TPU kernel sam_audio_tpu/ops/fused_attention.py::
fused_glue_attention (kernel body `_kernel`). Computes, per (batch, head),

    q' = rope_half(rmsnorm(q)) ; k' = rope_half(rmsnorm(k))
    out = softmax(q' k'^T / sqrt(D) + mask) v

with fp32 norm statistics and softmax, q'/k' cast back to the activation
dtype, p normalised and rounded to the activation dtype before the product
with v, T treated as padded to a multiple of 128 with masked zero keys.

Kernel: csrc/fused_attention.cu (CUDA, sm_90a). What bounds it on the H100
at the main-path shape (B=1, T=250 -> 256, H=16, D=128, bf16): it reads q, k,
v and writes out, 4 x 1 MB = 4.1 MB (1.2 us at 3.35 TB/s), and does
4*T*T*D*H = 0.52 GFLOP (0.5 us at 989 TFLOP/s bf16): below the card's ridge,
so a well-fed kernel is bound by bytes and latency. In bf16 a block of four
warpgroups owns 64 queries of one (batch, head); each warpgroup fetches a
quarter of the keys by TMA, normalises and rotates them once, computes its
scores once with wgmma and keeps them in registers; the warpgroups trade
their rows' max and sum once, so p is normalised before it is rounded to bf16
for p . v (wgmma, p as the register operand), and the four partial outputs
are summed in shared memory. In fp32 the products are FMAs with the scores in
shared memory. With no mask the kernel gets a null mask pointer; norm weights
and rope tables that are already float32 and contiguous are passed as they
are.

`fused_glue_attention` takes the plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors (raising if it cannot); it counts its
launches in `fused_glue_attention.launches`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from sam_audio_tpu_torch.ops import _build

NEG = torch.finfo(torch.float32).min
_lib = None


def _norm_rope(x, w, cos, sin, eps):
    t = x.shape[1]
    d2 = x.shape[-1] // 2
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xf = xf * w.float()
    c = cos[:t].float()[:, None, :]
    s = sin[:t].float()[:, None, :]
    x1, x2 = xf[..., :d2], xf[..., d2:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


def fused_glue_attention_plain(q, k, v, q_norm_w, k_norm_w, cos, sin,
                               key_padding_mask: Optional[torch.Tensor] = None,
                               eps: float = 1e-5) -> torch.Tensor:
    """The kernel's function in plain PyTorch. q, k, v: (B, T, H, D);
    q_norm_w, k_norm_w: (D,); cos, sin: (>=T, D/2); key_padding_mask: (B, T)
    bool, True = attend. Returns (B, T, H, D) in v's dtype."""
    b, t, h, d = q.shape
    scale = 1.0 / (d ** 0.5)
    t_pad = -(-t // 128) * 128
    if key_padding_mask is None:
        key_padding_mask = torch.ones((b, t), dtype=torch.bool, device=q.device)
    qn = _norm_rope(q, q_norm_w, cos, sin, eps)
    kn = F.pad(_norm_rope(k, k_norm_w, cos, sin, eps),
               (0, 0, 0, 0, 0, t_pad - t))
    vp = F.pad(v, (0, 0, 0, 0, 0, t_pad - t))
    mask = F.pad(key_padding_mask.bool(), (0, t_pad - t))
    logits = torch.einsum("bqhd,bkhd->bhqk", qn.float(), kn.float()) * scale
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.tensor(NEG, device=q.device))
    logits = logits - torch.amax(logits, dim=-1, keepdim=True)
    p = torch.exp(logits)
    p = p / torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vp.float())
    return out.to(v.dtype)


def fused_glue_attention_split_keys(q, k, v, q_norm_w, k_norm_w, cos, sin,
                                    key_padding_mask: Optional[torch.Tensor] = None,
                                    eps: float = 1e-5, groups: int = 4) -> torch.Tensor:
    """The bf16 kernel's softmax in plain PyTorch: the padded keys split into
    `groups` equal ranges; each range's row max m_g and sum l_g of
    exp(s - m_g); one exchange gives the row's max m and sum l =
    sum_g l_g exp(m_g - m); p = exp(s - m_g) * exp(m_g - m) / l, normalised
    before it is rounded. Same arguments and result as
    `fused_glue_attention_plain`, which it equals up to float rounding."""
    b, t, h, d = q.shape
    t_pad = -(-t // 128) * 128
    if key_padding_mask is None:
        key_padding_mask = torch.ones((b, t), dtype=torch.bool, device=q.device)
    qn = _norm_rope(q, q_norm_w, cos, sin, eps).float()
    kn = F.pad(_norm_rope(k, k_norm_w, cos, sin, eps), (0, 0, 0, 0, 0, t_pad - t)).float()
    vp = F.pad(v, (0, 0, 0, 0, 0, t_pad - t)).float()
    mask = F.pad(key_padding_mask.bool(), (0, t_pad - t))
    s = torch.einsum("bqhd,bkhd->bhqk", qn, kn) / (d ** 0.5)
    s = torch.where(mask[:, None, None, :], s, torch.tensor(NEG, device=q.device))
    parts = s.reshape(b, h, t, groups, t_pad // groups)
    m_g = parts.amax(-1, keepdim=True)
    e = torch.exp(parts - m_g)
    l_g = e.sum(-1, keepdim=True)
    m = m_g.amax(-2, keepdim=True)
    l = (l_g * torch.exp(m_g - m)).sum(-2, keepdim=True)
    p = (e * (torch.exp(m_g - m) / l)).reshape(b, h, t, t_pad)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vp)
    return out.to(v.dtype)


def _f32(x):
    """x as a contiguous float32 tensor: x itself when it already is one (the
    model's norm weights and rope tables), so a launch makes no copies."""
    if x.dtype == torch.float32 and x.is_contiguous():
        return x
    return x.float().contiguous()


def _bytes(mask):
    """A (B, T) mask as contiguous bytes (nonzero = attend); a bool mask is
    viewed as bytes, not copied."""
    mask = mask.contiguous()
    return mask.view(torch.uint8) if mask.dtype == torch.bool else mask.to(torch.uint8)


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("fused_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sa_fused_glue_attention.argtypes = [p] * 9 + [i] * 4 + [f, f, i, p]
        lib.sa_fused_glue_attention.restype = i
        _lib = lib
    return _lib


def fused_glue_attention(q, k, v, q_norm_w, k_norm_w, cos, sin,
                         key_padding_mask: Optional[torch.Tensor] = None,
                         eps: float = 1e-5) -> torch.Tensor:
    """qk-RMSNorm + split-half RoPE + SDPA. Plain version on the CPU, the
    CUDA kernel on the card (D = 128, T <= 512, float32 or bfloat16)."""
    if q.device.type == "cpu":
        return fused_glue_attention_plain(q, k, v, q_norm_w, k_norm_w, cos, sin,
                                          key_padding_mask, eps)
    if q.device.type != "cuda":
        raise ValueError(f"fused_glue_attention: unsupported device {q.device}")
    b, t, h, d = q.shape
    if d != 128 or t > 512:
        raise ValueError(f"fused_glue_attention kernel takes D = 128 and "
                         f"T <= 512, got D={d}, T={t}")
    if not (q.dtype == k.dtype == v.dtype) or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("fused_glue_attention: q, k, v must share shape and dtype")
    code = _build.dtype_code(q.dtype)
    q, k, v = (_build.aligned16(x.contiguous()) for x in (q, k, v))
    qw, kw = _f32(q_norm_w), _f32(k_norm_w)
    cs = _build.aligned16(_f32(cos[:t]))
    sn = _build.aligned16(_f32(sin[:t]))
    mask = None if key_padding_mask is None else _bytes(key_padding_mask)
    for x in (qw, kw, cs, sn) + (() if mask is None else (mask,)):
        if x.device != q.device:
            raise ValueError("fused_glue_attention: inputs on different devices")
    out = torch.empty_like(q)
    P = _build.ptr
    err = _load().sa_fused_glue_attention(
        P(q), P(k), P(v), P(qw), P(kw), P(cs), P(sn), None if mask is None else P(mask),
        P(out),
        b, t, h, d, ctypes.c_float(eps), ctypes.c_float(1.0 / (d ** 0.5)), code,
        _build.stream_of(q))
    _build.check(err, "fused_glue_attention")
    fused_glue_attention.launches += 1
    return out


fused_glue_attention.launches = 0
