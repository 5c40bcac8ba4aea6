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
v and writes out, 4 x 1 MB = 4.2 MB (1.3 us at 3.35 TB/s), and does
4*T*T*D*H = 0.54 GFLOP (0.54 us at 989 TFLOP/s bf16): below the card's
ridge, so a well-fed kernel is bound by bytes and launch latency. The design
keeps the scores and the normalised q'/k' on chip (one block per query tile,
K and V streamed in 64-key tiles), so nothing but q, k, v and out touches
device memory. In bf16 the products run on the tensor cores (mma.sync, two
passes over the keys: row statistics, then the normalised p rounded to bf16
into P . V, scores in registers); in fp32 they are FMAs with the scores in
shared memory. No TMA or wgmma yet.

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
    qw = q_norm_w.float().contiguous()
    kw = k_norm_w.float().contiguous()
    cs = _build.aligned16(cos[:t].float().contiguous())
    sn = _build.aligned16(sin[:t].float().contiguous())
    if key_padding_mask is None:
        mask = torch.ones((b, t), dtype=torch.uint8, device=q.device)
    else:
        mask = key_padding_mask.to(torch.uint8).contiguous()
    for x in (qw, kw, cs, sn, mask):
        if x.device != q.device:
            raise ValueError("fused_glue_attention: inputs on different devices")
    out = torch.empty_like(q)
    P = _build.ptr
    err = _load().sa_fused_glue_attention(
        P(q), P(k), P(v), P(qw), P(kw), P(cs), P(sn), P(mask), P(out),
        b, t, h, d, ctypes.c_float(eps), ctypes.c_float(1.0 / (d ** 0.5)), code,
        _build.stream_of(q))
    _build.check(err, "fused_glue_attention")
    fused_glue_attention.launches += 1
    return out


fused_glue_attention.launches = 0
