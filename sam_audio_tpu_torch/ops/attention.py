"""Attention ops: plain scaled dot-product attention and the dispatcher.

Counterpart of sam_audio_tpu/ops/attention.py. Layout: q, k, v are
(B, S, H, D). Masked keys take the fp32 `finfo.min` logit, so a query row
whose keys are all masked gets uniform weights (the mean of V), as in JAX —
a boolean mask in `F.scaled_dot_product_attention` would give 0 there, and
that library kernel is not used by the port.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from sam_audio_tpu_torch.ops.flash_attention import flash_attention

# At or above this query length self-attention takes the flash kernel.
FLASH_MIN_SEQLEN = 1024

NEG = torch.finfo(torch.float32).min


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         key_padding_mask: Optional[torch.Tensor] = None,
         scale: Optional[float] = None, score_dtype=None) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, H, D); key_padding_mask: (B, Sk) bool,
    True = attend. Returns (B, Sq, H, D) in v's dtype. Products accumulate
    in fp32 (inputs are upcast: a bf16 product is exact in fp32), softmax in
    fp32, the weights round to v's dtype before the second product.

    `score_dtype` (the JAX package's semantics): the (B, H, Sq, Sk) logits
    are rounded once to this dtype after the product and the softmax still
    runs in fp32. When q, k and v are already in that dtype and the scale is
    a power of two, both products run in that dtype on the tensor cores
    (fp32 accumulation, one rounding of the output), with the scale folded
    into q: q * 2^-n is exact, so the rounded product is the same number as
    the fp32 product scaled and then rounded. The keys are zero-padded to a
    multiple of 8 and the padded logits set to -inf (weights exactly 0), so
    that cuBLAS takes its aligned kernels (577 keys a PE-Core frame). Masked
    keys take the fp32 `finfo.min` after the rounding."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if score_dtype is not None and score_dtype != torch.float32:
        mask = None if key_padding_mask is None else key_padding_mask.bool()
        if (q.dtype == k.dtype == v.dtype == score_dtype
                and math.frexp(scale)[0] == 0.5):
            sk = k.shape[1]
            pad = (-sk) % 8
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)
            if pad:
                kt, vt = F.pad(kt, (0, 0, 0, pad)), F.pad(vt, (0, 0, 0, pad))
                if mask is not None:
                    mask = F.pad(mask, (0, pad))   # the padded keys are masked
            logits = torch.matmul((q * scale).transpose(1, 2), kt.transpose(-1, -2))
            if pad and mask is None:
                logits[..., sk:] = float("-inf")
        else:
            vt = None
            logits = (torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
                      * scale).to(score_dtype)
        if mask is not None:
            logits = logits.float().masked_fill(~mask[:, None, None, :], NEG)
        # fp32 statistics and exponentials, the weights rounded once to v's
        # dtype (torch's reduced-precision softmax computes in fp32)
        weights = (torch.softmax(logits, dim=-1) if logits.dtype == v.dtype
                   else torch.softmax(logits.float(), dim=-1).to(v.dtype))
        if vt is not None:
            return torch.matmul(weights, vt).transpose(1, 2)
        out = torch.einsum("bhqk,bkhd->bqhd", weights.float(), v.float())
        return out.to(v.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if key_padding_mask is not None:
        logits = logits.masked_fill(~key_padding_mask[:, None, None, :].bool(),
                                    NEG)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def attend(q, k, v, key_padding_mask=None, scale=None, score_dtype=None):
    """Long self-attention (>= 1024 frames, a > 40 s clip) goes to the flash
    kernel; everything else to `sdpa`, which takes `score_dtype`."""
    if (q.shape[1] >= FLASH_MIN_SEQLEN and q.shape[1] == k.shape[1]
            and q.shape[-1] % 128 == 0):
        return flash_attention(q, k, v, key_padding_mask=key_padding_mask,
                               scale=scale)
    return sdpa(q, k, v, key_padding_mask=key_padding_mask, scale=scale,
                score_dtype=score_dtype)
