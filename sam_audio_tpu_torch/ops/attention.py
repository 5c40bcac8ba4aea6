"""Attention ops: plain scaled dot-product attention and the dispatcher.

Counterpart of sam_audio_tpu/ops/attention.py. Layout: q, k, v are
(B, S, H, D). Masked keys take the fp32 `finfo.min` logit, so a query row
whose keys are all masked gets uniform weights (the mean of V), as in JAX —
a boolean mask in `F.scaled_dot_product_attention` would give 0 there, and
that library kernel is not used by the port.
"""

from __future__ import annotations

from typing import Optional

import torch

from sam_audio_tpu_torch.ops.flash_attention import flash_attention

# At or above this query length self-attention takes the flash kernel.
FLASH_MIN_SEQLEN = 1024

NEG = torch.finfo(torch.float32).min


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         key_padding_mask: Optional[torch.Tensor] = None,
         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, H, D); key_padding_mask: (B, Sk) bool,
    True = attend. Returns (B, Sq, H, D) in v's dtype. Products accumulate
    in fp32 (inputs are upcast: a bf16 product is exact in fp32), softmax in
    fp32, the weights round to v's dtype before the second product."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if key_padding_mask is not None:
        logits = logits.masked_fill(~key_padding_mask[:, None, None, :].bool(),
                                    NEG)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def attend(q, k, v, key_padding_mask=None, scale=None):
    """Long self-attention (>= 1024 frames, a > 40 s clip) goes to the flash
    kernel; everything else to `sdpa`."""
    if (q.shape[1] >= FLASH_MIN_SEQLEN and q.shape[1] == k.shape[1]
            and q.shape[-1] % 128 == 0):
        return flash_attention(q, k, v, key_padding_mask=key_padding_mask,
                               scale=scale)
    return sdpa(q, k, v, key_padding_mask=key_padding_mask, scale=scale)
