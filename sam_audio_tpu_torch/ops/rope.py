"""Rotary position embeddings in the split-half layout.

Counterpart of sam_audio_tpu/ops/rope.py:25-86. The q/k projection output
channels are stored deinterleaved (rotary pair (2i, 2i+1) moved to
(i, i + D/2)), so the rotation is two half-width multiplies. The tables are
built in float64 numpy and stored as float32, exactly as the JAX package does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def precompute_rope(head_dim: int, max_seqlen: int, theta: float,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (cos, sin), each (max_seqlen, head_dim // 2), float32."""
    freqs = 1.0 / (
        theta ** (np.arange(0, head_dim, 2)[: head_dim // 2].astype(np.float64)
                  / head_dim)
    )
    angles = np.outer(np.arange(max_seqlen, dtype=np.float64), freqs)
    return (
        torch.as_tensor(np.cos(angles).astype(np.float32), device=device),
        torch.as_tensor(np.sin(angles).astype(np.float32), device=device),
    )


def apply_rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate split-half rotary pairs: channels (i, i + D/2) by angle[i].
    x: (B, S, H, D); cos/sin: (S', D/2). Computed in fp32, cast back."""
    seqlen = x.shape[-3]
    d_half = x.shape[-1] // 2
    c = cos[:seqlen].float()[:, None, :]
    s = sin[:seqlen].float()[:, None, :]
    xf = x.float()
    x1 = xf[..., :d_half]
    x2 = xf[..., d_half:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)
