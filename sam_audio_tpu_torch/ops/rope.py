"""Rotary position embeddings.

Counterpart of sam_audio_tpu/ops/rope.py:25-147. The DiT's q/k projection
output channels are stored deinterleaved (rotary pair (2i, 2i+1) moved to
(i, i + D/2)), so its rotation is two half-width multiplies
(`apply_rope_half`). A PE-AV tower with rotary buffers, and the PE-Core
vision tower with `use_rope2d` (axial 2-D tables, `precompute_rope_2d`),
rotate interleaved pairs (`apply_rope`). The tables are built in float64 numpy and stored as
float32, exactly as the JAX package does.
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


def precompute_rope_2d(head_dim: int, grid: int, theta: float = 10000.0,
                       n_prefix_tokens: int = 0, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Axial 2-D RoPE tables for a (grid x grid) patch lattice (PE-Core's
    vision attention; parameter-free). The first half of the rotary pairs
    turns with the x coordinate, the second with y, each on the 1-D ladder
    over head_dim / 2; prefix tokens (CLS) get angle 0. Returns (cos, sin),
    each (n_prefix_tokens + grid * grid, head_dim // 2), float32."""
    d_half = head_dim // 2
    freqs = 1.0 / (theta ** (np.arange(0, d_half, 2).astype(np.float64) / d_half))
    ang = np.outer(np.arange(grid, dtype=np.float64), freqs)   # (grid, d_half / 2)
    ang_x = np.tile(ang[None, :, :], (grid, 1, 1))              # token (y, x)
    ang_y = np.tile(ang[:, None, :], (1, grid, 1))
    angles = np.concatenate([ang_x, ang_y], axis=-1).reshape(grid * grid, -1)
    if n_prefix_tokens:
        angles = np.concatenate([np.zeros((n_prefix_tokens, angles.shape[1])), angles])
    return (torch.as_tensor(np.cos(angles).astype(np.float32), device=device),
            torch.as_tensor(np.sin(angles).astype(np.float32), device=device))


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


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate interleaved rotary pairs: channels (2i, 2i + 1) by angle[i].
    x: (B, S, H, D); cos/sin: (S', D/2). Computed in fp32, cast back."""
    seqlen = x.shape[-3]
    c = cos[:seqlen].float()[:, None, :]
    s = sin[:seqlen].float()[:, None, :]
    xf = x.float()
    x0, x1 = xf[..., 0::2], xf[..., 1::2]
    return torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1).reshape(x.shape).to(x.dtype)
