"""Core neural-net ops as plain functions over parameter dicts of tensors.

Counterpart of sam_audio_tpu/ops/nn.py. Parameters keep the torch-style
layouts of the JAX package (Linear weight (out, in); Conv1d (out, in, k)), so
one parameter tree (bridged by checkpoint.params_from_numpy) feeds both.
Every function follows the JAX function's dtype policy: matmuls in
`compute_dtype`, normalization statistics in fp32.

Reference semantics: sam_audio/model/transformer.py (RMSNorm, ProjectionLayer,
FeedForward, TimestepEmbedder, modulate/gate) and sam_audio/model/model.py
(SinusoidalEmbedding, EmbedAnchors).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def _cast_pair(x: torch.Tensor, w: torch.Tensor, compute_dtype):
    dtype = compute_dtype or torch.promote_types(x.dtype, w.dtype)
    return x.to(dtype), w.to(dtype)


def linear(params, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None):
    x, w = _cast_pair(x, params["weight"], compute_dtype)
    y = torch.matmul(x, w.t())
    if "bias" in params:
        # added after the product's rounding, as the JAX einsum + add does
        y = y + params["bias"].to(y.dtype)
    return y


def embedding(params, ids: torch.Tensor):
    return params["weight"][ids.long()]


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5):
    """RMSNorm computed in fp32 (reference: sam_audio/model/transformer.py:36-47)."""
    xf = x.float()
    normed = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (normed * params["weight"].float()).to(x.dtype)


def layernorm(params, x: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    out = normed * params["weight"].float() + params["bias"].float()
    return out.to(x.dtype)


def modulate(x, shift, scale):
    return x * (1 + scale) + shift


def gate(x, g):
    return x * g


def get_nonlinearity(kind: str):
    """reference: sam_audio/model/transformer.py:25-33 ('swiglu' handled by
    callers). "gelu" is the tanh approximation, as jax.nn.gelu's default."""
    return {
        "relu": F.relu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "exact_gelu": F.gelu,
        "approx_gelu": lambda x: F.gelu(x, approximate="tanh"),
        "srelu": lambda x: torch.square(F.relu(x)),
        "silu": F.silu,
        "swiglu": None,
    }[kind]


def projection(params, x, non_linearity: str, compute_dtype=None):
    """w2(silu(w1(x)) * w3(x)) for swiglu, else w2(act(w1(x)))
    (reference: sam_audio/model/transformer.py:50-80)."""
    h1 = linear(params["w1"], x, compute_dtype)
    if non_linearity == "swiglu":
        h = F.silu(h1) * linear(params["w3"], x, compute_dtype)
    else:
        h = get_nonlinearity(non_linearity)(h1)
    return linear(params["w2"], h, compute_dtype)


# The FeedForward MLP has the projection's structure (reference
# transformer.py:164-206); only the hidden width differs, set by the params.
feedforward = projection


def sinusoidal_embedding(pos: torch.Tensor, dim: int, theta: float = 10000.0):
    """cos||sin sinusoidal embedding (reference: sam_audio/model/model.py:25-42).
    pos: (...,) positions. Returns (..., dim) float32."""
    half = dim // 2
    inv_freq = torch.exp(
        -math.log(theta)
        * torch.arange(half, dtype=torch.float32, device=pos.device) / half
    )
    args = pos.float()[..., None] * inv_freq
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def glide_timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0):
    """GLIDE-style frequencies (reference: sam_audio/model/transformer.py:228-253).
    t: (B,)."""
    emb = sinusoidal_embedding(t, dim, max_period)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def timestep_embedder(params, t, frequency_embedding_dim, non_linearity="swiglu",
                      compute_dtype=None):
    x = glide_timestep_embedding(t, frequency_embedding_dim)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    return projection(params["projection"], x, non_linearity, compute_dtype)


def embed_anchors(params, x, anchor_ids=None, anchor_alignment=None,
                  compute_dtype=None):
    """reference: sam_audio/model/model.py:45-65."""
    if anchor_ids is None:
        return x
    gathered = torch.gather(anchor_ids.long(), 1, anchor_alignment.long())
    proj = linear(params["proj"], embedding(params["embed"], gathered),
                  compute_dtype)
    g = torch.tanh(params["gate"]).to(proj.dtype)
    return x + g * proj


def align_modalities(params, anchor, tgt=None, compute_dtype=None,
                     eps: float = 1e-5):
    """1x1 conv == linear on (B, T, C_in) (reference:
    sam_audio/model/align.py:8-50). anchor: (B, T, C_out); tgt: (B, C_in, T)."""
    if tgt is None:
        return anchor
    post = linear(params["conv"], tgt.transpose(1, 2), compute_dtype)
    if "layer_norm" in params:
        post = layernorm(params["layer_norm"], post, eps)
    if "gate" not in params:
        return post
    g = torch.tanh(params["gate"]).to(post.dtype)
    return anchor + g * post
