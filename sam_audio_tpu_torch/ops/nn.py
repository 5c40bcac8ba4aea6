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

from sam_audio_tpu_torch.ops.quant import linear_int4, linear_int8
from sam_audio_tpu_torch.parallel import comm


def _cast_pair(x: torch.Tensor, w: torch.Tensor, compute_dtype):
    dtype = compute_dtype or torch.promote_types(x.dtype, w.dtype)
    return x.to(dtype), w.to(dtype)


def linear(params, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None):
    if "w8" in params:  # int8 serving mode (ops/quant.py)
        return linear_int8(params, x, compute_dtype)
    if "w4" in params:  # int4 weight storage, kernel 4 (ops/quant.py)
        return linear_int4(params, x, compute_dtype)
    x, w = _cast_pair(x, params["weight"], compute_dtype)
    y = torch.matmul(x, w.t())
    if "bias" in params:
        # added after the product's rounding, as the JAX einsum + add does
        y = y + params["bias"].to(y.dtype)
    return y


def in_features(params) -> int:
    for key in ("weight", "w8", "w4"):
        if key in params:
            return params[key].shape[-1]
    raise KeyError("not a linear's parameters")


def out_features(params) -> int:
    if "w4" in params:   # two rows a byte
        return 2 * params["w4"].shape[-2]
    return (params["weight"] if "weight" in params else params["w8"]).shape[-2]


# Tensor parallelism (parallel/mesh.py's rules, parallel/comm.py's
# collectives). Under an active tensor-parallel group a split leaf holds this
# rank's block; the caller passes the full width so that a split leaf is told
# from a whole one (a leaf whose dimension does not divide stays whole). A
# full width of 0 marks a linear that no rule splits.


def column_linear(params, x: torch.Tensor, compute_dtype=None, full_out: int = 0):
    """A column-parallel linear: with `params` holding this rank's block of
    the `full_out` output rows, this rank's block of the output; the whole
    input's gradient is summed over the group (Megatron's f)."""
    group = comm.tp_group()
    if group is not None and full_out and out_features(params) != full_out:
        x = comm.copy_to(x, group)
    return linear(params, x, compute_dtype)


def row_linear(params, x: torch.Tensor, compute_dtype=None, full_in: int = 0):
    """A row-parallel linear: with `params` holding this rank's block of the
    `full_in` input columns, the partial products are summed over the group
    (Megatron's g) and the whole bias is added once, after the sum. The
    int8 path takes the activation's absmax over the whole input (a max over
    the group) and sums the int32 products. `x` may be this rank's block or
    whole (then its block is taken); with a whole weight a split `x` is
    gathered."""
    group = comm.tp_group()
    w_in = in_features(params)
    if group is None or not full_in or w_in == full_in:
        if x.shape[-1] != w_in:
            x = comm.gather(x, -1, group)
        return linear(params, x, compute_dtype)
    if x.shape[-1] != w_in:
        x = comm.scatter(x, -1, group)
    if "w8" in params:
        return linear_int8(params, x, compute_dtype, group=group)
    y = linear({"weight": params["weight"]}, x, compute_dtype)
    y = comm.reduce_from(y.float(), group).to(y.dtype)
    if "bias" in params:
        y = y + params["bias"].to(y.dtype)
    return y


def gather_columns(y: torch.Tensor, full: int) -> torch.Tensor:
    """The whole output of a column-parallel linear (blocks in rank order)."""
    if y.shape[-1] == full:
        return y
    return comm.gather(y, -1, comm.tp_group())


def whole_heads(y: torch.Tensor, head_dim: int) -> torch.Tensor:
    """A column-parallel q/k/v block that splits a head is gathered whole
    (the split matched tp but not the head count); whole heads stay local."""
    if y.shape[-1] % head_dim:
        return comm.gather(y, -1, comm.tp_group())
    return y


def tp_replicated(w: torch.Tensor) -> torch.Tensor:
    """A whole parameter used on this rank's heads only (per-head norms, T5's
    relative bias): its gradient is summed over the group."""
    return comm.copy_to(w, comm.tp_group())


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


def dropout(x, rate: float, generator: Optional[torch.Generator] = None,
            full_last: int = 0):
    """Inverted dropout; the identity when rate is 0 or there is no generator
    (inference). The keep mask is drawn from `generator` (on x's device), so
    it cannot reproduce jax.random's bits: only the distribution is JAX's.
    `full_last`: the full width of a last dimension that tensor parallelism
    splits (a column-parallel hidden layer), 0 for a whole one; see
    `dropout_keep` for the mask on a mesh."""
    if rate <= 0.0 or generator is None:
        return x
    keep = dropout_keep(x.shape, rate, generator, x.device, full_last)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                          device=x.device)).to(x.dtype)


def dropout_keep(shape, rate: float, generator: torch.Generator, device,
                 full_last: int = 0) -> torch.Tensor:
    """The keep mask of a dropout site whose activation has `shape` on this
    rank. As JAX draws one mask over the global array, the mask is drawn at
    the global shape, the rows of every rank of the active data-parallel
    group (comm.use_dp) and the `full_last` units of a split last dimension,
    and this rank keeps its block: its dp rows and the tensor-parallel block
    of columns that column_linear keeps. A dp x tp step then drops what one
    card drops."""
    dp = comm.dp_group()
    split = bool(full_last) and shape[-1] != full_last
    full = (shape[0] * comm.size(dp), *shape[1:-1], full_last if split else shape[-1])
    keep = comm.block(torch.rand(full, generator=generator, device=device) >= rate, 0, dp)
    return comm.block(keep, len(full) - 1, comm.tp_group()) if split else keep


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


def projection(params, x, non_linearity: str, compute_dtype=None,
               dropout_rate: float = 0.0, generator: Optional[torch.Generator] = None,
               hidden: int = 0):
    """w2(dropout(silu(w1(x)) * w3(x))) for swiglu, else w2(dropout(act(w1(x))))
    (reference: sam_audio/model/transformer.py:50-80; dropout in training
    only, transformer.py:79). `hidden`: the full hidden width of a
    tensor-parallel FFN (w1/w3 column-, w2 row-parallel); 0 for a whole one."""
    h1 = column_linear(params["w1"], x, compute_dtype, hidden)
    if non_linearity == "swiglu":
        h = F.silu(h1) * column_linear(params["w3"], x, compute_dtype, hidden)
    else:
        h = get_nonlinearity(non_linearity)(h1)
    h = dropout(h, dropout_rate, generator, hidden)
    return row_linear(params["w2"], h, compute_dtype, hidden)


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
                      compute_dtype=None, dropout_rate: float = 0.0,
                      generator: Optional[torch.Generator] = None):
    x = glide_timestep_embedding(t, frequency_embedding_dim)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    return projection(params["projection"], x, non_linearity, compute_dtype,
                      dropout_rate, generator)


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
