"""T5 encoder stack (t5-base by default); counterpart of
sam_audio_tpu/models/t5.py.

The reference conditions the DiT on T5-base last-hidden-state text features
(reference: sam_audio/model/text_encoder.py:11-37):

  embed -> N x [RMSNorm -> relative-position-bias attention (no 1/sqrt(d)
  scaling, per T5) -> residual -> RMSNorm -> ReLU MLP -> residual]
  -> final RMSNorm

The relative position bias is computed once and shared by every layer; the
layers' parameters are stacked on axis 0 (the JAX storage layout) and the
layer loop is a Python loop over that axis.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from sam_audio_tpu_torch.config import T5EncoderConfig
from sam_audio_tpu_torch.ops import nn as N
from sam_audio_tpu_torch.utils import layer_slice


def relative_position_bucket(relative_position: torch.Tensor, num_buckets=32,
                             max_distance=128) -> torch.Tensor:
    """Bidirectional T5 relative position bucketing (HF numerics)."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int32) * num_buckets
    n = torch.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-20)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n.to(torch.int32), val_if_large)


def compute_position_bias(rel_bias_weight: torch.Tensor, q_len: int, k_len: int,
                          num_buckets: int, max_distance: int) -> torch.Tensor:
    """rel_bias_weight: (num_buckets, n_heads) -> (1, n_heads, q_len, k_len)."""
    dev = rel_bias_weight.device
    context_pos = torch.arange(q_len, device=dev)[:, None]
    memory_pos = torch.arange(k_len, device=dev)[None, :]
    buckets = relative_position_bucket(memory_pos - context_pos, num_buckets,
                                       max_distance)
    return rel_bias_weight[buckets.long()].permute(2, 0, 1)[None]


def _block_apply(params, h, position_bias, mask_bias, cfg: T5EncoderConfig,
                 compute_dtype=None):
    b, s, _ = h.shape
    hd, nh = cfg.head_dim, cfg.num_heads
    x = N.rmsnorm(params["attn"]["layer_norm"], h, cfg.layer_norm_eps)
    q = N.linear(params["attn"]["q"], x, compute_dtype).reshape(b, s, nh, hd)
    k = N.linear(params["attn"]["k"], x, compute_dtype).reshape(b, s, nh, hd)
    v = N.linear(params["attn"]["v"], x, compute_dtype).reshape(b, s, nh, hd)
    # T5 omits the 1/sqrt(d) attention scaling (absorbed into init).
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores + position_bias + mask_bias
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    attn = torch.einsum("bhqk,bkhd->bqhd", weights.float(), v.float()).to(v.dtype)
    h = h + N.linear(params["attn"]["o"], attn.reshape(b, s, nh * hd), compute_dtype)

    x = N.rmsnorm(params["ff"]["layer_norm"], h, cfg.layer_norm_eps)
    x = F.relu(N.linear(params["ff"]["wi"], x, compute_dtype))
    return h + N.linear(params["ff"]["wo"], x, compute_dtype)


def t5_encode(params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
              cfg: T5EncoderConfig, compute_dtype=None) -> torch.Tensor:
    """input_ids: (B, L) int; attention_mask: (B, L) bool/int.
    Returns last_hidden_state (B, L, dim) in fp32."""
    h = N.embedding(params["token_embedding"], input_ids)
    if compute_dtype is not None:
        h = h.to(compute_dtype)
    s = input_ids.shape[1]
    position_bias = compute_position_bias(
        params["relative_attention_bias"]["weight"].float(), s, s,
        cfg.relative_attention_num_buckets, cfg.relative_attention_max_distance,
    )
    mask = attention_mask.bool()
    zero = torch.zeros((), device=h.device)
    neg = torch.tensor(torch.finfo(torch.float32).min, device=h.device)
    mask_bias = torch.where(mask, zero, neg)[:, None, None, :]
    blocks = params["blocks"]
    for i in range(cfg.num_layers):
        h = _block_apply(layer_slice(blocks, i), h, position_bias, mask_bias, cfg,
                         compute_dtype)
    h = N.rmsnorm(params["final_layer_norm"], h, cfg.layer_norm_eps)
    return h.float()
