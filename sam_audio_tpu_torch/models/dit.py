"""DiT backbone (adaLN-single diffusion transformer); counterpart of
sam_audio_tpu/models/dit.py.

Matches the reference DiT (sam_audio/model/transformer.py:291-524):
per-block learned (6, dim) scale-shift tables added to a shared projection of
the timestep embedding, RoPE self-attention with per-head q/k RMSNorm,
un-gated cross-attention to the text memory, SwiGLU FFN, Patcher conv stem,
final adaLN modulation and linear head. Layer parameters are stacked on
axis 0; the layer loop is a Python loop.

Self-attention dispatch (as dit.py:70-110):
  * T <= 512 with qk_norm and head_dim % 128 == 0 -> the fused norm + RoPE +
    attention kernel (ops/fused_attention.py);
  * otherwise norm + RoPE in PyTorch, then ops/attention.attend, which sends
    T >= 1024 to the flash kernel (ops/flash_attention.py) and the rest to
    plain sdpa.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sam_audio_tpu_torch.config import TransformerConfig
from sam_audio_tpu_torch.ops import conv as C
from sam_audio_tpu_torch.ops import nn as N
from sam_audio_tpu_torch.ops.attention import attend, sdpa
from sam_audio_tpu_torch.ops.fused_attention import fused_glue_attention
from sam_audio_tpu_torch.ops.rope import apply_rope_half, precompute_rope
from sam_audio_tpu_torch.utils import layer_slice

FUSED_MAX_SEQLEN = 512


def attention_apply(params, x, *, n_heads, head_dim, cross_x=None,
                    key_padding_mask=None, rope_tables=None, norm_eps=1e-5,
                    compute_dtype=None):
    """x: (B, Tq, dim); cross_x: (B, Tk, dim) or None for self-attention.
    Heads split contiguously (B, T, H, D); checkpoint conversion already
    permuted the reference's strided head split."""
    src = x if cross_x is None else cross_x
    b, tq, _ = x.shape
    tk = src.shape[1]
    q = N.linear(params["wq"], x, compute_dtype).reshape(b, tq, n_heads, head_dim)
    k = N.linear(params["wk"], src, compute_dtype).reshape(b, tk, n_heads, head_dim)
    v = N.linear(params["wv"], src, compute_dtype).reshape(b, tk, n_heads, head_dim)
    if cross_x is None and rope_tables is not None and "q_norm" in params:
        if head_dim % 128 == 0 and tq <= FUSED_MAX_SEQLEN:
            out = fused_glue_attention(
                q, k, v, params["q_norm"]["weight"], params["k_norm"]["weight"],
                rope_tables[0], rope_tables[1],
                key_padding_mask=key_padding_mask, eps=norm_eps,
            )
            return N.linear(params["wo"], out.reshape(b, tq, n_heads * head_dim),
                            compute_dtype)
    if "q_norm" in params:
        q = N.rmsnorm(params["q_norm"], q, norm_eps)
        k = N.rmsnorm(params["k_norm"], k, norm_eps)
    if rope_tables is not None:
        q = apply_rope_half(q, *rope_tables)
        k = apply_rope_half(k, *rope_tables)
    attn = attend if cross_x is None else sdpa
    out = attn(q, k, v, key_padding_mask=key_padding_mask)
    return N.linear(params["wo"], out.reshape(b, tq, n_heads * head_dim),
                    compute_dtype)


def dit_block_apply(params, h, *, cfg: TransformerConfig, cross_x, t0,
                    padding_mask, memory_padding_mask, rope_tables,
                    compute_dtype=None):
    """h: (B, T, dim); t0: (B, 6*dim) shared timestep projection."""
    b = h.shape[0]
    biases = (params["scale_shift_table"][None].float()
              + t0.reshape(b, 6, -1).float()).to(h.dtype)
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (
        biases[:, i][:, None, :] for i in range(6)
    )
    h_attn = attention_apply(
        params["attention"],
        N.modulate(N.rmsnorm(params["attention_norm"], h, cfg.norm_eps),
                   shift_msa, scale_msa),
        n_heads=cfg.n_heads, head_dim=cfg.head_dim,
        key_padding_mask=padding_mask, rope_tables=rope_tables,
        norm_eps=cfg.norm_eps, compute_dtype=compute_dtype,
    )
    h = h + N.gate(h_attn, gate_msa)
    h = h + attention_apply(  # un-gated cross-attn (reference transformer.py:382-388)
        params["cross_attention"], h, cross_x=cross_x,
        n_heads=cfg.n_heads, head_dim=cfg.head_dim,
        key_padding_mask=memory_padding_mask, norm_eps=cfg.norm_eps,
        compute_dtype=compute_dtype,
    )
    h_ff = N.feedforward(
        params["feed_forward"],
        N.modulate(N.rmsnorm(params["ffn_norm"], h, cfg.norm_eps),
                   shift_mlp, scale_mlp),
        cfg.non_linearity, compute_dtype,
    )
    return h + N.gate(h_ff, gate_mlp)


def _conv_block_apply(params, x, num_groups=1, compute_dtype=None):
    x = C.groupnorm(params["groupnorm"], x, num_groups)
    x = F.silu(x)
    return C.audiocraft_conv1d(params["project"], x, compute_dtype=compute_dtype)


def patcher_apply(params, x, compute_dtype=None):
    """ResnetBlock1d with patch_size=1 (reference: patcher.py:104-164). x: (B,C,T)."""
    h = _conv_block_apply(params["block1"], x, compute_dtype=compute_dtype)
    h = _conv_block_apply(params["block2"], h, compute_dtype=compute_dtype)
    if "to_out" in params:
        return h + C.conv1d(params["to_out"], x, compute_dtype=compute_dtype)
    return h + x


def dit_apply(params, x, time, *, cfg: TransformerConfig, padding_mask=None,
              memory=None, memory_padding_mask=None, compute_dtype=None):
    """x: (B, T, in_channels or dim); time: (B,); memory: (B, L, context_dim).
    Returns (B, T, out_channels). Reference: transformer.py:473-524."""
    if "data_proj" in params:
        x = N.linear(params["data_proj"], x, compute_dtype)
    h = patcher_apply(params["x_embedder"], x.transpose(1, 2),
                      compute_dtype=compute_dtype).transpose(1, 2)

    t = N.timestep_embedder(params["t_embedder"], time,
                            cfg.frequency_embedding_dim,
                            cfg.timestep_non_linearity, compute_dtype)
    t0 = N.get_nonlinearity(cfg.t_block_non_linearity)(t)
    t0 = N.linear(params["t_block"], t0, compute_dtype)  # (B, 6*dim)

    y = None
    if memory is not None:
        ym = memory
        if "norm" in params["y_embedder"]:
            ym = N.rmsnorm(params["y_embedder"]["norm"], ym, cfg.norm_eps)
        if compute_dtype is not None:
            ym = ym.to(compute_dtype)
        y = N.projection(params["y_embedder"]["projection"], ym,
                         cfg.context_non_linearity, compute_dtype)

    rope_tables = None
    if cfg.use_rope:
        rope_tables = precompute_rope(cfg.head_dim, h.shape[1],
                                      max(10000, 2 * cfg.max_positions),
                                      device=h.device)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        h = dit_block_apply(
            layer_slice(layers, i), h, cfg=cfg, cross_x=y, t0=t0,
            padding_mask=padding_mask, memory_padding_mask=memory_padding_mask,
            rope_tables=rope_tables, compute_dtype=compute_dtype,
        )

    shift, scale = (
        params["final_layer_scale_shift_table"][None].float() + t[:, None].float()
    ).to(h.dtype).transpose(0, 1)
    h = N.modulate(N.rmsnorm(params["norm"], h, cfg.norm_eps),
                   shift[:, None, :], scale[:, None, :])
    return N.linear(params["output"], h, compute_dtype)
