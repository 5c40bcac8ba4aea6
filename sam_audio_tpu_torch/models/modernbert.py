"""ModernBERT text encoder; counterpart of sam_audio_tpu/models/modernbert.py.

The judge scores text with the CLS vector of ModernBERT's hidden layer 22
(reference: sam_audio/model/judge.py:48, 74-88; config.py:246). HF
ModernBERT: token embeddings + LayerNorm; pre-norm layers with a fused QKV,
NeoX (rotate-half) RoPE, a global layer every `global_attn_every_n_layers`
(theta 160k) and sliding-window local layers (window `local_attention`,
theta 10k) between them; GeGLU MLPs with exact GELU; no biases; layer 0's
attention norm is the identity. Layers are a Python list.

`hidden_states[i]` follows HF: [0] is the embedding output, [i] the output of
layer i before the final norm; last_hidden_state = final_norm(hidden_states[-1]).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sam_audio_tpu_torch.config import ModernBertTextConfig
from sam_audio_tpu_torch.ops import nn as N

NEG = torch.finfo(torch.float32).min


def _neox_rope_tables(head_dim: int, seqlen: int, theta: float, device):
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2).astype(np.float64) / head_dim))
    freqs = np.outer(np.arange(seqlen, dtype=np.float64), inv_freq)
    emb = np.concatenate([freqs, freqs], axis=-1)   # (S, D)
    return (torch.as_tensor(np.cos(emb).astype(np.float32), device=device),
            torch.as_tensor(np.sin(emb).astype(np.float32), device=device))


def _apply_neox_rope(x, cos, sin):
    """x: (B, S, H, D), the rotate-half convention (HF)."""
    d = x.shape[-1]
    rotated = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return (x.float() * c + rotated.float() * s).to(x.dtype)


def _norm(params, x, eps):
    """LayerNorm without a bias, in fp32."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.square(xf - mean).mean(-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * params["weight"].float()).to(x.dtype)


def modernbert_encode(params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                      cfg: ModernBertTextConfig, compute_dtype=None,
                      output_hidden_states: bool = True
                      ) -> Tuple[torch.Tensor, Optional[List[torch.Tensor]]]:
    """(B, S) ids and mask -> (last_hidden_state, hidden_states)."""
    b, s = input_ids.shape
    n_heads = cfg.num_attention_heads
    head_dim = cfg.hidden_size // n_heads
    dev = input_ids.device

    h = N.embedding(params["embeddings"]["tok_embeddings"], input_ids)
    h = _norm(params["embeddings"]["norm"], h, cfg.norm_eps)
    if compute_dtype is not None:
        h = h.to(compute_dtype)
    hidden_states = [h] if output_hidden_states else None

    # fp32 additive biases, as in JAX: on a local layer a padded key outside
    # the window gets min + min = -inf, and a row keeps at least one finite
    # logit, so softmax stays finite
    pad_bias = torch.where(attention_mask.bool(), 0.0, NEG)[:, None, None, :]
    pos = torch.arange(s, device=dev)
    local_ok = (pos[:, None] - pos[None, :]).abs() <= cfg.local_attention // 2
    local_bias = torch.where(local_ok, 0.0, NEG)[None, None]
    rope = {True: _neox_rope_tables(head_dim, s, cfg.global_rope_theta, dev),
            False: _neox_rope_tables(head_dim, s, cfg.local_rope_theta, dev)}
    scale = 1.0 / (head_dim ** 0.5)

    for i, layer in enumerate(params["layers"]):
        is_global = i % cfg.global_attn_every_n_layers == 0
        x = h if i == 0 else _norm(layer["attn_norm"], h, cfg.norm_eps)
        qkv = N.linear(layer["attn"]["Wqkv"], x, compute_dtype).reshape(b, s, 3, n_heads,
                                                                          head_dim)
        cos, sin = rope[is_global]
        q = _apply_neox_rope(qkv[:, :, 0], cos, sin)
        k = _apply_neox_rope(qkv[:, :, 1], cos, sin)
        v = qkv[:, :, 2]
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale + pad_bias
        if not is_global:
            logits = logits + local_bias
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float()).to(v.dtype)
        h = h + N.linear(layer["attn"]["Wo"], attn.reshape(b, s, cfg.hidden_size),
                         compute_dtype)

        x = _norm(layer["mlp_norm"], h, cfg.norm_eps)
        inp, gate = N.linear(layer["mlp"]["Wi"], x, compute_dtype).chunk(2, dim=-1)
        h = h + N.linear(layer["mlp"]["Wo"], F.gelu(inp) * gate, compute_dtype)
        if output_hidden_states:
            hidden_states.append(h)

    return _norm(params["final_norm"], h, cfg.norm_eps), hidden_states
