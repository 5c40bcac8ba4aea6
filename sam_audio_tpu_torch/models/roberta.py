"""RoBERTa, the CLAP text tower (counterpart of sam_audio_tpu/models/roberta.py).

laion_clap's text branch is an HF `RobertaModel` whose `pooler_output` feeds
`text_projection`: a post-LN BERT encoder with RoBERTa's padding-offset
position ids and the tanh pooler. Layers are stacked on axis 0, as in the JAX
tree; the layer loop is a Python loop.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from sam_audio_tpu_torch.ops import nn as N
from sam_audio_tpu_torch.ops.attention import attend
from sam_audio_tpu_torch.utils import unstack_layers


@dataclass(frozen=True)
class RobertaConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5


def roberta_position_ids(input_ids: torch.Tensor, pad_token_id: int) -> torch.Tensor:
    """Non-pad token i gets position pad_id + (its 1-based index among the
    non-pad tokens); pad tokens get pad_id."""
    mask = (input_ids != pad_token_id).long()
    return torch.cumsum(mask, dim=1) * mask + pad_token_id


def roberta_encode(params, input_ids, attention_mask, cfg: RobertaConfig,
                   compute_dtype=None):
    """Returns (last_hidden_state (B, L, H) fp32, pooler_output (B, H), or
    None for a tree without a pooler)."""
    b, t = input_ids.shape
    h, nh, eps = cfg.hidden_size, cfg.num_heads, cfg.layer_norm_eps
    valid = attention_mask.bool()
    ids = input_ids.long()
    x = (N.embedding(params["word_embeddings"], ids)
         + N.embedding(params["position_embeddings"],
                       roberta_position_ids(ids, cfg.pad_token_id))
         + params["token_type_embeddings"]["weight"][0][None, None, :])
    x = N.layernorm(params["emb_ln"], x, eps)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    for layer in unstack_layers(params["layers"]):
        a = layer["attn"]
        q = N.linear(a["wq"], x, compute_dtype).reshape(b, t, nh, -1)
        k = N.linear(a["wk"], x, compute_dtype).reshape(b, t, nh, -1)
        v = N.linear(a["wv"], x, compute_dtype).reshape(b, t, nh, -1)
        o = attend(q, k, v, key_padding_mask=valid).reshape(b, t, h)
        attn_out = N.layernorm(layer["attn_ln"], x + N.linear(a["wo"], o, compute_dtype),
                               eps)
        ffn = N.linear(layer["fc2"], F.gelu(N.linear(layer["fc1"], attn_out, compute_dtype)),
                       compute_dtype)
        x = N.layernorm(layer["ffn_ln"], attn_out + ffn, eps)
    x = x.float()
    pooled = None
    if "pooler" in params:
        pooled = torch.tanh(N.linear(params["pooler"], x[:, 0], None))
    return x, pooled
