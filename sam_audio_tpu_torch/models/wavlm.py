"""WavLM speech encoder (microsoft/wavlm, HF layout) in PyTorch.

Counterpart of sam_audio_tpu/models/wavlm.py: the backbone of the
audiobox-aesthetics predictor behind the Aesthetic eval metric
(models/aesthetics.py). Plain functions over the JAX package's parameter
tree (bridged by checkpoint.params_from_numpy; converted from a torch
checkpoint by convert.convert_wavlm_state_dict; random from
models.init.wavlm_init).

  feature extractor: 7 strided conv1d (kernels 10,3,3,3,3,2,2; strides
    5,2,2,2,2,2,2), GroupNorm after conv 0 ("group", wavlm-base) or a
    LayerNorm after every conv ("layer", wavlm-large), exact GELU;
  feature projection: LayerNorm -> Linear;
  encoder: a grouped positional conv (k=128, 16 groups, trailing sample
    dropped, GELU) added to the input, then post-LN layers (base) or pre-LN
    layers with a final LayerNorm (large). Self-attention adds a T5-style
    bucketed position bias held in layer 0 and shared by every layer, gated
    per (batch, head, query) by sigmoids of each layer's own input; scores
    and softmax in fp32, padded keys at -inf.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from sam_audio_tpu_torch.ops import nn as N
from sam_audio_tpu_torch.ops.conv import groupnorm


@dataclass(frozen=True)
class WavLMConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: tuple = (512, 512, 512, 512, 512, 512, 512)
    conv_stride: tuple = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: tuple = (10, 3, 3, 3, 3, 2, 2)
    num_buckets: int = 320
    max_distance: int = 800
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    # "group": GroupNorm after conv 0 only, convs bias-free (wavlm-base);
    # "layer": LayerNorm after every conv, convs with bias (wavlm-large).
    feat_extract_norm: str = "group"
    do_stable_layer_norm: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "WavLMConfig":
        """A config.json entry (lists where the dataclass has tuples)."""
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


def _relative_position_buckets(qlen: int, klen: int, num_buckets: int,
                               max_distance: int) -> np.ndarray:
    """T5-style log buckets (HF WavLMAttention._relative_positions_bucket)."""
    ctx = np.arange(qlen)[:, None]
    mem = np.arange(klen)[None, :]
    rel = mem - ctx
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact)
        / math.log(max_distance / max_exact) * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return buckets + np.where(is_small, rel, large)


def frame_lengths(cfg: WavLMConfig, sample_lengths: torch.Tensor) -> torch.Tensor:
    """Valid frames of each row from its valid samples, through the conv
    arithmetic (floor division, as JAX's on int32)."""
    lens = sample_lengths
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        lens = torch.div(lens - k, s, rounding_mode="floor") + 1
    return lens


def _gelu(x):
    return F.gelu(x)   # exact (erf), as jax.nn.gelu(approximate=False)


def feature_extract(params, cfg: WavLMConfig, wav: torch.Tensor,
                    compute_dtype=None) -> torch.Tensor:
    """wav: (B, T) -> (B, frames, conv_dim[-1]); 16 kHz in, 50 fps out."""
    x = wav[:, None, :]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    for i, conv in enumerate(params["feature_extractor"]):
        w = conv["weight"]
        if compute_dtype is not None:
            w = w.to(compute_dtype)
        dtype = torch.promote_types(x.dtype, w.dtype)
        x = F.conv1d(x.to(dtype), w.to(dtype), stride=cfg.conv_stride[i])
        if "bias" in conv:
            x = x + conv["bias"].to(x.dtype)[None, :, None]
        if "group_norm" in conv:
            x = groupnorm(conv["group_norm"], x, num_groups=x.shape[1])
        elif "layer_norm" in conv:
            # cross-channel LN (HF WavLMLayerNormConvLayer: transpose, LN, back)
            x = N.layernorm(conv["layer_norm"], x.transpose(1, 2),
                            cfg.layer_norm_eps).transpose(1, 2)
        x = _gelu(x)
    return x.transpose(1, 2)


def _positional_conv(params, cfg: WavLMConfig, h: torch.Tensor, compute_dtype):
    """Grouped conv positional embedding, same-pad with one trailing sample
    dropped (HF WavLMPositionalConvEmbedding: pad 64 both sides, k=128)."""
    w = params["pos_conv"]["weight"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
    pos = F.conv1d(h.transpose(1, 2).to(w.dtype), w,
                   padding=cfg.num_conv_pos_embeddings // 2,
                   groups=cfg.num_conv_pos_embedding_groups)
    pos = pos + params["pos_conv"]["bias"].to(pos.dtype)[None, :, None]
    if cfg.num_conv_pos_embeddings % 2 == 0:
        pos = pos[:, :, :-1]
    return _gelu(pos.transpose(1, 2))


def _attention(a, x, position_bias, attn_mask, nh, compute_dtype):
    b, t, hidden = x.shape
    hd = hidden // nh
    # the layer's gate on the shared bias: sigmoid projections of the
    # attention input, per (batch, head, query)
    ghs = x.reshape(b, t, nh, hd).transpose(1, 2)
    proj = N.linear(a["gru_rel_pos_linear"], ghs, compute_dtype)
    gates = torch.sigmoid(proj.reshape(b, nh, t, 2, 4).sum(-1).float())
    gate_a, gate_b = gates[..., 0:1], gates[..., 1:2]
    const = a["gru_rel_pos_const"].float()
    gate = gate_a * (gate_b * const - 1.0) + 2.0             # (B, H, T, 1)
    gated_bias = gate * position_bias[None]                  # (B, H, Tq, Tk)

    q = N.linear(a["q_proj"], x, compute_dtype).reshape(b, t, nh, hd)
    k = N.linear(a["k_proj"], x, compute_dtype).reshape(b, t, nh, hd)
    v = N.linear(a["v_proj"], x, compute_dtype).reshape(b, t, nh, hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores * (hd ** -0.5) + gated_bias
    if attn_mask is not None:
        scores = scores + attn_mask
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, hidden)
    return N.linear(a["out_proj"], ctx, compute_dtype)


def wavlm_encode(params, cfg: WavLMConfig, wav: torch.Tensor,
                 pad_mask: torch.Tensor | None = None, compute_dtype=None,
                 output_hidden_states: bool = False):
    """wav: (B, T) at 16 kHz; pad_mask: (B, T) bool, True = valid sample.
    Returns the final hidden states (B, frames, hidden), or the list of all
    num_layers + 1 hidden states."""
    eps = cfg.layer_norm_eps
    feats = feature_extract(params, cfg, wav, compute_dtype)
    h = N.layernorm(params["feature_projection"]["layer_norm"], feats, eps)
    h = N.linear(params["feature_projection"]["projection"], h, compute_dtype)

    attn_mask = None
    if pad_mask is not None:
        lens = frame_lengths(cfg, pad_mask.to(torch.int32).sum(-1))
        frame_mask = torch.arange(h.shape[1], device=h.device)[None, :] < lens[:, None]
        h = torch.where(frame_mask[:, :, None], h, 0.0)
        attn_mask = torch.where(frame_mask[:, None, None, :], 0.0, -math.inf)

    h = h + _positional_conv(params, cfg, h, compute_dtype)
    prenorm = cfg.do_stable_layer_norm
    if not prenorm:
        # the post-LN layout normalises before the stack; the stable (pre-LN)
        # layout applies encoder_layer_norm after the last layer instead
        h = N.layernorm(params["encoder_layer_norm"], h, eps)

    t = h.shape[1]
    buckets = _relative_position_buckets(t, t, cfg.num_buckets, cfg.max_distance)
    rel_embed = params["layers"][0]["attention"]["rel_attn_embed"].float()
    # (T, T, H) gathered -> (H, Tq, Tk), shared ungated across layers
    position_bias = rel_embed[torch.as_tensor(buckets, device=h.device)].permute(2, 0, 1)

    all_hidden = [h]
    for layer in params["layers"]:
        x_attn = N.layernorm(layer["layer_norm"], h, eps) if prenorm else h
        attn_out = _attention(layer["attention"], x_attn, position_bias, attn_mask,
                              cfg.num_heads, compute_dtype)
        if prenorm:
            h = h + attn_out
            ff = _gelu(N.linear(layer["intermediate_dense"],
                                N.layernorm(layer["final_layer_norm"], h, eps), compute_dtype))
            h = h + N.linear(layer["output_dense"], ff, compute_dtype)
        else:
            h = N.layernorm(layer["layer_norm"], h + attn_out, eps)
            ff = _gelu(N.linear(layer["intermediate_dense"], h, compute_dtype))
            ff = N.linear(layer["output_dense"], ff, compute_dtype)
            h = N.layernorm(layer["final_layer_norm"], h + ff, eps)
        all_hidden.append(h)

    if prenorm:
        h = N.layernorm(params["encoder_layer_norm"], h, eps)
        all_hidden[-1] = h
    return all_hidden if output_hidden_states else h
