"""PE-AV audio transformer encoder; counterpart of sam_audio_tpu/models/peav.py.

The judge runs both audios through a shared Perception-Encoder-AV
`Transformer` and a second "finetune" one (reference:
sam_audio/model/judge.py:7-8, 46-47, 101-126). One parameter layout (per
layer: ln1, attn {wq, wk, wv, wo}, ln2, mlp {fc1, fc2} or swiglu {w1, w2,
w3}; optional per-head q/k norms, bias_k/bias_v and layer scales; optional
top-level pos_embed, ln_pre and final_norm) runs every block style the
converters (convert.convert_peav_tower) map onto it, with the switches of the
config (prenorm, act, pos, norm). Layers are stacked on axis 0. Self-attention
goes through ops.attention.attend, as in the JAX package: 128-wide heads over
>= 1024 frames with no bias_k take the flash kernel (kernel 2), everything
else the plain `sdpa` (the default judge's 64-wide heads over 250 frames, and
ImageBind's trunks). The ImageBind models run their trunks through this
body too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from sam_audio_tpu_torch.config import PEAVTransformerConfig
from sam_audio_tpu_torch.ops import nn as N
from sam_audio_tpu_torch.ops.attention import attend
from sam_audio_tpu_torch.ops.rope import apply_rope, precompute_rope
from sam_audio_tpu_torch.utils import unstack_layers


@dataclass
class BaseModelOutputWithPooling:
    last_hidden_state: torch.Tensor
    pooler_output: Optional[torch.Tensor] = None


_ACTS = {
    "gelu": F.gelu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "relu": F.relu,
    "silu": F.silu,
}


def _per_head_norm(params, x, eps):
    """LayerNorm (with a bias) or RMSNorm over the head dim; x: (B, T, H, D)."""
    w = params["weight"].float()
    xf = x.float()
    if "bias" in params:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) / torch.sqrt(var + eps) * w + params["bias"].float()
    else:
        out = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps) * w
    return out.to(x.dtype)


def _attention(a, y, b, t, nh, hd, eps, rope, padding_mask, compute_dtype):
    q, k, v = (N.linear(a[n], y, compute_dtype).reshape(b, t, nh, hd)
               for n in ("wq", "wk", "wv"))
    if "q_norm" in a:
        q = _per_head_norm(a["q_norm"], q, eps)
    if "k_norm" in a:
        k = _per_head_norm(a["k_norm"], k, eps)
    if rope is not None:
        q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    mask = padding_mask
    if "bias_k" in a:   # torch MHA add_bias_kv: one learned key/value token
        k = torch.cat([k, a["bias_k"].reshape(1, 1, nh, hd).expand(b, 1, nh, hd).to(k.dtype)], 1)
        v = torch.cat([v, a["bias_v"].reshape(1, 1, nh, hd).expand(b, 1, nh, hd).to(v.dtype)], 1)
        if mask is not None:
            mask = torch.cat([mask, torch.ones((b, 1), dtype=mask.dtype, device=mask.device)], 1)
    o = attend(q, k, v, key_padding_mask=mask)
    return N.linear(a["wo"], o.reshape(b, t, nh * hd), compute_dtype)


def _mlp(m, y, act, compute_dtype):
    if "w3" in m:   # swiglu (llama convention: w1 gate, w3 up, w2 down)
        return N.linear(m["w2"], F.silu(N.linear(m["w1"], y, compute_dtype))
                        * N.linear(m["w3"], y, compute_dtype), compute_dtype)
    return N.linear(m["fc2"], act(N.linear(m["fc1"], y, compute_dtype)), compute_dtype)


def peav_apply(params, x: torch.Tensor, cfg: PEAVTransformerConfig,
               padding_mask: Optional[torch.Tensor] = None,
               compute_dtype=None) -> BaseModelOutputWithPooling:
    """x: (B, T, hidden); padding_mask: (B, T) bool, True = valid."""
    b, t, h = x.shape
    nh = cfg.num_heads
    hd = h // nh
    eps = cfg.layer_norm_eps
    act = None if cfg.act == "swiglu" else _ACTS[cfg.act]
    norm_fn = N.layernorm if cfg.norm == "layernorm" else N.rmsnorm

    def norm(p, y):
        return norm_fn(p, y, eps)

    if "pos_embed" in params:
        x = x + params["pos_embed"][:t][None].to(x.dtype)
    elif cfg.pos == "sinusoidal":
        pos = N.sinusoidal_embedding(torch.arange(t, device=x.device, dtype=torch.float32), h)
        x = x + pos[None].to(x.dtype)
    # interleaved-pair rotary (perception-models freqs_cis); theta from the
    # checkpoint's inv_freq
    rope = precompute_rope(hd, t, cfg.rope_theta, device=x.device) if cfg.pos == "rope" else None
    if "ln_pre" in params:
        x = norm(params["ln_pre"], x)
    if compute_dtype is not None:
        x = x.to(compute_dtype)

    for layer in unstack_layers(params["layers"]):
        if cfg.prenorm:
            a = _attention(layer["attn"], norm(layer["ln1"], x), b, t, nh, hd, eps, rope,
                           padding_mask, compute_dtype)
            if "ls1" in layer:
                a = a * layer["ls1"].to(a.dtype)
            x = x + a
            m = _mlp(layer["mlp"], norm(layer["ln2"], x), act, compute_dtype)
            if "ls2" in layer:
                m = m * layer["ls2"].to(m.dtype)
            x = x + m
        else:   # post-LN (BERT style)
            x = norm(layer["ln1"], x + _attention(layer["attn"], x, b, t, nh, hd, eps, rope,
                                                  padding_mask, compute_dtype))
            x = norm(layer["ln2"], x + _mlp(layer["mlp"], x, act, compute_dtype))
    if "final_norm" in params:
        x = norm(params["final_norm"], x)
    x = x.float()
    if padding_mask is not None:
        m = padding_mask[:, :, None].float()
        pooled = (x * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
    else:
        pooled = x.mean(1)
    return BaseModelOutputWithPooling(last_hidden_state=x, pooler_output=pooled)
