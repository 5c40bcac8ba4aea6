"""Perception-Encoder CLIP image tower (PE-Core-L14-336); counterpart of
sam_audio_tpu/models/pe_clip.py.

The reference encodes the masked video frames with PE-Core-L14-336's
`encode_image`: L2-normalised 1024-d features, at most `batch_size` (300)
frames a call (reference: sam_audio/model/vision_encoder.py:40-113,
config.py:69-83). ViT-L/14 at 336 px: a 14x14/14 patch conv, CLS token and a
learned position table (577 tokens), 24 pre-LN layers of width 1024 (16
heads, GELU MLP x4), ln_post, an attentive-pool head and a projection to
`dim`, L2 normalisation. Optional axial 2-D RoPE (`use_rope2d`).

Preprocessing runs on the tensors' device: resize to 336 x 336 as
jax.image.resize(method="cubic") defines it (Keys cubic with a = -0.5,
half-pixel centres, the kernel widened by the scale when it shrinks, each
row of weights normalised; `resize_weights`), then /255 and (x - 0.5) / 0.5.
That is neither F.interpolate(mode="bicubic") (a = -0.75, no antialias) nor
the HTSAT resize of the CLAP tower.

In a low-precision compute dtype the attention logits are rounded to it
after the product (ops.attention.sdpa's `score_dtype`, as in the JAX
package); the (frames, 16, 577, 577) score matrix is the tower's largest
object. No Pallas kernel runs in this tower.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from sam_audio_tpu_torch.config import PerceptionEncoderConfig
from sam_audio_tpu_torch.ops import nn as N
from sam_audio_tpu_torch.ops.attention import attend
from sam_audio_tpu_torch.utils import unstack_layers


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5 (jax.image's "cubic")."""
    x = np.abs(x)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@lru_cache(maxsize=16)
def resize_weights(in_len: int, out_len: int) -> np.ndarray:
    """(in_len, out_len) float32 weights of one axis of jax.image.resize's
    antialiased cubic resize (scale_and_translate with no translation):
    sample i sits at (i + 0.5) * in / out - 0.5; the kernel is stretched by
    in / out when shrinking; each column is normalised to sum 1 and zeroed
    when its sample lies outside the input."""
    inv_scale = in_len / out_len
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_len, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_len, dtype=np.float64)[:, None]) / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_len - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def preprocess_frames(frames: torch.Tensor, cfg: PerceptionEncoderConfig) -> torch.Tensor:
    """(N, C, H, W) uint8 or float -> (N, C, S, S) normalised float32 on the
    frames' device (reference: vision_encoder.py:16-37, 92-113)."""
    x = frames.float()
    s = cfg.image_size
    if cfg.interpolation_mode.lower() not in ("bicubic", "cubic"):
        raise ValueError(f"unsupported interpolation_mode {cfg.interpolation_mode!r}")
    h, w = x.shape[-2:]
    if h != s:
        x = torch.einsum("nchw,hy->ncyw", x,
                         torch.as_tensor(resize_weights(h, s), device=x.device))
    if w != s:
        x = torch.einsum("nchw,wx->nchx", x,
                         torch.as_tensor(resize_weights(w, s), device=x.device))
    x = x / 255.0
    return (x - 0.5) / 0.5


def encode_images(params, x: torch.Tensor, cfg: PerceptionEncoderConfig,
                  compute_dtype=None, normalize: bool = True) -> torch.Tensor:
    """x: preprocessed (N, 3, S, S) -> (N, dim) fp32, L2-normalised."""
    n = x.shape[0]
    w = cfg.width
    heads = cfg.vit_heads
    hd = w // heads
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    pe_w = params["patch_embed"]["weight"].to(x.dtype)
    h = F.conv2d(x, pe_w, stride=cfg.patch_size)               # (N, w, g, g)
    if "bias" in params["patch_embed"]:
        h = h + params["patch_embed"]["bias"].to(h.dtype)[None, :, None, None]
    h = h.reshape(n, w, -1).transpose(1, 2)                      # (N, tokens, w)
    if cfg.use_cls_token:
        cls = params["cls_token"].reshape(1, 1, w).expand(n, 1, w).to(h.dtype)
        h = torch.cat([cls, h], dim=1)
    if "pos_embed" in params:   # absent on rope2d-only checkpoints
        h = h + params["pos_embed"][None].to(h.dtype)
    if "ln_pre" in params:
        h = N.layernorm(params["ln_pre"], h)

    rope = None
    if cfg.use_rope2d:
        from sam_audio_tpu_torch.ops.rope import apply_rope, precompute_rope_2d

        rope = precompute_rope_2d(hd, cfg.image_size // cfg.patch_size, cfg.rope2d_theta,
                                  n_prefix_tokens=1 if cfg.use_cls_token else 0,
                                  device=h.device)
    # the logits round to a low-precision compute dtype (ops.attention.sdpa)
    score_dtype = (compute_dtype if compute_dtype is not None
                   and torch.finfo(compute_dtype).bits < 32 else None)

    # under tensor parallelism (parallel/mesh.py) each rank runs its block of
    # heads and of the MLP's hidden units; wo and fc2 sum the partial outputs
    mlp = int(w * cfg.mlp_ratio)
    for layer in unstack_layers(params["layers"]):
        y = N.layernorm(layer["ln1"], h)
        att = layer["attn"]
        q, k, v = (N.whole_heads(N.column_linear(att[nm], y, compute_dtype, w), hd)
                   .reshape(n, y.shape[1], -1, hd) for nm in ("wq", "wk", "wv"))
        if rope is not None:
            q, k = apply_rope(q, *rope), apply_rope(k, *rope)
        o = attend(q, k, v, score_dtype=score_dtype).reshape(n, y.shape[1], -1)
        h = h + N.row_linear(att["wo"], o, compute_dtype, w)
        y = N.layernorm(layer["ln2"], h)
        y = F.gelu(N.column_linear(layer["mlp"]["fc1"], y, compute_dtype, mlp),
                   approximate="tanh")
        h = h + N.row_linear(layer["mlp"]["fc2"], y, compute_dtype, mlp)
    h = N.layernorm(params["ln_post"], h)

    # attentive pooling: one probe query over all tokens
    ap = params["attn_pool"]
    probe = ap["probe"][None].expand(n, 1, w).to(h.dtype)
    q = N.linear(ap["wq"], probe, compute_dtype).reshape(n, 1, heads, hd)
    k = N.linear(ap["wk"], h, compute_dtype).reshape(n, -1, heads, hd)
    v = N.linear(ap["wv"], h, compute_dtype).reshape(n, -1, heads, hd)
    pooled = attend(q, k, v).reshape(n, w)
    pooled = N.layernorm(ap["ln"], N.linear(ap["wo"], pooled, compute_dtype))
    out = N.linear(params["proj"], pooled, compute_dtype).float()
    if normalize:
        out = out / torch.clamp(torch.linalg.norm(out, dim=-1, keepdim=True), min=1e-8)
    return out


class PerceptionEncoder:
    """The reference VisionEncoder's behaviour: each video encoded in chunks
    of at most `cfg.batch_size` frames, the batch right-padded to its
    longest video (reference: vision_encoder.py:47-69). Runs on `device`,
    in `compute_dtype` (bf16, as the JAX package's tower)."""

    def __init__(self, cfg: PerceptionEncoderConfig, params, device="cuda",
                 compute_dtype=torch.bfloat16):
        from sam_audio_tpu_torch.checkpoint import cast_matmul_weights
        from sam_audio_tpu_torch.models.sam_audio import resolve_device

        self.cfg = cfg
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        # set by SAMAudio.shard: the layers hold this rank's tp blocks
        self.mesh = None
        if compute_dtype is not None and compute_dtype != torch.float32:
            # the stacked layer norms are (layers, width): kept fp32, as read
            params = cast_matmul_weights(params, compute_dtype, keep=("ln1", "ln2"))
        self.params = params

    @classmethod
    def init_random(cls, cfg: PerceptionEncoderConfig, seed: int = 0, device="cuda",
                    compute_dtype=torch.bfloat16):
        from sam_audio_tpu_torch.models.init import pe_clip_init
        from sam_audio_tpu_torch.models.sam_audio import resolve_device

        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, pe_clip_init(cfg, gen, dev), dev, compute_dtype)

    @classmethod
    def from_pretrained(cls, path: str, cfg: PerceptionEncoderConfig = PerceptionEncoderConfig(),
                        device="cuda", compute_dtype=torch.bfloat16):
        """`path`: the npz that `python -m sam_audio_tpu_torch.convert pe-clip`
        writes from a PE-Core checkpoint."""
        from sam_audio_tpu_torch.checkpoint import load_params
        from sam_audio_tpu_torch.models.sam_audio import resolve_device

        dev = resolve_device(device)
        return cls(cfg, load_params(path, dev), dev, compute_dtype)

    @torch.inference_mode()
    def __call__(self, videos: Sequence[np.ndarray]) -> torch.Tensor:
        """videos: per item (N_i, C, H, W) frames -> (B, N_max, dim) fp32 on
        the device, zero rows past each video's end."""
        from sam_audio_tpu_torch.parallel import comm

        with comm.use_tp(None if self.mesh is None else self.mesh.group("tp")):
            return self._encode(videos)

    def _encode(self, videos: Sequence[np.ndarray]) -> torch.Tensor:
        feats: List[torch.Tensor] = []
        bs = self.cfg.batch_size
        for video in videos:
            v = preprocess_frames(torch.as_tensor(np.asarray(video), device=self.device),
                                  self.cfg)
            step = bs if bs > 0 else v.shape[0]
            feats.append(torch.cat([
                encode_images(self.params, v[i: i + step], self.cfg, self.compute_dtype)
                for i in range(0, v.shape[0], step)]))
        n_max = max(f.shape[0] for f in feats)
        return torch.stack([F.pad(f, (0, 0, 0, n_max - f.shape[0])) for f in feats])


def interp_strided_features(feats: torch.Tensor, n_full: int, stride: int) -> torch.Tensor:
    """Features encoded at frames 0, stride, 2 * stride, ... linearly
    interpolated to all `n_full` frames. feats: (ceil(n_full / stride), D).
    Frames past the last encoded one hold its value; the identity at
    stride 1."""
    pos = torch.arange(n_full, device=feats.device) / stride
    lo = torch.clamp(torch.floor(pos).long(), 0, feats.shape[0] - 1)
    hi = torch.clamp(lo + 1, 0, feats.shape[0] - 1)
    w = (pos - lo).to(feats.dtype)[:, None]
    return feats[lo] * (1 - w) + feats[hi] * w


def encode_videos(model, masked_videos, t_frames: int, stride: int = 1) -> torch.Tensor:
    """SAMAudio._encode_videos: per item (N, C, H, W) -> (B, vision_dim, T)
    on the model's device, aligned to the T latent frames.

    stride > 1 (opt-in, not the reference's semantics, which encodes every
    frame, vision_encoder.py:47-69): every stride-th frame goes through the
    tower and the features are linearly interpolated to all frames."""
    enc = model.vision_encoder
    if enc is None:
        if not model.allow_random_towers:
            raise ValueError(
                "Visual prompting needs a PE-Core vision tower and model.vision_encoder is "
                "None. Convert one with `python -m sam_audio_tpu_torch.convert pe-clip "
                "--torch PE-Core-L14-336.pt --out pe_clip.npz` and attach "
                "PerceptionEncoder.from_pretrained('pe_clip.npz'), or construct the model "
                "with allow_random_towers=True for tests only. The reference always loads "
                "real PE weights (sam_audio/model/vision_encoder.py:86-90).")
        enc = PerceptionEncoder.init_random(model.cfg.vision_encoder, seed=0,
                                            device=model.device)
        model.vision_encoder = enc
    if stride > 1:
        lens = [int(np.asarray(v).shape[0]) for v in masked_videos]
        feats_s = enc([np.asarray(v)[::stride] for v in masked_videos])
        n_max = max(lens)
        feats = torch.stack([
            F.pad(interp_strided_features(feats_s[i, : -(-n // stride)], n, stride),
                  (0, 0, 0, n_max - n))
            for i, n in enumerate(lens)])
    else:
        feats = enc(masked_videos)                              # (B, N_max, dim)
    n = feats.shape[1]
    if n != t_frames:
        feats = F.pad(feats, (0, 0, 0, max(0, t_frames - n)))[:, :t_frames]
    return feats.transpose(1, 2).to(model.device)               # (B, dim, T)
