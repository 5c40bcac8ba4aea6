"""ImageBind audio and vision towers, the visual ranker's scorers; counterpart
of sam_audio_tpu/models/imagebind.py (reference: sam_audio/ranking/
imagebind.py:30-197).

Audio branch (reference imagebind.py:30-86): waveform -> 16 kHz -> 3 clips
of 2 s -> per clip a 128-bin Kaldi fbank of 204 frames (25 ms window, 10 ms
hop) -> Normalize(-4.268, 9.138) -> ViT -> the clips' mean embedding.
Vision branch (reference imagebind.py:89-150): frames -> 5 temporal clips ->
short side scaled to 224, spatial crops -> ViT -> the mean over clips and
crops. The score is the cosine of the two.

Two scorers: `ImageBindHugeModel`, weight-faithful to imagebind_huge (conv
stems, CLS token, trunks through models/peav.py's body with torch-MHA
bias_kv and layer scale, LayerNorm + Linear heads; a checkpoint converts with
convert.convert_imagebind_state_dict), and `ImageBindModel`, the JAX
package's light structural towers (linear patch embeddings). Both run fp32,
as in the JAX package. The frame transforms are host numpy; the candidates'
audio path has a host form (`embed_audio`: numpy resample and fbank) and a
device form (`embed_audio_device`: resample, fbank and tower on the card).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from sam_audio_tpu_torch.config import PEAVTransformerConfig
from sam_audio_tpu_torch.models.peav import peav_apply
from sam_audio_tpu_torch.ops import nn as N
from sam_audio_tpu_torch.ops.mel import kaldi_fbank, kaldi_fbank_torch
from sam_audio_tpu_torch.ops.resample import resample, resample_np

AUDIO_MEAN = -4.268
AUDIO_STD = 9.138
VIDEO_MEAN = (0.48145466, 0.4578275, 0.40821073)
VIDEO_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class ImageBindConfig:
    """The audio and vision pipelines, and the light towers' widths."""

    sample_rate: int = 16_000
    clip_duration_s: float = 2.0
    num_audio_clips: int = 3
    n_mels: int = 128
    target_frames: int = 204
    n_fft: int = 400
    hop_length: int = 160
    audio_patch: int = 16
    audio_hidden: int = 256
    audio_layers: int = 4
    audio_heads: int = 4
    image_size: int = 224
    image_patch: int = 32
    num_video_clips: int = 5
    vision_hidden: int = 256
    vision_layers: int = 4
    vision_heads: int = 4
    embed_dim: int = 512


@dataclass(frozen=True)
class ImageBindHugeConfig:
    """The published imagebind_huge audio and vision branches. The block
    switches (layer scale, bias_kv, pre-LN) come with the weights."""

    audio_dim: int = 768
    audio_layers: int = 12
    audio_heads: int = 12
    audio_kernel: int = 16
    audio_stride: int = 10
    n_mels: int = 128
    target_frames: int = 204
    vision_dim: int = 1280
    vision_layers: int = 32
    vision_heads: int = 16
    vision_patch: int = 14
    vision_frames: int = 2   # PadIm2Video repeats a still image twice
    image_size: int = 224
    embed_dim: int = 1024
    ln_eps: float = 1e-6


def _l2_normalize(emb: torch.Tensor) -> torch.Tensor:
    return emb / torch.clamp(torch.linalg.norm(emb, dim=-1, keepdim=True), min=1e-8)


# ---------------------------------------------------------------------------
# Audio frontend
# ---------------------------------------------------------------------------


def clip_start_times(duration_s: float, clip_duration_s: float, num_clips: int) -> np.ndarray:
    """pytorchvideo ConstantClipsPerVideoSampler: starts spaced by
    max(duration - clip_duration, 0) / num_clips (not / (n - 1)), one per
    clip (reference imagebind.py:46-66)."""
    max_start = max(duration_s - clip_duration_s, 0.0)
    return np.arange(num_clips) * (max_start / num_clips)


def audio_to_melclips(wav: np.ndarray, cfg: ImageBindConfig) -> np.ndarray:
    """(T,) at cfg.sample_rate -> (num_clips, target_frames, n_mels) host
    numpy (imagebind.data.waveform2melspec, reference imagebind.py:67-86):
    per clip the mean removed, the Kaldi fbank (hanning window, dither 0),
    the frame axis zero-padded or cut to target_frames, then Normalize. The
    clip starts depend on the true duration."""
    sr = cfg.sample_rate
    t = wav.shape[-1]
    clip_len = int(cfg.clip_duration_s * sr)
    out = []
    for s in clip_start_times(t / sr, cfg.clip_duration_s, cfg.num_audio_clips):
        clip = wav[int(s * sr): int((s + cfg.clip_duration_s) * sr)]
        if clip.shape[-1] == 0:
            clip = np.zeros((min(t, clip_len) or clip_len,), wav.dtype)
        fb = kaldi_fbank(clip - clip.mean(), sample_frequency=sr, num_mel_bins=cfg.n_mels,
                         frame_length=25.0, frame_shift=10.0, window_type="hanning")
        f = fb.shape[0]
        out.append(np.pad(fb, ((0, cfg.target_frames - f), (0, 0))) if f < cfg.target_frames
                   else fb[: cfg.target_frames])
    return ((np.stack(out) - AUDIO_MEAN) / AUDIO_STD).astype(np.float32)


def audio_to_melclips_torch(wav: torch.Tensor, cfg: ImageBindConfig) -> torch.Tensor:
    """Batched `audio_to_melclips` on the tensors' device (JAX:
    audio_to_melclips_jax): (B, T) at cfg.sample_rate, all of true length T
    -> (B, num_clips, target_frames, n_mels)."""
    b, t = wav.shape
    sr = cfg.sample_rate
    clip_len = int(cfg.clip_duration_s * sr)
    out = []
    for s in clip_start_times(t / sr, cfg.clip_duration_s, cfg.num_audio_clips):
        clip = wav[:, int(s * sr): int((s + cfg.clip_duration_s) * sr)]
        if clip.shape[-1] == 0:
            clip = wav.new_zeros((b, min(t, clip_len) or clip_len))
        fb = kaldi_fbank_torch(clip - clip.mean(dim=-1, keepdim=True), sample_frequency=sr,
                               num_mel_bins=cfg.n_mels, frame_length=25.0, frame_shift=10.0,
                               window_type="hanning")
        f = fb.shape[-2]
        out.append(F.pad(fb, (0, 0, 0, cfg.target_frames - f)) if f < cfg.target_frames
                   else fb[:, : cfg.target_frames])
    return (torch.stack(out, dim=1) - AUDIO_MEAN) / AUDIO_STD


# ---------------------------------------------------------------------------
# Vision frontend (host numpy)
# ---------------------------------------------------------------------------


def _bilinear_resize_np(x: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """(N, C, H, W) float32 bilinear resize (half-pixel centres)."""
    _, _, h, w = x.shape

    def axis_weights(out_len, in_len):
        pos = (np.arange(out_len, dtype=np.float64) + 0.5) * in_len / out_len - 0.5
        lo = np.floor(pos).astype(np.int64)
        frac = (pos - lo).astype(np.float32)
        return np.clip(lo, 0, in_len - 1), np.clip(lo + 1, 0, in_len - 1), frac

    y0, y1, fy = axis_weights(nh, h)
    x0, x1, fx = axis_weights(nw, w)
    rows = x[:, :, y0] * (1.0 - fy)[None, None, :, None] + x[:, :, y1] * fy[None, None, :, None]
    out = (rows[:, :, :, x0] * (1.0 - fx)[None, None, None, :]
           + rows[:, :, :, x1] * fx[None, None, None, :])
    return out.astype(np.float32)


def video_to_clips(frames: np.ndarray, cfg: ImageBindConfig) -> np.ndarray:
    """(N, C, H, W) -> (num_clips, C, S, S) for the light towers: clips
    evenly in time, short side scaled to S, the centre crop, /255."""
    n = frames.shape[0]
    idx = np.linspace(0, max(n - 1, 0), cfg.num_video_clips).astype(int)
    sel = np.asarray(frames[idx], np.float32)
    h, w = sel.shape[2:]
    s = cfg.image_size
    scale = s / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    sel = _bilinear_resize_np(sel, nh, nw)
    top, left = (nh - s) // 2, (nw - s) // 2
    return sel[:, :, top: top + s, left: left + s] / 255.0


def video_to_frame_clips(frames: np.ndarray, num_clips: int = 5, frames_per_clip: int = 2,
                         size: int = 224, num_crops: int = 1) -> np.ndarray:
    """The reference VideoTransform (imagebind.py:89-150): `num_clips`
    temporal clips of `frames_per_clip` frames, /255 and the CLIP
    statistics, short side scaled to `size`, spatial crops (1: centre;
    3: along the long side). (N, 3, H, W) -> (num_clips * num_crops, 3,
    frames_per_clip, S, S)."""
    n = frames.shape[0]
    bounds = np.linspace(0, n, num_clips + 1)
    clip_sets = []
    for ci in range(num_clips):
        lo, hi = int(np.floor(bounds[ci])), max(int(np.ceil(bounds[ci + 1])), 1)
        hi = max(hi, lo + 1)
        idx = np.linspace(lo, hi - 1, frames_per_clip).astype(int).clip(0, n - 1)
        clip_sets.append(frames[idx])
    clips = np.stack(clip_sets).astype(np.float32) / 255.0
    mean = np.asarray(VIDEO_MEAN, np.float32)[None, None, :, None, None]
    std = np.asarray(VIDEO_STD, np.float32)[None, None, :, None, None]
    clips = (clips - mean) / std
    nc, t, c, h, w = clips.shape
    scale = size / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    clips = _bilinear_resize_np(clips.reshape(nc * t, c, h, w), nh, nw).reshape(nc, t, c, nh, nw)
    if num_crops == 1:
        offsets = [((nh - size) // 2, (nw - size) // 2)]
    elif nh >= nw:
        offsets = [(0, 0), ((nh - size) // 2, 0), (nh - size, 0)]
    else:
        offsets = [(0, 0), (0, (nw - size) // 2), (0, nw - size)]
    out = np.concatenate([clips[:, :, :, top: top + size, left: left + size]
                          for top, left in offsets])
    return out.transpose(0, 2, 1, 3, 4)


# ---------------------------------------------------------------------------
# The light towers
# ---------------------------------------------------------------------------


def _light_tf(hidden, layers, heads):
    return PEAVTransformerConfig(hidden_size=hidden, num_layers=layers, num_heads=heads)


def encode_audio(params, cfg: ImageBindConfig, melclips: torch.Tensor,
                 compute_dtype=None) -> torch.Tensor:
    """melclips: (B, clips, F, M) -> (B, embed_dim), L2-normalised."""
    b, c, f, m = melclips.shape
    p = cfg.audio_patch
    f_t, m_t = (f // p) * p, (m // p) * p
    x = melclips[:, :, :f_t, :m_t].reshape(b * c, f_t // p, p, m_t // p, p)
    patches = x.permute(0, 1, 3, 2, 4).reshape(b * c, -1, p * p)
    if compute_dtype is not None:
        patches = patches.to(compute_dtype)
    h = N.linear(params["audio"]["patch_embed"], patches, compute_dtype)
    out = peav_apply(params["audio"]["transformer"], h,
                     _light_tf(cfg.audio_hidden, cfg.audio_layers, cfg.audio_heads),
                     compute_dtype=compute_dtype)
    emb = N.linear(params["audio"]["proj"], out.pooler_output, compute_dtype)
    return _l2_normalize(emb.float().reshape(b, c, -1).mean(dim=1))


def encode_vision(params, cfg: ImageBindConfig, clips: torch.Tensor,
                  compute_dtype=None) -> torch.Tensor:
    """clips: (B, clips, 3, S, S) -> (B, embed_dim), L2-normalised."""
    b, c, ch, s, _ = clips.shape
    p = cfg.image_patch
    g = s // p
    x = clips.reshape(b * c, ch, g, p, g, p)
    patches = x.permute(0, 2, 4, 1, 3, 5).reshape(b * c, g * g, ch * p * p)
    if compute_dtype is not None:
        patches = patches.to(compute_dtype)
    h = N.linear(params["vision"]["patch_embed"], patches, compute_dtype)
    out = peav_apply(params["vision"]["transformer"], h,
                     _light_tf(cfg.vision_hidden, cfg.vision_layers, cfg.vision_heads),
                     compute_dtype=compute_dtype)
    emb = N.linear(params["vision"]["proj"], out.pooler_output, compute_dtype)
    return _l2_normalize(emb.float().reshape(b, c, -1).mean(dim=1))


# ---------------------------------------------------------------------------
# imagebind_huge (reference ranking/imagebind.py:23 loads
# imagebind_model.imagebind_huge(pretrained=True))
# ---------------------------------------------------------------------------


def _huge_tf(dim, layers, heads, eps):
    return PEAVTransformerConfig(hidden_size=dim, num_layers=layers, num_heads=heads,
                                 pos="none", act="gelu", layer_norm_eps=eps)


def _branch_apply(params, cfg_tf, tokens, compute_dtype=None) -> torch.Tensor:
    """Stem norm -> CLS + position table -> pre-LN -> trunk -> head LN ->
    the CLS row -> head linear (fp32). tokens: (B, N, D). The L2
    normalisation comes after the mean over clips."""
    b = tokens.shape[0]
    if "stem_norm" in params:
        tokens = N.layernorm(params["stem_norm"], tokens, 1e-6)
    cls = params["cls_token"].reshape(1, 1, -1).expand(b, 1, tokens.shape[-1]).to(tokens.dtype)
    x = torch.cat([cls, tokens], dim=1)
    pos = params["pos_embed"].reshape(1, -1, x.shape[-1])
    if pos.shape[1] != x.shape[1]:
        raise ValueError(f"position table of {pos.shape[1]} tokens for {x.shape[1]} tokens")
    x = x + pos.to(x.dtype)
    if "pre_ln" in params:
        x = N.layernorm(params["pre_ln"], x, 1e-6)
    out = peav_apply(params["trunk"], x, cfg_tf, compute_dtype=compute_dtype)
    h = N.layernorm(params["head_norm"], out.last_hidden_state, 1e-6)
    return N.linear(params["head_proj"], h[:, 0], None).float()


def imagebind_encode_audio(params, cfg: ImageBindHugeConfig, melclips: torch.Tensor,
                           compute_dtype=None) -> torch.Tensor:
    """melclips: (B, clips, F, M) -> (B, embed_dim), L2-normalised. The mel
    is a (1, M, F) image under a Conv2d stem of kernel 16, stride 10."""
    b, c, f, m = melclips.shape
    img = melclips.reshape(b * c, 1, f, m).transpose(2, 3)
    if compute_dtype is not None:
        img = img.to(compute_dtype)
    stem = params["audio"]["stem"]
    x = F.conv2d(img, stem["weight"].to(img.dtype),
                 stem["bias"].to(img.dtype) if "bias" in stem else None,
                 stride=cfg.audio_stride)
    tokens = x.flatten(2).transpose(1, 2)
    emb = _branch_apply(params["audio"], _huge_tf(cfg.audio_dim, cfg.audio_layers,
                                                  cfg.audio_heads, cfg.ln_eps),
                        tokens, compute_dtype)
    return _l2_normalize(emb.reshape(b, c, -1).mean(dim=1))


def imagebind_encode_vision(params, cfg: ImageBindHugeConfig, clips: torch.Tensor,
                            compute_dtype=None) -> torch.Tensor:
    """clips: (B, n, 3, T, S, S) or (B, n, 3, S, S) -> (B, embed_dim),
    L2-normalised. A still frame (T = 1) repeats to vision_frames
    (PadIm2Video 'repeat'); the stem is a Conv3d with kernel and stride
    (vision_frames, patch, patch), weight (D, 3, vision_frames, P, P)."""
    if clips.ndim == 5:
        clips = clips[:, :, :, None]
    b, n, ch, tf, s, _ = clips.shape
    x = clips.reshape(b * n, ch, tf, s, s)
    if tf < cfg.vision_frames:
        if tf != 1:
            raise ValueError(f"{tf} frames a clip, for a stem of {cfg.vision_frames}")
        x = x.expand(b * n, ch, cfg.vision_frames, s, s)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    stem = params["vision"]["stem"]
    x = F.conv3d(x, stem["weight"].to(x.dtype),
                 stem["bias"].to(x.dtype) if "bias" in stem else None,
                 stride=(cfg.vision_frames, cfg.vision_patch, cfg.vision_patch))
    tokens = x.flatten(2).transpose(1, 2)
    emb = _branch_apply(params["vision"], _huge_tf(cfg.vision_dim, cfg.vision_layers,
                                                   cfg.vision_heads, cfg.ln_eps),
                        tokens, compute_dtype)
    return _l2_normalize(emb.reshape(b, n, -1).mean(dim=1))


def _audio_embed_from_wav(model, rows: torch.Tensor, sample_rate: int, pipeline,
                          encode) -> torch.Tensor:
    """Resample to the pipeline's rate -> Kaldi mel clips -> tower, all on
    the rows' device. rows: (B, T) of equal true length."""
    rows = rows.float()
    if sample_rate != pipeline.sample_rate:
        rows = resample(rows, sample_rate, pipeline.sample_rate)
    return encode(model.params, model.cfg, audio_to_melclips_torch(rows, pipeline))


class _Scorer:
    """(cfg, params) on one device; the audio and video embeddings."""

    def __init__(self, cfg, params, pipeline: Optional[ImageBindConfig] = None):
        self.cfg = cfg
        self.params = params
        self.pipeline = pipeline or ImageBindConfig()

    @property
    def device(self) -> torch.device:
        leaf = self.params["audio"]
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        return leaf.device

    @torch.inference_mode()
    def embed_audio(self, wavs: Sequence[np.ndarray], sample_rate: int) -> torch.Tensor:
        """Host path: per waveform numpy resampling and fbank (any length)."""
        mels = []
        for w in wavs:
            w = np.asarray(w, np.float32).reshape(-1)
            if sample_rate != self.pipeline.sample_rate:
                w = resample_np(w, sample_rate, self.pipeline.sample_rate)
            mels.append(audio_to_melclips(w, self.pipeline))
        return self._encode_audio(self.params, self.cfg,
                                  torch.as_tensor(np.stack(mels), device=self.device))

    @torch.inference_mode()
    def embed_audio_device(self, rows: torch.Tensor, sample_rate: int) -> torch.Tensor:
        """(B, T) device waveforms of one true length T -> (B, embed_dim),
        without leaving the device."""
        return _audio_embed_from_wav(self, rows, int(sample_rate), self.pipeline,
                                     self._encode_audio)


class ImageBindHugeModel(_Scorer):
    """The weight-faithful imagebind_huge audio <-> vision scorer."""

    _encode_audio = staticmethod(imagebind_encode_audio)

    @classmethod
    def init_random(cls, cfg: Optional[ImageBindHugeConfig] = None, seed: int = 0,
                    device="cuda", pipeline: Optional[ImageBindConfig] = None):
        from sam_audio_tpu_torch.models.init import imagebind_huge_init
        from sam_audio_tpu_torch.models.sam_audio import resolve_device

        cfg = cfg or ImageBindHugeConfig()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, imagebind_huge_init(cfg, gen, dev), pipeline)

    @torch.inference_mode()
    def embed_videos(self, videos: Sequence[np.ndarray], num_crops: int = 3) -> torch.Tensor:
        clips = np.stack([video_to_frame_clips(np.asarray(v), size=self.cfg.image_size,
                                               frames_per_clip=self.cfg.vision_frames,
                                               num_crops=num_crops) for v in videos])
        return imagebind_encode_vision(self.params, self.cfg,
                                       torch.as_tensor(clips, device=self.device))


class ImageBindModel(_Scorer):
    """The light structural towers of the JAX package."""

    _encode_audio = staticmethod(encode_audio)

    def __init__(self, cfg: ImageBindConfig, params):
        super().__init__(cfg, params, cfg)

    @classmethod
    def init_random(cls, cfg: ImageBindConfig = ImageBindConfig(), seed: int = 0,
                    device="cuda"):
        from sam_audio_tpu_torch.models.init import imagebind_init
        from sam_audio_tpu_torch.models.sam_audio import resolve_device

        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, imagebind_init(cfg, gen, dev))

    @torch.inference_mode()
    def embed_videos(self, videos: Sequence[np.ndarray]) -> torch.Tensor:
        clips = np.stack([video_to_clips(np.asarray(v), self.cfg) for v in videos])
        return encode_vision(self.params, self.cfg, torch.as_tensor(clips, device=self.device))


def load_imagebind_model(checkpoint: str, device="cuda"):
    """A converted ImageBind npz: conv-stem branches (`audio/stem`, from
    convert.convert_imagebind_state_dict) run imagebind_huge; the light
    layout (`audio/patch_embed`) the light towers."""
    from sam_audio_tpu_torch.checkpoint import load_params
    from sam_audio_tpu_torch.models.sam_audio import resolve_device

    params = load_params(checkpoint, resolve_device(device))
    if "stem" in params.get("audio", {}):
        return ImageBindHugeModel(ImageBindHugeConfig(), params)
    return ImageBindModel(ImageBindConfig(), params)
