"""Audio aesthetics predictors: CE / CU / PC / PQ scores from a waveform.

Counterpart of sam_audio_tpu/models/aesthetics.py, behind the Aesthetic eval
metric (reference: eval/metrics/aes.py:6-49, which wraps
`audiobox_aesthetics.infer.AesPredictor`). Two models:

  * `AudioboxAesthetics`, the faithful one: a WavLM tower
    (models/wavlm.py), a masked mean over valid frames, per-axis MLP heads
    with exact GELU, then the checkpoint's target_transform. Inference:
    mono mean, resample to 16 kHz, 10 s chunks padded to the batch's longest
    with a sample mask, scores averaged per clip weighted by chunk length.
    Loaded from a torch checkpoint (`from_torch_checkpoint`) or from the
    converter's snapshot directory (`from_pretrained`).
  * `AesPredictor`, the JAX package's stand-in with the same interface: log
    mel -> PE-AV tower -> 4-way head with a mean / std per axis.

Entry points run on `cuda` unless the caller asks for the CPU. The WavLM
forward runs in fp32 whatever the caller's dtype, as JAX's does.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from sam_audio_tpu_torch.config import PEAVTransformerConfig
from sam_audio_tpu_torch.convert import AES_AXES as AXES
from sam_audio_tpu_torch.models.peav import peav_apply
from sam_audio_tpu_torch.models.wavlm import WavLMConfig, frame_lengths, wavlm_encode
from sam_audio_tpu_torch.ops import nn as N
from sam_audio_tpu_torch.ops.mel import mel_spectrogram
from sam_audio_tpu_torch.ops.resample import resample_np


def _device_of(params) -> torch.device:
    leaf = params
    while not isinstance(leaf, torch.Tensor):
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) else leaf[0]
    return leaf.device


@dataclass(frozen=True)
class AestheticsConfig:
    sample_rate: int = 16_000
    n_fft: int = 400
    hop_length: int = 160
    n_mels: int = 64
    hidden: int = 256
    layers: int = 4
    heads: int = 4
    max_seconds: float = 10.0


def aesthetics_forward(params, cfg: AestheticsConfig, wav: torch.Tensor,
                       compute_dtype=None) -> torch.Tensor:
    """wav: (B, T) at cfg.sample_rate -> (B, 4) scores."""
    mel = mel_spectrogram(wav, sample_rate=cfg.sample_rate, n_fft=cfg.n_fft,
                          hop_length=cfg.hop_length, n_mels=cfg.n_mels)
    mel = torch.log(torch.clamp(mel, min=1e-10))
    h = N.linear(params["mel_proj"], mel, compute_dtype)
    tf = PEAVTransformerConfig(hidden_size=cfg.hidden, num_layers=cfg.layers,
                               num_heads=cfg.heads)
    out = peav_apply(params["transformer"], h, tf, compute_dtype=compute_dtype)
    scores = N.linear(params["head"], out.pooler_output, compute_dtype)
    return scores.float() * params["std"].float() + params["mean"].float()


class AesPredictor:
    """(cfg, params) of the mel + PE-AV stand-in predictor."""

    def __init__(self, cfg: AestheticsConfig, params):
        self.cfg = cfg
        self.params = params

    @property
    def device(self) -> torch.device:
        return _device_of(self.params)

    @classmethod
    def init_random(cls, cfg: AestheticsConfig = AestheticsConfig(), seed: int = 0,
                    device="cuda"):
        from sam_audio_tpu_torch.models.init import aesthetics_init
        from sam_audio_tpu_torch.models.sam_audio import resolve_device

        dev = resolve_device(device)
        return cls(cfg, aesthetics_init(cfg, torch.Generator(device=dev).manual_seed(seed), dev))

    @classmethod
    def from_pretrained(cls, checkpoint_path: str, cfg: AestheticsConfig = AestheticsConfig(),
                        device="cuda"):
        """A flat npz of this model's tree (the JAX package's save_params)."""
        from sam_audio_tpu_torch.checkpoint import load_params
        from sam_audio_tpu_torch.models.sam_audio import resolve_device

        return cls(cfg, load_params(checkpoint_path, resolve_device(device)))

    @torch.inference_mode()
    def __call__(self, wavs: Sequence[np.ndarray], sample_rate: int) -> List[dict]:
        max_t = int(self.cfg.max_seconds * self.cfg.sample_rate)
        rows = []
        for w in wavs:
            w = np.asarray(w, np.float32).reshape(-1)
            if sample_rate != self.cfg.sample_rate:
                w = resample_np(w, sample_rate, self.cfg.sample_rate)
            rows.append(w[:max_t])
        batch = np.zeros((len(rows), max(r.shape[-1] for r in rows)), np.float32)
        for i, r in enumerate(rows):
            batch[i, : r.shape[-1]] = r
        scores = aesthetics_forward(self.params, self.cfg,
                                    torch.as_tensor(batch, device=self.device))
        return [dict(zip(AXES, row)) for row in scores.cpu().numpy().tolist()]


@dataclass(frozen=True)
class AudioboxAestheticsConfig:
    sample_rate: int = 16_000
    chunk_seconds: float = 10.0
    wavlm: Optional[WavLMConfig] = None   # WavLM-base when None

    def __post_init__(self):
        if self.wavlm is None:
            object.__setattr__(self, "wavlm", WavLMConfig())

    @classmethod
    def from_dict(cls, d: dict) -> "AudioboxAestheticsConfig":
        """The converter's config.json (asdict of this config)."""
        d = dict(d)
        wavlm = d.pop("wavlm", None)
        return cls(**d, wavlm=WavLMConfig.from_dict(wavlm) if wavlm else None)


def audiobox_scores(params, cfg: AudioboxAestheticsConfig, wav: torch.Tensor,
                    pad_mask: torch.Tensor) -> dict:
    """wav, pad_mask: (N, T) chunks at 16 kHz and their valid samples ->
    {axis: (N,) fp32 raw head outputs}: WavLM in fp32, the masked mean over
    valid frames, each axis' MLP (exact GELU between its linears)."""
    h = wavlm_encode(params["wavlm"], cfg.wavlm, wav, pad_mask=pad_mask,
                     compute_dtype=torch.float32)
    lens = frame_lengths(cfg.wavlm, pad_mask.to(torch.int32).sum(-1))
    fmask = (torch.arange(h.shape[1], device=h.device)[None, :] < lens[:, None])
    fmask = fmask.to(h.dtype)[:, :, None]
    pooled = (h * fmask).sum(1) / torch.clamp(fmask.sum(1), min=1.0)
    out = {}
    for ax in AXES:
        y = pooled
        layers = params["heads"][ax]
        for i, lin in enumerate(layers):
            y = N.linear(lin, y)
            if i < len(layers) - 1:
                y = F.gelu(y)
        out[ax] = y[:, 0]
    return out


class AudioboxAesthetics:
    """The audiobox_aesthetics.infer.AesPredictor equivalent (reference:
    eval/metrics/aes.py:6-49).

    params: {"wavlm": <models/wavlm.py tree>,
             "heads": {axis: [linear, ...]},       (GELU between linears)
             "target_transform": {axis: {"mean": s, "std": s}}  (optional)}

    As in JAX, the head activation (exact GELU) and the masked mean of the
    final hidden states are an assumption about the published predictor
    that no file in the repository can check; extra parameters of a real
    checkpoint fail loudly through the converter's unconverted keys."""

    def __init__(self, cfg: AudioboxAestheticsConfig, params):
        self.cfg = cfg
        self.params = params

    @property
    def device(self) -> torch.device:
        return _device_of(self.params["wavlm"])

    @classmethod
    def init_random(cls, cfg: Optional[AudioboxAestheticsConfig] = None, seed: int = 0,
                    device="cuda"):
        from sam_audio_tpu_torch.models.init import audiobox_aesthetics_init
        from sam_audio_tpu_torch.models.sam_audio import resolve_device

        cfg = cfg or AudioboxAestheticsConfig()
        dev = resolve_device(device)
        return cls(cfg, audiobox_aesthetics_init(
            cfg, torch.Generator(device=dev).manual_seed(seed), dev))

    @classmethod
    def from_torch_checkpoint(cls, path: str, cfg: Optional[AudioboxAestheticsConfig] = None,
                              device="cuda"):
        """An audiobox-aesthetics torch checkpoint, converted here
        (convert.convert_aes_checkpoint; unconverted keys raise)."""
        from sam_audio_tpu_torch.checkpoint import params_from_numpy
        from sam_audio_tpu_torch.convert import convert_aes_checkpoint
        from sam_audio_tpu_torch.models.sam_audio import resolve_device

        dev = resolve_device(device)
        params, unconverted, cfg = convert_aes_checkpoint(path, cfg or AudioboxAestheticsConfig())
        if unconverted:
            raise ValueError(f"unconverted audiobox-aesthetics keys: {unconverted[:20]}"
                             f" (+{max(0, len(unconverted) - 20)} more)")
        return cls(cfg, params_from_numpy(params, dev))

    @classmethod
    def from_pretrained(cls, path: str, device="cuda"):
        """The snapshot directory that `python -m sam_audio_tpu_torch.convert
        aesthetics` (or the JAX package's converter) writes: config.json
        (this config, with its `wavlm` sub-config) + params.npz."""
        from sam_audio_tpu_torch.checkpoint import load_params
        from sam_audio_tpu_torch.models.sam_audio import resolve_device

        dev = resolve_device(device)
        with open(os.path.join(path, "config.json")) as fin:
            cfg = AudioboxAestheticsConfig.from_dict(json.load(fin))
        return cls(cfg, load_params(os.path.join(path, "params.npz"), dev))

    @torch.inference_mode()
    def __call__(self, wavs: Sequence[np.ndarray], sample_rate: int) -> List[dict]:
        sr = self.cfg.sample_rate
        chunk = int(self.cfg.chunk_seconds * sr)
        chunks, weights, owners = [], [], []
        for i, w in enumerate(wavs):
            w = np.asarray(w, np.float32)
            if w.ndim > 1:
                w = w.mean(axis=0)
            if sample_rate != sr:
                w = resample_np(w, sample_rate, sr)
            for s in range(0, max(len(w), 1), chunk):
                seg = w[s: s + chunk]
                if seg.shape[-1] == 0:
                    seg = np.zeros((1,), np.float32)
                if s and int(frame_lengths(self.cfg.wavlm, torch.tensor(seg.shape[-1]))) < 1:
                    # a tail too short for one WavLM frame (25 ms) would give
                    # NaN through its fully masked attention; JAX keeps it
                    continue
                chunks.append(seg)
                weights.append(seg.shape[-1])
                owners.append(i)
        tmax = max(c.shape[-1] for c in chunks)
        batch = np.zeros((len(chunks), tmax), np.float32)
        mask = np.zeros((len(chunks), tmax), bool)
        for j, c in enumerate(chunks):
            batch[j, : c.shape[-1]] = c
            mask[j, : c.shape[-1]] = True
        dev = self.device
        scores = audiobox_scores(self.params, self.cfg, torch.as_tensor(batch, device=dev),
                                 torch.as_tensor(mask, device=dev))
        scores = {ax: v.cpu().numpy() for ax, v in scores.items()}

        tt = self.params.get("target_transform") or {}
        w_arr = np.asarray(weights, np.float64)
        owners = np.asarray(owners)
        results = []
        for i in range(len(wavs)):
            sel = np.flatnonzero(owners == i)
            row = {}
            for ax in AXES:
                v = float(np.average(scores[ax][sel], weights=w_arr[sel]))
                if ax in tt:
                    v = v * float(tt[ax]["std"]) + float(tt[ax]["mean"])
                row[ax] = v
            results.append(row)
        return results


__all__ = ["AXES", "AestheticsConfig", "AesPredictor", "AudioboxAestheticsConfig",
           "AudioboxAesthetics", "aesthetics_forward", "audiobox_scores"]
