"""STFT / mel-spectrogram frontend of the CLAP audio tower.

Counterpart of the parts of sam_audio_tpu/ops/mel.py that HTSAT uses
(torchaudio.transforms.MelSpectrogram numerics: reflect centre padding, a
periodic Hann window, power spectrogram, HTK or Slaney mel scales). The
filterbank is built on the host in float64 and cast once; the framing, FFT
and filterbank product run on the tensors' device. The Kaldi fbank parts come
with the ImageBind ranker.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def _hz_to_mel(f, scale: str):
    f = np.asarray(f, np.float64)
    if scale == "htk":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3          # slaney
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    (f - f_min) / f_sp)


def _mel_to_hz(m, scale: str):
    m = np.asarray(m, np.float64)
    if scale == "htk":
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), f_min + f_sp * m)


@lru_cache(maxsize=16)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float, mel_scale: str = "htk",
                   norm: Optional[str] = None) -> np.ndarray:
    """(n_freqs, n_mels) triangular filterbank (torchaudio melscale_fbanks)."""
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel(fmin, mel_scale), _hz_to_mel(fmax, mel_scale),
                        n_mels + 2)
    f_pts = _mel_to_hz(m_pts, mel_scale)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        fb *= (2.0 / (f_pts[2: n_mels + 2] - f_pts[:n_mels]))[None]
    return fb.astype(np.float32)


def stft_power(x: torch.Tensor, n_fft: int, hop_length: int,
               win_length: Optional[int] = None, center: bool = True,
               power: float = 2.0) -> torch.Tensor:
    """x: (..., T) -> (..., n_frames, n_fft//2+1) power spectrogram."""
    win_length = win_length or n_fft
    window = np.hanning(win_length + 1)[:-1].astype(np.float32)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    lead = x.shape[:-1]
    x = x.reshape(-1, 1, x.shape[-1])
    if center:
        x = F.pad(x, (n_fft // 2, n_fft // 2), mode="reflect")
    x = x[:, 0]
    n_frames = 1 + (x.shape[-1] - n_fft) // hop_length
    idx = torch.as_tensor(np.arange(n_frames)[:, None] * hop_length
                          + np.arange(n_fft)[None, :], device=x.device)
    frames = x[:, idx] * torch.as_tensor(window, device=x.device)
    mag = torch.abs(torch.fft.rfft(frames, dim=-1))
    spec = mag if power == 1.0 else mag ** power
    return spec.reshape(*lead, n_frames, n_fft // 2 + 1)


def mel_spectrogram(x: torch.Tensor, sample_rate: int, n_fft: int, hop_length: int,
                    win_length: Optional[int] = None, n_mels: int = 64,
                    fmin: float = 0.0, fmax: Optional[float] = None,
                    mel_scale: str = "htk", norm: Optional[str] = None,
                    power: float = 2.0, center: bool = True) -> torch.Tensor:
    """x: (..., T) -> (..., n_frames, n_mels)."""
    fmax = fmax or sample_rate / 2
    spec = stft_power(x, n_fft, hop_length, win_length, center, power)
    fb = mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax, mel_scale, norm)
    return spec @ torch.as_tensor(fb, device=spec.device)


def log_mel_spectrogram(x, amin: float = 1e-10, ref: float = 1.0,
                        top_db: Optional[float] = None, **kwargs):
    """10*log10 mel (torchaudio AmplitudeToDB on a power mel)."""
    logmel = 10.0 * torch.log10(torch.clamp(mel_spectrogram(x, **kwargs), min=amin))
    logmel = logmel - 10.0 * math.log10(max(amin, ref))
    if top_db is not None:
        logmel = torch.maximum(logmel, torch.amax(logmel) - top_db)
    return logmel
