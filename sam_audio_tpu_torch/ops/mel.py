"""STFT / mel-spectrogram frontends; counterpart of sam_audio_tpu/ops/mel.py.

  * The CLAP audio tower's (torchaudio.transforms.MelSpectrogram numerics:
    reflect centre padding, a periodic Hann window, power spectrogram, HTK
    or Slaney mel scales): the filterbank is built on the host in float64 and
    cast once; framing, FFT and filterbank product run on the tensors'
    device.
  * The ImageBind audio tower's Kaldi fbank (torchaudio.compliance.kaldi.fbank
    with dither 0): `kaldi_fbank` in numpy float64 for the host path,
    `kaldi_fbank_torch` batched on the tensors' device in float32.
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


# ---------------------------------------------------------------------------
# Kaldi-compatible fbank (torchaudio.compliance.kaldi.fbank numerics)
# ---------------------------------------------------------------------------


def _next_power_of_2(n: int) -> int:
    return 1 if n == 0 else 2 ** (n - 1).bit_length()


@lru_cache(maxsize=16)
def kaldi_mel_banks(num_bins: int, padded_window_size: int, sample_freq: float,
                    low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """Kaldi's mel filterbank, (num_bins, padded_window_size // 2 + 1): mel
    scale 1127 ln(1 + f / 700), triangles on an even mel grid between
    low_freq and high_freq (<= 0: an offset from Nyquist), evaluated at the
    FFT bin frequencies; the Nyquist column is zero."""
    num_fft_bins = padded_window_size // 2
    nyquist = 0.5 * sample_freq
    if high_freq <= 0.0:
        high_freq = high_freq + nyquist
    if not 0.0 <= low_freq < high_freq <= nyquist:
        raise ValueError(f"bad mel range ({low_freq}, {high_freq}) for Nyquist {nyquist}")

    def mel(f):
        return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)

    mel_low, mel_high = mel(low_freq), mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    bins = np.arange(num_bins, dtype=np.float64)[:, None]
    left, center, right = (mel_low + (bins + j) * mel_delta for j in (0.0, 1.0, 2.0))
    freq_mel = mel(sample_freq / padded_window_size * np.arange(num_fft_bins))[None, :]
    up = (freq_mel - left) / (center - left)
    down = (right - freq_mel) / (right - center)
    fb = np.maximum(0.0, np.minimum(up, down))
    return np.pad(fb, ((0, 0), (0, 1))).astype(np.float32)


def _kaldi_window(window_type: str, n: int, blackman_coeff: float = 0.42) -> np.ndarray:
    """Kaldi's frame window (periodic=False: n - 1 denominators), float64."""
    i = np.arange(n, dtype=np.float64)
    if window_type == "hanning":
        return 0.5 - 0.5 * np.cos(2.0 * np.pi * i / (n - 1))
    if window_type == "hamming":
        return 0.54 - 0.46 * np.cos(2.0 * np.pi * i / (n - 1))
    if window_type == "povey":
        return (0.5 - 0.5 * np.cos(2.0 * np.pi * i / (n - 1))) ** 0.85
    if window_type == "rectangular":
        return np.ones(n)
    if window_type == "blackman":
        a = 2.0 * np.pi / (n - 1)
        return blackman_coeff - 0.5 * np.cos(a * i) + (0.5 - blackman_coeff) * np.cos(2.0 * a * i)
    raise ValueError(f"unknown window_type {window_type}")


def kaldi_fbank(waveform: np.ndarray, sample_frequency: float = 16000.0,
                num_mel_bins: int = 128, frame_length: float = 25.0,
                frame_shift: float = 10.0, window_type: str = "hanning",
                low_freq: float = 20.0, high_freq: float = 0.0,
                preemphasis_coefficient: float = 0.97,
                remove_dc_offset: bool = True) -> np.ndarray:
    """Kaldi log-mel fbank on the host, float64 inside (ImageBind's frontend,
    reference sam_audio/ranking/imagebind.py:75-77): snip-edges framing,
    per-frame DC removal, replicate-edge preemphasis, the periodic=False
    window, zero padding to a power-of-two FFT, the power spectrum, Kaldi
    mel banks, the natural log floored at float32 eps. Returns
    (num_frames, num_mel_bins) float32; (0, num_mel_bins) for a signal
    shorter than one window."""
    wav = np.asarray(waveform, np.float64).reshape(-1)
    shift = int(sample_frequency * frame_shift * 0.001)
    size = int(sample_frequency * frame_length * 0.001)
    padded = _next_power_of_2(size)
    if len(wav) < size:
        return np.zeros((0, num_mel_bins), np.float32)
    m = 1 + (len(wav) - size) // shift
    frames = wav[np.arange(m)[:, None] * shift + np.arange(size)[None, :]]
    if remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if preemphasis_coefficient != 0.0:
        prev = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - preemphasis_coefficient * prev
    frames = frames * _kaldi_window(window_type, size)[None, :]
    spectrum = np.abs(np.fft.rfft(frames, n=padded, axis=1)) ** 2
    fb = kaldi_mel_banks(num_mel_bins, padded, float(sample_frequency), low_freq, high_freq)
    mel = spectrum @ fb.T.astype(np.float64)
    return np.log(np.maximum(mel, float(np.finfo(np.float32).eps))).astype(np.float32)


def kaldi_fbank_torch(waveform: torch.Tensor, sample_frequency: float = 16000.0,
                      num_mel_bins: int = 128, frame_length: float = 25.0,
                      frame_shift: float = 10.0, window_type: str = "hanning",
                      low_freq: float = 20.0, high_freq: float = 0.0,
                      preemphasis_coefficient: float = 0.97,
                      remove_dc_offset: bool = True) -> torch.Tensor:
    """`kaldi_fbank` batched on the tensors' device in float32 (JAX:
    kaldi_fbank_jax): (..., T) -> (..., num_frames, num_mel_bins) log-mel.
    The same framing, DC removal, preemphasis, window and mel banks; the
    power spectrum is the rfft of the zero-padded frame."""
    wav = waveform.float()
    t = wav.shape[-1]
    shift = int(sample_frequency * frame_shift * 0.001)
    size = int(sample_frequency * frame_length * 0.001)
    padded = _next_power_of_2(size)
    if t < size:
        return wav.new_zeros(wav.shape[:-1] + (0, num_mel_bins))
    m = 1 + (t - size) // shift
    idx = torch.as_tensor(np.arange(m)[:, None] * shift + np.arange(size)[None, :],
                          device=wav.device)
    frames = wav[..., idx]                                      # (..., m, size)
    if remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemphasis_coefficient != 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - preemphasis_coefficient * prev
    frames = frames * torch.as_tensor(_kaldi_window(window_type, size).astype(np.float32),
                                      device=wav.device)
    spec = torch.fft.rfft(frames, n=padded, dim=-1)
    power = spec.real * spec.real + spec.imag * spec.imag
    fb = kaldi_mel_banks(num_mel_bins, padded, float(sample_frequency), low_freq, high_freq)
    mel = power @ torch.as_tensor(np.ascontiguousarray(fb.T), device=wav.device)
    return torch.log(torch.clamp(mel, min=float(np.finfo(np.float32).eps)))
