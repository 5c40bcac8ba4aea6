"""Bandlimited sinc resampling in numpy, numerically equivalent to
torchaudio.functional.resample defaults (sinc_interp_hann,
lowpass_filter_width=6, rolloff=0.99), which the reference uses for all audio
loading (reference: sam_audio/processor.py:29-31).

  * `resample_np` — numpy, host-side preprocessing.
  * `resample`    — the same kernel as a strided conv1d on the tensors'
    device (the ImageBind ranker's 48 kHz -> 16 kHz on the card).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=64)
def _sinc_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                 rolloff: float = 0.99) -> tuple:
    """Returns (kernels (new_freq, 1, K) float32, width) with frequencies
    already reduced by their gcd."""
    gcd = math.gcd(int(orig_freq), int(new_freq))
    orig_freq = int(orig_freq) // gcd
    new_freq = int(new_freq) // gcd
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, None] / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None, None] / new_freq + idx
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * math.pi / lowpass_filter_width / 2) ** 2
    t *= math.pi
    scale = base_freq / orig_freq
    kernels = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernels *= window * scale
    return kernels.astype(np.float32), width


def resample_np(waveform: np.ndarray, orig_freq: int, new_freq: int,
                lowpass_filter_width: int = 6, rolloff: float = 0.99) -> np.ndarray:
    """waveform: (..., T) numpy. Returns (..., ceil(T * new/orig))."""
    if orig_freq == new_freq:
        return waveform
    kernels, width = _sinc_kernel(orig_freq, new_freq, lowpass_filter_width, rolloff)
    g = math.gcd(int(orig_freq), int(new_freq))
    orig_r, new_r = int(orig_freq) // g, int(new_freq) // g
    shape = waveform.shape
    length = shape[-1]
    wav = waveform.reshape(-1, length).astype(np.float32)
    wav = np.pad(wav, [(0, 0), (width, width + orig_r)])
    num_out_frames = (wav.shape[-1] - kernels.shape[-1]) // orig_r + 1
    strides = (wav.strides[0], wav.strides[1] * orig_r, wav.strides[1])
    frames = np.lib.stride_tricks.as_strided(
        wav, (wav.shape[0], num_out_frames, kernels.shape[-1]), strides
    )
    # (W, F, K) x (P, K) -> (W, F, P) -> interleave phases
    out = np.einsum("wfk,pk->wfp", frames, kernels[:, 0, :])
    out = out.reshape(wav.shape[0], -1)
    target_length = int(math.ceil(new_r * length / orig_r))
    out = out[:, :target_length]
    return out.reshape(*shape[:-1], target_length)


def resample(waveform: torch.Tensor, orig_freq: int, new_freq: int,
             lowpass_filter_width: int = 6, rolloff: float = 0.99) -> torch.Tensor:
    """`resample_np` on the tensor's device: waveform (..., T) ->
    (..., ceil(T * new / orig)), computed in float32, returned in the
    input's dtype."""
    if orig_freq == new_freq:
        return waveform
    kernels, width = _sinc_kernel(orig_freq, new_freq, lowpass_filter_width, rolloff)
    g = math.gcd(int(orig_freq), int(new_freq))
    orig_r, new_r = int(orig_freq) // g, int(new_freq) // g
    shape = waveform.shape
    length = shape[-1]
    wav = F.pad(waveform.reshape(-1, 1, length).float(), (width, width + orig_r))
    out = F.conv1d(wav, torch.as_tensor(kernels, device=wav.device), stride=orig_r)
    out = out.transpose(1, 2).reshape(wav.shape[0], -1)       # interleave the phases
    target_length = int(math.ceil(new_r * length / orig_r))
    return out[:, :target_length].reshape(*shape[:-1], target_length).to(waveform.dtype)
