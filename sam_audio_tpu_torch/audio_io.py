"""Host-side audio file I/O (numpy, and the host runtime's WAV reader).

  * WAV read/write in pure numpy (stdlib `wave` handles the RIFF framing),
    covering PCM8/16/24/32.
  * IEEE-float (format 3) and WAVE_FORMAT_EXTENSIBLE WAVs, which `wave`
    rejects, through the native reader (runtime/native.read_wav_native).
  * Other containers (mp3/mp4/flac) and WAVs the native reader cannot parse
    (float64, ADPCM) route through the `ffmpeg` CLI when present; otherwise
    a clear error tells the user to pre-convert.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import wave
from typing import Optional, Tuple

import numpy as np

from sam_audio_tpu_torch.runtime.native import read_wav_native


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns (waveform (channels, T) float32 in [-1, 1], sample_rate)."""
    with wave.open(path, "rb") as f:
        n_channels = f.getnchannels()
        sampwidth = f.getsampwidth()
        sample_rate = f.getframerate()
        raw = f.readframes(f.getnframes())
    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 3:
        a = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        ints = (
            a[:, 0].astype(np.int32)
            | (a[:, 1].astype(np.int32) << 8)
            | (a[:, 2].astype(np.int32) << 16)
        )
        ints = np.where(ints >= 2**23, ints - 2**24, ints)
        data = ints.astype(np.float32) / 8388608.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"Unsupported WAV sample width: {sampwidth}")
    return data.reshape(-1, n_channels).T.copy(), sample_rate


def write_wav(path: str, waveform: np.ndarray, sample_rate: int):
    """waveform: (T,) or (channels, T) float32 in [-1, 1] -> PCM16 WAV."""
    wav = np.asarray(waveform, dtype=np.float32)
    if wav.ndim == 1:
        wav = wav[None]
    pcm = np.clip(wav.T * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(pcm.shape[1])
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def _ffmpeg_decode(path: str, sample_rate: Optional[int] = None) -> Tuple[np.ndarray, int]:
    ffmpeg = shutil.which("ffmpeg")
    ffprobe = shutil.which("ffprobe")
    if ffmpeg is None:
        raise RuntimeError(
            f"Cannot decode {path!r}: not a WAV file that this package reads "
            "and no ffmpeg on PATH. Pre-convert to WAV."
        )
    sr, num_channels = sample_rate, None
    if ffprobe is not None:
        out = subprocess.run(
            [ffprobe, "-v", "error", "-select_streams", "a:0", "-show_entries",
             "stream=sample_rate,channels", "-of", "csv=p=0", path],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
        parts = out.split(",") if out else []
        if sr is None and parts and parts[0]:
            sr = int(parts[0])
        if len(parts) > 1 and parts[1]:
            num_channels = int(parts[1])
    sr = sr or 48000
    # without -ac ffmpeg emits the native channel count, which must match
    # the reshape below; with the count unknown, force a mono downmix
    ch = num_channels or 1
    cmd = [ffmpeg, "-v", "error", "-i", path, "-f", "f32le", "-ar", str(sr),
           "-ac", str(ch), "-"]
    raw = subprocess.run(cmd, capture_output=True, check=True).stdout
    data = np.frombuffer(raw, dtype="<f4")
    return data.reshape(-1, ch).T.copy(), sr


def load_audio(path: str, sample_rate: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Load any audio file -> ((channels, T) float32, sr). A WAV comes back at
    its own rate, through stdlib `wave` or, for float and extensible WAVs,
    the native reader; only what neither parses goes to ffmpeg, which
    resamples to `sample_rate` when given. Resampling is otherwise the
    caller's job (ops/resample.resample_np)."""
    if os.path.splitext(path)[1].lower() == ".wav":
        try:
            return read_wav(path)
        except (wave.Error, ValueError):
            native = read_wav_native(path)
            if native is not None:
                return native
    return _ffmpeg_decode(path, sample_rate=sample_rate)
