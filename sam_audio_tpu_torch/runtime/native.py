"""ctypes bindings for the host runtime: WAV I/O, the sinc resampler and the
batch planner in C++ (`csrc/host/{wavio,resample,scheduler}.cc`).

Counterpart of sam_audio_tpu/runtime/native.py, with its entry points and
results: `read_wav_native` gives None for a file it cannot parse (a missing
or truncated file, a codec other than PCM 8/16/24/32 or float32),
`write_wav_native` False, `resample_native` None when the library is not
there, and `plan_batches` falls back to `runtime.plan_batches` (the same
groups). The serving layer plans with `runtime.plan_batches` and never
builds the library; `load_audio` reads float and extensible WAVs with
`read_wav_native`. `write_wav_native`, `resample_native` and the native
`plan_batches` have no caller in the package: they are JAX's entry points,
kept for parity (`ops/resample.resample_np` is faster on the host).

The library builds at first use with

    g++ -O3 -fPIC -shared -std=c++17 -o libsam_audio_host.so \
        wavio.cc resample.cc scheduler.cc

into `build/host/<hash>/` beside the package (git-ignored), the hash over
the sources and the flags; `$CXX` names another compiler. No `-march=native`:
the host that builds it may not be the one that runs it. Where JAX swallows a
failed build, this module warns once (RuntimeWarning, on stderr) with the
compiler's message and then takes the fallbacks above.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import warnings
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from sam_audio_tpu_torch.runtime import plan_batches as plan_batches_plain

HOST_SRC = Path(__file__).resolve().parent.parent / "csrc" / "host"
BUILD_ROOT = HOST_SRC.parent.parent.parent / "build" / "host"
SOURCES = ("wavio.cc", "resample.cc", "scheduler.cc")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
LIB_NAME = "libsam_audio_host.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False

_i64p = ctypes.POINTER(ctypes.c_longlong)
_f32p = ctypes.POINTER(ctypes.c_float)
_intp = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "wav_read_info": ([ctypes.c_char_p, _intp, _intp, _i64p, _intp, _intp], ctypes.c_int),
    "wav_read_f32": ([ctypes.c_char_p, _f32p, ctypes.c_longlong], ctypes.c_longlong),
    "wav_write_pcm16": ([ctypes.c_char_p, _f32p, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_int], ctypes.c_int),
    "resample_out_size": ([ctypes.c_longlong, ctypes.c_int, ctypes.c_int], ctypes.c_longlong),
    "resample_f32": ([_f32p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _f32p,
                      ctypes.c_longlong], ctypes.c_longlong),
    "plan_batches": ([_i64p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                      ctypes.c_longlong, _i64p, _i64p, _i64p], ctypes.c_longlong),
}


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((HOST_SRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the library of the current sources is (or will be) built."""
    return BUILD_ROOT / _source_hash() / LIB_NAME


def build_native(quiet: bool = False) -> bool:
    """Compile the library unless the build for the current sources exists.
    Returns success; a failure raises nothing but warns (RuntimeWarning) with
    the compiler's message. Unless `quiet`, a build prints its command and
    the compiler's output on stderr."""
    target = library_path()
    if target.exists():
        return True
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        message = "no C++ compiler (g++ or $CXX) on PATH"
    else:
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{LIB_NAME}.tmp{os.getpid()}")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *(str(HOST_SRC / name) for name in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if not quiet:
            print(" ".join(cmd), proc.stdout, proc.stderr, sep="\n", file=sys.stderr)
        if proc.returncode == 0:
            os.replace(tmp, target)   # atomic: processes building at once agree
            return True
        message = f"{cxx} exited {proc.returncode}:\n{proc.stderr}"
    warnings.warn(f"sam_audio_tpu_torch.runtime.native: the host library did not "
                  f"build ({message}); the numpy paths run instead", RuntimeWarning,
                  stacklevel=2)
    return False


def _load() -> Optional[ctypes.CDLL]:
    """The library, built at first use; None (after one warning) when it
    cannot be built or loaded."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            if not build_native(quiet=True):
                _load_failed = True
                return None
            lib = ctypes.CDLL(str(library_path()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
        except OSError as e:
            warnings.warn(f"sam_audio_tpu_torch.runtime.native: the host library did not "
                          f"load ({e}); the numpy paths run instead", RuntimeWarning,
                          stacklevel=2)
            _load_failed = True
            return None
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# WAV I/O
# ---------------------------------------------------------------------------


def read_wav_native(path: str) -> Optional[Tuple[np.ndarray, int]]:
    """((channels, T) float32, sample rate), or None if the library is not
    there or the file cannot be parsed."""
    lib = _load()
    if lib is None:
        return None
    sr, ch, frames, bits, is_float = (ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong(),
                                      ctypes.c_int(), ctypes.c_int())
    if lib.wav_read_info(os.fsencode(path), ctypes.byref(sr), ctypes.byref(ch),
                         ctypes.byref(frames), ctypes.byref(bits),
                         ctypes.byref(is_float)) != 0:
        return None
    out = np.empty(frames.value * ch.value, np.float32)
    got = lib.wav_read_f32(os.fsencode(path), out.ctypes.data_as(_f32p), out.size)
    if got < 0 or got % max(ch.value, 1):
        # a data chunk cut mid-frame is unparsable, as in JAX
        return None
    return out[:got].reshape(-1, ch.value).T.copy(), sr.value


def write_wav_native(path: str, waveform: np.ndarray, sample_rate: int) -> bool:
    """(T,) or (channels, T) float32 in [-1, 1] -> a PCM16 WAV. False if the
    library is not there or the file cannot be opened."""
    lib = _load()
    if lib is None:
        return False
    wav = np.asarray(waveform, np.float32)
    if wav.ndim == 1:
        wav = wav[None]
    inter = np.ascontiguousarray(wav.T.reshape(-1))
    return lib.wav_write_pcm16(os.fsencode(path), inter.ctypes.data_as(_f32p),
                               wav.shape[1], wav.shape[0], sample_rate) == 0


# ---------------------------------------------------------------------------
# Resampling
# ---------------------------------------------------------------------------


def resample_native(wav: np.ndarray, orig_freq: int, new_freq: int) -> Optional[np.ndarray]:
    """(..., T) float32 -> (..., ceil(T * new / orig)), the sinc resampler of
    ops/resample.resample_np in C++ (float64 sums); None if the library is
    not there."""
    lib = _load()
    if lib is None:
        return None
    shape = wav.shape
    flat = np.ascontiguousarray(wav.reshape(-1, shape[-1]), np.float32)
    out_len = int(lib.resample_out_size(shape[-1], orig_freq, new_freq))
    out = np.empty((flat.shape[0], out_len), np.float32)
    for i in range(flat.shape[0]):
        got = lib.resample_f32(flat[i].ctypes.data_as(_f32p), flat.shape[-1], orig_freq,
                               new_freq, out[i].ctypes.data_as(_f32p), out_len)
        if got != out_len:
            return None
    return out.reshape(*shape[:-1], out_len)


# ---------------------------------------------------------------------------
# Batch planning
# ---------------------------------------------------------------------------


def plan_batches(lengths: Sequence[int], hop: int, bucket_steps: int,
                 max_batch: int) -> Tuple[List[List[int]], List[int]]:
    """Groups request indices by length bucket. Each length rounds up to a
    multiple of `hop * bucket_steps` (left as it is when that unit is not
    positive); indices sorted by (bucket, index) fill groups of at most
    `max_batch` of one bucket. Returns (groups, the padded length of each
    group). The library's planner where it is built, else
    `runtime.plan_batches`: the same groups."""
    n = len(lengths)
    lib = _load()
    if lib is not None and n:
        arr = np.asarray(lengths, np.int64)
        order, sizes, buckets = (np.empty(n, np.int64) for _ in range(3))
        nb = lib.plan_batches(arr.ctypes.data_as(_i64p), n, hop, bucket_steps, max_batch,
                              order.ctypes.data_as(_i64p), sizes.ctypes.data_as(_i64p),
                              buckets.ctypes.data_as(_i64p))
        groups, pos = [], 0
        for size in sizes[:nb].tolist():
            groups.append(order[pos:pos + size].tolist())
            pos += size
        return groups, buckets[:nb].tolist()
    return plan_batches_plain(lengths, hop, bucket_steps, max_batch)
