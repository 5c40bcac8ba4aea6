"""Builds the hand-written CUDA kernels in `csrc/` and binds them with ctypes.

Each `csrc/<name>.cu` compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o lib<name>.so <name>.cu

into `build/kernels/<hash>/` beside the package (git-ignored). The hash covers
every source and header in `csrc/` and the flags, so an edited kernel
rebuilds and an unchanged one loads as it is. All sources build at the first
use of any kernel, one nvcc process each, started together. The libraries
have a plain C interface: every entry point takes raw device pointers and the
CUDA stream as `void*`, launches, and returns `cudaGetLastError()`; the
Python wrapper raises when that is not 0. A missing nvcc or a failed build
raises: there is no fallback for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC.parent.parent / "build" / "kernels"
KERNEL_SOURCES = ("fused_attention", "flash_attention", "fused_conv", "int4_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# seconds the last build took and nvcc's register/shared-memory report,
# for chip_smoke.py to print
build_info: Dict[str, object] = {}
# every object whose `launches` counts a kernel's device executions (each
# wrapper adds itself); a CUDA graph of the DiT (models/dit_graph.py) adds
# the launches it recorded at capture to each on every replay
COUNTERS: List[object] = []


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc was not found (PATH or /usr/local/cuda/bin): the CUDA "
            "kernels of sam_audio_tpu_torch cannot be built, and a CUDA "
            "tensor has no other path")
    return nvcc


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_all(build_root: Optional[Path] = None) -> Path:
    """Compile every kernel source (in parallel) unless the build for the
    current sources exists. Returns the build directory."""
    out_dir = Path(build_root or BUILD_ROOT) / _source_hash()
    missing = [n for n in KERNEL_SOURCES
               if not (out_dir / f"lib{n}.so").exists()]
    if not missing:
        return out_dir
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    procs = {}
    for name in missing:
        tmp = out_dir / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures, report = [], []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        report.append(f"== {name}.cu ==\n{log}")
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out_dir / f"lib{name}.so")
    build_info["seconds"] = time.perf_counter() - start
    build_info["log"] = "\n".join(report)
    (out_dir / "build.log").write_text(build_info["log"])
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return out_dir


def load(name: str) -> ctypes.CDLL:
    """The shared library of kernel source `name`, built at first use."""
    with _lock:
        if name not in _libs:
            out_dir = build_all()
            _libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        return _libs[name]


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def aligned16(t):
    """`t` itself when its data starts 16-byte aligned (the kernels' vector
    loads need it), else an aligned copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ptr(t) -> int:
    """The tensor's device address, as the int a `c_void_p` argument takes."""
    return t.data_ptr()


def stream_of(t) -> int:
    """The raw handle of the current CUDA stream of t's device. A wrapper is
    called thousands of times a separate, so this takes torch's direct
    accessor where the build has it: building a `torch.cuda.Stream` costs
    several microseconds."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        index = t.device.index
        return raw(torch.cuda.current_device() if index is None else index)
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(dtype) -> int:
    """The kernels' dtype switch: 0 = float32, 1 = bfloat16."""
    import torch

    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"the CUDA kernels take float32 or bfloat16, got {dtype}")
