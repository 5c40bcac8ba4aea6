"""Product with packed int4 weights: y = x . dequant(w4)^T.

Replaces the TPU kernel sam_audio_tpu/ops/int4_matmul.py::matmul_int4
(kernel body `_kernel`). Layout (ops/quant.quantize_linear_int4): w4 is
(out/2, in) uint8, byte (j, i) holding weight row j in its low nibble and row
j + out/2 in its high nibble, values in [-7, 7]; w4_scale is (out, in/g) fp32,
one scale per (output row, group of g inputs). Because a group's columns share
one scale, it factors out of the group's dot:

    y[:, o] = sum_i  s[o, i] * (x[:, group i] . q[o, group i])

each partial in fp32, scaled, then summed; y is rounded once to x's dtype.

Kernel: csrc/int4_matmul.cu (CUDA, sm_90a). What bounds it on the H100: at
the DiT's shapes and 250 tokens (k=1), 2*M*K*N operations (e.g. 2.1 GFLOP for
(2048, 2048), 2.1 us at 989 TFLOP/s, against 2.1 MB of packed weights, 0.6 us
at 3.35 TB/s): bound by operations, near the card's ridge. Cross-attention's
k/v projections at ~14 tokens are the only launches bound by weight bytes. A
block owns 64 tokens x 64 packed rows and makes both output planes from one
read of the packed tile; it stages x and the packed bytes in shared memory
(16-byte cp.async, three chunks in flight), sign-extends the nibbles to bf16
there, and runs mma.sync m16n8k16 into a per-group fp32 partial that is scaled
into the accumulator at each group's end. fp32 inputs take an FMA path. The
kernel is far from its bound (PERF.md): one block walks the whole contraction
axis. The TPU kernel's `tokens <= 256` VMEM gate and its padding of the tokens
to 8 are not carried over: masked loads take any token count.

`matmul_int4` takes the plain PyTorch version for CPU tensors and launches the
kernel for CUDA tensors (raising ValueError for a shape it cannot take: the
group must divide `in` and be a multiple of 16); it counts its launches in
`matmul_int4.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from sam_audio_tpu_torch.ops import _build

_lib = None


def unpack_int4(w4: torch.Tensor):
    """(..., half, in) uint8 -> the sign-extended (low, high) nibble planes as
    int32 (..., half, in) each."""
    p = w4.to(torch.int32)
    return ((p & 0xF) ^ 8) - 8, ((p >> 4) ^ 8) - 8


def matmul_int4_plain(x: torch.Tensor, w4: torch.Tensor,
                      w4_scale: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, group by group as the TPU grid
    runs: x (M, in) float32 or bfloat16; w4 (half, in) uint8; w4_scale
    (2*half, G) -> (M, 2*half) in x's dtype."""
    n_groups = w4_scale.shape[-1]
    gs = x.shape[-1] // n_groups
    lo, hi = unpack_int4(w4)
    q = torch.cat([lo, hi], dim=0).float()             # (out, in)
    xf = x.float()
    s = w4_scale.float()
    acc = torch.zeros((x.shape[0], q.shape[0]), dtype=torch.float32, device=x.device)
    for i in range(n_groups):
        cols = slice(i * gs, (i + 1) * gs)
        acc = acc + (xf[:, cols] @ q[:, cols].t()) * s[:, i]
    return acc.to(x.dtype)


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("int4_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sa_matmul_int4.argtypes = [p] * 4 + [i] * 5 + [p]
        lib.sa_matmul_int4.restype = i
        _lib = lib
    return _lib


def matmul_int4(x: torch.Tensor, w4: torch.Tensor, w4_scale: torch.Tensor) -> torch.Tensor:
    """x (M, in) float32 or bfloat16; w4 (out/2, in) uint8; w4_scale
    (out, in/g). Returns (M, out) in x's dtype (no bias). Plain version on
    the CPU, the CUDA kernel on the card."""
    if x.device.type == "cpu":
        return matmul_int4_plain(x, w4, w4_scale)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_int4: unsupported device {x.device}")
    if x.ndim != 2 or w4.ndim != 2 or w4_scale.ndim != 2:
        raise ValueError("matmul_int4 kernel takes a 2-D x, w4 and w4_scale")
    m, k = x.shape
    half, n_groups = w4.shape[0], w4_scale.shape[1]
    if (w4.shape[1] != k or w4_scale.shape[0] != 2 * half or w4.dtype != torch.uint8
            or k % n_groups or (k // n_groups) % 16):
        raise ValueError(
            f"matmul_int4 kernel cannot take x {tuple(x.shape)}, w4 "
            f"{tuple(w4.shape)} {w4.dtype}, w4_scale {tuple(w4_scale.shape)}: the "
            "group (in / G) must divide `in` and be a multiple of 16")
    code = _build.dtype_code(x.dtype)
    xc = _build.aligned16(x.contiguous())
    wc = _build.aligned16(w4.contiguous())
    sc = w4_scale.float().contiguous()
    for t in (wc, sc):
        if t.device != x.device:
            raise ValueError("matmul_int4: inputs on different devices")
    out = torch.empty((m, 2 * half), dtype=x.dtype, device=x.device)
    P = _build.ptr
    err = _load().sa_matmul_int4(P(xc), P(wc), P(sc), P(out), m, k, half, n_groups,
                                 code, _build.stream_of(xc))
    _build.check(err, "matmul_int4")
    matmul_int4.launches += 1
    return out


matmul_int4.launches = 0
