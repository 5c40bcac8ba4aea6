"""One whole DAC-VAE residual unit in one kernel.

Replaces the TPU kernel sam_audio_tpu/ops/fused_conv.py::fused_residual_unit
(`_fused_res_unit_padded` / `_res_unit_kernel`; its `_pick_block_t` VMEM
budget and the measured `t < 16384` cut-off are TPU-specific and not
carried over). Computes, on (B, C, T) in the compute dtype:

    s1  = round(snake(x, alpha1))                 (polynomial sin^2 in bf16)
    h   = round(b7 + conv_k7_dilated(s1))         (zero-padded edges, fp32 sum)
    s2  = round(snake(h, alpha2))
    out = round(W_1x1 . s2 + b1 + x)              (fp32 sum)

Kernel: csrc/fused_conv.cu (CUDA, sm_90a). What bounds it on the H100 at the
main-path shapes (bf16, e.g. decoder C=96 at T=480,000: 92 MB in + 92 MB out,
55 us at 3.35 TB/s; 2*8*C^2*T = 70.8 GFLOP, 72 us at 989 TFLOP/s): the
larger-C stages are bound by operations, the C=64 encoder stage by bytes.
The 36 launches of one separate do 2.28 TFLOP in all. The design reads x
once and writes out once per (batch, time tile): snake(x) with its halo, the
k=7 conv output and the second snake stay in shared memory, the seven shifted
products run as one implicit GEMM over K = 7*C. In bf16 the products run on
the tensor cores (mma.sync m16n8k16, fp32 accumulation), with s1 and h kept
channel-contiguous so each operand fragment is one 32-bit load; in fp32 they
are FMAs. No TMA or wgmma yet, and at C=512/768 (T=3000) the grid of 47-94
time tiles leaves SMs idle.

`fused_residual_unit` takes the plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors (raising if it cannot, e.g. C not a
multiple of 32); it counts its launches in `fused_residual_unit.launches`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sam_audio_tpu_torch.ops import _build
from sam_audio_tpu_torch.ops.conv import snake_f32

_lib = None


def residual_unit_operands(params, x, compute_dtype):
    """(x, w7 (K, C_out, C_in), b7, w1 (C_out, C_in), b1, a1, a2): weights in
    the compute dtype, biases and alphas in fp32 (as the TPU kernel takes
    them)."""
    c = x.shape[1]
    zeros = torch.zeros((c,), dtype=torch.float32, device=x.device)
    w7 = params["conv1"]["weight"].permute(2, 0, 1).to(compute_dtype).contiguous()
    w1 = params["conv2"]["weight"][:, :, 0].to(compute_dtype).contiguous()
    b7 = params["conv1"].get("bias", zeros).float().contiguous()
    b1 = params["conv2"].get("bias", zeros).float().contiguous()
    a1 = params["snake1"]["alpha"].reshape(c).float().contiguous()
    a2 = params["snake2"]["alpha"].reshape(c).float().contiguous()
    return x.to(compute_dtype).contiguous(), w7, b7, w1, b1, a1, a2


def fused_residual_unit_plain(x, w7, b7, w1, b1, a1, a2, dilation: int):
    """The kernel's function in plain PyTorch on the prepared operands."""
    dtype = x.dtype
    fast = dtype == torch.bfloat16
    halo = (w7.shape[0] - 1) * dilation // 2
    s1 = snake_f32(x.float(), a1[:, None], fast).to(dtype)
    h = F.conv1d(s1.float(), w7.permute(1, 2, 0).float(), None, 1, halo,
                 dilation) + b7[:, None]
    s2 = snake_f32(h.to(dtype).float(), a2[:, None], fast).to(dtype)
    out = F.conv1d(s2.float(), w1.float()[:, :, None]) + b1[:, None]
    return (out + x.float()).to(dtype)


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("fused_conv")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sa_fused_residual_unit.argtypes = [p] * 8 + [i] * 5 + [p]
        lib.sa_fused_residual_unit.restype = i
        lib.sa_res_unit_tile.argtypes = [i, i, i]
        lib.sa_res_unit_tile.restype = i
        _lib = lib
    return _lib


def fused_residual_unit(params, x: torch.Tensor, dilation: int,
                        compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Drop-in for models.dacvae's plain residual unit. params: {snake1.alpha,
    conv1.{weight,bias}, snake2.alpha, conv2.{weight,bias}}; x: (B, C, T).
    Returns (B, C, T) in `compute_dtype`."""
    ops = residual_unit_operands(params, x, compute_dtype)
    if x.device.type == "cpu":
        return fused_residual_unit_plain(*ops, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"fused_residual_unit: unsupported device {x.device}")
    xc, w7, b7, w1, b1, a1, a2 = ops
    b, c, t = xc.shape
    if w7.shape[0] != 7:
        raise ValueError("fused_residual_unit kernel takes kernel size 7")
    code = _build.dtype_code(compute_dtype)
    lib = _load()
    if c % 32 or lib.sa_res_unit_tile(c, dilation, code) == 0:
        raise ValueError(f"fused_residual_unit kernel cannot take C={c}, "
                         f"dilation={dilation}, {compute_dtype}")
    out = torch.empty_like(xc)
    P = _build.ptr
    err = lib.sa_fused_residual_unit(
        P(xc), P(w7), P(b7), P(w1), P(b1), P(a1), P(a2), P(out),
        b, c, t, dilation, code, _build.stream_of(xc))
    _build.check(err, "fused_residual_unit")
    fused_residual_unit.launches += 1
    return out


fused_residual_unit.launches = 0
