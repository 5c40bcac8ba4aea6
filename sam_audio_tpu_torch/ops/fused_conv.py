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
The 36 launches of one separate do 2.28 TFLOP in all. In bf16 the unit is an
implicit GEMM on wgmma (time as M, output channels as N): staging warps fetch
64-channel input chunks by cp.async and store them, snaked, as an operand
that every tap's row shift can address; the weights are tiled once per unit
(`tile_weights`, cached by `prepared_operands`) and streamed by bulk copies.
Up to 256 channels one kernel does the whole unit, s2 kept in registers for
the 1x1 product; wider units run a k7 kernel into a scratch s2 and a 1x1
kernel, over chunks of output channels (`bf16_chunk`). In fp32 the products
are FMAs. A ragged T is padded to a multiple of 8 for the bf16 kernel (zeros
past T are the conv's own padding).

`fused_residual_unit` takes the plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors (raising if it cannot, e.g. C not a
multiple of 32); it counts its launches in `fused_residual_unit.launches`.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict

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


def bf16_chunk(c: int) -> int:
    """Output channels the bf16 kernel computes per work item for width c: c
    itself for c = 32, 64, 96, 128, 192 or 256 (the whole unit in one kernel,
    s2 kept in registers), else the widest of 128 / 96 / 64 / 32 dividing c (a
    k7 kernel writes s2 to a scratch, a 1x1 kernel reads it). 0 when c is not
    a multiple of 32. Mirrors bf16_chunk in csrc/fused_conv.cu."""
    if c % 32 or c < 32:
        return 0
    if c <= 128 or c in (192, 256):
        return c
    return next(nc for nc in (128, 96, 64, 32) if c % nc == 0)


def conv1_chunk(c: int) -> int:
    """Output channels of one pass of the 1x1 product: the k7 chunk, or half
    of it in the fused kernel above 128 channels (its accumulator and s2 then
    fit the registers together)."""
    nc = bf16_chunk(c)
    return nc // 2 if nc == c and nc > 128 else nc


def tile_weights(w7: torch.Tensor, w1: torch.Tensor, nc: int, nc1: int) -> torch.Tensor:
    """The bf16 kernel's weight slices, in the order it streams them: for each
    chunk of nc output channels, for each 64-deep chunk of input channels, the
    seven k7 taps; then the 1x1 weight by chunks of nc1 output channels, one
    slice per input chunk. A slice is nc (or nc1) rows (output channels) x 64
    input channels (zero past C), each row 128 bytes with the 128-byte
    swizzle of a wgmma operand: the 16-byte piece p of row r is stored at
    piece p ^ (r % 8). w7: (7, C_out, C_in), w1: (C_out, C_in). Returns the
    slices as one flat bf16 tensor."""
    taps, c, _ = w7.shape
    nci = -(-c // 64)

    def slices(w, n):   # (taps, C_out, C_in) -> (chunks * nci * taps, n, 64), swizzled
        w = F.pad(w.to(torch.bfloat16), (0, nci * 64 - c))
        w = w.reshape(w.shape[0], c // n, n, nci, 64).permute(1, 3, 0, 2, 4).reshape(-1, n, 8, 8)
        src = torch.arange(8, device=w.device)[None, :] ^ (torch.arange(n, device=w.device) % 8)[:, None]
        return torch.gather(w, 2, src[None, :, :, None].expand(w.shape[0], n, 8, 8))

    return torch.cat([slices(w7, nc).reshape(-1), slices(w1[None], nc1).reshape(-1)])


# Operands prepared for the card once per (residual unit, dtype): keyed by the
# id of the unit's k7 weight tensor, dropped with it, rebuilt if a weight
# changes in place. (Tensors compare elementwise, so a WeakKeyDictionary
# cannot hold them.)
_prepared: Dict[int, tuple] = {}


def _weights_version(params):
    tensors = (params["conv1"]["weight"], params["conv1"].get("bias"),
               params["conv2"]["weight"], params["conv2"].get("bias"),
               params["snake1"]["alpha"], params["snake2"]["alpha"])
    return tuple(None if t is None else t._version for t in tensors)


def prepared_operands(params, compute_dtype):
    """(weights, b7, b1, a1, a2) for the kernel, made once per unit and
    dtype: in bf16 the tiled slices (`tile_weights`) and each alpha as (C, 2)
    pairs (alpha, 1 / (alpha + 1e-9)); in fp32 (w7, w1) and the alphas as
    `residual_unit_operands` gives them; all fp32 but the weights."""
    key = params["conv1"]["weight"]
    entry = _prepared.get(id(key))
    if entry is None or entry[0]() is not key:
        entry = (weakref.ref(key), {})
        _prepared[id(key)] = entry
        weakref.finalize(key, _prepared.pop, id(key), None)
    per_unit = entry[1]
    version = _weights_version(params)
    hit = per_unit.get(compute_dtype)
    if hit is not None and hit[0] == version:
        return hit[1]
    c = key.shape[0]
    _, w7, b7, w1, b1, a1, a2 = residual_unit_operands(
        params, torch.empty((1, c, 0), device=key.device), compute_dtype)
    if compute_dtype == torch.bfloat16:
        nc = bf16_chunk(c)
        weights = tile_weights(w7, w1, nc, conv1_chunk(c)) if nc else None
        # (alpha, 1 / (alpha + 1e-9)) a channel: the snake's division, once
        a1, a2 = (torch.stack([a, 1.0 / (a + 1e-9)], -1).contiguous() for a in (a1, a2))
    else:
        weights = (w7, w1)
    ops = (weights, b7, b1, a1, a2)
    per_unit[compute_dtype] = (version, ops)
    return ops


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("fused_conv")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sa_fused_residual_unit.argtypes = [p] * 8 + [i] * 4 + [p]
        lib.sa_fused_residual_unit.restype = i
        lib.sa_fused_residual_unit_bf16.argtypes = [p] * 8 + [i] * 4 + [p]
        lib.sa_fused_residual_unit_bf16.restype = i
        lib.sa_res_unit_plan.argtypes = [i, i, i]
        lib.sa_res_unit_plan.restype = i
        _lib = lib
    return _lib


def fused_residual_unit(params, x: torch.Tensor, dilation: int,
                        compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Drop-in for models.dacvae's plain residual unit. params: {snake1.alpha,
    conv1.{weight,bias}, snake2.alpha, conv2.{weight,bias}}; x: (B, C, T).
    Returns (B, C, T) in `compute_dtype`."""
    if x.device.type == "cpu":
        return fused_residual_unit_plain(*residual_unit_operands(params, x, compute_dtype),
                                         dilation)
    if x.device.type != "cuda":
        raise ValueError(f"fused_residual_unit: unsupported device {x.device}")
    b, c, t = x.shape
    if params["conv1"]["weight"].shape[-1] != 7:
        raise ValueError("fused_residual_unit kernel takes kernel size 7")
    code = _build.dtype_code(compute_dtype)
    lib = _load()
    if lib.sa_res_unit_plan(c, dilation, code) == 0:
        raise ValueError(f"fused_residual_unit kernel cannot take C={c}, "
                         f"dilation={dilation}, {compute_dtype}")
    weights, b7, b1, a1, a2 = prepared_operands(params, compute_dtype)
    xc = x.to(compute_dtype).contiguous()
    P = _build.ptr
    if code == 1:
        # the bf16 kernel reads rows of a multiple of 8 samples (TMA); zeros
        # past T are the conv's own zero padding, so a ragged T is padded
        tp = -(-t // 8) * 8
        xin = _build.aligned16(xc if tp == t else F.pad(xc, (0, tp - t)))
        out = torch.empty_like(xin)
        s2 = None if bf16_chunk(c) == c else torch.empty_like(xin)
        err = lib.sa_fused_residual_unit_bf16(
            P(xin), P(weights), P(b7), P(b1), P(a1), P(a2), None if s2 is None else P(s2),
            P(out), b, c, tp, dilation, _build.stream_of(xc))
        if tp != t:
            out = out[..., :t].contiguous()
    else:
        out = torch.empty_like(xc)
        w7, w1 = weights
        err = lib.sa_fused_residual_unit(
            P(xc), P(w7), P(b7), P(w1), P(b1), P(a1), P(a2), P(out),
            b, c, t, dilation, _build.stream_of(xc))
    _build.check(err, "fused_residual_unit")
    fused_residual_unit.launches += 1
    return out


fused_residual_unit.launches = 0
