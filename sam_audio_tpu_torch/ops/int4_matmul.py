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
k/v projections at ~14 tokens are the only launches bound by weight bytes.

Design (bf16): y^T = W . x^T on wgmma. A block owns 64 packed rows x a token
tile (16 or 64 tokens when they hold M, else 128) x one split of the groups.
Two consumer warpgroups each make one nibble plane from the same staged bytes:
a thread sign-extends its own nibbles in registers straight into wgmma's A
fragment; the x chunk is the swizzled shared-memory B operand; one lane of a
third warpgroup fetches both through TMA into a five-stage ring guarded by
mbarriers; each group's fp32 partial is scaled into the fp32 accumulator. `split_plan` spreads the groups of a tile over several blocks so
that one launch fills the card's 132 SMs (one block each) without a second
wave: (2048, 2048) at 250 tokens runs 32 tiles x 4 splits, at 14 tokens 16
tiles x 8 splits. Splits write fp32 partials to a workspace and a second
kernel adds them in order and rounds once, so the result is the same bits run
to run (no atomics). A launch of 86 tiles, (5504, 2048) at 250 tokens, stays
unsplit: two splits would need a second wave. What holds it back (PERF.md): a
chunk's copies and products take their times one after the other instead of
overlapping, and at 250 tokens two thirds of a launch are fixed costs (two
launches, the ring's fill, the workspace).

Design (fp32): the same tiles, ring and split plan on the bf16 tensor cores.
The weights are integers in [-7, 7], exact in bf16, so only x is split: a
small kernel of the same call writes x as three bf16 planes, x = hi + mid +
lo (each rounded to nearest; 24 bits in all), into a (3, M, in) workspace,
and a product of a plane with an int4 weight is exact in fp32. Each group's
partial is W_g . lo^T + W_g . mid^T + W_g . hi^T into one fresh wgmma
accumulator (the tensor cores' fp32 accumulation rounds toward zero, so it
never runs across groups), then scaled and added in fp32 as in bf16. Its
tiles, and so `split_plan`, are the bf16 body's (a stage of three planes
leaves room for two to eight stages). Its bound under this arithmetic: three
bf16 products, 3 x 2.1 GFLOP = 6.4 us at (2048, 2048) and 250 tokens (45.9 ms
over the 4,640 such launches of an fp32 separate after quantize(4)). It runs
at ~2.5x that, about a third of the fp32 matmul of the dequantized weight
(PERF.md): a chunk's copies and products add instead of overlapping, and a
call is three launches (split, products, reduce). The precision
is the design's: neither body reads torch.backends.cuda.matmul.allow_tf32 or
cudnn.allow_tf32. The TPU kernel's `tokens <= 256` VMEM gate and its padding
of the tokens to 8 are not carried over: masked copies take any token count.

`matmul_int4` takes the plain PyTorch version for CPU tensors and launches the
kernel for CUDA tensors (raising ValueError for a shape it cannot take: the
group must divide `in` and be a multiple of 16); it counts its launches in
`matmul_int4.launches`. The kernel has no gradient (nothing trains a
quantized model): on the card the wrapper raises RuntimeError when autograd
records and x requires grad.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sam_audio_tpu_torch.ops import _build
from sam_audio_tpu_torch.ops.grad import refuse_grad

_lib = None

ROW_TILE = 64          # packed rows a block owns
RESIDENT_BLOCKS = 132  # one block an SM, 132 SMs


def token_tile(m: int) -> int:
    """Tokens a block owns (either body): the least of 16, 64, 128 that
    holds m, else 128."""
    return 16 if m <= 16 else 64 if m <= 64 else 128


@functools.lru_cache(maxsize=None)
def n_splits(m: int, half: int, n_groups: int) -> int:
    """How many blocks share the groups of one output tile: the most that
    keep tiles x splits within one wave of resident blocks."""
    tiles = -(-half // ROW_TILE) * -(-m // token_tile(m))
    return max(1, min(n_groups, RESIDENT_BLOCKS // tiles))


def split_plan(m: int, half: int, n_groups: int):
    """The kernel's split of the contraction axis for m tokens, `half`
    packed rows and n_groups scale groups, in either body: [(first group,
    end group)] per split. Split s of S takes groups [s*G // S, (s+1)*G //
    S), so every group lies in exactly one split and no split is empty."""
    splits = n_splits(m, half, n_groups)
    return [(s * n_groups // splits, (s + 1) * n_groups // splits) for s in range(splits)]


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
        lib.sa_matmul_int4.argtypes = [p] * 6 + [i] * 6 + [p]
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
    refuse_grad("matmul_int4", x, w4_scale)
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
    if w4_scale.dtype != torch.float32 or not w4_scale.is_contiguous():
        raise ValueError("matmul_int4 kernel takes contiguous float32 scales, as "
                         f"quantize_linear_int4 stores them; got {w4_scale.dtype}")
    xc = _build.aligned16(x.contiguous())
    wc = _build.aligned16(w4.contiguous())
    for t in (wc, w4_scale):
        if t.device != x.device:
            raise ValueError("matmul_int4: inputs on different devices")
    out = torch.empty((m, 2 * half), dtype=x.dtype, device=x.device)
    splits = n_splits(m, half, n_groups)
    ws = (torch.empty((splits, m, 2 * half), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    # fp32: the kernel's bf16 planes hi, mid, lo of x
    x3 = (torch.empty((3, m, k), dtype=torch.bfloat16, device=x.device)
          if x.dtype == torch.float32 else None)
    P = _build.ptr
    err = _load().sa_matmul_int4(P(xc), P(wc), P(w4_scale), P(out),
                                 P(ws) if ws is not None else None,
                                 P(x3) if x3 is not None else None, m, k, half, n_groups,
                                 splits, code, _build.stream_of(xc))
    _build.check(err, "matmul_int4")
    matmul_int4.launches += 1
    return out


matmul_int4.launches = 0
_build.COUNTERS.append(matmul_int4)
