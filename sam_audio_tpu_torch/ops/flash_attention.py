"""Forward flash attention with a key-padding mask, (B, S, H, D) layout.

Replaces the TPU kernel sam_audio_tpu/ops/flash_attention.py::
flash_attention (`_flash_padded` / `_flash_kernel`): an online softmax
(running max m, running sum l and the accumulator in fp32) over key tiles,
the int8 key mask applied as an additive -0.7 * f32max, p rounded to the
value dtype before the product with V, l == 0 guarded, sequences treated as
padded to multiples of 128 (padded keys masked).

Kernel: csrc/flash_attention.cu (CUDA, sm_90a). What bounds it on the H100
at the main-path shape (a 45 s clip: B=1, S=1125, H=16, D=128, bf16): it
reads q, k, v and writes out, 4 x 4.6 MB = 18.4 MB (5.5 us at 3.35 TB/s),
and does 4*S*S*D*H = 10.4 GFLOP (10.5 us at 989 TFLOP/s bf16): bound by
operations. The design never materialises the (S, S) scores. In bf16 a block
is three consumer warpgroups of 64 queries each plus a producer: one lane of
the producer's warpgroup fetches Q and then 64-key K and V tiles through TMA
(a tensor map over the (B, S, H, D) layout, 128-byte swizzle, zero fill past
S) into a three-stage ring guarded by mbarriers, so the next tiles' copies run
under this tile's products; q . k^T and p . v are wgmma products (p from
registers, V read as it lies); a warpgroup starts tile j + 1's scores together
with tile j's p . v and runs the softmax, in base 2 with the scale folded in,
while they are in flight. 192 queries a block make the long path 96 blocks,
all resident at once, each pulling K and V through L2 only once per 192
queries. In fp32 both products run on the tensor cores in split TF32
("3xTF32": each operand split into hi + lo in TF32, lo . hi + hi . lo +
hi . hi summed in fp32) on mma.sync, fed by the same kind of TMA ring (two
stages of 32-key fp32 K and V tiles, each split once for the block, V
transposed); a block is nine warps of 16 query rows (144 rows: the long
path's 128 blocks fill one wave), the scores and p stay in registers, p is
not rounded, and each tile's p . v goes to a fresh accumulator added to the
running output in fp32. Its bound under that arithmetic: three TF32
products, 3 x 10.4 GFLOP = 63 us at 495 TFLOP/s at (1, 1125, 16, 128). It
runs at ~3.6x that, under SDPA fp32 at B = 1 and 8 (PERF.md): a tile's
products form long dependent chains, Q's fragments are split again every
tile, and ten warps an SM cap a thread at 168 registers.
The precision is the design's: neither body reads
torch.backends.cuda.matmul.allow_tf32 or cudnn.allow_tf32. A null mask
pointer stands for "no mask": the wrapper launches nothing but the kernel; a
tile's mask bytes are read two a lane and shared by ballot.

`flash_attention` takes the plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors (raising if it cannot); it counts its
launches in `flash_attention.launches`. When autograd records and q, k or v
requires grad, the launch goes through `FlashAttentionFn`, whose backward is
the plain version's gradient (ops/grad.py): the JAX package defines no VJP
for its kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from sam_audio_tpu_torch.ops import _build
from sam_audio_tpu_torch.ops.grad import needs_grad, plain_vjp

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
BLOCK = 128
_lib = None


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def flash_attention_plain(q, k, v, key_padding_mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None,
                          block_k: int = BLOCK) -> torch.Tensor:
    """The kernel's function in plain PyTorch, walking the key blocks in
    order with the same online-softmax updates."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    sk_p = _round_up(sk, block_k)
    if key_padding_mask is None:
        key_padding_mask = torch.ones((b, sk), dtype=torch.bool, device=q.device)
    mask = F.pad(key_padding_mask.float(), (0, sk_p - sk))   # 1 = attend
    kp = F.pad(k, (0, 0, 0, 0, 0, sk_p - sk)).float()
    vp = F.pad(v, (0, 0, 0, 0, 0, sk_p - sk))
    qf = q.float()
    m = torch.full((b, h, sq, 1), float("-inf"), device=q.device)
    l = torch.zeros((b, h, sq, 1), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    for k0 in range(0, sk_p, block_k):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kp[:, k0:k0 + block_k]) * scale
        s = s + (1.0 - mask[:, None, None, k0:k0 + block_k]) * DEFAULT_MASK_VALUE
        m_next = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - m_next)
        l = alpha * l + torch.sum(p, dim=-1, keepdim=True)
        m = m_next
        acc = acc * alpha + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(v.dtype).float(),
            vp[:, k0:k0 + block_k].float())
    l_inv = torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
    return (acc * l_inv).to(q.dtype).transpose(1, 2)


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sa_flash_attention.argtypes = [p] * 5 + [i] * 5 + [f, i, p]
        lib.sa_flash_attention.restype = i
        _lib = lib
    return _lib


class FlashAttentionFn(torch.autograd.Function):
    """Kernel 2 forward, the plain version's gradient backward.

    `forward_fn(q, k, v, key_padding_mask, scale)` computes the forward: the
    kernel's launch on the card (a test passes `flash_attention_plain` to run
    this backward on the CPU). The backward reruns `flash_attention_plain` on
    the saved inputs and differentiates it, for q, k and v."""

    @staticmethod
    def forward(ctx, forward_fn, q, k, v, key_padding_mask, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, key_padding_mask)
        return forward_fn(q, k, v, key_padding_mask, scale)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, mask = ctx.saved_tensors
        grads = plain_vjp(lambda *x: flash_attention_plain(*x, mask, ctx.scale),
                          (q, k, v), ctx.needs_input_grad[1:4], grad_out)
        return (None, *grads, None, None)


def flash_attention(q, k, v, key_padding_mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, H, D); key_padding_mask: (B, Sk) bool.
    Plain version on the CPU, the CUDA kernel on the card (D = 128), through
    `FlashAttentionFn` when a gradient is recorded."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, key_padding_mask, scale)
    if needs_grad(q, k, v):
        return FlashAttentionFn.apply(_launch, q, k, v, key_padding_mask, scale)
    return _launch(q, k, v, key_padding_mask, scale)


def _launch(q, k, v, key_padding_mask, scale):
    """One launch of the kernel on CUDA tensors (counted)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d != 128:
        raise ValueError(f"flash_attention kernel takes D = 128, got {d}")
    if not (q.dtype == k.dtype == v.dtype) or k.shape != v.shape or k.shape[0] != b \
            or k.shape[2:] != q.shape[2:]:
        raise ValueError("flash_attention: q, k, v shapes/dtypes disagree")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    code = _build.dtype_code(q.dtype)
    q, k, v = (_build.aligned16(x.contiguous()) for x in (q, k, v))
    mask = key_padding_mask
    if mask is not None:
        # one byte an element either way: the kernel reads the bool tensor as it is
        if mask.dtype not in (torch.bool, torch.uint8) or mask.shape != (b, sk):
            raise ValueError("flash_attention: key_padding_mask must be a (B, Sk) bool "
                             f"tensor, got {mask.dtype} {tuple(mask.shape)}")
        mask = mask.contiguous()
    if k.device != q.device or (mask is not None and mask.device != q.device):
        raise ValueError("flash_attention: inputs on different devices")
    out = torch.empty_like(q)
    P = _build.ptr
    err = _load().sa_flash_attention(
        P(q), P(k), P(v), P(mask) if mask is not None else None, P(out), b, sq, sk, h, d,
        ctypes.c_float(scale), code, _build.stream_of(q))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
_build.COUNTERS.append(flash_attention)
