"""The port's CUDA kernels on the card: each wrapper, given CUDA tensors,
launches its kernel (its launch counter moves) and agrees with its plain
PyTorch version. Skipped on machines without an NVIDIA GPU. Imports neither
JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Tolerances: fp32 1e-4 (another summation order); bf16 2e-2 for attention
and the int4 product, 5e-2 for the residual unit (a value near a bf16
rounding boundary can round the other way in one sum order, one bf16 ulp
being 2^-8 of it)."""

import pytest
import torch

from sam_audio_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from sam_audio_tpu_torch.ops.fused_attention import (
    fused_glue_attention,
    fused_glue_attention_plain,
)
from sam_audio_tpu_torch.ops.fused_conv import (
    fused_residual_unit,
    fused_residual_unit_plain,
    residual_unit_operands,
)
from sam_audio_tpu_torch.ops.int4_matmul import matmul_int4, matmul_int4_plain
from sam_audio_tpu_torch.ops.quant import quantize_linear_int4
from sam_audio_tpu_torch.ops.rope import precompute_rope

H, D = 2, 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(dev, t, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(2, t, H, D, generator=g, device=dev).to(dtype)
               for _ in range(3))
    mask = torch.ones((2, t), dtype=torch.bool, device=dev)
    mask[0, t * 3 // 4:] = False   # padded batch row
    mask[1, :] = False             # fully masked row
    return q, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_cuda_fused_glue_attention_launches_kernel(cuda, dtype, tol):
    q, k, v, mask = _qkv(cuda, 200, dtype, 4)
    w = torch.ones(D, device=cuda)
    cos, sin = precompute_rope(D, 200, 20000, device=cuda)
    n = fused_glue_attention.launches
    out = fused_glue_attention(q, k, v, w, w, cos, sin, mask)
    assert fused_glue_attention.launches == n + 1
    ref = fused_glue_attention_plain(q, k, v, w, w, cos, sin, mask)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def _glue_inputs(dev, b, t, dtype):
    """q, k, v, norm weights, rope tables and a mask: row 0 padded, and where
    the batch has them row 1 fully masked and row 2 with holes."""
    g = torch.Generator(device=dev).manual_seed(t + b)
    q, k, v = (torch.randn(b, t, H, D, generator=g, device=dev).to(dtype) for _ in range(3))
    qw, kw = (1 + 0.1 * torch.randn(D, generator=g, device=dev) for _ in range(2))
    cos, sin = precompute_rope(D, t, 20000, device=dev)
    mask = torch.ones((b, t), dtype=torch.bool, device=dev)
    mask[0, max(1, t * 3 // 4):] = False
    if b > 1:
        mask[1, :] = False
    if b > 2:
        mask[2, ::3] = False
    return q, k, v, qw, kw, cos, sin, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("t", [1, 63, 64, 200, 250, 256, 257, 511, 512])
def test_cuda_fused_glue_attention_lengths_and_batches(cuda, dtype, tol, b, t):
    """Lengths on and off the 64-row query tiles and the 128-key padding (one
    to four key blocks a warpgroup); a fully masked row is the sum of V over
    round_up(T, 128) keys."""
    args = _glue_inputs(cuda, b, t, dtype)
    q, k, v, qw, kw, cos, sin, mask = args
    out = fused_glue_attention(*args)
    ref = fused_glue_attention_plain(*args)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    if b > 1:
        want = (v[1].float().sum(0) / (-(-t // 128) * 128)).expand(t, H, D)
        torch.testing.assert_close(out[1].float(), want, rtol=tol, atol=tol)
    assert torch.equal(out, fused_glue_attention(*args)), "two runs differ"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [250, 512])
def test_cuda_fused_glue_attention_no_mask_equals_all_true(cuda, dtype, t):
    q, k, v, qw, kw, cos, sin, _ = _glue_inputs(cuda, 2, t, dtype)
    mask = torch.ones((2, t), dtype=torch.bool, device=cuda)
    assert torch.equal(fused_glue_attention(q, k, v, qw, kw, cos, sin),
                       fused_glue_attention(q, k, v, qw, kw, cos, sin, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_cuda_flash_attention_launches_kernel(cuda, dtype, tol):
    q, k, v, mask = _qkv(cuda, 1100, dtype, 5)
    n = flash_attention.launches
    out = flash_attention(q, k, v, mask)
    assert flash_attention.launches == n + 1
    ref = flash_attention_plain(q, k, v, mask)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("s", [1024, 1125, 2000])
def test_cuda_flash_attention_lengths_and_batches(cuda, dtype, tol, b, s):
    """Sequence lengths on and off the 128-key padding and the 64-row tiles;
    a padded row everywhere, a fully masked row where the batch has one."""
    g = torch.Generator(device=cuda).manual_seed(s + b)
    q, k, v = (torch.randn(b, s, H, D, generator=g, device=cuda).to(dtype) for _ in range(3))
    mask = torch.ones((b, s), dtype=torch.bool, device=cuda)
    mask[0, s * 3 // 4:] = False
    if b > 1:
        mask[1, :] = False
        mask[2, ::3] = False   # holes, not only a padded tail
    out = flash_attention(q, k, v, mask)
    ref = flash_attention_plain(q, k, v, mask)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    if b > 1:   # the fully masked row: the sum of V over round_up(S, 128) keys
        want = (v[1].float().sum(0) / (-(-s // 128) * 128)).expand(s, H, D)
        torch.testing.assert_close(out[1].float(), want, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_no_mask_equals_all_true(cuda, dtype):
    q, k, v, _ = _qkv(cuda, 1125, dtype, 6)
    mask = torch.ones((2, 1125), dtype=torch.bool, device=cuda)
    assert torch.equal(flash_attention(q, k, v), flash_attention(q, k, v, mask))


def _unit(dev, c, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def u(*shape):
        return (torch.rand(*shape, generator=g, device=dev) * 2 - 1) / shape[1] ** 0.5

    return {"snake1": {"alpha": 0.5 + torch.rand(1, c, 1, generator=g, device=dev)},
            "conv1": {"weight": u(c, c, 7), "bias": u(c, c)[0]},
            "snake2": {"alpha": 0.5 + torch.rand(1, c, 1, generator=g, device=dev)},
            "conv2": {"weight": u(c, c, 1), "bias": u(c, c)[0]}}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
def test_cuda_residual_unit_launches_kernel(cuda, dtype, tol):
    p = _unit(cuda, 96, 7)
    x = torch.randn(2, 96, 5000, device=cuda)
    for dilation in (1, 3, 9):
        n = fused_residual_unit.launches
        out = fused_residual_unit(p, x, dilation, dtype)
        assert fused_residual_unit.launches == n + 1
        ref = fused_residual_unit_plain(*residual_unit_operands(p, x, dtype), dilation)
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("dilation", [1, 3, 9])
@pytest.mark.parametrize("c", [64, 96, 128, 192, 256, 384, 512, 768])
def test_cuda_residual_unit_widths_bf16(cuda, c, dilation, b):
    """Every width of the codec, fused (C <= 128) and split over output-channel
    chunks, at a ragged T; two runs give the same bits."""
    p = _unit(cuda, c, c + dilation)
    x = torch.randn(b, c, 3001, generator=torch.Generator(device=cuda).manual_seed(c),
                    device=cuda).to(torch.bfloat16)
    out = fused_residual_unit(p, x, dilation, torch.bfloat16)
    ref = fused_residual_unit_plain(*residual_unit_operands(p, x, torch.bfloat16), dilation)
    torch.testing.assert_close(out.float(), ref.float(), rtol=5e-2, atol=5e-2)
    assert torch.equal(out, fused_residual_unit(p, x, dilation, torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("dilation", [1, 3, 9])
@pytest.mark.parametrize("c", [64, 192, 512])
def test_cuda_residual_unit_widths_fp32(cuda, c, dilation):
    p = _unit(cuda, c, c + dilation)
    x = torch.randn(2, c, 3001, generator=torch.Generator(device=cuda).manual_seed(c),
                    device=cuda)
    out = fused_residual_unit(p, x, dilation, torch.float32)
    ref = fused_residual_unit_plain(*residual_unit_operands(p, x, torch.float32), dilation)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("c", [64, 256])
def test_cuda_residual_unit_shorter_than_halo(cuda, dtype, tol, c):
    """T = 20 at dilation 9: every tap of every row reaches the zero padding
    on one side or the other."""
    p = _unit(cuda, c, 3)
    x = torch.randn(2, c, 20, device=cuda)
    out = fused_residual_unit(p, x, 9, dtype)
    ref = fused_residual_unit_plain(*residual_unit_operands(p, x, dtype), 9)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_residual_unit_refuses_what_it_cannot_take(cuda):
    with pytest.raises(ValueError):
        fused_residual_unit(_unit(cuda, 40, 1), torch.randn(1, 40, 64, device=cuda), 1)


def _int4(dev, out, din, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return quantize_linear_int4({"weight": 0.1 * torch.randn(out, din, generator=g,
                                                             device=dev)})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("tokens,out,din", [(250, 256, 512), (14, 200, 768), (77, 64, 160)],
                         ids=["k1-tokens", "few-tokens-ragged-out", "group-80"])
def test_cuda_matmul_int4_launches_kernel(cuda, dtype, tol, tokens, out, din):
    q = _int4(cuda, out, din, tokens)
    x = torch.randn(tokens, din, device=cuda).to(dtype)
    n = matmul_int4.launches
    y = matmul_int4(x, q["w4"], q["w4_scale"])
    assert matmul_int4.launches == n + 1 and y.dtype == dtype and y.shape == (tokens, out)
    ref = matmul_int4_plain(x, q["w4"], q["w4_scale"])
    torch.testing.assert_close(y.float(), ref.float(), rtol=tol, atol=tol)


# (out, in) of the DiT's quantized linears at full width
DIT_SHAPES = [(2048, 2048), (5504, 2048), (2048, 5504), (2048, 768)]


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [1, 14, 250, 2000])
@pytest.mark.parametrize("out,din", DIT_SHAPES, ids=lambda v: str(v))
def test_cuda_matmul_int4_dit_shapes(cuda, tokens, out, din):
    """Every split plan the serving path meets (1 to 16 splits, uneven ones
    over 43 and 6 groups), and two runs giving the same bits."""
    q = _int4(cuda, out, din, tokens + out)
    g = torch.Generator(device=cuda).manual_seed(tokens)
    x = torch.randn(tokens, din, generator=g, device=cuda).to(torch.bfloat16)
    y = matmul_int4(x, q["w4"], q["w4_scale"])
    ref = matmul_int4_plain(x, q["w4"], q["w4_scale"])
    torch.testing.assert_close(y.float(), ref.float(), rtol=2e-2, atol=2e-2)
    assert torch.equal(y, matmul_int4(x, q["w4"], q["w4_scale"]))


@pytest.mark.cuda
@pytest.mark.parametrize("tokens,out,din,group", [(250, 256, 512, 64), (40, 200, 768, 128),
                                                  (9, 72, 96, 32), (300, 136, 2048, 16)],
                         ids=["group-64", "ragged-out", "group-32", "group-16"])
def test_cuda_matmul_int4_groups_and_ragged_rows(cuda, tokens, out, din, group):
    g = torch.Generator(device=cuda).manual_seed(out)
    q = quantize_linear_int4({"weight": 0.1 * torch.randn(out, din, generator=g, device=cuda)},
                             group_size=group)
    assert q["w4_scale"].shape == (out, din // group)
    x = torch.randn(tokens, din, generator=g, device=cuda).to(torch.bfloat16)
    y = matmul_int4(x, q["w4"], q["w4_scale"])
    ref = matmul_int4_plain(x, q["w4"], q["w4_scale"])
    torch.testing.assert_close(y.float(), ref.float(), rtol=2e-2, atol=2e-2)
    assert torch.equal(y, matmul_int4(x, q["w4"], q["w4_scale"]))


@pytest.mark.cuda
def test_cuda_matmul_int4_refuses_other_scales(cuda):
    q = _int4(cuda, 64, 256, 1)
    x = torch.randn(4, 256, device=cuda)
    with pytest.raises(ValueError):
        matmul_int4(x, q["w4"], q["w4_scale"].double())
    with pytest.raises(ValueError):
        matmul_int4(x, q["w4"], q["w4_scale"].t().contiguous().t())


@pytest.mark.cuda
def test_cuda_matmul_int4_refuses_what_it_cannot_take(cuda):
    q = _int4(cuda, 16, 120, 0)   # group 120: not a multiple of 16
    with pytest.raises(ValueError):
        matmul_int4(torch.randn(4, 120, device=cuda), q["w4"], q["w4_scale"])
