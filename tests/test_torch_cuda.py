"""The port's CUDA kernels on the card: each wrapper, given CUDA tensors,
launches its kernel (its launch counter moves) and agrees with its plain
PyTorch version. Skipped on machines without an NVIDIA GPU. Imports neither
JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Tolerances: fp32 1e-4 (another summation order); bf16 2e-2 for attention
and 5e-2 for the residual unit (a value near a bf16 rounding boundary can
round the other way in one sum order, one bf16 ulp being 2^-8 of it)."""

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_cuda_flash_attention_launches_kernel(cuda, dtype, tol):
    q, k, v, mask = _qkv(cuda, 1100, dtype, 5)
    n = flash_attention.launches
    out = flash_attention(q, k, v, mask)
    assert flash_attention.launches == n + 1
    ref = flash_attention_plain(q, k, v, mask)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


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
def test_cuda_residual_unit_refuses_what_it_cannot_take(cuda):
    with pytest.raises(ValueError):
        fused_residual_unit(_unit(cuda, 40, 1), torch.randn(1, 40, 64, device=cuda), 1)
