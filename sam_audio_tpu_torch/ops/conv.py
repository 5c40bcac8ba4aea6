"""1-D convolution ops with the reference's padding semantics.

Counterpart of sam_audio_tpu/ops/conv.py:
  * audiocraft-style asymmetric/"extra" padding used by the Patcher stem
    (reference: sam_audio/model/patcher.py:11-67),
  * reflect padding with the small-input zero-extension trick
    (reference: patcher.py:24-32),
  * torch Conv1d / ConvTranspose1d for the DAC-VAE codec,
  * GroupNorm and the Snake activation, with the bf16 polynomial sin^2.

Weight layouts are torch's: Conv1d (out, in, k); ConvTranspose1d (in, out, k).
Arrays are channels-first (B, C, T). The plain convs go to F.conv1d /
F.conv_transpose1d; the residual unit has its own kernel (ops/fused_conv.py).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def pad1d(x: torch.Tensor, paddings: Tuple[int, int], mode: str = "constant",
          value: float = 0.0) -> torch.Tensor:
    """Pad the last axis. For reflect mode on inputs shorter than the padding,
    zero-extend to the right first then trim (audiocraft trick,
    reference: sam_audio/model/patcher.py:11-34) — F.pad alone raises there."""
    padding_left, padding_right = paddings
    assert padding_left >= 0 and padding_right >= 0, paddings
    if mode != "reflect":
        return F.pad(x, (padding_left, padding_right), value=value)
    length = x.shape[-1]
    extra_pad = 0
    max_pad = max(padding_left, padding_right)
    if length <= max_pad:
        extra_pad = max_pad - length + 1
        x = F.pad(x, (0, extra_pad))
    shape = x.shape
    # F.pad's reflect mode takes (N, C, T); fold any leading axes into N
    padded = F.pad(x.reshape(-1, 1, shape[-1]), (padding_left, padding_right),
                   mode="reflect")
    padded = padded.reshape(*shape[:-1], padded.shape[-1])
    return padded[..., : padded.shape[-1] - extra_pad]


def get_extra_padding_for_conv1d(length: int, kernel_size: int, stride: int,
                                 padding_total: int = 0) -> int:
    """reference: sam_audio/model/patcher.py:37-45."""
    n_frames = (length - kernel_size + padding_total) / stride + 1
    ideal_length = (math.ceil(n_frames) - 1) * stride + (kernel_size - padding_total)
    return ideal_length - length


def _add_bias(out, params):
    if "bias" in params:
        out = out + params["bias"].to(out.dtype)[None, :, None]
    return out


def conv1d(params, x, stride: int = 1, padding=0, dilation: int = 1,
           groups: int = 1, compute_dtype=None):
    """x: (B, C_in, T); weight: (C_out, C_in/groups, K). `padding` is an int
    (symmetric, like torch) or an explicit (left, right) tuple."""
    w = params["weight"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    if not isinstance(padding, int):
        left, right = padding
        if left == right:
            padding = left
        else:
            x = F.pad(x, (left, right))
            padding = 0
    out = F.conv1d(x, w, None, stride, padding, dilation, groups)
    return _add_bias(out, params).to(x.dtype)


def conv_transpose1d(params, x, stride: int = 1, padding: int = 0,
                     output_padding: int = 0, compute_dtype=None):
    """torch.nn.ConvTranspose1d numerics: out_len = (T-1)*stride - 2*padding + K
    + output_padding; weight (in, out, k)."""
    w = params["weight"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    out = F.conv_transpose1d(x, w, None, stride, padding, output_padding)
    return _add_bias(out, params).to(x.dtype)


def audiocraft_conv1d(params, x, stride: int = 1, dilation: int = 1,
                      pad_mode: str = "constant", compute_dtype=None):
    """Conv1d with audiocraft auto-padding (reference: patcher.py:48-67):
    pads so every input frame is covered, asymmetric for odd strides."""
    k = params["weight"].shape[-1]
    effective_k = (k - 1) * dilation + 1
    padding_total = effective_k - stride
    extra_padding = get_extra_padding_for_conv1d(
        x.shape[-1], effective_k, stride, padding_total
    )
    padding_right = padding_total // 2
    padding_left = padding_total - padding_right
    x = pad1d(x, (padding_left, padding_right + extra_padding), mode=pad_mode)
    return conv1d(params, x, stride=stride, padding=0, dilation=dilation,
                  compute_dtype=compute_dtype)


def groupnorm(params, x, num_groups: int, eps: float = 1e-5):
    """torch.nn.GroupNorm numerics, statistics in fp32. x: (B, C, T)."""
    b, c, t = x.shape
    xf = x.float().reshape(b, num_groups, c // num_groups * t)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    normed = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, c, t)
    out = normed * params["weight"][None, :, None] + params["bias"][None, :, None]
    return out.to(x.dtype)


# cos(sqrt(u)) on u in [0, pi^2], Chebyshev-fit power basis, max err 2.6e-8.
_COS_POLY = (0.9999999738700588, -0.49999985125182195, 0.041666462324917386,
             -0.0013887731716129153, 2.4769052460238803e-05,
             -2.7075446763970063e-07, 1.7243750503357124e-09)
_TWO_PI = 6.283185307179586


def sin2_fast(z: torch.Tensor) -> torch.Tensor:
    """sin^2(z) = (1 - cos(2z))/2 with range reduction to [-pi, pi] and an
    even polynomial; f32 absolute error <= 4e-5 for |z| < 320, far below
    bf16 resolution (sam_audio_tpu/ops/conv.py:217-228)."""
    z2 = 2.0 * z
    r = z2 - _TWO_PI * torch.round(z2 * (1.0 / _TWO_PI))
    u = r * r
    acc = torch.full_like(z, _COS_POLY[-1])
    for c in _COS_POLY[-2::-1]:
        acc = acc * u + c
    return 0.5 * (1.0 - acc)


def snake_f32(xf: torch.Tensor, alpha: torch.Tensor, fast: bool) -> torch.Tensor:
    """x + sin^2(alpha x)/alpha in fp32; alpha broadcasts over x."""
    sin2 = sin2_fast(alpha * xf) if fast else torch.square(torch.sin(alpha * xf))
    return xf + (1.0 / (alpha + 1e-9)) * sin2


def snake(params, x: torch.Tensor, fast: Optional[bool] = None) -> torch.Tensor:
    """x + (1/alpha) * sin^2(alpha x), alpha (1, C, 1). The polynomial sin^2
    runs for bf16 inputs, exact sin for fp32 (as the JAX package does)."""
    if fast is None:
        fast = x.dtype == torch.bfloat16
    return snake_f32(x.float(), params["alpha"].float(), fast).to(x.dtype)
