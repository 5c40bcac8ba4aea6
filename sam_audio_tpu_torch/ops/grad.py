"""Gradients around the hand-written kernels.

The JAX package defines no VJP for any of its Pallas kernels: `jax.grad`
differentiates its plain code. The port's attention kernels (1 and 2) keep
that gradient: their `torch.autograd.Function`s launch the kernel forward and,
in the backward, rerun the kernel's plain version on the saved inputs and
differentiate it (`plain_vjp`). Kernels 3 and 4 are on no differentiated path
(the codec is frozen, and nothing trains a quantized model), so their wrappers
refuse a CUDA input that needs a gradient (`refuse_grad`) instead of returning
a tensor cut from the graph.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch


def needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """True when autograd is recording and any of `tensors` requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def plain_vjp(fn: Callable, inputs: Sequence[torch.Tensor], needs: Sequence[bool],
              grad_out: torch.Tensor):
    """The gradient of `fn(*inputs)` against `grad_out`, for the inputs whose
    `needs` is True (None for the others), by autograd over `fn`."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(n) for x, n in zip(inputs, needs)]
        out = fn(*xs)
        got = iter(torch.autograd.grad(out, [x for x, n in zip(xs, needs) if n], grad_out))
    return [next(got) if n else None for n in needs]


def refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise when a kernel without a gradient is asked for one."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no gradient, and an input requires one. "
            "Run it under torch.no_grad() (the codec is frozen in training) or on "
            "tensors that do not require grad")
