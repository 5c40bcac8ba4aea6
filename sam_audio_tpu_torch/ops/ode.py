"""Fixed-step ODE integrators (counterpart of sam_audio_tpu/ops/ode.py).

The reference integrates the flow-matching velocity field with torchdiffeq's
fixed-grid midpoint method, step 2/32 over t in [0, 1] => 16 steps, 32 NFE
(reference: sam_audio/model/model.py:22, 285-290). The step grid and the
dtype casts are the JAX package's: t is float32, each increment is cast to
the state's dtype.
"""

from __future__ import annotations

from typing import Callable

import torch


def _num_steps(t0: float, t1: float, step_size: float) -> int:
    n = (t1 - t0) / step_size
    n_int = round(n)
    if abs(n - n_int) > 1e-9:
        raise ValueError(f"step_size {step_size} must divide interval [{t0},{t1}]")
    return int(n_int)


def odeint(func: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
           y0: torch.Tensor, t0: float = 0.0, t1: float = 1.0,
           method: str = "midpoint", step_size: float = 1.0 / 16) -> torch.Tensor:
    """Integrate dy/dt = func(t, y) from t0 to t1; returns y(t1). `t` is a
    0-d float32 tensor on y's device."""
    if method not in ("euler", "midpoint", "rk4"):
        raise ValueError(f"Unknown ODE method: {method!r}")
    n_steps = _num_steps(t0, t1, step_size)
    f32 = torch.float32
    h = torch.tensor(step_size, dtype=f32, device=y0.device)
    half = h / 2

    def inc(y, dt, dy):
        return y + dt.to(y.dtype) * dy.to(y.dtype)

    y = y0
    for i in range(n_steps):
        t = t0 + torch.tensor(float(i), dtype=f32, device=y0.device) * h
        if method == "euler":
            y = inc(y, h, func(t, y))
        elif method == "midpoint":
            k1 = func(t, y)
            y = inc(y, h, func(t + half, inc(y, half, k1)))
        else:
            k1 = func(t, y)
            k2 = func(t + half, inc(y, half, k1))
            k3 = func(t + half, inc(y, half, k2))
            k4 = func(t + h, inc(y, h, k3))
            y = inc(y, h / 6, k1 + 2 * k2 + 2 * k3 + k4)
    return y
