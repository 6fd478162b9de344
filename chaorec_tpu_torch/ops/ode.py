"""Fixed-grid Euler integration.

Counterpart of ``chaorec_tpu/ops/ode.py``, which replaces
``torchdiffeq.odeint(method='euler')`` as BSPM uses it (Model/BSPM.py:
128-181, solver 'euler' on linspace grids): one step per grid interval. A
Python loop of ``steps`` steps takes the place of the JAX package's
``lax.scan``, with the same ``dt = (t1 - t0) / steps`` and the same ``t``,
carried in y's dtype.
"""

from __future__ import annotations

from typing import Callable

import torch


def odeint_euler(func: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                 y0: torch.Tensor, t0: float, t1: float, steps: int) -> torch.Tensor:
    """y(t1) by ``steps`` Euler steps of ``f(t, y)`` from ``y(t0) = y0``."""
    dt = (t1 - t0) / steps
    t = torch.tensor(t0, dtype=y0.dtype, device=y0.device)
    y = y0
    for _ in range(steps):
        y = y + dt * func(t, y)
        t = t + dt
    return y
