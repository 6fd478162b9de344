"""Parameter initializers with torch's semantics.

Counterpart of ``chaorec_tpu/ops/init.py``. Each draws from an explicit
``torch.Generator`` and makes its tensor on that generator's device. The
numbers differ from ``jax.random``'s; parity tests carry the JAX package's
initial params across with ``params.from_numpy`` instead.

torch ``xavier_normal_`` and ``xavier_uniform_`` on a 2-D tensor (N, D)
use fan_in = D (dim 1), fan_out = N (dim 0): normal std = gain * sqrt(2 /
(fan_in + fan_out)), uniform bound = gain * sqrt(6 / (fan_in + fan_out)).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def _fans(shape: Tuple[int, ...]) -> Tuple[int, int]:
    if len(shape) < 2:
        raise ValueError("xavier init requires >= 2 dims")
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    fan_in = shape[1] * receptive
    fan_out = shape[0] * receptive
    return fan_in, fan_out


def _uniform(gen: torch.Generator, shape: Tuple[int, ...], low: float,
             high: float, dtype: torch.dtype) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=dtype)
    return u * (high - low) + low


def xavier_normal(gen: torch.Generator, shape: Tuple[int, ...], gain: float = 1.0,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    fan_in, fan_out = _fans(shape)
    std = gain * math.sqrt(2.0 / (fan_in + fan_out))
    return std * torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)


def xavier_uniform(gen: torch.Generator, shape: Tuple[int, ...], gain: float = 1.0,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    fan_in, fan_out = _fans(shape)
    bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return _uniform(gen, shape, -bound, bound, dtype)


def normal_init(gen: torch.Generator, shape: Tuple[int, ...], std: float = 0.1,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return std * torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)


def torch_linear_init(gen: torch.Generator, out_features: int, in_features: int,
                      dtype: torch.dtype = torch.float32
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch ``nn.Linear`` default init: weight and bias both
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)).

    Returns (weight (out, in), bias (out,)). Apply as ``x @ w.T + b``.
    """
    bound = 1.0 / math.sqrt(in_features)
    w = _uniform(gen, (out_features, in_features), -bound, bound, dtype)
    b = _uniform(gen, (out_features,), -bound, bound, dtype)
    return w, b


def uniform01_init(gen: torch.Generator, shape: Tuple[int, ...],
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """torch ``nn.init.uniform_`` default U[0, 1) (MultVAE's layers,
    Model/MultVAE.py:52-69)."""
    return torch.rand(shape, generator=gen, device=gen.device, dtype=dtype)
