"""Kolmogorov-Arnold layers (Fourier and Chebyshev bases).

Counterpart of ``chaorec_tpu/ops/kan.py``, which replaces the reference's
``kanlayer.py`` (NaiveFourierKANLayer :14-46, ChebyKANLayer :49-84) used
by FKAN_GCF: each layer is one contraction of a basis expansion of its
input with a coefficient table.
"""

from __future__ import annotations

import math

import torch


def fourier_kan_init(gen: torch.Generator, in_dim: int, out_dim: int,
                     grid_size: int) -> torch.Tensor:
    """coeffs (2, out, in, grid): randn / (sqrt(in) * sqrt(grid))
    (kanlayer.py:28-29), on the generator's device."""
    scale = 1.0 / (math.sqrt(in_dim) * math.sqrt(grid_size))
    return scale * torch.randn((2, out_dim, in_dim, grid_size), generator=gen,
                               device=gen.device)


def fourier_kan(x: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """y[b, j] = sum_{i,k} cos((k+1) x[b,i]) C[0,j,i,k] + sin(..) C[1,j,i,k]."""
    grid = coeffs.shape[-1]
    k = torch.arange(1, grid + 1, dtype=x.dtype, device=x.device)
    ang = x[:, :, None] * k  # (B, in, grid)
    y = torch.einsum("big,jig->bj", torch.cos(ang), coeffs[0])
    return y + torch.einsum("big,jig->bj", torch.sin(ang), coeffs[1])


def cheby_kan(x: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Chebyshev KAN: coeffs (in, out, degree+1) (kanlayer.py:49-84)."""
    degree = coeffs.shape[-1] - 1
    n = torch.arange(0, degree + 1, dtype=x.dtype, device=x.device)
    t = torch.cos(torch.arccos(torch.clamp(torch.tanh(x), -1.0, 1.0))[:, :, None] * n)
    return torch.einsum("bid,iod->bo", t, coeffs)
