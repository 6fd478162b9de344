"""Distance correlation (DGCF's factor-decorrelation regularizer).

Counterpart of ``chaorec_tpu/ops/distcorr.py``, with the reference's
epsilon placements (``utils.distance_correlation``, utils.py:83-108): +1e-8
inside both square roots, +1e-10 in the final denominator.
"""

from __future__ import annotations

import torch


def _centered_distance(x: torch.Tensor) -> torch.Tensor:
    r = torch.sum(x * x, dim=1, keepdim=True)
    d = torch.sqrt(torch.clamp(r - 2.0 * (x @ x.T) + r.T, min=0.0) + 1e-8)
    return d - d.mean(dim=0, keepdim=True) - d.mean(dim=1, keepdim=True) + d.mean()


def _dcov(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    n = d1.shape[0]
    return torch.sqrt(torch.clamp(torch.sum(d1 * d2) / (n * n), min=0.0) + 1e-8)


def distance_correlation(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    d1 = _centered_distance(x1)
    d2 = _centered_distance(x2)
    dcov_12 = _dcov(d1, d2)
    dcov_11 = _dcov(d1, d1)
    dcov_22 = _dcov(d2, d2)
    return dcov_12 / (torch.sqrt(torch.clamp(dcov_11 * dcov_22, min=0.0)) + 1e-10)
