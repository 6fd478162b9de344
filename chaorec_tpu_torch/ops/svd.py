"""Randomized truncated SVD.

Counterpart of ``chaorec_tpu/ops/svd.py``, which replaces
``torch.svd_lowrank`` (LightGCL, Model/LightGCL.py:43-49) and the sparse SVD
of BSPM's catalogs above 20000 items: the Halko-Martinsson-Tropp sketch, a
Gaussian range finder with ``power_iters`` QR re-orthonormalisations, then
the exact SVD of the small projected matrix, all in float32. It runs once,
when a model is built, through ``torch.linalg`` on the matrix's device; no
kernel stands behind it in either package. The Gaussian sketch comes from
an explicit generator, so its numbers differ from ``jax.random``'s: the
tests compare subspaces and singular values, not the factors' signs.
"""

from __future__ import annotations

from typing import Tuple

import torch


def randomized_svd(generator: torch.Generator, a: torch.Tensor, q: int,
                   oversample: int = 10, power_iters: int = 4
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rank-q SVD of a dense (M, N) matrix: (U (M, q), s (q,), V (N, q)), in
    float32 on a's device (the generator's device must be that device)."""
    m, n = a.shape
    width = min(q + oversample, min(m, n))
    a32 = a.to(torch.float32)
    g = torch.randn((n, width), generator=generator, device=generator.device,
                    dtype=torch.float32)
    qmat, _ = torch.linalg.qr(a32 @ g)
    for _ in range(power_iters):
        z, _ = torch.linalg.qr(a32.T @ qmat)
        qmat, _ = torch.linalg.qr(a32 @ z)
    ub, s, vt = torch.linalg.svd(qmat.T @ a32, full_matrices=False)
    return (qmat @ ub)[:, :q], s[:q], vt[:q].T
