"""Lloyd k-means, in place of the reference's faiss.

Counterpart of ``chaorec_tpu/ops/kmeans.py``. NCL clusters its raw user and
item tables every training step (Model/NCL.py:61-94,
train_and_evaluate.py:107-115); here each iteration is one (N, D) @ (D, K)
product, an argmax and two ``index_add_``s, all on the tables' device:

- initial centroids: k distinct rows, the first k of a permutation drawn
  from the generator;
- assignment: the nearest centroid in L2, as the argmax of
  2 x.c - ||c||^2 (the first index on a tie, as ``jnp.argmax``);
- update: the mean of each cluster's rows; an empty cluster keeps its
  centroid.

``kmeans_from`` takes the initial rows' indices, so a test can start both
packages from the same points (the two draw different random streams).
"""

from __future__ import annotations

from typing import Tuple

import torch


def _assign(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    logits = 2.0 * (x @ c.T) - torch.sum(c * c, dim=1)[None, :]
    return torch.argmax(logits, dim=1)


def kmeans_from(x: torch.Tensor, init_idx: torch.Tensor, iters: int = 15
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(centroids (k, D), assignment (N,) int64) after ``iters`` Lloyd
    iterations from the rows ``init_idx`` (k,) of ``x`` (N, D)."""
    k = init_idx.shape[0]
    c = x[init_idx]
    ones = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    for _ in range(iters):
        a = _assign(x, c)
        sums = torch.zeros_like(c).index_add_(0, a, x)
        counts = torch.zeros(k, dtype=x.dtype, device=x.device).index_add_(0, a, ones)
        new_c = sums / torch.clamp(counts, min=1.0)[:, None]
        c = torch.where(counts[:, None] > 0, new_c, c)
    return c, _assign(x, c)


def kmeans(generator: torch.Generator, x: torch.Tensor, k: int, iters: int = 15
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kmeans_from`` with k distinct initial rows drawn from ``generator``
    (on x's device)."""
    init_idx = torch.randperm(x.shape[0], generator=generator, device=generator.device)[:k]
    return kmeans_from(x, init_idx, iters)
