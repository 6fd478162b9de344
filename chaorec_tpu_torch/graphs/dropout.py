"""Edge dropout and pruning with renormalization.

Counterpart of ``chaorec_tpu/graphs/dropout.py``. Given a 0/1 keep mask
over the edge list, the degrees are counted again over the kept edges (the
reference's post-dropout renormalization, Model/SGL.py:110-121,
Model/FREEDOM.py:143-162) and each kept edge weighs
``(d_u + eps)^-1/2 (d_i + eps)^-1/2``. The mask zeroes weights and never
drops entries, as in the JAX package. Two forms:

- ``masked_dense_r``: the weights scatter-added into a dense (U, I) R, for
  per-epoch pruning (FREEDOM);
- ``masked_edge_weights`` + ``edge_propagate``: the weights stay on the
  edges and a hop is two ``index_add_``s, for per-batch views (SGL draws
  two views every step, so a dense rebuild would cost O(U I) per step).

SGL's masks index the graph's user-sorted edge order
(``BipartiteGraph.u_by_u``/``i_by_u``); both packages sort the edges by user
stably, so a mask drawn by one applies to the other. The JAX package's
scatter-free ``sorted_two_way_propagate`` is a TPU workaround and is not
ported: here autograd of ``edge_propagate`` gives the gradients.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def masked_dense_r(edge_u: torch.Tensor, edge_i: torch.Tensor, keep: torch.Tensor,
                   num_user: int, num_item: int, eps: float = 1e-7) -> torch.Tensor:
    """(U, I) float32 R over the edges with ``keep`` 1, on their device."""
    keep = keep.to(torch.float32)
    du = torch.zeros(num_user, dtype=torch.float32, device=keep.device).index_add_(0, edge_u, keep)
    di = torch.zeros(num_item, dtype=torch.float32, device=keep.device).index_add_(0, edge_i, keep)
    w = keep * torch.rsqrt((du[edge_u] + eps) * (di[edge_i] + eps))
    dense = torch.zeros((num_user, num_item), dtype=torch.float32, device=keep.device)
    return dense.index_put_((edge_u, edge_i), w, accumulate=True)


def bernoulli_keep(generator: torch.Generator, num_edges: int, keep_prob: float) -> torch.Tensor:
    """(E,) float32 0/1 mask, each edge kept with ``keep_prob``, on the
    generator's device."""
    u = torch.rand(num_edges, generator=generator, device=generator.device)
    return (u < keep_prob).to(torch.float32)


def masked_edge_weights(edge_u: torch.Tensor, edge_i: torch.Tensor, keep: torch.Tensor,
                        num_user: int, num_item: int, self_loops: bool = False,
                        eps: float = 1e-7
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(w, self_u, self_i): each edge's weight renormalized over the kept
    edges (0 for a dropped one), in the edges' order; with ``self_loops``
    each degree counts one more and ``self_u``/``self_i`` are the self-loop
    weights 1 / (d + eps), else None."""
    keep = keep.to(torch.float32)
    du = torch.zeros(num_user, dtype=torch.float32, device=keep.device).index_add_(0, edge_u, keep)
    di = torch.zeros(num_item, dtype=torch.float32, device=keep.device).index_add_(0, edge_i, keep)
    if self_loops:
        du, di = du + 1.0, di + 1.0
    w = keep * torch.rsqrt((du[edge_u] + eps) * (di[edge_i] + eps))
    if self_loops:
        return w, 1.0 / (du + eps), 1.0 / (di + eps)
    return w, None, None


def edge_propagate(edge_u: torch.Tensor, edge_i: torch.Tensor, w: torch.Tensor,
                   xu: torch.Tensor, xi: torch.Tensor, num_user: int, num_item: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One symmetric hop over weighted edges: (sum over a user's edges of
    w xi[item], sum over an item's edges of w xu[user]), in float32. The
    gathers are ``index_select``s, whose gradient is an ``index_add_`` (the
    gradient of ``xi[edge_i]`` sorts the edges first, several times slower
    on the card)."""
    new_u = xi.new_zeros((num_user, xi.shape[1]), dtype=torch.float32)
    new_u = new_u.index_add(0, edge_u, w[:, None] * xi.index_select(0, edge_i))
    new_i = xu.new_zeros((num_item, xu.shape[1]), dtype=torch.float32)
    new_i = new_i.index_add(0, edge_i, w[:, None] * xu.index_select(0, edge_u))
    return new_u, new_i
