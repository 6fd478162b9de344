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
  edges and a hop is two segment sums, for per-batch views (SGL draws two
  views every step, so a dense rebuild would cost O(U I) per step).

SGL's masks index the graph's user-sorted edge order
(``BipartiteGraph.u_by_u``/``i_by_u``); both packages sort the edges by user
stably, so a mask drawn by one applies to the other. The JAX package's
scatter-free ``sorted_two_way_propagate`` is a TPU workaround and is not
ported.

A hop's sums are taken without atomics, in a fixed order (``EdgeBags``,
one ``ops/ell.SegmentBags`` a side: each destination row sums its edges
in chunks, then its chunks, weighted by w). The hop is its own transpose,
so its backward is the same two sums of the cotangents (``_EdgeHop``).
So the same inputs give the same bits on the card, at every degree: an
``index_add_`` sums in the atomics' order, and under the trainer's
deterministic mode sorts, which a row of thousands of edges (a popular
item) makes slow.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from chaorec_tpu_torch.ops.ell import SegmentBags, segment_bags


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


@dataclass(frozen=True)
class EdgeBags:
    """Both sides' ``SegmentBags`` of one edge list: users (sums over a
    user's edges of the items' rows) and items. Built once per graph."""

    users: SegmentBags
    items: SegmentBags

    @staticmethod
    def build(edge_u: torch.Tensor, edge_i: torch.Tensor, num_user: int,
              num_item: int) -> "EdgeBags":
        u, i = edge_u.cpu().numpy(), edge_i.cpu().numpy()
        return EdgeBags(segment_bags(u, i, num_user, edge_u.device),
                        segment_bags(i, u, num_item, edge_u.device))

    def hop(self, w: torch.Tensor, xu: torch.Tensor, xi: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.users.sum(xi, w), self.items.sum(xu, w)


class _EdgeHop(torch.autograd.Function):
    """(new_u, new_i) = (A xi, A^T xu) for the weighted (U, I) incidence A:
    the hop is symmetric, so the cotangents go back through the same sums."""

    @staticmethod
    def forward(ctx, w, xu, xi, bags, edge_u, edge_i):
        ctx.bags = bags
        ctx.save_for_backward(w, xu, xi, edge_u, edge_i)
        return bags.hop(w, xu, xi)

    @staticmethod
    def backward(ctx, g_u, g_i):
        w, xu, xi, edge_u, edge_i = ctx.saved_tensors
        gw = None
        if ctx.needs_input_grad[0]:
            gw = (torch.sum(g_u[edge_u] * xi[edge_i].float(), dim=1)
                  + torch.sum(g_i[edge_i] * xu[edge_u].float(), dim=1)).to(w.dtype)
        gxu, gxi = ctx.bags.hop(w, g_u, g_i)
        return (gw, gxu.to(xu.dtype) if ctx.needs_input_grad[1] else None,
                gxi.to(xi.dtype) if ctx.needs_input_grad[2] else None, None, None, None)


def edge_propagate(edge_u: torch.Tensor, edge_i: torch.Tensor, w: torch.Tensor,
                   xu: torch.Tensor, xi: torch.Tensor, num_user: int, num_item: int,
                   bags: Optional[EdgeBags] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One symmetric hop over weighted edges: (sum over a user's edges of
    w xi[item], sum over an item's edges of w xu[user]), in float32, in a
    fixed order (``EdgeBags``; built here when not given, which reads the
    edges back to the host: a caller that hops often builds it once)."""
    if bags is None:
        bags = EdgeBags.build(edge_u, edge_i, num_user, num_item)
    return _EdgeHop.apply(w, xu, xi, bags, edge_u, edge_i)
