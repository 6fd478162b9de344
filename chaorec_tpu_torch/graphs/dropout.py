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
                   num_user: int, num_item: int, eps: float = 1e-7, self_loops: bool = False):
    """(U, I) float32 R over the edges with ``keep`` 1, on their device.
    With ``self_loops`` each degree counts one more and the result is
    ``(R, self_u, self_i)``, the self-loop weights 1 / (d + eps): a hop is
    then ``R xi + self_u xu`` and ``R^T xu + self_i xi`` (MMGCN's and
    MVGAE's graph)."""
    keep = keep.to(torch.float32)
    du = torch.zeros(num_user, dtype=torch.float32, device=keep.device).index_add_(0, edge_u, keep)
    di = torch.zeros(num_item, dtype=torch.float32, device=keep.device).index_add_(0, edge_i, keep)
    if self_loops:
        du, di = du + 1.0, di + 1.0
    w = keep * torch.rsqrt((du[edge_u] + eps) * (di[edge_i] + eps))
    dense = torch.zeros((num_user, num_item), dtype=torch.float32, device=keep.device)
    dense = dense.index_put_((edge_u, edge_i), w, accumulate=True)
    if self_loops:
        return dense, 1.0 / (du + eps), 1.0 / (di + eps)
    return dense


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


class _EdgeHop(torch.autograd.Function):
    """(new_u, new_i) = (A xi, B^T xu) for the weighted (U, I) incidences A
    (weights w) and B (weights w_i; B = A in one symmetric hop): each
    cotangent goes back through the other side's sums, with that side's
    weights."""

    @staticmethod
    def forward(ctx, w, w_i, xu, xi, bags, edge_u, edge_i):
        ctx.bags = bags
        ctx.save_for_backward(w, w_i, xu, xi, edge_u, edge_i)
        return bags.users.sum(xi, w), bags.items.sum(xu, w_i)

    @staticmethod
    def backward(ctx, g_u, g_i):
        w, w_i, xu, xi, edge_u, edge_i = ctx.saved_tensors
        gw = gw_i = None
        if ctx.needs_input_grad[0]:
            gw = torch.sum(g_u[edge_u] * xi[edge_i].float(), dim=1).to(w.dtype)
        if ctx.needs_input_grad[1]:
            gw_i = torch.sum(g_i[edge_i] * xu[edge_u].float(), dim=1).to(w_i.dtype)
        gxu = ctx.bags.users.sum(g_i, w_i) if ctx.needs_input_grad[2] else None
        gxi = ctx.bags.items.sum(g_u, w) if ctx.needs_input_grad[3] else None
        return (gw, gw_i, gxu.to(xu.dtype) if gxu is not None else None,
                gxi.to(xi.dtype) if gxi is not None else None, None, None, None)


def kept_edge_weights(edge_u: torch.Tensor, edge_i: torch.Tensor, keep: torch.Tensor,
                      bags: EdgeBags, num_user: int, num_item: int) -> torch.Tensor:
    """(E,) float32 ``keep * max(d_u d_i, 1e-12)^-1/2``, the degrees counted
    over the kept edges (``keep`` 0/1, in the edges' order) by ``bags`` in
    a fixed order: MMGCL's dropped views and DDRec's filtered layers, whose
    reference clamps the product of the degrees where ``masked_edge_weights``
    adds eps to each."""
    keep = keep.to(torch.float32)
    du = bags.users.sum(keep.new_ones((num_item, 1)), keep)[:, 0]
    di = bags.items.sum(keep.new_ones((num_user, 1)), keep)[:, 0]
    return keep * torch.rsqrt(torch.clamp(du[edge_u] * di[edge_i], min=1e-12))


def edge_propagate(edge_u: torch.Tensor, edge_i: torch.Tensor, w: torch.Tensor,
                   xu: torch.Tensor, xi: torch.Tensor, num_user: int, num_item: int,
                   bags: Optional[EdgeBags] = None, w_item: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One hop over weighted edges: (sum over a user's edges of w xi[item],
    sum over an item's edges of w_item xu[user]), in float32, in a fixed
    order (``EdgeBags``; built here when not given, which reads the edges
    back to the host: a caller that hops often builds it once).
    ``w_item`` (the edges' item-side weights, in the same edge order) is
    ``w`` unless given: FKAN_GCF drops each side's edges with a mask of its
    own."""
    if bags is None:
        bags = EdgeBags.build(edge_u, edge_i, num_user, num_item)
    return _EdgeHop.apply(w, w if w_item is None else w_item, xu, xi, bags, edge_u, edge_i)
