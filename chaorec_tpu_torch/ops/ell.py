"""Segment sums in sorted prefix-difference form, and their transposed twin.

Counterpart of the segment section of ``chaorec_tpu/ops/ell.py``
(``build_segment_transpose``, ``seg_sum``, ``seg_gather``). For a flat
index vector ``flat_idx`` (E,) over S segments:

    seg_sum(values)[s] = sum_{j: flat_idx[j] == s} values[j]
    seg_gather(x)[j]   = x[flat_idx[j]]
    seg_edge_weighted_sum(edge_emb, alpha)[s]
                       = sum_{j: flat_idx[j] == s} alpha[j] edge_emb[edge(j)]

``seg_sum`` permutes the values into segment order, takes their prefix sum
(``ops/prefix_scan.prefix_cumsum``: the CUDA kernel ``csrc/prefix_scan.cu``
on the card) and differences it at the segment pointers. Each is the
other's transpose, so the backward of ``seg_sum`` is a gather and the
backward of ``seg_gather`` is the ``seg_sum`` primal, through the prefix
kernel again. ``seg_edge_weighted_sum`` is MHRec's hypergraph message
sum: slot j of a (He, k) incidence belongs to hyperedge j // k, and the
forward gathers the edges' rows in segment order, weighs them and takes
the same prefix; its backward is two gathers. The index arguments get no
gradient.

``SegmentBags`` sums segments another way, each one on its own: in order,
a bag of at most ``BAG_CHUNK`` rows at a time, then the bags
(``torch.nn.functional.embedding_bag``, no atomics), so its error is that
of the segment's own sum, and a segment of thousands of rows costs a few
short bags, not one long serial loop. ``bag_sum`` is its differentiable
form (the gradient is a gather), and ``bag_gather`` the transposed twin (a
gather whose gradient is a bag sum). SGL's views (``graphs/dropout.py``) and
the edge softmax's sums (``ops/edge_softmax.py``) use it.

``EdgeMatrix`` and ``EdgePattern`` are the port's counterparts of the JAX
package's ``EllMatrix`` and ``EllPattern``: the same sums over a fixed COO
list, ``EdgeMatrix`` with weights fixed at build (GUME's float32 graphs),
``EdgePattern`` with weights given at each call (GRCN's attention and edge
weights). Both sum with ``SegmentBags`` in each orientation, so the
backward of one orientation is the other's forward, in a fixed order. The
ELL + overflow bucket layout, ``auto_cap`` and the lane-packed (grouped)
forms are TPU gather layouts and are not ported, and so is the JAX
package's column-major slot order of ``seg_edge_weighted_sum`` (a TPU lane
layout): the port takes the incidence's slots row by row.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from chaorec_tpu_torch.ops.prefix_scan import prefix_cumsum

BAG_CHUNK = 32  # rows (then bags) one bag of SegmentBags sums in order, at most


def build_segment_transpose(indices: torch.Tensor, num_segments: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(perm, ptr)`` for a flat index vector: ``indices[perm]`` is sorted
    (stably, as the JAX package's argsort, so ties keep their order) and
    ``ptr`` (num_segments + 1,) is its CSR row pointer. Computed once per
    graph, on the indices' device."""
    perm = torch.argsort(indices, stable=True)
    bounds = torch.arange(num_segments + 1, dtype=indices.dtype, device=indices.device)
    return perm, torch.searchsorted(indices[perm], bounds)


def _seg_sum_primal(values: torch.Tensor, perm: torch.Tensor,
                    ptr: torch.Tensor) -> torch.Tensor:
    """Permute-gather, fp32 prefix sum with a zero row in front, then the
    difference at the pointers: (S,) or (S, D) fp32."""
    v = values[perm]
    cs = torch.empty((v.shape[0] + 1, *v.shape[1:]), dtype=torch.float32, device=v.device)
    cs[0] = 0.0
    prefix_cumsum(v, out=cs[1:])
    return cs[ptr[1:]] - cs[ptr[:-1]]


class _SegSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, flat_idx, perm, ptr):
        ctx.save_for_backward(flat_idx)
        ctx.dtype = values.dtype
        return _seg_sum_primal(values, perm, ptr)

    @staticmethod
    def backward(ctx, g):
        (flat_idx,) = ctx.saved_tensors
        return g[flat_idx].to(ctx.dtype), None, None, None


class _SegGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, flat_idx, perm, ptr):
        ctx.save_for_backward(perm, ptr)
        ctx.dtype = x.dtype
        return x[flat_idx]

    @staticmethod
    def backward(ctx, g):
        perm, ptr = ctx.saved_tensors
        return _seg_sum_primal(g, perm, ptr).to(ctx.dtype), None, None, None


def seg_sum(values: torch.Tensor, flat_idx: torch.Tensor, perm: torch.Tensor,
            ptr: torch.Tensor) -> torch.Tensor:
    """``out[s] = sum_{j: flat_idx[j] == s} values[j]``, fp32, differentiable
    in ``values`` (the gradient is the gather ``g[flat_idx]``).

    ``values`` is (M,) or (M, D) in the order of ``flat_idx``; ``(perm, ptr)``
    come from ``build_segment_transpose(flat_idx, S)``; the output has
    ``ptr.shape[0] - 1`` rows, and an empty segment is exactly 0.

    CAVEAT (precision model): a segment's sum is the difference of two
    global fp32 prefix values, so its ABSOLUTE error scales with the
    global running total at that point, roughly ulp(total) x O(log M),
    NOT with the segment's own magnitude; the prefix of non-negative
    values is not even monotone after rounding (an empty-looking segment
    can come out slightly negative). For zero-mean message tensors the
    running total is a random walk (~sqrt(M) sigma) and the error is
    benign; for NON-NEGATIVE values (degrees, exp-sums) the total grows
    linearly and a downstream rsqrt or division can see errors of ~0.1 at
    1e5-edge scale. Keep such scalar reductions on ``index_add_``
    (``ops/edge_softmax.segment_softmax`` does).
    """
    return _SegSum.apply(values, flat_idx, perm, ptr)


def seg_gather(x: torch.Tensor, flat_idx: torch.Tensor, perm: torch.Tensor,
               ptr: torch.Tensor) -> torch.Tensor:
    """``x[flat_idx]`` whose gradient is ``seg_sum`` of the cotangent (the
    prefix kernel on the card) instead of a scatter-add. ``ptr`` must have
    ``x.shape[0] + 1`` entries (segments over x's rows)."""
    if ptr.shape[0] != x.shape[0] + 1:
        raise ValueError(f"ptr has {ptr.shape[0]} entries, x {x.shape[0]} rows")
    return _SegGather.apply(x, flat_idx, perm, ptr)


def _sews_primal(edge_emb: torch.Tensor, alpha: torch.Tensor, perm: torch.Tensor,
                 edge_perm: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """The weighted edge rows in segment order, in fp32, then the prefix and
    its difference at the pointers: (S, D) fp32."""
    v = (alpha[perm][:, None] * edge_emb[edge_perm]).to(torch.float32)
    cs = torch.empty((v.shape[0] + 1, v.shape[1]), dtype=torch.float32, device=v.device)
    cs[0] = 0.0
    prefix_cumsum(v, out=cs[1:])
    return cs[ptr[1:]] - cs[ptr[:-1]]


class _SegEdgeWeightedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, edge_emb, alpha, flat_idx, perm, edge_perm, ptr):
        ctx.save_for_backward(edge_emb, alpha, flat_idx)
        return _sews_primal(edge_emb, alpha, perm, edge_perm, ptr)

    @staticmethod
    def backward(ctx, g):
        edge_emb, alpha, flat_idx = ctx.saved_tensors
        he, d = edge_emb.shape
        g_slots = g[flat_idx].to(torch.float32).view(he, -1, d)  # (He, k, D)
        a32 = alpha.to(torch.float32).view(he, -1)
        d_edge = d_alpha = None
        if ctx.needs_input_grad[0]:
            d_edge = (a32[:, :, None] * g_slots).sum(1).to(edge_emb.dtype)
        if ctx.needs_input_grad[1]:
            d_alpha = (edge_emb.to(torch.float32)[:, None, :] * g_slots).sum(2)
            d_alpha = d_alpha.reshape(-1).to(alpha.dtype)
        return d_edge, d_alpha, None, None, None, None


def seg_edge_weighted_sum(edge_emb: torch.Tensor, alpha: torch.Tensor, flat_idx: torch.Tensor,
                          perm: torch.Tensor, edge_perm: torch.Tensor,
                          ptr: torch.Tensor) -> torch.Tensor:
    """``out[s] = sum_{j: flat_idx[j] == s} alpha[j] * edge_emb[j // k]``
    (fp32, (S, D)) without a (He k, D) message tensor: the fused message sum
    of hypergraph attention (MHRec, Model/MHRec.py:37-89).

    ``flat_idx`` is the (He, k) incidence's node slots row by row
    (``h_nodes.reshape(-1)``), ``alpha`` (He k,) their weights in that
    order, ``(perm, ptr)`` from ``build_segment_transpose(flat_idx, S)``
    and ``edge_perm = perm // k``, the hyperedge of each slot in segment
    order. Forward: one gather of He-row edge embeddings in segment order,
    weighted, into the fp32 prefix (``prefix_cumsum``, K4 on the card).
    Backward, two gathers of the cotangent at the slots' nodes:
    ``d edge_emb[e] = sum_j alpha[e k + j] g[flat_idx[e k + j]]`` and
    ``d alpha[m] = edge_emb[m // k] . g[flat_idx[m]]``, returned in the
    inputs' dtypes.

    Its precision is ``seg_sum``'s (a global fp32 prefix): right for
    zero-mean messages, not for non-negative scalar sums, which stay on
    ``index_add_`` (MHRec's softmax denominators do).
    """
    if alpha.shape[0] % edge_emb.shape[0]:
        raise ValueError(f"{alpha.shape[0]} slots over {edge_emb.shape[0]} hyperedges")
    return _SegEdgeWeightedSum.apply(edge_emb, alpha, flat_idx, perm, edge_perm, ptr)


@dataclass(frozen=True)
class SegmentBags:
    """Fixed-order sums over the segments of a fixed index list (each entry
    j: a segment dest[j] and a source row src[j]): the entries in segment
    order (``order``, None when already so), their source rows in that
    order (``src``), and the bag offsets of each level (``levels``): the
    first level's bags are runs of at most BAG_CHUNK entries of one
    segment, each later level's of at most BAG_CHUNK bags of the level
    before, and the last level has one bag a segment (empty for a segment
    without entries)."""

    order: Optional[torch.Tensor]
    src: torch.Tensor
    levels: List[torch.Tensor]
    inputs: List[torch.Tensor]  # arange(bags) of each level but the last, the next level's input

    def sum(self, x: torch.Tensor, w: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(segments, D) float32: segment s's sum of w[j] x[src[j]] over its
        entries j (w (E,) in the entries' own order; 1 when None)."""
        if w is not None:
            w = (w if self.order is None else w[self.order]).float()
        out = F.embedding_bag(self.src, x.float(), self.levels[0], mode="sum",
                              per_sample_weights=w)
        for inp, offsets in zip(self.inputs, self.levels[1:]):
            out = F.embedding_bag(inp, out, offsets, mode="sum")
        return out


def segment_bags(dest: np.ndarray, src: np.ndarray, num_rows: int,
                 device: torch.device | str) -> SegmentBags:
    """``SegmentBags`` of the entries (dest, src), ``dest`` in any order.
    Built on the host, once per index list."""
    order = np.argsort(dest, kind="stable")
    counts = np.bincount(dest, minlength=num_rows).astype(np.int64)
    levels = []
    while True:
        starts = np.cumsum(counts) - counts  # each row's first entry at this level
        if counts.max(initial=0) <= BAG_CHUNK:
            levels.append(starts)
            break
        chunks = -(-counts // BAG_CHUNK)
        row = np.repeat(np.arange(num_rows), chunks)
        nth = np.arange(row.shape[0]) - (np.cumsum(chunks) - chunks)[row]
        levels.append(starts[row] + BAG_CHUNK * nth)
        counts = chunks
    def as_t(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)

    identity = bool(np.all(order == np.arange(order.shape[0])))
    return SegmentBags(order=None if identity else as_t(order), src=as_t(src[order]),
                       levels=[as_t(a) for a in levels],
                       inputs=[torch.arange(a.shape[0], device=device) for a in levels[:-1]])


class _BagSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, bags, dest):
        ctx.save_for_backward(dest)
        ctx.dtype = values.dtype
        return bags.sum(values.reshape(values.shape[0], -1)).reshape(-1, *values.shape[1:])

    @staticmethod
    def backward(ctx, g):
        (dest,) = ctx.saved_tensors
        return g[dest].to(ctx.dtype), None, None


def bag_sum(values: torch.Tensor, dest: torch.Tensor, bags: SegmentBags) -> torch.Tensor:
    """``out[s] = sum_{j: dest[j] == s} values[j]`` (fp32, (S,) or (S, D)),
    each segment summed on its own in a fixed order; ``bags`` is
    ``segment_bags(dest, arange(E), S)``. Differentiable in ``values`` (the
    gradient is the gather ``g[dest]``)."""
    return _BagSum.apply(values, bags, dest)


class _BagGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, bags):
        ctx.bags = bags
        ctx.dtype = x.dtype
        return x[idx]

    @staticmethod
    def backward(ctx, g):
        out = ctx.bags.sum(g.reshape(g.shape[0], -1))
        return out.reshape(-1, *g.shape[1:]).to(ctx.dtype), None, None


def bag_gather(x: torch.Tensor, idx: torch.Tensor, bags: SegmentBags) -> torch.Tensor:
    """``x[idx]`` whose gradient is summed per row of x in a fixed order
    (``bags.sum`` of the cotangent) instead of by a scatter-add: ``bags`` is
    ``segment_bags(idx, arange(E), x.shape[0])``, ``bag_sum``'s transposed
    twin."""
    return _BagGather.apply(x, idx, bags)


class _EdgeMatVec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, fwd, bwd):
        ctx.save_for_backward(w)
        ctx.bwd, ctx.dtype = bwd, x.dtype
        return fwd.sum(x, w)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return ctx.bwd.sum(g, w).to(ctx.dtype), None, None, None


@dataclass(frozen=True)
class EdgeMatrix:
    """A fixed (num_rows, num_cols) sparse matrix A of float32 weights ``w``
    over a COO list (``EllMatrix``): ``matvec(x)`` is A @ x, ``t.matvec(x)``
    is A^T @ x, each summed per row in a fixed order, and the gradient of x
    is the other orientation's sum of the cotangent. The weights get no
    gradient."""

    num_rows: int
    num_cols: int
    w: torch.Tensor          # (E,) float32, in the COO list's order
    by_row: SegmentBags      # segments: rows, sources: cols
    by_col: SegmentBags      # segments: cols, sources: rows

    @staticmethod
    def from_coo(rows: np.ndarray, cols: np.ndarray, w: np.ndarray, num_rows: int,
                 num_cols: int, device: torch.device | str) -> "EdgeMatrix":
        rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
        return EdgeMatrix(num_rows, num_cols,
                          torch.from_numpy(np.asarray(w, np.float32)).to(device),
                          segment_bags(rows, cols, num_rows, device),
                          segment_bags(cols, rows, num_cols, device))

    @property
    def t(self) -> "EdgeMatrix":
        return EdgeMatrix(self.num_cols, self.num_rows, self.w, self.by_col, self.by_row)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x for x (num_cols, D): (num_rows, D) float32."""
        return _EdgeMatVec.apply(x, self.w, self.by_row, self.by_col)


class _PatternMatVec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, x, pat):
        ctx.save_for_backward(w, x)
        ctx.pat = pat
        return pat.by_row.sum(x, w)

    @staticmethod
    def backward(ctx, g):
        w, x = ctx.saved_tensors
        pat = ctx.pat
        gw = gx = None
        if ctx.needs_input_grad[0]:
            gw = torch.sum(g[pat.rows] * x[pat.cols].float(), dim=1).to(w.dtype)
        if ctx.needs_input_grad[1]:
            gx = pat.by_col.sum(g, w).to(x.dtype)
        return gw, gx, None


class _PairInner(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pat):
        ctx.save_for_backward(x)
        ctx.pat = pat
        return torch.sum(x[pat.rows] * x[pat.cols], dim=1)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pat = ctx.pat
        return (pat.by_row.sum(x, g) + pat.by_col.sum(x, g)).to(x.dtype), None


@dataclass(frozen=True)
class EdgePattern:
    """A fixed COO pattern (rows[e], cols[e]) over (num_rows, num_cols) whose
    edge weights are given at each call (``EllPattern``): the GAT family's
    per-step attention. Every sum is per row or per column in a fixed
    order, forward and backward:

    - ``weighted_matvec(w, x)[r] = sum_{e: rows[e] = r} w[e] x[cols[e]]``,
      differentiable in w and x;
    - ``weighted_rowsum(w)[r] = sum_{e: rows[e] = r} w[e]``;
    - ``pair_inner(x)[e] = <x[rows[e]], x[cols[e]]>`` (square patterns);
    - ``row_gather(v)`` and ``col_gather(v)``: ``v[rows]`` and ``v[cols]``
      whose gradients are those fixed-order sums, not scatter-adds."""

    num_rows: int
    num_cols: int
    rows: torch.Tensor       # (E,) int64
    cols: torch.Tensor       # (E,) int64
    by_row: SegmentBags      # segments: rows, sources: cols
    by_col: SegmentBags      # segments: cols, sources: rows
    row_bags: SegmentBags    # segments: rows, sources: the edges
    col_bags: SegmentBags    # segments: cols, sources: the edges

    @staticmethod
    def from_coo(rows: np.ndarray, cols: np.ndarray, num_rows: int, num_cols: int,
                 device: torch.device | str) -> "EdgePattern":
        rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
        edges = np.arange(rows.shape[0])

        def as_t(a):
            return torch.from_numpy(a).to(device)

        return EdgePattern(num_rows, num_cols, as_t(rows), as_t(cols),
                           segment_bags(rows, cols, num_rows, device),
                           segment_bags(cols, rows, num_cols, device),
                           segment_bags(rows, edges, num_rows, device),
                           segment_bags(cols, edges, num_cols, device))

    @property
    def num_edges(self) -> int:
        return int(self.rows.shape[0])

    def weighted_matvec(self, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return _PatternMatVec.apply(w, x, self)

    def weighted_rowsum(self, w: torch.Tensor) -> torch.Tensor:
        return bag_sum(w, self.rows, self.row_bags)

    def pair_inner(self, x: torch.Tensor) -> torch.Tensor:
        return _PairInner.apply(x, self)

    def row_gather(self, v: torch.Tensor) -> torch.Tensor:
        return bag_gather(v, self.rows, self.row_bags)

    def col_gather(self, v: torch.Tensor) -> torch.Tensor:
        return bag_gather(v, self.cols, self.col_bags)
