"""Segment sums in sorted prefix-difference form, and their transposed twin.

Counterpart of the segment section of ``chaorec_tpu/ops/ell.py``
(``build_segment_transpose``, ``seg_sum``, ``seg_gather``). For a flat
index vector ``flat_idx`` (E,) over S segments:

    seg_sum(values)[s] = sum_{j: flat_idx[j] == s} values[j]
    seg_gather(x)[j]   = x[flat_idx[j]]

``seg_sum`` permutes the values into segment order, takes their prefix sum
(``ops/prefix_scan.prefix_cumsum``: the CUDA kernel ``csrc/prefix_scan.cu``
on the card) and differences it at the segment pointers. Each is the
other's transpose, so the backward of ``seg_sum`` is a gather and the
backward of ``seg_gather`` is the ``seg_sum`` primal, through the prefix
kernel again. The index arguments get no gradient.

The ELL matrices (``EllMatrix``, ``EllPattern``), the grouped primitives
and ``seg_edge_weighted_sum`` are TPU gather layouts or come with their
models (ROADMAP).
"""

from __future__ import annotations

from typing import Tuple

import torch

from chaorec_tpu_torch.ops.prefix_scan import prefix_cumsum


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
