"""Per-destination edge softmax (GAT family).

Counterpart of ``chaorec_tpu/ops/edge_softmax.py``, which replaces
torch-geometric's ``softmax(alpha, index)`` (Model/MGAT.py GraphGAT): per
segment, subtract the max, exponentiate, divide by the segment's sum.

The sums are non-negative scalars, so they go to ``index_add_`` and not
to ``ops/ell.seg_sum``, whose prefix-difference form loses them to the
running total (its CAVEAT).
"""

from __future__ import annotations

import torch


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                    indices_are_sorted: bool = False) -> torch.Tensor:
    """Softmax of ``scores`` (E,) within each segment of ``segment_ids``
    (E,); a segment with no edge has max 0 (as the JAX package guards
    ``segment_max``'s -inf). ``indices_are_sorted`` is the JAX signature's
    hint for XLA and changes nothing here."""
    # The max only shifts each segment, and a softmax does not change under
    # a shift: detached, its gradient is the same.
    smax = scores.new_full((num_segments,), float("-inf")).scatter_reduce(
        0, segment_ids, scores.detach(), "amax", include_self=False)
    smax = torch.where(torch.isfinite(smax), smax, 0.0)
    e = torch.exp(scores - smax[segment_ids])
    denom = scores.new_zeros((num_segments,)).index_add(0, segment_ids, e)
    return e / torch.clamp(denom[segment_ids], min=1e-16)
