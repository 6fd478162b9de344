"""Per-destination edge softmax (GAT family).

Counterpart of ``chaorec_tpu/ops/edge_softmax.py``, which replaces
torch-geometric's ``softmax(alpha, index)`` (Model/MGAT.py GraphGAT): per
segment, subtract the max, exponentiate, divide by the segment's sum.

The sums are non-negative scalars, so they go to ``ops/ell.bag_sum``, each
segment's sum on its own in a fixed order, and not to ``ops/ell.seg_sum``,
whose prefix-difference form loses them to the running total (its
CAVEAT), nor to an atomic ``index_add_``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from chaorec_tpu_torch.ops.ell import SegmentBags, bag_sum, segment_bags


def softmax_bags(segment_ids: torch.Tensor, num_segments: int) -> SegmentBags:
    """The layout of ``segment_softmax``'s sums over ``segment_ids``: build
    it once for a fixed index list."""
    ids = segment_ids.cpu().numpy()
    return segment_bags(ids, np.arange(ids.shape[0]), num_segments, segment_ids.device)


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                    indices_are_sorted: bool = False,
                    bags: Optional[SegmentBags] = None) -> torch.Tensor:
    """Softmax of ``scores`` (E,) within each segment of ``segment_ids``
    (E,); a segment with no edge has max 0 (as the JAX package guards
    ``segment_max``'s -inf). ``indices_are_sorted`` is the JAX signature's
    hint for XLA and changes nothing here. ``bags`` is
    ``softmax_bags(segment_ids, num_segments)``, built here when not given
    (a read of the ids back to the host)."""
    # The max only shifts each segment, and a softmax does not change under
    # a shift: detached, its gradient is the same.
    smax = scores.new_full((num_segments,), float("-inf")).scatter_reduce(
        0, segment_ids, scores.detach(), "amax", include_self=False)
    smax = torch.where(torch.isfinite(smax), smax, 0.0)
    e = torch.exp(scores - smax[segment_ids])
    if bags is None:
        bags = softmax_bags(segment_ids, num_segments)
    denom = bag_sum(e, segment_ids, bags)
    return e / torch.clamp(denom[segment_ids], min=1e-16)
