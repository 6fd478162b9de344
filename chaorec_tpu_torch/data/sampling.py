"""Epoch batches and BPR negative sampling, on the device.

Counterpart of ``chaorec_tpu/data/sampling.py``. Everything random is
drawn from the trainer's ``torch.Generator`` on its device.

- ``make_epoch_batches``: a permutation of the users, for "user_rows"
  models (the JAX trainer feeds them one (user, 0) pair per user);
- ``make_edge_batches``: a permutation of the train edges, for "bpr"
  models: each batch holds (user, positive item) pairs;
- ``sample_negatives``: per row, ``num_candidates`` uniform candidate
  items; the first that is not in the user's history is the negative, and
  if all are (rare at real densities), the last. The accepted negatives
  are uniform over the items outside the history, as the reference's
  rejection loop draws them (dataload.py:74-84); the two packages draw
  different streams, so they agree in distribution only.

The last batch is padded to a full one as the JAX package pads it
(``pack_batches``): real rows weigh 1, and pad rows repeat row 0 of the
unshuffled table with weight 0. A short batch would not give the same
results, because not every loss is a weighted mean over its rows:

- DCCF's in-batch InfoNCE (``models/dccf.py:_pair_cl``) puts every batch
  row, pad rows included, into each logsumexp;
- DGCF's ``distance_correlation`` over [u; pos] takes no weights;
- FREEDOM's ``table_rows`` puts the pad rows' items into the row-sparse
  Adam's row set, so those rows move by their decayed moments.
"""

from __future__ import annotations

from typing import List

import torch

from chaorec_tpu_torch.models.base import Batch

# Up to this history width the (B, K, H) broadcast compare is used; above
# it, a binary search per candidate. Both give the same booleans.
_BCAST_MAX_H = 4096


def pack_batches(perm: torch.Tensor, rows: torch.Tensor, batch_size: int) -> List[Batch]:
    """``rows[perm]`` cut into full batches of ``batch_size``, as
    ``chaorec_tpu/data/sampling.py:make_epoch_batches`` packs them: the last
    batch is padded by repeating ``rows[0]`` with weight 0, every real row
    has weight 1, and ``index`` is the batch's position. ``rows`` is (N, 2)
    [user, item] edges, giving ``users`` and ``pos_items``, or (N,) user ids."""
    n = perm.shape[0]
    n_batches = -(-n // batch_size)
    pad = perm.new_zeros(n_batches * batch_size - n)
    picked = rows[torch.cat([perm, pad])].split(batch_size)
    weights = (torch.arange(n_batches * batch_size, device=perm.device) < n).float()
    if rows.dim() == 1:
        return [Batch(users, w, index=b)
                for b, (users, w) in enumerate(zip(picked, weights.split(batch_size)))]
    return [Batch(e[:, 0], w, pos_items=e[:, 1], index=b)
            for b, (e, w) in enumerate(zip(picked, weights.split(batch_size)))]


def make_epoch_batches(generator: torch.Generator, num_users: int,
                       batch_size: int) -> List[Batch]:
    """A permutation of ``range(num_users)`` packed into full batches of
    ``batch_size`` users (``pack_batches``: the last one padded with user 0
    at weight 0), on the generator's device."""
    perm = torch.randperm(num_users, generator=generator, device=generator.device)
    return pack_batches(perm, torch.arange(num_users, device=perm.device), batch_size)


def make_edge_batches(generator: torch.Generator, edges: torch.Tensor,
                      batch_size: int) -> List[Batch]:
    """The rows of ``edges`` (E, 2) [user, item] in a random order, packed
    into full batches of ``batch_size`` (``pack_batches``: the last one
    padded with edge 0 at weight 0); negatives are drawn per step
    (``sample_negatives``), for pad rows as for any row."""
    perm = torch.randperm(edges.shape[0], generator=generator, device=generator.device)
    return pack_batches(perm, edges, batch_size)


def _in_sorted(history_rows: torch.Tensor, candidates: torch.Tensor) -> torch.Tensor:
    """(B, K) bool: whether each candidate is in its row of ``history_rows``
    (B, H), sorted ascending and padded with a sentinel above every item."""
    if history_rows.shape[1] <= _BCAST_MAX_H:
        return (candidates[:, :, None] == history_rows[:, None, :]).any(dim=2)
    idx = torch.searchsorted(history_rows, candidates.to(history_rows.dtype))
    idx = idx.clamp(max=history_rows.shape[1] - 1)
    return torch.gather(history_rows, 1, idx) == candidates


def sample_negatives(generator: torch.Generator, users: torch.Tensor,
                     history_values: torch.Tensor, num_item: int,
                     num_candidates: int = 8) -> torch.Tensor:
    """One negative item per row of ``users`` (B,), uniform over the items
    outside that user's history; ``history_values`` (U, H) is the sorted,
    padded history table. Returns (B,) 0-based item ids."""
    cand = torch.randint(0, num_item, (users.shape[0], num_candidates), generator=generator,
                         device=users.device, dtype=history_values.dtype)
    valid = ~_in_sorted(history_values[users], cand)
    first = torch.argmax(valid.to(torch.uint8), dim=1)  # the first valid candidate
    pick = torch.where(valid.any(dim=1), first, num_candidates - 1)
    return torch.gather(cand, 1, pick[:, None])[:, 0].to(torch.int64)
