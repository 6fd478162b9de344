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

The JAX package pads the last batch to a full one with weight-0 rows so
that every batch has one static shape. Here the last batch is short
instead: every loss is a weighted mean over its rows, so a short batch of
weight-1 rows gives the same loss as the padded one.
"""

from __future__ import annotations

from typing import List

import torch

from chaorec_tpu_torch.models.base import Batch

# Up to this history width the (B, K, H) broadcast compare is used; above
# it, a binary search per candidate. Both give the same booleans.
_BCAST_MAX_H = 4096


def make_epoch_batches(generator: torch.Generator, num_users: int,
                       batch_size: int) -> List[Batch]:
    """A permutation of ``range(num_users)`` cut into batches of
    ``batch_size`` users (the last one shorter when it does not divide),
    each with weight 1 per row, on the generator's device."""
    perm = torch.randperm(num_users, generator=generator, device=generator.device)
    return [Batch(users, torch.ones(users.shape[0], device=users.device))
            for users in perm.split(batch_size)]


def make_edge_batches(generator: torch.Generator, edges: torch.Tensor,
                      batch_size: int) -> List[Batch]:
    """The rows of ``edges`` (E, 2) [user, item] in a random order, cut
    into batches of ``batch_size`` (the last one shorter), with weight 1
    per row and ``index`` the batch's position; negatives are drawn per
    step (``sample_negatives``)."""
    perm = torch.randperm(edges.shape[0], generator=generator, device=generator.device)
    return [Batch(edges[idx, 0], torch.ones(idx.shape[0], device=idx.device),
                  pos_items=edges[idx, 1], index=b)
            for b, idx in enumerate(perm.split(batch_size))]


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
