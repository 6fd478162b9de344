"""Epoch batches of shuffled users, for "user_rows" models.

Counterpart of ``chaorec_tpu/data/sampling.py:make_epoch_batches`` as the
JAX trainer uses it for user-row models (``train/loop.py``), where the
edges are one (user, 0) pair per user: every user appears exactly once per
epoch, in an order drawn from a ``torch.Generator``.

The JAX package pads the last batch to a full one with weight-0 rows so
that every batch has one static shape. Here the last batch is short
instead: every loss is a weighted mean over its rows, so a short batch of
weight-1 rows gives the same loss as the padded one, and the port has no
compiled shape to keep. ``sample_negatives`` comes with the BPR models.
"""

from __future__ import annotations

from typing import List

import torch

from chaorec_tpu_torch.models.base import Batch


def make_epoch_batches(generator: torch.Generator, num_users: int,
                       batch_size: int) -> List[Batch]:
    """A permutation of ``range(num_users)`` cut into batches of
    ``batch_size`` users (the last one shorter when it does not divide),
    each with weight 1 per row, on the generator's device."""
    perm = torch.randperm(num_users, generator=generator, device=generator.device)
    return [Batch(users, torch.ones(users.shape[0], device=users.device))
            for users in perm.split(batch_size)]
