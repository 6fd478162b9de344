"""Homograph (U-U / I-I one-hot neighbourhood) rows.

Counterpart of ``chaorec_tpu/data/homograph.py`` (reference:
``dataload.py:267-344``, ``UserHomographData`` / ``ItemHomographData``). The
reference builds a dense (N, N) float32 matrix on the host from the (node,
neighbour) pairs of a kNN table and serves one row per ``__getitem__``; its
only consumer is a commented-out MHRec dispatch (``main.py:421-424``), and
no model of the port reads these rows either.

Only the requested batch of rows is made, on the neighbour table's device:
``row[b, j]`` counts the times ``j`` appears among the neighbours of node
``index[b]``, so duplicate neighbours (replacement-padded sampling,
``utils.py:154-178``) sum, as duplicate COO entries do in the reference's
``toarray()``.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

__all__ = ["homograph_rows", "homograph_batches"]


def homograph_rows(neighbors: torch.Tensor, index: torch.Tensor, num_nodes: int,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, num_nodes) rows of neighbour counts for the node ids ``index``
    (B,), from the (N, k) neighbour table ``neighbors``."""
    nbr = neighbors[index].to(torch.int64)  # (B, k)
    b = index.shape[0]
    flat = (torch.arange(b, device=nbr.device)[:, None] * num_nodes + nbr).reshape(-1)
    rows = torch.zeros(b * num_nodes, dtype=dtype, device=nbr.device)
    rows.index_add_(0, flat, torch.ones(flat.shape[0], dtype=dtype, device=nbr.device))
    return rows.view(b, num_nodes)


def homograph_batches(neighbors, batch_size: int, dtype: torch.dtype = torch.float32
                      ) -> Iterator[Tuple[torch.Tensor, torch.Tensor, int]]:
    """``(rows (B, N), index (B,), valid)`` over all N nodes in order, as the
    reference's ``DataLoader(HomographData)`` iterates; the last batch is
    filled to ``batch_size`` by repeating node N-1, and only its first
    ``valid`` rows are real."""
    if not isinstance(neighbors, torch.Tensor):
        neighbors = torch.from_numpy(np.asarray(neighbors))
    n = int(neighbors.shape[0])
    for start in range(0, n, batch_size):
        idx = torch.clamp(torch.arange(start, start + batch_size, device=neighbors.device),
                          max=n - 1)
        yield homograph_rows(neighbors, idx, n, dtype), idx, min(batch_size, n - start)
