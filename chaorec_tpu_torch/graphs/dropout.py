"""Edge pruning with renormalization, as a dense R.

Counterpart of ``chaorec_tpu/graphs/dropout.py:masked_dense_r``: given a
0/1 keep mask over the edge list, the degrees are counted again over the
kept edges (the reference's post-dropout renormalization,
Model/FREEDOM.py:143-162) and the kept edges' weights
``(d_u + eps)^-1/2 (d_i + eps)^-1/2`` are scatter-added into a dense (U, I)
float32 R. The mask zeroes weights and never drops entries, as in the JAX
package.
"""

from __future__ import annotations

import torch


def masked_dense_r(edge_u: torch.Tensor, edge_i: torch.Tensor, keep: torch.Tensor,
                   num_user: int, num_item: int, eps: float = 1e-7) -> torch.Tensor:
    """(U, I) float32 R over the edges with ``keep`` 1, on their device."""
    keep = keep.to(torch.float32)
    du = torch.zeros(num_user, dtype=torch.float32, device=keep.device).index_add_(0, edge_u, keep)
    di = torch.zeros(num_item, dtype=torch.float32, device=keep.device).index_add_(0, edge_i, keep)
    w = keep * torch.rsqrt((du[edge_u] + eps) * (di[edge_i] + eps))
    dense = torch.zeros((num_user, num_item), dtype=torch.float32, device=keep.device)
    return dense.index_put_((edge_u, edge_i), w, accumulate=True)
