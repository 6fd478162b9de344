"""kNN similarity graphs over item (or user) features.

Counterpart of ``chaorec_tpu/graphs/knn.py``: cosine similarity of the
L2-normalized features, the top-k neighbours of each row (``torch.topk``,
in row chunks of 4096 so at most a (4096, N) block of similarities exists
at once), and a fixed-degree graph of neighbour indices (N, k) and weights
(N, k). Weights by ``norm``:

- "ref_laplacian": the reference's laplacian over the kNN graph uses the
  row sum at both ends (Model/FREEDOM.py:122-129), and every row sums to
  k, so every weight is exactly 1/k;
- "sym": the true symmetric laplacian, k^-1/2 times the neighbour's
  in-degree^-1/2;
- "row_softmax_values": the similarities normalized by their row sum
  (LATTICE).

The host kNN primitives of ``chaorec_tpu/ops/ell.py`` that MGCN, SMORE and
GUME build their item graphs with: ``knn_topk`` (``knn_topk_ell_host``:
the rows normalized by max(norm, 1e-12), not norm + 1e-12),
``topk_sym_norm`` (``topk_sym_norm_host``: D^-1/2 S D^-1/2 with D the row
sums of the similarity values, not the neighbour counts of "sym") and
``union_max`` (``ell_union_max``: SMORE's fusion graph, built once on the
host with scipy). ``ell_rows_matvec`` is ``gather_weighted_sum``.

One propagation step is a gather and a weighted sum over the k axis;
autograd of the gather is its backward (the JAX package's custom VJP exists
for the TPU's scatter speed).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


def gather_weighted_sum(x: torch.Tensor, weights: torch.Tensor,
                        indices: torch.Tensor) -> torch.Tensor:
    """out[n] = sum_j weights[n, j] * x[indices[n, j]]."""
    return torch.einsum("nk,nkd->nd", weights, x[indices])


@dataclass(frozen=True)
class ELLGraph:
    """Fixed-degree graph: each row's k neighbours and their weights."""

    indices: torch.Tensor  # (N, k) int64
    weights: torch.Tensor  # (N, k) float32

    @property
    def k(self) -> int:
        return int(self.indices.shape[1])

    def propagate(self, x: torch.Tensor) -> torch.Tensor:
        return gather_weighted_sum(x, self.weights, self.indices)


def _topk_rows(feats: torch.Tensor, k: int, row_chunk: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vals, idx) (N, k): the k largest entries of each row of feats
    feats^T, in row chunks."""
    vals, idx = [], []
    for start in range(0, feats.shape[0], row_chunk):
        v, i = torch.topk(feats[start:start + row_chunk] @ feats.T, k, dim=1)
        vals.append(v)
        idx.append(i)
    return torch.cat(vals), torch.cat(idx)


def build_knn_graph(features: torch.Tensor, topk: int = 10, norm: str = "sym",
                    row_chunk: int = 4096) -> ELLGraph:
    """The kNN graph of the rows of ``features`` (N, F), on its device."""
    if norm not in ("ref_laplacian", "sym", "row_softmax_values"):
        raise ValueError(f"unknown norm {norm!r}")
    feats = features / (torch.linalg.vector_norm(features, dim=1, keepdim=True) + 1e-12)
    n = feats.shape[0]
    vals, idx = _topk_rows(feats, topk, row_chunk)
    if norm == "ref_laplacian":
        w = torch.full(idx.shape, 1.0 / topk, dtype=torch.float32, device=idx.device)
    elif norm == "sym":
        col_deg = torch.zeros(n, dtype=torch.float32, device=idx.device)
        col_deg.index_add_(0, idx.reshape(-1), torch.ones(idx.numel(), device=idx.device))
        w = (float(topk) ** -0.5) * torch.clamp(col_deg, min=1.0)[idx] ** -0.5
    else:
        w = vals / (torch.sum(vals, dim=1, keepdim=True) + 1e-12)
    return ELLGraph(idx, w.to(torch.float32))


def mixed_knn_graph(v_feat: torch.Tensor, t_feat: torch.Tensor, k: int,
                    image_weight: float) -> ELLGraph:
    """The visual and the textual kNN graphs ("ref_laplacian": weights 1/k)
    side by side, weighted ``image_weight`` and 1 - ``image_weight``: MENTOR's
    and DDRec's multimodal item graph, one propagation a gather of 2k rows."""
    gv = build_knn_graph(v_feat, k, norm="ref_laplacian")
    gt = build_knn_graph(t_feat, k, norm="ref_laplacian")
    return ELLGraph(torch.cat([gv.indices, gt.indices], 1),
                    torch.cat([image_weight * gv.weights, (1 - image_weight) * gt.weights], 1))


def knn_topk(features: torch.Tensor, k: int, row_chunk: int = 4096
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vals (N, k) float32, idx (N, k)): the cosine similarities of each
    row's k nearest rows and their indices, on the features' device, the
    rows normalized by max(norm, 1e-12) (``knn_topk_ell_host``)."""
    feats = features / torch.clamp(torch.linalg.vector_norm(features, dim=1, keepdim=True),
                                   min=1e-12)
    return _topk_rows(feats.to(torch.float32), k, row_chunk)


def topk_sym_norm(vals: torch.Tensor, idx: torch.Tensor) -> ELLGraph:
    """The top-k graph's similarity values, D^-1/2 S D^-1/2 normalized with
    d = max(rowsum(vals), 1e-7)^-1/2: weight vals[n, j] d[n] d[idx[n, j]]
    (``topk_sym_norm_host``)."""
    d = torch.clamp(vals.sum(1), min=1e-7) ** -0.5
    return ELLGraph(idx, (vals * d[:, None] * d[idx]).to(torch.float32))


def union_max(a: ELLGraph, b: ELLGraph) -> ELLGraph:
    """The elementwise maximum of two graphs over N rows on the union of
    their patterns (``ell_union_max``, SMORE's fusion graph), as scipy's
    ``csr_matrix.maximum`` takes it: an entry in one graph only becomes
    max(v, 0), so a negative one drops out. Built on the host; each row is
    padded to the longest row with weight 0 at index 0."""
    import scipy.sparse as sp

    n = a.indices.shape[0]

    def csr(g: ELLGraph):
        rows = np.repeat(np.arange(n), g.k)
        return sp.csr_matrix((g.weights.cpu().numpy().astype(np.float64).ravel(),
                              (rows, g.indices.cpu().numpy().ravel())), shape=(n, n))

    m = csr(a).maximum(csr(b)).tocoo()
    order = np.argsort(m.row, kind="stable")
    row, col, val = m.row[order], m.col[order], m.data[order].astype(np.float32)
    deg = np.bincount(row, minlength=n)
    width = max(int(deg.max(initial=0)), 1)
    rank = np.arange(row.shape[0]) - (np.cumsum(deg) - deg)[row]
    idx = np.zeros((n, width), np.int64)
    w = np.zeros((n, width), np.float32)
    idx[row, rank], w[row, rank] = col, val
    dev = a.indices.device
    return ELLGraph(torch.from_numpy(idx).to(dev), torch.from_numpy(w).to(dev))
