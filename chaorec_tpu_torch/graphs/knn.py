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

One propagation step is a gather and a weighted sum over the k axis;
autograd of the gather is its backward (the JAX package's custom VJP exists
for the TPU's scatter speed).
"""

from __future__ import annotations

from dataclasses import dataclass

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


def build_knn_graph(features: torch.Tensor, topk: int = 10, norm: str = "sym",
                    row_chunk: int = 4096) -> ELLGraph:
    """The kNN graph of the rows of ``features`` (N, F), on its device."""
    if norm not in ("ref_laplacian", "sym", "row_softmax_values"):
        raise ValueError(f"unknown norm {norm!r}")
    feats = features / (torch.linalg.vector_norm(features, dim=1, keepdim=True) + 1e-12)
    n = feats.shape[0]
    vals, idx = [], []
    for start in range(0, n, row_chunk):
        v, i = torch.topk(feats[start:start + row_chunk] @ feats.T, topk, dim=1)
        vals.append(v)
        idx.append(i)
    vals, idx = torch.cat(vals), torch.cat(idx)
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
