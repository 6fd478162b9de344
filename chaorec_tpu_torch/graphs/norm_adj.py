"""The symmetric-normalized user-item graph.

Counterpart of ``chaorec_tpu/graphs/norm_adj.py`` and of the numpy paths of
the graph builders in ``chaorec_tpu/native`` (``build_adj``,
``fill_dense``). The graph is bipartite, so ``A = [[0, R], [R^T, 0]]``
with ``R[u, i] = (d_u + eps)^-1/2 (d_i + eps)^-1/2`` is never built whole:
one propagation step is ``new_user = R @ item_emb`` and ``new_item = R^T @
user_emb``. Two paths behind one interface:

- dense: R as a (U, I) tensor in ``compute_dtype`` (bf16 by default, with
  bf16 products summed in float32, ``ops/mxu.bdot``), used while U * I is
  at most ``dense_threshold``;
- segment: the edge list sorted by user and by item, gathered and summed
  with ``index_add_``. At ``compute_dtype`` "bfloat16" the gathered input
  is rounded to bf16 first (``round_bf16``: float32 weights times bf16
  values, summed in float32, as the JAX package's ELL path casts its input
  before the gather-sum); the input's gradient is not rounded.

The JAX package's ELL layout is a TPU gather layout and is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from chaorec_tpu_torch.ops.mxu import bdot

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _RoundBf16(torch.autograd.Function):
    """x rounded to bf16 (kept in float32) forward, the identity backward."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 in its own dtype; its gradient passes unrounded
    (the JAX package's cast before a gather-sum whose VJP returns the
    float32 cotangent)."""
    return _RoundBf16.apply(x)


def build_adj(edges: np.ndarray, num_user: int, num_item: int, eps: float = 1e-7
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(du, di, w, order_u, order_i) of (E, 2) [user, item] edges: float32
    degrees, each edge's weight (du + eps)^-1/2 (di + eps)^-1/2 in float32,
    and the stable orders of the edges by user and by item."""
    edges = np.ascontiguousarray(edges, dtype=np.int32)
    du = np.bincount(edges[:, 0], minlength=num_user).astype(np.float32)
    di = np.bincount(edges[:, 1], minlength=num_item).astype(np.float32)
    w = (1.0 / np.sqrt((du[edges[:, 0]] + np.float32(eps))
                       * (di[edges[:, 1]] + np.float32(eps)))).astype(np.float32)
    order_u = np.argsort(edges[:, 0], kind="stable").astype(np.int32)
    order_i = np.argsort(edges[:, 1], kind="stable").astype(np.int32)
    return du, di, w, order_u, order_i


def fill_dense(edges: np.ndarray, w: np.ndarray, num_user: int, num_item: int) -> np.ndarray:
    """Dense (U, I) float32 scatter-add of the edge weights (duplicate
    edges add)."""
    r = np.zeros((num_user, num_item), dtype=np.float32)
    np.add.at(r, (edges[:, 0], edges[:, 1]), w)
    return r


@dataclass(frozen=True)
class BipartiteGraph:
    """The normalized user-item graph on one device."""

    num_user: int
    num_item: int
    use_dense: bool
    compute_dtype: str  # "float32" or "bfloat16": the dense R's dtype, the segment path's inputs
    u_by_u: torch.Tensor  # (E,) user ids, ascending
    i_by_u: torch.Tensor  # (E,) item ids aligned with u_by_u
    w_by_u: torch.Tensor  # (E,) float32 edge weights aligned with u_by_u
    u_by_i: torch.Tensor
    i_by_i: torch.Tensor  # ascending
    w_by_i: torch.Tensor
    dense_r: Optional[torch.Tensor]  # (U, I) normalized R, or None

    @property
    def num_edges(self) -> int:
        return int(self.u_by_u.shape[0])

    def propagate(self, user_emb: torch.Tensor, item_emb: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One symmetric-normalized step: (R @ item_emb, R^T @ user_emb),
        in float32 (Model/LightGCN.py:28-43)."""
        return self.apply_r(item_emb), self.apply_rt(user_emb)

    def apply_r(self, item_x: torch.Tensor) -> torch.Tensor:
        """R @ item_x -> (U, D), one user-side aggregation."""
        if self.use_dense:
            return bdot(self.dense_r, item_x.to(self.dense_r.dtype))
        out = item_x.new_zeros((self.num_user, item_x.shape[1]), dtype=torch.float32)
        msgs = self.w_by_u[:, None] * self._cast(item_x)[self.i_by_u]
        return out.index_add_(0, self.u_by_u, msgs)

    def apply_rt(self, user_x: torch.Tensor) -> torch.Tensor:
        """R^T @ user_x -> (I, D), one item-side aggregation."""
        if self.use_dense:
            return bdot(self.dense_r.t(), user_x.to(self.dense_r.dtype))
        out = user_x.new_zeros((self.num_item, user_x.shape[1]), dtype=torch.float32)
        msgs = self.w_by_i[:, None] * self._cast(user_x)[self.u_by_i]
        return out.index_add_(0, self.i_by_i, msgs)

    def _cast(self, x: torch.Tensor) -> torch.Tensor:
        """The segment path's input: rounded to bf16 at "bfloat16"."""
        return round_bf16(x) if self.compute_dtype == "bfloat16" else x


def build_norm_adj(edges: np.ndarray, num_user: int, num_item: int,
                   device: torch.device | str, use_dense: Optional[bool] = None,
                   dense_threshold: int = 600_000_000, compute_dtype: str = "float32",
                   eps: float = 1e-7) -> BipartiteGraph:
    """The graph of the train edges (E, 2) [user, item], on ``device``:
    dense when ``use_dense`` says so, or when it is None and U * I is at
    most ``dense_threshold``."""
    edges = np.ascontiguousarray(edges, dtype=np.int32)
    if use_dense is None:
        use_dense = num_user * num_item <= dense_threshold
    _, _, w, order_u, order_i = build_adj(edges, num_user, num_item, eps=eps)

    def on_device(a: np.ndarray, dtype=torch.int64) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    dense_r = None
    if use_dense:
        dense_r = on_device(fill_dense(edges, w, num_user, num_item),
                            COMPUTE_DTYPES[compute_dtype])
    return BipartiteGraph(
        num_user=num_user, num_item=num_item, use_dense=use_dense,
        compute_dtype=compute_dtype,
        u_by_u=on_device(edges[order_u, 0]), i_by_u=on_device(edges[order_u, 1]),
        w_by_u=on_device(w[order_u], torch.float32),
        u_by_i=on_device(edges[order_i, 0]), i_by_i=on_device(edges[order_i, 1]),
        w_by_i=on_device(w[order_i], torch.float32),
        dense_r=dense_r,
    )
