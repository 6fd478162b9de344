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
- segment: the edge list sorted by user and by item, and four CSRs built
  from it (``segment_csrs``), each grouping the edges by the rows one sum
  writes: apply_r's and apply_rt's, and each one's input gradient. A sum
  is ``ops/csr_spmm.csr_apply`` over them: on the card the CSR gather-sum
  kernel, on the CPU its plain version (the gather, the product and
  ``index_add_``). Each CSR keeps a row's edges in the order the
  deterministic ``index_add_`` of the messages and the gather's backward
  add them, so the sums are that scatter's bits. At ``compute_dtype``
  "bfloat16" the input is read rounded to bf16 (float32 weights times
  bf16 values, summed in float32, as the JAX package's ELL path casts its
  input before the gather-sum); the input's gradient is not rounded.

The JAX package's ELL layout is a TPU gather layout and is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from chaorec_tpu_torch.ops.csr_spmm import Csr, csr_apply
from chaorec_tpu_torch.ops.mxu import bdot

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def stable_order(keys: np.ndarray) -> np.ndarray:
    """The stable ascending order of integer ``keys`` (a radix sort: a
    tenth of numpy's stable argsort's time at a million keys)."""
    keys = torch.from_numpy(np.ascontiguousarray(keys, dtype=np.int64))
    return torch.sort(keys, stable=True).indices.numpy()


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
    order_u = stable_order(edges[:, 0]).astype(np.int32)
    order_i = stable_order(edges[:, 1]).astype(np.int32)
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
    # the segment path's CSRs (None on the dense path): apply_r's sum (rows
    # users, the user-sorted edges) and its input's gradient (rows items,
    # the stable sort of i_by_u); apply_rt's (rows items, the item-sorted
    # edges) and its gradient (rows users, the stable sort of u_by_i)
    csr_r: Optional[Csr] = None
    csr_r_grad: Optional[Csr] = None
    csr_rt: Optional[Csr] = None
    csr_rt_grad: Optional[Csr] = None

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
        return csr_apply(item_x, self.csr_r, self.csr_r_grad, self.compute_dtype == "bfloat16")

    def apply_rt(self, user_x: torch.Tensor) -> torch.Tensor:
        """R^T @ user_x -> (I, D), one item-side aggregation."""
        if self.use_dense:
            return bdot(self.dense_r.t(), user_x.to(self.dense_r.dtype))
        return csr_apply(user_x, self.csr_rt, self.csr_rt_grad,
                         self.compute_dtype == "bfloat16")


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

    u_by_u, i_by_u, w_by_u = edges[order_u, 0], edges[order_u, 1], w[order_u]
    u_by_i, i_by_i, w_by_i = edges[order_i, 0], edges[order_i, 1], w[order_i]
    dense_r, csrs = None, {}
    if use_dense:
        dense_r = on_device(fill_dense(edges, w, num_user, num_item),
                            COMPUTE_DTYPES[compute_dtype])
    else:
        csrs = segment_csrs(u_by_u, i_by_u, w_by_u, u_by_i, i_by_i, w_by_i, num_user, num_item,
                            device)
    return BipartiteGraph(
        num_user=num_user, num_item=num_item, use_dense=use_dense,
        compute_dtype=compute_dtype,
        u_by_u=on_device(u_by_u), i_by_u=on_device(i_by_u),
        w_by_u=on_device(w_by_u, torch.float32),
        u_by_i=on_device(u_by_i), i_by_i=on_device(i_by_i),
        w_by_i=on_device(w_by_i, torch.float32),
        dense_r=dense_r, **csrs,
    )


def segment_csrs(u_by_u, i_by_u, w_by_u, u_by_i, i_by_i, w_by_i, num_user: int, num_item: int,
                 device) -> dict:
    """The four CSRs of the segment path. Each keeps a row's edges in the
    order its scatter adds them: the stable sort of the destinations over
    the message array's positions (apply_r's messages are the user-sorted
    edges, apply_rt's the item-sorted ones; a gradient scatters the same
    messages to their sources)."""
    return dict(csr_r=build_csr(u_by_u, i_by_u, w_by_u, num_user, num_item, device),
                csr_r_grad=build_csr(i_by_u, u_by_u, w_by_u, num_item, num_user, device),
                csr_rt=build_csr(i_by_i, u_by_i, w_by_i, num_item, num_user, device),
                csr_rt_grad=build_csr(u_by_i, i_by_i, w_by_i, num_user, num_item, device))


def build_csr(dst: np.ndarray, src: np.ndarray, w: np.ndarray, n_rows: int, n_src: int,
              device) -> Csr:
    """The CSR of the edges (dst[e], src[e], w[e]) on ``device``: each row's
    edges in their order in the input (the order a scatter over the input
    positions adds them), rows by falling degree, ties by row id."""
    dst = np.asarray(dst, dtype=np.int64)
    if dst.shape[0] >= 2 ** 31:
        raise ValueError(f"at most 2^31 - 1 edges, got {dst.shape[0]}")
    deg = np.bincount(dst, minlength=n_rows)
    rows = stable_order(-deg)
    ptr = np.concatenate([[0], np.cumsum(deg[rows])])
    # the edges by row id, then each row's run moved to its slot
    by_row = stable_order(dst)
    first = np.cumsum(deg) - deg
    perm = by_row[np.repeat(first[rows] - ptr[:-1], deg[rows]) + np.arange(dst.shape[0])]

    def on(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    return Csr(n_rows, n_src, on(ptr, np.int32), on(rows, np.int32),
               on(np.asarray(src)[perm], np.int32), on(np.asarray(w)[perm], np.float32))
