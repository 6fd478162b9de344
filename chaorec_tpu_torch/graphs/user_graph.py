"""The user-user co-interaction graph (DualGNN, DRAGON, COHESION).

Counterpart of ``chaorec_tpu/graphs/user_graph.py`` and of the numpy path
of ``chaorec_tpu/native/__init__.py:uu_topk``. Two users' co-interaction
count is an entry of ``B B^T`` for the binary interaction matrix B, so
``build_user_cooccurrence`` keeps, for each user, the ``topk`` other users
with the largest counts (dualgnn-gen-u-u-matrix.py:20-107), and
``topk_sample`` draws each epoch's fixed-shape (U, k) neighbours and their
softmax(count) weights (utils.py:154-178, Model/DualGNN.py:319-358);
``draw_user_graph`` puts one draw on the models' device.

Counts are small integers, so a user's row is full of ties, and the tie
order decides which neighbours a model aggregates: both paths order each
row by (-count, user id), as ``jax.lax.top_k`` and the native path's
``np.lexsort((cand, -score))`` do. ``torch.topk`` gives no such order, so
the dense path sorts stably instead.

- Dense path (U * I at most ``dense_threshold``): B on ``device`` (bf16 on
  the card, whose products of 0/1 values sum exactly in float32; float32
  on the CPU), ``B B^T`` a row chunk at a time, the self entry set below
  every count, then a stable descending sort.
- Sparse path (above it): the count matrix's product with its transpose
  in scipy, a user chunk at a time, then the same order per row; a
  duplicate edge counts each time, as in the native path's loops.

The JAX package's C++ ``ch_uu_topk`` is a host speed-up of the sparse path
and is not ported.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def build_user_cooccurrence(
    edges: np.ndarray,
    num_user: int,
    num_item: int,
    topk: int = 200,
    row_chunk: int = 4096,
    dense_threshold: int = 1_500_000_000,
    device: torch.device | str = "cpu",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(indices (U, topk') int32, counts (U, topk') float32, lengths (U,)
    int32), ``topk' = min(topk, U - 1)``: each user's other users by
    (-count, id), the first ``topk'`` of them; ``lengths`` counts those
    with a count above 0, and indices and counts past it are 0."""
    edges = np.asarray(edges)
    if num_user * num_item > dense_threshold:
        return _build_user_cooccurrence_sparse(edges, num_user, topk, row_chunk)
    topk = min(topk, num_user - 1)
    device = torch.device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    b = torch.zeros((num_user, num_item), dtype=dtype, device=device)
    e = torch.from_numpy(np.ascontiguousarray(edges[:, :2], np.int64)).to(device)
    b[e[:, 0], e[:, 1]] = 1.0
    idx_out = np.zeros((num_user, topk), np.int32)
    cnt_out = np.zeros((num_user, topk), np.float32)
    for start in range(0, num_user, row_chunk):
        end = min(start + row_chunk, num_user)
        if device.type == "cuda":
            counts = torch.mm(b[start:end], b.t(), out_dtype=torch.float32)
        else:
            counts = b[start:end] @ b.t()
        rows = torch.arange(end - start, device=device)
        counts[rows, rows + start] = -1.0  # the user itself, after every other user
        vals, idx = torch.sort(counts, dim=1, descending=True, stable=True)
        idx_out[start:end] = idx[:, :topk].cpu().numpy()
        cnt_out[start:end] = vals[:, :topk].cpu().numpy()
        del counts, vals, idx
    return _zero_past_lengths(idx_out, cnt_out)


def _zero_past_lengths(idx: np.ndarray, cnt: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    lengths = (cnt > 0).sum(axis=1).astype(np.int32)
    mask = np.arange(idx.shape[1])[None, :] < lengths[:, None]
    return (np.where(mask, idx, 0).astype(np.int32),
            np.where(mask, cnt, 0.0).astype(np.float32), lengths)


def _build_user_cooccurrence_sparse(edges: np.ndarray, num_user: int, topk: int,
                                    row_chunk: int = 4096
                                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The same contract from the count matrix A (U, I) in scipy: each
    chunk of users' rows of A A^T without the diagonal, each row ordered
    by (-count, id) (the counts are whole numbers)."""
    import scipy.sparse as sp

    num_item = int(edges[:, 1].max()) + 1
    topk = min(topk, num_user - 1)
    a = sp.csr_matrix((np.ones(edges.shape[0], np.float64),
                       (edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64))),
                      shape=(num_user, num_item))
    at = a.T.tocsr()
    ids = np.zeros((num_user, topk), np.int32)
    w = np.zeros((num_user, topk), np.float32)
    for start in range(0, num_user, row_chunk):
        end = min(start + row_chunk, num_user)
        c = a[start:end] @ at
        c.setdiag(0, k=start)  # the user itself
        c.eliminate_zeros()
        n = np.diff(c.indptr)
        row = np.repeat(np.arange(end - start, dtype=np.int64), n)
        count = np.rint(c.data).astype(np.int64)  # sums of ones: whole numbers
        # one int64 key a pair, ordered by row, then (-count, id): sorting the
        # keys is the lexsort; only the kept prefix of each row is decoded
        top = int(count.max(initial=0))
        key = np.sort((row * (top + 1) + (top - count)) * num_user + c.indices)
        kept = np.minimum(n, topk)
        rank = np.arange(int(kept.sum())) - np.repeat(np.cumsum(kept) - kept, kept)
        key = key[np.repeat(c.indptr[:-1], kept) + rank]
        rows = np.repeat(np.arange(start, end), kept)
        ids[rows, rank] = key % num_user
        w[rows, rank] = top - (key // num_user) % (top + 1)
    return _zero_past_lengths(ids, w)


def topk_sample(
    indices: np.ndarray,
    counts: np.ndarray,
    lengths: np.ndarray,
    k: int,
    rs: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-epoch (U, k) neighbour sample + softmax(count) weights: the
    first min(len, k) stored neighbours; a row shorter than k is padded by
    drawing from its own neighbours (``rs.integers``, user by user, as the
    JAX package draws); an empty row gets index 0 and weight 0."""
    num_user = indices.shape[0]
    out_idx = np.zeros((num_user, k), np.int32)
    out_w = np.zeros((num_user, k), np.float32)
    lens = np.minimum(lengths, k)
    for u in range(num_user):
        n = int(lens[u])
        if n == 0:
            continue
        ii = indices[u, :n]
        cc = counts[u, :n]
        if n < k:
            extra = rs.integers(0, n, size=k - n)
            ii = np.concatenate([ii, ii[extra]])
            cc = np.concatenate([cc, cc[extra]])
        out_idx[u] = ii[:k]
        e = np.exp(cc[:k] - cc[:k].max())
        out_w[u] = e / e.sum()
    return out_idx, out_w


def draw_user_graph(uu: Tuple[np.ndarray, np.ndarray, np.ndarray], k: int, seed: int,
                    device: torch.device | str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices (U, k) int64, weights (U, k) float32) on ``device``: the
    ``topk_sample`` of the co-occurrence graph ``uu`` with
    ``np.random.default_rng(seed)``, the JAX package's draw."""
    idx, w = topk_sample(*uu, k, np.random.default_rng(seed))
    return torch.from_numpy(idx).to(device, torch.int64), torch.from_numpy(w).to(device)
