"""Dataset loading: npy assets -> padded numpy arrays.

Counterpart of ``chaorec_tpu/data/loading.py``. The arrays are identical to
the JAX loader's, so one dataset means the same thing to both packages:

- item ids in ``train.npy``/``val.npy``/``test.npy``/``user_item_dict.npy``
  are globally offset (items occupy ``[num_user, num_user + num_item)``);
  they become 0-based once, here, and serving adds the offset back;
- ``num_user``/``num_item`` come from the reference's per-dataset table
  (``DATASET_STATS``), else from ``stats.json``, else from the data;
- the per-user history is sorted and padded with ``num_item`` (a sentinel
  that sorts after every real item); eval positives are padded with -1.

The data stays in numpy on the host; callers move what they need to the
device. ``_pad_ragged`` is the numpy path of the JAX package's C++
``native.pad_ragged``; the C++ host runtime comes to the port later.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# Widths and seeds of the synthetic modality features (image, text).
V_FEAT_DIM, V_FEAT_SEED = 4096, 1234
T_FEAT_DIM, T_FEAT_SEED = 384, 5678

# The reference's hard-coded dataset statistics: (num_user, num_item).
DATASET_STATS: Dict[str, Tuple[int, int]] = {
    "netfilx": (14971, 7444),
    "clothing": (18072, 11384),
    "baby": (12351, 4794),
    "sports": (28940, 15207),
    "beauty": (15482, 8643),
    "electronics": (150179, 51901),
    "microlens": (46420, 14079),
}


@dataclass
class PaddedLists:
    """A ragged list-of-lists as (values, lengths) padded int32 arrays."""

    values: np.ndarray  # (N, P) int32, padded with `fill`
    lengths: np.ndarray  # (N,) int32
    fill: int

    @property
    def max_len(self) -> int:
        return self.values.shape[1]


def _pad_ragged(indptr: np.ndarray, values: np.ndarray, width: int, fill: int,
                sort_rows: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """CSR -> (N, width) padded int32 + (N,) lengths; truncates long rows,
    then sorts each row when ``sort_rows``."""
    indptr = np.asarray(indptr, np.int64)
    values = np.asarray(values, np.int32)
    n = indptr.shape[0] - 1
    lens = np.minimum(np.diff(indptr), width)
    rows = np.repeat(np.arange(n), lens)
    cols = np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens, lens)
    vals = values[indptr[:-1][rows] + cols]
    if sort_rows:
        vals = vals[np.lexsort((vals, rows))]
    out = np.full((n, width), fill, np.int32)
    out[rows, cols] = vals
    return out, lens.astype(np.int32)


def _pad_lists(lists, fill: int, sort: bool = False, min_width: int = 1) -> PaddedLists:
    n = len(lists)
    row_lens = np.fromiter((len(x) for x in lists), np.int64, n)
    width = max(min_width, int(row_lens.max()) if n else 0)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(row_lens, out=indptr[1:])
    flat = np.fromiter(
        (int(v) for row in lists for v in row), np.int32, int(indptr[-1])
    )
    out, lens = _pad_ragged(indptr, flat, width, fill, sort_rows=sort)
    return PaddedLists(out, lens, fill)


@dataclass
class RecDataset:
    """A loaded dataset. All item ids are 0-based (offset removed)."""

    name: str
    num_user: int
    num_item: int
    # Train edges (E, 2): [:, 0] = user id, [:, 1] = 0-based item id.
    train_edges: np.ndarray
    # Per-user train history, sorted, padded with num_item.
    history: PaddedLists
    # Validation / test ground truth: per-user positive items (0-based),
    # padded with -1, in val.npy/test.npy row order.
    val_users: np.ndarray
    val_pos: PaddedLists
    test_users: np.ndarray
    test_pos: PaddedLists
    v_feat: Optional[np.ndarray] = None
    t_feat: Optional[np.ndarray] = None

    @property
    def num_edges(self) -> int:
        return int(self.train_edges.shape[0])

    def user_item_dict(self) -> Dict[int, list]:
        """Reference-format dict (global item ids)."""
        d = {}
        for u in range(self.num_user):
            n = int(self.history.lengths[u])
            d[u] = (self.history.values[u, :n] + self.num_user).tolist()
        return d


def _load_eval_split(path: Path, num_user: int) -> Tuple[np.ndarray, PaddedLists]:
    """val.npy/test.npy: object array of [user, pos_item, ...] rows."""
    raw = np.load(path, allow_pickle=True)
    users = np.array([int(r[0]) for r in raw], dtype=np.int32)
    pos = [[int(x) - num_user for x in r[1:]] for r in raw]
    return users, _pad_lists(pos, fill=-1)


def data_load(
    dataset: str,
    data_root: str = "Data",
    has_v: bool = False,
    has_t: bool = False,
    synthetic_features: bool = True,
) -> RecDataset:
    """Load ``{data_root}/{dataset}/`` into padded arrays.

    ``user_item_dict.npy`` is used for the history when present, and
    rebuilt from ``train.npy`` (from which it derives) when absent."""
    dir_ = Path(data_root) / dataset
    train = np.load(dir_ / "train.npy", allow_pickle=True).astype(np.int64)

    if dataset in DATASET_STATS:
        num_user, num_item = DATASET_STATS[dataset]
    else:
        stats_file = dir_ / "stats.json"
        if stats_file.exists():
            stats = json.loads(stats_file.read_text())
            num_user, num_item = int(stats["num_user"]), int(stats["num_item"])
        else:  # infer: users in [0, U), items in [U, U+I)
            num_user = int(train[:, 0].max()) + 1
            num_item = int(train[:, 1].max()) + 1 - num_user

    edges = np.stack(
        [train[:, 0].astype(np.int32), (train[:, 1] - num_user).astype(np.int32)],
        axis=1,
    )

    dict_file = dir_ / "user_item_dict.npy"
    if dict_file.exists():
        ui = np.load(dict_file, allow_pickle=True).item()
        hist_lists = [
            [int(x) - num_user for x in ui.get(u, [])] for u in range(num_user)
        ]
    else:
        hist_lists = [[] for _ in range(num_user)]
        for u, i in edges:
            hist_lists[int(u)].append(int(i))
    history = _pad_lists(hist_lists, fill=num_item, sort=True)

    val_users, val_pos = _load_eval_split(dir_ / "val.npy", num_user)
    test_users, test_pos = _load_eval_split(dir_ / "test.npy", num_user)

    def _feat(fname: str, enabled: bool, dim: int, seed: int) -> Optional[np.ndarray]:
        p = dir_ / fname
        if not enabled:
            return None
        if p.exists():
            return np.load(p, allow_pickle=True).astype(np.float32)
        if not synthetic_features:
            return None
        logging.warning(
            "%s/%s missing - generating deterministic synthetic features "
            "(%d-dim interaction-projection stand-ins)", dataset, fname, dim
        )
        return synthetic_item_features(edges, num_user, num_item, dim, seed)

    return RecDataset(
        name=dataset,
        num_user=num_user,
        num_item=num_item,
        train_edges=edges,
        history=history,
        val_users=val_users,
        val_pos=val_pos,
        test_users=test_users,
        test_pos=test_pos,
        v_feat=_feat("v_feat.npy", has_v, V_FEAT_DIM, V_FEAT_SEED),
        t_feat=_feat("t_feat.npy", has_t, T_FEAT_DIM, T_FEAT_SEED),
    )


def synthetic_item_features(edges: np.ndarray, num_user: int, num_item: int, dim: int,
                            seed: int, edge_chunk: int = 65536) -> np.ndarray:
    """(num_item, dim) float32 stand-ins for a modality feature table that
    a dataset does not ship: each item is the sum of a random projection
    of the users who interacted with it, plus noise, so feature similarity
    follows co-interaction. Deterministic in ``seed``; not a parity target
    for paper numbers. The edges are added in order, ``edge_chunk`` at a
    time, so at most (edge_chunk, dim) gathered rows exist at once, by
    torch's CPU ``index_add_``: it adds an item's rows one after another in
    edge order, the bits of the JAX loader's ``np.add.at`` at under half its
    host time (tests/test_torch_catalog_scale.py)."""
    rs = np.random.default_rng(seed)
    proj = torch.from_numpy(rs.standard_normal((num_user, dim)).astype(np.float32))
    feats = torch.zeros((num_item, dim), dtype=torch.float32)
    e = torch.from_numpy(np.ascontiguousarray(edges[:, :2], dtype=np.int64))
    for s in range(0, e.shape[0], edge_chunk):
        feats.index_add_(0, e[s:s + edge_chunk, 1], proj[e[s:s + edge_chunk, 0]])
    feats = feats.numpy()
    feats += 0.1 * rs.standard_normal((num_item, dim)).astype(np.float32)
    return feats


def dense_interactions(ds: RecDataset, dtype=np.float32) -> np.ndarray:
    """Dense (num_user, num_item) 0/1 interaction matrix, for the VAE and
    diffusion families."""
    m = np.zeros((ds.num_user, ds.num_item), dtype=dtype)
    m[ds.train_edges[:, 0], ds.train_edges[:, 1]] = 1.0
    return m
