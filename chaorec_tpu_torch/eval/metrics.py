"""Top-K quality metrics: P, R, NDCG, HR and MAP on the device.

Counterpart of ``chaorec_tpu/eval/metrics.py``: its ``_metrics_kernel`` as
torch operations on padded ground-truth tensors, then ``gene_metrics`` for
one split and ``gene_metrics_pair`` for validation and test together.

Parity traps kept on purpose, as in the JAX package:
- NDCG uses the **natural log** discount (``np.log``, not log2); IDCG
  truncates at ``min(len(truth), k)``.
- recall, ndcg and map are 0 for users with an empty truth list.
- MAP divides by the truth length, not by ``min(k, len)``.
- The average runs over **all rows of the split**, empty-truth rows
  included.
- Sums are float32 on the device and divided in float64 on the host, after
  **one** device-to-host copy for both splits (``gene_metrics_pair``).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

METRIC_NAMES = ("precision", "recall", "ndcg", "hit_rate", "map")

Metrics = Dict[int, Dict[str, float]]


def metric_sums(ranked: torch.Tensor, pos: torch.Tensor, pos_len: torch.Tensor,
                k_list: Sequence[int]) -> torch.Tensor:
    """(len(k_list), 5) float32 sums over rows (not yet averaged).

    ranked (N, K) global item ids; pos (N, P) global ids padded with -1,
    which never equals an id; pos_len (N,)."""
    kmax = ranked.shape[1]
    hits = torch.any(ranked[:, :, None] == pos[:, None, :], dim=2)  # (N, K)
    hits_f = hits.float()
    positions = torch.arange(kmax, dtype=torch.float32, device=ranked.device)
    inv_log = 1.0 / torch.log(positions + 2.0)  # natural log
    # cum_inv_log[m-1] = IDCG of m truths. Both prefixes are taken where the
    # trainer's deterministic mode allows them (it refuses torch.cumsum of a
    # CUDA float): inv_log's on the host (K values), the hits' in integers.
    cum_inv_log = torch.cumsum(inv_log.cpu(), 0).to(ranked.device)
    cum_hits = torch.cumsum(hits, dim=1).float()
    nonempty = (pos_len > 0).float()
    len_f = torch.clamp(pos_len.float(), min=1.0)
    rows = []
    for k in k_list:
        hk = hits_f[:, :k]
        n_hits = hk.sum(1)
        precision = n_hits / k
        recall = nonempty * n_hits / len_f
        dcg = (hk * inv_log[:k]).sum(1)
        idcg = cum_inv_log[torch.clamp(torch.clamp(pos_len, max=k) - 1, 0, kmax - 1).long()]
        ndcg = nonempty * dcg / torch.clamp(idcg, min=1e-12)
        hit = hits[:, :k].any(1).float()
        ap = (hk * cum_hits[:, :k] / (positions[:k] + 1.0)).sum(1)
        map_k = nonempty * ap / len_f
        rows.append(torch.stack([precision.sum(), recall.sum(), ndcg.sum(), hit.sum(),
                                 map_k.sum()]))
    return torch.stack(rows)


def split_tensors(dataset, split: str, device: torch.device | str
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(users, positives as global ids padded with -1, lengths) of the
    "val" or "test" split, on ``device``."""
    pos = dataset.val_pos if split == "val" else dataset.test_pos
    users = dataset.val_users if split == "val" else dataset.test_users
    pos_global = np.where(pos.values >= 0, pos.values.astype(np.int64) + dataset.num_user, -1)
    return (torch.from_numpy(np.asarray(users, np.int64)).to(device),
            torch.from_numpy(pos_global).to(device),
            torch.from_numpy(np.asarray(pos.lengths, np.int64)).to(device))


def _unpack(summed: np.ndarray, n: int, k_list: Sequence[int]) -> Metrics:
    return {int(k): {name: float(summed[i, j] / n) for j, name in enumerate(METRIC_NAMES)}
            for i, k in enumerate(k_list)}


def gene_metrics(dataset, rank_list: torch.Tensor, k_list: Sequence[int],
                 split: str = "val") -> Metrics:
    """The reference's ``utils.gene_metrics(split_data, rank_list, ks)``;
    ``rank_list`` (num_user, K) holds global item ids."""
    users, pos, lengths = split_tensors(dataset, split, rank_list.device)
    summed = metric_sums(rank_list[users], pos, lengths, k_list).cpu().numpy()
    return _unpack(summed.astype(np.float64), len(users), k_list)


def gene_metrics_pair(rank_list: torch.Tensor, k_list: Sequence[int], val_split,
                      test_split) -> Tuple[Metrics, Metrics]:
    """(val, test) metrics with a single device-to-host copy; each split is
    ``split_tensors``' triple, made once per dataset by the caller."""
    sums = [metric_sums(rank_list[u], p, n, k_list) for u, p, n in (val_split, test_split)]
    both = torch.stack(sums).cpu().numpy().astype(np.float64)
    return (_unpack(both[0], len(val_split[0]), k_list),
            _unpack(both[1], len(test_split[0]), k_list))
