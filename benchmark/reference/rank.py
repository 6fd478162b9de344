"""The ranking pass, plain: scores of every user against every item as
products of the propagated tables at the stated precision (bf16 inputs,
float32 sums), each user's seen items set to 1e-6, the best ``topk``; and
the top-K metrics (precision, recall, NDCG with the natural log, hit rate,
MAP over the truth length) averaged over every row of a split.

``list_gaps`` judges lists that another side made: for each position k the
reference's k-th best score less its score of the listed item, over the
row's largest score magnitude; the widest gap is the number compared. A
row with an id out of range or repeated gaps by infinity.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from benchmark.reference.common import matmul_precision, round_to

MASK_VALUE = 1e-6
METRICS = ("precision", "recall", "ndcg", "hit_rate", "map")


def scores(user_rows: torch.Tensor, item_emb: torch.Tensor, hist_rows: torch.Tensor,
           prec: str) -> torch.Tensor:
    """(n, I) masked scores of ``user_rows`` (n, D)."""
    with matmul_precision("float32"):
        s = round_to(user_rows, prec) @ round_to(item_emb, prec).t()
    n, num_item = s.shape
    wide = torch.cat([s, s.new_empty((n, 1))], dim=1)
    wide.scatter_(1, hist_rows.long(), MASK_VALUE)
    return wide[:, :num_item]


@torch.no_grad()
def rank_lists(user_emb, item_emb, hist, topk: int, prec: str, chunk: int = 4096):
    """(U, topk) global ids (item + U) of every user's best unseen items."""
    num_user = user_emb.shape[0]
    out = []
    for a in range(0, num_user, chunk):
        s = scores(user_emb[a:a + chunk], item_emb, hist[a:a + chunk], prec)
        out.append(torch.topk(s, topk, dim=1).indices + num_user)
    return torch.cat(out)


@torch.no_grad()
def list_gaps(lists: torch.Tensor, user_emb, item_emb, hist, prec: str,
              chunk: int = 4096) -> float:
    """The widest relative score gap of ``lists`` (U, K) global ids."""
    num_user, num_item = user_emb.shape[0], item_emb.shape[0]
    widest = 0.0
    for a in range(0, num_user, chunk):
        got = lists[a:a + chunk].long() - num_user
        srt = torch.sort(got, dim=1).values
        bad = ((got < 0) | (got >= num_item)).any(1) | (srt[:, 1:] == srt[:, :-1]).any(1)
        s = scores(user_emb[a:a + chunk], item_emb, hist[a:a + chunk], prec)
        best = torch.topk(s, got.shape[1], dim=1).values
        at = torch.gather(s, 1, got.clamp(0, num_item - 1))
        gap = (best - at) / s.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
        gap[bad] = float("inf")
        widest = max(widest, float(gap.max()))
    return widest


def metric_values(lists: np.ndarray, users: np.ndarray, truth: np.ndarray,
                  k_list: Sequence[int], sums: str = "float32") -> Dict[int, Dict[str, float]]:
    """The metrics of ``lists`` (U, K) global ids over the rows ``users``
    with one truth item each (global id, -1 for none), each per-row value
    worked out in float64 and summed in float64, or rounded to ``sums``
    (the control's "bfloat16") when it is not "float32"."""
    ranked = lists[users]
    hits = ranked == truth[:, None]
    n_truth = (truth >= 0).astype(np.float64)
    length = np.maximum(n_truth, 1.0)
    pos = np.arange(ranked.shape[1], dtype=np.float64)
    disc = 1.0 / np.log(pos + 2.0)
    cum = np.cumsum(hits, axis=1)
    out = {}
    for k in k_list:
        hk = hits[:, :k].astype(np.float64)
        n_hits = hk.sum(1)
        idcg = np.cumsum(disc)[np.clip(np.minimum(n_truth, k).astype(int) - 1, 0, None)]
        rows = {"precision": n_hits / k, "recall": n_truth * n_hits / length,
                "ndcg": n_truth * (hk * disc[:k]).sum(1) / idcg,
                "hit_rate": (n_hits > 0).astype(np.float64),
                "map": n_truth * (hk * cum[:, :k] / (pos[:k] + 1.0)).sum(1) / length}
        out[int(k)] = {m: _mean(v, sums) for m, v in rows.items()}
    return out


def _mean(v: np.ndarray, sums: str) -> float:
    if sums == "float32":
        return float(v.sum() / v.shape[0])
    total = torch.from_numpy(v).to(torch.bfloat16).sum(dtype=torch.bfloat16)
    return float(total) / v.shape[0]


def metric_gap(got: Dict, ref: Dict, n_rows: int) -> float:
    """The widest gap of one metric, over its value or one row's share of
    the average, whichever is larger."""
    return max(abs(float(got[k][m]) - ref[k][m]) / max(abs(ref[k][m]), 1.0 / n_rows)
               for k in ref for m in METRICS)
