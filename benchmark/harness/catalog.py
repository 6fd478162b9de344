"""A seeded synthetic catalog at a data set's exact shape, drawn on the card.

The law (``chip_smoke.py:catalog_dataset``'s, rewritten here): every item
has a popularity weight 1 / (rank + offset), the ranks in a random order
(so popular items are not neighbours in memory); each user holds n train items
(n from ``train_items_per_user``) drawn without replacement with
probabilities proportional to the weights, as a Gumbel top-k over chunks of
users on the device (the first n of a row's largest ``log w + Gumbel``
keys); one val and one test item a user, each uniform over the items the
user has not seen.

So that every seed does the same work in another order, the graph is drawn
once from the traffic's ``sizes_seed`` and the run's seed permutes its
users, then draws the held-out items. Every seed has the same degrees and
the same item layout, so the same work; the trainer's draws and the
weights come from the seed as well.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

CHUNK = 4096  # users a Gumbel top-k draw takes at once
SEED_GUMBEL = 1 << 40  # offsets of the torch streams: the base graph's keys, the params
SEED_PARAMS = 1 << 41


@dataclass
class Catalog:
    """Train edges (E, 2) [user, item] sorted by user, the sorted histories
    padded with ``num_item``, and one held item a user for val and test."""

    name: str
    num_user: int
    num_item: int
    edges: np.ndarray  # (E, 2) int32
    hist: np.ndarray  # (U, H) int32, sorted, padded with num_item
    lens: np.ndarray  # (U,) int32
    val_item: np.ndarray  # (U,) int32
    test_item: np.ndarray  # (U,) int32

    @property
    def num_edges(self) -> int:
        return int(self.edges.shape[0])


def size_multiset(traffic: dict) -> np.ndarray:
    """The users' train sizes, the same multiset for every run seed."""
    lo, hi = traffic["train_items_per_user"]
    rng = np.random.default_rng(traffic["sizes_seed"])
    return rng.integers(lo, hi + 1, traffic["num_user"]).astype(np.int32)


def unseen_pairs(rng: np.random.Generator, hist: np.ndarray, num_item: int,
                 cands: int = 8) -> np.ndarray:
    """(U, 2): two distinct items a user, each uniform over the items not in
    its row of ``hist`` (rejection from ``cands`` uniform draws a row; a row
    left with fewer than two draws again)."""
    out = np.empty((hist.shape[0], 2), np.int64)
    todo = np.arange(hist.shape[0])
    while todo.size:
        cand = rng.integers(num_item, size=(todo.size, cands))
        bad = (cand[:, :, None] == hist[todo][:, None, :]).any(2)
        bad |= np.triu(cand[:, :, None] == cand[:, None, :], 1).any(1)
        enough = (~bad).sum(1) >= 2
        first = np.argsort(bad, axis=1, kind="stable")[:, :2]
        out[todo[enough]] = np.take_along_axis(cand, first, 1)[enough]
        todo = todo[~enough]
    return out


def base_graph(traffic: dict, device) -> tuple:
    """(sizes (U,), picks (U, W)) of the traffic's graph before relabelling:
    user u's first sizes[u] picks are its items."""
    num_user, num_item = int(traffic["num_user"]), int(traffic["num_item"])
    lens = size_multiset(traffic)
    width = int(lens.max())
    w = 1.0 / (np.arange(num_item) + float(traffic["item_weight_offset"]))
    w = w[np.random.default_rng(traffic["sizes_seed"]).permutation(num_item)]
    log_w = torch.from_numpy(np.log(w)).to(device, torch.float32)
    gen = torch.Generator(device).manual_seed(int(traffic["sizes_seed"]) + SEED_GUMBEL)
    picks = []
    for start in range(0, num_user, CHUNK):
        u = torch.rand((min(CHUNK, num_user - start), num_item), generator=gen, device=device)
        picks.append(torch.topk(log_w - torch.log(-torch.log(u)), width, dim=1).indices.cpu())
    return lens, torch.cat(picks).numpy()


def draw(traffic: dict, seed: int, device) -> Catalog:
    """The traffic's catalog, its users permuted by ``seed``."""
    num_user, num_item = int(traffic["num_user"]), int(traffic["num_item"])
    lens, picks = base_graph(traffic, device)
    rng = np.random.default_rng(seed)
    row_of = rng.permutation(num_user)  # new user v holds base user row_of[v]'s items
    lens, picks = lens[row_of], picks[row_of].astype(np.int32)
    width = picks.shape[1]
    kept = np.arange(width)[None, :] < lens[:, None]
    hist = np.sort(np.where(kept, picks, num_item), axis=1).astype(np.int32)
    edges = np.stack([np.repeat(np.arange(num_user, dtype=np.int32), lens), hist[kept]], 1)
    held = unseen_pairs(rng, hist, num_item).astype(np.int32)
    return Catalog(traffic["dataset"], num_user, num_item, np.ascontiguousarray(edges), hist,
                   lens.astype(np.int32), held[:, 0].copy(), held[:, 1].copy())


def init_params(config: dict, cat: Catalog, seed: int, device) -> dict:
    """The configuration's params, xavier-uniform (torch's: bound
    sqrt(6 / (fan_in + fan_out)), fan_in the second dim), drawn on
    ``device`` from the seed, one call a table."""
    if config["init"] != "xavier_uniform":
        raise ValueError(f"init {config['init']!r} is not drawn here")
    sizes = {"num_user": cat.num_user, "num_item": cat.num_item, **config["combo"]}
    gen = torch.Generator(device).manual_seed(seed + SEED_PARAMS)
    out = {}
    for name, dims in config["params"].items():
        shape = tuple(int(sizes[d]) if isinstance(d, str) else int(d) for d in dims)
        bound = (6.0 / (shape[0] + shape[1])) ** 0.5
        out[name] = torch.rand(shape, generator=gen, device=device) * (2 * bound) - bound
    return out
