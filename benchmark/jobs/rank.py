"""Ranking: full-catalog passes of ``Trainer.evaluate`` over every user, back
to back, on the set-up's params.

Set-up draws the catalog, builds the model and its trainer as ``cli.run``
does, gives it the benchmark's params and runs one pass, which warms every
shape. The window runs passes until ``seconds`` have passed and keeps the
rank lists and metrics of two of them: one drawn from the seed among the
first ``kept_pass_choices``, and the last. Both are judged once the window
has closed.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.harness import catalog
from benchmark.jobs.train import build
from benchmark.reference import rank as rank_ref
from benchmark.reference.common import Graph, Precision

E2E = {"rank_users_per_s": "users"}
NUMBERS = ("score_gap", "metric_gap")  # what ``check`` reads


@dataclass
class RankState:
    cell: object
    seed: int
    cat: catalog.Catalog
    init: Dict[str, torch.Tensor]
    program: Dict
    keep_at: int
    kept: List[Tuple[torch.Tensor, Dict, Dict]] = field(default_factory=list)


def setup(cell, seed: int, device, mark=lambda name: None) -> RankState:
    cat, init, model, trainer = build(cell, seed, device, mark)
    params = {k: v.clone() for k, v in init.items()}
    trainer.evaluate(params)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    mark("warm")
    keep_at = int(np.random.default_rng(seed).integers(int(cell.traffic["kept_pass_choices"])))
    return RankState(cell, seed, cat, init, dict(model=model, trainer=trainer, params=params),
                     keep_at)


def window(state: RankState, win, seconds: float) -> None:
    from torch.profiler import record_function

    p = state.program
    n = 0
    last = None
    while True:
        with record_function("bench.evaluate"):
            val, test, lists = p["trainer"].evaluate(p["params"])
        win.add(users=state.cat.num_user, passes=1)
        if n == state.keep_at:
            state.kept.append((lists, val, test))
        last = (lists, val, test)
        n += 1
        if win.elapsed() >= seconds and n > state.keep_at:
            break
    if state.keep_at != n - 1:
        state.kept.append(last)


def attempted(win) -> int:
    return int(win.units.get("users", 0))


def release(state: RankState) -> None:
    state.program.clear()


def not_compared(cell) -> Dict[str, str]:
    return {}


def reference_tables(state: RankState, device, lower: bool = False):
    """(graph, precision, user table, item table) of the plain reference."""
    from benchmark.harness.manifest import reference_module

    cell, cat = state.cell, state.cat
    graph = Graph.build(cat.edges, cat.num_user, cat.num_item, device,
                        int(cell.config["precision"]["dense_prop_threshold"]))
    prec = Precision.stated(cell.config["precision"], graph.dense, lower)
    ref = reference_module(cell.config["model"])
    with torch.no_grad():
        u, i = ref.embeddings(state.init, graph, cell.config["combo"], prec)
    return graph, prec, u, i


def readings_of(state: RankState, kept, tables) -> Dict[str, float]:
    _, prec, u, i = tables
    cat = state.cat
    hist = torch.from_numpy(cat.hist).to(u.device)
    users = np.arange(cat.num_user)
    out = {"score_gap": 0.0, "metric_gap": 0.0}
    for lists, val, test in kept:
        out["score_gap"] = max(out["score_gap"], rank_ref.list_gaps(
            lists, u, i, hist, prec.scores, int(state.cell.traffic["eval_user_chunk"])))
        arr = lists.cpu().numpy()
        for got, item in ((val, cat.val_item), (test, cat.test_item)):
            ref = rank_ref.metric_values(arr, users, item.astype(np.int64) + cat.num_user,
                                         state.cell.traffic["topk"])
            out["metric_gap"] = max(out["metric_gap"], rank_ref.metric_gap(got, ref, len(users)))
    return out


def check(state: RankState, device) -> Dict[str, float]:
    return readings_of(state, state.kept, reference_tables(state, device))


def side_readings(state: RankState, device) -> Dict[str, Dict[str, float]]:
    """The control's readings: the reference one step below the stated
    precision (its graph inputs and scores in fp8, its metric sums in bf16),
    put in the program's place."""
    tables = reference_tables(state, device)
    _, prec, u, i = reference_tables(state, device, lower=True)
    cat, t = state.cat, state.cell.traffic
    hist = torch.from_numpy(cat.hist).to(u.device)
    lists = rank_ref.rank_lists(u, i, hist, int(t["rank_topk"]), prec.scores,
                                int(t["eval_user_chunk"]))
    arr, users = lists.cpu().numpy(), np.arange(cat.num_user)
    val, test = (rank_ref.metric_values(arr, users, item.astype(np.int64) + cat.num_user,
                                        t["topk"], prec.metric_sums)
                 for item in (cat.val_item, cat.test_item))
    return {"control": readings_of(state, [(lists, val, test)], tables)}
