"""The reference's first training steps, worked out again from the seed: the
trainer's draws (``common.Draws``), the model's plain loss (``<model>.py``)
and its gradients by autograd, and Adam written out.

Step 1 starts from the benchmark's initial params. Each later step starts
from the params that the side it judges reached after the step before
(``follow``), with the reference's own Adam moments, worked out from the
start. So each step is judged by itself: a gradient that cancels to near
Adam's eps (1e-8) in one step, whose update the rounding of its sums sets,
does not carry into the next step's comparison. A step's change is
compared over the elements whose Adam denominator sqrt(v_hat) is past
``SETTLED`` in the reference; nearer eps the rounding sets the update.

``fault`` plants one of the faults the comparison has to catch, in the
reference put in the program's place: "half_batch" (the second half of
each batch left out, the mean taken over the rest).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from benchmark.reference.common import Adam, Draws, Graph, Precision

SETTLED = 1e-6


@dataclass
class StepsOut:
    losses: List[float]  # each step's loss
    grad1: Dict[str, torch.Tensor]  # the first step's gradient
    deltas: List[Dict[str, torch.Tensor]]  # each step's change of the params
    settled: List[Dict[str, torch.Tensor]]  # where each step's update is past Adam's eps

    def params(self, init: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
        """The params after each step, when each step started from the last."""
        out, p = [], init
        for d in self.deltas:
            p = {k: p[k] + d[k] for k in p}
            out.append(p)
        return out


def reference_steps(model_ref, config: Dict, cat, init: Dict[str, torch.Tensor], seed: int,
                    traffic: Dict, device, steps: int,
                    follow: Optional[List[Dict[str, torch.Tensor]]] = None,
                    lower: bool = False, fault: Optional[str] = None) -> StepsOut:
    """``steps`` steps from ``init``; step t + 1 starts from ``follow[t]``
    (the judged side's params after step t), or without ``follow`` from the
    reference's own."""
    combo = config["combo"]
    graph = Graph.build(cat.edges, cat.num_user, cat.num_item, device,
                        int(config["precision"]["dense_prop_threshold"]))
    prec = Precision.stated(config["precision"], graph.dense, lower)
    edges = torch.from_numpy(cat.edges).to(device, torch.int64)
    hist = torch.from_numpy(cat.hist).to(device)
    n_keep, p_keep = model_ref.draws(combo)
    draws = Draws(seed, edges, hist, cat.num_item, int(traffic["batch_size"]),
                  int(traffic["neg_candidates"]), n_keep, p_keep)
    adam = Adam(init, float(combo["learning_rate"]))
    out = StepsOut([], {}, [], [])
    start = init
    for t in range(steps):
        rows = draws.step(t)
        if fault == "half_batch":
            rows.weights[rows.weights.shape[0] // 2:] = 0.0
        leaves = {k: v.detach().clone().requires_grad_() for k, v in start.items()}
        loss = model_ref.loss(leaves, graph, rows, combo, prec)
        grads = {k: g.detach() for k, g in
                 zip(leaves, torch.autograd.grad(loss, list(leaves.values())))}
        new = adam.step(leaves, grads)
        out.losses.append(float(loss.detach()))
        if t == 0:
            out.grad1 = grads
        out.deltas.append({k: new[k] - start[k] for k in new})
        out.settled.append({k: d >= SETTLED for k, d in adam.denominators().items()})
        start = follow[t] if follow is not None else new
    return out
