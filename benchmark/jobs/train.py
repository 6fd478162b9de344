"""Training: whole epochs of the port's BPR trainer, back to back.

Set-up draws the catalog, builds the model with ``build_model`` and its
``trainer_cls`` (as ``cli.run`` does) and gives the trainer the benchmark's
params and a fresh Adam. It warms every shape with one step through the
window's own feed and call (``make_edge_batches`` on the trainer's
generator, ``bpr_batch``, ``train_step``) on a throwaway copy of the params
and its own Adam, then puts the generator back, so the window starts from
the seed. The window runs each epoch as ``Trainer.run`` does
(``model.pre_epoch``, then ``Trainer.train_epoch``) on that trainer, params
and optimizer, and ends at the end of the first epoch that ends at or after
``seconds``.

The compared steps are the window's first ``STEPS``, as ``train_epoch``
drives them: a ``StepTap`` in place of the trainer's ``train_step`` keeps
each one's loss and the params after it, and Adam's first moment after the
first, then takes itself away, so the rest of the window runs untouched.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import catalog, checks
from benchmark.reference.train import reference_steps

E2E = {"train_edges_per_s": "edges"}
NUMBERS = ("loss_gap", "grad_gap", "delta_gap", "delta_diff")  # what ``check`` reads
STEPS = 3  # the window's first steps, which the reference follows


class StepTap:
    """Stands in for ``trainer.train_step`` for the first ``steps`` calls:
    passes each on to the trainer's own, keeps the loss and a copy of the
    params after it (and after the first, Adam's first moment), then
    removes itself from the trainer."""

    def __init__(self, trainer, steps: int):
        self.trainer, self.call, self.steps = trainer, trainer.train_step, steps
        self.losses: List[torch.Tensor] = []
        self.params: List[Dict[str, torch.Tensor]] = []
        self.exp_avg: Optional[Dict[str, torch.Tensor]] = None
        trainer.train_step = self

    def __call__(self, params, optimizer, batch):
        loss = self.call(params, optimizer, batch)
        self.losses.append(loss.detach().clone())
        self.params.append({k: v.detach().clone() for k, v in params.items()})
        if self.exp_avg is None:
            # none where the optimizer holds no state: it took no step
            self.exp_avg = {k: optimizer.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                            .detach().clone() for k, p in params.items()}
        if len(self.losses) == self.steps:
            self.remove()
        return loss

    def remove(self) -> None:
        if self.trainer is not None and self.trainer.__dict__.get("train_step") is self:
            del self.trainer.train_step  # the class's own again
        self.trainer = self.call = None


@dataclass
class TrainState:
    cell: object
    seed: int
    cat: catalog.Catalog
    init: Dict[str, torch.Tensor]
    program: Dict  # model, trainer, params, optimizer: dropped by ``release``
    tap: StepTap
    steps_per_epoch: int


def dataset(cat: catalog.Catalog):
    """The port's ``RecDataset`` of a drawn catalog."""
    from chaorec_tpu_torch.data.loading import PaddedLists, RecDataset

    users, ones = np.arange(cat.num_user, dtype=np.int32), np.ones(cat.num_user, np.int32)
    return RecDataset(
        name=cat.name, num_user=cat.num_user, num_item=cat.num_item, train_edges=cat.edges,
        history=PaddedLists(cat.hist, cat.lens, cat.num_item),
        val_users=users, val_pos=PaddedLists(cat.val_item[:, None].copy(), ones, -1),
        test_users=users, test_pos=PaddedLists(cat.test_item[:, None].copy(), ones, -1))


def program_config(cell, seed: int, **extra):
    from chaorec_tpu_torch.config import Config

    t = cell.traffic
    return Config(Model=cell.config["model"], data_path=t["dataset"], seed=seed,
                  dense_prop_threshold=int(cell.config["precision"]["dense_prop_threshold"]),
                  graph_compute_dtype=cell.config["precision"]["graph"],
                  **{k: v for k, v in cell.config["combo"].items()}, **extra)


def build(cell, seed: int, device, mark: Callable[[str], None] = lambda name: None):
    """(catalog, init params, model, trainer) of the cell for ``seed``;
    ``mark`` is called after the import of the port, the catalog's draw
    and the build."""
    from chaorec_tpu_torch.models import build_model
    from chaorec_tpu_torch.train.loop import Trainer

    mark("port_import")
    cat = catalog.draw(cell.traffic, seed, device)
    mark("catalog")
    extra = {k: cell.traffic[k] for k in ("batch_size", "neg_candidates", "eval_user_chunk",
                                          "rank_topk") if k in cell.traffic}
    if "topk" in cell.traffic:
        extra["topk"] = tuple(cell.traffic["topk"])
    cfg = program_config(cell, seed, **extra)
    ds = dataset(cat)
    model = build_model(cfg, ds, device)
    trainer = getattr(model, "trainer_cls", Trainer)(model, ds, cfg)
    init = catalog.init_params(cell.config, cat, seed, device)
    mark("build")
    return cat, init, model, trainer


def warm(trainer, init: Dict[str, torch.Tensor], batch_size: int) -> None:
    """One step through the window's feed and call on a throwaway copy of
    the params with its own Adam; the trainer's generator is put back."""
    from chaorec_tpu_torch.data.sampling import make_edge_batches

    rng = trainer.generator.get_state()
    params = {k: v.clone().requires_grad_() for k, v in init.items()}
    optimizer = trainer.make_optimizer(params)
    batch = make_edge_batches(trainer.generator, trainer.edges, batch_size)[0]
    trainer.train_step(params, optimizer, trainer.bpr_batch(batch)).detach()
    trainer.generator.set_state(rng)


def setup(cell, seed: int, device,
          mark: Callable[[str], None] = lambda name: None) -> TrainState:
    cat, init, model, trainer = build(cell, seed, device, mark)
    bs = int(cell.traffic["batch_size"])
    warm(trainer, init, bs)
    params = {k: v.clone().requires_grad_() for k, v in init.items()}
    optimizer = trainer.make_optimizer(params)
    tap = StepTap(trainer, STEPS)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    mark("warm")
    return TrainState(cell, seed, cat, init,
                      dict(model=model, trainer=trainer, params=params, optimizer=optimizer),
                      tap, -(-cat.num_edges // bs))


def window(state: TrainState, win, seconds: float) -> None:
    from torch.profiler import record_function

    p = state.program
    epoch = 0
    while True:
        with record_function("bench.pre_epoch"):
            p["model"].pre_epoch(p["params"], epoch)
        with record_function("bench.train_epoch"):
            loss = p["trainer"].train_epoch(p["params"], p["optimizer"])
        win.add(edges=state.cat.num_edges, steps=state.steps_per_epoch, epochs=1,
                failed=0 if np.isfinite(loss) else state.steps_per_epoch)
        epoch += 1
        if win.elapsed() >= seconds:
            break


def attempted(win) -> int:
    return int(win.units.get("steps", 0))


def release(state: TrainState) -> None:
    state.tap.remove()
    state.program.clear()


def not_compared(cell) -> Dict[str, str]:
    """The numbers this cell reads and does not hold to a limit, each with
    why (the model's reference says)."""
    from benchmark.harness.manifest import reference_module

    return dict(getattr(reference_module(cell.config["model"]), "NOT_COMPARED", {}))


@dataclass
class Steps:
    """What one side's first steps made: each loss, the first gradient as
    Adam got it, and the params after each step."""

    losses: List[float]
    grad1: Dict[str, torch.Tensor]
    params: List[Dict[str, torch.Tensor]]


def program_steps(state: TrainState) -> Optional[Steps]:
    """The program's: the gradient worked out from Adam's first moment
    after one step, (1 - beta1) g."""
    from chaorec_tpu_torch.train.loop import ADAM_BETAS

    tap = state.tap
    if len(tap.losses) < STEPS:
        return None
    return Steps([float(x) for x in tap.losses],
                 {k: v / (1.0 - ADAM_BETAS[0]) for k, v in tap.exp_avg.items()}, tap.params)


def readings(init: Dict[str, torch.Tensor], side: Steps, ref) -> Dict[str, float]:
    """The compared numbers of a side's first steps against the reference's
    ``ref`` (which followed that side's params from step to step):

    - ``loss_gap``: the worst step's relative loss gap;
    - ``grad_gap``: the worst leaf's gradient norm gap at step 1, the
      gradient as Adam got it (its first moment over 1 - beta1);
    - ``delta_gap``: the worst step's and leaf's norm gap of the step's
      change over the settled elements;
    - ``delta_diff``: the same with the norm of the two changes' difference,
      which sees a flipped or a wrongly scaled update element by element.
    """
    ref_g = checks.norms(ref.grad1)
    leaves = checks.counted_leaves(ref_g)
    out = {"loss_gap": max(checks.rel_gap(a, b) for a, b in zip(side.losses, ref.losses)),
           "grad_gap": checks.leaf_norm_gap(checks.norms(side.grad1), ref_g, leaves),
           "delta_gap": 0.0, "delta_diff": 0.0}
    before = init
    for after, ref_delta, settled in zip(side.params, ref.deltas, ref.settled):
        prog = {k: (after[k] - before[k]) * settled[k] for k in leaves}
        want = {k: ref_delta[k] * settled[k] for k in leaves}
        out["delta_gap"] = max(out["delta_gap"], checks.leaf_norm_gap(
            checks.norms(prog), checks.norms(want), leaves))
        out["delta_diff"] = max(out["delta_diff"], checks.leaf_diff_gap(prog, want, leaves))
        before = after
    return out


def reference(state: TrainState, device, follow=None, lower: bool = False, fault: str = None):
    from benchmark.harness.manifest import reference_module

    cell = state.cell
    return reference_steps(reference_module(cell.config["model"]), cell.config, state.cat,
                           state.init, state.seed, cell.traffic, device, STEPS, follow=follow,
                           lower=lower, fault=fault)


NOT_TAKEN = {n: float("inf") for n in NUMBERS}


def check(state: TrainState, device) -> Dict[str, float]:
    side = program_steps(state)
    if side is None:  # the window did not run its steps through train_step
        return dict(NOT_TAKEN)
    return readings(state.init, side, reference(state, device, follow=side.params))


def side_readings(state: TrainState, device) -> Dict[str, Dict[str, float]]:
    """The control's and the planted faults' readings, each side put in the
    program's place (for the limits; the benchmark's runs do not run it)."""
    out = {}
    for name, kw in (("control", dict(lower=True)), ("half_batch", dict(fault="half_batch"))):
        side_ref = reference(state, device, **kw)
        side = Steps(side_ref.losses, side_ref.grad1, side_ref.params(state.init))
        out[name] = readings(state.init, side, reference(state, device, follow=side.params))
    out["state_unchanged"] = {"delta_gap": 1.0, "delta_diff": 1.0}
    return out
