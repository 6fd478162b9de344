"""The reference against the port at a small size on the CPU, the control
(the reference one step below the stated precision, put in the program's
place) failing, and each fault a cell can have planted under a whole run
(the harness's look for a card skipped) turning ``correct`` false."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from benchmark import run
from benchmark.harness import manifest
from benchmark.harness.window import Window
from benchmark.tests.conftest import small_cell

TRAIN = ["sgl-sports-train", "sgl-microlens-train", "lightgcn-microlens-train"]
RANK = ["lightgcn-electronics-rank"]
SEED = 2**31 + 17  # more than 32 signed bits hold


def run_small(name, seed=SEED, seconds=0.2):
    return run.run_cell(name, seed, seconds, False, device="cpu", cell=small_cell(name))


@pytest.mark.parametrize("name", TRAIN + RANK)
def test_port_matches_reference(name):
    res = run_small(name)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {m["name"] for m in small_cell(name).end_to_end}
    assert list(res)[-1] == "checks"
    job = manifest.job_module(small_cell(name).job)
    assert set(res["checks"]) == set(job.NUMBERS) - set(job.not_compared(small_cell(name)))


@pytest.mark.parametrize("name", TRAIN + RANK)
def test_control_fails(name):
    from benchmark.harness.checks import Report

    cell = small_cell(name)
    job = manifest.job_module(cell.job)
    state = job.setup(cell, SEED, torch.device("cpu"))
    job.window(state, Window().start(), 0.0)
    job.release(state)
    sides = job.side_readings(state, torch.device("cpu"))
    report = Report(cell.limits)
    for n, v in sides["control"].items():
        report.add(n, v)
    assert not report.ok, sides["control"]
    if "half_batch" in sides:
        report = Report(cell.limits)
        for n, v in sides["half_batch"].items():
            report.add(n, v)
        assert not report.ok, sides["half_batch"]


def test_same_seed_same_inputs():
    from benchmark.harness import catalog

    t = small_cell("sgl-sports-train").traffic
    a, b, c = catalog.draw(t, SEED, "cpu"), catalog.draw(t, SEED, "cpu"), catalog.draw(t, 7, "cpu")
    assert (a.edges == b.edges).all() and (a.val_item == b.val_item).all()
    assert a.num_edges == c.num_edges and not (a.edges == c.edges).all()
    assert sorted(a.lens) == sorted(c.lens)


# Faults planted in the program under a whole run.

def _unchanged_step(self, params, optimizer, batch):
    """A step that computes its loss and returns the state unchanged."""
    return self.model.loss(params, batch, self.generator)


@pytest.mark.parametrize("name", TRAIN)
def test_fault_state_unchanged(name, monkeypatch):
    from chaorec_tpu_torch.train.loop import Trainer

    monkeypatch.setattr(Trainer, "train_step", _unchanged_step)
    res = run_small(name)
    assert not res["correct"]
    assert res["checks"]["delta_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_fault_half_batch(name, monkeypatch):
    from chaorec_tpu_torch.train.loop import Trainer

    whole = Trainer.bpr_batch

    def half(self, batch):
        b = whole(self, batch)
        w = b.weights.clone()
        w[w.shape[0] // 2:] = 0.0
        return dataclasses.replace(b, weights=w)

    monkeypatch.setattr(Trainer, "bpr_batch", half)
    res = run_small(name)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", TRAIN)
def test_fault_unchanged_after_the_first_step(name, monkeypatch):
    """A fault in ``train_epoch`` alone: the epoch's first step is sound,
    every later one returns its loss and leaves the state unchanged (its
    learning rate 0)."""
    from chaorec_tpu_torch.data.sampling import make_edge_batches
    from chaorec_tpu_torch.train.loop import Trainer

    def epoch(self, params, optimizer):
        losses = []
        for n, batch in enumerate(make_edge_batches(self.generator, self.edges,
                                                    int(self.cfg.batch_size))):
            for group in optimizer.param_groups:
                group["lr"] = float(self.cfg.learning_rate) if n == 0 else 0.0
            losses.append(self.train_step(params, optimizer, self.bpr_batch(batch)).detach())
        return float(torch.stack(losses).sum())

    monkeypatch.setattr(Trainer, "train_epoch", epoch)
    res = run_small(name)
    assert not res["correct"]
    assert res["checks"]["delta_gap"]["value"] == pytest.approx(1.0)


def _optimizer_with(**options):
    def make(self, params):
        return torch.optim.Adam(list(params.values()), lr=float(self.cfg.learning_rate),
                                **options)
    return make


@pytest.mark.parametrize("name", TRAIN)
def test_fault_ascent(name, monkeypatch):
    """Every update's sign flipped, the loss and the gradient's norm sound:
    only the changes' difference sees it."""
    from chaorec_tpu_torch.train.loop import ADAM_BETAS, ADAM_EPS, Trainer

    monkeypatch.setattr(Trainer, "make_optimizer",
                        _optimizer_with(betas=ADAM_BETAS, eps=ADAM_EPS, maximize=True))
    res = run_small(name)
    assert not res["correct"]
    assert res["checks"]["delta_diff"]["value"] > 1.0
    assert res["checks"]["delta_gap"]["value"] < 1e-3


@pytest.mark.parametrize("name", TRAIN)
def test_fault_wrong_beta2(name, monkeypatch):
    """Adam's second moment kept with beta2 0.5: step 1's update, moment
    and loss are the same whatever beta2, so only the later steps show it."""
    from chaorec_tpu_torch.train.loop import ADAM_BETAS, ADAM_EPS, Trainer

    monkeypatch.setattr(Trainer, "make_optimizer",
                        _optimizer_with(betas=(ADAM_BETAS[0], 0.5), eps=ADAM_EPS))
    res = run_small(name)
    checks = res["checks"]
    assert not res["correct"], checks
    assert checks["grad_gap"]["value"] <= checks["grad_gap"]["limit"]
    assert checks["delta_diff"]["value"] > 0.01


@pytest.mark.parametrize("name", TRAIN + RANK)
def test_a_number_without_its_limit_fails(name):
    cell = small_cell(name)
    limits = dict(cell.limits)
    limits.pop(sorted(limits)[0])
    res = run.run_cell(name, SEED, 0.2, False, device="cpu",
                       cell=dataclasses.replace(cell, limits=limits))
    assert not res["correct"]


@pytest.mark.parametrize("name", RANK)
def test_fault_answer_altered(name, monkeypatch):
    from chaorec_tpu_torch.train.loop import Trainer

    evaluate = Trainer.evaluate

    def altered(self, params):
        val, test, lists = evaluate(self, params)
        lists = lists.clone()
        lists[7, 0] = lists[7, -1]  # one listed item replaced where it is produced
        return val, test, lists

    monkeypatch.setattr(Trainer, "evaluate", altered)
    res = run_small(name)
    assert not res["correct"] and res["checks"]["score_gap"]["value"] > 1.0


@pytest.mark.parametrize("name", RANK)
def test_fault_metric_altered(name, monkeypatch):
    from chaorec_tpu_torch.train.loop import Trainer

    evaluate = Trainer.evaluate

    def altered(self, params):
        val, test, lists = evaluate(self, params)
        test = {k: dict(v, recall=v["recall"] * 1.01 + 1e-3) for k, v in test.items()}
        return val, test, lists

    monkeypatch.setattr(Trainer, "evaluate", altered)
    res = run_small(name)
    assert not res["correct"] and res["checks"]["metric_gap"]["value"] > 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAIN + RANK)
def test_small_cell_on_the_card(name, card):
    res = run.run_cell(name, SEED, 0.5, False, device="cuda", cell=small_cell(name))
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
