"""The port's spans and counters (``chaorec_tpu_torch/tracing.py``).

Without a profiler they do nothing (``record_function`` is never entered);
under one, each span of the trainer and the ranking is a ``user_annotation``
range of the trace over the operations it encloses, its calls agree with
the trainer's own counters, and the run's bits are those of a run with no
profiler. The ``cuda`` case reads the spans' device time on the card.
"""

import json
import logging
import math
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chaorec_tpu_torch import tracing
from chaorec_tpu_torch.config import Config
from chaorec_tpu_torch.eval.ranking import rank_from_scores
from chaorec_tpu_torch.models import build_model
from chaorec_tpu_torch.train import loop
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

LIGHTGCN = dict(Model="LightGCN", batch_size=100, dim_E=16, learning_rate=0.01, reg_weight=1e-3,
                n_layers=2, graph_compute_dtype="float32", topk=(5, 10, 20))
SGL = dict(Model="SGL", batch_size=64, dim_E=16, learning_rate=0.05, reg_weight=1e-3,
           n_layers=2, ssl_temp=0.2, ssl_alpha=1e-3, graph_compute_dtype="float32",
           topk=(5, 10, 20))
FREEDOM = dict(Model="FREEDOM", batch_size=64, dim_E=16, feature_embed=16, learning_rate=0.05,
               reg_weight=1e-3, n_layers=2, mm_layers=1, ii_topk=5, dropout=0.1,
               lambda_coeff=0.8, topk=(5, 10, 20))
STEP_PHASES = ("train.step", "train.sample", "train.forward", "train.backward",
               "train.optimizer")


def _trainer(ds, flags, device="cpu", **over):
    cfg = Config(**{**flags, **over}, seed=7)
    model = build_model(cfg, ds, torch.device(device))
    return model, loop.Trainer(model, ds, cfg)


def _profiled(fn, cuda=False):
    """(fn's result, its snapshot, the profiler's host events) of ``fn``
    run under a profiler, the spans cleared before."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    tracing.reset()
    with profile(activities=acts) as prof:
        out = fn()
    snap = tracing.snapshot()
    tracing.reset()
    return out, snap, [e for e in prof.profiler.kineto_results.events()
                       if e.device_type() == torch.autograd.DeviceType.CPU]


def _ranges(events, name):
    return [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
            if e.name() == name and e.activity_type() == "user_annotation"]


def _ops_inside(events, ranges):
    return {e.name() for e in events if e.activity_type() == "cpu_op"
            and any(a <= e.start_ns() and e.start_ns() + e.duration_ns() <= b
                    for a, b in ranges)}


def test_span_and_count_alone():
    tracing.reset()
    assert tracing.span("a") is tracing.span("b")  # the shared null context
    tracing.count("c", 3)
    assert tracing.snapshot()["counters"] == {}
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("outer"):
            for _ in range(2):
                with tracing.span("inner"):
                    time.sleep(0.002)
            tracing.count("c", 3)
            tracing.count("c")
    snap = tracing.snapshot()
    outer, inner = snap["spans"]["outer"], snap["spans"]["inner"]
    assert (outer["calls"], inner["calls"], outer["parent"], inner["parent"]) == (
        1, 2, None, "outer")
    assert inner["host_ms"] >= 4.0 and inner["host_self_ms"] == inner["host_ms"]
    assert outer["host_self_ms"] == pytest.approx(outer["host_ms"] - inner["host_ms"], abs=1e-6)
    assert outer["device_ms"] is None and snap["counters"] == {"c": 4}
    assert set(snap["launches"]) >= {"streaming_lse_fwd", "fused_row_adam", "prefix_cumsum"}
    tracing.reset()
    assert tracing.snapshot()["spans"] == {} == tracing.snapshot()["counters"]


def test_no_profiler_no_span(tiny_dataset, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(tracing, "record_function", refuse)
    tracing.reset()
    _, tr = _trainer(tiny_dataset, LIGHTGCN)
    params = tr.init_params()
    tr.train_epoch(params, tr.make_optimizer(params))
    tr.evaluate(params)
    snap = tracing.snapshot()
    assert snap["spans"] == {} and snap["counters"] == {}


@pytest.mark.parametrize("threshold,dense", [(600_000_000, True), (0, False)],
                         ids=["dense", "segment"])
def test_train_spans_under_profiler(tiny_dataset, threshold, dense):
    model, tr = _trainer(tiny_dataset, SGL, dense_prop_threshold=threshold)
    assert model.graph.use_dense is dense
    params = tr.init_params()
    opt = tr.make_optimizer(params)
    _, snap, events = _profiled(lambda: tr.train_epoch(params, opt))
    edges = tiny_dataset.train_edges.shape[0]
    steps = math.ceil(edges / SGL["batch_size"])
    spans, counters = snap["spans"], snap["counters"]
    assert counters == {"train.steps": steps, "train.edges": edges}
    assert all(spans[n]["calls"] == steps for n in STEP_PHASES)
    assert spans["train.batches"]["calls"] == spans["train.sync"]["calls"] == 1
    assert all(spans[n]["parent"] == "train.step" for n in STEP_PHASES[1:])
    assert all(s["device_ms"] is None for s in spans.values())
    step = spans["train.step"]
    assert step["host_self_ms"] == pytest.approx(
        step["host_ms"] - sum(spans[n]["host_ms"] for n in STEP_PHASES[1:]), abs=1e-3)
    for name in spans:
        assert len(_ranges(events, name)) == spans[name]["calls"], name
    inside = {n: _ops_inside(events, _ranges(events, n)) for n in spans}
    assert "aten::randperm" in inside["train.batches"]
    assert "aten::randint" in inside["train.sample"]
    assert "aten::randint" not in inside["train.forward"] | inside["train.backward"]
    assert inside["train.backward"] and inside["train.forward"]
    assert any("adam" in op.lower() or op == "aten::addcdiv_" for op in inside["train.optimizer"])
    assert "aten::stack" in inside["train.sync"]


@pytest.mark.parametrize("flags", [LIGHTGCN, SGL], ids=["LightGCN", "SGL"])
def test_profiler_leaves_the_bits(tiny_dataset, flags):
    def run():
        _, tr = _trainer(tiny_dataset, flags)
        params = tr.init_params()
        opt = tr.make_optimizer(params)
        losses = [tr.train_epoch(params, opt) for _ in range(2)]
        return losses, {k: v.detach().clone() for k, v in params.items()}, tr.evaluate(params)[2]

    plain = run()
    traced, snap, _ = _profiled(run)
    assert snap["spans"]["train.step"]["calls"] > 0
    assert [x.hex() for x in plain[0]] == [x.hex() for x in traced[0]]
    for k in plain[1]:
        assert torch.equal(plain[1][k], traced[1][k]), k
    assert torch.equal(plain[2], traced[2])


def test_evaluate_spans_and_counters(tiny_dataset):
    chunk = 20
    _, tr = _trainer(tiny_dataset, LIGHTGCN, eval_user_chunk=chunk)
    params = tr.init_params()
    (_, _, lists), snap, events = _profiled(lambda: tr.evaluate(params))
    users = tiny_dataset.num_user
    chunks = math.ceil(users / chunk)
    spans, counters = snap["spans"], snap["counters"]
    assert counters == {"eval.passes": 1, "eval.chunks": chunks, "eval.users": users}
    assert spans["eval.score"]["calls"] == spans["eval.select"]["calls"] == chunks
    assert all(spans[n]["calls"] == 1 for n in ("eval.embeddings", "eval.rank", "eval.metrics"))
    assert spans["eval.score"]["parent"] == spans["eval.select"]["parent"] == "eval.rank"
    assert lists.shape[0] == users
    assert "aten::topk" in _ops_inside(events, _ranges(events, "eval.select"))
    assert "aten::scatter_" in _ops_inside(events, _ranges(events, "eval.select"))


def test_score_mode_ranking_counts():
    num_user, num_item, chunk = 50, 30, 16
    table = torch.randn(num_user, num_item, generator=torch.Generator().manual_seed(0))
    model = SimpleNamespace(num_user=num_user, num_item=num_item, mask_value=-float("inf"),
                            score_users=lambda params, ids: table[ids])
    hist = torch.full((num_user, 3), num_item, dtype=torch.int32)
    plain = rank_from_scores(model, None, hist, 5, chunk)
    traced, snap, _ = _profiled(lambda: rank_from_scores(model, None, hist, 5, chunk))
    assert torch.equal(plain, traced)
    chunks = math.ceil(num_user / chunk)
    assert snap["counters"] == {"eval.chunks": chunks, "eval.users": num_user}
    assert snap["spans"]["eval.score"]["calls"] == snap["spans"]["eval.select"]["calls"] == chunks


def test_table_branch_optimizer_span(tiny_dataset):
    model, tr = _trainer(tiny_dataset, FREEDOM)
    assert model.table_params
    params = tr.init_params()
    opt = tr.make_optimizer(params)
    _, snap, events = _profiled(lambda: tr.train_epoch(params, opt))
    steps = math.ceil(tiny_dataset.train_edges.shape[0] / FREEDOM["batch_size"])
    assert snap["counters"]["train.steps"] == steps
    assert all(snap["spans"][n]["calls"] == steps for n in STEP_PHASES)
    assert int(tr.table_count) == steps


def test_profile_dir_logs_the_epochs_spans(tiny_dataset, tmp_path, caplog):
    prof = tmp_path / "prof"
    cfg = Config(**LIGHTGCN, seed=7, num_epoch=2, profile_dir=str(prof))
    tracing.reset()
    with caplog.at_level(logging.INFO):
        loop.Trainer(build_model(cfg, tiny_dataset, torch.device("cpu")), tiny_dataset,
                     cfg).run()
    steps = math.ceil(tiny_dataset.train_edges.shape[0] / LIGHTGCN["batch_size"])
    lines = [m for m in caplog.messages if m.startswith("span ")]
    assert [m.split(":")[0] for m in lines] == [
        f"span {n}" for n in ("train.batches", "train.sample", "train.forward",
                              "train.backward", "train.optimizer", "train.step", "train.sync",
                              "eval.embeddings", "eval.score", "eval.select", "eval.rank",
                              "eval.metrics")]
    assert f"span train.step: calls {steps}," in " ".join(lines)
    assert all(m.endswith("device none ms") for m in lines)
    counters = [m for m in caplog.messages if m.startswith("counters: ")]
    assert counters == [f"counters: train.edges {tiny_dataset.train_edges.shape[0]}, "
                        f"train.steps {steps}, eval.passes 1, eval.chunks 1, "
                        f"eval.users {tiny_dataset.num_user}"]
    names = {e.get("name") for e in json.loads(
        (prof / "epoch_2.trace.json").read_text())["traceEvents"]}
    assert {"train.step", "train.backward", "eval.select"} <= names
    assert tracing.snapshot()["spans"] == {}  # reset after the log


@pytest.mark.cuda
def test_device_ms_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device time exists only there")
    rs = np.random.default_rng(3)
    num_user, num_item = 3000, 2000
    ds = _catalog(rs, num_user, num_item, 12)
    _, tr = _trainer(ds, dict(LIGHTGCN, batch_size=1024), device="cuda")
    params = tr.init_params()
    opt = tr.make_optimizer(params)
    tr.train_epoch(params, opt)  # warm

    def epoch():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_epoch(params, opt)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    seconds, snap, _ = _profiled(epoch, cuda=True)
    steps = snap["counters"]["train.steps"]
    phases = [snap["spans"][n]["device_ms"] for n in STEP_PHASES[1:]]
    assert all(ms is not None and ms > 0 for ms in phases), phases
    assert sum(phases) / steps <= 1e3 * seconds / steps
    assert snap["spans"]["train.step"]["device_ms"] <= 1e3 * seconds


def _catalog(rs, num_user, num_item, per_user):
    """A port ``RecDataset`` with ``per_user`` distinct train items a user
    and one val and one test item outside them."""
    from chaorec_tpu_torch.data.loading import PaddedLists, RecDataset

    items = np.stack([rs.choice(num_item, per_user + 2, replace=False) for _ in range(num_user)])
    hist = np.sort(items[:, :per_user], axis=1).astype(np.int32)
    users = np.arange(num_user, dtype=np.int32)
    edges = np.stack([np.repeat(users, per_user), hist.ravel()], 1).astype(np.int32)
    ones = np.ones(num_user, np.int32)
    return RecDataset(
        name="card", num_user=num_user, num_item=num_item, train_edges=edges,
        history=PaddedLists(hist, np.full(num_user, per_user, np.int32), num_item),
        val_users=users, val_pos=PaddedLists(items[:, -2:-1].astype(np.int32), ones, -1),
        test_users=users, test_pos=PaddedLists(items[:, -1:].astype(np.int32), ones, -1))
