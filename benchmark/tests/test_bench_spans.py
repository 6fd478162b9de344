"""The readers of the program's own spans: device ms of a span over the
program's count, None (with why) on the CPU, for a span that never ran, for
a count that disagrees with the window's, or for a program without spans;
and the trace reduction naming a gap by the program's innermost span."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import manifest, spans, trace
from benchmark.harness.window import Window
from benchmark.tests.conftest import small_cell

# metric: (span, the window's unit)
READERS = {
    "sample_ms_per_step": ("train.sample", "steps"),
    "forward_ms_per_step": ("train.forward", "steps"),
    "backward_ms_per_step": ("train.backward", "steps"),
    "optimizer_ms_per_step": ("train.optimizer", "steps"),
    "rank_embed_ms_per_pass": ("eval.embeddings", "passes"),
    "rank_score_ms_per_pass": ("eval.score", "passes"),
    "rank_select_ms_per_pass": ("eval.select", "passes"),
    "rank_metrics_ms_per_pass": ("eval.metrics", "passes"),
}
COUNTER = {"steps": "train.steps", "passes": "eval.passes"}


def _ctx(unit, n):
    win = Window()
    win.add(**{unit: n})
    return SimpleNamespace(win=win)


def _stub(monkeypatch, span, device_ms, counters):
    snap = {"spans": {span: {"calls": 4, "host_ms": 1.0, "host_self_ms": 1.0,
                             "device_ms": device_ms, "parent": None}},
            "counters": counters, "launches": {}}
    monkeypatch.setattr(spans, "snapshot", lambda ctx: snap)


@pytest.mark.parametrize("metric", list(READERS))
def test_reader_on_a_stubbed_snapshot(metric, monkeypatch, capsys):
    span, unit = READERS[metric]
    read = manifest.metric_module(metric).read
    _stub(monkeypatch, span, 120.0, {COUNTER[unit]: 4})
    assert read(_ctx(unit, 4)) == pytest.approx(30.0)
    assert read(_ctx(unit, 5)) is None  # the program's count disagrees
    _stub(monkeypatch, span, 120.0, {})
    assert read(_ctx(unit, 4)) is None  # no count
    _stub(monkeypatch, "other.span", 120.0, {COUNTER[unit]: 4})
    assert read(_ctx(unit, 4)) is None  # the span never ran
    _stub(monkeypatch, span, None, {COUNTER[unit]: 4})
    assert read(_ctx(unit, 4)) is None  # the CPU: no device time
    assert capsys.readouterr().err.count(metric) == 4


@pytest.mark.parametrize("metric", list(READERS))
def test_reader_of_a_program_without_spans(metric, monkeypatch):
    span, unit = READERS[metric]
    monkeypatch.setitem(sys.modules, "chaorec_tpu_torch.tracing", None)  # an ImportError
    monkeypatch.setattr(spans, "_last", (None, None))
    assert manifest.metric_module(metric).read(_ctx(unit, 4)) is None


def test_one_snapshot_a_run():
    from chaorec_tpu_torch import tracing

    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("train.sample"):
            tracing.count("train.steps")
    ctx = _ctx("steps", 1)
    first = spans.snapshot(ctx)
    assert spans.snapshot(ctx) is first and first["counters"] == {"train.steps": 1}
    assert spans.count(ctx, "train.steps") == 1 and spans.device_ms(ctx, "train.sample") is None
    assert tracing.snapshot()["spans"] == {}  # cleared for the next run
    assert spans.snapshot(_ctx("steps", 1))["spans"] == {}


def test_gap_in_train_batches_is_named_by_it():
    """A real CPU profile of a traced ``train_epoch`` (the benchmark's ranges
    around the program's spans) with device operations laid before and
    after ``train.batches``: the gap between them is named by that span."""
    from torch.profiler import record_function

    from benchmark.jobs import train

    state = train.setup(small_cell("lightgcn-microlens-train"), 5, torch.device("cpu"))
    p = state.program
    prof = trace.profiler("cpu")
    with record_function(trace.WINDOW):
        with record_function("bench.train_epoch"):
            p["trainer"].train_epoch(p["params"], p["optimizer"])
    prof.stop()
    train.release(state)
    dev, host = trace._events(prof)
    assert dev == []
    (w0, w1), = [(s, e) for s, e, n, _ in host if n == trace.WINDOW]
    (b0, b1), = [(s, e) for s, e, n, r in host if n == "train.batches" and r]
    assert w0 < b0 < b1 < w1
    s = trace.reduce([(w0, b0, "before"), (b1, w1, "after")], host)
    name, seconds = s.gaps[0]
    assert name.startswith("train.batches > ") and seconds == pytest.approx((b1 - b0) * 1e-9)
    assert not any(n.startswith("bench.train_epoch") for n, _ in s.gaps)
