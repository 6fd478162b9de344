"""The reader of ``csr_spmm_ms_per_step``: device ms of the trace's
``csr_spmm`` kernels over the window's steps, when their count equals the
program's ``graph.csr_spmm`` counter; None (with why) when it does not, and
None, quietly, for a program without the kernel or without counters."""

from __future__ import annotations

import sys

from benchmark.harness import manifest, spans
from benchmark.harness.trace import TraceSummary
from benchmark.harness.window import Window

KERNEL = "void (anonymous namespace)::csr_spmm_kernel<float>(float const*, int const*)"


def _ctx(steps, ops):
    from types import SimpleNamespace

    win = Window()
    win.add(steps=steps)
    trace = TraceSummary(1.0, 1.0, {n: s for n, (s, _) in ops.items()},
                         {n: c for n, (_, c) in ops.items()})
    return SimpleNamespace(win=win, trace=trace)


def _counters(monkeypatch, counters):
    snap = {"spans": {}, "counters": counters, "launches": {}}
    monkeypatch.setattr(spans, "snapshot", lambda ctx: snap)


def test_reads_the_kernels_ms_a_step_when_the_counts_agree(monkeypatch, capsys):
    read = manifest.metric_module("csr_spmm_ms_per_step").read
    ops = {KERNEL: (0.006, 24), "indexing_backward_kernel<float, 4>": (0.5, 2)}
    _counters(monkeypatch, {"graph.csr_spmm": 24, "train.steps": 2})
    assert abs(read(_ctx(2, ops)) - 3.0) < 1e-12
    _counters(monkeypatch, {"graph.csr_spmm": 23})
    assert read(_ctx(2, ops)) is None  # the trace and the counter disagree
    assert "csr_spmm_ms_per_step" in capsys.readouterr().err
    _counters(monkeypatch, {})
    assert read(_ctx(2, ops)) is None  # kernels in the trace, no counter


def test_reads_nothing_without_the_kernel(monkeypatch, capsys):
    """A program without the kernel (the trace holds none) or a window
    without steps reads nothing, and says nothing."""
    read = manifest.metric_module("csr_spmm_ms_per_step").read
    _counters(monkeypatch, {"train.steps": 2})
    assert read(_ctx(2, {"indexing_backward_kernel<float, 4>": (0.5, 2)})) is None
    assert read(_ctx(0, {KERNEL: (0.006, 24)})) is None
    assert capsys.readouterr().err == ""


def test_a_program_without_counters_reads_nothing(monkeypatch, capsys):
    read = manifest.metric_module("csr_spmm_ms_per_step").read
    monkeypatch.setitem(sys.modules, "chaorec_tpu_torch.tracing", None)  # an ImportError
    monkeypatch.setattr(spans, "_last", (None, None))
    assert read(_ctx(2, {KERNEL: (0.006, 24)})) is None
    assert "csr_spmm_ms_per_step" in capsys.readouterr().err
