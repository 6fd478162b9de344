"""The trace reduction: the device's busy time is the union of its
operations inside the window, gaps are named by the host's innermost range
and operation."""

from __future__ import annotations

import pytest

from benchmark.harness import trace


def test_busy_union_gaps_and_names():
    ms = 1_000_000
    dev = [(10 * ms, 20 * ms, "k1"), (15 * ms, 30 * ms, "k2"), (50 * ms, 60 * ms, "k1"),
           (95 * ms, 120 * ms, "late")]
    host = [(0, 100 * ms, trace.WINDOW, True), (30 * ms, 50 * ms, "bench.train_epoch", True),
            (35 * ms, 45 * ms, "aten::index_add_", False),
            (32 * ms, 48 * ms, "autograd::backward", False)]
    s = trace.reduce(dev, host)
    assert s.window_s == pytest.approx(0.1)
    assert s.busy_s == pytest.approx(0.020 + 0.010 + 0.005)  # k2 overlaps k1; "late" clipped
    assert s.idle_pct == pytest.approx(65.0)
    assert s.op_seconds["k1"] == pytest.approx(0.020) and s.op_counts["k1"] == 2
    assert s.gaps[0] == ("bench.window > (no host op)", pytest.approx(0.035))
    assert s.gaps[1] == ("bench.train_epoch > aten::index_add_", pytest.approx(0.020))
    assert [g for _, g in s.gaps] == sorted((g for _, g in s.gaps), reverse=True)
    b = s.breakdown()
    assert b["device_ops"][0][0] == "k1" and len(b["idle_gaps"]) <= 10


def test_no_device_operation_raises():
    with pytest.raises(RuntimeError):
        trace.reduce([], [(0, 10, trace.WINDOW, True)])
