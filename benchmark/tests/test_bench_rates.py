"""A rate is all the window's work over all its time: a stall inside the
window lowers it."""

from __future__ import annotations

import time

import pytest

from benchmark.harness.window import Window


def run(stall: float) -> Window:
    w = Window().start()
    for _ in range(4):
        time.sleep(0.02)
        w.add(edges=1000, steps=1)
    time.sleep(stall)
    w.stop()
    return w


def test_rate_is_work_over_window():
    w = run(0.0)
    assert w.units == {"edges": 4000, "steps": 4}
    assert w.rate("edges") == pytest.approx(4000 / w.seconds)
    assert w.seconds >= 0.08


def test_a_stall_lowers_the_rate():
    assert run(0.2).rate("edges") < 0.5 * run(0.0).rate("edges")


def test_stop_synchronizes_first():
    order = []
    w = Window(sync=lambda: order.append("sync")).start()
    w.stop()
    assert order == ["sync", "sync"]
