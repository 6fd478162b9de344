"""The limit rule of ``calibrate.summarize``: the lower reading is the
program's largest, a side sets the upper reading only where its smallest
reads its factor times the lower, and the limit lies two thirds of the way
up in log scale."""

from __future__ import annotations

import pytest

from benchmark.calibrate import summarize


def row(seed, prog, control, half=None):
    r = {"seed": seed, "program": prog, "control": control}
    if half is not None:
        r["half_batch"] = half
    return r


def test_upper_from_the_smallest_side_past_its_factor():
    rows = [row(1, {"a": 1e-7, "b": 1e-7}, {"a": 1e-5, "b": 2e-7}, {"a": 0.5, "b": 0.3}),
            row(2, {"a": 2e-7, "b": 1e-7}, {"a": 4e-6, "b": 5e-7}, {"a": 0.4, "b": 0.2})]
    s = summarize(rows)
    assert s["lower"] == {"a": 2e-7, "b": 1e-7}
    assert s["upper"]["a"] == pytest.approx(4e-6)  # the control's smallest, 20 times the lower
    assert s["upper"]["b"] == pytest.approx(0.2)  # the control's smallest is 2 times: the fault's
    assert 2e-7 < s["limit"]["a"] < 4e-6
    assert s["limit"]["a"] == pytest.approx((2e-7 * 4e-6 ** 2) ** (1 / 3))


def test_no_upper_no_limit():
    s = summarize([row(1, {"a": 0.0}, {"a": 0.0}, {"a": 0.0})])
    assert s["upper"]["a"] is None and "a" not in s["limit"]
