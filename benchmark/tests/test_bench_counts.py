"""The operation and byte counts behind the rooflines and the MFU, against
hand counts."""

from __future__ import annotations

import pytest

from benchmark.harness import peaks
from benchmark.reference import lightgcn, sgl


def test_lse_bound_matches_the_kernel_table():
    # PERF.md's kernel table: K2 at SGL's user side on sports
    fwd, kind = peaks.lse_bound(1024, 28940, 64, "fwd")
    assert kind == "operations" and fwd == pytest.approx(0.0566, abs=5e-5)
    assert peaks.lse_bound(1024, 28940, 64, "dq")[0] == pytest.approx(0.1132, abs=5e-5)
    assert peaks.lse_bound(1024, 28940, 64, "dk")[0] == pytest.approx(0.1132, abs=5e-5)
    assert peaks.k2_call_bound_ms(1024, 28940, 64) == pytest.approx(
        (2 + 4 + 4) * 1024 * 28940 * 64 / 67e12 * 1e3)


def test_bound_picks_bytes_when_they_bind():
    ms, kind = peaks.bound_ms(1.0, 3.35e9)
    assert kind == "bytes" and ms == pytest.approx(1.0)


def test_step_flops_by_hand():
    combo = {"dim_E": 64, "n_layers": 3}
    u, i, e, b = 28940, 15207, 260623, 1024
    one_graph = 3 * 2 * 2 * (2 * e * 64)  # layers, fwd+bwd, two sides, 2 flops an edge and column
    bpr = 3 * 2 * 2 * b * 64
    assert lightgcn.step_flops(combo, u, i, e, b) == pytest.approx(one_graph + bpr)
    k2 = 6 * b * 64 * (u + i)
    assert sgl.step_flops(combo, u, i, e, b) == pytest.approx(2.8 * one_graph + bpr + k2)
    assert sgl.k2_calls(combo, u, i, b) == [(b, u, 64), (b, i, 64)]
    assert lightgcn.k2_calls(combo, u, i, b) == []
