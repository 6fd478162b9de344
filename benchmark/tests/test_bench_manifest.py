"""The manifest and the files it names: they load, keep the character rules,
and every cell finds its configuration, traffic, job, limits, reference and
per-layer readers."""

from __future__ import annotations

import json

import pytest

from benchmark.harness import manifest

M = manifest.load_manifest()
CELLS = [w["name"] for w in M["workloads"]]
WIDTH_WORDS = ("dim", "hidden", "intermediate", "latent", "state", "proj", "head", "rank")


def test_manifest_keys_and_names():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert manifest.name_errors(M) == []
    assert M["paths"] == ["benchmark"] and M["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) < 64 * 1024


def test_configs_are_whole_width():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/")
        data = manifest.load_json(manifest.ROOT / c["file"])
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"] == []
        assert not any(w in k for k in c["reduced"] for w in WIDTH_WORDS)


def test_metrics_and_cells():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(names) == len(set(names)) and len(CELLS) == len(set(CELLS))
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs)) and all(w["chips"] == 1 for w in M["workloads"])
    for m in M["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        for w in m.get("workloads", CELLS):
            assert manifest.applies(e2e[m["moves"]], w), (m["name"], w)


@pytest.mark.parametrize("name", CELLS)
def test_cell_files(name):
    cell = manifest.load_cell(name)
    job = manifest.job_module(cell.job)
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert all(m in job.E2E for m in e2e if m != "setup_s")
    for m in cell.per_layer:
        assert callable(manifest.metric_module(m["name"]).read)
    ref = manifest.reference_module(cell.config["model"])
    assert callable(ref.step_flops) and callable(ref.k2_calls)
    assert cell.limits and all(v["lower"] < v["limit"] < v["upper"]
                               for v in cell.limits.values())
    # every number the job reads has its limit, but those the cell declares
    # not compared (a number with no limit fails a run)
    assert set(cell.limits) == set(job.NUMBERS) - set(job.not_compared(cell))
    for key in ("num_user", "num_item", "train_items_per_user", "sizes_seed"):
        assert key in cell.traffic
