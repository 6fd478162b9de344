"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Each lives in a file of its own under ``benchmark/``:

- ``configs/<config file>``: the model, its combo, its precision and what
  was assumed (``file`` in the manifest's ``configs`` entry);
- ``traffic/<traffic>.json``: the data set's shape, the interaction law, the
  job kind and its parameters;
- ``jobs/<job>.py``: what a window drives;
- ``metrics/<metric>.py``: the reader of one per-layer metric;
- ``limits/<workload>.json``: each compared number's limit and the readings
  it was set from (a number the job reads that the file does not name fails
  the run, unless the job declares it ``not_compared``);
- ``reference/<model>.py``: the model's plain reference.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """The Python file at ``path`` as a module (metric files carry dots in
    their names, so they are loaded by path, not imported)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass(frozen=True)
class Cell:
    """One workload with everything its files say."""

    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]  # the manifest's end-to-end metrics this cell reports
    per_layer: List[Dict]  # the manifest's per-layer metrics this cell reports
    limits: Dict

    @property
    def job(self) -> str:
        return self.traffic["job"]


def applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_manifest(path: Path = MANIFEST) -> Dict:
    return load_json(path)


def load_cell(workload: str, manifest: Dict = None) -> Cell:
    """The cell named ``workload``; a KeyError names the ones there are."""
    manifest = manifest or load_manifest()
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the manifest has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits_path = BENCH_DIR / "limits" / f"{workload}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in manifest["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in manifest["per_layer"] if applies(m, workload)],
        limits=limits)


def job_module(kind: str) -> ModuleType:
    return importlib.import_module(f"benchmark.jobs.{kind}")


def metric_module(name: str) -> ModuleType:
    return load_module(BENCH_DIR / "metrics" / f"{name}.py", "bench_metric_" + name.replace(".", "_"))


def reference_module(model: str) -> ModuleType:
    return importlib.import_module(f"benchmark.reference.{model.lower()}")


def name_errors(manifest: Dict) -> List[str]:
    """Every name, unit and one-line text of ``manifest`` that breaks the
    benchmark's character rules (empty when all keep them)."""
    errors = []

    def name(v, where):
        if not isinstance(v, str) or not NAME_RE.match(v):
            errors.append(f"{where}: bad name {v!r}")

    def line(v, where):
        if not isinstance(v, str) or not 1 <= len(v) <= 200 or "\n" in v or "\t" in v:
            errors.append(f"{where}: bad text {v!r}")

    for c in manifest["configs"]:
        name(c["name"], "config")
        line(c["source"], "config source")
        for k in c["reduced"]:
            name(k, "reduced")
    for w in manifest["workloads"]:
        for k in ("name", "config", "traffic"):
            name(w[k], f"workload {k}")
        line(w["why"], "workload why")
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        name(m["name"], "metric")
        if not UNIT_RE.match(m["unit"]):
            errors.append(f"metric {m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            errors.append(f"metric {m['name']}: better {m['better']!r}")
        if "layer" in m:
            line(m["layer"], "layer")
    for word in manifest["command"]:
        line(word, "command")
    return errors
