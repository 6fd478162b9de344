"""The import guard compares whole top-level names, and a run's modules,
the port's included, load no JAX."""

from __future__ import annotations

import subprocess
import sys

from benchmark.harness import guard
from benchmark.tests.conftest import ROOT


def test_whole_top_level_names():
    names = ["chaorec_tpu_torch", "chaorec_tpu_torch.ops", "jaxtyping", "numpy"]
    assert guard.forbidden_modules(names) == []
    assert guard.forbidden_modules(names + ["chaorec_tpu.models", "jax.numpy", "jaxlib",
                                            "flax"]) == [
        "chaorec_tpu.models", "flax", "jax.numpy", "jaxlib"]


def test_a_run_loads_no_jax():
    code = ("import sys; sys.argv = ['x']; import benchmark.run, benchmark.calibrate; "
            "from benchmark.jobs import train, rank; import chaorec_tpu_torch.models.builders; "
            "import chaorec_tpu_torch.train.loop; from benchmark.harness import guard; "
            "print(guard.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.sgl, benchmark.reference.lightgcn, "
            "benchmark.reference.rank, benchmark.reference.train; "
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('chaorec')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
