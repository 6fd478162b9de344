"""The port imports neither jax nor the JAX package, directly or indirectly.

Checked in a fresh interpreter: every module of chaorec_tpu_torch, and
chip_smoke.py, is imported and ``sys.modules`` is inspected.
"""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

PROBE = """
import importlib, pkgutil, sys
import chaorec_tpu_torch
names = [m.name for m in pkgutil.walk_packages(chaorec_tpu_torch.__path__, "chaorec_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "chaorec_tpu"))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_port_never_imports_jax():
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 99, proc.stdout
