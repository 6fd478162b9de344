"""The port's supervisor (``chaorec_tpu_torch/elastic.py``), as
tests/test_elastic.py holds the JAX package's: the probe, the bounded wait
and the relaunch loop. The probe runs on the CPU here (``device="cpu"``;
the supervisor's tests put that probe in place of the card's), where it
answers at once; the card's probe answers only on a card.
"""

import os
import subprocess
import sys

import pytest
import torch

from chaorec_tpu_torch import elastic
from chaorec_tpu_torch.elastic import probe_backend, supervise, wait_for_backend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cpu_probe(monkeypatch):
    """The supervisor's waits probe the CPU."""
    monkeypatch.setattr(elastic, "probe_backend",
                        lambda timeout_s: probe_backend(timeout_s, device="cpu"))


def test_probe_backend_cpu():
    assert probe_backend(timeout_s=300, device="cpu") == "cpu"


def test_probe_backend_card():
    """"gpu" on a card; None without one (the product cannot run)."""
    assert probe_backend(timeout_s=300) == ("gpu" if torch.cuda.is_available() else None)


def test_probe_backend_timeout_returns_none(monkeypatch):
    monkeypatch.setattr(elastic, "_PROBE", "import time; time.sleep(30)")
    assert probe_backend(timeout_s=0.5, device="cpu") is None


def test_wait_for_backend_returns_the_probe(monkeypatch):
    answers = iter([None, None, "gpu"])
    monkeypatch.setattr(elastic, "probe_backend", lambda timeout_s: next(answers))
    msgs = []
    assert wait_for_backend(max_wait_s=60, poll_s=0.01, log=msgs.append) == "gpu"
    assert len(msgs) == 2 and all("backend probe" in m for m in msgs)


def test_expired_wait_returns_none_and_leaves_env_alone(monkeypatch):
    """The budget runs out: None, and the environment as it was (no CPU pin:
    a later attempt must still reach the card)."""
    monkeypatch.setattr(elastic, "probe_backend", lambda timeout_s: None)
    before = dict(os.environ)
    msgs = []
    assert wait_for_backend(max_wait_s=0, probe_timeout_s=300, log=msgs.append) is None
    assert dict(os.environ) == before
    assert msgs, "an expired wait explains itself"


def test_supervise_success_first_try(cpu_probe):
    assert supervise([sys.executable, "-c", "print('ok')"], retries=0, log=lambda m: None) == 0


def test_supervise_relaunches_until_success(tmp_path, cpu_probe):
    """A child that fails twice then succeeds: the supervisor relaunches
    (the checkpoints and the grid cursor make the real CLI resume exactly;
    here the marker file plays the checkpoint)."""
    marker = tmp_path / "attempts"
    child = ("import pathlib, sys; p = pathlib.Path(r'%s'); "
             "n = int(p.read_text()) if p.exists() else 0; "
             "p.write_text(str(n + 1)); sys.exit(0 if n >= 2 else 3)" % marker)
    msgs = []
    rc = supervise([sys.executable, "-c", child], retries=5, backend_wait_s=5,
                   log=msgs.append)
    assert rc == 0
    assert marker.read_text() == "3"
    assert sum("relaunching" in m for m in msgs) == 2


def test_supervise_gives_up_after_retries(cpu_probe):
    msgs = []
    rc = supervise([sys.executable, "-c", "import sys; sys.exit(7)"], retries=1,
                   backend_wait_s=1, log=msgs.append)
    assert rc == 7
    assert msgs[-1] == "# elastic: giving up after 2 attempts"


def test_supervisor_cli_entry():
    """python -m chaorec_tpu_torch.elastic -- cmd..."""
    out = subprocess.run(
        [sys.executable, "-m", "chaorec_tpu_torch.elastic", "--retries", "0", "--",
         sys.executable, "-c", "print('supervised-ok')"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "supervised-ok" in out.stdout
    bad = subprocess.run([sys.executable, "-m", "chaorec_tpu_torch.elastic", "--bogus", "1"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert bad.returncode != 0 and "unknown supervisor flag" in bad.stderr
