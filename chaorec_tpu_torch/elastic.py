"""Failure recovery: a card probe and a process supervisor.

Counterpart of ``chaorec_tpu/elastic.py``. A run's common failure is its
environment (a lost card, a killed process), and a poisoned CUDA context
cannot be revived in process, so recovery is by process:

- :func:`probe_backend` finds the card in a **subprocess** with a hard
  timeout (a wedged CUDA stack can hang the first CUDA call rather than raise)
  and runs one product on it; :func:`wait_for_backend` retries it within a
  budget;
- :func:`supervise` / ``python -m chaorec_tpu_torch.elastic -- cmd...``
  runs a training command and, on a non-zero exit, waits for the card and
  relaunches it. Exact continuation comes from the checkpoints and the grid
  cursor (``train/checkpoint.py``, ``cli.py``): a relaunch with
  ``--checkpoint_dir`` resumes mid-grid and mid-run, early-stopping state
  included.

    python -m chaorec_tpu_torch.elastic --retries 2 -- \\
        python -m chaorec_tpu_torch.cli --Model FREEDOM --data_path sports \\
        --checkpoint_dir ckpt --checkpoint_every 1
"""

from __future__ import annotations

import signal
import subprocess
import sys
import threading
import time
from typing import Optional, Sequence

# argv[1] is the device; prints "gpu" for a card, "cpu" for the CPU
_PROBE = (
    "import sys, torch\n"
    "dev = torch.device(sys.argv[1])\n"
    "assert dev.type == 'cpu' or torch.cuda.is_available(), 'no CUDA card'\n"
    "x = torch.ones((128, 128), device=dev)\n"
    "assert (x @ x).sum().item() == 128.0 ** 3\n"
    "print('gpu' if dev.type == 'cuda' else 'cpu')\n"
)


def probe_backend(timeout_s: float = 300.0, device: str = "cuda") -> Optional[str]:
    """One subprocess probe of ``device``: "gpu" (a card) or "cpu", or None
    if the probe failed or hung past ``timeout_s``."""
    try:
        out = subprocess.run([sys.executable, "-c", _PROBE, device], capture_output=True,
                             text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return None
    if out.returncode != 0:
        return None
    lines = out.stdout.strip().splitlines()
    return lines[-1] if lines else None


def wait_for_backend(max_wait_s: float = 1800.0, poll_s: float = 30.0,
                     probe_timeout_s: float = 300.0, log=print) -> Optional[str]:
    """Probe the card until it answers or ``max_wait_s`` has passed;
    returns the probe's answer, or None when the budget runs out. The
    environment is never changed."""
    deadline = time.time() + max_wait_s
    attempt = 0
    while True:
        attempt += 1
        platform = probe_backend(probe_timeout_s)
        if platform is not None:
            return platform
        remaining = deadline - time.time()
        log(f"# elastic: backend probe {attempt} failed; {remaining:.0f}s left")
        if remaining <= 0:
            return None
        time.sleep(min(poll_s, max(remaining, 1.0)))


def supervise(cmd: Sequence[str], retries: int = 5, backend_wait_s: float = 1800.0,
              probe_timeout_s: float = 300.0, log=print) -> int:
    """Run ``cmd``; on failure, wait for the card and relaunch, at most
    ``retries`` times. Returns the last exit code (0 on success). SIGTERM
    and SIGINT are passed to the running child before the supervisor
    exits. The child is expected to resume where it stopped
    (``--checkpoint_dir`` and the grid cursor make the CLI do so)."""
    child = {"proc": None}
    in_main = threading.current_thread() is threading.main_thread()

    def _forward(signum, frame):
        # an outer `timeout` signals only this supervisor; without
        # forwarding, the training child would orphan and keep the card busy
        p = child["proc"]
        if p is not None and p.poll() is None:
            p.terminate()
        raise SystemExit(128 + signum)

    old = {}
    if in_main:
        for s in (signal.SIGTERM, signal.SIGINT):
            old[s] = signal.signal(s, _forward)
    try:
        attempt = 0
        while True:
            attempt += 1
            log(f"# elastic: launch attempt {attempt}: {' '.join(cmd)}")
            proc = subprocess.Popen(list(cmd))
            child["proc"] = proc
            rc = proc.wait()
            if rc == 0:
                return 0
            log(f"# elastic: attempt {attempt} exited rc={rc}")
            if attempt > retries:
                log(f"# elastic: giving up after {attempt} attempts")
                return rc
            # an expired wait relaunches anyway: the attempt budget bounds it
            platform = wait_for_backend(backend_wait_s, probe_timeout_s=probe_timeout_s,
                                        log=log)
            if platform is None:
                log("# elastic: wait expired; relaunching anyway")
            else:
                log(f"# elastic: backend back ({platform}); relaunching")
    finally:
        if in_main:
            for s, h in old.items():
                signal.signal(s, h)


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    retries, backend_wait, probe_timeout = 5, 1800.0, 300.0
    while argv and argv[0] != "--":
        if argv[0] == "--retries":
            retries = int(argv[1]); argv = argv[2:]
        elif argv[0] == "--backend-wait":
            backend_wait = float(argv[1]); argv = argv[2:]
        elif argv[0] == "--probe-timeout":
            probe_timeout = float(argv[1]); argv = argv[2:]
        else:
            raise SystemExit(f"unknown supervisor flag {argv[0]!r} "
                             "(flags: --retries N --backend-wait S --probe-timeout S -- cmd...)")
    if not argv or argv[0] != "--" or len(argv) < 2:
        raise SystemExit("usage: python -m chaorec_tpu_torch.elastic [--retries N] "
                         "[--backend-wait S] [--probe-timeout S] -- cmd arg...")
    return supervise(argv[1:], retries=retries, backend_wait_s=backend_wait,
                     probe_timeout_s=probe_timeout)


if __name__ == "__main__":
    raise SystemExit(main())
