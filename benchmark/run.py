"""Run one cell of the benchmark of ``chaorec_tpu_torch`` on one NVIDIA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Each run is a new process: it draws the cell's inputs from the seed, builds
the program's model and trainer, warms every shape it will use (all of it
``setup_s``), runs the measured window, then judges what the window's path
produced against the plain reference, and prints one JSON line last on
standard output. With ``--trace 0`` its metrics are the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` trace of the window. See ``benchmark/README.md``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"  # fixed paths inside the checkout
if __name__ == "__main__":
    # the bytecode of every module a run imports, kept in the checkout: an
    # installation that keeps none (or an environment that forbids writing
    # it) makes each process compile PyTorch's sources again, about 6 s of
    # set-up on the benchmark's H100 machine
    sys.pycache_prefix = str(CACHE / "pycache")
    sys.dont_write_bytecode = False
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(CACHE / "torch_kernels")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark.harness import guard, manifest  # noqa: E402
from benchmark.harness.checks import Report  # noqa: E402
from benchmark.harness.window import Window  # noqa: E402

EXIT_NO_CARD, EXIT_FORBIDDEN = 3, 4
# Few host threads, so that a run's load on a shared host is one process's
# few cores; on the benchmark's H100 machine 2 threads and PyTorch's default
# 8 gave the same rates and set-up (PERF.md, section 5)
HOST_THREADS = 2


def say(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def k2_launches():
    from chaorec_tpu_torch.ops.streaming_lse import (streaming_lse_dk, streaming_lse_dq,
                                                     streaming_lse_fwd)

    return {"fwd": streaming_lse_fwd.launches, "dq": streaming_lse_dq.launches,
            "dk": streaming_lse_dk.launches}


def card_state() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


class SetupClock:
    """The set-up's parts: the seconds from one mark to the next."""

    def __init__(self, t_start: float):
        self.last = t_start
        self.parts = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.parts[name] = self.parts.get(name, 0.0) + now - self.last
        self.last = now

    def line(self) -> str:
        return ", ".join(f"{k} {v:.3f}" for k, v in self.parts.items())


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             cell=None, t_start: float = None) -> dict:
    """One run of ``workload``; returns the result line's object. ``cell``
    (a ``manifest.Cell``) stands in for the manifest's, as the tests give
    one at a small size; ``device`` "cpu" runs the kernels' plain versions."""
    t_start = T_START if t_start is None else t_start
    clock = SetupClock(t_start)
    cell = cell or manifest.load_cell(workload)
    job = manifest.job_module(cell.job)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else None
    clock.mark("python_and_torch_import")
    if cuda:
        torch.cuda.init()
        torch.empty(1, device=dev)
        torch.cuda.synchronize(dev)
    clock.mark("cuda_init")

    state = job.setup(cell, seed, dev, clock.mark)
    guard.check("set-up")
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    clock.mark("rest")
    say(f"{workload}: seed {seed}, set-up {setup_s:.3f} s: {clock.line()}")

    launches0 = k2_launches()
    win = Window(sync)
    prof = None
    if trace:
        from benchmark.harness import trace as tr

        prof = tr.profiler(dev.type)
    with torch.profiler.record_function("bench.window"):
        win.start()
        job.window(state, win, seconds)
        win.stop()
    if prof is not None:
        prof.stop()
    launches = {k: v - launches0[k] for k, v in k2_launches().items()}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    say(f"{workload}: window {win.seconds:.3f} s, units {win.units}, launches {launches}, "
        f"peak {peak} B; card {card_state() if cuda else 'none'}")
    guard.check("window")

    out = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                out["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            else:
                out[m["name"]] = {"value": win.rate(job.E2E[m["name"]]), "unit": m["unit"]}
    breakdown = None
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        summary = tr.summarize(prof)
        del prof
        ctx = SimpleNamespace(trace=summary, win=win, cell=cell, cat=state.cat,
                              launches=launches,
                              ref=manifest.reference_module(cell.config["model"]))
        for m in cell.per_layer:
            v = manifest.metric_module(m["name"]).read(ctx)
            if v is not None:
                out[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
        breakdown = summary.breakdown()

    job.release(state)
    if cuda:
        torch.cuda.empty_cache()
    report = Report(cell.limits)
    aside = job.not_compared(cell)
    for name, value in job.check(state, dev).items():
        if name in aside:
            say(f"reading {name}: {value!r}, not compared: {aside[name]}")
        else:  # a number with no limit fails
            report.add(name, value)
    failed = int(win.units.get("failed", 0))
    result = {"correct": bool(report.ok and failed == 0), "attempted": job.attempted(win),
              "failed": failed, "metrics": out, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = report.as_dict()
    report.print_lines()
    guard.check("the comparison")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = manifest.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        say(f"{args.workload} needs {cell.chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return EXIT_NO_CARD
    torch.set_num_threads(HOST_THREADS)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), cell=cell)
    except guard.ForbiddenImport as e:
        say(f"forbidden import: {e}; no result")
        return EXIT_FORBIDDEN
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
