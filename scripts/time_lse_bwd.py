#!/usr/bin/env python3
"""Time the PyTorch port's streaming logsumexp kernels (K2) on one CUDA
card, for this checkout's package or another's.

At SGL's two shapes on sports (q (1024, 64) over the temperature 0.1
against k (28940, 64), the user side, and (15207, 64), the item side),
times the forward, dq and dk wrappers (``ops/streaming_lse.py``) two ways:

- ``hot``: the mean of CUDA-event times over ``--iters`` back-to-back
  calls, as ``chip_smoke.py`` times every kernel (each call includes its
  combine pass and the wrapper's allocations);
- ``graph``: the mean over ``--iters`` calls captured in one CUDA graph and
  replayed (``chip_smoke.graph_ms``): the card's time alone.

Prints each beside the fp32 bound of ``chip_smoke.lse_bound`` and its
share, dq's and dk's largest error over the largest plain entry beside the
gate (1e-5), whether two calls give the same bits, and ptxas's registers
and spills for the tree's dq and dk kernels.

    python3 scripts/time_lse_bwd.py [--root DIR] [--iters 20]

``--root`` imports ``chaorec_tpu_torch`` from another checkout (a parent
tree unpacked with ``git archive``), so that two trees can be timed in
turns on one card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
SHAPES = {"user": (1024, 28940, 64), "item": (1024, 15207, 64)}
TEMPERATURE = 0.1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_lse_bwd: needs a CUDA card")
    sys.path.insert(0, str(REPO))
    from chip_smoke import graph_ms, lse_bound, lse_inputs, ptxas_entries

    sys.path.insert(0, str(Path(args.root).resolve()))
    from chaorec_tpu_torch import kernels
    from chaorec_tpu_torch.ops import streaming_lse as lse_ops

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi}; package from {Path(kernels.__file__).parent}", flush=True)
    for frag in ("lse_bwd64_kernel", "lse_dq_kernel", "lse_dk_kernel"):
        for entry, regs, spill in ptxas_entries("streaming_lse", frag):
            print(f"    ptxas {entry}: {regs}; {spill}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for side, (b, n, e) in SHAPES.items():
        q, k, g = lse_inputs(gen, (b, n, e, TEMPERATURE, True), "cuda")
        q, k = q.detach(), k.detach()
        lse = lse_ops.streaming_lse_fwd(q, k)
        kq, kk = q.clone().requires_grad_(), k.clone().requires_grad_()
        want = torch.autograd.grad(lse_ops.streaming_logsumexp_reference(kq, kk), (kq, kk), g)
        calls = {"fwd": lambda: lse_ops.streaming_lse_fwd(q, k),
                 "dq": lambda: lse_ops.streaming_lse_dq(q, k, lse, g),
                 "dk": lambda: lse_ops.streaming_lse_dk(q, k, lse, g)}
        for kernel, fn in calls.items():
            first, second = fn(), fn()
            same = torch.equal(first, second)
            err = ""
            if kernel != "fwd":
                w = want[0 if kernel == "dq" else 1]
                rel = ((first - w).abs().max() / w.abs().max()).item()
                err = f"; max abs err / max |plain| {rel:.2e} (gate 1e-05)"
            fn()
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(args.iters):
                fn()
            end.record()
            end.synchronize()
            hot = start.elapsed_time(end) / args.iters
            graph = graph_ms(fn, args.iters)
            bound, by = lse_bound(b, n, e, kernel)
            print(f"  {kernel} {side} ({b}, {n}, {e}): hot {hot:.4f} ms ({100 * bound / hot:.1f}% "
                  f"of the {bound:.4f} ms {by} bound), graph {graph:.4f} ms "
                  f"({100 * bound / graph:.1f}%); same bits in two calls: {same}{err}",
                  flush=True)
        del q, k, g, lse, kq, kk, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
