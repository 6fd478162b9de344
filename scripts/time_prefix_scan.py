#!/usr/bin/env python3
"""Time the PyTorch port's prefix sum (K4) on one CUDA card, for this
checkout's package or another's.

Times ``prefix_cumsum`` (``csrc/prefix_scan.cu``) at the shapes the segment
sums of DGCF, DCCF and MGAT give it on sports, three ways:

- ``hot``: the mean of CUDA-event times over ``--iters`` back-to-back
  calls, as ``chip_smoke.py`` times every kernel; where the host takes
  longer to issue a call than the card takes to run it, this is the host's
  time (the host's time a call is printed beside it);
- ``graph``: the mean over ``--iters`` calls captured in one CUDA graph and
  replayed (``chip_smoke.graph_ms``): the card's time alone, with DGCF's
  and DCCF's input and output (40 and 81 MB) largely in the 50 MB L2;
- ``cold``: a CUDA graph of ``--iters`` pairs (a 256 MB write that evicts
  L2, a call) less a graph of the writes alone, over ``--iters``: the
  card's time with x read from HBM;

and one call after such a write under ``torch.profiler``, its device time
split by operation (the scratch's memset, each kernel).

Prints each time beside the bound, 8 M D bytes over 3.35 TB/s, the error
against a float64 prefix beside the gate (4 ulp of the largest |prefix| x
ceil(log2 M)), whether the bits equal the first call's, and ptxas's
register and spill counts for the kernel's build.

    python3 scripts/time_prefix_scan.py [--root DIR] [--iters 20]

``--root`` imports ``chaorec_tpu_torch`` from another checkout (a parent
tree unpacked with ``git archive``), so that two trees can be timed in
turns on one card.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

# (M, D): DGCF, DCCF, MGAT's three widths over sports' 159,101 train edges
SHAPES = {"dgcf": (159101, 32), "dccf": (159101, 64), "mgat_v": (318202, 256),
          "mgat_t": (318202, 100), "mgat": (318202, 64)}
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_prefix_scan: needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(REPO))
    from chip_smoke import graph_ms  # this tree's, whichever package is timed

    sys.path.insert(0, str(Path(args.root).resolve()))
    from chaorec_tpu_torch import kernels
    from chaorec_tpu_torch.ops.prefix_scan import prefix_cumsum

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi}; package from {Path(kernels.__file__).parent}")
    for line in kernels.build("prefix_scan").log.splitlines():
        if "registers" in line or "spill" in line:
            print("    " + line.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    for name, shape in SHAPES.items():
        x = torch.randn(shape, generator=gen, device="cuda")
        out = torch.empty_like(x)
        exact = torch.cumsum(x.double(), 0)
        first = prefix_cumsum(x).clone()
        prefix_cumsum(x, out=out)
        torch.cuda.synchronize()
        top = exact.abs().max().item()
        gate = 2.0 ** (math.floor(math.log2(top)) - 23) * 4 * math.ceil(math.log2(shape[0]))
        err = (out.double() - exact).abs().max().item()
        same = torch.equal(out, first)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            prefix_cumsum(x, out=out)
        host_us = (time.perf_counter() - t0) / args.iters * 1e6
        end.record()
        end.synchronize()
        hot = start.elapsed_time(end) / args.iters
        graph = graph_ms(lambda: prefix_cumsum(x, out=out), args.iters)

        def flushed_call():
            flush.fill_(1.0)
            prefix_cumsum(x, out=out)

        cold = graph_ms(flushed_call, args.iters) - graph_ms(lambda: flush.fill_(1.0), args.iters)
        flush.fill_(1.0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            prefix_cumsum(x, out=out)
            torch.cuda.synchronize()
        ops = [(e.key.split("<")[0].split("(")[0][:24], e.self_device_time_total / 1e3)
               for e in prof.key_averages()
               if e.self_device_time_total > 0 and "fill" not in e.key.lower()]
        split = ", ".join(f"{key} {ms:.4f}" for key, ms in ops)
        split = f"{sum(ms for _, ms in ops):.4f} ({split})"
        bound = 8 * x.numel() / PEAK_BYTES_PER_S * 1e3
        print(f"  {name} {shape}: hot {hot:.4f} ms ({100 * bound / hot:.1f}% of the {bound:.4f} "
              f"ms bound; host {host_us:.1f} us a call), graph {graph:.4f} ms "
              f"({100 * bound / graph:.1f}%), cold {cold:.4f} ms ({100 * bound / cold:.1f}%); "
              f"one cold call's device ms: {split}; err {err:.3e} (gate {gate:.3e}); same bits "
              f"in two calls: {same}", flush=True)
        del x, out, exact, first
    return 0


if __name__ == "__main__":
    sys.exit(main())
