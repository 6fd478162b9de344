#!/usr/bin/env python3
"""Time the PyTorch port's streaming logsumexp kernels (K2) on one CUDA
card, for this checkout's package or another's.

At SGL's two shapes on sports (q (1024, 64) over the temperature 0.1
against k (28940, 64), the user side, and (15207, 64), the item side),
times the forward, dq and dk wrappers (``ops/streaming_lse.py``) two ways:

- ``hot``: the mean of CUDA-event times over ``--iters`` back-to-back
  calls, as ``chip_smoke.py`` times every kernel (each call includes its
  combine pass and the wrapper's allocations; the host's time a call is
  printed beside it: where it is the longer, ``hot`` is the host's);
- ``graph``: the mean over ``--iters`` calls captured in one CUDA graph and
  replayed (``chip_smoke.graph_ms``): the card's time alone.

Prints each beside the fp32 bound of ``chip_smoke.lse_bound`` and its
share, the forward's largest error share of its gate (rtol/atol 1e-5) and
dq's and dk's largest error over the largest plain entry beside theirs
(1e-5), whether two calls give the same bits, the kernel the forward ran,
and ptxas's registers and spills for the tree's kernels.

``--extra_shapes`` adds NCL's prototype term (q (1024, 64) over the
temperature 0.01 against 200 centroids: forward and dq, as NCL runs it) and
the ragged last batch of an epoch (381 rows against the item side: the
forward), where a block has little work.

    python3 scripts/time_lse_bwd.py [--root DIR] [--iters 20] [--extra_shapes]

``--root`` imports ``chaorec_tpu_torch`` from another checkout (a parent
tree unpacked with ``git archive``), so that two trees can be timed in
turns on one card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
# side: (B, N, E, temperature, kernels timed)
SHAPES = {"user": (1024, 28940, 64, 0.1, ("fwd", "dq", "dk")),
          "item": (1024, 15207, 64, 0.1, ("fwd", "dq", "dk"))}
EXTRA_SHAPES = {"prototypes": (1024, 200, 64, 0.01, ("fwd", "dq")),
                "ragged": (381, 15207, 64, 0.1, ("fwd",))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--extra_shapes", action="store_true",
                    help="also NCL's prototypes (forward, dq) and the ragged batch (forward)")
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
    for frag in ("lse_fwd64_kernel", "lse_fwd_kernel", "lse_bwd64_kernel", "lse_dq_kernel",
                 "lse_dk_kernel"):
        for entry, regs, spill in ptxas_entries("streaming_lse", frag):
            print(f"    ptxas {entry}: {regs}; {spill}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = {**SHAPES, **(EXTRA_SHAPES if args.extra_shapes else {})}
    for side, (b, n, e, temp, kernels_timed) in shapes.items():
        q, k, g = lse_inputs(gen, (b, n, e, temp, True), "cuda")
        q, k = q.detach(), k.detach()
        lse = lse_ops.streaming_lse_fwd(q, k)
        kq, kk = q.clone().requires_grad_(), k.clone().requires_grad_()
        plain = lse_ops.streaming_logsumexp_reference(kq, kk)
        want = torch.autograd.grad(plain, (kq, kk), g)
        # a parent tree without forward_layout ran the generic forward
        layout = getattr(lse_ops, "forward_layout", lambda *_: ("lse_fwd_kernel",))
        calls = {"fwd": lambda: lse_ops.streaming_lse_fwd(q, k),
                 "dq": lambda: lse_ops.streaming_lse_dq(q, k, lse, g),
                 "dk": lambda: lse_ops.streaming_lse_dk(q, k, lse, g)}
        for kernel in kernels_timed:
            fn = calls[kernel]
            first, second = fn(), fn()
            same = torch.equal(first, second)
            if kernel == "fwd":
                w = plain.detach()
                share = ((first - w).abs() / (1e-5 + 1e-5 * w.abs())).max().item()
                err = f"; by {layout(q, k, sms)[0]}; err {share:.3f} of rtol/atol 1e-5"
            else:
                w = want[0 if kernel == "dq" else 1]
                rel = ((first - w).abs().max() / w.abs().max()).item()
                err = f"; max abs err / max |plain| {rel:.2e} (gate 1e-05)"
            fn()
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            t0 = time.perf_counter()
            for _ in range(args.iters):
                fn()
            host_us = (time.perf_counter() - t0) / args.iters * 1e6
            end.record()
            end.synchronize()
            hot = start.elapsed_time(end) / args.iters
            graph = graph_ms(fn, args.iters)
            bound, by = lse_bound(b, n, e, kernel)
            print(f"  {kernel} {side} ({b}, {n}, {e}): hot {hot:.4f} ms ({100 * bound / hot:.1f}% "
                  f"of the {bound:.4f} ms {by} bound; host {host_us:.1f} us a call), graph "
                  f"{graph:.4f} ms "
                  f"({100 * bound / graph:.1f}%); same bits in two calls: {same}{err}",
                  flush=True)
        del q, k, g, lse, kq, kk, plain, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
