#!/usr/bin/env python3
"""Time the PyTorch port's row-sparse Adam (K1) on one CUDA card, for this
checkout's package or another's, and print the bits of one seeded step.

At FREEDOM's four table shapes on sports (v_feat (15207, 4096) and t_feat
(15207, 384), fp32 and bf16 storage, one step of 2048 raw rows with
duplicates, rows 0 and N-1, as ``chip_smoke.row_adam_rows`` makes them),
times ``fused_row_adam`` (``csrc/row_adam.cu``) three ways:

- ``hot``: the mean of CUDA-event times over ``--iters`` back-to-back
  calls, as ``chip_smoke.py`` times every kernel (the host's time a call
  is printed beside it: where it is the longer, ``hot`` is the host's);
- ``graph``: the mean over ``--iters`` calls captured in one CUDA graph and
  replayed (``chip_smoke.graph_ms``): the card's time alone, with t_feat's
  tables (35 and 70 MB) largely in the 50 MB L2;
- ``cold``: a CUDA graph of ``--iters`` pairs (a 256 MB write that evicts
  L2, a call) less a graph of the writes alone: the card's time with the
  tables read from HBM, as a training step finds them.

Each beside the bound, 6 N D stored elements plus the batch's gradient rows
over 3.35 TB/s (``chip_smoke.row_adam_phase``'s). Before the timing, one
step from seeded tables, with the batch's gradients summed in PyTorch's
deterministic mode: the SHA-256 of p, m and v after it (two trees that
print the same digests gave the same bits), and the largest difference
from ``row_adam_reference``. Then ptxas's registers and spills of the tree's
kernel instances.

    python3 scripts/time_row_adam.py [--root DIR] [--iters 20] [--tile_rows 1,2,4]

``--root`` imports ``chaorec_tpu_torch`` from another checkout (a parent
tree unpacked with ``git archive``), so that two trees can be timed in
turns on one card. ``--tile_rows`` also times this tree's kernel at those
tile heights in place of ``ops/row_adam.tile_rows``'s choice.
"""

from __future__ import annotations

import argparse
import hashlib
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
SHAPES = {"v_feat": (15207, 4096), "t_feat": (15207, 384)}
BATCH, COUNT, LR = 2048, 5, 1e-3


def digest(t: torch.Tensor) -> str:
    """SHA-256 of a tensor's bytes (first 16 hex digits)."""
    raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return hashlib.sha256(raw.cpu().numpy().tobytes()).hexdigest()[:16]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--tile_rows", default="", help="comma-separated tile heights to time too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_row_adam: needs a CUDA card")
    sys.path.insert(0, str(REPO))
    from chip_smoke import PEAK_BYTES_PER_S, graph_ms, row_adam_rows

    sys.path.insert(0, str(Path(args.root).resolve()))
    from chaorec_tpu_torch import kernels
    from chaorec_tpu_torch.ops import row_adam as ops

    # prepare_sorted_rows sums duplicate rows' gradients by index_add_: in a
    # fixed order here, so that two trees step from the same g
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi}; package from {Path(kernels.__file__).parent}", flush=True)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    heights = [int(h) for h in args.tile_rows.split(",") if h]
    for name, (n, d) in SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device="cuda").manual_seed(n + d + dtype.itemsize)
            p = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
            m = (torch.rand((n, d), generator=gen, device="cuda") * 1e-3).to(dtype)
            v = (torch.rand((n, d), generator=gen, device="cuda") * 1e-6).to(dtype)
            rows = row_adam_rows(gen, n, BATCH, "cuda")
            g = torch.randn((BATCH, d), generator=gen, device="cuda")
            count = torch.tensor(COUNT, dtype=torch.int32, device="cuda")
            r_s, g_s = ops.prepare_sorted_rows(rows, g, n)
            want = [t.clone() for t in (p, m, v)]
            ops.row_adam_reference(*want, r_s, g_s, count, LR)
            ops.fused_row_adam(p, m, v, r_s, g_s, count, LR)
            torch.cuda.synchronize()
            err = max((a.float() - b.float()).abs().max().item() for a, b in zip((p, m, v), want))
            sums = " ".join(f"{t}={digest(x)}" for t, x in zip("pmv", (p, m, v)))
            grid = ""
            if hasattr(ops, "launch_grid"):
                grid = "; {} rows a block, {} blocks, {} an SM at once".format(
                    *ops.launch_grid(p, m, v, g_s))
            distinct = int((r_s < n).sum())
            bound = (6 * n * d * p.element_size() + distinct * d * 4 + BATCH * 4 + 4) \
                / PEAK_BYTES_PER_S * 1e3
            print(f"  {name} ({n}, {d}) {str(dtype)[6:]}{grid}: sha256 {sums}; max |kernel - "
                  f"row_adam_reference| {err:.3e}", flush=True)
            del want
            initial = [t.clone() for t in (p, m, v)]
            choose = getattr(ops, "tile_rows", None)
            for height in [None, *heights]:
                if height is not None:
                    if choose is None:
                        break
                    ops.tile_rows = lambda *_, h=height: h
                for t, t0 in zip((p, m, v), initial):
                    t.copy_(t0)  # every height from the same tables (m decays 0.9 a call)

                def call():
                    ops.fused_row_adam(p, m, v, r_s, g_s, count, LR)

                def flushed_call():
                    flush.fill_(1.0)
                    call()

                call()
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    call()
                host_us = (time.perf_counter() - t0) / args.iters * 1e6
                end.record()
                end.synchronize()
                hot = start.elapsed_time(end) / args.iters
                graph = graph_ms(call, args.iters)
                cold = (graph_ms(flushed_call, args.iters)
                        - graph_ms(lambda: flush.fill_(1.0), args.iters))
                tag = "chosen tile" if height is None else f"tile_rows {height}"
                print(f"    {tag}: hot {hot:.4f} ms ({100 * bound / hot:.1f}% of the "
                      f"{bound:.4f} ms bytes bound; host {host_us:.1f} us a call), graph "
                      f"{graph:.4f} ms ({100 * bound / graph:.1f}%), cold {cold:.4f} ms "
                      f"({100 * bound / cold:.1f}%)", flush=True)
            if choose is not None:
                ops.tile_rows = choose
            del p, m, v, g, g_s, initial
            torch.cuda.empty_cache()
    for line in kernels.build("row_adam").log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("    " + line.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
