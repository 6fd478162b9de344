#!/usr/bin/env python3
"""Time the PyTorch port's attention backward on one CUDA card, for its
source and for variants of it.

Times ``csrc/fused_mha_bwd.cu`` (through ``ops/fused_attn._launch_bwd``) at
CF_Diff's training batch, (B, 4, 1034, 1034, 4) at keep 0.5 and 1.0, as
the mean of CUDA-event times over 5 calls after one warm-up, and splits
one call into its dq and dk/dv kernels with ``torch.profiler``. A variant
is the same source with some of its ``constexpr int`` constants changed,
built with the port's own nvcc flags in a temporary directory; its dq, dk
and dv are compared bit for bit with the source's. The source and the
variants run in turns, then again in reverse order, and each run prints
ptxas's register and spill counts.

    python3 scripts/time_attn_bwd.py [--batch 1024] [VARIANT ...]

A VARIANT is NAME=VALUE[,NAME=VALUE...] of the file's constants, for
example ``kKeys=2`` or ``kMaxRows=512,kKeyWarps=12``.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chaorec_tpu_torch import kernels  # noqa: E402
from chaorec_tpu_torch.ops import fused_attn  # noqa: E402

SOURCE = "fused_mha_bwd"


def use_source(csrc: Path, build: Path) -> None:
    """Point the port's kernel loader at ``csrc`` and print what ptxas said."""
    kernels.CSRC_DIR, kernels.BUILD_DIR = csrc, build
    kernels.build.cache_clear()
    kernels.load.cache_clear()
    fused_attn._bwd_fn.cache_clear()
    for line in kernels.build(SOURCE).log.splitlines():
        if "registers" in line or "spill" in line:
            print("    " + line.strip())


def make_variant(spec: str, root: Path) -> Path:
    """A copy of csrc/ with the constants of ``spec`` changed."""
    out = root / re.sub(r"\W", "_", spec)
    shutil.copytree(kernels.CSRC_DIR, out)
    path = out / f"{SOURCE}.cu"
    text = path.read_text()
    for pair in spec.split(","):
        name, value = pair.split("=")
        text, n = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{int(value)};", text)
        if n != 1:
            raise SystemExit(f"no constant {name} in {path.name}")
    path.write_text(text)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_attn_bwd: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (args.batch, 4, 1034, 4)
    q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda") for _ in range(4))
    seed = torch.tensor([17], device="cuda")
    fwd = {keep: fused_attn._launch_fwd(q, k, v, seed if keep < 1 else None, keep, with_lse=True)
           for keep in (0.5, 1.0)}
    first = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        sources = [("source", kernels.CSRC_DIR)]
        sources += [(spec, make_variant(spec, root)) for spec in args.variants]
        for name, csrc in sources + sources[::-1]:
            print(f"{name}:")
            use_source(csrc, root / "build" / re.sub(r"\W", "_", name))
            for keep in (0.5, 1.0):
                out, lse = fwd[keep]

                def call():
                    return fused_attn._launch_bwd(q, k, v, out, dout, lse, seed, keep)[:3]

                got = call()
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, first.setdefault(keep, got)))
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(5):
                    call()
                end.record()
                end.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    call()
                    torch.cuda.synchronize()
                split = ", ".join(
                    f"{e.key.split('<')[0].split('::')[-1]} {e.self_device_time_total / 1e3:.3f} ms"
                    for e in prof.key_averages() if e.self_device_time_total > 0)
                print(f"  keep {keep}: backward {start.elapsed_time(end) / 5:.3f} ms ({split}); "
                      f"same bits as the source: {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
