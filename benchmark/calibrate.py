"""Readings behind a cell's limits, at the cell's own size, many seeds in one
process (the benchmark's own runs do not run this):

- the program's: set-up as a run makes it, then a window of one epoch
  (training) or one pass (ranking), judged against the reference;
- the control's: the reference one step below the stated precision, put in
  the program's place;
- each planted fault's that the cell can have (training: half of each
  batch left out; a state left unchanged reads 1 by construction).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ...

Prints one JSON line a seed and a summary (``summarize``): each number's
lower and upper reading and the limit between them that the cell's
``limits/<cell>.json`` takes.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark.harness import guard, manifest  # noqa: E402
from benchmark.harness.window import Window  # noqa: E402

# A side sets a number's upper reading where its smallest reading is this
# many times the program's largest: the control three times, a planted
# fault ten times, a state left unchanged three times.
FACTOR = {"control": 3, "half_batch": 10, "state_unchanged": 3}


def seed_readings(cell, seed: int, device) -> dict:
    job = manifest.job_module(cell.job)
    t0 = time.perf_counter()
    state = job.setup(cell, seed, device)
    t1 = time.perf_counter()
    job.window(state, Window().start(), 0.0)
    t2 = time.perf_counter()
    job.release(state)
    out = {"seed": seed, "setup_s": t1 - t0, "window_s": t2 - t1,
           "program": job.check(state, device)}
    out.update(job.side_readings(state, device))
    out["check_s"] = time.perf_counter() - t2
    guard.check("calibration")
    return out


def summarize(rows: list) -> dict:
    """For each number: the lower reading (the program's largest over the
    seeds); each side's smallest; the upper reading (the smallest of those
    sides' smallest that read ``FACTOR`` times the lower or more); and a
    limit two thirds of the way from the lower to the upper in log scale
    (a lower of 0 takes a third of the upper)."""
    names = rows[0]["program"].keys()
    lower = {n: max(r["program"][n] for r in rows) for n in names}
    least = {}
    for r in rows:
        for side, d in r.items():
            if isinstance(d, dict) and side != "program":
                for n, v in d.items():
                    least.setdefault(side, {})[n] = min(v, least.get(side, {}).get(n, v))
    upper, limit = {}, {}
    for n in names:
        ups = [d[n] for side, d in least.items()
               if n in d and d[n] > 0 and d[n] >= FACTOR[side] * lower[n]]
        upper[n] = min(ups) if ups else None
        if upper[n] is not None:
            limit[n] = (math.exp((math.log(lower[n]) + 2 * math.log(upper[n])) / 3)
                        if lower[n] > 0 else upper[n] / 3)
    return {"lower": lower, "least": least, "upper": upper, "limit": limit,
            "seeds": [r["seed"] for r in rows]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = manifest.load_cell(args.workload)
    device = torch.device("cuda")
    rows = []
    for seed in args.seeds:
        rows.append(seed_readings(cell, seed, device))
        print(json.dumps(rows[-1]), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, **summarize(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
