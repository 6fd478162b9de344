#!/usr/bin/env python3
"""Time the training steps and epochs of the port's segment-sum models on
one CUDA card.

Builds DGCF, DCCF and MGAT (the first combo of each Model_YAML grid) on the
synthetic sports-sized set that ``chip_smoke.py`` trains them on. Their K4
(the prefix sum, ``csrc/prefix_scan.cu``) runs 24, 8 and 18 times a step.
For each model:

- one batch of 1024 edges through ``Trainer.train_step``: 5 times to warm
  up, ``--steps`` times with a synchronize after each (the median and the
  least wall of a step), and ``--steps`` times back to back with one
  synchronize at the end (the mean: a step's cost when the host runs ahead);
- one warm-up epoch (``Trainer.train_epoch``), then ``--epochs`` epochs of
  the same loop with the host's time split three ways: making the batches
  and their negatives (``prep``), issuing each ``train_step`` (``issue``:
  the host's own work, plus any wait on the card inside the step), and the
  epoch's closing sync (``tail``: the card's backlog when the host is done);
- one more epoch under ``torch.profiler``: the card's busy time (every
  kernel's and copy's device time) and K4's part of it, so that the idle
  share of an epoch is 1 - busy / the mean wall of the timed epochs.

    python3 scripts/time_seg_steps.py [--root DIR] [--steps 30] [--epochs 3]

``--root`` runs the package and ``chip_smoke.py`` of another checkout (a
parent tree unpacked with ``git archive``), so that two trees can be timed
in turns on one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

# kernel names of K4: the one-pass kernel, and the three passes it replaced
K4_KERNELS = ("lookback_scan", "group_sums", "carry_kernel", "scan_kernel")


def timed_epoch(trainer, params, opt, sample_negatives, make_edge_batches) -> dict:
    """``Trainer.train_epoch``'s loop over edge batches, with its host time
    split into prep, issue and tail (seconds)."""
    bs, k = int(trainer.cfg.batch_size), int(trainer.cfg.neg_candidates)
    t_start = time.perf_counter()
    prep = issue = 0.0
    batches = make_edge_batches(trainer.generator, trainer.edges, bs)
    prep += time.perf_counter() - t_start
    losses = []
    for batch in batches:
        t0 = time.perf_counter()
        neg = sample_negatives(trainer.generator, batch.users, trainer.history,
                               trainer.model.num_item, k)
        t1 = time.perf_counter()
        losses.append(trainer.train_step(params, opt,
                                         dataclasses.replace(batch, neg_items=neg)).detach())
        t2 = time.perf_counter()
        prep, issue = prep + t1 - t0, issue + t2 - t1
    t3 = time.perf_counter()
    float(torch.stack(losses).sum())
    t4 = time.perf_counter()
    return dict(wall=t4 - t_start, prep=prep, issue=issue, tail=t4 - t3, batches=len(batches))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--epochs", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_seg_steps: needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import chip_smoke
    from chaorec_tpu_torch.config import Config
    from chaorec_tpu_torch.data.sampling import make_edge_batches, sample_negatives
    from chaorec_tpu_torch.models import build_model
    from chaorec_tpu_torch.train.loop import Trainer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi}; package from {root}", flush=True)
    fds = chip_smoke.sports_dataset(argparse.Namespace(seed=0, data_root="", out_dir=""))
    for name in ("DGCF", "DCCF", "MGAT"):
        combo, _ = chip_smoke.first_combo(name)
        cfg = Config(Model=name, data_path=chip_smoke.FREEDOM_DATASET, seed=0,
                     num_epoch=1).replace(**combo, export_artifact="")
        model = build_model(cfg, fds, "cuda")
        trainer = Trainer(model, fds, cfg)
        init = trainer.init_params()
        batch = make_edge_batches(trainer.generator, trainer.edges, cfg.batch_size)[0]
        batch = dataclasses.replace(batch, neg_items=sample_negatives(
            trainer.generator, batch.users, trainer.history, model.num_item, cfg.neg_candidates))
        params = {n: t.detach().clone().requires_grad_() for n, t in init.items()}
        opt = trainer.make_optimizer(params)
        for _ in range(5):
            trainer.train_step(params, opt, batch)
        torch.cuda.synchronize()
        walls = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            trainer.train_step(params, opt, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            trainer.train_step(params, opt, batch)
        torch.cuda.synchronize()
        ahead = (time.perf_counter() - t0) / args.steps
        print(f"{name}: step wall median {1e3 * statistics.median(walls):.2f} ms (least "
              f"{1e3 * min(walls):.2f}); {args.steps} steps back to back {1e3 * ahead:.2f} ms a "
              "step", flush=True)

        trainer.train_epoch(params, opt)
        epochs = [timed_epoch(trainer, params, opt, sample_negatives, make_edge_batches)
                  for _ in range(args.epochs)]
        for i, e in enumerate(epochs):
            print(f"{name}: epoch {i + 1} of {e['batches']} batches: wall {e['wall']:.3f} s = prep "
                  f"{e['prep']:.3f} + issue {e['issue']:.3f} + tail {e['tail']:.3f} s; issue "
                  f"{1e3 * e['issue'] / e['batches']:.2f} ms a step", flush=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            trainer.train_epoch(params, opt)
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in events) / 1e6
        k4 = sum(e.self_device_time_total for e in events
                 if any(k in e.key for k in K4_KERNELS)) / 1e6
        wall = statistics.mean(e["wall"] for e in epochs)
        print(f"{name}: profiled epoch: device busy {busy:.3f} s (K4 {k4:.3f} s); idle share of "
              f"the timed epochs' mean wall {wall:.3f} s: {100 * (1 - busy / wall):.1f}%",
              flush=True)
        del model, trainer, init, params, opt, prof
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
