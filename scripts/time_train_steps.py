#!/usr/bin/env python3
"""Time one training step of each model the PyTorch port trains, on one
CUDA card, with and without the trainer's deterministic mode, and check
that two runs on one seed give the same bits; for this checkout's package
or another's.

Each model is built as ``chip_smoke.py``'s CLI runs train it
(``chip_smoke.path_config``: CF_Diff on the baby-sized set, the others at
their first Model_YAML combo on the sports-sized set). After ``--warmup``
steps, ``--steps`` steps of ``Trainer.train_step`` on fixed batches are
timed by the host's clock up to a synchronize (``wall``), and
``--profiled`` more under ``torch.profiler`` give the card's busy time a
step (``device``, the sum of its kernels' times). Where the package has
the deterministic mode (``train/loop.py:deterministic_mode``), the step
runs with it (``on``, as the trainer runs) and without it (``off``,
``Trainer.train_step.__wrapped__``), in turns off, on, on, off; a package
without it runs ``off`` twice. Then ``chip_smoke.seeded_run`` trains two
fresh trainers on one seed (CF_Diff one epoch, the others
``chip_smoke.DET_STEPS`` steps) and evaluates: whether the loss bits and the
rank lists are equal.

    python3 scripts/time_train_steps.py [--root DIR] [--models SGL NCL]

``--root`` imports ``chaorec_tpu_torch`` from another checkout (a parent
tree unpacked with ``git archive``), so that two trees can be timed in
turns on one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--models", nargs="*", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data_root", default="")
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--profiled", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_train_steps: needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    sys.path.insert(0, str(Path(args.root).resolve()))
    from chaorec_tpu_torch import kernels
    from chaorec_tpu_torch.data.sampling import (make_edge_batches, make_epoch_batches,
                                                 sample_negatives)
    from chaorec_tpu_torch.models import build_model
    from chaorec_tpu_torch.train import loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    has_mode = hasattr(loop, "deterministic_mode")
    print(f"{smi}; package from {Path(kernels.__file__).parent}; deterministic mode: "
          f"{'yes' if has_mode else 'no'}", flush=True)
    device = torch.device("cuda", 0)
    datasets = {cs.DATASET: cs.synthetic_dataset(cs.DATASET, args.seed),
                cs.FREEDOM_DATASET: cs.sports_dataset(args)}
    step_on = loop.Trainer.train_step
    step_off = getattr(step_on, "__wrapped__", step_on)
    for name in args.models or cs.DET_MODELS:
        cfg, ds_name = cs.path_config(name, args)
        ds = datasets[ds_name]
        model = build_model(cfg, ds, device)
        trainer = loop.Trainer(model, ds, cfg)
        params = trainer.init_params()
        opt = trainer.make_optimizer(params)
        model.pre_epoch(params, 0)
        n = args.warmup + args.steps + args.profiled
        if trainer.user_rows:
            batches = make_epoch_batches(trainer.generator, ds.num_user, cfg.batch_size)
        else:
            batches = [dataclasses.replace(b, neg_items=sample_negatives(
                trainer.generator, b.users, trainer.history, model.num_item,
                int(cfg.neg_candidates)))
                for b in make_edge_batches(trainer.generator, trainer.edges, cfg.batch_size)[:n]]
        batches = (batches * -(-n // len(batches)))[:n]
        result = {"model": name, "batch": cfg.batch_size}
        for mode in ("off", "on", "on", "off") if has_mode else ("off", "off"):
            step = step_on if mode == "on" else step_off
            for b in batches[:args.warmup]:
                step(trainer, params, opt, b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in batches[args.warmup:args.warmup + args.steps]:
                step(trainer, params, opt, b)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / args.steps * 1e3
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for b in batches[args.warmup + args.steps:]:
                    step(trainer, params, opt, b)
                torch.cuda.synchronize()
            busy = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                       and not getattr(e, "is_user_annotation", False)) / 1e3 / args.profiled
            result.setdefault(f"wall_ms_{mode}", []).append(round(wall, 3))
            result.setdefault(f"device_ms_{mode}", []).append(round(busy, 3))
        del model, trainer, params, opt, batches
        torch.cuda.empty_cache()
        steps = None if name == "CF_Diff" else cs.DET_STEPS
        (l1, r1, s1), (l2, r2, _) = (cs.seeded_run(cfg, ds, device, steps) for _ in range(2))
        result.update(
            same_seed_runs="1 epoch" if steps is None else f"{steps} steps",
            equal_loss_bits=bool(np.array_equal(l1.view(np.int32), l2.view(np.int32))),
            equal_rank_lists=bool(np.array_equal(r1, r2)),
            loss_ulps_apart=int(np.abs(l1.view(np.int32).astype(np.int64)
                                       - l2.view(np.int32).astype(np.int64)).max()),
            run_s=round(s1, 3))
        print(json.dumps(result), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
