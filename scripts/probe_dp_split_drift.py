#!/usr/bin/env python3
"""How far a dp split moves a model's epoch, beside a mere reordering and
beside a broken split.

A dp split (``parallel/mesh.py``) sums each batch's gradient as two
slices' scaled parts: the same gradient up to the order of its sums (and,
under bf16 graph products, one bf16 rounding of each slice's propagated
gradient, ``ops/mxu.py``). This probe trains one epoch of a model's first
Model_YAML combo on a seeded synthetic set from one seed, in one process:

- ``one``: as one device does (the reference);
- ``permuted``: each batch's rows permuted (the same loss, summed in
  another order);
- ``split``: the loss taken as the two dp=2 slices' scaled parts
  (``split_rows``, each slice from the same generator state, as the
  ranks draw);
- two planted faults: ``same_half``, both ranks on slice 0 (a rank that
  ignores its dp index: the second half's rows never train, and the
  replicated params still agree across ranks), and ``no_unshare``, each
  slice's summed terms not divided by its share (``Batch.share`` unset).

With ``--mesh`` the split and both faults also run as real dp=2 worlds:
the CLI's ranks (``cli.run_rank``, gloo), spawned here as the CLI spawns
them, the faults planted by patching ``train/loop.py``'s ``shard_batch``
in each rank; each is compared with one device's ``Trainer.run`` (as
``chip_smoke.py`` phase 72 compares).

For each run: its epoch loss and relative difference from the
reference's, each param's largest difference, the users whose top-k list
differs and the mean share of a user's list kept.

    python3 scripts/probe_dp_split_drift.py [--model SGL] [--users 3000]
        [--items 1500] [--sports] [--device cpu] [--mesh]

``--sports`` takes ``chip_smoke.py``'s sports-sized set (28940 x 15207,
seed 0) instead; on the card: ``--sports --device cuda --mesh``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import types

import torch
import torch.multiprocessing as torch_mp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from chaorec_tpu_torch import cli  # noqa: E402
from chaorec_tpu_torch.config import Config  # noqa: E402
from chaorec_tpu_torch.models import build_model  # noqa: E402
from chaorec_tpu_torch.parallel.mesh import split_rows  # noqa: E402
from chaorec_tpu_torch.train import loop  # noqa: E402
from chaorec_tpu_torch.train.loop import Trainer  # noqa: E402

MODES = ("permuted", "split", "same_half", "no_unshare")
WORLDS = ("split", "same_half", "no_unshare")


def same_half(batch, mesh):
    """A planted fault: every dp rank takes slice 0."""
    return split_rows(batch, mesh.dp, 0)


def no_unshare(batch, mesh):
    """A planted fault: the slice's summed terms keep their whole value."""
    part, share = split_rows(batch, mesh.dp, mesh.dp_index)
    return dataclasses.replace(part, share=None), share


def epoch(cfg, ds, device, mode: str):
    """(epoch loss, params, rank lists) of one epoch in one process."""
    trainer = Trainer(build_model(cfg, ds, device), ds, cfg)
    params = trainer.init_params()
    optimizer = trainer.make_optimizer(params)
    model = trainer.model
    loss_fn = model.loss

    def sliced(p, b, g):
        start, total = trainer.generator.get_state(), 0.0
        for r in range(2):
            trainer.generator.set_state(start)
            half, share = split_rows(b, 2, 0 if mode == "same_half" else r)
            if mode == "no_unshare":
                half = dataclasses.replace(half, share=None)
            total = total + loss_fn(p, half, g) * share
        return total

    model.loss = {"one": loss_fn, "permuted": chip_smoke.row_permuted(loss_fn)}.get(mode, sliced)
    model.pre_epoch(params, 0)
    loss = trainer.train_epoch(params, optimizer)
    rank_list = trainer.evaluate(params)[2].cpu()
    return loss, {k: v.detach().cpu() for k, v in params.items()}, rank_list


def rank_main(rank: int, world: int, init_method: str, argv: list, device: str, fault: str,
              run_dir: str) -> None:
    """One rank of a dp=2 world, ``fault`` planted ("split": none)."""
    os.chdir(run_dir)
    if fault != "split":
        loop.shard_batch = {"same_half": same_half, "no_unshare": no_unshare}[fault]
    cli.run_rank(rank, world, init_method, argv, device)


def mesh_world(model: str, ds, root: str, seed: int, device: str, fault: str, tmp: str) -> str:
    """Runs the CLI's dp=2 world one epoch with ``fault``; returns rank
    0's checkpoint file."""
    run_dir = os.path.join(tmp, fault)
    os.makedirs(os.path.join(run_dir, "Model_YAML"))
    with open(os.path.join(run_dir, "Model_YAML", f"{model}.yaml"), "w") as fh:
        json.dump(chip_smoke.first_combo(model)[1], fh)  # JSON is YAML
    argv = ["--Model", model, "--data_path", ds.name, "--data_root", root, "--num_epoch", "1",
            "--seed", str(seed), "--checkpoint_dir", os.path.join(run_dir, "ckpt"),
            "--checkpoint_every", "1", "--log_dir", os.path.join(run_dir, "log"),
            "--mesh_shape", "dp=2"]
    torch_mp.spawn(rank_main, nprocs=2, join=True, daemon=True,
                   args=(2, "file://" + os.path.join(run_dir, "rendezvous"), argv, device,
                         fault, run_dir))
    return os.path.join(run_dir, "ckpt", "combo_0", "step_1", "state.pt"), os.path.join(
        run_dir, "log", f"{model}_{ds.name}.log")


def report(name: str, loss, params, lists, base) -> None:
    drift = chip_smoke.param_drift(params, base[1])
    differ = int((lists != base[2]).any(1).sum())
    print(f"{name}: loss {loss!r} (rel {abs(loss - base[0]) / abs(base[0]):.3e}); params' "
          f"largest difference {max(drift.values()):.3e} ("
          + ", ".join(f"{k} {v:.3e}" for k, v in drift.items())
          + f"); {differ} of {lists.shape[0]} users' top-{lists.shape[1]} lists differ, mean "
          f"overlap {chip_smoke.top_share(lists, base[2]):.5f}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="SGL")
    ap.add_argument("--users", type=int, default=3000)
    ap.add_argument("--items", type=int, default=1500)
    ap.add_argument("--sports", action="store_true")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--mesh", action="store_true")
    args = ap.parse_args(argv)
    seed = 0
    if args.sports:
        ds = chip_smoke.synthetic_dataset(chip_smoke.FREEDOM_DATASET, seed, lens=(4, 8),
                                          features=True)
    else:
        ds = chip_smoke.synthetic_dataset("probe", seed, shape=(args.users, args.items),
                                          features=args.mesh)
    combo, _ = chip_smoke.first_combo(args.model)
    cfg = Config(Model=args.model, data_path=ds.name, seed=seed).replace(**combo)
    base = epoch(cfg, ds, args.device, "one")
    print(f"{args.model} ({ds.num_user} x {ds.num_item}, {ds.num_edges} edges, "
          f"{cfg.graph_compute_dtype} graphs) on {args.device}: one device's epoch loss "
          f"{base[0]!r}", flush=True)
    for mode in MODES:
        report(mode, *epoch(cfg, ds, args.device, mode), base)
    if not args.mesh:
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        root = chip_smoke.write_loader_files(ds, os.path.join(tmp, "data"))
        one = chip_smoke.single_run(cfg, ds, args.device, os.path.join(tmp, "single"),
                                    os.path.join(tmp, "single-log"))
        ref_state = os.path.join(tmp, "single", "step_1", "state.pt")
        ref = torch.load(ref_state, map_location="cpu", weights_only=True)["params"]
        base = (one["loss"], ref, one["rank_list"])
        print(f"Trainer.run on one device: loss {one['loss']!r}", flush=True)
        for fault in WORLDS:
            state, log = mesh_world(args.model, ds, root, seed, args.device, fault, tmp)
            loss = chip_smoke.mesh_epoch_line(chip_smoke.log_messages(log), "dp=2")[0]
            got = chip_smoke.split_lists(types.SimpleNamespace(seed=seed), args.model, ds,
                                         args.device, state, ref_state)
            params = torch.load(state, map_location="cpu", weights_only=True)["params"]
            report(f"dp=2 world, {fault}", loss, params, got["rank_list"], base)
    return 0


if __name__ == "__main__":
    sys.exit(main())
