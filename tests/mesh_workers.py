"""Rank workers of the port's mesh tests (tests/test_torch_mesh.py).

``torch.multiprocessing.spawn`` imports a worker's module again in every
rank, so this module imports neither jax nor the JAX package: the tests
pass it numpy arrays and the port's own dataset class. Each world joins a
``file://`` store in the test's ``tmp_path`` (never a fixed port: the
suite runs several workers at once), runs one case function on every rank
with one torch thread, and saves each rank's result for the test to read.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

from chaorec_tpu_torch.config import Config
from chaorec_tpu_torch.data.loading import PaddedLists, RecDataset
from chaorec_tpu_torch.models import build_model
from chaorec_tpu_torch.models.base import Batch
from chaorec_tpu_torch.parallel.mesh import (Mesh, close_mesh, init_mesh, parse_mesh_spec,
                                             shard_params, sharded_rank, sharded_rank_scores)
from chaorec_tpu_torch.params import from_numpy
from chaorec_tpu_torch.train import loop


def port_dataset(ds) -> RecDataset:
    """``ds`` (either package's dataset) as the port's, numpy arrays only."""
    def lists(p):
        return PaddedLists(np.asarray(p.values), np.asarray(p.lengths), p.fill)

    return RecDataset(ds.name, ds.num_user, ds.num_item, np.asarray(ds.train_edges),
                      lists(ds.history), np.asarray(ds.val_users), lists(ds.val_pos),
                      np.asarray(ds.test_users), lists(ds.test_pos), ds.v_feat, ds.t_feat)


def entry(rank: int, world: int, init_method: str, spec: str, fn: str, root: str) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    mesh = init_mesh(spec, "cpu", init_method)
    try:
        payload = torch.load(os.path.join(root, "payload.pt"), weights_only=False)
        torch.save(globals()[fn](mesh, payload), os.path.join(root, f"rank{rank}.pt"))
    finally:
        close_mesh()


def run_world(root: Path, spec: str, fn: str, payload: Dict[str, Any]) -> List[Any]:
    """Each rank's result of ``fn(mesh, payload)`` over a CPU world of
    ``spec``; a rank that raises raises here."""
    dp, mp = parse_mesh_spec(spec)
    root.mkdir(parents=True, exist_ok=True)
    torch.save(payload, root / "payload.pt")
    torch.multiprocessing.spawn(entry, args=(dp * mp, f"file://{root}/rendezvous", spec, fn,
                                             str(root)), nprocs=dp * mp, join=True)
    return [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(dp * mp)]


def torch_batch(arrays) -> Batch:
    u, p, n, w = arrays
    return Batch(torch.from_numpy(u).long(), torch.from_numpy(w),
                 pos_items=torch.from_numpy(p).long(), neg_items=torch.from_numpy(n).long())


def host(tree):
    return {k: v.detach().numpy() for k, v in tree.items()}


def mesh_trainer(flags: Dict, ds, mesh: Mesh) -> loop.Trainer:
    """A trainer of ``flags`` on ``mesh`` (on a one-process mesh, on one device)."""
    cfg = Config(**flags, mesh_shape=mesh.spec if mesh.backend else "")
    model = build_model(cfg, ds, "cpu")
    return getattr(model, "trainer_cls", loop.Trainer)(model, ds, cfg)


def one_step(mesh: Mesh, case: Dict) -> Dict:
    """One ``Trainer.train_step`` of a "bpr" model from the given params on
    the given batch: the loss (summed over the dp slices) and every param
    gathered whole. ``keep_mask``: FREEDOM's pruning; ``protos``: NCL's
    prototypes."""
    ds = case["dataset"]
    tr = mesh_trainer(case["flags"], ds, mesh)
    model = tr.model
    if "keep_mask" in case:
        model.apply_keep_mask(torch.from_numpy(case["keep_mask"]))
    if "protos" in case:
        protos = tuple(from_numpy(case["protos"]))
        model.prototypes = lambda params, generator: protos
    params = from_numpy(case["params"])
    params = {k: v if k in model.table_params else v.requires_grad_() for k, v in params.items()}
    store = tr.store = shard_params(params, tr.mesh, model.table_params)
    opt = tr.make_optimizer(store.shards)
    batch = torch_batch(case["batch"])
    loss = tr.train_step(store.view, opt, batch).detach()
    if tr.dp_split:
        loss = tr.mesh.all_reduce(loss, "dp")
    return {"loss": float(loss), "params": host(store.gather_host()),
            "sharded": sorted(store.rows), "digest": store.digest()}


def steps(mesh: Mesh, payload: Dict) -> Dict:
    """``one_step`` of each case of ``payload["steps"]``."""
    return {name: one_step(mesh, case) for name, case in payload["steps"].items()}


def ranks(mesh: Mesh, p: Dict) -> Dict:
    """``sharded_rank`` of the given tables and ``sharded_rank_scores`` of
    MultVAE at the given params."""
    hist = torch.from_numpy(p["hist"])
    out = {"rank": sharded_rank(torch.from_numpy(p["ue"]), torch.from_numpy(p["ie"]), hist,
                                p["num_user"], 10, mesh).numpy()}
    model = build_model(Config(**p["multvae"]), p["dataset"], "cpu")
    out["scores"] = sharded_rank_scores(model, from_numpy(p["multvae_params"]), hist,
                                        p["num_user"], 10, mesh).numpy()
    return out


def steps_and_ranks(mesh: Mesh, payload: Dict) -> Dict:
    return {"steps": steps(mesh, payload), "ranks": ranks(mesh, payload)}


def family_epoch(flags: Dict, ds, mesh: Mesh) -> Dict:
    """One epoch of a model's own trainer as ``Trainer.run`` takes it
    (``pre_epoch``, the trainer's epoch, an evaluation): the epoch loss,
    every param gathered whole and the rank lists."""
    trainer = mesh_trainer(flags, ds, mesh)
    base = getattr(trainer, "_base", trainer)
    store = base.store = shard_params(base.init_params(), base.mesh, base.model.table_params)
    params = store.view
    optimizer = base.make_optimizer(store.shards)
    with loop.deterministic_mode():
        base.model.pre_epoch(params, 0)
        loss = base.train_epoch(params, optimizer)
        rank_list = base.evaluate(params)[2]
    return {"loss": loss, "params": host(store.gather_host()), "rank_list": rank_list.numpy(),
            "sharded": sorted(store.rows)}


def families(mesh: Mesh, payload: Dict) -> Dict:
    return {name: family_epoch(flags, payload["dataset"], mesh)
            for name, flags in payload["families"].items()}


def resume_run(flags: Dict, ds, mesh: Mesh, ckpt: str, epochs: int) -> Dict:
    """``Trainer.run`` to ``epochs`` with a checkpoint each epoch in
    ``ckpt`` (resuming from its newest): the best metrics and the final
    params whole."""
    trainer = mesh_trainer(dict(flags, num_epoch=epochs, checkpoint_dir=ckpt,
                                checkpoint_every=1), ds, mesh)
    best = trainer.run()
    return {"best": best, "params": host(trainer.final_params)}


def resumes(mesh: Mesh, payload: Dict) -> Dict:
    """The mesh's legs of the checkpoint exchange: a run of 2 epochs into
    ``to_single``; the run resumed from ``from_single`` to 3 epochs."""
    ds, flags = payload["dataset"], payload["flags"]
    return {"wrote": resume_run(flags, ds, mesh, payload["to_single"], 2),
            "resumed": resume_run(flags, ds, mesh, payload["from_single"], 3)}


def families_and_resumes(mesh: Mesh, payload: Dict) -> Dict:
    return {"families": families(mesh, payload), "resumes": resumes(mesh, payload)}



def loaded(mesh: Mesh, payload: Dict) -> List[str]:
    """The modules of jax and of the JAX package this rank has loaded."""
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "chaorec_tpu"))
