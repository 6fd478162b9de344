"""Command line: the YAML grid search with the reference's log format.

Counterpart of ``chaorec_tpu/cli.py``: the same flags (``config.parse_cli``),
the same YAML grid (``Model_YAML/{Model}.yaml``), the same log file
(``log/{Model}_{data_path}.log``, overwritten) and line formats, the same
grid-progress and best-performance blocks, and ``--export_artifact`` of the
best combo's best epoch into the serving path (``serve.export_artifact``).
Each combo is trained by its model's ``trainer_cls`` (the standard
``Trainer`` unless the model names a family trainer: BSPM's
``TrainFreeTrainer``, GFormer's ``GFormerTrainer``), and the export takes
the trainer's weights as the JAX CLI does: ``best_params_host``, else
``final_params``, else it logs that the trainer kept none and skips.

    python -m chaorec_tpu_torch.cli --Model FREEDOM --data_path sports [--device cpu]

The run is on the first CUDA card unless ``--device cpu`` (or ``device=
"cpu"`` in ``run``) asks for the CPU, where the kernels' plain versions
run; without a card, a run that did not ask for the CPU raises before any
work. The data is loaded with both modality feature tables, as the JAX
CLI loads it.

The grid cursor, as the JAX CLI's: with ``--checkpoint_dir`` and
``--checkpoint_every`` N > 0, each combo checkpoints under
``<checkpoint_dir>/combo_<idx>`` (``train/loop.py``), and each finished
combo's best metrics are recorded in ``<checkpoint_dir>/grid_cursor.json``
(``{str(idx): {str(k): metrics}}``, written whole to a temporary file and
renamed). A rerun skips the recorded combos, counts them in choosing the
best combo, and resumes the unfinished one from its newest step; a cursor
written by either package is read by the other. When the best combo came
from the cursor there are no live weights to export: the JAX CLI's warning
is logged and the export skipped.

``--mesh_shape dp=..,mp=..`` trains over dp x mp ranks (``parallel/mesh.py``,
``train/loop.py``). The JAX command runs the mesh in one process; torch
needs a process a rank, so ``main`` spawns them itself (a ``file://``
rendezvous in a temporary directory; rank r on ``cuda:(r % cards)``, or
all on the CPU under ``--device cpu``) and exits nonzero when any rank
fails. Under torchrun (``WORLD_SIZE`` set) the process joins the world it
is given, on ``cuda:(LOCAL_RANK % cards)``. Only rank 0 writes the log,
the grid cursor, checkpoints and the export; at the end it logs each
rank's peak device memory and kernel launches.
``--max_dispatch_batches`` and ``--eval_pipeline`` parse and are ignored:
they tune the JAX trainer's chunked dispatch and eval pipeline for the
TPU, which ROADMAP lists under "Do not port".
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile
from typing import Dict, List, Optional

import torch
import torch.multiprocessing as torch_mp

from chaorec_tpu_torch.config import Config, grid_combinations, load_yaml_config, parse_cli
from chaorec_tpu_torch.data.loading import RecDataset, data_load
from chaorec_tpu_torch.models import build_model
from chaorec_tpu_torch.ops import kernel_wrappers
from chaorec_tpu_torch.parallel.mesh import (close_mesh, init_mesh, parse_mesh_spec, rank_report,
                                             world_mesh)
from chaorec_tpu_torch.params import clone_to
from chaorec_tpu_torch.train.loop import Trainer, deterministic_mode, log_metrics

LOG_FORMAT = "%(asctime)s %(levelname)s %(message)s"
DATE_FORMAT = "%a %d %b %Y %H:%M:%S"


GRID_CURSOR = "grid_cursor.json"


def write_cursor(path: str, done: Dict[str, Dict]) -> None:
    """The grid cursor ``done`` into ``path``, whole or not at all."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(done, f)
    os.replace(tmp, path)


def setup_logging(cfg: Config, lead: bool = True) -> None:
    """The log file and the console at INFO; a mesh rank other than 0
    (``lead`` false) writes no file and shows warnings only."""
    logger = logging.getLogger()
    if not lead:
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
        logger.setLevel(logging.WARNING)
        return
    os.makedirs(cfg.log_dir, exist_ok=True)
    log_filename = os.path.join(cfg.log_dir, f"{cfg.Model}_{cfg.data_path}.log")
    formatter = logging.Formatter(LOG_FORMAT, DATE_FORMAT)
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    console = logging.StreamHandler()
    console.setLevel(logging.INFO)
    console.setFormatter(formatter)
    file_handler = logging.FileHandler(log_filename, mode="w")
    file_handler.setLevel(logging.INFO)
    file_handler.setFormatter(formatter)
    logger.addHandler(console)
    logger.addHandler(file_handler)


def run(cfg: Config, yaml_cfg: Optional[Dict] = None,
        dataset: Optional[RecDataset] = None,
        device: torch.device | str = "cuda") -> Dict:
    """Full grid-search run; returns the best combo's best test metrics.

    ``dataset`` is used instead of loading ``cfg.data_path`` from
    ``cfg.data_root`` when given; ``yaml_cfg`` instead of the model's YAML."""
    device = torch.device(device)
    torch.empty(0, device=device)  # a missing card raises here, before any work
    mesh = world_mesh(cfg.mesh_shape, device) if cfg.mesh_shape else None
    lead = mesh is None or mesh.rank == 0
    setup_logging(cfg, lead)
    logging.info("============Arguments==============")
    for arg, value in cfg.as_flat_dict().items():
        logging.info("%s: %s", arg, value)
    if mesh is not None:
        logging.info(mesh.describe())

    if dataset is None:
        dataset = data_load(cfg.data_path, cfg.data_root, has_v=True, has_t=True)
    if yaml_cfg is None:
        try:
            yaml_cfg = load_yaml_config(cfg.Model)
        except FileNotFoundError:
            yaml_cfg = {"hyper_parameters": []}
    combos = list(grid_combinations(yaml_cfg)) or [{}]

    best_performance = None
    best_params = None
    best_metrics = None
    best_export = None
    cursor_path = (os.path.join(cfg.checkpoint_dir, GRID_CURSOR)
                   if cfg.checkpoint_dir and cfg.checkpoint_every > 0 else None)
    done: Dict[str, Dict] = {}
    if cursor_path and os.path.exists(cursor_path):
        with open(cursor_path) as f:
            done = json.load(f)
    for idx, hyper_param_dict in enumerate(combos):
        logging.info("========={}/{}: Parameters:{}=========".format(
            idx + 1, len(combos), hyper_param_dict))
        combo_cfg = cfg.replace(**hyper_param_dict)
        trainer = None
        if cursor_path:
            combo_cfg = combo_cfg.replace(
                checkpoint_dir=os.path.join(cfg.checkpoint_dir, f"combo_{idx}"))
        if str(idx) in done:
            logging.info("combo %d already finished - skipping (grid cursor)", idx + 1)
            current = {int(k): v for k, v in done[str(idx)].items()}
        else:
            model = build_model(combo_cfg, dataset, device)
            trainer_cls = getattr(model, "trainer_cls", Trainer)
            trainer = trainer_cls(model, dataset, combo_cfg)
            current = trainer.run()
            if cursor_path:
                done[str(idx)] = {str(k): dict(v) for k, v in current.items()}
                if lead:
                    write_cursor(cursor_path, done)
        current_recall = current[20]["recall"] if 20 in current else (
            current[max(current)]["recall"])
        if best_performance is None or current_recall > best_performance:
            best_performance = current_recall
            best_params = dict(hyper_param_dict)
            best_metrics = current
            # a combo from the cursor has no live weights
            best_export = None
            if cfg.export_artifact and trainer is not None:
                # the JAX CLI's fallbacks: a family trainer that keeps no
                # weights of its own (BSPM's, GFormer's) has none to export
                best_host = getattr(trainer, "best_params_host", None)
                mstate = getattr(trainer, "best_mstate_host", None)
                best_export = (
                    model,
                    best_host if best_host is not None
                    else getattr(trainer, "final_params", None),
                    mstate if mstate is not None else getattr(trainer, "model_state", None),
                    "best-epoch" if best_host is not None else "final-epoch",
                )

    if cfg.export_artifact and lead:
        if best_export is None:
            logging.warning("export_artifact: best combo resumed from the grid cursor - "
                            "re-run it to export")
            params = None
        else:
            model, params, mstate, snapshot = best_export
        if params is None:
            logging.warning("export_artifact: best combo's trainer kept no "
                            "weights - skipping export")
        else:
            from chaorec_tpu_torch.serve import export_artifact

            logging.info("export_artifact: exporting %s weights to %s", snapshot,
                         cfg.export_artifact)
            with deterministic_mode():
                export_artifact(model, clone_to(params, model.device),
                                clone_to(mstate, model.device), dataset, cfg.export_artifact,
                                snapshot=snapshot)

    logging.info("Best performance: {:.5f}".format(best_performance))
    logging.info("Best parameters: {}".format(best_params))
    log_metrics("Best metrics:", best_metrics)
    if mesh is not None and mesh.backend is not None:
        log_ranks(mesh)
    return best_metrics


def log_ranks(mesh) -> None:
    """Logs each rank's peak device memory and kernel launches (one
    all_gather)."""
    peak = (torch.cuda.max_memory_allocated(mesh.device) if mesh.device.type == "cuda"
            else -1)
    launches = {f.__name__: f.launches for f in kernel_wrappers()}
    for r, row in enumerate(rank_report(mesh, {"peak": peak, **launches})):
        peak_r = row.pop("peak")
        logging.info("mesh %s rank %d (dp %d, mp %d): peak device memory %s; kernel launches %s",
                     mesh.spec, r, r // mesh.mp, r % mesh.mp,
                     f"{peak_r / 2 ** 30:.3f} GiB" if peak_r >= 0 else "not measured (cpu)",
                     ", ".join(f"{k} {int(v)}" for k, v in row.items()))


def rank_device(device: str, local_rank: int) -> torch.device:
    """A mesh rank's device: ``cuda`` becomes ``cuda:(local_rank % cards)``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank % max(torch.cuda.device_count(), 1))
    return device


def run_in_world(argv: List[str], device: str, local_rank: int,
                 init_method: str = "env://") -> None:
    """The command line ``argv`` as one rank of the world it joins at
    ``init_method``, on ``rank_device(device, local_rank)``."""
    cfg = parse_cli(argv)
    dev = rank_device(device, local_rank)
    init_mesh(cfg.mesh_shape, dev, init_method)
    try:
        run(cfg, device=dev)
    finally:
        close_mesh()


def run_rank(rank: int, world: int, init_method: str, argv: List[str], device: str) -> None:
    """A rank that ``main`` spawned."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    run_in_world(argv, device, rank, init_method)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda")
    ns, rest = ap.parse_known_args(argv)
    cfg = parse_cli(rest)
    if not cfg.mesh_shape:
        run(cfg, device=ns.device)
    elif "WORLD_SIZE" in os.environ:  # torchrun's world
        run_in_world(rest, ns.device, int(os.environ.get("LOCAL_RANK", 0)))
    else:
        dp, mp = parse_mesh_spec(cfg.mesh_shape)
        with tempfile.TemporaryDirectory() as d:
            # a rank that raises ends the others and raises here; a rank
            # is a daemon, ended when this process ends
            torch_mp.spawn(run_rank, nprocs=dp * mp, join=True, daemon=True,
                           args=(dp * mp, "file://" + os.path.join(d, "rendezvous"), rest,
                                 ns.device))


if __name__ == "__main__":
    main()
