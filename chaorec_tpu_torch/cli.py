"""Command line: the YAML grid search with the reference's log format.

Counterpart of ``chaorec_tpu/cli.py``: the same flags (``config.parse_cli``),
the same YAML grid (``Model_YAML/{Model}.yaml``), the same log file
(``log/{Model}_{data_path}.log``, overwritten) and line formats, the same
grid-progress and best-performance blocks, and ``--export_artifact`` of the
best combo's best epoch into the serving path (``serve.export_artifact``).

    python -m chaorec_tpu_torch.cli --Model FREEDOM --data_path sports [--device cpu]

The run is on the first CUDA card unless ``--device cpu`` (or ``device=
"cpu"`` in ``run``) asks for the CPU, where the kernels' plain versions
run; without a card, a run that did not ask for the CPU raises before any
work. The data is loaded with both modality feature tables, as the JAX
CLI loads it. The JAX CLI's checkpoint grid cursor comes with
checkpointing: until then the trainer refuses ``--checkpoint_dir``,
``--checkpoint_every``, ``--mesh_shape`` and ``--profile_dir``.
``--max_dispatch_batches`` and ``--eval_pipeline`` parse and are ignored:
they tune the JAX trainer's chunked dispatch and eval pipeline for the
TPU, which ROADMAP lists under "Do not port".
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Dict, List, Optional

import torch

from chaorec_tpu_torch.config import Config, grid_combinations, load_yaml_config, parse_cli
from chaorec_tpu_torch.data.loading import RecDataset, data_load
from chaorec_tpu_torch.models import build_model
from chaorec_tpu_torch.params import clone_to
from chaorec_tpu_torch.train.loop import Trainer, deterministic_mode, log_metrics

LOG_FORMAT = "%(asctime)s %(levelname)s %(message)s"
DATE_FORMAT = "%a %d %b %Y %H:%M:%S"


def setup_logging(cfg: Config) -> None:
    os.makedirs(cfg.log_dir, exist_ok=True)
    log_filename = os.path.join(cfg.log_dir, f"{cfg.Model}_{cfg.data_path}.log")
    formatter = logging.Formatter(LOG_FORMAT, DATE_FORMAT)
    logger = logging.getLogger()
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
    setup_logging(cfg)
    logging.info("============Arguments==============")
    for arg, value in cfg.as_flat_dict().items():
        logging.info("%s: %s", arg, value)

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
    for idx, hyper_param_dict in enumerate(combos):
        logging.info("========={}/{}: Parameters:{}=========".format(
            idx + 1, len(combos), hyper_param_dict))
        combo_cfg = cfg.replace(**hyper_param_dict)
        model = build_model(combo_cfg, dataset, device)
        trainer = Trainer(model, dataset, combo_cfg)
        current = trainer.run()
        current_recall = current[20]["recall"] if 20 in current else (
            current[max(current)]["recall"])
        if best_performance is None or current_recall > best_performance:
            best_performance = current_recall
            best_params = dict(hyper_param_dict)
            best_metrics = current
            # the trainer snapshots the best epoch whenever export is asked for
            best_export = (model, trainer.best_params_host, trainer.best_mstate_host)

    if cfg.export_artifact:
        from chaorec_tpu_torch.serve import export_artifact

        model, params, mstate = best_export
        logging.info("export_artifact: exporting best-epoch weights to %s",
                     cfg.export_artifact)
        with deterministic_mode():
            export_artifact(model, clone_to(params, model.device),
                            clone_to(mstate, model.device), dataset, cfg.export_artifact,
                            snapshot="best-epoch")

    logging.info("Best performance: {:.5f}".format(best_performance))
    logging.info("Best parameters: {}".format(best_params))
    log_metrics("Best metrics:", best_metrics)
    return best_metrics


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda")
    ns, rest = ap.parse_known_args(argv)
    run(parse_cli(rest), device=ns.device)


if __name__ == "__main__":
    main()
