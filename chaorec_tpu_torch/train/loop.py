"""Training runtime: epochs of Adam steps, per-epoch evaluation, early stopping.

Counterpart of ``chaorec_tpu/train/loop.py`` for stateful "user_rows" models
(CF_Diff): each epoch shuffles every user once, takes one Adam step per
batch on the model's ``loss_stateful``, carries the model state from batch
to batch, then ranks the full catalog and computes the metrics.

Behavioral parity with the JAX trainer, and through it the reference:
- epoch loss = sum of the batch losses, each a weighted mean over its batch;
- Adam with torch defaults (betas (0.9, 0.999), eps 1e-8);
- early stopping on **test** Recall@max(topk) with ``cfg.patience``; an
  equal score counts as an improvement;
- the same log lines: ``Epoch {n}, Loss: {x:.5f}``, the Validation/Test
  metric tables, ``epoch_time_s`` and the ``Best Test Metrics:`` block;
- best metrics = test metrics at the best epoch.

What the port measures in ``epoch_time_s`` differs: the "train-dispatch"
slot is the whole training epoch up to the host's read of its loss (the
device has finished by then), and "eval+sync" the ranking and metrics.

Not ported: the JAX trainer's chunked epoch dispatch, its serialize guard,
its compile sharing through injected hyperparameters and its one-epoch-deep
eval pipeline exist for the TPU and its remote link. The BPR, row-sparse
table and rebuild-gated branches, checkpointing, mesh training and the
profiler hook come with the models and slices that need them.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import torch

from chaorec_tpu_torch.config import Config
from chaorec_tpu_torch.data.loading import RecDataset
from chaorec_tpu_torch.data.sampling import make_epoch_batches
from chaorec_tpu_torch.eval.metrics import gene_metrics_pair, split_tensors
from chaorec_tpu_torch.eval.ranking import rank_from_scores
from chaorec_tpu_torch.models.base import Params, RecModel

ADAM_BETAS = (0.9, 0.999)  # torch.optim.Adam defaults, as the reference uses
ADAM_EPS = 1e-8


class EarlyStopping:
    """Parity with the reference's ``utils.EarlyStopping``."""

    def __init__(self, patience: int = 20, verbose: bool = True):
        self.patience = patience
        self.verbose = verbose
        self.counter = 0
        self.best_score = None
        self.early_stop = False
        self.best_metrics = None

    def __call__(self, score: float, metrics) -> None:
        if self.best_score is None:
            self.best_score = score
            self.best_metrics = metrics
        elif score < self.best_score:
            self.counter += 1
            if self.verbose:
                print(f"EarlyStopping counter: {self.counter} out of {self.patience}")
            if self.counter >= self.patience:
                self.early_stop = True
        else:
            self.best_score = score
            self.best_metrics = metrics
            self.counter = 0


def log_metrics(title: str, metrics) -> None:
    """``title``, then one line per k: ``{k}: name: value | ...``."""
    logging.info(title)
    for k, values in metrics.items():
        metrics_strs = [f"{metric}: {value:.5f}" for metric, value in values.items()]
        logging.info(f"{k}: {' | '.join(metrics_strs)}")


def _log_metric_tables(val_metrics, test_metrics) -> None:
    log_metrics("Validation Metrics:", val_metrics)
    log_metrics("Test Metrics:", test_metrics)


class Trainer:
    """The standard trainer of a stateful "user_rows" model on its device."""

    def __init__(self, model: RecModel, dataset: RecDataset, cfg: Config):
        if model.trainer_mode != "user_rows" or not model.stateful:
            raise NotImplementedError(
                f"{model.name}: only stateful user_rows models are ported; "
                f"trainer_mode {model.trainer_mode!r} comes with its models")
        self.model = model
        self.dataset = dataset
        self.cfg = cfg
        self.device = model.device
        # One generator drives everything random in training: shuffles,
        # timesteps, noise and dropout.
        self.generator = torch.Generator(self.device).manual_seed(cfg.seed)
        self.model_state = model.init_state(self.device)
        self.history = torch.from_numpy(dataset.history.values).to(self.device)
        self.val_split = split_tensors(dataset, "val", self.device)
        self.test_split = split_tensors(dataset, "test", self.device)
        # the best epoch's weights, kept for --export_artifact
        self.best_params_host: Optional[Params] = None
        self.best_mstate_host = None

    def init_params(self) -> Params:
        gen = torch.Generator(self.device).manual_seed(self.cfg.seed + 1)
        return {k: v.requires_grad_() for k, v in self.model.init_params(gen).items()}

    def make_optimizer(self, params: Params) -> torch.optim.Adam:
        return torch.optim.Adam(params.values(), lr=float(self.cfg.learning_rate),
                                betas=ADAM_BETAS, eps=ADAM_EPS)

    def train_epoch(self, params: Params, optimizer: torch.optim.Optimizer) -> float:
        """One pass over every user; returns the sum of the batch losses."""
        losses = []
        for batch in make_epoch_batches(self.generator, self.dataset.num_user,
                                        int(self.cfg.batch_size)):
            optimizer.zero_grad(set_to_none=True)
            loss, self.model_state = self.model.loss_stateful(
                params, self.model_state, batch, self.generator)
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
        return float(torch.stack(losses).sum())  # the epoch's one host sync

    def evaluate(self, params: Params):
        """(val, test, rank_list): full-catalog top-``rank_topk`` ranking with
        seen items masked, then the metrics of both splits."""
        rank_list = rank_from_scores(self.model, params, self.history,
                                     self.cfg.rank_topk, self.cfg.eval_user_chunk)
        val, test = gene_metrics_pair(rank_list, list(self.cfg.topk),
                                      self.val_split, self.test_split)
        return val, test, rank_list

    def run(self) -> Dict:
        cfg = self.cfg
        params = self.init_params()
        optimizer = self.make_optimizer(params)
        early_stopping = EarlyStopping(patience=cfg.patience, verbose=True)
        for epoch in range(cfg.num_epoch):
            t0 = time.perf_counter()
            loss = self.train_epoch(params, optimizer)
            t1 = time.perf_counter()
            val_metrics, test_metrics, _ = self.evaluate(params)
            t2 = time.perf_counter()
            logging.info("Epoch {}, Loss: {:.5f}".format(epoch + 1, loss))
            _log_metric_tables(val_metrics, test_metrics)
            logging.info(
                "epoch_time_s: total %.3f (train-dispatch %.3f | eval+sync %.3f)",
                t2 - t0, t1 - t0, t2 - t1,
            )
            early_stopping(test_metrics[max(cfg.topk)]["recall"], test_metrics)
            if cfg.export_artifact and early_stopping.counter == 0:
                # host copies: the optimizer updates params in place
                self.best_params_host = {k: v.detach().cpu().clone()
                                         for k, v in params.items()}
                self.best_mstate_host = tuple(t.cpu().clone() for t in self.model_state)
            if early_stopping.early_stop:
                print("Early stopping")
                break
        log_metrics("Best Test Metrics:", early_stopping.best_metrics)
        return early_stopping.best_metrics


def train_and_evaluate(model: RecModel, dataset: RecDataset, cfg: Config) -> Dict:
    """Convenience one-shot entry, as in the JAX package."""
    return Trainer(model, dataset, cfg).run()
