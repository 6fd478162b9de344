"""Training runtime: epochs of Adam steps, per-epoch evaluation, early stopping.

Counterpart of ``chaorec_tpu/train/loop.py`` for two kinds of model:

- stateful "user_rows" models (CF_Diff): each epoch shuffles every user
  once and takes one Adam step per batch on ``loss_stateful``, carrying
  the model state from batch to batch;
- "bpr" models: each epoch shuffles the train edges; every batch of
  (user, positive) pairs gets one negative per row from outside the
  user's history, drawn on the device. A stateful one (DGCF's routing
  scores) steps on ``loss_stateful`` and carries its state from batch to
  batch, and evaluates and exports with ``embeddings_stateful``. Models
  with ``table_params`` (FREEDOM's trainable feature tables) take the
  row-sparse table step: the batch's rows of each table are gathered as
  leaf tensors, one backward gives the dense gradients and the rows'
  gradients, Adam steps the dense params, and
  ``ops/indexed_adam.table_adam_update`` steps each table with a step
  count shared by the tables (on the card, the ``csrc/row_adam.cu``
  kernel, in place).

Each epoch calls the model's ``pre_epoch`` first (graph pruning, operator
rebuilds), counted as training time; then ranks the full catalog
(``gene_ranklist`` for embedding models, ``rank_from_scores`` for
score-mode ones) and computes the metrics.

Behavioral parity with the JAX trainer, and through it the reference:
- epoch loss = sum of the batch losses, each a weighted mean over its batch;
- Adam with torch defaults (betas (0.9, 0.999), eps 1e-8), for the tables
  too;
- ``--relaxed_precision bf16`` stores the tables and their moments in bf16
  (the math stays float32);
- early stopping on **test** Recall@max(topk) with ``cfg.patience``; an
  equal score counts as an improvement;
- the same log lines: ``Epoch {n}, Loss: {x:.5f}``, the Validation/Test
  metric tables, ``epoch_time_s`` and the ``Best Test Metrics:`` block;
- best metrics = test metrics at the best epoch.

Same seed, same bits: the trainer runs in PyTorch's deterministic mode
(``deterministic_mode``), entered by ``run``, ``train_epoch``,
``train_step``, ``evaluate`` and the CLI's export. On the card that turns
every sum the port takes by atomics (``index_add_``, the backward of a row
gather) into a sorted, fixed-order one, so two runs on one seed give equal
losses and rank lists, as the JAX package's (tests/test_determinism.py).

What the port measures in ``epoch_time_s`` differs: the "train-dispatch"
slot is the whole training epoch (``pre_epoch`` included) up to the host's
read of its loss (the device has finished by then), and "eval+sync" the
ranking and metrics.

Not ported: the JAX trainer's chunked epoch dispatch, its serialize guard,
its compile sharing through injected hyperparameters and its one-epoch-deep
eval pipeline exist for the TPU and its remote link. The rebuild-gated
branches (``epoch0_params``, ``frozen_state_epoch``), checkpointing, mesh
training and the profiler hook come with the models and slices that need
them: the trainer refuses a model that asks for one, and refuses
``--checkpoint_dir``, ``--checkpoint_every``, ``--mesh_shape`` and
``--profile_dir`` (``UNPORTED_FLAGS``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Dict, Optional

import torch

from chaorec_tpu_torch.config import Config
from chaorec_tpu_torch.data.loading import RecDataset
from chaorec_tpu_torch.data.sampling import (make_edge_batches, make_epoch_batches,
                                             sample_negatives)
from chaorec_tpu_torch.eval.metrics import gene_metrics_pair, split_tensors
from chaorec_tpu_torch.eval.ranking import gene_ranklist, rank_from_scores
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.indexed_adam import init_table_state, table_adam_update
from chaorec_tpu_torch.params import clone_to

ADAM_BETAS = (0.9, 0.999)  # torch.optim.Adam defaults, as the reference uses
ADAM_EPS = 1e-8
# Flags the JAX trainer reads and this one does not yet: the trainer refuses
# them rather than run without them. Each names the ROADMAP item that ports it.
UNPORTED_FLAGS = {
    "checkpoint_dir": "Queue 1 item 8 (checkpoint and grid cursor)",
    "checkpoint_every": "Queue 1 item 8 (checkpoint and grid cursor)",
    "mesh_shape": "Queue 1 item 9 (multi-device)",
    "profile_dir": "Queue 1 items 8-9 (the profiler hook comes with them)",
}


@contextlib.contextmanager
def deterministic_mode():
    """PyTorch's deterministic algorithms on, and the previous state back on
    exit; usable as a decorator. Under it ``index_add_`` and ``index_put_``
    with ``accumulate`` sum in a fixed order on the card, and an operation
    with no deterministic CUDA version (``torch.cumsum`` of a CUDA float)
    raises. Memory from ``torch.empty`` is left unfilled, as outside the
    mode: every buffer the port allocates so is written before it is read,
    and filling the kernels' large scratch would only cost device time.
    Scoped, not global: outside the trainer the kernels' yardsticks run as
    PyTorch runs them by default. A cuBLAS product under the mode needs
    ``CUBLAS_WORKSPACE_CONFIG``, which the package sets on import."""
    was_on = torch.are_deterministic_algorithms_enabled()
    was_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    was_fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was_on, warn_only=was_warn)
        torch.utils.deterministic.fill_uninitialized_memory = was_fill


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


def apply_relaxed_precision(model: RecModel, params: Params, cfg: Config) -> Params:
    """``--relaxed_precision bf16``: the model's tables are stored in bf16,
    and their Adam moments with them (``init_table_state`` follows the
    table's dtype); the per-step math stays float32."""
    if cfg.relaxed_precision == "bf16" and model.table_params:
        for n in model.table_params:
            params[n] = params[n].to(torch.bfloat16)
        logging.info("relaxed_precision=bf16: tables %s stored bf16", list(model.table_params))
    return params


class Trainer:
    """The standard trainer of a model on its device: stateful "user_rows"
    models, and "bpr" models, stateful or with row-sparse tables."""

    def __init__(self, model: RecModel, dataset: RecDataset, cfg: Config):
        self.user_rows = model.trainer_mode == "user_rows"
        if not (model.trainer_mode == "bpr" or (self.user_rows and model.stateful)):
            raise NotImplementedError(
                f"{model.name}: trainer_mode {model.trainer_mode!r} with stateful="
                f"{model.stateful} is not ported; it comes with its models")
        if model.stateful and model.table_params:
            raise NotImplementedError(f"{model.name}: a stateful model with row-sparse "
                                      "tables is not ported")
        for gate in ("epoch0_params", "frozen_state_epoch"):
            if getattr(model, gate, None):
                raise NotImplementedError(f"{model.name}: the rebuild-gated branch "
                                          f"({gate}) is not ported; it comes with its models")
        for flag, item in UNPORTED_FLAGS.items():
            if getattr(cfg, flag):
                raise NotImplementedError(f"--{flag} is not ported; ROADMAP {item} ports it")
        self.model = model
        self.dataset = dataset
        self.cfg = cfg
        self.device = model.device
        # One generator drives everything random in training: shuffles,
        # negatives, timesteps, noise and dropout.
        self.generator = torch.Generator(self.device).manual_seed(cfg.seed)
        self.model_state = model.init_state(self.device)
        self.history = torch.from_numpy(dataset.history.values).to(self.device)
        self.edges = torch.from_numpy(dataset.train_edges).to(self.device, torch.int64)
        self.val_split = split_tensors(dataset, "val", self.device)
        self.test_split = split_tensors(dataset, "test", self.device)
        # row-sparse table optimizer state: {table: (m, v)} and the shared
        # step count, an int32 on the device (read there by the kernel)
        self.table_state = {}
        self.table_count = torch.zeros((), dtype=torch.int32, device=self.device)
        # the best epoch's weights, kept for --export_artifact
        self.best_params_host: Optional[Params] = None
        self.best_mstate_host = None

    def init_params(self) -> Params:
        """The model's initial params (the tables in bf16 under
        ``--relaxed_precision bf16``); every param but the tables is a
        leaf that requires grad."""
        gen = torch.Generator(self.device).manual_seed(self.cfg.seed + 1)
        params = apply_relaxed_precision(self.model, self.model.init_params(gen), self.cfg)
        tables = set(self.model.table_params)
        return {k: v if k in tables else v.requires_grad_() for k, v in params.items()}

    def make_optimizer(self, params: Params) -> torch.optim.Adam:
        """Adam over the dense params; resets the tables' optimizer state."""
        tables = self.model.table_params
        self.table_state = {n: init_table_state(params[n]) for n in tables}
        self.table_count.zero_()
        return torch.optim.Adam([v for k, v in params.items() if k not in tables],
                                lr=float(self.cfg.learning_rate), betas=ADAM_BETAS,
                                eps=ADAM_EPS)

    @deterministic_mode()
    def train_step(self, params: Params, optimizer: torch.optim.Optimizer,
                   batch: Batch) -> torch.Tensor:
        """One Adam step on a batch (a "bpr" batch with its negatives);
        returns the loss. Updates ``params`` (the tables by replacement on
        the CPU, in place on the card) and a stateful model's state."""
        optimizer.zero_grad(set_to_none=True)
        names = self.model.table_params
        if not names:
            if self.model.stateful:
                loss, self.model_state = self.model.loss_stateful(
                    params, self.model_state, batch, self.generator)
            else:
                loss = self.model.loss(params, batch, self.generator)
            loss.backward()
            optimizer.step()
            return loss
        dense = {k: v for k, v in params.items() if k not in names}
        rows = self.model.table_rows(batch)
        gathered = {n: params[n][rows[n]].requires_grad_() for n in names}
        loss = self.model.loss_tables(dense, gathered, batch, self.generator)
        loss.backward()
        optimizer.step()
        self.table_count += 1
        lr = float(self.cfg.learning_rate)
        for n in names:
            params[n], self.table_state[n] = table_adam_update(
                params[n], self.table_state[n], rows[n], gathered[n].grad,
                self.table_count, lr, ADAM_BETAS[0], ADAM_BETAS[1], ADAM_EPS)
        return loss

    @deterministic_mode()
    def train_epoch(self, params: Params, optimizer: torch.optim.Optimizer) -> float:
        """One pass over every user (user_rows) or every edge (bpr); returns
        the sum of the batch losses."""
        losses = []
        bs = int(self.cfg.batch_size)
        if self.user_rows:
            for batch in make_epoch_batches(self.generator, self.dataset.num_user, bs):
                losses.append(self.train_step(params, optimizer, batch).detach())
        else:
            for batch in make_edge_batches(self.generator, self.edges, bs):
                neg = sample_negatives(self.generator, batch.users, self.history,
                                       self.model.num_item, int(self.cfg.neg_candidates))
                loss = self.train_step(params, optimizer,
                                       dataclasses.replace(batch, neg_items=neg))
                losses.append(loss.detach())
        return float(torch.stack(losses).sum())  # the epoch's one host sync

    @torch.no_grad()
    @deterministic_mode()
    def evaluate(self, params: Params):
        """(val, test, rank_list): full-catalog top-``rank_topk`` ranking with
        seen items masked, then the metrics of both splits."""
        if self.model.rank_mode == "embeddings":
            if self.model.stateful:
                user_emb, item_emb = self.model.embeddings_stateful(params, self.model_state)
            else:
                user_emb, item_emb = self.model.embeddings(params)
            rank_list = gene_ranklist(user_emb, item_emb, self.history, self.model.num_user,
                                      self.cfg.rank_topk, self.cfg.eval_user_chunk)
        else:
            rank_list = rank_from_scores(self.model, params, self.history,
                                         self.cfg.rank_topk, self.cfg.eval_user_chunk)
        val, test = gene_metrics_pair(rank_list, list(self.cfg.topk),
                                      self.val_split, self.test_split)
        return val, test, rank_list

    @deterministic_mode()
    def run(self) -> Dict:
        cfg = self.cfg
        params = self.init_params()
        optimizer = self.make_optimizer(params)
        early_stopping = EarlyStopping(patience=cfg.patience, verbose=True)
        for epoch in range(cfg.num_epoch):
            t0 = time.perf_counter()
            self.model.pre_epoch(params, epoch)
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
                self.best_params_host = clone_to(params, "cpu")
                self.best_mstate_host = clone_to(self.model_state, "cpu")
            if early_stopping.early_stop:
                print("Early stopping")
                break
        log_metrics("Best Test Metrics:", early_stopping.best_metrics)
        return early_stopping.best_metrics


def train_and_evaluate(model: RecModel, dataset: RecDataset, cfg: Config) -> Dict:
    """Convenience one-shot entry, as in the JAX package."""
    return Trainer(model, dataset, cfg).run()
