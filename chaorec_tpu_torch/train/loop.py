"""Training runtime: epochs of Adam steps, per-epoch evaluation, early stopping.

Counterpart of ``chaorec_tpu/train/loop.py`` for two kinds of model:

- stateful "user_rows" models (CF_Diff): each epoch shuffles every user
  once and takes one Adam step per batch on ``loss_stateful``, carrying
  the model state from batch to batch;
- "bpr" models: each epoch shuffles the train edges; every batch of
  (user, positive) pairs gets one negative per row from outside the
  user's history, drawn on the device, and then, for a model that
  ``needs_int_items`` (MCLN), a second such item (``bpr_batch``). A
  stateful one (DGCF's routing scores, the VAEs' anneal counters,
  DualVAE's latent caches) steps on ``loss_stateful`` and carries its
  state from batch to batch, and evaluates and exports with
  ``embeddings_stateful``, or ranks with ``score_users_stateful`` when it
  has it (``eval/ranking.scorer``). Models
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
score-mode ones, after a model's ``resample_eval`` where it has one) and
computes the metrics.

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

The rebuild-gated branch (LATTICE, MICRO): a model with
``frozen_state_epoch`` builds its graph on each epoch's batch 0
(``batch.index == 0``) and reads it detached on every later batch, a Python
branch in its ``loss_stateful``. Its ``epoch0_params`` get a real gradient
on batch 0 only. The reference pins torch 1.11, whose ``zero_grad`` zeroes
``.grad`` rather than dropping it, so Adam steps those params on every later
batch with a zero gradient: momentum decay, and a step count that grows each
batch. The JAX trainer applies those steps after the epoch in closed form
(``chaorec_tpu/ops/adam_tail.py``); this trainer runs them literally:
``train_step`` fills every gradient through ``grads_into`` (zeros where the
loss does not reach a param) before ``optimizer.step()``, for a model with
``epoch0_params`` only, so every other model's step is unchanged. As in the
JAX trainer, ``epoch0_params`` and ``table_params`` are refused together.

Checkpoint/resume, as the JAX trainer's (``train/checkpoint.py``): with
``--checkpoint_dir`` and ``--checkpoint_every`` N > 0, ``run`` saves after
every N-th epoch's early-stopping update (step = epochs done) the params,
the Adam's state, the tables' moments and shared step count, the model
state, the generator's state and the early-stopping cursor (``best_score``
exact, not rounded to float32 as the JAX package stores it), and resumes
from the newest step, so a resumed run gives the bits of an uninterrupted
one. A checkpoint resumes on the device kind that wrote it (the CPU's and
the card's generator states differ in shape). ``--profile_dir``: a
``torch.profiler`` trace of epoch ``start_epoch + 1`` (its ``pre_epoch``,
training and evaluation, the JAX trainer's window), written as Chrome-trace
JSON; on the card it must hold device kernels. The profiler turns on the
spans of ``tracing.py`` (``train.batches``, ``train.step``, ``train.sample``,
``train.forward``, ``train.backward``, ``train.optimizer``, ``train.sync``,
``eval.embeddings``, ``eval.rank``, ``eval.score``, ``eval.select``,
``eval.metrics``), ranges of the trace, and its counters; the epoch's
spans, a line each with calls, host ms, host self ms and device ms, and
then the counters are logged when the trace is written.

Under ``--mesh_shape dp=..,mp=..`` (``parallel/mesh.py``, in a world the
CLI spawns or torchrun starts) ``run`` keeps the params in a
``ShardedParams`` store: the optimizers step ``store.shards`` (each rank's
rows of a param the JAX rule shards over mp), the model reads
``store.view`` (those rows gathered, refreshed after every optimizer
step), and a table's rows are gathered by one all_reduce and stepped by K1
on the rows the rank owns. Every rank draws whole batches from the same
seed; a ``dp_split`` model steps on its dp slice, its loss scaled by the
slice's share, its gradients summed over dp before the step. Evaluation
ranks the users split over the world (``sharded_rank``,
``sharded_rank_scores``) and gives every rank all the lists; each epoch
logs its loss's bits and sha256 digests of the rank lists and of the
replicated params, which must agree on every rank. Checkpoints keep the
single-device schema (the gathered params, moments and tables, written by
rank 0; a restore keeps each rank's rows), so a mesh run resumes a
single-device checkpoint and the reverse. Only rank 0 logs, profiles and
saves. On one device the store is the params dict itself: the same ops,
the same bits.

Not ported: the JAX trainer's chunked epoch dispatch, its serialize guard,
its compile sharing through injected hyperparameters and its one-epoch-deep
eval pipeline exist for the TPU and its remote link.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import logging
import os
import time
from typing import Dict, Optional

import torch

from chaorec_tpu_torch import tracing
from chaorec_tpu_torch.config import Config
from chaorec_tpu_torch.data.loading import RecDataset
from chaorec_tpu_torch.data.sampling import (make_edge_batches, make_epoch_batches,
                                             sample_negatives)
from chaorec_tpu_torch.eval.metrics import gene_metrics_pair, split_tensors
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.indexed_adam import (TableOptState, init_table_state,
                                                table_adam_update)
from chaorec_tpu_torch.parallel.mesh import (Mesh, ShardedParams, shard_batch, shard_params,
                                             sharded_rank, sharded_rank_scores, world_mesh)
from chaorec_tpu_torch.params import clone_to
from chaorec_tpu_torch.train.checkpoint import CheckpointManager

ADAM_BETAS = (0.9, 0.999)  # torch.optim.Adam defaults, as the reference uses
ADAM_EPS = 1e-8
ADAM_MOMENTS = ("exp_avg", "exp_avg_sq")


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


def grads_into(loss: torch.Tensor, params) -> None:
    """``loss``'s gradient into each of ``params``' ``.grad`` (replacing it),
    zeros where the loss does not reach the param. optax steps every leaf
    every time and Adam moves a leaf with a zero gradient by its momentum;
    torch's Adam skips a param whose ``.grad`` is None. A family trainer
    whose optimizers share params across losses (AdaGCL's, Grade's) fills
    every gradient so before each step."""
    params = list(params)
    for p, g in zip(params, torch.autograd.grad(loss, params, allow_unused=True)):
        p.grad = torch.zeros_like(p) if g is None else g


def opt_params(*optimizers: torch.optim.Optimizer) -> list:
    """The params ``optimizers`` step, in their param groups' order."""
    return [p for o in optimizers for g in o.param_groups for p in g["params"]]


def optimizer_tree(optimizer: torch.optim.Optimizer, like: bool = False) -> Dict:
    """An Adam's (or AdamW's) state as a checkpoint tree, one entry a param
    in the param groups' order: whether it has state yet (torch's Adam makes
    a param's state at its first step), its step count and its moments,
    zeros where it has none. With ``like``, the stand-ins ``restore`` reads
    shapes, dtypes and devices from: the params themselves, no copy."""
    params = opt_params(optimizer)
    tree = {"has": torch.tensor([bool(optimizer.state.get(p)) for p in params], dtype=torch.bool),
            "step": [], **{k: [] for k in ADAM_MOMENTS}}
    for p in params:
        st = {} if like else optimizer.state.get(p, {})
        tree["step"].append(st.get("step", torch.zeros(())))
        for k in ADAM_MOMENTS:
            tree[k].append(p if like else st.get(k, torch.zeros_like(p)))
    return tree


def load_optimizer_tree(optimizer: torch.optim.Optimizer, tree: Dict) -> None:
    """``optimizer_tree``'s state back into ``optimizer``: the params that
    had state get it, the others none."""
    sd = optimizer.state_dict()
    sd["state"] = {i: {"step": tree["step"][i], **{k: tree[k][i] for k in ADAM_MOMENTS}}
                   for i, has in enumerate(tree["has"].tolist()) if has}
    optimizer.load_state_dict(sd)


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
        if model.epoch0_params and model.table_params:
            raise ValueError(f"{model.name}: table_params and epoch0_params are mutually "
                             "exclusive (the row-sparse path has no rebuild-gated schema)")
        if model.stateful and model.table_params:
            raise NotImplementedError(f"{model.name}: a stateful model with row-sparse "
                                      "tables is not ported")
        self.model = model
        self.dataset = dataset
        self.cfg = cfg
        self.device = model.device
        self.mesh = (world_mesh(cfg.mesh_shape, self.device) if cfg.mesh_shape
                     else Mesh(device=self.device))
        # set by ``run``: the params on the mesh (on one device, the dict itself)
        self.store: Optional[ShardedParams] = None
        # One generator drives everything random in training: shuffles,
        # negatives, timesteps, noise and dropout.
        self.generator = torch.Generator(self.device).manual_seed(cfg.seed)
        self.model_state = model.init_state(
            self.device, torch.Generator(self.device).manual_seed(cfg.seed + 2))
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

    def store_for(self, params: Params) -> ShardedParams:
        """The store whose ``view`` is ``params``: ``run``'s, or for params
        given from outside (one device) a store that is the dict itself."""
        if self.store is not None and params is self.store.view:
            return self.store
        return ShardedParams(params, Mesh(device=self.device), self.model.table_params)

    def trainable(self, params: Params) -> Params:
        """What an optimizer over ``params`` steps: the store's shards."""
        return self.store_for(params).shards

    def refresh(self) -> None:
        """The store's view gathered anew after an optimizer step."""
        if self.store is not None:
            self.store.full()

    @property
    def dp_split(self) -> bool:
        """Whether each dp rank steps on its slice of a batch."""
        return self.mesh.dp > 1 and self.model.dp_split

    @deterministic_mode()
    def train_step(self, params: Params, optimizer: torch.optim.Optimizer,
                   batch: Batch) -> torch.Tensor:
        """One Adam step on a batch (a "bpr" batch with its negatives);
        returns the loss (under a dp split, this rank's slice's scaled
        part). Updates ``params`` (the tables by replacement on the CPU, in
        place on the card) and a stateful model's state."""
        store = self.store_for(params)
        share = None
        if self.dp_split:
            batch, share = shard_batch(batch, self.mesh)
        tracing.count("train.steps")
        optimizer.zero_grad(set_to_none=True)
        names = self.model.table_params
        if not names:
            with tracing.span("train.forward"):
                if self.model.stateful:
                    loss, self.model_state = self.model.loss_stateful(
                        params, self.model_state, batch, self.generator)
                else:
                    loss = self.model.loss(params, batch, self.generator)
                if share is not None:
                    loss = loss * share
            with tracing.span("train.backward"):
                if self.model.epoch0_params:
                    # off batch 0 the gated params get a zero gradient, not none
                    grads_into(loss, store.shards.values())
                else:
                    loss.backward()
            with tracing.span("train.optimizer"):
                if share is not None:
                    store.reduce_grads()
                optimizer.step()
                store.full()
            return loss
        with tracing.span("train.forward"):
            dense = {k: v for k, v in params.items() if k not in names}
            rows = self.model.table_rows(batch)
            gathered = {n: store.table_rows(n, rows[n]).requires_grad_() for n in names}
            loss = self.model.loss_tables(dense, gathered, batch, self.generator)
            if share is not None:
                loss = loss * share
        with tracing.span("train.backward"):
            loss.backward()
        with tracing.span("train.optimizer"):
            if share is not None:
                store.reduce_grads()
            optimizer.step()
            store.full()
            self.table_count += 1
            lr = float(self.cfg.learning_rate)
            for n in names:
                r, g = rows[n], gathered[n].grad
                if share is not None:
                    r, g = self.dp_table_rows(store, n, r, g)
                t, self.table_state[n] = table_adam_update(
                    store.shards[n], self.table_state[n], store.owned_rows(n, r), g,
                    self.table_count, lr, ADAM_BETAS[0], ADAM_BETAS[1], ADAM_EPS)
                store.set(n, t)
        return loss

    def dp_table_rows(self, store: ShardedParams, name: str, rows: torch.Tensor,
                      g: torch.Tensor):
        """(rows, gradients) of table ``name`` over the whole batch: each dp
        rank's, laid end to end (padded to one length with the table's row
        count, which the row-sparse Adam skips, and zero gradients)."""
        mesh = self.mesh
        n = int(mesh.all_gather(torch.tensor(rows.shape[0], device=rows.device), "dp").max())
        pad = n - rows.shape[0]
        if pad:
            rows = torch.cat([rows, rows.new_full((pad,), store.full_shape(name)[0])])
            g = torch.cat([g, g.new_zeros((pad,) + tuple(g.shape[1:]))])
        return mesh.all_gather(rows, "dp"), mesh.all_gather(g, "dp")

    def bpr_batch(self, batch: Batch) -> Batch:
        """A "bpr" batch of (user, positive) rows completed for a step: one
        negative a row, then (``needs_int_items``) one interest item a row,
        each from outside the user's history, drawn from the trainer's
        generator in that order."""
        def outside():
            return sample_negatives(self.generator, batch.users, self.history,
                                    self.model.num_item, int(self.cfg.neg_candidates))

        with tracing.span("train.sample"):
            neg = outside()
            interest = outside() if self.model.needs_int_items else None
        return dataclasses.replace(batch, neg_items=neg, int_items=interest)

    @deterministic_mode()
    def train_epoch(self, params: Params, optimizer: torch.optim.Optimizer) -> float:
        """One pass over every user (user_rows) or every edge (bpr); returns
        the sum of the batch losses."""
        losses = []
        bs = int(self.cfg.batch_size)
        with tracing.span("train.batches"):
            if self.user_rows:
                batches = make_epoch_batches(self.generator, self.dataset.num_user, bs)
            else:
                tracing.count("train.edges", self.edges.shape[0])
                batches = make_edge_batches(self.generator, self.edges, bs)
        for batch in batches:
            with tracing.span("train.step"):
                if not self.user_rows:
                    batch = self.bpr_batch(batch)
                losses.append(self.train_step(params, optimizer, batch).detach())
        with tracing.span("train.sync"):
            # freed while the card still runs the queued steps: freeing an
            # epoch's batches after the wait would leave it idle (~2 ms)
            del batches
            losses = torch.stack(losses)
            if self.dp_split:  # each batch's loss: the sum of its slices' parts
                losses = self.mesh.all_reduce(losses, "dp")
            return float(losses.sum())  # the epoch's one host sync

    @torch.no_grad()
    @deterministic_mode()
    def evaluate(self, params: Params):
        """(val, test, rank_list): full-catalog top-``rank_topk`` ranking with
        seen items masked, the users split over the mesh's ranks (on one
        device, all of them), then the metrics of both splits."""
        tracing.count("eval.passes")
        if self.model.rank_mode == "embeddings":
            with tracing.span("eval.embeddings"):
                if self.model.stateful:
                    user_emb, item_emb = self.model.embeddings_stateful(params,
                                                                        self.model_state)
                else:
                    user_emb, item_emb = self.model.embeddings(params)
            with tracing.span("eval.rank"):
                rank_list = sharded_rank(user_emb, item_emb, self.history, self.model.num_user,
                                         self.cfg.rank_topk, self.mesh, self.cfg.eval_user_chunk)
        else:
            # a fresh draw a ranking pass (LightGT's evaluation subsets, as the
            # reference's EvalDataset reshuffles, dataload.py:124-145)
            if hasattr(self.model, "resample_eval"):
                self.model.resample_eval()
            with tracing.span("eval.rank"):
                rank_list = sharded_rank_scores(self.model, params, self.history,
                                                self.model.num_user, self.cfg.rank_topk,
                                                self.mesh, self.model_state,
                                                self.cfg.eval_user_chunk)
        with tracing.span("eval.metrics"):
            val, test = gene_metrics_pair(rank_list, list(self.cfg.topk),
                                          self.val_split, self.test_split)
        return val, test, rank_list

    def checkpoint_tree(self, params: Params, optimizer: torch.optim.Optimizer,
                        early_stopping: EarlyStopping, like: bool = False) -> Dict:
        """What a checkpoint holds (with ``like``, the live structure a
        restore fills): the params, the Adam's state, the tables' moments
        and shared step count, the model state, the generator's state and
        the early-stopping cursor (its metrics go in the JSON sidecar).
        On a mesh, the single-device schema: each sharded param, its
        moments and its table moments gathered whole (with ``like``,
        stand-ins of the whole shape that hold no memory)."""
        store = self.store_for(params)

        def whole(name, t):
            if name not in store.rows:
                return t
            if like:
                return t.new_empty(()).expand(store.full_shape(name))
            return store.gather(name, t.detach())

        opt = optimizer_tree(optimizer, like)
        if store.rows:
            for i, p in enumerate(opt_params(optimizer)):
                name = store.name_of(p)
                for k in ADAM_MOMENTS:
                    opt[k][i] = whole(name, opt[k][i])
        return {
            "params": {k: whole(k, v) for k, v in store.shards.items()},
            "optimizer": opt,
            "tables": {n: TableOptState(whole(n, s.m), whole(n, s.v))
                       for n, s in self.table_state.items()},
            "table_count": self.table_count,
            "mstate": self.model_state,
            "rng": self.generator.get_state(),
            "es": {"best_score": torch.tensor(early_stopping.best_score or 0.0,
                                              dtype=torch.float64),
                   "counter": torch.tensor(early_stopping.counter, dtype=torch.int64)},
        }

    def restore(self, ckpt: CheckpointManager, step: int, params: Params,
                optimizer: torch.optim.Optimizer, early_stopping: EarlyStopping) -> None:
        """Step ``step`` of ``ckpt`` into the live params (in place: the
        optimizer holds them), the optimizer, the trainer's state and
        ``early_stopping``. On a mesh each rank keeps its rows."""
        store = self.store_for(params)
        tree, metrics = ckpt.restore(
            step, self.checkpoint_tree(params, optimizer, early_stopping, like=True),
            self.device)
        with torch.no_grad():
            for k, v in tree["params"].items():
                store.shards[k].copy_(store.local(k, v))
        opt = tree["optimizer"]
        for i, p in enumerate(opt_params(optimizer) if store.rows else ()):
            name = store.name_of(p)
            for k in ADAM_MOMENTS:
                opt[k][i] = store.local(name, opt[k][i])
        load_optimizer_tree(optimizer, opt)
        self.table_state = {n: TableOptState(store.local(n, s.m), store.local(n, s.v))
                            for n, s in tree["tables"].items()}
        self.table_count.copy_(tree["table_count"])
        self.model_state = tree["mstate"]
        self.generator.set_state(tree["rng"])
        store.full()
        if metrics is not None:
            early_stopping.best_metrics = {int(k): v for k, v in metrics.items()}
            early_stopping.best_score = float(tree["es"]["best_score"])
            early_stopping.counter = int(tree["es"]["counter"])

    def start_profile(self):
        """A started ``torch.profiler`` over the CPU, and the card's kernels
        when the trainer runs on one."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities, acc_events=True)  # one cycle: no warning
        prof.start()
        return prof

    def stop_profile(self, prof, epoch: int) -> str:
        """Ends ``prof``, logs the profiled epoch's spans (a line each:
        calls, host ms, host self ms, device ms) and counters, clears them
        (``tracing.reset``) and writes the Chrome trace into
        ``profile_dir``; returns the file's path. On the card a trace
        without a device kernel raises: the profiler could not record the
        card."""
        from torch.autograd import DeviceType

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        snap = tracing.snapshot()
        for name, s in snap["spans"].items():
            device = "none" if s["device_ms"] is None else f"{s['device_ms']:.3f}"
            logging.info("span %s: calls %d, host %.3f ms, host self %.3f ms, device %s ms",
                         name, s["calls"], s["host_ms"], s["host_self_ms"], device)
        logging.info("counters: %s", ", ".join(f"{k} {v}" for k, v in snap["counters"].items()))
        tracing.reset()
        if self.device.type == "cuda" and not any(
                e.device_type == DeviceType.CUDA for e in prof.events()):
            raise RuntimeError("--profile_dir: the profiler recorded no kernel on the card "
                               "(CUDA activity unavailable); no trace written")
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        path = os.path.join(self.cfg.profile_dir, f"epoch_{epoch + 1}.trace.json")
        prof.export_chrome_trace(path)
        return path

    @deterministic_mode()
    def run(self) -> Dict:
        cfg = self.cfg
        lead = self.mesh.rank == 0  # the rank that logs, profiles and saves
        store = self.store = shard_params(self.init_params(), self.mesh,
                                          self.model.table_params)
        params = store.view
        optimizer = self.make_optimizer(store.shards)
        early_stopping = EarlyStopping(patience=cfg.patience, verbose=lead)
        ckpt = None
        start_epoch = 0
        if cfg.checkpoint_dir and cfg.checkpoint_every > 0:
            ckpt = CheckpointManager(cfg.checkpoint_dir)
            latest = ckpt.latest_step()
            if latest is not None:
                self.restore(ckpt, latest, params, optimizer, early_stopping)
                start_epoch = latest
                logging.info("resumed from checkpoint at epoch %d", latest)
        for epoch in range(start_epoch, cfg.num_epoch):
            # the second epoch of this process: steady state, no build noise
            prof = (self.start_profile()
                    if cfg.profile_dir and epoch == start_epoch + 1 and lead else None)
            t0 = time.perf_counter()
            self.model.pre_epoch(params, epoch)
            loss = self.train_epoch(params, optimizer)
            t1 = time.perf_counter()
            val_metrics, test_metrics, rank_list = self.evaluate(params)
            t2 = time.perf_counter()
            logging.info("Epoch {}, Loss: {:.5f}".format(epoch + 1, loss))
            _log_metric_tables(val_metrics, test_metrics)
            logging.info(
                "epoch_time_s: total %.3f (train-dispatch %.3f | eval+sync %.3f)",
                t2 - t0, t1 - t0, t2 - t1,
            )
            if self.mesh.backend is not None:
                self.log_mesh_epoch(epoch, loss, rank_list)
            early_stopping(test_metrics[max(cfg.topk)]["recall"], test_metrics)
            if cfg.export_artifact and early_stopping.counter == 0:
                # host copies: the optimizer updates params in place
                self.best_params_host = store.gather_host()
                self.best_mstate_host = clone_to(self.model_state, "cpu")
            if prof is not None:
                self.stop_profile(prof, epoch)
                logging.info("profiler trace written to %s", cfg.profile_dir)
            if ckpt is not None and (epoch + 1) % cfg.checkpoint_every == 0:
                tree = self.checkpoint_tree(params, optimizer, early_stopping)
                if lead:
                    ckpt.save(epoch + 1, tree, metrics={
                        str(k): dict(v) for k, v in (early_stopping.best_metrics or {}).items()})
                del tree
            if early_stopping.early_stop:
                if lead:
                    print("Early stopping")
                break
        log_metrics("Best Test Metrics:", early_stopping.best_metrics)
        # the CLI's export falls back to these when no epoch of this
        # process was the best (a resume past the best epoch)
        self.final_params = store.gather_host() if store.rows else params
        return early_stopping.best_metrics

    def log_mesh_epoch(self, epoch: int, loss: float, rank_list: torch.Tensor) -> None:
        """Logs the epoch's loss bits and sha256 digests of the rank lists
        and of the replicated params, after checking that every rank holds
        the same: a rank that went its own way would stop early alone and
        hang the others in their next collective."""
        digests = [float(loss).hex(),
                   hashlib.sha256(rank_list.cpu().numpy().tobytes()).hexdigest(),
                   self.store.digest()]
        mine = torch.frombuffer(bytearray("|".join(digests).encode()), dtype=torch.uint8)
        mine = torch.cat([mine, torch.zeros(256 - mine.numel(), dtype=torch.uint8)])
        every = self.mesh.all_gather(mine.to(self.device)[None], "world").cpu()
        if not bool((every == every[0]).all()):
            raise RuntimeError(f"mesh {self.mesh.spec}, epoch {epoch + 1}: the ranks disagree "
                               "on the loss, the rank lists or the replicated params")
        logging.info("mesh %s epoch %d: loss %s, rank lists sha256 %s, replicated params "
                     "sha256 %s, the same on all %d ranks", self.mesh.spec, epoch + 1,
                     *digests, self.mesh.world)


def train_and_evaluate(model: RecModel, dataset: RecDataset, cfg: Config) -> Dict:
    """Convenience one-shot entry, as in the JAX package."""
    return Trainer(model, dataset, cfg).run()
