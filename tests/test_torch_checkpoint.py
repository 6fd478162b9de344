"""Checkpoint/resume and the grid cursor of the port (``train/checkpoint.py``,
``Trainer.run``, ``cli.run``), against the JAX package's.

A resumed run must give the bits of an uninterrupted one, on each branch of
the standard trainer: the losses, the best metrics, the params, the Adam's
state, the tables' moments and step count, the model state and the
generator (as tests/test_checkpoint.py holds the JAX trainer to it, here
exactly). A grid cursor written by either package's CLI is read by the
other's.
"""

import json
import logging
import os
import re
from collections import namedtuple

import numpy as np
import pytest
import torch

from chaorec_tpu import cli as jcli
from chaorec_tpu.config import Config as JConfig
from chaorec_tpu_torch import cli as tcli
from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.models import build_model as tbuild
from chaorec_tpu_torch.models import cf_diff as tcf
from chaorec_tpu_torch.train import loop as tloop
from chaorec_tpu_torch.train.checkpoint import CheckpointManager
from test_torch_adagcl_grade import FLAGS as FAMILY2
from test_torch_dgcf import CFG as DGCF
from test_torch_diffmm import FLAGS as DIFFMM
from test_torch_freedom import CFG as FREEDOM
from test_torch_gformer import FIRST as GFORMER
from test_torch_lightgcn import LIGHTGCN
from test_torch_mhrec import FLAGS as MHREC
from test_torch_mmssl import FLAGS as MMSSL
from test_torch_rebuild_gated import FLAGS as REBUILD_GATED
from test_torch_train import LEARN as CF_DIFF
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

SEED = 42
SCHEMA = "does not match the current optimizer/state schema"
Pair = namedtuple("Pair", "a b")


def _tree(fill=None):
    """Nested dicts, a tuple, a named tuple, a list, None; fp32, bf16, int32,
    int64 and float64 leaves (``fill``: every leaf set to it)."""
    g = torch.Generator().manual_seed(0)
    tree = {"params": {"w": torch.randn((3, 4), generator=g),
                       "table": torch.randn((5, 2), generator=g).to(torch.bfloat16)},
            "state": (torch.arange(5, dtype=torch.int32), None,
                      Pair(torch.ones(2), torch.tensor(7, dtype=torch.int64))),
            "es": [torch.tensor(0.123456789012345, dtype=torch.float64)]}
    if fill is not None:
        for t in (tree["params"]["w"], tree["params"]["table"], tree["state"][0],
                  tree["state"][2].a, tree["state"][2].b, tree["es"][0]):
            t.fill_(fill)
    return tree


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_manager_round_trip_keeps_last_three(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.latest_step() is None
    tree = _tree()
    for step in (1, 2, 3, 4):
        mgr.save(step, tree, metrics={"20": {"recall": 0.5 + step}})
    assert mgr.latest_step() == 4
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_2", "step_3", "step_4"]
    got, metrics = mgr.restore(4, _tree(fill=0))
    assert metrics == {"20": {"recall": 4.5}}
    assert isinstance(got["state"], tuple) and isinstance(got["state"][2], Pair)
    assert got["state"][1] is None and isinstance(got["es"], list)
    for a, b in zip(_leaves(got), _leaves(tree)):
        if b is None:
            continue
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
    assert mgr.restore(3, _tree())[1] == {"20": {"recall": 3.5}}


def test_manager_ignores_an_incomplete_step(tmp_path):
    """A process killed mid-write leaves a temporary directory, or a step
    directory without its state: neither is a step."""
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(2, _tree())
    os.makedirs(tmp_path / "ck" / "step_3.tmp-12345")
    (tmp_path / "ck" / "step_3.tmp-12345" / "state.pt").write_bytes(b"torn")
    os.makedirs(tmp_path / "ck" / "step_4")
    assert mgr.latest_step() == 2
    mgr.save(3, _tree())  # a later save of the same step replaces the torn one
    assert mgr.latest_step() == 3


def _wrong_shape(t):
    t["params"]["w"] = torch.zeros((4, 3))


def _wrong_dtype(t):
    t["params"]["table"] = t["params"]["table"].float()


def _extra_leaf(t):
    t["params"]["extra"] = torch.zeros(1)


def _tensor_for_none(t):
    t["state"] = (t["state"][0], torch.zeros(1), t["state"][2])


def _fewer_entries(t):
    t["es"] = []


@pytest.mark.parametrize("change", [_wrong_shape, _wrong_dtype, _extra_leaf, _tensor_for_none,
                                    _fewer_entries])
def test_manager_schema_mismatch_raises_the_jax_message(tmp_path, change):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, _tree())
    like = _tree()
    change(like)
    with pytest.raises(RuntimeError, match=SCHEMA):
        mgr.restore(1, like)


class Recorder:
    """A trainer of ``flags`` whose epochs' losses and optimizer are kept."""

    def __init__(self, ds, flags, ckpt, epochs, every=2, **over):
        self.cfg = TConfig(**flags, seed=SEED, num_epoch=epochs, checkpoint_dir=str(ckpt),
                           checkpoint_every=every, **over)
        model = tbuild(self.cfg, ds, "cpu")
        self.trainer = getattr(model, "trainer_cls", tloop.Trainer)(model, ds, self.cfg)
        self.base = base = getattr(self.trainer, "_base", self.trainer)
        self.losses = []
        epoch, make = base.train_epoch, base.make_optimizer

        def train_epoch(params, optimizer):
            self.losses.append(epoch(params, optimizer))
            return self.losses[-1]

        def make_optimizer(params):
            self.optimizer = make(params)
            return self.optimizer

        base.train_epoch, base.make_optimizer = train_epoch, make_optimizer

    def run(self):
        self.best = self.trainer.run()
        return self


def _same(a, b, what):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        if x is None or y is None:
            assert x is None and y is None, (what, i)
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, (what, i)
        eq = torch.equal(x.view(torch.int16), y.view(torch.int16)) \
            if x.dtype == torch.bfloat16 else torch.equal(x, y)
        assert eq, (what, i)


BRANCHES = {
    "LightGCN": (LIGHTGCN, {}),  # plain BPR
    "FREEDOM": (FREEDOM, {}),  # row-sparse tables
    "FREEDOM-bf16": (FREEDOM, dict(relaxed_precision="bf16")),
    "DGCF": (DGCF, {}),  # stateful BPR: its routing scores
    "CF_Diff": (CF_DIFF, {}),  # user rows
    "LATTICE": (REBUILD_GATED["LATTICE"], {}),  # rebuild-gated: zero-gradient steps
}


@pytest.mark.parametrize("name", list(BRANCHES))
def test_resume_equals_uninterrupted(tiny_dataset, tmp_path, monkeypatch, caplog, name):
    """4 epochs checkpointed every 2, against 2 epochs and then a resume to
    4 from the same directory: the same bits throughout."""
    monkeypatch.setattr(tcf.CF_Diff, "dim_inters", 64)  # CF_Diff's small width
    flags, over = BRANCHES[name]
    full = Recorder(tiny_dataset, flags, tmp_path / "full", 4, **over).run()
    first = Recorder(tiny_dataset, flags, tmp_path / "split", 2, **over).run()
    assert sorted(os.listdir(tmp_path / "split")) == ["step_2"]
    with caplog.at_level(logging.INFO):
        rest = Recorder(tiny_dataset, flags, tmp_path / "split", 4, **over).run()
    assert "resumed from checkpoint at epoch 2" in caplog.messages
    assert len(full.losses) == 4 and np.all(np.isfinite(full.losses))
    assert first.losses + rest.losses == full.losses  # floats: equal bits
    assert rest.best == full.best
    fb, rb = full.base, rest.base
    _same(fb.final_params, rb.final_params, "params")
    _same(tloop.optimizer_tree(full.optimizer), tloop.optimizer_tree(rest.optimizer), "adam")
    assert [p in full.optimizer.state for g in full.optimizer.param_groups for p in g["params"]] \
        == [p in rest.optimizer.state for g in rest.optimizer.param_groups for p in g["params"]]
    _same(fb.table_state, rb.table_state, "table moments")
    assert bool(fb.model.table_params) == bool(fb.table_state)
    assert int(fb.table_count) == int(rb.table_count) == (
        4 * -(-tiny_dataset.num_edges // flags["batch_size"]) if fb.table_state else 0)
    _same(fb.model_state, rb.model_state, "model state")
    _same(fb.generator.get_state(), rb.generator.get_state(), "generator")
    if over.get("relaxed_precision") == "bf16":
        assert all(rb.final_params[n].dtype == torch.bfloat16 for n in rb.model.table_params)


def test_family_trainer_resumes_with_fresh_generator_adams(tiny_dataset, tmp_path, caplog):
    """AdaGCL runs through the base trainer's resume; its generators' Adams
    live outside the base and are made anew, as in the JAX package: after
    the resumed epoch they hold one epoch's steps, not three."""
    flags = FAMILY2["AdaGCL"]
    Recorder(tiny_dataset, flags, tmp_path / "ck", 2, every=1).run()
    with caplog.at_level(logging.INFO):
        rest = Recorder(tiny_dataset, flags, tmp_path / "ck", 3, every=1).run()
    assert "resumed from checkpoint at epoch 2" in caplog.messages
    assert len(rest.losses) == 1 and np.isfinite(rest.losses[0])
    assert sorted(rest.best) == [5, 10, 20]
    batches = -(-tiny_dataset.num_edges // flags["batch_size"])
    for opt in rest.trainer.gen_opts:
        steps = {float(s["step"]) for s in opt.state.values()}
        assert steps == {float(batches)}, steps
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_1", "step_2", "step_3"]


# the family trainers that keep no state outside the base trainer, and those
# that do (made anew on resume, as in the JAX package)
FAMILY = {"DiffMM": DIFFMM, "MHRec": MHREC, "MMSSL": MMSSL}
FAMILY_OUTSIDE = {"Grade": FAMILY2["Grade"], "GFormer": GFORMER}


@pytest.mark.parametrize("name", list(FAMILY) + list(FAMILY_OUTSIDE))
def test_family_trainer_resumes(tiny_dataset, tmp_path, caplog, name):
    """A rerun of a family trainer from its checkpoint restores the state
    its epochs left (DiffMM's rebuilt graphs, MHRec's incidence layouts,
    MMSSL's) and runs to its end. Where the trainer keeps nothing outside
    the base, the resumed run gives the uninterrupted run's bits."""
    flags = {**FAMILY, **FAMILY_OUTSIDE}[name]
    full = Recorder(tiny_dataset, flags, tmp_path / "full", 2, every=1).run()
    first = Recorder(tiny_dataset, flags, tmp_path / "split", 1, every=1).run()
    with caplog.at_level(logging.INFO):
        rest = Recorder(tiny_dataset, flags, tmp_path / "split", 2, every=1).run()
    assert "resumed from checkpoint at epoch 1" in caplog.messages
    assert len(rest.losses) == 1 and np.isfinite(rest.losses[0])
    assert sorted(rest.best) == [5, 10, 20]
    assert sorted(os.listdir(tmp_path / "split")) == ["step_1", "step_2"]
    if name in FAMILY:
        assert first.losses + rest.losses == full.losses
        assert rest.best == full.best
        fb, rb = full.base, rest.base
        _same(fb.final_params, rb.final_params, "params")
        _same(tloop.optimizer_tree(full.optimizer), tloop.optimizer_tree(rest.optimizer), "adam")
        _same(fb.model_state, rb.model_state, "model state")
        _same(fb.generator.get_state(), rb.generator.get_state(), "generator")


def test_profile_dir_traces_the_second_epoch(tiny_dataset, tmp_path, caplog):
    prof = tmp_path / "prof"
    cfg = TConfig(**LIGHTGCN, seed=SEED, num_epoch=2, profile_dir=str(prof))
    with caplog.at_level(logging.INFO):
        tloop.Trainer(tbuild(cfg, tiny_dataset, "cpu"), tiny_dataset, cfg).run()
    assert os.listdir(prof) == ["epoch_2.trace.json"]
    assert f"profiler trace written to {prof}" in caplog.messages
    trace = json.loads((prof / "epoch_2.trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)

    one = tmp_path / "one"
    cfg = cfg.replace(num_epoch=1, profile_dir=str(one))
    tloop.Trainer(tbuild(cfg, tiny_dataset, "cpu"), tiny_dataset, cfg).run()
    assert not one.exists()


# --- the CLI: checkpoint_dir alone, the export after a resume, the cursor ---


@pytest.fixture
def quiet_root():
    """The root logger's handlers as they were, after the CLIs replace them."""
    root = logging.getLogger()
    handlers = list(root.handlers)
    yield
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    for h in handlers:
        root.addHandler(h)


def _messages(path):
    return [re.sub(r"^.*? (INFO|WARNING) ", "", line)
            for line in open(path).read().splitlines()]


GRID = {"learning_rate": [0.01, 0.05], "hyper_parameters": ["learning_rate"]}


def _run_both(tiny_dataset, monkeypatch, tmp_path, ckpt, tag, flags, package):
    monkeypatch.setattr(jcli, "data_load", lambda *a, **kw: tiny_dataset)
    log_dir = str(tmp_path / f"log_{tag}")
    if package == "jax":
        jcli.run(JConfig(**flags, log_dir=log_dir, checkpoint_dir=str(ckpt)), dict(GRID))
    else:
        tcli.run(TConfig(**flags, log_dir=log_dir, checkpoint_dir=str(ckpt)), dict(GRID),
                 tiny_dataset, "cpu")
    return _messages(os.path.join(log_dir, "LightGCN_tiny.log"))


def test_checkpoint_dir_alone_writes_nothing(tiny_dataset, tmp_path, quiet_root):
    ckpt = tmp_path / "ck"
    flags = dict(LIGHTGCN, data_path="tiny", num_epoch=2, seed=SEED,
                 log_dir=str(tmp_path / "log"), checkpoint_dir=str(ckpt), checkpoint_every=0)
    tcli.run(TConfig(**flags), dict(GRID), tiny_dataset, "cpu")
    assert not ckpt.exists() or os.listdir(ckpt) == []


def _best_lines(messages):
    start = next(i for i, m in enumerate(messages) if m.startswith("Best performance:"))
    return messages[start:]


@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch")])
def test_grid_cursor_is_read_by_the_other_package(tiny_dataset, monkeypatch, tmp_path,
                                                  quiet_root, writer, reader):
    """The writer runs the two-combo grid with checkpoints; the reader, and
    the writer again, skip both combos from the cursor and choose the same
    best combo with the same lines."""
    flags = dict(LIGHTGCN, data_path="tiny", num_epoch=1, seed=SEED, checkpoint_every=1)
    ckpt = tmp_path / "ck"
    wrote = _run_both(tiny_dataset, monkeypatch, tmp_path, ckpt, "w", flags, writer)
    cursor = json.loads((ckpt / "grid_cursor.json").read_text())
    assert sorted(cursor) == ["0", "1"] and sorted(cursor["0"]) == ["10", "20", "5"]
    assert sorted(os.listdir(ckpt)) == ["combo_0", "combo_1", "grid_cursor.json"]
    read = _run_both(tiny_dataset, monkeypatch, tmp_path, ckpt, "r", flags, reader)
    again = _run_both(tiny_dataset, monkeypatch, tmp_path, ckpt, "a", flags, writer)
    skips = [m for m in read if "already finished" in m]
    assert skips == ["combo 1 already finished - skipping (grid cursor)",
                     "combo 2 already finished - skipping (grid cursor)"]
    assert skips == [m for m in again if "already finished" in m]
    assert not any(m.startswith("Epoch ") for m in read + again)
    assert _best_lines(read) == _best_lines(wrote) == _best_lines(again)


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_export_after_resume(tiny_dataset, monkeypatch, tmp_path, quiet_root, package):
    """A run killed after its last checkpoint but before the cursor write
    resumes past its best epoch with no epoch left: the export takes the
    final-epoch weights. Rerun once more, the best combo comes from the
    cursor: no live weights, the JAX CLI's warning, no crash."""
    grid = {"learning_rate": [0.01], "hyper_parameters": ["learning_rate"]}
    monkeypatch.setattr(jcli, "data_load", lambda *a, **kw: tiny_dataset)
    ckpt, art = tmp_path / "ck", tmp_path / "m.npz"

    def run(tag):
        flags = dict(LIGHTGCN, data_path="tiny", num_epoch=2, seed=SEED, checkpoint_every=2,
                     checkpoint_dir=str(ckpt), export_artifact=str(art),
                     log_dir=str(tmp_path / tag))
        if package == "jax":
            jcli.run(JConfig(**flags), dict(grid))
        else:
            tcli.run(TConfig(**flags), dict(grid), tiny_dataset, "cpu")
        return _messages(tmp_path / tag / "LightGCN_tiny.log")

    first = run("first")
    assert f"export_artifact: exporting best-epoch weights to {art}" in first
    os.remove(ckpt / "grid_cursor.json")
    os.remove(art)
    resumed = run("resumed")
    assert "resumed from checkpoint at epoch 2" in resumed
    assert not any(m.startswith("Epoch ") for m in resumed)
    assert f"export_artifact: exporting final-epoch weights to {art}" in resumed
    assert art.exists()
    art.unlink()
    cursor = run("cursor")
    assert "export_artifact: best combo resumed from the grid cursor - re-run it to export" \
        in cursor
    assert not art.exists()
    assert _best_lines(cursor) == _best_lines(first)
