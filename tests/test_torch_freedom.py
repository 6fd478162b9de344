"""models/freedom.py and its trainer path against the JAX package's FREEDOM.

Both packages build FREEDOM from ``tiny_dataset`` (64 users x 48 items,
32- and 16-wide features). The port takes the JAX package's initial
params (``params.from_numpy``), its pruning mask (the JAX draw repeated
here and injected with ``apply_keep_mask``), and the same batches and
negatives made with numpy. Tolerances: float32 graphs to 1e-5 (float32
sums in another order); bf16 graphs to 1e-4 relative, since a row
operator entry can round to the other bf16 neighbour when its float32 sum
is taken in another order; gradients to 1e-4 of their tensor's largest
entry plus 1e-6 absolute.
"""

import logging
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chaorec_tpu import cli as jcli
from chaorec_tpu.config import Config as JConfig
from chaorec_tpu.models import build_model as jbuild
from chaorec_tpu.models.base import Batch as JBatch
from chaorec_tpu.ops import indexed_adam as jadam
from chaorec_tpu_torch import cli as tcli
from chaorec_tpu_torch import params as tparams
from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.models import build_model as tbuild
from chaorec_tpu_torch.models.base import Batch as TBatch
from chaorec_tpu_torch.train import loop as tloop
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

# tests/test_models_e2e.py's FREEDOM settings
CFG = dict(Model="FREEDOM", batch_size=64, dim_E=16, feature_embed=16, learning_rate=0.05,
           reg_weight=1e-3, n_layers=2, mm_layers=1, ii_topk=5, dropout=0.1,
           lambda_coeff=0.8, topk=(5, 10, 20))
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "bfloat16": dict(rtol=1e-4, atol=1e-5)}


def jax_prune_mask(jm, epoch):
    """The keep mask the JAX package's pre_epoch draws (freedom.py:134-137)."""
    e = jm._edge_u.shape[0]
    key = jax.random.fold_in(jax.random.PRNGKey(6151), epoch)
    scores = jm._log_edge_w + jax.random.gumbel(key, (e,))
    keep_idx = jax.lax.top_k(scores, int(e * (1.0 - jm.dropout)))[1]
    return np.array(jnp.zeros((e,), jnp.float32).at[keep_idx].set(1.0))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(tiny_dataset, dtype="float32", prune=True, **over):
    """(jax model, port model, jax params, port params), both pruned by the
    JAX package's epoch-0 mask."""
    flags = dict(CFG, graph_compute_dtype=dtype, **over)
    jm = jbuild(JConfig(**flags), tiny_dataset)
    tm = tbuild(TConfig(**flags), tiny_dataset, "cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = tparams.from_numpy({k: np.asarray(v) for k, v in jp.items()})
    if prune:
        mask = jax_prune_mask(jm, 0)
        jm.pre_epoch(jp, None, 0)
        tm.apply_keep_mask(torch.from_numpy(mask))
    return jm, tm, jp, tp


def _batch(tiny_dataset, b=40, seed=0):
    """users, positives from the train edges, negatives outside each
    history, and weights with a zeroed tail (a padded batch)."""
    rs = np.random.default_rng(seed)
    edges = tiny_dataset.train_edges[rs.choice(tiny_dataset.num_edges, b, replace=False)]
    hist = tiny_dataset.history
    neg = np.array([rs.choice(np.setdiff1d(np.arange(tiny_dataset.num_item),
                                           hist.values[u, :hist.lengths[u]]))
                    for u in edges[:, 0]], np.int32)
    w = np.ones(b, np.float32)
    w[-5:] = 0.0
    return edges[:, 0].astype(np.int32), edges[:, 1].astype(np.int32), neg, w


def _batches_both(arrays):
    u, p, n, w = arrays
    jb = JBatch(jnp.asarray(u), jnp.asarray(p), jnp.asarray(n), jnp.asarray(w))
    tb = TBatch(torch.from_numpy(u).long(), torch.from_numpy(w),
                pos_items=torch.from_numpy(p).long(), neg_items=torch.from_numpy(n).long())
    return jb, tb


@pytest.mark.parametrize("dtype", DTYPES)
def test_build_matches_jax(tiny_dataset, dtype):
    """The frozen mixed kNN graph, the edge order and R (before pruning)."""
    jm, tm, _, _ = _pair(tiny_dataset, dtype, prune=False)
    np.testing.assert_array_equal(tm.mm_graph.indices.numpy(), np.asarray(jm.mm_graph.indices))
    np.testing.assert_allclose(tm.mm_graph.weights.numpy(), np.asarray(jm.mm_graph.weights),
                               rtol=1e-7)
    np.testing.assert_array_equal(tm._edge_u.numpy(), jm._edge_u)
    np.testing.assert_array_equal(tm._edge_i.numpy(), jm._edge_i)
    assert tm.masked_r.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    np.testing.assert_array_equal(tm.masked_r.float().numpy(), _np(jm.masked_r))


def test_no_dropout_halves_r(tiny_dataset):
    """The reference's dropout <= 0 quirk: R at half, every epoch."""
    jm, tm, jp, tp = _pair(tiny_dataset, prune=False, dropout=0.0)
    np.testing.assert_array_equal(tm.masked_r.numpy(), _np(jm.masked_r))
    np.testing.assert_array_equal(tm.masked_r.numpy(), 0.5 * tm.graph.dense_r.numpy())
    tm.pre_epoch(tp, 3)
    np.testing.assert_array_equal(tm.masked_r.numpy(), _np(jm.masked_r))


@pytest.mark.parametrize("dtype", DTYPES)
def test_pruned_graph_and_embeddings_match_jax(tiny_dataset, dtype):
    """After the same pruning mask: R, its row operators, and forward /
    embeddings at the JAX package's initial params."""
    jm, tm, jp, tp = _pair(tiny_dataset, dtype)
    np.testing.assert_allclose(tm.masked_r.float().numpy(), _np(jm.masked_r), **TOL[dtype])
    for t, j in ((tm._rt, jm._rt), (tm._rrt, jm._rrt), (tm._rtr, jm._rtr)):
        np.testing.assert_allclose(t.float().numpy(), _np(j), rtol=TOL[dtype]["rtol"] * 40,
                                   atol=TOL[dtype]["atol"])
    with torch.no_grad():
        tu, ti = tm.embeddings(tp)
    ju, ji = jm.embeddings(jp)
    assert tu.dtype == ti.dtype == torch.float32
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL[dtype])
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **TOL[dtype])


def test_prune_mask_keeps_the_share_and_changes_by_epoch(tiny_dataset):
    _, tm, _, _ = _pair(tiny_dataset, prune=False)
    e = tm._edge_u.shape[0]
    m0, m0b, m1 = tm.prune_mask(0), tm.prune_mask(0), tm.prune_mask(1)
    assert int(m0.sum()) == int(m1.sum()) == int(e * 0.9)
    assert set(m0.unique().tolist()) <= {0.0, 1.0}
    assert torch.equal(m0, m0b) and not torch.equal(m0, m1)


def test_rows_fast_path_matches_forward(tiny_dataset):
    """_rows (the per-epoch row operators) equals forward's gathered rows."""
    _, tm, _, tp = _pair(tiny_dataset, "float32")
    users, pos, neg, _ = _batch(tiny_dataset)
    items = torch.from_numpy(np.concatenate([pos, neg])).long()
    with torch.no_grad():
        fu, fi = tm.forward(tp)
        u, i = tm._rows(tp, torch.from_numpy(users).long(), items)
    np.testing.assert_allclose(u.numpy(), fu[torch.from_numpy(users).long()].numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(i.numpy(), fi[items].numpy(), rtol=1e-5, atol=1e-6)


def _assert_grads_close(got, want, name):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale + 1e-6, err_msg=name)


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_tables_and_gradients_match_jax(tiny_dataset, dtype):
    """loss_tables and its gradients (dense params and the gathered table
    rows) against jax.value_and_grad of the JAX package's loss_tables."""
    jm, tm, jp, tp = _pair(tiny_dataset, dtype)
    jb, tb = _batches_both(_batch(tiny_dataset))
    names = jm.table_params
    jdense = {k: v for k, v in jp.items() if k not in names}
    jrows = jm.table_rows(jb)
    jgath = {n: jp[n][jrows[n]] for n in names}
    jloss, (jgd, jgr) = jax.value_and_grad(jm.loss_tables, argnums=(0, 1))(
        jdense, jgath, jb, jax.random.PRNGKey(1))
    tdense = {k: v.clone().requires_grad_() for k, v in tp.items() if k not in names}
    trows = tm.table_rows(tb)
    tgath = {n: tp[n][trows[n]].requires_grad_() for n in names}
    tloss = tm.loss_tables(tdense, tgath, tb, torch.Generator())
    tloss.backward()
    assert tloss.item() == pytest.approx(float(jloss), rel=TOL[dtype]["rtol"])
    # the direct loss (gathering inside) is the same number
    assert tm.loss(tp, tb, torch.Generator()).item() == pytest.approx(tloss.item(), rel=1e-7)
    for k in jdense:
        _assert_grads_close(tdense[k].grad.numpy(), np.asarray(jgd[k]), k)
    for n in names:
        _assert_grads_close(tgath[n].grad.numpy(), np.asarray(jgr[n]), n)


@pytest.mark.parametrize("dtype", DTYPES)
def test_three_trainer_steps_match_jax(tiny_dataset, dtype):
    """Three steps of the port's Trainer.train_step against a JAX loop of
    loss_tables + optax.adam (dense) + row_adam_update (tables) with a
    shared step count, on the same batches and negatives: per-batch
    losses and final params."""
    jm, tm, jp, tp = _pair(tiny_dataset, dtype)
    lr = CFG["learning_rate"]
    names = jm.table_params
    jdense = {k: v for k, v in jp.items() if k not in names}
    opt = optax.adam(lr)
    jopt = opt.init(jdense)
    jtab = {n: jp[n] for n in names}
    jstate = {n: jadam.init_table_state(jp[n]) for n in names}
    trainer = tloop.Trainer(tm, tiny_dataset, TConfig(**dict(CFG, graph_compute_dtype=dtype)))
    params = {k: v if k in names else v.requires_grad_() for k, v in tp.items()}
    topt = trainer.make_optimizer(params)
    for step in range(1, 4):
        jb, tb = _batches_both(_batch(tiny_dataset, seed=step))
        rows = jm.table_rows(jb)
        gath = {n: jtab[n][rows[n]] for n in names}
        jloss, (gd, gr) = jax.value_and_grad(jm.loss_tables, argnums=(0, 1))(
            jdense, gath, jb, jax.random.PRNGKey(step))
        upd, jopt = opt.update(gd, jopt, jdense)
        jdense = optax.apply_updates(jdense, upd)
        for n in names:
            jtab[n], jstate[n] = jadam.row_adam_update(
                jtab[n], jstate[n], rows[n], gr[n], jnp.asarray(step, jnp.int32), lr)
        tloss = trainer.train_step(params, topt, tb)
        assert tloss.item() == pytest.approx(float(jloss), rel=1e-5), step
    assert int(trainer.table_count) == 3
    for k, want in {**jdense, **jtab}.items():
        np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    for n in names:
        np.testing.assert_allclose(trainer.table_state[n].m.numpy(), np.asarray(jstate[n].m),
                                   rtol=1e-5, atol=1e-7, err_msg=n)


def test_relaxed_precision_stores_tables_in_bf16(tiny_dataset):
    cfg = TConfig(**dict(CFG, relaxed_precision="bf16"))
    trainer = tloop.Trainer(tbuild(cfg, tiny_dataset, "cpu"), tiny_dataset, cfg)
    params = trainer.init_params()
    trainer.make_optimizer(params)
    for n in ("v_feat", "t_feat"):
        assert params[n].dtype == torch.bfloat16 and not params[n].requires_grad
        assert trainer.table_state[n].m.dtype == trainer.table_state[n].v.dtype == torch.bfloat16
    assert params["user_embedding"].dtype == torch.float32 and params["user_embedding"].requires_grad


def test_freedom_learns(tiny_dataset):
    """The port's counterpart of tests/test_models_e2e.py's FREEDOM case:
    test recall@20 of the untrained model (random ranking gives ~0.42 on
    the planted 24-item blocks) rises above 0.6 within 3 epochs, and the
    epoch loss falls."""
    cfg = TConfig(**CFG, num_epoch=3)
    trainer = tloop.Trainer(tbuild(cfg, tiny_dataset, "cpu"), tiny_dataset, cfg)
    params = trainer.init_params()
    opt = trainer.make_optimizer(params)
    trainer.model.pre_epoch(params, 0)
    recalls, losses = [trainer.evaluate(params)[1][20]["recall"]], []
    for epoch in range(cfg.num_epoch):
        trainer.model.pre_epoch(params, epoch)
        losses.append(trainer.train_epoch(params, opt))
        recalls.append(trainer.evaluate(params)[1][20]["recall"])
    assert recalls[0] < 0.5 and max(recalls[1:]) > 0.6, recalls
    assert losses[-1] < losses[0], losses


# --- the CLI ----------------------------------------------------------------
DATE = r"[A-Z][a-z]{2} \d{2} [A-Z][a-z]{2} \d{4} \d{2}:\d{2}:\d{2} INFO "
NUMBER = re.compile(r"-?\d+(\.\d+)?(e-?\d+)?")


def _shapes(path):
    lines = open(path).read().splitlines()
    assert lines and all(re.match(DATE, line) for line in lines), lines[:3]
    messages = [re.sub(DATE, "", line) for line in lines]
    start = next(i for i, m in enumerate(messages) if m.startswith("=========1/"))
    return messages[:start], [NUMBER.sub("#", m) for m in messages[start:]]


def test_cli_log_matches_jax_cli(tiny_dataset, monkeypatch, tmp_path):
    """Two epochs of FREEDOM through each package's cli.run, with the
    shipped grid (Model_YAML/FREEDOM.yaml): the same log name, argument
    keys and line shapes, and an embeddings artifact of the best epoch."""
    monkeypatch.setattr(jcli, "data_load", lambda *a, **kw: tiny_dataset)
    flags = dict(CFG, data_path="tiny", num_epoch=2)
    root = logging.getLogger()
    handlers = list(root.handlers)
    art = str(tmp_path / "freedom.npz")
    try:
        jcli.run(JConfig(**flags, log_dir=str(tmp_path / "jax")))
        best = tcli.run(TConfig(**flags, log_dir=str(tmp_path / "torch"), export_artifact=art),
                        None, tiny_dataset, "cpu")
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
            h.close()
        for h in handlers:
            root.addHandler(h)
    jargs, jlines = _shapes(tmp_path / "jax" / "FREEDOM_tiny.log")
    targs, tlines = _shapes(tmp_path / "torch" / "FREEDOM_tiny.log")
    tlines = [line for line in tlines if not line.startswith("export_artifact")
              and not line.startswith("serving artifact")]
    assert tlines == jlines
    assert [a.split(":")[0] for a in targs] == [a.split(":")[0] for a in jargs]
    assert sum(line == "Epoch #, Loss: #" for line in tlines) == 2
    assert sorted(best) == [5, 10, 20]
    with np.load(art) as z:
        assert str(z["kind"]) == "embeddings" and str(z["model"]) == "FREEDOM"
        assert z["user_emb"].shape == (64, 16) and z["item_emb"].shape == (48, 16)


def test_cli_without_a_device_needs_the_card(tiny_dataset, tmp_path):
    """cli.run defaults to the card: without one it raises before any
    work, and does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises((RuntimeError, AssertionError)):
        tcli.run(TConfig(**CFG, data_path="tiny", num_epoch=1, log_dir=str(tmp_path)),
                 None, tiny_dataset)
    assert not (tmp_path / "FREEDOM_tiny.log").exists()
