"""models/dgcf.py, ops/distcorr.py and the trainer's stateful BPR branch
against the JAX package's.

Both packages build DGCF from ``tiny_dataset`` (64 users x 48 items, 384
train edges) at dim 16 with DGCF.yaml's first combo otherwise (3 layers, 2
factors, 1 routing iteration, corDecay 0.01, reg 0.01). The port takes the
JAX package's initial params (``params.from_numpy``) and, for the trainer,
the JAX package's batches and negatives (``make_epoch_batches``,
``sample_negatives``).

Tolerances: the loss to rtol 1e-5; every gradient to 1e-4 of its tensor's
largest entry plus 1e-6 (float32 sums in another order: the segment sums
are prefix differences in both packages, summed in another order); the
embeddings to rtol 1e-5, atol 1e-6. The routing scores S are O(1) (a
softmax plus a cosine of tanh'd unit rows): each update is a sum of
products of rows that agree to ~1e-6, so S is held to atol 1e-5, also
after 3 steps that each package carries on its own.
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
from chaorec_tpu.data import sampling as jsampling
from chaorec_tpu.models import build_model as jbuild
from chaorec_tpu.models.base import Batch as JBatch
from chaorec_tpu.models.dgcf import DGCF as JDGCF
from chaorec_tpu.ops import distcorr as jdistcorr
from chaorec_tpu_torch import cli as tcli
from chaorec_tpu_torch import params as tparams
from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.config import grid_combinations, load_yaml_config
from chaorec_tpu_torch.eval.ranking import gene_ranklist
from chaorec_tpu_torch.models import build_model as tbuild
from chaorec_tpu_torch.models.base import Batch as TBatch
from chaorec_tpu_torch.models.base import RecModel
from chaorec_tpu_torch.models.dgcf import DGCF
from chaorec_tpu_torch.ops import distcorr as tdistcorr
from chaorec_tpu_torch.serve import export_artifact
from chaorec_tpu_torch.train import loop as tloop
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

CFG = dict(Model="DGCF", batch_size=100, dim_E=16, learning_rate=0.01, reg_weight=0.01,
           corDecay=0.01, n_factors=2, n_iterations=1, n_layers=3, topk=(5, 10, 20))
TOL = dict(rtol=1e-5, atol=1e-6)
S_TOL = dict(rtol=0, atol=1e-5)


def _pair(tiny_dataset, **over):
    flags = dict(CFG, **over)
    jm = jbuild(JConfig(**flags), tiny_dataset)
    tm = tbuild(TConfig(**flags), tiny_dataset, "cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = tparams.from_numpy({k: np.asarray(v) for k, v in jp.items()})
    return jm, tm, jp, tp


def _state(tm, seed=3):
    """Routing scores away from the initial ones, as after some training."""
    return np.random.default_rng(seed).uniform(-1.0, 2.0, (tm.n_factors, tm.edge_u.shape[0])
                                               ).astype(np.float32)


def _batch(tiny_dataset, b=40, seed=0, pad=5):
    rs = np.random.default_rng(seed)
    edges = tiny_dataset.train_edges[rs.choice(tiny_dataset.num_edges, b, replace=False)]
    neg = rs.integers(0, tiny_dataset.num_item, b).astype(np.int32)
    w = np.ones(b, np.float32)
    w[b - pad:] = 0.0
    return edges[:, 0].astype(np.int32), edges[:, 1].astype(np.int32), neg, w


def _batches_both(arrays):
    u, p, n, w = (np.array(a) for a in arrays)
    jb = JBatch(jnp.asarray(u), jnp.asarray(p), jnp.asarray(n), jnp.asarray(w))
    tb = TBatch(torch.from_numpy(u).long(), torch.from_numpy(w),
                pos_items=torch.from_numpy(p).long(), neg_items=torch.from_numpy(n).long())
    return jb, tb


def _assert_grads_close(got, want, name):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale + 1e-6, err_msg=name)


# --- distance correlation ---------------------------------------------------
@pytest.mark.parametrize("dup", [False, True])
def test_distance_correlation_matches_jax(dup):
    """The value to rtol 1e-5 and both gradients to 1e-2 of their largest
    entry; with ``dup``, repeated rows (zero distances, where the +1e-8
    inside the square root matters). Why the gradients' bound is wide: a
    diagonal distance is sqrt(d2 + 1e-8) of a d2 that is 0 up to the
    rounding of r_i - 2 <x_i, x_i> + r_i, and 1 / (2 sqrt(1e-8)) = 5e3
    amplifies that rounding, so each package's float32 gradient here is
    0.1-0.5% off its float64 value. The port's gradient itself is checked
    in float64 against finite differences (gradcheck)."""
    rs = np.random.default_rng(1)
    a = rs.standard_normal((40, 8))
    b = 0.5 * a + rs.standard_normal((40, 8))
    if dup:
        a[10:20] = a[0]
        b[10:20] = b[0]
    a, b = a.astype(np.float32), b.astype(np.float32)
    want, jg = jax.value_and_grad(jdistcorr.distance_correlation, argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    ta, tb = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b).requires_grad_()
    got = tdistcorr.distance_correlation(ta, tb)
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    for name, g, w in (("x1", ta.grad, jg[0]), ("x2", tb.grad, jg[1])):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-2 * np.abs(w).max(),
                                   err_msg=name)
    assert torch.autograd.gradcheck(
        tdistcorr.distance_correlation,
        tuple(torch.from_numpy(x[:12]).double().requires_grad_() for x in (a, b)))


# --- the model --------------------------------------------------------------
def test_build_goes_through_build_model(tiny_dataset):
    _, tm, _, _ = _pair(tiny_dataset)
    assert isinstance(tm, DGCF) and tm.stateful
    assert (tm.dim_E, tm.n_factors, tm.n_iterations, tm.n_layers, tm.cor_decay,
            tm.reg_weight) == (16, 2, 1, 3, 0.01, 0.01)
    state = tm.init_state("cpu")
    assert state.shape == (2, tiny_dataset.num_edges) and bool((state == 1).all())


@pytest.mark.parametrize("factors,iterations", [(2, 1), (4, 2)])
def test_embeddings_match_jax(tiny_dataset, factors, iterations):
    """embeddings_stateful under routing scores away from the initial
    ones, and the S they leave."""
    jm, tm, jp, tp = _pair(tiny_dataset, n_factors=factors, n_iterations=iterations)
    s = _state(tm)
    ju, ji, js = jm.forward(jp, jnp.asarray(s))
    with torch.no_grad():
        tu, ti, ts = tm.forward(tp, torch.from_numpy(s))
        eu, ei = tm.embeddings_stateful(tp, torch.from_numpy(s))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **S_TOL)
    assert torch.equal(eu, tu) and torch.equal(ei, ti)


@pytest.mark.parametrize("factors,iterations,pad", [(2, 1, 5), (2, 1, 0), (4, 2, 5)])
def test_loss_gradients_and_new_state_match_jax(tiny_dataset, factors, iterations, pad):
    jm, tm, jp, tp = _pair(tiny_dataset, n_factors=factors, n_iterations=iterations)
    jb, tb = _batches_both(_batch(tiny_dataset, pad=pad))
    s = _state(tm)
    (jloss, jnew), jg = jax.value_and_grad(jm.loss_stateful, has_aux=True)(
        jp, jnp.asarray(s), jb, jax.random.PRNGKey(1))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tloss, tnew = tm.loss_stateful(leaves, torch.from_numpy(s), tb, None)
    tloss.backward()
    assert not tnew.requires_grad
    assert tloss.item() == pytest.approx(float(jloss), rel=1e-5)
    for k in jg:
        _assert_grads_close(leaves[k].grad.numpy(), np.asarray(jg[k]), k)
    np.testing.assert_allclose(tnew.numpy(), np.asarray(jnew), **S_TOL)


def test_state_is_in_the_order_of_the_edges_given(tiny_dataset):
    """S follows the train edges as given, not sorted: with the edges
    shuffled, both packages give the same S, and it is the S of the sorted
    edges shuffled alike."""
    ds = tiny_dataset
    order = np.random.default_rng(4).permutation(ds.num_edges)
    shuffled = ds.train_edges[order]
    args = (16, 0.01, 0.01, 2, 1, 3)
    jm = JDGCF(ds.num_user, ds.num_item, shuffled, *args)
    tm = DGCF(ds.num_user, ds.num_item, shuffled, *args)
    tm_sorted = DGCF(ds.num_user, ds.num_item, ds.train_edges, *args)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = tparams.from_numpy({k: np.asarray(v) for k, v in jp.items()})
    s = _state(tm)
    _, _, js = jm.forward(jp, jnp.asarray(s))
    inverse = np.argsort(order)
    with torch.no_grad():
        tu, ti, ts = tm.forward(tp, torch.from_numpy(s))
        su, si, ss = tm_sorted.forward(tp, torch.from_numpy(s[:, inverse]))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **S_TOL)
    np.testing.assert_allclose(ts.numpy(), ss.numpy()[:, order], **S_TOL)
    np.testing.assert_allclose(tu.numpy(), su.numpy(), **TOL)
    np.testing.assert_allclose(ti.numpy(), si.numpy(), **TOL)


# --- the trainer's stateful BPR branch ----------------------------------------
def test_trainer_steps_carry_the_state_as_jax(tiny_dataset):
    """Three Trainer.train_step calls against value_and_grad of the JAX
    loss_stateful + optax.adam, on the JAX package's own batches and
    negatives (the last batch padded with weight-0 rows), each step from
    equal params, with S carried by each package on its own: per-batch
    losses, gradients and the carried S."""
    ds = tiny_dataset
    jm, tm, jp, tp = _pair(ds)
    trainer = tloop.Trainer(tm, ds, TConfig(**CFG))
    params = {k: v.clone().requires_grad_() for k, v in tp.items()}
    opt = trainer.make_optimizer(params)
    jopt_fn = optax.adam(CFG["learning_rate"])
    jopt = jopt_fn.init(jp)
    jstate = jm.init_state(jax.random.PRNGKey(0))
    users, pos, weights, _ = jsampling.make_epoch_batches(
        jax.random.PRNGKey(5), jnp.asarray(ds.train_edges), CFG["batch_size"])
    assert float(weights[-1].sum()) < CFG["batch_size"]  # the padded last batch
    history = jnp.asarray(ds.history.values)
    for n, b in enumerate((0, 1, users.shape[0] - 1)):
        neg = jsampling.sample_negatives(jax.random.PRNGKey(50 + b), users[b], history,
                                         ds.num_item)
        jb, tb = _batches_both((users[b], pos[b], neg, weights[b]))
        (jloss, jstate), jg = jax.value_and_grad(jm.loss_stateful, has_aux=True)(
            jp, jstate, jb, jax.random.PRNGKey(b))
        with torch.no_grad():
            for k, v in jp.items():
                params[k].copy_(torch.from_numpy(np.array(v)))
        tloss = trainer.train_step(params, opt, tb)
        assert tloss.item() == pytest.approx(float(jloss), rel=1e-5), n
        for k in jg:
            _assert_grads_close(params[k].grad.numpy(), np.asarray(jg[k]), f"{k} step {n}")
        assert isinstance(trainer.model_state, torch.Tensor)
        assert not trainer.model_state.requires_grad
        np.testing.assert_allclose(trainer.model_state.numpy(), np.asarray(jstate), **S_TOL,
                                   err_msg=f"S after step {n}")
        upd, jopt = jopt_fn.update(jg, jopt, jp)
        jp = optax.apply_updates(jp, upd)


def test_evaluate_ranks_by_the_carried_state(tiny_dataset):
    """evaluate ranks the tables of embeddings_stateful(params, the
    trainer's S), and S changes them."""
    ds = tiny_dataset
    _, tm, _, tp = _pair(ds)
    cfg = TConfig(**CFG)
    trainer = tloop.Trainer(tm, ds, cfg)
    s = torch.from_numpy(_state(tm))
    trainer.model_state = s
    _, _, rank = trainer.evaluate(tp)
    with torch.no_grad():
        ue, ie = tm.embeddings_stateful(tp, s)
        ue0, _ = tm.embeddings_stateful(tp, tm.init_state("cpu"))
    want = gene_ranklist(ue, ie, trainer.history, tm.num_user, cfg.rank_topk,
                         cfg.eval_user_chunk)
    assert torch.equal(rank, want)
    assert float((ue - ue0).abs().max()) > 1e-3


def test_best_epoch_state_is_copied_whole_and_exported(tiny_dataset, tmp_path):
    """The best epoch's S is kept as one tensor (a copy, not the live
    state), and an exported artifact holds embeddings_stateful(best params,
    best S), which differ from the tables under the initial S."""
    ds = tiny_dataset
    cfg = TConfig(**CFG, num_epoch=2, export_artifact=str(tmp_path / "unused.npz"))
    model = tbuild(cfg, ds, "cpu")
    trainer = tloop.Trainer(model, ds, cfg)
    trainer.run()
    best_p, best_s = trainer.best_params_host, trainer.best_mstate_host
    assert isinstance(best_s, torch.Tensor) and best_s.shape == (2, ds.num_edges)
    assert best_s.data_ptr() != trainer.model_state.data_ptr()
    assert not bool((best_s == 1).all())
    path = str(tmp_path / "dgcf.npz")
    export_artifact(model, best_p, best_s, ds, path)
    with torch.no_grad():
        ue, ie = model.embeddings_stateful(best_p, best_s)
        ue0, _ = model.embeddings_stateful(best_p, model.init_state("cpu"))
    with np.load(path) as z:
        assert str(z["kind"]) == "embeddings" and str(z["model"]) == "DGCF"
        np.testing.assert_array_equal(z["user_emb"], ue.numpy())
        np.testing.assert_array_equal(z["item_emb"], ie.numpy())
        assert float(np.abs(z["user_emb"] - ue0.numpy()).max()) > 1e-3


class _Gated(RecModel):
    name, stateful = "Gated", True
    device = torch.device("cpu")


@pytest.mark.parametrize("gate", ["epoch0_params", "frozen_state_epoch"])
def test_trainer_refuses_the_rebuild_gated_branch(tiny_dataset, gate):
    """The trainer takes each gate of the rebuild-gated branch (LATTICE's
    and MICRO's); what it still refuses, as the JAX trainer's
    ``init_opt_state`` does, is ``epoch0_params`` together with
    ``table_params``."""
    model = _Gated(tiny_dataset.num_user, tiny_dataset.num_item)
    setattr(model, gate, ("x",) if gate == "epoch0_params" else True)
    assert tloop.Trainer(model, tiny_dataset, TConfig(Model="Gated")).model is model
    if gate == "epoch0_params":
        model.table_params = ("x",)
        with pytest.raises(ValueError, match="table_params and epoch0_params"):
            tloop.Trainer(model, tiny_dataset, TConfig(Model="Gated"))


# --- the CLI ----------------------------------------------------------------
DATE = r"[A-Z][a-z]{2} \d{2} [A-Z][a-z]{2} \d{4} \d{2}:\d{2}:\d{2} INFO "
NUMBER = re.compile(r"-?\d+(\.\d+)?(e-?\d+)?")


def _shapes(path):
    messages = [re.sub(DATE, "", line) for line in open(path).read().splitlines()]
    start = next(i for i, m in enumerate(messages) if m.startswith("=========1/"))
    return [NUMBER.sub("#", m) for m in messages[start:]]


def test_cli_log_matches_jax_cli(tiny_dataset, monkeypatch, tmp_path):
    """Two epochs of DGCF through each package's cli.run on a one-combo
    grid (the first of Model_YAML/DGCF.yaml): the same line shapes, and an
    embeddings artifact of the best epoch."""
    monkeypatch.setattr(jcli, "data_load", lambda *a, **kw: tiny_dataset)
    combo = next(grid_combinations(load_yaml_config("DGCF")))
    grid = {k: [v] for k, v in combo.items()}
    grid["hyper_parameters"] = list(combo)
    flags = dict(CFG, data_path="tiny", num_epoch=2)
    root = logging.getLogger()
    handlers = list(root.handlers)
    art = str(tmp_path / "dgcf.npz")
    try:
        jcli.run(JConfig(**flags, log_dir=str(tmp_path / "jax")), grid)
        best = tcli.run(TConfig(**flags, log_dir=str(tmp_path / "torch"), export_artifact=art),
                        grid, tiny_dataset, "cpu")
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
            h.close()
        for h in handlers:
            root.addHandler(h)
    jlines = _shapes(tmp_path / "jax" / "DGCF_tiny.log")
    tlines = [line for line in _shapes(tmp_path / "torch" / "DGCF_tiny.log")
              if not line.startswith(("export_artifact", "serving artifact"))]
    assert tlines == jlines
    assert sum(line == "Epoch #, Loss: #" for line in tlines) == 2
    assert sorted(best) == [5, 10, 20]
    with np.load(art) as z:
        assert str(z["kind"]) == "embeddings" and str(z["model"]) == "DGCF"
        assert z["user_emb"].shape == (64, 16) and z["item_emb"].shape == (48, 16)
        assert np.isfinite(z["user_emb"]).all() and np.isfinite(z["item_emb"]).all()
