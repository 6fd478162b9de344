"""models/sgl.py and graphs/dropout.py's edge views against the JAX package's.

Both packages build SGL from ``tiny_dataset`` (64 users x 48 items) at
dim 16, 2 layers, on a float32 graph. The port takes the JAX package's
initial params (``params.from_numpy``) and its two view masks (the JAX
draw, ``bernoulli_keep`` on ``jax.random.split(rng)``, repeated here and
given to ``loss_with_masks``), and the same batches and negatives made with
numpy. Tolerances: the loss to rtol 1e-5; every gradient to 1e-4 of its
tensor's largest entry plus 1e-6 (float32 sums in another order); the
embeddings and edge weights to 1e-5.
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
from chaorec_tpu.graphs import dropout as jdropout
from chaorec_tpu.models import build_model as jbuild
from chaorec_tpu.models.base import Batch as JBatch
from chaorec_tpu_torch import cli as tcli
from chaorec_tpu_torch import params as tparams
from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.config import grid_combinations, load_yaml_config
from chaorec_tpu_torch.graphs import dropout as tdropout
from chaorec_tpu_torch.models import build_model as tbuild
from chaorec_tpu_torch.models.base import Batch as TBatch
from chaorec_tpu_torch.models.sgl import SGL
from chaorec_tpu_torch.train import loop as tloop
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

CFG = dict(Model="SGL", batch_size=64, dim_E=16, learning_rate=0.05, reg_weight=1e-3,
           n_layers=2, ssl_temp=0.2, ssl_alpha=1e-3, graph_compute_dtype="float32",
           topk=(5, 10, 20))
TOL = dict(rtol=1e-5, atol=1e-6)


def _pair(tiny_dataset, **over):
    flags = dict(CFG, **over)
    jm = jbuild(JConfig(**flags), tiny_dataset)
    tm = tbuild(TConfig(**flags), tiny_dataset, "cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = tparams.from_numpy({k: np.asarray(v) for k, v in jp.items()})
    return jm, tm, jp, tp


def jax_masks(jm, rng):
    """The two keep masks the JAX package's loss draws from ``rng``
    (sgl.py:78,132-135)."""
    e = jm.graph.u_by_u.shape[0]
    return tuple(torch.from_numpy(np.array(jdropout.bernoulli_keep(key, e, 1.0 - jm.ssl_ratio)))
                 for key in jax.random.split(rng))


def _batch(tiny_dataset, b=40, seed=0, pad=5):
    """users, positives from the train edges, negatives outside each
    history, and weights with a zeroed tail of ``pad`` rows."""
    rs = np.random.default_rng(seed)
    edges = tiny_dataset.train_edges[rs.choice(tiny_dataset.num_edges, b, replace=False)]
    hist = tiny_dataset.history
    neg = np.array([rs.choice(np.setdiff1d(np.arange(tiny_dataset.num_item),
                                           hist.values[u, :hist.lengths[u]]))
                    for u in edges[:, 0]], np.int32)
    w = np.ones(b, np.float32)
    w[b - pad:] = 0.0
    return edges[:, 0].astype(np.int32), edges[:, 1].astype(np.int32), neg, w


def _batches_both(arrays):
    u, p, n, w = arrays
    jb = JBatch(jnp.asarray(u), jnp.asarray(p), jnp.asarray(n), jnp.asarray(w))
    tb = TBatch(torch.from_numpy(u).long(), torch.from_numpy(w),
                pos_items=torch.from_numpy(p).long(), neg_items=torch.from_numpy(n).long())
    return jb, tb


def _assert_grads_close(got, want, name):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale + 1e-6, err_msg=name)


def test_user_sorted_edge_order_is_the_same(tiny_dataset):
    """SGL's masks index the user-sorted edges: both packages sort them
    the same way, so a JAX mask carries over unchanged."""
    jm, tm, _, _ = _pair(tiny_dataset)
    np.testing.assert_array_equal(tm.graph.u_by_u.numpy(), np.asarray(jm.graph.u_by_u))
    np.testing.assert_array_equal(tm.graph.i_by_u.numpy(), np.asarray(jm.graph.i_by_u))
    np.testing.assert_array_equal(np.asarray(jm._arrs[0]), np.asarray(jm.graph.u_by_u))
    np.testing.assert_array_equal(np.asarray(jm._arrs[1]), np.asarray(jm.graph.i_by_u))


@pytest.mark.parametrize("self_loops", [False, True])
def test_masked_edge_weights_and_propagate_match_jax(tiny_dataset, self_loops):
    jm, tm, _, _ = _pair(tiny_dataset)
    keep, _ = jax_masks(jm, jax.random.PRNGKey(3))
    g = tm.graph
    jw, jsu, jsi = jdropout.sorted_masked_edge_weights(
        jnp.asarray(keep.numpy()), jm._arrs, jm.num_user, jm.num_item, self_loops=self_loops)
    tw, tsu, tsi = tdropout.masked_edge_weights(g.u_by_u, g.i_by_u, keep, tm.num_user,
                                                tm.num_item, self_loops=self_loops)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    if self_loops:
        np.testing.assert_allclose(tsu.numpy(), np.asarray(jsu), **TOL)
        np.testing.assert_allclose(tsi.numpy(), np.asarray(jsi), **TOL)
    else:
        assert tsu is None and tsi is None
    assert float(tw[keep == 0].abs().max()) == 0.0

    rs = np.random.default_rng(1)
    xu = rs.standard_normal((tm.num_user, 16)).astype(np.float32)
    xi = rs.standard_normal((tm.num_item, 16)).astype(np.float32)
    ju, ji = jdropout.edge_propagate(jm._arrs[0], jm._arrs[1], jw, jnp.asarray(xu),
                                     jnp.asarray(xi), jm.num_user, jm.num_item)
    txu, txi = torch.from_numpy(xu).requires_grad_(), torch.from_numpy(xi).requires_grad_()
    tu, ti = tdropout.edge_propagate(g.u_by_u, g.i_by_u, tw, txu, txi, tm.num_user, tm.num_item)
    np.testing.assert_allclose(tu.detach().numpy(), np.asarray(ju), **TOL)
    np.testing.assert_allclose(ti.detach().numpy(), np.asarray(ji), **TOL)
    # and the gradients of a weighted sum, through autograd of index_add_
    cu = rs.standard_normal(tu.shape).astype(np.float32)
    ci = rs.standard_normal(ti.shape).astype(np.float32)
    jg = jax.grad(lambda a, b: sum(jnp.sum(c * x) for c, x in zip(
        (cu, ci), jdropout.edge_propagate(jm._arrs[0], jm._arrs[1], jw, a, b, jm.num_user,
                                          jm.num_item))), argnums=(0, 1))(jnp.asarray(xu),
                                                                          jnp.asarray(xi))
    (torch.sum(torch.from_numpy(cu) * tu) + torch.sum(torch.from_numpy(ci) * ti)).backward()
    np.testing.assert_allclose(txu.grad.numpy(), np.asarray(jg[0]), **TOL)
    np.testing.assert_allclose(txi.grad.numpy(), np.asarray(jg[1]), **TOL)


def test_bernoulli_keep_keeps_the_share():
    gen = torch.Generator().manual_seed(0)
    keep = tdropout.bernoulli_keep(gen, 20000, 0.9)
    assert keep.dtype == torch.float32 and set(keep.unique().tolist()) == {0.0, 1.0}
    assert abs(float(keep.mean()) - 0.9) < 4 * (0.09 / 20000) ** 0.5


def test_build_goes_through_build_model(tiny_dataset):
    _, tm, _, _ = _pair(tiny_dataset)
    assert isinstance(tm, SGL)
    assert (tm.dim_E, tm.n_layers, tm.ssl_temp, tm.ssl_reg, tm.reg_weight) == (16, 2, 0.2, 1e-3,
                                                                              1e-3)
    assert tm.graph.dense_r.dtype == torch.float32


def test_embeddings_match_jax(tiny_dataset):
    jm, tm, jp, tp = _pair(tiny_dataset)
    ju, ji = jm.embeddings(jp)
    with torch.no_grad():
        tu, ti = tm.embeddings(tp)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **TOL)


@pytest.mark.parametrize("pad", [5, 0])
def test_loss_and_gradients_match_jax_under_its_masks(tiny_dataset, pad):
    """The loss and both tables' gradients, with the JAX package's two
    masks, on a batch with and without a zero-weight tail."""
    jm, tm, jp, tp = _pair(tiny_dataset)
    jb, tb = _batches_both(_batch(tiny_dataset, pad=pad))
    rng = jax.random.PRNGKey(7)
    jloss, jg = jax.value_and_grad(jm.loss)(jp, jb, rng)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tloss = tm.loss_with_masks(leaves, tb, jax_masks(jm, rng))
    tloss.backward()
    assert tloss.item() == pytest.approx(float(jloss), rel=1e-5)
    for k in jg:
        _assert_grads_close(leaves[k].grad.numpy(), np.asarray(jg[k]), k)


def test_three_trainer_steps_match_jax(tiny_dataset):
    """Three steps of the port's Trainer.train_step against value_and_grad
    of the JAX loss, each from equal params, with the JAX batches,
    negatives and masks: each step's loss and gradients."""
    jm, tm, jp, tp = _pair(tiny_dataset)
    trainer = tloop.Trainer(tm, tiny_dataset, TConfig(**CFG))
    params = {k: v.clone().requires_grad_() for k, v in tp.items()}
    opt = trainer.make_optimizer(params)
    jopt_fn = optax.adam(CFG["learning_rate"])
    jopt = jopt_fn.init(jp)
    for step in range(1, 4):
        jb, tb = _batches_both(_batch(tiny_dataset, seed=step))
        rng = jax.random.PRNGKey(100 + step)
        jloss, jg = jax.value_and_grad(jm.loss)(jp, jb, rng)
        with torch.no_grad():
            for k, v in jp.items():
                params[k].copy_(torch.from_numpy(np.array(v)))
        tm.view_masks = lambda gen, masks=jax_masks(jm, rng): masks
        tloss = trainer.train_step(params, opt, tb)
        assert tloss.item() == pytest.approx(float(jloss), rel=1e-5), step
        for k in jg:
            _assert_grads_close(params[k].grad.numpy(), np.asarray(jg[k]), f"{k} step {step}")
        upd, jopt = jopt_fn.update(jg, jopt, jp)
        jp = optax.apply_updates(jp, upd)


def test_sgl_learns(tiny_dataset):
    """Test recall@20 of the untrained model (random ranking gives ~0.42 on
    the planted 24-item blocks) rises after one epoch, and stays finite."""
    cfg = TConfig(**dict(CFG, ssl_alpha=1e-5), num_epoch=1)
    trainer = tloop.Trainer(tbuild(cfg, tiny_dataset, "cpu"), tiny_dataset, cfg)
    params = trainer.init_params()
    opt = trainer.make_optimizer(params)
    before = trainer.evaluate(params)[1][20]["recall"]
    loss = trainer.train_epoch(params, opt)
    after = trainer.evaluate(params)[1][20]["recall"]
    assert np.isfinite(loss) and after > before and after > 0.5, (before, after)


# --- the CLI ----------------------------------------------------------------
DATE = r"[A-Z][a-z]{2} \d{2} [A-Z][a-z]{2} \d{4} \d{2}:\d{2}:\d{2} INFO "
NUMBER = re.compile(r"-?\d+(\.\d+)?(e-?\d+)?")


def _shapes(path):
    messages = [re.sub(DATE, "", line) for line in open(path).read().splitlines()]
    start = next(i for i, m in enumerate(messages) if m.startswith("=========1/"))
    return [NUMBER.sub("#", m) for m in messages[start:]]


def test_cli_log_matches_jax_cli(tiny_dataset, monkeypatch, tmp_path):
    """Two epochs of SGL through each package's cli.run on a one-combo
    grid (the first of Model_YAML/SGL.yaml): the same line shapes, and an
    embeddings artifact of the best epoch."""
    monkeypatch.setattr(jcli, "data_load", lambda *a, **kw: tiny_dataset)
    combo = next(grid_combinations(load_yaml_config("SGL")))
    grid = {k: [v] for k, v in combo.items()}
    grid["hyper_parameters"] = list(combo)
    flags = dict(CFG, data_path="tiny", num_epoch=2)
    root = logging.getLogger()
    handlers = list(root.handlers)
    art = str(tmp_path / "sgl.npz")
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
    jlines = _shapes(tmp_path / "jax" / "SGL_tiny.log")
    tlines = [line for line in _shapes(tmp_path / "torch" / "SGL_tiny.log")
              if not line.startswith(("export_artifact", "serving artifact"))]
    assert tlines == jlines
    assert sum(line == "Epoch #, Loss: #" for line in tlines) == 2
    assert sorted(best) == [5, 10, 20]
    with np.load(art) as z:
        assert str(z["kind"]) == "embeddings" and str(z["model"]) == "SGL"
        assert z["user_emb"].shape == (64, 16) and z["item_emb"].shape == (48, 16)
