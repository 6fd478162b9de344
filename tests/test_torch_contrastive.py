"""models/hccf.py, lightgcl.py, vgcl.py and graphaug.py against the JAX
package's.

Both packages build each model from ``tiny_dataset`` (64 users x 48 items,
384 train edges) at dim 16 on a float32 graph, with its Model_YAML file's
first combo otherwise (HCCF 3 layers at keepRate 1, and also at keepRate
0.7, where its edge and hyper dropouts draw; LightGCL 2 layers; VGCL 4
layers, 50 user and 48 item clusters; GraphAug 3 layers, 7680 random
edges). The port takes the JAX package's initial params, its batches and
negatives, and the draws the JAX loss makes from its key, given to
``loss_with_draws``: HCCF's dropout masks, VGCL's noise and k-means
initial rows, GraphAug's dropout masks, gate and RelaxedBernoulli
uniforms and random edges. LightGCL draws nothing at a step: the port is
fed the JAX builder's SVD factors.

Tolerances: each loss to rtol 1e-5; every gradient to 1e-4 of its
tensor's largest entry plus 1e-6; the embeddings to rtol 1e-5, atol 1e-6.
"""

import functools

import jax
import numpy as np
import optax
import pytest
import torch

from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.models.graphaug import GraphAug
from chaorec_tpu_torch.models.hccf import HCCF
from chaorec_tpu_torch.models.lightgcl import LightGCL
from chaorec_tpu_torch.models.vgcl import VGCL
from chaorec_tpu_torch.train import loop as tloop
from test_torch_lightgcn import assert_grads_close, both_batches, jax_batches, make_pair
from test_torch_vae import cli_logs_match, t
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

BASE = dict(batch_size=100, dim_E=16, graph_compute_dtype="float32", topk=(5, 10, 20))
HCCF_F = dict(BASE, Model="HCCF", n_layers=3, learning_rate=0.001, reg_weight=1e-5,
              ssl_alpha=0.1, ssl_temp=0.5, leaky=0.5, keepRate=1.0, mult=0.01)
LIGHTGCL_F = dict(BASE, Model="LightGCL", n_layers=2, learning_rate=0.001, reg_weight=0.0,
                  ssl_alpha=0.01, ssl_temp=0.1)
VGCL_F = dict(BASE, Model="VGCL", n_layers=4, learning_rate=0.001, reg_weight=0.001,
              ssl_alpha=0.4, ssl_temp=0.2)
GRAPHAUG_F = dict(BASE, Model="GraphAug", n_layers=3, learning_rate=0.001, reg_weight=0.001,
                  ssl_alpha=0.01, ssl_temp=0.2)
FLAGS = {"HCCF": HCCF_F, "LightGCL": LIGHTGCL_F, "VGCL": VGCL_F, "GraphAug": GRAPHAUG_F,
         # the dropouts on, beside the first combo's keepRate 1; LightGCL's reg on
         "HCCF-dropout": dict(HCCF_F, keepRate=0.7, n_layers=2),
         "LightGCL-reg": dict(LIGHTGCL_F, reg_weight=1e-7)}
CLASSES = {"HCCF": HCCF, "LightGCL": LightGCL, "VGCL": VGCL, "GraphAug": GraphAug}
TOL = dict(rtol=1e-5, atol=1e-6)


def pair(ds, name):
    """(JAX model, port model, JAX params, port params); LightGCL's port
    model takes the JAX builder's SVD factors."""
    jm, tm, jp, tp = make_pair(ds, FLAGS[name])
    if isinstance(tm, LightGCL):
        tm.u_mul_s, tm.v_mul_s, tm.ut, tm.vt = (t(x) for x in (jm.u_mul_s, jm.v_mul_s, jm.ut,
                                                               jm.vt))
    return jm, tm, jp, tp


@functools.partial(jax.jit, static_argnums=0)
def _jax_draws(jm, rng):
    """The draws the JAX loss makes from ``rng``, repeating its split order
    (hccf.py:69-106, vgcl.py:75-107, graphaug.py:240-284)."""
    if jm.name == "HCCF":
        keep, out = jm.keep_rate, []
        for _ in range(jm.n_layers):
            rng, k_adj, k_hu, k_hi = jax.random.split(rng, 4)
            ku, ki = jax.random.split(k_adj)
            out.append({"edge_u": jax.random.bernoulli(ku, keep, jm.graph.w_by_u.shape) * 1.0,
                        "edge_i": jax.random.bernoulli(ki, keep, jm.graph.w_by_i.shape) * 1.0,
                        "hyper_u": jax.random.bernoulli(k_hu, keep, (jm.num_user, jm.dim_E)) * 1.0,
                        "hyper_i": jax.random.bernoulli(k_hi, keep, (jm.num_item, jm.dim_E)) * 1.0})
        return out
    if jm.name == "VGCL":
        k1, k2, ku, ki = jax.random.split(rng, 4)
        shape = (jm.num_user + jm.num_item, jm.dim_E)
        return {"noise1": jax.random.normal(k1, shape), "noise2": jax.random.normal(k2, shape),
                "init_u": jax.random.choice(ku, jm.num_user, (jm.n_user_cluster,), replace=False),
                "init_i": jax.random.choice(ki, jm.num_item, (jm.n_item_cluster,), replace=False)}
    k_mix, k_v1, k_v2 = jax.random.split(rng, 3)
    ks = jax.random.split(k_mix, 6)
    shape = (jm.n_nodes, jm.mixhop_width)
    keep = [jax.random.bernoulli(k, 1.0 - jm.mixhop_dropout, shape) * 1.0 for k in ks]
    views = []
    for k in (k_v1, k_v2):
        k1, k2, k3 = jax.random.split(k, 3)
        e2 = jm.src.shape[0]
        views.append({"gate_u": jax.random.uniform(k1, (e2,), minval=1e-4, maxval=1 - 1e-4),
                      "relaxed_u": jax.random.uniform(k2, (e2,), minval=1e-6, maxval=1 - 1e-6),
                      "r_src": jax.random.randint(k3, (jm.n_rand,), 0, jm.num_user),
                      "r_dst": jax.random.randint(jax.random.fold_in(k3, 1), (jm.n_rand,), 0,
                                                  jm.num_item)})
    return {"keep": keep, "views": views}


def jax_draws(jm, rng):
    """``_jax_draws`` as tensors (indices int64); None where the model draws
    nothing (LightGCL, HCCF at keepRate 1)."""
    if jm.name == "LightGCL" or (jm.name == "HCCF" and jm.keep_rate >= 1.0):
        return None

    def conv(x):
        x = t(x)
        return x.long() if not x.is_floating_point() else x

    return jax.tree_util.tree_map(conv, _jax_draws(jm, rng))


def loss_with(tm, params, batch, draws):
    if isinstance(tm, LightGCL):
        return tm.loss(params, batch, None)
    return tm.loss_with_draws(params, batch, draws)


def grad_np(p):
    """A leaf's gradient; zeros where the loss never read it (GraphAug's
    edge MLP, detached as in the reference: JAX's gradient is zero)."""
    return np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()


def _loss(p, m, b, r):
    return m.loss(p, b, r)


_VALUE_AND_GRAD = jax.jit(jax.value_and_grad(_loss))


@pytest.mark.parametrize("name", list(CLASSES))
def test_build_goes_through_build_model(tiny_dataset, name):
    jm, tm, jp, _ = pair(tiny_dataset, name)
    assert isinstance(tm, CLASSES[name]) and tm.name == name
    assert (tm.rank_mode, tm.stateful, tm.trainer_mode) == ("embeddings", False, "bpr")
    own = tm.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    if name == "VGCL":
        assert (tm.n_user_cluster, tm.n_item_cluster, tm.temp_cluster) == (50, 48, 0.7 * 0.2)
    if name == "GraphAug":
        assert tm.n_rand == 7680 == jm.n_rand
        np.testing.assert_array_equal(tm.src.numpy(), np.asarray(jm.src))
        np.testing.assert_array_equal(tm.dst.numpy(), np.asarray(jm.dst))


@pytest.mark.parametrize("name,step", [(n, s) for n in FLAGS for s in (0, -1)],
                         ids=[f"{n}-{'full' if s == 0 else 'padded'}_batch" for n in FLAGS
                              for s in (0, -1)])
def test_loss_and_gradients_match_jax(tiny_dataset, name, step):
    jm, tm, jp, tp = pair(tiny_dataset, name)
    jb, tb = both_batches(jax_batches(tiny_dataset, 100, (step,))[0])
    rng = jax.random.PRNGKey(11 + step)
    jloss, jg = _VALUE_AND_GRAD(jp, jm, jb, rng)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tloss = loss_with(tm, leaves, tb, jax_draws(jm, rng))
    tloss.backward()
    assert tloss.item() == pytest.approx(float(jloss), rel=1e-5)
    for k in jg:
        assert_grads_close(grad_np(leaves[k]), np.asarray(jg[k]), k)


@pytest.mark.parametrize("name", list(FLAGS))
def test_three_trainer_steps_match_jax(tiny_dataset, name):
    """Trainer.train_step on the JAX trainer's batches (the last one padded)
    against value_and_grad of the JAX loss and optax.adam, each step from
    equal params, under the JAX loss's draws: each step's loss and
    gradients."""
    ds = tiny_dataset
    jm, tm, jp, tp = pair(ds, name)
    flags = FLAGS[name]
    trainer = tloop.Trainer(tm, ds, TConfig(**flags))
    params = {k: v.clone().requires_grad_() for k, v in tp.items()}
    opt = trainer.make_optimizer(params)
    jopt_fn = optax.adam(flags["learning_rate"])
    jopt = jopt_fn.init(jp)
    for step, arrays in enumerate(jax_batches(ds, flags["batch_size"])):
        jb, tb = both_batches(arrays)
        rng = jax.random.PRNGKey(100 + step)
        jloss, jg = _VALUE_AND_GRAD(jp, jm, jb, rng)
        with torch.no_grad():
            for k, v in jp.items():
                params[k].copy_(torch.from_numpy(np.array(v)))
        drawn = jax_draws(jm, rng)
        tm.draws = lambda *args: drawn
        tloss = trainer.train_step(params, opt, tb)
        assert tloss.item() == pytest.approx(float(jloss), rel=1e-5), step
        for k in jg:
            assert_grads_close(grad_np(params[k]), np.asarray(jg[k]), f"{k} step {step}")
        upd, jopt = jopt_fn.update(jg, jopt, jp)
        jp = optax.apply_updates(jp, upd)


@pytest.mark.parametrize("name", list(CLASSES))
def test_embeddings_match_jax(tiny_dataset, name):
    jm, tm, jp, tp = pair(tiny_dataset, name)
    ju, ji = jm.embeddings(jp)
    with torch.no_grad():
        tu, ti = tm.embeddings(tp)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lightgcl_builder_takes_the_svd_of_r_as_stored(tiny_dataset, dtype):
    """The builder's rank-5 factors are ``randomized_svd`` (generator seeded
    ``seed``) of R in graph_compute_dtype (bf16 by default), cast to
    float32 after that rounding: equal bits to that call, and singular
    values within 1e-3 (relative) of the exact SVD of that R (the sketch's
    own error after four power iterations on this R is about 4e-4)."""
    from chaorec_tpu_torch.ops.svd import randomized_svd

    tm = make_pair(tiny_dataset, dict(LIGHTGCL_F, graph_compute_dtype=dtype))[1]
    assert tm.graph.dense_r.dtype == getattr(torch, dtype)
    r = tm.graph.dense_r.to(torch.float32)
    u, s, v = randomized_svd(torch.Generator().manual_seed(TConfig().seed), r, 5)
    assert torch.equal(tm.u_mul_s, u * s[None, :]) and torch.equal(tm.vt, v.T)
    assert torch.equal(tm.v_mul_s, v * s[None, :]) and torch.equal(tm.ut, u.T)
    exact = np.linalg.svd(r.numpy().astype(np.float64), compute_uv=False)[:5]
    np.testing.assert_allclose(s.numpy(), exact, rtol=1e-3)
    assert tm.ut.shape == (5, 64) and tm.vt.shape == (5, 48)


def test_graphaug_views_cut_weights_at_and_below_its_threshold(tiny_dataset):
    """A view's edge weights are 0 or above 0.2, and its random edges land
    at raw item ids in node space (the reference's quirk)."""
    jm, tm, jp, tp = pair(tiny_dataset, "GraphAug")
    d = tm.draws(torch.Generator().manual_seed(0))
    emb = tm.mixhop(tp, tm.main(tp).detach(), d["keep"])
    w, r_src, r_dst = tm.view_edges(tp, emb, d["views"][0])
    assert w.shape == (768,) and ((w == 0) | (w > 0.2)).all() and (w == 0).any()
    assert int(r_src.max()) < 64 and int(r_dst.max()) < 48 and r_dst.shape == (7680,)


@pytest.mark.parametrize("name", list(CLASSES))
def test_cli_log_matches_jax_cli(tiny_dataset, monkeypatch, tmp_path, name):
    _, art = cli_logs_match(tiny_dataset, monkeypatch, tmp_path, FLAGS[name],
                            export=name == "HCCF")
    if art:
        with np.load(art) as z:
            assert str(z["kind"]) == "embeddings"
            assert z["user_emb"].shape == (64, 16) and z["item_emb"].shape == (48, 16)
