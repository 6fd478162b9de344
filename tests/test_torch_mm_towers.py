"""models/slmrec.py (with ``in_batch_ce``), vbpr.py, bm3.py and mgcl.py
against the JAX package's.

Both packages build each model from ``tiny_dataset`` (64 users x 48 items,
384 train edges, 32- and 16-wide item features) at dim 16 on a float32
graph, with its Model_YAML file's first combo otherwise (SLMRec 1 layer;
VBPR reg 1e-3; BM3 2 layers, dropout 0.1, cl_weight 1, its feature width
16 = dim_E, as its shared predictor needs; MGCL 2 layers). The port takes
the JAX package's initial params, its batches and negatives, and (BM3)
the dropout keep masks the JAX loss draws from its key, given to
``loss_with_draws``.

Tolerances are those of tests/test_torch_contrastive.py: each loss to rtol
1e-5; every gradient to 1e-4 of its tensor's largest entry plus 1e-6; the
embeddings to rtol 1e-5, atol 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chaorec_tpu.models.slmrec import in_batch_ce as j_in_batch_ce
from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.models.bm3 import BM3
from chaorec_tpu_torch.models.mgcl import MGCL
from chaorec_tpu_torch.models.slmrec import SLMRec, in_batch_ce
from chaorec_tpu_torch.models.vbpr import VBPR
from chaorec_tpu_torch.serve import Recommender
from chaorec_tpu_torch.train import loop as tloop
from test_torch_lightgcn import TOL, assert_grads_close, both_batches, jax_batches, make_pair
from test_torch_vae import cli_logs_match, t
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

BASE = dict(batch_size=100, dim_E=16, graph_compute_dtype="float32", topk=(5, 10, 20))
FLAGS = {
    "SLMRec": dict(BASE, Model="SLMRec", learning_rate=0.001, ssl_alpha=0.05, n_layers=1,
                   ssl_temp=0.2),
    "VBPR": dict(BASE, Model="VBPR", reg_weight=0.001, learning_rate=0.001),
    "BM3": dict(BASE, Model="BM3", n_layers=2, learning_rate=0.001, reg_weight=1e-4,
                dropout=0.1, cl_weight=1.0, feature_embed=16),
    "MGCL": dict(BASE, Model="MGCL", learning_rate=0.001, reg_weight=1e-4, ssl_alpha=0.01,
                 ssl_temp=0.2, n_layers=2),
}
CLASSES = {"SLMRec": SLMRec, "VBPR": VBPR, "BM3": BM3, "MGCL": MGCL}
EXPORTED = "MGCL"  # the one exported and served: its embeddings are the id tower's


@functools.partial(jax.jit, static_argnums=0)
def _bm3_draws(jm, rng):
    """BM3's dropout keep masks, as its JAX loss draws them (bm3.py:81-92)."""
    ks = jax.random.split(rng, 4)
    keep = 1.0 - jm.dropout
    shapes = {"u": (jm.num_user, jm.dim_E), "i": (jm.num_item, jm.dim_E),
              "t": (jm.num_item, jm.feat_E), "v": (jm.num_item, jm.feat_E)}
    return {k: jax.random.bernoulli(key, keep, shapes[k]).astype(jnp.float32)
            for k, key in zip(("u", "i", "t", "v"), ks)}


def loss_with(tm, params, batch, rng):
    """The port's loss on ``batch`` under the JAX loss's draws from ``rng``."""
    if isinstance(tm, BM3):
        return tm.loss_with_draws(params, batch, {k: t(v) for k, v in _bm3_draws(
            tm._jm, rng).items()})
    return tm.loss(params, batch, None)


def pair(ds, name):
    jm, tm, jp, tp = make_pair(ds, FLAGS[name])
    tm._jm = jm  # the JAX model whose draws BM3's loss takes
    return jm, tm, jp, tp


def grad_np(p):
    """A leaf's gradient; zeros where the loss never read it (MGCL's
    ``lambda_m``: JAX's gradient is zero)."""
    return np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()


_VALUE_AND_GRAD = jax.jit(jax.value_and_grad(lambda p, m, b, r: m.loss(p, b, r)),
                          static_argnums=1)


@pytest.mark.parametrize("temp", [0.2, 1.0])
def test_in_batch_ce_matches_jax(temp):
    """``in_batch_ce`` and its gradients in both inputs, on a batch whose
    last rows are weight-0 padding (still in every row's logsumexp, as in
    the JAX package)."""
    rs = np.random.default_rng(int(temp * 10))
    a, b = (rs.standard_normal((37, 16)).astype(np.float32) for _ in range(2))
    w = np.ones(37, np.float32)
    w[-5:] = 0.0
    want, (ga, gb) = jax.value_and_grad(
        lambda x, y: j_in_batch_ce(x, y, temp, jnp.asarray(w)), (0, 1))(a, b)
    ta, tb = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b).requires_grad_()
    got = in_batch_ce(ta, tb, temp, torch.from_numpy(w))
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-6)
    assert_grads_close(ta.grad.numpy(), np.asarray(ga), "a")
    assert_grads_close(tb.grad.numpy(), np.asarray(gb), "b")
    # the plain cross entropy over the unpadded rows, another way
    ce = torch.nn.functional.cross_entropy((ta @ tb.T)[:32] / temp, torch.arange(32))
    assert got.item() == pytest.approx(ce.item(), rel=1e-6)


@pytest.mark.parametrize("name", list(CLASSES))
def test_build_goes_through_build_model(tiny_dataset, name):
    jm, tm, jp, _ = pair(tiny_dataset, name)
    assert isinstance(tm, CLASSES[name]) and tm.name == name
    assert (tm.rank_mode, tm.stateful, tm.trainer_mode) == ("embeddings", False, "bpr")
    assert getattr(tm, "trainer_cls", tloop.Trainer) is tloop.Trainer
    own = tm.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    if name in ("VBPR", "BM3"):  # the raw feature tables are trainable params
        np.testing.assert_array_equal(own["v_feat"].numpy(), tiny_dataset.v_feat)
    if name == "VBPR":
        assert own["user_embedding"].shape == (64, 16 + 64)


def test_slmrec_trains_on_the_halved_operator(tiny_dataset):
    """One SLMRec layer is 0.5 D^-1/2 A D^-1/2: the reference's degrees
    counted over the doubled edge list, built here in float64 from the
    train edges."""
    _, tm, _, _ = pair(tiny_dataset, "SLMRec")
    e = tiny_dataset.train_edges
    deg = np.bincount(np.concatenate([e[:, 0], e[:, 1] + 64]), minlength=64 + 48) * 2.0
    r = np.zeros((64, 48))
    np.add.at(r, (e[:, 0], e[:, 1]), 1.0 / np.sqrt(deg[e[:, 0]] * deg[e[:, 1] + 64]))
    rs = np.random.default_rng(0)
    xu, xi = rs.standard_normal((64, 5)), rs.standard_normal((48, 5))
    au, ai = tm.tower(torch.from_numpy(xu).float(), torch.from_numpy(xi).float())
    # n_layers 1: the mean of the ego and one layer
    np.testing.assert_allclose(au.numpy(), (xu + r @ xi) / 2, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ai.numpy(), (xi + r.T @ xu) / 2, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,step", [(n, s) for n in CLASSES for s in (0, -1)],
                         ids=[f"{n}-{'full' if s == 0 else 'padded'}_batch" for n in CLASSES
                              for s in (0, -1)])
def test_loss_and_gradients_match_jax(tiny_dataset, name, step):
    jm, tm, jp, tp = pair(tiny_dataset, name)
    jb, tb = both_batches(jax_batches(tiny_dataset, 100, (step,))[0])
    rng = jax.random.PRNGKey(11 + step)
    jloss, jg = _VALUE_AND_GRAD(jp, jm, jb, rng)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tloss = loss_with(tm, leaves, tb, rng)
    tloss.backward()
    assert tloss.item() == pytest.approx(float(jloss), rel=1e-5)
    for k in jg:
        assert_grads_close(grad_np(leaves[k]), np.asarray(jg[k]), k)


@pytest.mark.parametrize("name", list(CLASSES))
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
        if name == "BM3":
            drawn = {k: t(v) for k, v in _bm3_draws(jm, rng).items()}
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


@pytest.mark.parametrize("name", list(CLASSES))
def test_cli_log_matches_jax_cli(tiny_dataset, monkeypatch, tmp_path, name):
    """Each package's cli.run of the first combo, 1 epoch: the same line
    shapes. MGCL's best epoch is exported and served: the server's answers
    are the artifact tables' own top 10 (bf16 inputs, summed in float64
    here), none of them a seen item."""
    ds = tiny_dataset
    _, art = cli_logs_match(ds, monkeypatch, tmp_path, FLAGS[name], export=name == EXPORTED)
    if not art:
        return
    with np.load(art) as z:
        assert str(z["kind"]) == "embeddings"
        user_emb, item_emb = z["user_emb"], z["item_emb"]
    assert user_emb.shape == (64, 16) and item_emb.shape == (48, 16)
    rec = Recommender.load(art, "cpu")
    # the server scores bf16 inputs with float32 products, as the JAX package's
    ub, ib = (torch.from_numpy(x).to(torch.bfloat16).double().numpy() for x in (user_emb,
                                                                               item_emb))
    users = list(range(ds.num_user))
    for u, recs in zip(users, rec.recommend(users, k=10)):
        seen = ds.history.values[u, :ds.history.lengths[u]]
        want = ib @ ub[u]
        want[seen] = -np.inf
        got = [(i - ds.num_user, s) for i, s in recs]
        assert len(got) == 10 and not set(seen.tolist()) & {i for i, _ in got}
        kth = np.sort(want)[-10]
        for i, score in got:
            assert score == pytest.approx(want[i], rel=1e-5, abs=1e-6)
            assert want[i] >= kth - 1e-6
