"""models/mgcn.py, smore.py, gume.py and grcn.py against the JAX package's.

Both packages build each model from ``tiny_dataset`` (64 users x 48 items,
384 train edges, 32- and 16-wide item features) at dim 16 on a float32
graph, with its Model_YAML file's first combo otherwise (MGCN ssl_alpha
0.01 at temperature 0.2; SMORE 3 layers, ii_topk 10, dropout 0, and also
dropout 0.1; GUME 3 U-I layers, 1 kNN layer; GRCN dropout 0.1, its
feature width 16 = dim_E). MGCN and SMORE run on the sparse U-I graph, as
their JAX builders force. The port takes the JAX package's initial params,
the JAX trainer's batches and negatives, and the draws the JAX loss makes
from its key (SMORE's preference-gate keep masks, GUME's four noise
uniforms, GRCN's edge keep mask), given to ``loss_with_draws``.

Tolerances are those of tests/test_torch_mm_towers.py: each loss to rtol
1e-5; every gradient to 1e-4 of its tensor's largest entry plus 1e-6; the
embeddings to rtol 1e-5, atol 1e-6. At ``graph_compute_dtype`` bfloat16
(GUME's dense bf16 graphs, MGCN's bf16-rounded sparse inputs) the
embeddings are held to ``PROP_TOL["bfloat16"]`` (1e-4 relative, 1e-5
absolute) and the step to a loss rtol of 1e-4 and gradients within 2^-6 of
their tensor's largest entry: each bf16 product is exact in float32 in
both packages, but a float32 sum taken in another order can round an
input, or one of ``bdot``'s gradients, to the other bf16 neighbour.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.graphs.knn import ELLGraph
from chaorec_tpu_torch.models.grcn import GRCN
from chaorec_tpu_torch.models.gume import GUME
from chaorec_tpu_torch.models.mgcn import MGCN
from chaorec_tpu_torch.models.smore import SMORE
from chaorec_tpu_torch.serve import Recommender
from chaorec_tpu_torch.train import loop as tloop
from test_torch_graphs import PROP_TOL
from test_torch_lightgcn import TOL, assert_grads_close, both_batches, jax_batches, make_pair
from test_torch_mm_towers import grad_np
from test_torch_vae import cli_logs_match, one_torch_thread, t  # noqa: F401

BASE = dict(batch_size=100, dim_E=16, graph_compute_dtype="float32", topk=(5, 10, 20))
FLAGS = {
    "MGCN": dict(BASE, Model="MGCN", learning_rate=0.001, reg_weight=1e-4, ssl_alpha=0.01,
                 ssl_temp=0.2),
    "SMORE": dict(BASE, Model="SMORE", learning_rate=0.001, n_ui_layers=3, reg_weight=1e-5,
                  ii_topk=10, dropout=0.0),
    "GUME": dict(BASE, Model="GUME", learning_rate=0.001, n_ui_layers=3, n_layers=1,
                 um_loss=0.1, vt_loss=0.1),
    "GRCN": dict(BASE, Model="GRCN", learning_rate=0.001, reg_weight=0.001, dropout=0.1,
                 n_iterations=2, feature_embed=16),
}
CLASSES = {"MGCN": MGCN, "SMORE": SMORE, "GUME": GUME, "GRCN": GRCN}
EXPORTED = "GRCN"  # exported and served
# the flags of each loss case: the first combos, and SMORE at dropout 0.1
VARIANTS = {**{n: FLAGS[n] for n in CLASSES}, "SMORE-dropout": dict(FLAGS["SMORE"], dropout=0.1)}
BF16 = ("MGCN", "GUME")
BF16_LOSS_RTOL, BF16_GRAD_SHARE = 1e-4, 2.0 ** -6


def _bern(key, p, shape):
    return jax.random.bernoulli(key, p, shape).astype(jnp.float32)


@functools.partial(jax.jit, static_argnums=(0, 2))
def _smore_draws(jm, rng, batch_size):
    """SMORE's preference-gate keep masks (smore.py:161-167): the same three
    keys for the users' (U, d) and the items' (I, d) masks."""
    keep = 1.0 - jm.dropout
    ks = jax.random.split(jax.random.fold_in(rng, 3), 3)
    out = {}
    for side, n in (("u", jm.num_user), ("i", jm.num_item)):
        for name, k in zip(("image", "text", "fusion"), ks):
            out[f"{name}_{side}"] = _bern(k, keep, (n, jm.dim_E))
    return out


@functools.partial(jax.jit, static_argnums=(0, 2))
def _gume_draws(jm, rng, batch_size):
    """GUME's noise uniforms (gume.py:300-313): the first noise term's two
    from the first half of the key's split, the second's from the other."""
    out = {}
    for name, k in zip(("integration", "ext_it"), jax.random.split(rng)):
        k1, k2 = jax.random.split(k)
        out[f"{name}_1"] = jax.random.uniform(k1, (batch_size, jm.dim_E))
        out[f"{name}_2"] = jax.random.uniform(k2, (batch_size, jm.dim_E))
    return out


@functools.partial(jax.jit, static_argnums=(0, 2))
def _grcn_draws(jm, rng, batch_size):
    """GRCN's edge keep mask (grcn.py:138-142)."""
    return {"keep": _bern(rng, 1.0 - jm.dropout, (jm.e_u.shape[0],))}


JAX_DRAWS = {"SMORE": _smore_draws, "GUME": _gume_draws, "GRCN": _grcn_draws}


def draws_of(jm, name, rng, batch_size):
    """The port's form of the draws the JAX loss of ``name`` makes from
    ``rng`` (None: a model that draws nothing; {} at dropout 0)."""
    if name not in JAX_DRAWS:
        return None
    if name in ("SMORE", "GRCN") and jm.dropout <= 0:
        return {}
    return {k: t(v) for k, v in JAX_DRAWS[name](jm, rng, batch_size).items()}


def port_loss(tm, params, batch, draws):
    if draws is None:
        return tm.loss(params, batch, None)
    return tm.loss_with_draws(params, batch, draws)


@functools.partial(jax.jit, static_argnums=1)
def _value_and_grad(jp, jm, jb, rng):
    return jax.value_and_grad(lambda p: jm.loss(p, jb, rng))(jp)


def loss_and_grads(ds, flags, step, rng_seed):
    """(JAX loss, JAX gradients, port loss, port leaves) of one batch."""
    name = flags["Model"]
    jm, tm, jp, tp = make_pair(ds, flags)
    jb, tb = both_batches(jax_batches(ds, flags["batch_size"], (step,))[0])
    rng = jax.random.PRNGKey(rng_seed)
    jloss, jg = _value_and_grad(jp, jm, jb, rng)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tloss = port_loss(tm, leaves, tb, draws_of(jm, name, rng, int(jb.users.shape[0])))
    tloss.backward()
    return jloss, jg, tloss, leaves


@pytest.mark.parametrize("name", list(CLASSES))
def test_build_goes_through_build_model(tiny_dataset, name):
    jm, tm, jp, _ = make_pair(tiny_dataset, FLAGS[name])
    assert isinstance(tm, CLASSES[name]) and tm.name == name
    assert (tm.rank_mode, tm.stateful, tm.trainer_mode) == ("embeddings", False, "bpr")
    assert getattr(tm, "trainer_cls", tloop.Trainer) is tloop.Trainer and not tm.table_params
    own = tm.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    if name in ("MGCN", "SMORE"):  # the JAX builders' force_sparse
        assert not jm.graph.use_dense and not tm.graph.use_dense and tm.graph.dense_r is None
    if name == "GRCN":
        assert tm.pat.num_edges == 2 * 384
        np.testing.assert_array_equal(tm.pat.rows.numpy(), np.asarray(jm.pat.rows))
        np.testing.assert_array_equal(tm.pat.cols.numpy(), np.asarray(jm.pat.cols))


@pytest.mark.parametrize("name", ["MGCN", "SMORE", "GUME"])
def test_knn_graphs_match_jax(tiny_dataset, name):
    """Each modal kNN graph: the same neighbours, weights to 1e-6; SMORE's
    fusion graph the same matrix."""
    jm, tm, _, _ = make_pair(tiny_dataset, FLAGS[name])
    for attr in ("image_adj", "text_adj"):
        jv, ji = getattr(jm, attr)
        g = getattr(tm, attr)
        assert isinstance(g, ELLGraph)
        np.testing.assert_array_equal(g.indices.numpy(), np.asarray(ji))
        np.testing.assert_allclose(g.weights.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-7)
    if name == "SMORE":
        n = tiny_dataset.num_item
        want = np.zeros((n, n), np.float32)
        jv, ji = (np.asarray(a) for a in jm.fusion_adj)
        np.add.at(want, (np.repeat(np.arange(n), ji.shape[1]), ji.ravel()), jv.ravel())
        got = torch.zeros(n, n).index_put_(
            (torch.arange(n).repeat_interleave(tm.fusion_adj.k), tm.fusion_adj.indices.ravel()),
            tm.fusion_adj.weights.ravel(), accumulate=True)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gume_graphs_match_jax(tiny_dataset, dtype):
    """The I-I intersection edges (as a set: the JAX package lists each
    row's in set order), the joint-degree weights of R and of the I-I graph
    (each the matrix, read off by its product with the identity at float32,
    the dense bf16 bits at bf16), and the kNN graphs' dense bf16 bits."""
    flags = dict(FLAGS["GUME"], graph_compute_dtype=dtype)
    jm, tm, _, _ = make_pair(tiny_dataset, flags)
    assert tm.graph_bf16 == jm.graph_bf16 == (dtype == "bfloat16")
    jr = jm.r_norm if jm.graph_bf16 else jm.r_norm.matvec(jnp.eye(48, dtype=jnp.float32))
    jii = jm.ii_norm if jm.graph_bf16 else jm.ii_norm.matvec(jnp.eye(48, dtype=jnp.float32))
    want_ii = set(zip(*np.nonzero(np.asarray(jnp.asarray(jii, jnp.float32)))))
    assert set(zip(tm.ii_rows.tolist(), tm.ii_cols.tolist())) == want_ii and want_ii
    assert all(r != c for r, c in want_ii)
    if dtype == "bfloat16":
        for got, want in ((tm.r_norm, jm.r_norm), (tm.ii_norm, jm.ii_norm),
                          (tm.image_adj, jm.image_adj), (tm.text_adj, jm.text_adj)):
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    else:
        eye = torch.eye(48)
        np.testing.assert_array_equal(tm.r_norm.matvec(eye).numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tm.ii_norm.matvec(eye).numpy(), np.asarray(jii))
    # the joint degrees: an item's U-I edges plus its I-I edges
    deg_i = (np.bincount(np.unique(tiny_dataset.train_edges, axis=0)[:, 1], minlength=48)
             + np.bincount(tm.ii_rows, minlength=48))
    r = (tm.r_norm.float() if dtype == "bfloat16" else tm.r_norm.matvec(torch.eye(48))).numpy()
    u, i = np.unique(tiny_dataset.train_edges, axis=0).T
    du = np.bincount(u, minlength=64).astype(np.float32) ** -0.5
    want_r = du[u] * deg_i[i].astype(np.float32) ** -0.5
    np.testing.assert_allclose(r[u, i], want_r, rtol=2 ** -8 if dtype == "bfloat16" else 1e-6)


CASES = [(v, s) for v in VARIANTS for s in (0, -1)]


@pytest.mark.parametrize("variant,step", CASES,
                         ids=[f"{v}-{'full' if s == 0 else 'padded'}_batch" for v, s in CASES])
def test_loss_and_gradients_match_jax(tiny_dataset, variant, step):
    jloss, jg, tloss, leaves = loss_and_grads(tiny_dataset, VARIANTS[variant], step, 11 + step)
    assert tloss.item() == pytest.approx(float(jloss), rel=1e-5)
    for k in jg:
        assert_grads_close(grad_np(leaves[k]), np.asarray(jg[k]), k)


def test_smore_fft_gradient_at_the_real_bins(tiny_dataset):
    """irfft drops the imaginary part of bin 0 and of the Nyquist bin (8 at
    width 16): those entries of each complex weight's gradient are the JAX
    package's (zero), and the others are not all zero."""
    jloss, jg, _, leaves = loss_and_grads(tiny_dataset, FLAGS["SMORE"], 0, 11)
    for name in ("image", "text", "fusion"):
        key = f"{name}_complex_weight"
        got, want = grad_np(leaves[key]), np.asarray(jg[key])
        assert got.shape == (1, 9, 2)
        np.testing.assert_allclose(got[0, [0, 8], 1], want[0, [0, 8], 1], rtol=0, atol=1e-9)
        assert np.abs(got[0, 1:8]).min() > 0
        assert_grads_close(got, want, key)


@pytest.mark.parametrize("name", list(CLASSES))
def test_three_trainer_steps_match_jax(tiny_dataset, name):
    """Trainer.train_step on the JAX trainer's batches (the last one padded)
    against value_and_grad of the JAX loss and optax.adam, each step from
    equal params, under the JAX loss's draws: each step's loss and
    gradients."""
    ds = tiny_dataset
    flags = FLAGS[name]
    jm, tm, jp, tp = make_pair(ds, flags)
    trainer = tloop.Trainer(tm, ds, TConfig(**flags))
    params = {k: v.clone().requires_grad_() for k, v in tp.items()}
    opt = trainer.make_optimizer(params)
    jopt_fn = optax.adam(flags["learning_rate"])
    jopt = jopt_fn.init(jp)
    for step, arrays in enumerate(jax_batches(ds, flags["batch_size"])):
        jb, tb = both_batches(arrays)
        rng = jax.random.PRNGKey(100 + step)
        jloss, jg = _value_and_grad(jp, jm, jb, rng)
        with torch.no_grad():
            for k, v in jp.items():
                params[k].copy_(torch.from_numpy(np.array(v)))
        drawn = draws_of(jm, name, rng, int(jb.users.shape[0]))
        if drawn is not None:
            tm.draws = lambda *args: drawn
        tloss = trainer.train_step(params, opt, tb)
        assert tloss.item() == pytest.approx(float(jloss), rel=1e-5), step
        for k in jg:
            assert_grads_close(grad_np(params[k]), np.asarray(jg[k]), f"{k} step {step}")
        upd, jopt = jopt_fn.update(jg, jopt, jp)
        jp = optax.apply_updates(jp, upd)


@pytest.mark.parametrize("name", list(CLASSES))
def test_embeddings_match_jax(tiny_dataset, name):
    """Ranking's tables, without draws (GRCN without edge dropout, as the
    JAX package's ``embeddings``)."""
    jm, tm, jp, tp = make_pair(tiny_dataset, FLAGS[name])
    ju, ji = jm.embeddings(jp)
    with torch.no_grad():
        tu, ti = tm.embeddings(tp)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **TOL)
    if name == "GRCN":
        assert tu.shape == (64, 48) and ti.shape == (48, 48)
        with torch.no_grad():
            dropped = tm.forward(tp, tm.draws(torch.Generator().manual_seed(0)))
        assert not torch.allclose(dropped[0], tu)


@pytest.mark.parametrize("name", BF16)
def test_bf16_graph_matches_jax(tiny_dataset, name):
    """At graph_compute_dtype bfloat16 (GUME's dense bf16 graphs, MGCN's
    sparse graph with bf16-rounded inputs): the embeddings, and one full
    batch's loss and gradients, at the bf16 tolerances of the docstring."""
    flags = dict(FLAGS[name], graph_compute_dtype="bfloat16")
    jm, tm, jp, tp = make_pair(tiny_dataset, flags)
    ju, ji = jm.embeddings(jp)
    with torch.no_grad():
        tu, ti = tm.embeddings(tp)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **PROP_TOL["bfloat16"])
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **PROP_TOL["bfloat16"])
    jloss, jg, tloss, leaves = loss_and_grads(tiny_dataset, flags, 0, 11)
    assert tloss.item() == pytest.approx(float(jloss), rel=BF16_LOSS_RTOL)
    for k in jg:
        want = np.asarray(jg[k])
        np.testing.assert_allclose(grad_np(leaves[k]), want, rtol=0,
                                   atol=BF16_GRAD_SHARE * float(np.abs(want).max()) + 1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(CLASSES))
def test_cli_log_matches_jax_cli(tiny_dataset, monkeypatch, tmp_path, name):
    """Each package's cli.run of the first combo, 2 epochs: the same line
    shapes. GRCN's best epoch is exported and served: the server's answers
    are the artifact tables' own top 10 (bf16 inputs, summed in float64
    here), none of them a seen item; its tables are 3 x dim_E wide."""
    ds = tiny_dataset
    _, art = cli_logs_match(ds, monkeypatch, tmp_path, FLAGS[name], export=name == EXPORTED,
                            num_epoch=2)
    if not art:
        return
    with np.load(art) as z:
        assert str(z["kind"]) == "embeddings" and str(z["model"]) == "GRCN"
        user_emb, item_emb = z["user_emb"], z["item_emb"]
    assert user_emb.shape == (64, 48) and item_emb.shape == (48, 48)
    rec = Recommender.load(art, "cpu")
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
