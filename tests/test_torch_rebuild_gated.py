"""The rebuild-gated branch: graphs/knn.py's differentiable kNN,
models/lattice.py and models/micro.py against the JAX package's, and the
trainer's literal zero-gradient steps against the JAX trainer's gate and
closed-form tail.

Both packages build each model from ``tiny_dataset`` (64 users x 48 items,
384 train edges, 32- and 16-wide item features) at dim 16 (feature_embed
16), with its Model_YAML file's first combo otherwise (LATTICE: 2 layers, 1
item layer, ii_topk 10, lambda 0.1; MICRO: reg 0.1, tau 0.5, ssl_alpha 0.1).
The variants:

- LATTICE on a float32 graph: the (vals, idx) item graph, frozen batches
  through the row operators on the dense float32 R; "LATTICE-mm2" (2 item
  layers): the same graph, frozen batches through the whole forward;
  "LATTICE-bf16" (graph_compute_dtype bfloat16): the dense bf16 (I, I) item
  graph, frozen batches through the bf16 row operators (R R^T, R^T R);
- MICRO on a float32 graph (the direct full-catalog InfoNCE) and
  "MICRO-bf16" (the log-domain InfoNCE through ``catalog_logsumexp``).

The port takes the JAX package's initial params and the JAX trainer's
batches and negatives; a frozen batch reads the JAX package's batch-0 graph.
Each JAX reference runs once per module (``ref``).

Tolerances are those of tests/test_torch_mm_towers4.py: each loss to rtol
1e-5, every gradient to 1e-4 of its tensor's largest entry plus 1e-6, the
embeddings and graph values to ``TOL`` (rtol 1e-5, atol 1e-6); at bfloat16
the embeddings to ``PROP_TOL["bfloat16"]``, the loss to rtol 1e-4 and the
gradients within 2^-6 of their tensor's largest entry, and a built bf16
graph within one bf16 rounding (2^-7 relative) of the JAX package's. After
an epoch, params to ``TOL``, first moments like gradients, second moments to
1e-4 of their tensor's largest entry plus 1e-12.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chaorec_tpu.config import Config as JConfig
from chaorec_tpu.data import sampling as jsampling
from chaorec_tpu.models import lattice as jlattice
from chaorec_tpu.models.base import Batch as JBatch
from chaorec_tpu.ops import ell as jell
from chaorec_tpu.ops.adam_tail import zero_grad_adam_tail
from chaorec_tpu.train.loop import Trainer as JTrainer
from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.graphs import knn as tknn
from chaorec_tpu_torch.models import lattice as tlattice
from chaorec_tpu_torch.models.base import Batch as TBatch
from chaorec_tpu_torch.models.lattice import LATTICE
from chaorec_tpu_torch.models.micro import MICRO
from chaorec_tpu_torch.serve import Recommender
from chaorec_tpu_torch.train import loop as tloop
from test_torch_adagcl_grade import _adam_state
from test_torch_graphs import PROP_TOL
from test_torch_lightgcn import TOL, assert_grads_close, jax_batches, make_pair
from test_torch_mm_towers import grad_np
from test_torch_vae import cli_logs_match, one_torch_thread, t  # noqa: F401

BASE = dict(batch_size=100, dim_E=16, feature_embed=16, graph_compute_dtype="float32",
            topk=(5, 10, 20))
LATTICE_F = dict(BASE, Model="LATTICE", learning_rate=1e-3, reg_weight=0.01, n_layers=2,
                 mm_layers=1, ii_topk=10, lambda_coeff=0.1)
MICRO_F = dict(BASE, Model="MICRO", learning_rate=1e-3, reg_weight=0.1, n_layers=2,
               mm_layers=1, ii_topk=10, ssl_temp=0.5, ssl_alpha=0.1, lambda_coeff=0.1)
FLAGS = {"LATTICE": LATTICE_F, "MICRO": MICRO_F}
VARIANTS = {"LATTICE": LATTICE_F, "LATTICE-mm2": dict(LATTICE_F, mm_layers=2),
            "LATTICE-bf16": dict(LATTICE_F, graph_compute_dtype="bfloat16"),
            "MICRO": MICRO_F, "MICRO-bf16": dict(MICRO_F, graph_compute_dtype="bfloat16")}
BF16_LOSS_RTOL, BF16_GRAD_SHARE, BF16_GRAPH_RTOL = 1e-4, 2.0 ** -6, 2.0 ** -7
V_TOL = 1e-4


def _bf16(variant):
    return VARIANTS[variant]["graph_compute_dtype"] == "bfloat16"


def both_indexed(arrays, index):
    """(JAX batch, port batch) of numpy (users, pos, neg, weights) at
    ``index`` in its epoch."""
    u, p, n, w = (np.array(x) for x in arrays)
    jb = JBatch(jnp.asarray(u), jnp.asarray(p), jnp.asarray(n), jnp.asarray(w),
                jnp.asarray(index, jnp.int32))
    tb = TBatch(torch.from_numpy(u).long(), torch.from_numpy(w),
                pos_items=torch.from_numpy(p).long(), neg_items=torch.from_numpy(n).long(),
                index=index)
    return jb, tb


def to_port(tree):
    """A JAX pytree (the item graph state) as tensors: (vals, idx) tuples,
    bf16 matrices kept bf16."""
    if isinstance(tree, tuple):
        return tuple(to_port(x) for x in tree)
    a = np.asarray(tree)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a)).long() if a.dtype.kind == "i" else t(a)


@functools.partial(jax.jit, static_argnums=1)
def _j_step(jp, jm, state, jb):
    def f(p):
        return jm.loss_stateful(p, state, jb, jax.random.PRNGKey(0))

    (loss, new_state), g = jax.value_and_grad(f, has_aux=True)(jp)
    return loss, g, new_state


@pytest.fixture(scope="module")
def ref(tiny_dataset):
    """ref(variant): both models, params, the epoch's batches 0 and 1, and
    the JAX package's loss, gradients and new state of batch 0 (from its
    init_state) and of batch 1 (on batch 0's graph), and its embeddings on
    that graph; computed once per variant."""
    cache = {}

    def get(variant):
        if variant not in cache:
            flags = VARIANTS[variant]
            jm, tm, jp, tp = make_pair(tiny_dataset, flags)
            batches = [both_indexed(a, i) for i, a in
                       enumerate(jax_batches(tiny_dataset, flags["batch_size"], (0, 1)))]
            l0, g0, built = _j_step(jp, jm, jm.init_state(jax.random.PRNGKey(1)), batches[0][0])
            l1, g1, kept = _j_step(jp, jm, built, batches[1][0])
            emb = [np.asarray(x) for x in jm.embeddings_stateful(jp, built)]
            cache[variant] = SimpleNamespace(jm=jm, tm=tm, jp=jp, tp=tp, batches=batches,
                                             steps=((l0, g0), (l1, g1)), built=built, kept=kept,
                                             emb=emb)
        return cache[variant]

    return get


def port_step(tm, tp, state, tb):
    """(loss, gradients as numpy, new state) of the port's loss_stateful."""
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    loss, new_state = tm.loss_stateful(leaves, state, tb, None)
    loss.backward()
    return loss.item(), {k: grad_np(v) for k, v in leaves.items()}, new_state


def assert_step_close(jloss, jg, tloss, grads, bf16, what=""):
    if not bf16:
        assert tloss == pytest.approx(float(jloss), rel=1e-5), what
        for k in jg:
            assert_grads_close(grads[k], np.asarray(jg[k]), f"{k} {what}")
        return
    assert tloss == pytest.approx(float(jloss), rel=BF16_LOSS_RTOL), what
    for k in jg:
        want = np.asarray(jg[k])
        np.testing.assert_allclose(grads[k], want, rtol=0,
                                   atol=BF16_GRAD_SHARE * float(np.abs(want).max()) + 1e-6,
                                   err_msg=f"{k} {what}")


def assert_graph_close(got, want, bf16_dense):
    """A built item graph: a dense bf16 matrix within one bf16 rounding, or
    (vals, idx) blocks with equal indices and values to TOL."""
    if bf16_dense:
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=BF16_GRAPH_RTOL, atol=1e-7)
        return
    if isinstance(want[0], tuple):  # MICRO: one (vals, idx) a modality
        for g, w in zip(got, want):
            assert_graph_close(g, w, False)
        return
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)


# ---------------------------------------------------------------------------
# the kNN primitives, with gradients


@pytest.mark.parametrize("k", [5, 12])
def test_knn_primitives_carry_gradients_like_jax(k):
    """knn_topk, topk_sym_norm and gather_weighted_sum against knn_topk_ell,
    topk_sym_norm_ell and ell_rows_matvec on projected features: the
    neighbour indices equal, the values, and the gradients of the raw
    features, the projection, the propagated table and the similarity
    values (through the top-k gather and the d[idx] gather)."""
    rs = np.random.default_rng(3 + k)
    x, w, b, h, g = (rs.standard_normal(s).astype(np.float32)
                     for s in ((40, 12), (8, 12), (8,), (40, 5), (40, 5)))

    def jfn(x_, w_, b_, h_):
        sv, si = jell.knn_topk_ell(x_ @ w_.T + b_, k)
        nv, ni = jell.topk_sym_norm_ell(sv, si)
        return jell.ell_rows_matvec(nv, ni, h_), (sv, si, nv)

    jout, vjp, (jsv, jsi, jnv) = jax.vjp(jfn, *(jnp.asarray(a) for a in (x, w, b, h)),
                                         has_aux=True)
    jgrads = vjp(jnp.asarray(g))
    tx, tw, tb, th = (torch.from_numpy(a).requires_grad_() for a in (x, w, b, h))
    sv, si = tknn.knn_topk(tx @ tw.t() + tb, k, row_chunk=16)
    graph = tknn.topk_sym_norm(sv, si)
    sv.retain_grad()
    out = tknn.gather_weighted_sum(th, graph.weights, graph.indices)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(si.numpy(), np.asarray(jsi))
    np.testing.assert_allclose(sv.detach().numpy(), np.asarray(jsv), **TOL)
    np.testing.assert_allclose(graph.weights.detach().numpy(), np.asarray(jnv), **TOL)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    for name, got, want in zip("xwbh", (tx, tw, tb, th), jgrads):
        assert_grads_close(got.grad.numpy(), np.asarray(want), name)
    # the similarity values' own gradient, through topk_sym_norm_ell
    _, vvjp = jax.vjp(lambda v: jell.ell_rows_matvec(*jell.topk_sym_norm_ell(v, jsi),
                                                     jnp.asarray(h)), jsv)
    assert_grads_close(sv.grad.numpy(), np.asarray(vvjp(jnp.asarray(g))[0]), "vals")


def test_dense_helpers_match_jax_with_ties_and_an_empty_row():
    """dense_knn_sim keeps every entry at least the k-th (rows come in
    identical threes, so the k-th similarity ties and a row keeps more than
    k), dense_norm_laplacian gives a row summing to 0 weight 0; the gradient
    of the features through both."""
    rs = np.random.default_rng(9)
    # unit rows of four entries +-0.5, in identical threes: every similarity
    # is exact in float32, so both packages see the same ties
    f = np.zeros((10, 6), np.float32)
    for row in f:
        row[rs.choice(6, 4, replace=False)] = rs.choice([-0.5, 0.5], 4)
    f = np.repeat(f, 3, axis=0)
    g = rs.standard_normal((30, 30)).astype(np.float32)

    def jfn(f_):
        adj = jlattice.dense_knn_sim(f_, 4)
        return jlattice.dense_norm_laplacian(adj.at[11].set(0.0)), adj

    jout, vjp, jadj = jax.vjp(jfn, jnp.asarray(f), has_aux=True)
    tf = torch.from_numpy(f).requires_grad_()
    adj = tlattice.dense_knn_sim(tf, 4)
    kept = (adj != 0).sum(1).numpy()
    assert kept.max() > 4 and (kept >= 4).all()
    masked = adj.clone()
    masked[11] = 0.0
    out = tlattice.dense_norm_laplacian(masked)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(adj.detach().numpy() != 0, np.asarray(jadj) != 0)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    assert not out[11].any() and not out[:, 11].any()
    assert_grads_close(tf.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), "features")


def test_chunked_gram_rounds_as_jax():
    """R R^T in bf16 from float32 sums, in chunks, as the JAX package's."""
    r = np.random.default_rng(2).uniform(0, 1, (70, 30)).astype(np.float32)
    want = np.asarray(jlattice._chunked_gram(jnp.asarray(r, jnp.bfloat16), chunk=32),
                      np.float32)
    got = tlattice.chunked_gram(torch.from_numpy(r).to(torch.bfloat16), chunk=32)
    assert got.dtype == torch.bfloat16 and got.shape == (70, 70)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_GRAPH_RTOL, atol=0)


# ---------------------------------------------------------------------------
# the models


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_build_matches_jax(ref, variant):
    """build_model's class, gates and param shapes; the same path choices
    (dense item graph, row operators) as the JAX model; the frozen original
    graphs equal."""
    r = ref(variant)
    jm, tm = r.jm, r.tm
    name = VARIANTS[variant]["Model"]
    assert isinstance(tm, {"LATTICE": LATTICE, "MICRO": MICRO}[name]) and tm.name == name
    assert (tm.stateful, tm.frozen_state_epoch, tm.epoch0_params) == (
        True, True, tuple(jm.epoch0_params))
    assert getattr(tm, "trainer_cls", tloop.Trainer) is tloop.Trainer and not tm.table_params
    own = tm.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in r.jp.items()}
    if name == "MICRO":
        assert tm.cl_fast == jm.cl_fast == _bf16(variant)
        assert not tm.graph.use_dense
        pairs = ((tm.image_original, jm.image_original), (tm.text_original, jm.text_original))
    else:
        assert tm.dense_items == jm.dense_items == _bf16(variant)
        assert (tm._rt is None) == (jm._rt is None) == (variant == "LATTICE-mm2")
        if tm.dense_items:
            pairs = ((tm.image_original, jm.image_original_d),
                     (tm.text_original, jm.text_original_d))
        else:
            pairs = ((tm.image_original, jm.image_original),
                     (tm.text_original, jm.text_original))
    for got, want in pairs:
        assert_graph_close(got, want, name == "LATTICE" and tm.dense_items)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_batch0_builds_the_graph_like_jax(ref, variant):
    """Batch 0: the loss and every gradient (the gated params' through the
    graph build) and the graph it returns as the state, detached."""
    r = ref(variant)
    tloss, grads, built = port_step(r.tm, r.tp, r.tm.init_state(), r.batches[0][1])
    jloss, jg = r.steps[0]
    assert_step_close(jloss, jg, tloss, grads, _bf16(variant), "batch 0")
    for k in r.tm.epoch0_params:
        assert np.abs(grads[k]).max() > 0, k
    leaves = built if isinstance(built, tuple) else (built,)
    flat = [x for g in leaves for x in (g if isinstance(g, tuple) else (g,))]
    assert not any(x.requires_grad for x in flat)
    assert_graph_close(built, r.built, variant == "LATTICE-bf16")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_frozen_batch_matches_jax(ref, variant):
    """Batch 1 on the JAX package's batch-0 graph: the loss and gradients;
    the gated params get no gradient (the trainer steps them with zeros),
    and the state comes back as it went in."""
    r = ref(variant)
    state = to_port(r.built)
    tloss, grads, kept = port_step(r.tm, r.tp, state, r.batches[1][1])
    jloss, jg = r.steps[1]
    assert_step_close(jloss, jg, tloss, grads, _bf16(variant), "batch 1")
    for k in r.tm.epoch0_params:
        assert not grads[k].any() and not np.asarray(jg[k]).any(), k
    assert_graph_close(kept, r.kept, variant == "LATTICE-bf16")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_embeddings_match_jax(ref, variant):
    r = ref(variant)
    with torch.no_grad():
        got = r.tm.embeddings_stateful(r.tp, to_port(r.built))
    tol = PROP_TOL["bfloat16"] if _bf16(variant) else TOL
    for g, w in zip(got, r.emb):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, **tol)


# ---------------------------------------------------------------------------
# one epoch against the JAX trainer


def jax_epoch_batches(ds, cfg, rng):
    """The batches (users, pos, neg, weights) of the JAX trainer's epoch
    from ``rng``, each negative drawn from its step's key as the epoch
    function draws it."""
    rng, shuffle = jax.random.split(rng)
    users, pos, weights, _ = jsampling.make_epoch_batches(shuffle, jnp.asarray(ds.train_edges),
                                                          cfg.batch_size)
    history = jnp.asarray(ds.history.values)
    out = []
    for b in range(users.shape[0]):
        rng, neg_rng, _, _ = jax.random.split(rng, 4)
        neg = jsampling.sample_negatives(neg_rng, users[b], history, ds.num_item,
                                         int(cfg.neg_candidates))
        out.append(tuple(np.asarray(x) for x in (users[b], pos[b], neg, weights[b])))
    return out


def _adam_moments(opt, p):
    s = opt.state[p]
    return int(s["step"]), s["exp_avg"].numpy(), s["exp_avg_sq"].numpy()


@pytest.mark.parametrize("name", list(FLAGS))
def test_epoch_matches_the_jax_trainer(tiny_dataset, name):
    """Trainer.train_step over the JAX trainer's epoch (4 batches, the last
    padded): each batch's loss against the JAX loss at the port's params
    (a frozen batch on the JAX graph built at batch 0); at the epoch's end
    every param against the JAX trainer's (the gated ones through its
    batch-0 gate and closed-form tail, ops/adam_tail.py), the gated params'
    Adam moments and step count against its gate state, the others' against
    its main Adam state."""
    ds, flags = tiny_dataset, FLAGS[name]
    jm, tm, jp, tp = make_pair(ds, flags)
    jcfg = JConfig(**flags)
    jtr = JTrainer(jm, ds, jcfg)
    j_params, j_opt, _, j_total = jtr.train_epoch(
        jax.tree.map(jnp.array, jp), jtr.init_opt_state(jax.tree.map(jnp.array, jp)),
        jax.random.PRNGKey(1), 0)
    main_state, (gmu, gnu, gcount, _) = j_opt

    trainer = tloop.Trainer(tm, ds, TConfig(**flags))
    params = {k: v.clone().requires_grad_() for k, v in tp.items()}
    opt = trainer.make_optimizer(params)
    batches = jax_epoch_batches(ds, jcfg, jax.random.PRNGKey(1))
    assert len(batches) == 4 and batches[-1][3].min() == 0
    built, losses = None, []
    for b, arrays in enumerate(batches):
        jb, tb = both_indexed(arrays, b)
        # copies: the optimizer steps the tensors in place
        here = {k: jnp.array(v.detach().numpy(), copy=True) for k, v in params.items()}
        jloss, _, new_state = _j_step(here, jm, built if b else jm.init_state(None), jb)
        built = new_state if b == 0 else built
        jloss = float(jloss)
        tloss = trainer.train_step(params, opt, tb).item()
        assert tloss == pytest.approx(jloss, rel=1e-5), f"batch {b}"
        losses.append(tloss)
    assert sum(losses) == pytest.approx(float(j_total), rel=1e-5)
    for k, v in params.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(j_params[k]), **TOL,
                                   err_msg=k)
    adam = _adam_state(main_state)
    assert int(gcount) == int(adam.count) == len(batches)
    for k, p in params.items():
        step, m, v = _adam_moments(opt, p)
        assert step == len(batches), k
        gated = k in tm.epoch0_params
        want_m, want_v = (np.asarray(x[k]) for x in ((gmu, gnu) if gated else (adam.mu, adam.nu)))
        assert_grads_close(m, want_m, f"first moment of {k}")
        np.testing.assert_allclose(v, want_v, rtol=0,
                                   atol=V_TOL * float(np.abs(want_v).max()) + 1e-12,
                                   err_msg=f"second moment of {k}")


def test_zero_grad_steps_match_the_closed_form_tail():
    """What the port runs literally, torch's Adam stepping a param with a
    zero gradient n times after a real step, against the JAX package's
    closed form of those steps (ops/adam_tail.zero_grad_adam_tail)."""
    rs = np.random.default_rng(4)
    p0, g = rs.standard_normal((2, 50, 7)).astype(np.float32)
    p = torch.from_numpy(p0.copy()).requires_grad_()
    opt = torch.optim.Adam([p], lr=1e-3, betas=tloop.ADAM_BETAS, eps=tloop.ADAM_EPS)
    p.grad = torch.from_numpy(g)
    opt.step()
    s = opt.state[p]
    mu, nu, after_one = (x.numpy().copy() for x in (s["exp_avg"], s["exp_avg_sq"], p.detach()))
    for _ in range(9):
        p.grad = torch.zeros_like(p)
        opt.step()
    want = zero_grad_adam_tail(jnp.asarray(after_one), jnp.asarray(mu), jnp.asarray(nu),
                               jnp.asarray(1), 9, 1e-3, 0.9, 0.999, 1e-8)
    assert int(s["step"]) == 10
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(s["exp_avg"].numpy(), np.asarray(want[1]), **TOL)
    np.testing.assert_allclose(s["exp_avg_sq"].numpy(), np.asarray(want[2]), rtol=1e-5, atol=0)
    assert np.abs(p.detach().numpy() - after_one).max() > 1e-4  # the tail moved it


# ---------------------------------------------------------------------------
# the CLI


@pytest.mark.parametrize("name", list(FLAGS))
def test_cli_log_matches_jax_cli_and_serves_the_export(tiny_dataset, monkeypatch, tmp_path,
                                                       name):
    """Each package's cli.run of the first combo, 2 epochs: the same line
    shapes. The best epoch is exported with its item graph (the
    embeddings_stateful tables) and served: the server's answers are the
    artifact tables' own top 10 (bf16 inputs, summed in float64 here), none
    of them a seen item."""
    ds = tiny_dataset
    _, art = cli_logs_match(ds, monkeypatch, tmp_path, FLAGS[name], export=True, num_epoch=2)
    with np.load(art) as z:
        assert str(z["kind"]) == "embeddings" and str(z["model"]) == name
        user_emb, item_emb = z["user_emb"], z["item_emb"]
    assert user_emb.shape == (64, 16) and item_emb.shape == (48, 16)
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
