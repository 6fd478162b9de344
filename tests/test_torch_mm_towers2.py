"""models/mmgcl.py, lgmrec.py, mmgcn.py, mvgae.py, powerec.py, mentor.py and
ddrec.py against the JAX package's, with ``graphs/dropout.masked_dense_r``'s
self-loop form and ``params.load_frozen``.

Both packages build each model from ``tiny_dataset`` (64 users x 48 items,
384 train edges, 32- and 16-wide item features) at dim 16 on a float32
graph, with its Model_YAML file's first combo otherwise (MMGCL 1 layer,
dropout 0.1; LGMRec 3 layers; MVGAE 2 layers at learning rate 0.1;
POWERec one prompt, dropout 0.1; MENTOR 1 multimodal layer; DDRec 3
layers, threshold 0, its feature width 16 = dim_E, as its gate needs). The
port takes the JAX package's initial params, MMGCN's and MVGAE's frozen
tensors (``load_frozen``), the JAX trainer's batches and negatives, and
the draws the JAX loss makes from its key (MMGCL's keep masks and
modality pick, LGMRec's Gumbel uniforms and keep masks, MVGAE's dropout
masks and noise, MENTOR's noise uniforms and keep masks), given to
``loss_with_draws``; DDRec's state is the JAX package's before each step.

Tolerances are those of tests/test_torch_mm_towers.py: each loss to rtol
1e-5; every gradient to 1e-4 of its tensor's largest entry plus 1e-6; the
embeddings, the pruned R and DDRec's state to rtol 1e-5, atol 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chaorec_tpu.graphs.dropout import masked_dense_r as j_masked_dense_r
from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.graphs.dropout import masked_dense_r
from chaorec_tpu_torch.models.ddrec import DDRec
from chaorec_tpu_torch.models.lgmrec import ASSIGNMENTS, LGMRec
from chaorec_tpu_torch.models.mentor import MENTOR, NOISY
from chaorec_tpu_torch.models.mmgcl import MMGCL
from chaorec_tpu_torch.models.mmgcn import MMGCN
from chaorec_tpu_torch.models.mvgae import MODALITIES, MVGAE
from chaorec_tpu_torch.models.powerec import POWERec
from chaorec_tpu_torch.params import load_frozen
from chaorec_tpu_torch.serve import Recommender, export_artifact
from chaorec_tpu_torch.train import loop as tloop
from test_torch_lightgcn import TOL, assert_grads_close, both_batches, jax_batches, make_pair
from test_torch_mm_towers import grad_np
from test_torch_vae import cli_logs_match, one_torch_thread, t  # noqa: F401

BASE = dict(batch_size=100, dim_E=16, graph_compute_dtype="float32", topk=(5, 10, 20))
FLAGS = {
    "MMGCL": dict(BASE, Model="MMGCL", learning_rate=0.001, reg_weight=0.001, n_layers=1,
                  ssl_alpha=0.5, ssl_temp=0.2, dropout=0.1),
    "LGMRec": dict(BASE, Model="LGMRec", learning_rate=0.001, reg_weight=1e-4, n_layers=3,
                   ssl_alpha=1e-4),
    "MMGCN": dict(BASE, Model="MMGCN", reg_weight=1e-4, learning_rate=0.001),
    "MVGAE": dict(BASE, Model="MVGAE", learning_rate=0.1, reg_weight=0.1, n_layers=2),
    "POWERec": dict(BASE, Model="POWERec", learning_rate=0.001, reg_weight=0.1, n_layers=4,
                    neg_weight=0.001, dropout=0.1, prompt_num=1),
    "MENTOR": dict(BASE, Model="MENTOR", learning_rate=1e-4, reg_weight=0.001, mm_layers=1,
                   dropout=0.1, ssl_temp=0.2, align_weight=0.1, mask_weight_g=0.001,
                   mask_weight_f=1.5),
    "DDRec": dict(BASE, Model="DDRec", learning_rate=0.001, reg_weight=0.1, n_layers=3,
                  ssl_alpha=0.01, threshold=0.0, ssl_temp=0.2, feature_embed=16),
}
CLASSES = {"MMGCL": MMGCL, "LGMRec": LGMRec, "MMGCN": MMGCN, "MVGAE": MVGAE,
           "POWERec": POWERec, "MENTOR": MENTOR, "DDRec": DDRec}
PLAIN = [n for n in CLASSES if n != "DDRec"]  # on the plain BPR branch
EXPORTED = "DDRec"  # exported with its state and served


def _bern(key, p, shape):
    return jax.random.bernoulli(key, p, shape).astype(jnp.float32)


@functools.partial(jax.jit, static_argnums=0)
def _mmgcl_draws(jm, rng):
    """MMGCL's keep masks and modality pick, as its JAX loss draws them
    (mmgcl.py:64-79, 152)."""
    k_ed, k_nd, k_mod = jax.random.split(rng, 3)
    ku, ki = jax.random.split(k_nd)
    keep = 1.0 - jm.dropout_rate
    return {"edge": _bern(k_ed, keep, (jm.graph.u_by_u.shape[0],)),
            "user": _bern(ku, keep, (jm.num_user,)), "item": _bern(ki, keep, (jm.num_item,)),
            "pick_image": jax.random.bernoulli(k_mod, jm.p_vat)}


@functools.partial(jax.jit, static_argnums=0)
def _lgmrec_draws(jm, rng):
    """LGMRec's Gumbel uniforms and keep masks (lgmrec.py:86-102, 128)."""
    ks = jax.random.split(rng, 8)
    rows = {"user": jm.num_user, "item": jm.num_item}
    out = {}
    for j, (a, side) in enumerate(ASSIGNMENTS):
        shape = (rows[side], jm.hyper_num)
        out[f"{a}_gumbel"] = jax.random.uniform(ks[j], shape)
        out[f"{a}_keep"] = _bern(ks[4 + j], jm.keep_rate, shape)
    return out


@functools.partial(jax.jit, static_argnums=0)
def _mvgae_draws(jm, rng):
    """MVGAE's conv dropout masks and reparameterization noise
    (mvgae.py:100, 141, 150-160)."""
    k_f, k_z, k_v, k_t, k_c = jax.random.split(rng, 5)
    shape = (jm.num_user + jm.num_item, jm.dim_E)
    out = {}
    for mod, k_mod in zip(MODALITIES, jax.random.split(k_f, 3)):
        ks = jax.random.split(k_mod, 5)
        for i in tuple(range(jm.n_layers)) + (3, 4):
            out[f"{mod}_conv{i}"] = _bern(ks[i], 1.0 - jm.conv_dropout, shape)
    for name, k in (("z", k_z), ("z_v", k_v), ("z_t", k_t), ("z_c", k_c)):
        out[name] = jax.random.normal(k, shape)
    return out


@functools.partial(jax.jit, static_argnums=0)
def _mentor_draws(jm, rng):
    """MENTOR's noise uniforms and feature-mask keep masks
    (mentor.py:110-125, 196-208)."""
    k_fwd, k_drop = jax.random.split(rng)
    d = jm.dim_E
    out = {}
    for name, key in zip(NOISY, jax.random.split(k_fwd, 4)):
        for layer in range(2):
            ku, ki = jax.random.split(jax.random.fold_in(key, layer))
            out[f"{name}_{layer}_u"] = jax.random.uniform(ku, (jm.num_user, d))
            out[f"{name}_{layer}_i"] = jax.random.uniform(ki, (jm.num_item, d))
    ku, ki = jax.random.split(k_drop)
    keep = 1.0 - jm.dropout
    out["mask_u"] = _bern(ku, keep, (jm.num_user, 2 * d))
    out["mask_i"] = _bern(ki, keep, (jm.num_item, 2 * d))
    return out


JAX_DRAWS = {"MMGCL": _mmgcl_draws, "LGMRec": _lgmrec_draws, "MVGAE": _mvgae_draws,
             "MENTOR": _mentor_draws}


def draws_of(jm, name, rng):
    """The port's form of the draws the JAX loss of ``name`` makes from
    ``rng`` (None: a model that draws nothing)."""
    if name not in JAX_DRAWS:
        return None
    return {k: t(v) for k, v in JAX_DRAWS[name](jm, rng).items()}


def frozen_of(jm, tm):
    return {n: np.asarray(getattr(jm, n)) for n in getattr(tm, "frozen", ())}


def pair(ds, name, epoch=0):
    """(JAX model, port model, JAX params, the same params as tensors): the
    port with the JAX model's frozen tensors, POWERec's R pruned at
    ``epoch`` on both sides."""
    jm, tm, jp, tp = make_pair(ds, FLAGS[name])
    if hasattr(tm, "frozen"):
        load_frozen(tm, frozen_of(jm, tm))
    if name == "POWERec":
        jm.pre_epoch(jp, jax.random.PRNGKey(epoch), epoch)
        tm.pre_epoch(tp, epoch)
    return jm, tm, jp, tp


def port_loss(tm, name, params, batch, draws, state=None):
    """(loss, new state or None) of the port's model under ``draws``."""
    if name == "DDRec":
        return tm.loss_stateful(params, state, batch, None)
    if draws is None:
        return tm.loss(params, batch, None), None
    return tm.loss_with_draws(params, batch, draws), None


@functools.partial(jax.jit, static_argnums=1)
def _value_and_grad(jp, jm, jb, rng):
    return jax.value_and_grad(lambda p: jm.loss(p, jb, rng))(jp)


@functools.partial(jax.jit, static_argnums=1)
def _value_and_grad_stateful(jp, jm, state, jb, rng):
    return jax.value_and_grad(lambda p: jm.loss_stateful(p, state, jb, rng), has_aux=True)(jp)


def jax_step(jm, name, jp, jb, rng, state=None):
    """((loss, new state or None), gradients) of the JAX loss."""
    if name == "DDRec":
        return _value_and_grad_stateful(jp, jm, state, jb, rng)
    loss, g = _value_and_grad(jp, jm, jb, rng)
    return (loss, None), g


def assert_state_close(got, want, what):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]), err_msg=what)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL, err_msg=what)


def test_masked_dense_r_self_loops_matches_jax(tiny_dataset):
    """``self_loops=True``: (R, 1/(d_u+1+eps), 1/(d_i+1+eps)) over the kept
    edges, as the JAX function; without the flag the result is the one R
    it always was, bit for bit (FREEDOM's, LayerGCN's and POWERec's)."""
    _, tm, _, _ = pair(tiny_dataset, "MMGCL")
    g = tm.graph
    keep = (np.random.default_rng(3).random(g.num_edges) < 0.8).astype(np.float32)
    ju, ji = np.asarray(g.u_by_u), np.asarray(g.i_by_u)
    want = j_masked_dense_r(jnp.asarray(ju), jnp.asarray(ji), jnp.asarray(keep), 64, 48,
                            self_loops=True)
    got = masked_dense_r(g.u_by_u, g.i_by_u, torch.from_numpy(keep), 64, 48, self_loops=True)
    assert len(got) == 3
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
    du = np.bincount(ju, weights=keep, minlength=64) + 1.0
    np.testing.assert_allclose(got[1].numpy(), 1.0 / (du + 1e-7), rtol=1e-6)
    plain = masked_dense_r(g.u_by_u, g.i_by_u, torch.from_numpy(keep), 64, 48)
    assert isinstance(plain, torch.Tensor) and plain.dtype == torch.float32
    deg_u = torch.zeros(64).index_add_(0, g.u_by_u, torch.from_numpy(keep))
    deg_i = torch.zeros(48).index_add_(0, g.i_by_u, torch.from_numpy(keep))
    w = torch.from_numpy(keep) * torch.rsqrt((deg_u[g.u_by_u] + 1e-7) * (deg_i[g.i_by_u] + 1e-7))
    old = torch.zeros(64, 48).index_put_((g.u_by_u, g.i_by_u), w, accumulate=True)
    np.testing.assert_array_equal(plain.numpy(), old.numpy())
    jplain = j_masked_dense_r(jnp.asarray(ju), jnp.asarray(ji), jnp.asarray(keep), 64, 48)[0]
    np.testing.assert_allclose(plain.numpy(), np.asarray(jplain), rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", list(CLASSES))
def test_build_goes_through_build_model(tiny_dataset, name):
    jm, tm, jp, _ = pair(tiny_dataset, name)
    assert isinstance(tm, CLASSES[name]) and tm.name == name
    assert (tm.rank_mode, tm.stateful, tm.trainer_mode) == ("embeddings", name == "DDRec",
                                                             "bpr")
    assert getattr(tm, "trainer_cls", tloop.Trainer) is tloop.Trainer and not tm.table_params
    own = tm.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    # the frozen tensors: the port draws its own from seed + 21 / + 31,
    # of the JAX package's shapes, and takes the JAX package's in a test
    fresh = make_pair(tiny_dataset, FLAGS[name])[1]
    for n, arr in frozen_of(jm, tm).items():
        assert tuple(getattr(fresh, n).shape) == arr.shape
        np.testing.assert_array_equal(getattr(tm, n).numpy(), arr)
    if name in ("MENTOR", "DDRec"):  # the same multimodal kNN graph
        np.testing.assert_array_equal(tm.mm_graph.indices.numpy(),
                                      np.asarray(jm.mm_graph.indices))
        np.testing.assert_array_equal(tm.mm_graph.weights.numpy(),
                                      np.asarray(jm.mm_graph.weights))


def test_load_frozen_checks_names_and_shapes(tiny_dataset):
    jm, tm, _, _ = pair(tiny_dataset, "MMGCN")
    frozen = frozen_of(jm, tm)
    with pytest.raises(ValueError, match="freezes"):
        load_frozen(tm, {k: v for k, v in frozen.items() if k != "id_embedding"})
    with pytest.raises(ValueError, match="shape"):
        load_frozen(tm, dict(frozen, v_preference=frozen["v_preference"][:5]))
    own = make_pair(tiny_dataset, FLAGS["MMGCN"])[1]
    assert not np.array_equal(own.id_embedding.numpy(), frozen["id_embedding"])


@pytest.mark.parametrize("name,step", [(n, s) for n in CLASSES for s in (0, -1)],
                         ids=[f"{n}-{'full' if s == 0 else 'padded'}_batch" for n in CLASSES
                              for s in (0, -1)])
def test_loss_and_gradients_match_jax(tiny_dataset, name, step):
    """DDRec from its initial state (the modal inputs ungated)."""
    jm, tm, jp, tp = pair(tiny_dataset, name)
    jb, tb = both_batches(jax_batches(tiny_dataset, 100, (step,))[0])
    rng = jax.random.PRNGKey(11 + step)
    jstate = jm.init_state(jax.random.PRNGKey(0)) if name == "DDRec" else None
    (jloss, _), jg = jax_step(jm, name, jp, jb, rng, jstate)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tstate = tm.init_state("cpu") if name == "DDRec" else None
    tloss, _ = port_loss(tm, name, leaves, tb, draws_of(jm, name, rng), tstate)
    tloss.backward()
    assert tloss.item() == pytest.approx(float(jloss), rel=1e-5)
    for k in jg:
        assert_grads_close(grad_np(leaves[k]), np.asarray(jg[k]), k)


@pytest.mark.parametrize("name", PLAIN)
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
        (jloss, _), jg = jax_step(jm, name, jp, jb, rng)
        with torch.no_grad():
            for k, v in jp.items():
                params[k].copy_(torch.from_numpy(np.array(v)))
        drawn = draws_of(jm, name, rng)
        if drawn is not None:
            tm.draws = lambda *args: drawn
        tloss = trainer.train_step(params, opt, tb)
        assert tloss.item() == pytest.approx(float(jloss), rel=1e-5), step
        for k in jg:
            assert_grads_close(grad_np(params[k]), np.asarray(jg[k]), f"{k} step {step}")
        upd, jopt = jopt_fn.update(jg, jopt, jp)
        jp = optax.apply_updates(jp, upd)


def test_ddrec_state_across_two_batches_matches_jax(tiny_dataset):
    """Trainer.train_step carries DDRec's state: after each of two batches
    the new state (has_prev 1, the id tower's final items) equals the JAX
    loss's, and the second batch, whose modal inputs the first's items
    gate, has the JAX loss and gradients; then embeddings_stateful."""
    ds = tiny_dataset
    jm, tm, jp, tp = pair(ds, "DDRec")
    flags = FLAGS["DDRec"]
    trainer = tloop.Trainer(tm, ds, TConfig(**flags))
    assert float(trainer.model_state[0]) == 0.0 and not trainer.model_state[1].any()
    params = {k: v.clone().requires_grad_() for k, v in tp.items()}
    opt = trainer.make_optimizer(params)
    jopt_fn = optax.adam(flags["learning_rate"])
    jopt = jopt_fn.init(jp)
    jstate = jm.init_state(jax.random.PRNGKey(0))
    for step, arrays in enumerate(jax_batches(ds, flags["batch_size"], steps=(0, 1))):
        jb, tb = both_batches(arrays)
        (jloss, jnew), jg = jax_step(jm, "DDRec", jp, jb, jax.random.PRNGKey(step), jstate)
        with torch.no_grad():
            for k, v in jp.items():
                params[k].copy_(torch.from_numpy(np.array(v)))
        trainer.model_state = tuple(t(x) for x in jstate)  # equal inputs each step
        tloss = trainer.train_step(params, opt, tb)
        assert tloss.item() == pytest.approx(float(jloss), rel=1e-5), step
        for k in jg:
            assert_grads_close(grad_np(params[k]), np.asarray(jg[k]), f"{k} step {step}")
        assert_state_close(trainer.model_state, jnew, f"state after step {step}")
        assert not trainer.model_state[1].requires_grad
        upd, jopt = jopt_fn.update(jg, jopt, jp)
        jp, jstate = optax.apply_updates(jp, upd), jnew
    ju, ji = jm.embeddings_stateful(jp, jstate)
    with torch.no_grad():
        tu, ti = tm.embeddings_stateful({k: t(v) for k, v in jp.items()},
                                        tuple(t(x) for x in jstate))
    assert tu.shape == (64, 48) and ti.shape == (48, 48)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **TOL)


@pytest.mark.parametrize("name", list(CLASSES))
def test_embeddings_match_jax(tiny_dataset, name):
    """Ranking's tables: without draws (no noise, no dropout), POWERec on
    the unpruned R, DDRec from its initial state."""
    jm, tm, jp, tp = pair(tiny_dataset, name)
    if name == "DDRec":
        ju, ji = jm.embeddings_stateful(jp, jm.init_state(jax.random.PRNGKey(0)))
        with torch.no_grad():
            tu, ti = tm.embeddings_stateful(tp, tm.init_state("cpu"))
    else:
        ju, ji = jm.embeddings(jp)
        with torch.no_grad():
            tu, ti = tm.embeddings(tp)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **TOL)


def test_powerec_prunes_the_same_edges_as_jax(tiny_dataset):
    """At epochs 0 (the weighted draw) and 1 (the uniform one) both packages
    keep the same edges and renormalize to the same R; ranking keeps the
    unpruned one."""
    jm, tm, jp, tp = pair(tiny_dataset, "POWERec")
    np.testing.assert_array_equal(tm._edge_w, np.asarray(jm._edge_w))
    for epoch in range(2):
        if epoch:
            jm.pre_epoch(jp, jax.random.PRNGKey(epoch), epoch)
            tm.pre_epoch(tp, epoch)
        jr, tr = np.asarray(jm.masked_r), tm.masked_r.numpy()
        assert tr.dtype == np.float32
        np.testing.assert_array_equal(tr != 0, jr != 0, err_msg=f"epoch {epoch}")
        assert int((tr != 0).sum()) == int(384 * 0.9)
        np.testing.assert_allclose(tr, jr, **TOL, err_msg=f"epoch {epoch}")
    assert not tm.pruning_random  # two flips
    assert tm.graph.dense_r is not tm.masked_r


@pytest.mark.parametrize("name", ["MMGCN", "MVGAE"])
def test_frozen_tensors_stay_frozen_through_an_epoch(tiny_dataset, name):
    """A training epoch steps every param and none of the frozen tensors:
    they are bit-equal to the JAX package's after it."""
    ds = tiny_dataset
    jm, tm, _, _ = pair(ds, name)
    before = frozen_of(jm, tm)
    cfg = TConfig(**FLAGS[name])
    trainer = tloop.Trainer(tm, ds, cfg)
    params = trainer.init_params()
    start = {k: v.detach().clone() for k, v in params.items()}
    opt = trainer.make_optimizer(params)
    loss = trainer.train_epoch(params, opt)
    assert np.isfinite(loss)
    assert not set(before) & set(params)
    for n, arr in before.items():
        assert not getattr(tm, n).requires_grad
        np.testing.assert_array_equal(getattr(tm, n).numpy(), arr, err_msg=n)
    moved = [k for k in params if not torch.equal(params[k].detach(), start[k])]
    assert len(moved) > len(params) // 2, moved


def test_ddrec_best_epoch_state_is_exported(tiny_dataset, tmp_path):
    """The best epoch's state is a host copy, not the live state, and the
    export holds embeddings_stateful(best params, best state), which differ
    from the tables under the initial state."""
    ds = tiny_dataset
    cfg = TConfig(**FLAGS["DDRec"], num_epoch=2, export_artifact=str(tmp_path / "unused.npz"))
    _, model, _, _ = pair(ds, "DDRec")
    trainer = tloop.Trainer(model, ds, cfg)
    trainer.run()
    best_p, (has_prev, prev) = trainer.best_params_host, trainer.best_mstate_host
    assert float(has_prev) == 1.0 and prev.shape == (48, 16)
    assert prev.data_ptr() != trainer.model_state[1].data_ptr()
    path = str(tmp_path / "ddrec.npz")
    export_artifact(model, best_p, (has_prev, prev), ds, path)
    with torch.no_grad():
        ue, ie = model.embeddings_stateful(best_p, (has_prev, prev))
        _, ie0 = model.embeddings_stateful(best_p, model.init_state("cpu"))
    with np.load(path) as z:
        assert str(z["kind"]) == "embeddings" and str(z["model"]) == "DDRec"
        np.testing.assert_array_equal(z["user_emb"], ue.numpy())
        np.testing.assert_array_equal(z["item_emb"], ie.numpy())
        assert float(np.abs(z["item_emb"] - ie0.numpy()).max()) > 1e-3


@pytest.mark.parametrize("name", list(CLASSES))
def test_cli_log_matches_jax_cli(tiny_dataset, monkeypatch, tmp_path, name):
    """Each package's cli.run of the first combo, 2 epochs: the same line
    shapes (POWERec prunes twice). DDRec's best epoch is exported with its
    state and served: the server's answers are the artifact tables' own top
    10 (bf16 inputs, summed in float64 here), none of them a seen item."""
    ds = tiny_dataset
    _, art = cli_logs_match(ds, monkeypatch, tmp_path, FLAGS[name], export=name == EXPORTED,
                            num_epoch=2)
    if not art:
        return
    with np.load(art) as z:
        assert str(z["kind"]) == "embeddings"
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
