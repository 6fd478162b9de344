"""models/diffmm.py, with its three-phase trainer, against the JAX package's.

Both packages build DiffMM from ``tiny_dataset`` (64 users x 48 items, 384
train edges, 32- and 16-wide item features) at dim 16 on a float32 graph,
batch 40, with its Model_YAML file's first combo but ``rebuild_k`` 3 (so
that a user's picks and the items' pick counts vary) and ``e_loss`` and
``ssl_alpha`` 0.1 (so that the modal and contrastive terms weigh in). The
port takes the JAX package's initial params (``params.from_numpy``; the
denoisers' nested params flattened as ``img_dn.<name>``), the JAX
trainer's batches and negatives, and every draw the JAX functions make
from their keys: phase A's timesteps, noise and dropout keep masks
(``phase_a_draws``), phase B's four edge keep masks a modality
(``phase_b_draws``), given to the ``*_with_draws`` entries.

The models are built once per module (``pair``), and one test takes the
JAX steps it holds the port to. The trainer's optimizer steps are held as
tests/test_torch_adagcl_grade.py holds AdaGCL's: two phase-A steps of the denoisers' fresh Adam against the JAX
trainer's ``multi_transform`` (Adam on the denoisers, ``set_to_zero``
elsewhere), then two phase-C steps of the main Adam against optax's Adam
over every param: after each, every param and the stepping optimizer's
count and moments. The main Adam leaves the denoisers out: the JAX one
steps them on an exactly zero gradient, its moments for them stay zero,
and the denoisers keep their bits through phase C in both packages.

Tolerances are those of tests/test_torch_adagcl_grade.py: each loss to rtol
1e-5; every gradient and first moment to 1e-4 of its tensor's largest entry
plus 1e-6; the embeddings to rtol 1e-5, atol 1e-6; the second moments to
1e-4 of the tensor's largest entry plus 1e-12. The params after the steps:
rtol 1e-5, atol 1e-6, plus how far Adam can carry a gradient's tolerance
(``adam_drift``): the denoisers' gradients span four decades (a weight of
an input column few rows reach gets a sum that nearly cancels), and Adam
divides each entry by its own scale, so an entry whose gradient is small
moves by its learning rate on a gradient whose last digits are rounding. The
rebuilt graphs' picks are equal and their weights to rtol 1e-6 (a count's
rsqrt); ``dnn_forward`` with bf16 products to 2^-8 of the largest output
(bf16 operands rounded alike, float32 sums in another order).
"""

import functools
import logging
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chaorec_tpu.models import diffmm as jdiffmm
from chaorec_tpu_torch import params as tparams
from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.models import build_model as tbuild
from chaorec_tpu_torch.models import diffmm as tdiffmm
from test_torch_adagcl_grade import V_TOL
from test_torch_bspm import both_clis_export
from test_torch_lightgcn import TOL, assert_grads_close, both_batches, jax_batches
from test_torch_mm_towers import grad_np
from test_torch_vae import one_torch_thread, t  # noqa: F401

from chaorec_tpu.config import Config as JConfig
from chaorec_tpu.models import build_model as jbuild

FLAGS = dict(Model="DiffMM", batch_size=40, dim_E=16, graph_compute_dtype="float32",
             topk=(5, 10, 20), learning_rate=1e-3, reg_weight=1e-4, n_layers=1, e_loss=0.1,
             ssl_alpha=0.1, ris_lambda=0.5, ssl_temp=0.1, rebuild_k=3)
DN_LABEL = "dn"


def flat_params(tree):
    """A JAX params dict with the denoisers' nested dicts flattened as
    ``{prefix}.{name}``, leaves as numpy (MaskedNode leaves dropped)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{n}": np.asarray(a) for n, a in v.items()
                        if not isinstance(a, optax.MaskedNode)})
        elif not isinstance(v, optax.MaskedNode):
            out[k] = np.asarray(v)
    return out


def dn_optimizer(jp, lr):
    """The JAX trainers' ``opt_dn``: Adam on the ``*_dn`` subtrees,
    ``set_to_zero`` elsewhere (diffmm.py:386-397, mhrec.py:387-398)."""
    labels = {k: jax.tree_util.tree_map(lambda _: DN_LABEL if k.endswith("_dn") else "frozen", v)
              for k, v in jp.items()}
    return optax.multi_transform({DN_LABEL: optax.adam(lr), "frozen": optax.set_to_zero()},
                                 labels)


def find_adam(state):
    """The ScaleByAdamState inside an optax state: plain, or the Adam
    group's of a multi_transform (the other group's is ``set_to_zero``)."""
    if isinstance(state, optax.ScaleByAdamState):
        return state
    if isinstance(state, optax.MultiTransformState):
        found = [find_adam(s) for s in state.inner_states.values()]
        return next(s for s in found if s is not None)
    if hasattr(state, "inner_state"):
        return find_adam(state.inner_state)
    if isinstance(state, tuple):
        for s in state:
            found = find_adam(s)
            if found is not None:
                return found
    return None


def assert_adam_state(opt, params, jstate, what, names=None, extra=None):
    """The port Adam ``opt``'s state of each of its params (``names``, when
    given, must be exactly those) against the optax Adam state ``jstate``:
    one count, the first and second moments to their tolerances, plus
    ``extra[name]`` = (first, second) where a gradient's own rounding is
    larger (``moment_slack``)."""
    adam = find_adam(jstate)
    mu, nu = flat_params(adam.mu), flat_params(adam.nu)
    mine = {id(p) for g in opt.param_groups for p in g["params"]}
    got = [k for k, p in params.items() if id(p) in mine]
    if names is not None:
        assert sorted(got) == sorted(names), what
    for k in got:
        st = opt.state[params[k]]
        m_x, v_x = (extra or {}).get(k, (0.0, 0.0))
        assert int(st["step"]) == int(adam.count), f"{what}: {k} count"
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu[k], rtol=0,
                                   atol=1e-4 * float(np.abs(mu[k]).max()) + 1e-6 + m_x,
                                   err_msg=f"{what}: first moment of {k}")
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu[k], rtol=0,
                                   atol=V_TOL * float(np.abs(nu[k]).max()) + 1e-12 + v_x,
                                   err_msg=f"{what}: second moment of {k}")
    return mu, nu


def moment_slack(steps, g_tols, betas=(0.9, 0.999)):
    """Per step, (first, second) moment slack of each param of ``g_tols``
    (per step {name: how far its gradient may be from JAX's}): Adam's
    moments carry a gradient's error d as m += (1 - b1) d and v += (1 - b2)
    (2 |g| d + d^2), decayed by b1 and b2 a step."""
    out, acc = [], {}
    for (_, g, _, _), tols in zip(steps, g_tols):
        grads = flat_params(g)
        for k, d in tols.items():
            m, v = acc.get(k, (0.0, 0.0))
            top = float(np.abs(grads[k]).max())
            acc[k] = (betas[0] * m + (1 - betas[0]) * d,
                      betas[1] * v + (1 - betas[1]) * (2 * top * d + d * d))
        out.append(dict(acc))
    return out


def adam_drift(steps, lr, b2=0.999, eps=1e-8, g_tols=None):
    """Per step, each param's bound (per entry) on how far the port's
    carried params may drift from JAX's through the Adam steps so far: a
    step moves an entry by lr m/(sqrt(v) + eps) (bias-corrected), whose
    ratio is at most about 3 at these betas, so a gradient within its
    tolerance d moves it by at most about (1 + 3) d / sqrt(v) times lr, and
    never by more than 2 lr. ``steps`` are the JAX steps' (loss, gradient,
    params after, state after); ``g_tols`` per step {name: a gradient
    tolerance} where it is larger than the standard one."""
    out, acc = [], {}
    for s, (_, g, _, st) in enumerate(steps):
        adam = find_adam(st)
        grads = flat_params(g)
        for k, v in flat_params(adam.nu).items():
            d = max(1e-4 * float(np.abs(grads[k]).max()) + 1e-6,
                    (g_tols[s] if g_tols else {}).get(k, 0.0))
            v_hat = v / (1 - b2 ** int(adam.count))
            acc[k] = acc.get(k, 0.0) + lr * np.minimum(2.0, 4 * d / (np.sqrt(v_hat) + eps))
        out.append(dict(acc))
    return out


def assert_params(params, jp, what, drift=None):
    """Every param at TOL of JAX's, plus its ``adam_drift`` bound."""
    for k, want in flat_params(jp).items():
        got = params[k].detach().numpy()
        bound = TOL["atol"] + TOL["rtol"] * np.abs(want) + (drift or {}).get(k, 0.0)
        worst = np.max(np.abs(got - want) - bound)
        assert worst <= 0, f"{what}: {k} off its bound by {worst:.3e}"


def phase_a_draws(jm, key, b):
    """The draws ``diffusion_loss`` makes from ``key`` for ``b`` rows
    (diffmm.py:332-340)."""
    out = {}
    for m, k in zip(("img", "txt"), jax.random.split(key)):
        k_t, k_n, k_d = jax.random.split(k, 3)
        out[f"{m}_ts"] = t(jax.random.randint(k_t, (b,), 0, jm.sched.steps)).long()
        out[f"{m}_noise"] = t(jax.random.normal(k_n, (b, jm.num_item)))
        out[f"{m}_keep"] = t(jax.random.bernoulli(k_d, 0.5, (b, jm.num_item))
                             .astype(jnp.float32))
    return out


def phase_b_draws(jm, key):
    """The keep masks ``rebuild_graphs`` draws from ``key`` (diffmm.py:354,
    :89-96)."""
    shapes = ((jm.num_user, jm.rebuild_k),) * 2 + ((jm.num_user,), (jm.num_item,))
    out = {}
    for m, k in zip(("img", "txt"), jax.random.split(key)):
        for j, (kk, s) in enumerate(zip(jax.random.split(k, 4), shapes)):
            out[f"{m}_keep{j}"] = t(jax.random.bernoulli(kk, jm.keep_rate, s)
                                    .astype(jnp.float32))
    return out


def to_port_adj(adj):
    return tdiffmm.ModalAdj(t(adj.topk).long(), *(t(a) for a in adj[1:]))


def assert_adj_equal(got, want, what):
    np.testing.assert_array_equal(got.topk.numpy(), np.asarray(want.topk), err_msg=what)
    for name in ("v_ui", "v_iu", "self_u", "self_i"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=0, err_msg=f"{what}: {name}")


def phase_a_batches(jm, bs, key):
    """The JAX phase A's batches: (users, weights) of each, numpy."""
    from chaorec_tpu.data.sampling import make_epoch_batches

    user_edges = jnp.stack([jnp.arange(jm.num_user, dtype=jnp.int32),
                            jnp.zeros((jm.num_user,), jnp.int32)], axis=1)
    users, _, weights, _ = make_epoch_batches(key, user_edges, bs)
    return [(np.array(u), np.array(w)) for u, w in zip(users, weights)]


@functools.partial(jax.jit, static_argnums=1)
def _j_diff(jp, jm, users, weights, key):
    return jax.value_and_grad(jm.diffusion_loss)(jp, users, weights, key)


@functools.partial(jax.jit, static_argnums=1)
def _j_bpr(jp, jm, state, jb):
    return jax.value_and_grad(jm.loss_bpr)(jp, state, jb)


@pytest.fixture(scope="module")
def pair(tiny_dataset):
    """Both models and the JAX initial params, the JAX phase A's two
    batches and keys, phase B's key and phase C's two batches."""
    ds = tiny_dataset
    jm, tm = jbuild(JConfig(**FLAGS), ds), tbuild(TConfig(**FLAGS), ds, "cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    return SimpleNamespace(
        ds=ds, jm=jm, tm=tm, jp=jp, tp=tparams.from_numpy(flat_params(jp)),
        a_batches=phase_a_batches(jm, FLAGS["batch_size"], jax.random.PRNGKey(4)),
        a_keys=[jax.random.PRNGKey(200 + b) for b in range(2)], b_key=jax.random.PRNGKey(300),
        c_batches=[both_batches(a) for a in jax_batches(ds, FLAGS["batch_size"], (0, 1))])


def leaves(tp):
    return {k: v.clone().requires_grad_() for k, v in tp.items()}


def test_build_graphs_denoiser_and_picks_match_jax(pair):
    """``build_model`` builds DiffMM with its trainer, params of the JAX
    shapes; ``build_modal_adj`` from the JAX picks and draws and
    ``modal_prop`` over it; ``dnn_forward`` in float32 with a keep mask and
    with bf16 products; phase B's picks of the deterministic reverse
    process at float32 (ties to the lower item, as lax.top_k)."""
    jm, tm, jp, tp = pair.jm, pair.tm, pair.jp, pair.tp
    jstate0 = jm.rebuild_graphs(jp, pair.b_key)
    assert isinstance(tm, tdiffmm.DiffMM) and tm.trainer_cls is tdiffmm.DiffMMTrainer
    own = tm.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == {k: tuple(v.shape) for k, v in tp.items()}
    assert (tm.rebuild_k, tm.e_loss, tm.ris_lambda, tm.sample_dtype) == (3, 0.1, 0.5, None)
    draws = phase_b_draws(jm, pair.b_key)
    got = tm.rebuild_graphs_with_draws(tp, draws)
    for g, w, m in zip(got, jstate0, ("img", "txt")):
        assert_adj_equal(g, w, f"{m} graph")
        assert (g.self_u.numpy() == 0).any() and (g.v_ui.numpy() == 0).any()  # dropped entries
    # ties: a constant score row picks its lowest items, as lax.top_k
    scores = torch.zeros((2, 6))
    scores[1, 4] = 1.0
    assert tdiffmm.topk_by_value_then_index(scores, 3).tolist() == [[0, 1, 2], [4, 0, 1]]
    rs = np.random.default_rng(5)
    xu = rs.standard_normal((jm.num_user, 16)).astype(np.float32)
    xi = rs.standard_normal((jm.num_item, 16)).astype(np.float32)
    for g, w in zip(got, jstate0):
        for a, b in zip(tdiffmm.modal_prop(g, t(xu), t(xi)), jdiffmm.modal_prop(w, xu, xi)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    x = pair.a_batches[0][0]
    rows = np.asarray(jm.x)[x]
    ts = np.arange(rows.shape[0]) % jm.sched.steps
    keep = (rs.random(rows.shape) < 0.5).astype(np.float32)
    for dtype in (None, "bfloat16"):
        jdt = None if dtype is None else jnp.bfloat16
        want = np.asarray(jdiffmm.dnn_forward(jp["img_dn"], rows, jnp.asarray(ts), 10, 1,
                                              compute_dtype=jdt))
        got_f = tdiffmm.dnn_forward(tp, "img_dn", t(rows), torch.from_numpy(ts), 10, 1,
                                    compute_dtype=None if dtype is None else torch.bfloat16)
        if dtype is None:
            np.testing.assert_allclose(got_f.numpy(), want, **TOL)
        else:
            np.testing.assert_allclose(got_f.numpy(), want, rtol=0,
                                       atol=2.0 ** -8 * np.abs(want).max())
    kept = tdiffmm.dnn_forward(tp, "img_dn", t(rows), torch.from_numpy(ts), 10, 1, t(keep))
    scale = 1.0 - jm.dnn_dropout
    want = jdiffmm.dnn_forward(jp["img_dn"], rows * keep / scale, jnp.asarray(ts), 10, 1)
    np.testing.assert_allclose(kept.numpy(), np.asarray(want), **TOL)
    for j, prefix in enumerate(("img_dn", "txt_dn")):
        np.testing.assert_array_equal(tm.rebuild_topk(tp, prefix).numpy(),
                                      np.asarray(jstate0[j].topk))


def _assert_loss_and_grads(tloss, lv, jloss, jg, what, dn_reached):
    """A loss and every gradient against JAX's from equal params: the
    denoisers' only (``dn_reached``), or every param's but theirs."""
    assert tloss.item() == pytest.approx(float(jloss), rel=1e-5), what
    for name, want in flat_params(jg).items():
        if (name.split(".")[0] in tdiffmm.DENOISERS) == dn_reached:
            assert_grads_close(grad_np(lv[name]), want, f"{what}: {name}")
        else:
            assert lv[name].grad is None and not want.any(), f"{what}: {name}"


def test_three_phases_match_jax_optimizer_by_optimizer(pair):
    """An epoch's three phases, each package carrying its own params: two
    phase-A steps of the trainer's fresh denoiser Adam (``diffusion_loss``
    under the JAX draws, the second batch padded) against the JAX trainer's
    ``multi_transform``, the rebuild under the JAX draws, then two phase-C
    steps of the main Adam (``Trainer.train_step``; ``loss_bpr``'s two
    contrasts through catalog_logsumexp) against optax's Adam. Before each
    step its loss and every gradient from the JAX params (phase A reaches
    the denoisers only, i_emb and the features detached; phase C all but
    them); after it every param and the stepping optimizer's state. Phase A
    moves the denoisers only, phase C everything but the denoisers, which
    keep their bits (the JAX Adam's moments for them stay 0). Then the
    ranking tables over the rebuilt graphs."""
    jm, tm, lr = pair.jm, pair.tm, FLAGS["learning_rate"]
    family = tm.trainer_cls(tm, pair.ds, TConfig(**FLAGS))
    params = leaves(pair.tp)
    dn_names = tdiffmm.denoiser_names(params, tdiffmm.DENOISERS)
    opt, jopt = family.denoiser_adam(params, tdiffmm.DENOISERS), dn_optimizer(pair.jp, lr)
    jp, jst, a_steps = pair.jp, jopt.init(pair.jp), []
    for b, ((u, w), k) in enumerate(zip(pair.a_batches, pair.a_keys)):
        users, weights = torch.from_numpy(u).long(), torch.from_numpy(w)
        draws = phase_a_draws(jm, k, u.shape[0])
        jloss, jg = _j_diff(jp, jm, jnp.asarray(u), jnp.asarray(w), k)
        lv = leaves(tparams.from_numpy(flat_params(jp)))
        loss = tm.diffusion_loss_with_draws(lv, users, weights, draws)
        loss.backward()
        _assert_loss_and_grads(loss, lv, jloss, jg, f"phase A batch {b}", True)
        upd, jst = jopt.update(jg, jst, jp)
        jp = optax.apply_updates(jp, upd)
        a_steps.append((float(jloss), jg, jp, jst))
        before = {n: v.detach().clone() for n, v in params.items()}
        loss = family.denoise_step(opt, tm.diffusion_loss_with_draws(params, users, weights,
                                                                     draws))
        assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
        assert_params(params, jp, f"phase A step {b}", adam_drift(a_steps, lr)[b])
        assert_adam_state(opt, params, jst, f"phase A step {b}", dn_names)
        assert all(torch.equal(params[n], before[n]) for n in params if n not in dn_names)
    a_drift = adam_drift(a_steps, lr)[-1]
    base = family._base
    jstate = jm.rebuild_graphs(jp, pair.b_key)
    base.model_state = tm.rebuild_graphs_with_draws(params, phase_b_draws(jm, pair.b_key))
    for got, want in zip(base.model_state, jstate):
        assert_adj_equal(got, want, "rebuilt after phase A")
    main, jmain = base.make_optimizer(params), optax.adam(lr)
    dn_before = {n: params[n].detach().clone() for n in dn_names}
    port_state = tuple(to_port_adj(a) for a in jstate)
    jst, c_steps = jmain.init(jp), []
    for b, (jb, tb) in enumerate(pair.c_batches):
        jloss, jg = _j_bpr(jp, jm, jstate, jb)
        lv = leaves(tparams.from_numpy(flat_params(jp)))
        loss, same = tm.loss_stateful(lv, port_state, tb)
        loss.backward()
        assert same is port_state
        _assert_loss_and_grads(loss, lv, jloss, jg, f"phase C batch {b}", False)
        upd, jst = jmain.update(jg, jst, jp)
        jp = optax.apply_updates(jp, upd)
        c_steps.append((float(jloss), jg, jp, jst))
        loss = base.train_step(params, main, tb)
        assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
        assert_params(params, jp, f"phase C step {b}",
                      {k: a_drift.get(k, 0.0) + v for k, v in adam_drift(c_steps, lr)[b].items()})
        mu, nu = assert_adam_state(main, params, jst, f"phase C step {b}",
                                   [n for n in params if n not in dn_names])
        assert not any(mu[n].any() or nu[n].any() for n in dn_names)
        assert all(torch.equal(params[n], dn_before[n]) for n in dn_names)
    with torch.no_grad():
        got = tm.embeddings_stateful(tparams.from_numpy(flat_params(jp)), port_state)
    for a, b in zip(got, jm.embeddings_stateful(jp, jstate)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_cli_log_matches_jax_cli_and_skips_the_export(tiny_dataset, monkeypatch, tmp_path):
    """Each package's cli.run of the first combo, 1 epoch, through the
    trainer_cls dispatch: the same line shapes, the phase lines word for
    word; ``--export_artifact`` logs the JAX CLI's warning and writes no
    file (the trainer keeps no weights)."""
    flags = {k: v for k, v in FLAGS.items() if k in ("Model", "dim_E", "topk")}
    jlines, tlines, arts = both_clis_export(tiny_dataset, monkeypatch, tmp_path,
                                            dict(flags, batch_size=40))
    assert tlines == jlines
    n = tiny_dataset.num_user // 40
    steps = [x for x in tlines if x.startswith("INFO Diffusion Step")]
    assert steps == [f"INFO Diffusion Step #/#; Diffusion Loss #"] * (-(-64 // 40))
    raw = open(tmp_path / "torch" / "DiffMM_tiny.log").read()
    assert f"Diffusion Step 1/{n}; Diffusion Loss " in raw
    i = tlines.index("INFO Start to re-build UI matrix")
    assert tlines[i - 1] == "INFO " and tlines[i + 1] == "INFO UI matrix built!"
    assert not any(os.path.exists(a) for a in arts)
    assert "WARNING export_artifact: best combo's trainer kept no weights - skipping export" \
        in tlines
    logging.getLogger().handlers.clear()
