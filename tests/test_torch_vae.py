"""models/multvae.py, models/macridvae.py and models/dualvae.py against the
JAX package's, and the host pieces they ride on: the trainer's stateful
BPR branch with a score-mode model, ``eval/ranking.scorer`` and the
stateful score export.

Both packages build each model from ``tiny_dataset`` (64 users x 48 items,
384 train edges) at dim 16 with its Model_YAML file's first combo
otherwise (MacridVAE's 10 concepts and 600-wide encoder, DualVAE's 5
aspects of 25). The port takes the JAX package's initial params and
initial state (``params.from_numpy``), its batches and negatives, and the
draws its loss makes from its key: dropout masks, eps and Gumbel
uniforms, given to ``loss_stateful_with_draws``.

Tolerances: each loss to rtol 1e-5; every gradient to 1e-4 of its
tensor's largest entry plus 1e-6; scores and carried state to rtol 1e-5,
atol 1e-6 (MacridVAE's scores atol 1e-6 / tau = 1e-5: its logits are
products of unit rows over tau 0.1; DualVAE's caches after three steps
each package carries on its own: atol 1e-5).
"""

import functools
import logging
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chaorec_tpu import cli as jcli
from chaorec_tpu import serve as jserve
from chaorec_tpu.config import Config as JConfig
from chaorec_tpu_torch import cli as tcli
from chaorec_tpu_torch import params as tparams
from chaorec_tpu_torch import serve as tserve
from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.config import grid_combinations, load_yaml_config
from chaorec_tpu_torch.eval.ranking import mask_rows, rank_from_scores
from chaorec_tpu_torch.models.dualvae import DualVAE, write_rows
from chaorec_tpu_torch.models.macridvae import MacridVAE
from chaorec_tpu_torch.models.multvae import MultVAE
from chaorec_tpu_torch.train import loop as tloop
from test_torch_lightgcn import assert_grads_close, both_batches, jax_batches, make_pair
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

BASE = dict(batch_size=100, dim_E=16, topk=(5, 10, 20))
MULTVAE = dict(BASE, Model="MultVAE", learning_rate=0.01, reg_weight=0.01)
MACRIDVAE = dict(BASE, Model="MacridVAE", learning_rate=0.01)
DUALVAE = dict(BASE, Model="DualVAE", learning_rate=0.001, reg_weight=0.5, ssl_alpha=0.01)
FLAGS = {"MultVAE": MULTVAE, "MacridVAE": MACRIDVAE, "DualVAE": DUALVAE}
TOL = dict(rtol=1e-5, atol=1e-6)
STATE_TOL = dict(rtol=1e-5, atol=1e-5)


def t(x):
    """A JAX array as a tensor."""
    return torch.from_numpy(np.array(x))


def jax_draws(jm, rng, b):
    return {k: t(v) for k, v in _jax_draws(jm, rng, b).items()}


@functools.partial(jax.jit, static_argnums=2)
def _jax_draws(jm, rng, b):
    """The draws each JAX loss makes from ``rng`` for a batch of ``b`` rows,
    repeating its split order (multvae.py:67, macridvae.py:80-106,
    dualvae.py:124-141); masks as float32."""
    if jm.name == "MultVAE":
        k_drop, k_eps = jax.random.split(rng)
        return {"keep": jax.random.bernoulli(k_drop, jm.keep_prob, (b, jm.num_item)) * 1.0,
                "eps": jax.random.normal(k_eps, (b, jm.dim_E))}
    if jm.name == "MacridVAE":
        rng, k_drop, k_gumbel = jax.random.split(rng, 3)
        eps = []
        for _ in range(jm.kfac):
            rng, k_eps = jax.random.split(rng)
            eps.append(jax.random.normal(k_eps, (b, jm.dim_E)))
        return {"keep": jax.random.bernoulli(k_drop, 1 - jm.drop_out, (b, jm.num_item)) * 1.0,
                "gumbel_u": jax.random.uniform(k_gumbel, (jm.num_item, jm.kfac)),
                "eps": jnp.stack(eps)}
    out = {}
    for name, key in zip(("eps_i", "eps_u"), jax.random.split(rng)):
        eps = []
        for _ in range(jm.a):
            key, k = jax.random.split(key)
            eps.append(jax.random.normal(k, (b, jm.k)))
        out[name] = jnp.stack(eps)
    return out


def _loss_stateful(p, m, s, b, r):
    return m.loss_stateful(p, s, b, r)


# jitted once, with the model as an argument, so that the tests of one
# process share each compile (op by op, the JAX losses are slow to run)
_JIT_LOSS = {False: jax.jit(_loss_stateful),
             True: jax.jit(jax.value_and_grad(_loss_stateful, has_aux=True))}


@functools.partial(jax.jit, static_argnums=3)
def adam_step(grads, opt_state, params, lr):
    """One optax.adam step at ``lr`` (torch's defaults): (params, opt_state)."""
    upd, opt_state = optax.adam(lr).update(grads, opt_state, params)
    return optax.apply_updates(params, upd), opt_state


def jit_loss(jm, grad=False):
    """The JAX ``loss_stateful(params, state, batch, rng)``; with ``grad``,
    its value_and_grad in the params."""
    return lambda p, s, b, r: _JIT_LOSS[grad](p, jm, s, b, r)


def jax_state(jm):
    return jm.init_state(jax.random.PRNGKey(9))


def state_np(state):
    return {k: np.asarray(v) for k, v in state.items()} if isinstance(state, dict) \
        else np.asarray(state)


def assert_state_close(got, want, msg, tol=TOL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **tol,
                                       err_msg=f"{msg} {k}")
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol, err_msg=msg)


def stateful_steps_match(ds, flags, jm, tm, jp, tp, jstate, draw_fn, batches, state_tol=TOL):
    """Trainer.train_step on ``batches`` (pairs of JAX and port batches)
    against value_and_grad of the JAX loss_stateful and optax.adam, each
    step from equal params, the state carried by each package on its own:
    each step's loss, gradients and new state. ``draw_fn(rng, batch)`` gives
    the JAX loss's draws, which the port's ``draws`` then returns."""
    trainer = tloop.Trainer(tm, ds, TConfig(**flags))
    trainer.model_state = tparams.from_numpy(state_np(jstate))
    params = {k: v.clone().requires_grad_() for k, v in tp.items()}
    opt = trainer.make_optimizer(params)
    jopt = optax.adam(flags["learning_rate"]).init(jp)
    value_and_grad = jit_loss(jm, grad=True)
    for step, (jb, tb) in enumerate(batches):
        rng = jax.random.PRNGKey(100 + step)
        (jloss, jstate), jg = value_and_grad(jp, jstate, jb, rng)
        with torch.no_grad():
            for k, v in jp.items():
                params[k].copy_(torch.from_numpy(np.array(v)))
        drawn = draw_fn(rng, jb)
        tm.draws = lambda *args: drawn
        tloss = trainer.train_step(params, opt, tb)
        assert tloss.item() == pytest.approx(float(jloss), rel=1e-5), step
        for k in jg:
            assert_grads_close(params[k].grad.numpy(), np.asarray(jg[k]), f"{k} step {step}")
        assert_state_close(trainer.model_state, jstate, f"state after step {step}", state_tol)
        jp, jopt = adam_step(jg, jopt, jp, flags["learning_rate"])
    del tm.draws
    return trainer, params


@pytest.mark.parametrize("name", list(FLAGS))
def test_build_shapes_params_and_state_match_jax(tiny_dataset, name):
    jm, tm, jp, tp = make_pair(tiny_dataset, FLAGS[name])
    assert isinstance(tm, {"MultVAE": MultVAE, "MacridVAE": MacridVAE, "DualVAE": DualVAE}[name])
    assert (tm.name, tm.rank_mode, tm.stateful, tm.trainer_mode) == (name, "scores", True, "bpr")
    own = tm.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    np.testing.assert_array_equal(tm.x.numpy(), np.asarray(jm.x))
    js = state_np(jm.init_state(jax.random.PRNGKey(0)))
    ts = tm.init_state("cpu", torch.Generator().manual_seed(0))
    if isinstance(js, dict):
        assert {k: tuple(v.shape) for k, v in ts.items()} == {k: v.shape for k, v in js.items()}
        assert all(float(ts[k].abs().max()) == 0 for k in ("mu_theta", "mu_beta"))
        assert 0.005 < float(ts["theta"].std()) < 0.02
    else:
        assert ts.shape == () and float(ts) == 0.0 == float(js)
    if name == "MultVAE":
        assert all(0.0 <= float(v.min()) and float(v.max()) < 1.0 for v in own.values())
    if name == "MacridVAE":
        assert (tm.kfac, tm.hidden, tm.tau, tm.std) == (10, 600, 0.1, 0.01)


@pytest.mark.parametrize("name,step", [(n, s) for n in FLAGS for s in (0, -1)],
                         ids=[f"{n}-{'full' if s == 0 else 'padded'}_batch" for n in FLAGS
                              for s in (0, -1)])
def test_loss_gradients_and_new_state_match_jax(tiny_dataset, name, step):
    """From a state away from the initial one (MultVAE's and MacridVAE's
    counter at 30000, so the anneal term is on; DualVAE's caches after a
    JAX step)."""
    jm, tm, jp, tp = make_pair(tiny_dataset, FLAGS[name])
    jb, tb = both_batches(jax_batches(tiny_dataset, 100, steps=(step,))[0])
    jstate = jax_state(jm)
    if name == "DualVAE":
        jb0, _ = both_batches(jax_batches(tiny_dataset, 100, steps=(1,))[0])
        _, jstate = jit_loss(jm)(jp, jstate, jb0, jax.random.PRNGKey(3))
    else:
        jstate = jnp.float32(30000.0)
    rng = jax.random.PRNGKey(11)
    (jloss, jnew), jg = jit_loss(jm, grad=True)(jp, jstate, jb, rng)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tloss, tnew = tm.loss_stateful_with_draws(leaves, tparams.from_numpy(state_np(jstate)), tb,
                                              jax_draws(jm, rng, 100))
    tloss.backward()
    assert tloss.item() == pytest.approx(float(jloss), rel=1e-5)
    for k in jg:
        assert_grads_close(leaves[k].grad.numpy(), np.asarray(jg[k]), k)
    assert not any(v.requires_grad for v in (tnew.values() if isinstance(tnew, dict) else [tnew]))
    assert_state_close(tnew, jnew, "new state")


@pytest.mark.parametrize("name", list(FLAGS))
def test_three_trainer_steps_match_jax(tiny_dataset, name):
    jm, tm, jp, tp = make_pair(tiny_dataset, FLAGS[name])
    batches = [both_batches(a) for a in jax_batches(tiny_dataset, 100)]
    assert float(batches[-1][1].weights.sum()) < 100  # the padded last batch
    stateful_steps_match(tiny_dataset, FLAGS[name], jm, tm, jp, tp, jax_state(jm),
                         lambda rng, jb: jax_draws(jm, rng, jb.users.shape[0]), batches,
                         STATE_TOL if name == "DualVAE" else TOL)


@pytest.mark.parametrize("name", list(FLAGS))
def test_scores_match_jax(tiny_dataset, name):
    """score_users (MultVAE, MacridVAE) or score_users_stateful (DualVAE,
    on caches after a JAX step), and the rank list that the trainer's
    ``rank_from_scores`` makes of them."""
    jm, tm, jp, tp = make_pair(tiny_dataset, FLAGS[name])
    ids = np.arange(64, dtype=np.int32)
    state = None
    if name == "DualVAE":
        jb, _ = both_batches(jax_batches(tiny_dataset, 100, steps=(0,))[0])
        _, jstate = jit_loss(jm)(jp, jax_state(jm), jb, jax.random.PRNGKey(4))
        want = jm.score_users_stateful(jp, jstate, jnp.asarray(ids))
        state = tparams.from_numpy(state_np(jstate))
        got = tm.score_users_stateful(tp, state, torch.from_numpy(ids).long())
    else:
        want = jm.score_users(jp, jnp.asarray(ids))
        got = tm.score_users(tp, torch.from_numpy(ids).long())
    # MacridVAE's logits are unit-row products over tau = 0.1, so a float32
    # ulp of a product is 10 of its score: atol 1e-6 / tau
    tol = dict(TOL, atol=TOL["atol"] / tm.tau) if name == "MacridVAE" else TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    # ranked in chunks of 24 users: each list is the top 20 of its user's
    # scores with the seen items set to 1e-6
    hist = torch.from_numpy(tiny_dataset.history.values)
    rank = rank_from_scores(tm, tp, hist, topk=20, user_chunk=24, state=state)
    masked = mask_rows(got, hist, 1e-6)
    ranked = torch.gather(masked, 1, rank - 64)
    np.testing.assert_allclose(ranked.numpy(), torch.topk(masked, 20, dim=1).values.numpy(),
                               **TOL)


def test_dualvae_cache_rule_matches_jax_on_repeated_ids(tiny_dataset):
    """The JAX package's ``.at[ids].set`` leaves the last occurrence's row
    where an id repeats (the CPU's scatter); ``write_rows`` gives the same
    table, for a batch whose ids repeat and whose pad rows repeat its first
    edge, and the rows it writes are those of each id's last occurrence."""
    ids = np.array([5, 3, 5, 0, 7, 3, 5, 2, 2, 2], np.int64)
    rows = np.random.default_rng(0).standard_normal((10, 4, 3)).astype(np.float32)
    table = np.random.default_rng(1).standard_normal((9, 4, 3)).astype(np.float32)
    want = np.asarray(jnp.asarray(table).at[jnp.asarray(ids)].set(jnp.asarray(rows)))
    got = write_rows(torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want)
    for i in set(ids.tolist()):
        np.testing.assert_array_equal(got.numpy()[i], rows[np.flatnonzero(ids == i)[-1]])
    untouched = [i for i in range(9) if i not in set(ids.tolist())]
    np.testing.assert_array_equal(got.numpy()[untouched], table[untouched])
    # the model's whole step on the padded last batch, whose ids repeat
    jm, tm, jp, tp = make_pair(tiny_dataset, DUALVAE)
    jb, tb = both_batches(jax_batches(tiny_dataset, 100, steps=(-1,))[0])
    users, items = np.asarray(jb.users), np.asarray(jb.pos_items)
    assert len(set(users.tolist())) < 100 and len(set(items.tolist())) < 100
    assert float(np.asarray(jb.weights).sum()) < 100
    rng = jax.random.PRNGKey(2)
    _, jnew = jit_loss(jm)(jp, jax_state(jm), jb, rng)
    _, tnew = tm.loss_stateful_with_draws(tp, tparams.from_numpy(state_np(jax_state(jm))), tb,
                                          jax_draws(jm, rng, 100))
    assert_state_close(tnew, jnew, "caches after the padded batch")


def test_evaluate_and_export_rank_by_the_carried_state(tiny_dataset, tmp_path):
    """A stateful score-mode model: Trainer.evaluate ranks by
    score_users_stateful with the trainer's state, the export writes the
    same rank lists from the best epoch's state, and an artifact of either
    package serves the same answers through serve.Recommender."""
    ds = tiny_dataset
    jm, tm, jp, tp = make_pair(ds, DUALVAE)
    jb, _ = both_batches(jax_batches(ds, 100, steps=(0,))[0])
    _, jstate = jit_loss(jm)(jp, jax_state(jm), jb, jax.random.PRNGKey(6))
    state = tparams.from_numpy(state_np(jstate))
    trainer = tloop.Trainer(tm, ds, TConfig(**DUALVAE))
    trainer.model_state = state
    _, _, rank = trainer.evaluate(tp)
    with torch.no_grad():
        scores = tm.score_users_stateful(tp, state, torch.arange(64))
        fresh = tm.score_users_stateful(tp, tm.init_state("cpu"), torch.arange(64))
    assert float((scores - fresh).abs().max()) > 1e-3  # the state matters
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jserve.export_artifact(jm, jp, jstate, ds, jpath, score_topk=20)
    tserve.export_artifact(tm, tp, state, ds, tpath, score_topk=20)
    # items whose mu_beta rows are still zero score alike, and two top-k
    # calls may order such ties differently: each list is checked by its
    # scores, which must be its user's top 20
    top = torch.topk(mask_rows(scores, trainer.history, 1e-6), 20, dim=1).values.numpy()
    masked = mask_rows(scores, trainer.history, 1e-6).numpy()
    with np.load(jpath) as jz, np.load(tpath) as tz:
        assert str(tz["kind"]) == "ranklists" and str(tz["model"]) == "DualVAE"
        np.testing.assert_allclose(tz["rank_scores"], jz["rank_scores"], **TOL)
        np.testing.assert_allclose(tz["rank_scores"], top, **TOL)
        for ids in (tz["rank_ids"], jz["rank_ids"], rank.numpy()[:, :20]):
            np.testing.assert_allclose(np.take_along_axis(masked, ids - 64, 1), top, **TOL)
    for path in (jpath, tpath):  # either package's artifact serves its own lists
        with np.load(path) as z:
            rank_ids = z["rank_ids"]
        got = tserve.Recommender.load(path, "cpu").recommend([0, 5, 63], k=10)
        for u, res in zip((0, 5, 63), got):
            assert [i for i, _ in res] == rank_ids[u, :10].tolist()
            seen = set((ds.history.values[u][:ds.history.lengths[u]] + 64).tolist())
            assert not seen & {i for i, _ in res}


# --- the CLI ----------------------------------------------------------------
DATE = r"[A-Z][a-z]{2} \d{2} [A-Z][a-z]{2} \d{4} \d{2}:\d{2}:\d{2} INFO "
NUMBER = re.compile(r"-?\d+(\.\d+)?(e-?\d+)?")


def _shapes(path):
    messages = [re.sub(DATE, "", line) for line in open(path).read().splitlines()]
    start = next(i for i, m in enumerate(messages) if m.startswith("=========1/"))
    return [NUMBER.sub("#", m) for m in messages[start:]]


def cli_logs_match(ds, monkeypatch, tmp_path, flags, export=False, num_epoch=1):
    """``num_epoch`` epochs of ``flags["Model"]`` at its Model_YAML file's
    first combo through each package's cli.run: the same line shapes.
    Returns the port's best metrics and its artifact's path (``export``)."""
    name = flags["Model"]
    monkeypatch.setattr(jcli, "data_load", lambda *a, **kw: ds)
    combo = next(grid_combinations(load_yaml_config(name)))
    grid = {k: [v] for k, v in combo.items()}
    grid["hyper_parameters"] = list(combo)
    run_flags = dict(flags, data_path="tiny", num_epoch=num_epoch)
    art = str(tmp_path / f"{name}.npz") if export else ""
    root = logging.getLogger()
    handlers = list(root.handlers)
    try:
        jcli.run(JConfig(**run_flags, log_dir=str(tmp_path / "jax")), grid)
        best = tcli.run(TConfig(**run_flags, log_dir=str(tmp_path / "torch"),
                                export_artifact=art), grid, ds, "cpu")
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
            h.close()
        for h in handlers:
            root.addHandler(h)
    jlines = _shapes(tmp_path / "jax" / f"{name}_tiny.log")
    tlines = [line for line in _shapes(tmp_path / "torch" / f"{name}_tiny.log")
              if not line.startswith(("export_artifact", "serving artifact"))]
    assert tlines == jlines
    assert sum(line == "Epoch #, Loss: #" for line in tlines) == num_epoch
    assert sorted(best) == [5, 10, 20]
    assert all(np.isfinite(v) for m in best.values() for v in m.values())
    return best, art


@pytest.mark.parametrize("name", list(FLAGS))
def test_cli_log_matches_jax_cli(tiny_dataset, monkeypatch, tmp_path, name):
    _, art = cli_logs_match(tiny_dataset, monkeypatch, tmp_path, FLAGS[name],
                            export=name == "DualVAE")
    if art:
        with np.load(art) as z:
            assert str(z["kind"]) == "ranklists" and z["rank_ids"].shape == (64, 48)
            assert np.isfinite(z["rank_scores"]).all()
