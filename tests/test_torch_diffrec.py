"""models/diffrec.py against chaorec_tpu/models/diffrec.py, on the trainer's
user-rows branch.

Both packages build DiffRec from ``tiny_dataset`` (64 users x 48 items) at
the first combo of Model_YAML/DiffRec.yaml (5 steps, noise scale 1e-3,
noise_min = noise_max = 5e-3, dims "[1000]": an MLP [48 + 10 -> 1000 ->
48]). The port takes the JAX package's initial params and loss history,
its user-row batches (``make_epoch_batches`` over (user, 0) rows, the
last one padded) and the draws its loss makes from its key: timesteps,
their importance weights, noise and the dropout mask, given to
``loss_stateful_with_draws``.

Tolerances: each loss to rtol 1e-5; every gradient to 1e-4 of its
tensor's largest entry plus 1e-6; the loss history and the scores on a
float32 reverse process to rtol 1e-5, atol 1e-6. The scores' bf16 path
(bf16 products summed in float32, the default) is held to the float32
path at 2^-6 of the largest score: each layer's input is rounded to bf16
(2^-8 relative), through two layers and five steps.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chaorec_tpu.data import sampling as jsampling
from chaorec_tpu.models.base import Batch as JBatch
from chaorec_tpu.ops import diffusion as jdiff
from chaorec_tpu_torch import params as tparams
from chaorec_tpu_torch import serve as tserve
from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.models.base import Batch as TBatch
from chaorec_tpu_torch.models.diffrec import DiffRec
from chaorec_tpu_torch.ops import diffusion as tdiff
from chaorec_tpu_torch.train import loop as tloop
from test_torch_lightgcn import assert_grads_close, make_pair
from test_torch_vae import adam_step, cli_logs_match, jit_loss, one_torch_thread, t  # noqa: F401

FLAGS = dict(Model="DiffRec", batch_size=24, learning_rate=0.0005, noise_scale=0.001,
             noise_min=0.005, noise_max=0.005, steps=5, dims="[1000]", topk=(5, 10, 20))
F32 = dict(FLAGS, graph_compute_dtype="float32")
TOL = dict(rtol=1e-5, atol=1e-6)


@functools.partial(jax.jit, static_argnums=3)
def _jax_draws(jm, rng, state, b):
    """The draws of DiffRec's loss from ``rng`` (diffrec.py:98-100 and
    ops/diffusion.py:147-150)."""
    k_drop, k_diff = jax.random.split(rng)
    k_t, k_n = jax.random.split(k_diff)
    ts, pt = jdiff.sample_timesteps(k_t, state, b, jm.steps)
    return {"ts": ts, "pt": pt, "noise": jax.random.normal(k_n, (b, jm.num_item)),
            "keep": jax.random.bernoulli(k_drop, 1.0 - jm.dnn_dropout, (b, jm.num_item)) * 1.0}


def jax_draws(jm, rng, state, b):
    d = {k: t(v) for k, v in _jax_draws(jm, rng, state, b).items()}
    d["ts"] = d["ts"].long()
    return d


def user_batches(ds, batch_size, seed=5):
    """The JAX trainer's user-row batches (loop.py:472-476): (user, 0) rows
    through make_epoch_batches, the last one padded; JAX and port Batch."""
    rows = jnp.stack([jnp.arange(ds.num_user, dtype=jnp.int32),
                      jnp.zeros(ds.num_user, jnp.int32)], axis=1)
    users, pos, weights, _ = jsampling.make_epoch_batches(jax.random.PRNGKey(seed), rows,
                                                          batch_size)
    out = []
    for b in (0, 1, users.shape[0] - 1):
        jb = JBatch(users[b], pos[b], pos[b], weights[b])
        tb = TBatch(torch.from_numpy(np.array(users[b])).long(),
                    torch.from_numpy(np.array(weights[b])))
        out.append((jb, tb))
    return out


def ready_state(steps=5, seed=0):
    rs = np.random.default_rng(seed)
    return (jnp.asarray(rs.random((steps, tdiff.HISTORY_PER_TERM)).astype(np.float32)),
            jnp.full((steps,), tdiff.HISTORY_PER_TERM, jnp.int32))


def test_build_shapes_and_quirks(tiny_dataset):
    jm, tm, jp, tp = make_pair(tiny_dataset, FLAGS)
    assert isinstance(tm, DiffRec) and (tm.rank_mode, tm.stateful, tm.trainer_mode) == (
        "scores", True, "user_rows")
    assert tm.mask_value == float(jm.mask_value) == float("-inf")
    assert tm.sample_dtype == torch.bfloat16
    own = tm.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert own["in_w0"].shape == (1000, 58) and own["out_w0"].shape == (48, 1000)
    for name in ("betas", "alphas_cumprod", "posterior_mean_coef1", "posterior_mean_coef2"):
        np.testing.assert_array_equal(getattr(tm.sched, name).numpy(),
                                      np.asarray(getattr(jm.sched, name)))
    th, tc = tm.init_state("cpu")
    jh, jc = jm.init_state(None)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("ready", [False, True], ids=["uniform_steps", "importance_steps"])
def test_loss_gradients_and_history_match_jax(tiny_dataset, ready):
    """On the padded last batch, from an empty loss history and from a full
    one (importance-sampled timesteps)."""
    jm, tm, jp, tp = make_pair(tiny_dataset, FLAGS)
    jb, tb = user_batches(tiny_dataset, 24)[-1]
    assert float(jb.weights.sum()) < 24
    jstate = ready_state() if ready else jm.init_state(None)
    rng = jax.random.PRNGKey(11)
    (jloss, (jh, jc)), jg = jit_loss(jm, grad=True)(jp, jstate, jb, rng)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tloss, (th, tc) = tm.loss_stateful_with_draws(
        leaves, tparams.from_numpy(tuple(np.asarray(x) for x in jstate)), tb,
        jax_draws(jm, rng, jstate, 24))
    tloss.backward()
    assert tloss.item() == pytest.approx(float(jloss), rel=1e-5)
    for k in jg:
        assert_grads_close(leaves[k].grad.numpy(), np.asarray(jg[k]), k)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_three_trainer_steps_match_jax(tiny_dataset):
    """Trainer.train_step on the JAX package's user-row batches (the last
    one padded) against value_and_grad of the JAX loss and optax.adam
    (AdamW at weight decay 0), each step from equal params, the loss
    history carried by each package on its own."""
    ds = tiny_dataset
    jm, tm, jp, tp = make_pair(ds, FLAGS)
    trainer = tloop.Trainer(tm, ds, TConfig(**FLAGS))
    assert trainer.user_rows
    params = {k: v.clone().requires_grad_() for k, v in tp.items()}
    opt = trainer.make_optimizer(params)
    jopt = optax.adam(FLAGS["learning_rate"]).init(jp)
    jstate = jm.init_state(None)
    value_and_grad = jit_loss(jm, grad=True)
    for step, (jb, tb) in enumerate(user_batches(ds, 24)):
        rng = jax.random.PRNGKey(100 + step)
        drawn = jax_draws(jm, rng, jstate, 24)
        (jloss, jstate), jg = value_and_grad(jp, jstate, jb, rng)
        with torch.no_grad():
            for k, v in jp.items():
                params[k].copy_(torch.from_numpy(np.array(v)))
        tm.draws = lambda *args: drawn
        tloss = trainer.train_step(params, opt, tb)
        assert tloss.item() == pytest.approx(float(jloss), rel=1e-5), step
        for k in jg:
            assert_grads_close(params[k].grad.numpy(), np.asarray(jg[k]), f"{k} step {step}")
        np.testing.assert_allclose(trainer.model_state[0].numpy(), np.asarray(jstate[0]), **TOL)
        np.testing.assert_array_equal(trainer.model_state[1].numpy(), np.asarray(jstate[1]))
        jp, jopt = adam_step(jg, jopt, jp, FLAGS["learning_rate"])


def test_scores_match_jax(tiny_dataset):
    """The reverse process in float32 in both packages to TOL; the default
    bf16 products against the float32 path (see the module docstring), and
    the JAX package's bf16 path likewise."""
    ids = np.arange(64, dtype=np.int32)
    jm, tm, jp, tp = make_pair(tiny_dataset, F32)
    assert tm.sample_dtype is None
    want = np.asarray(jm.score_users(jp, jnp.asarray(ids)))
    got = tm.score_users(tp, torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    jm16, tm16, _, _ = make_pair(tiny_dataset, FLAGS)
    got16 = tm16.score_users(tp, torch.from_numpy(ids).long()).numpy()
    want16 = np.asarray(jm16.score_users(jp, jnp.asarray(ids)))
    bound = 2.0 ** -6 * np.abs(want).max()
    assert np.abs(got16 - got).max() <= bound and np.abs(want16 - want).max() <= bound
    assert not np.array_equal(got16, got)  # the bf16 route did run


def test_evaluate_masks_seen_items_with_minus_inf(tiny_dataset, tmp_path):
    """Seen items score -inf in the trainer's ranking and the export: over
    the whole catalog they are each user's last items, whatever the
    unseen items score; the export's lists hold no seen item and serve as
    written."""
    ds = tiny_dataset
    _, tm, _, tp = make_pair(ds, FLAGS)
    cfg = TConfig(**dict(FLAGS, rank_topk=48))
    trainer = tloop.Trainer(tm, ds, cfg)
    _, _, rank = trainer.evaluate(tp)
    assert rank.shape == (64, 48)
    for u in range(64):
        n = int(ds.history.lengths[u])
        seen = set((ds.history.values[u][:n] + 64).tolist())
        assert set(rank[u, 48 - n:].tolist()) == seen, u
    path = str(tmp_path / "diffrec.npz")
    tserve.export_artifact(tm, tp, trainer.model_state, ds, path, score_topk=48)
    with np.load(path) as z:
        scores, ids = z["rank_scores"], z["rank_ids"]
    assert np.isneginf(scores[:, -6:]).all() and np.isfinite(scores[:, :-6]).all()
    for u in range(64):
        n = int(ds.history.lengths[u])
        assert set(ids[u, 48 - n:].tolist()) == set((ds.history.values[u][:n] + 64).tolist())
    rec = tserve.Recommender.load(path, "cpu")
    for u, res in zip((0, 7, 63), rec.recommend([0, 7, 63], k=10)):
        assert [i for i, _ in res] == ids[u, :10].tolist()


def test_cli_log_matches_jax_cli(tiny_dataset, monkeypatch, tmp_path):
    _, art = cli_logs_match(tiny_dataset, monkeypatch, tmp_path, FLAGS, export=True)
    with np.load(art) as z:
        assert str(z["kind"]) == "ranklists" and str(z["model"]) == "DiffRec"
        assert z["rank_ids"].shape == (64, 48)
