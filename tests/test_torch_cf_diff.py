"""models/cf_diff.py against chaorec_tpu/models/cf_diff.py.

The JAX package's ``init_params(PRNGKey(0))`` goes through
``params.from_numpy``, so both packages score and train with the same
weights. Scores are float32 after 10 diffusion steps of the CAM_AE
denoiser; the port holds them to rtol 1e-4 and atol 1e-5 (what is reached
is ~1e-7 absolute). Training is compared with dropout off on both sides
(the two packages draw different masks), on the JAX package's own draws of
timesteps and noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chaorec_tpu.config import Config as JConfig
from chaorec_tpu.models import build_model as jbuild
from chaorec_tpu.models import cf_diff as jcf
from chaorec_tpu.ops import diffusion as jdiff
from chaorec_tpu.ops import pallas_attn
from chaorec_tpu_torch import params as tparams
from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.models import build_model as tbuild
from chaorec_tpu_torch.models import cf_diff as tcf
from chaorec_tpu_torch.models.base import Batch
from chaorec_tpu_torch.ops import diffusion as tdiff
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

# Model_YAML/CF_Diff.yaml, first combo
CFG = dict(Model="CF_Diff", steps=10, noise_scale=0.1, noise_min=5e-4, noise_max=5e-3)
TOL = dict(rtol=1e-4, atol=1e-5)


def _pair(ds, monkeypatch, width):
    monkeypatch.setattr(jcf.CF_Diff, "dim_inters", width)
    monkeypatch.setattr(tcf.CF_Diff, "dim_inters", width)
    jm = jbuild(JConfig(**CFG), ds)
    tm = tbuild(TConfig(**CFG), ds, "cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = tparams.from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    return jm, jp, tm, tp


def _scores(jm, jp, tm, tp, n):
    want = np.asarray(jm.score_users(jp, jnp.arange(n, dtype=jnp.int32)))
    got = tm.score_users(tp, torch.arange(n)).numpy()
    return got, want


def test_buffers_and_param_shapes(tiny_dataset, monkeypatch):
    jm, jp, tm, _ = _pair(tiny_dataset, monkeypatch, 64)
    np.testing.assert_array_equal(tm.x.numpy(), np.asarray(jm.x))
    np.testing.assert_allclose(tm.sec.numpy(), np.asarray(jm.sec), rtol=1e-7)
    own = tm.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert all(v.dtype == torch.float32 for v in own.values())
    assert tm.seq_len == jm.seq_len and tm.rank_mode == jm.rank_mode
    assert tm.mask_value == float(jm.mask_value) == float("-inf")
    th, tc = tm.init_state("cpu")
    jh, jc = jm.init_state(jax.random.PRNGKey(0))
    assert th.shape == jh.shape and tc.shape == jc.shape


def test_score_users_small_width(tiny_dataset, monkeypatch):
    jm, jp, tm, tp = _pair(tiny_dataset, monkeypatch, 64)
    got, want = _scores(jm, jp, tm, tp, tiny_dataset.num_user)
    np.testing.assert_allclose(got, want, **TOL)


def test_score_users_full_width(tiny_dataset, monkeypatch):
    """The published 1034-token width, for a few users."""
    jm, jp, tm, tp = _pair(tiny_dataset, monkeypatch, tcf.CF_Diff.dim_inters)
    assert tm.seq_len == 1034
    got, want = _scores(jm, jp, tm, tp, 3)
    np.testing.assert_allclose(got, want, **TOL)


def test_score_users_against_pallas_interpret(tiny_dataset, monkeypatch):
    """The JAX side through its Pallas kernel in interpret mode."""
    calls = []

    def interpret(q, k, v, seed, keep):
        calls.append(q.shape)
        return pallas_attn.fused_mha(q, k, v, seed, keep, True)

    monkeypatch.setattr(jcf, "use_fused_attn", lambda: True)
    monkeypatch.setattr(jcf, "fused_mha", interpret)
    jm, jp, tm, tp = _pair(tiny_dataset, monkeypatch, 64)
    got, want = _scores(jm, jp, tm, tp, 8)
    assert calls, "the JAX side did not reach the Pallas kernel"
    np.testing.assert_allclose(got, want, **TOL)


def test_cpu_path_micro_batches_match_one_batch(tiny_dataset, monkeypatch):
    """The CPU path's micro-batching does not change the scores."""
    _, _, tm, tp = _pair(tiny_dataset, monkeypatch, 64)
    whole = tm.score_users(tp, torch.arange(20))
    monkeypatch.setattr(tcf.CF_Diff, "micro", 7)
    np.testing.assert_allclose(tm.score_users(tp, torch.arange(20)).numpy(),
                               whole.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("state", [True, False])
def test_params_round_trip(state):
    rs = np.random.default_rng(0)
    tree = ((rs.random((3, 2), np.float32), np.arange(4, dtype=np.int32)) if state
            else {"w": rs.random((2, 5), np.float32), "b": np.zeros(5, np.float32)})
    back = tparams.to_numpy(tparams.from_numpy(tree, "cpu"))
    flat = back if state else back.values()
    want = tree if state else tree.values()
    assert type(back) is type(tree)
    for a, b in zip(flat, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# --- training ---------------------------------------------------------------
# The loss and gradients go through the 64-wide CAM_AE and 10 diffusion
# steps' SNR weights in float32. The loss and the state are held to rtol
# 1e-4 / atol 1e-6. The SNR weights reach ~1e4, so the gradient's entries
# span 1e-8 to ~200, and rounding upstream reaches the small ones in
# absolute terms (a bias gradient sums ~2700 cancelling token terms; the
# key bias's is zero in exact arithmetic). So each gradient entry is held
# to rtol 1e-4 of its tensor's largest entry plus atol 1e-6 of the whole
# gradient's largest entry (reached: under 7e-5 and 6e-7). Params after
# 3 Adam steps on the same gradients are held to 1e-5.
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _assert_grads_close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    scale = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        err = np.abs(got[name] - w).max()
        bound = GRAD_TOL["rtol"] * np.abs(w).max() + GRAD_TOL["atol"] * scale
        assert err <= bound, f"{name}: max abs err {err:.3e} > {bound:.3e}"


def _jax_loss_and_draws(jm, users, state, weights, key):
    """JAX's loss (dropout off: _cam without an rng) and the (ts, pt, noise)
    its training_loss draws, from the same k_t, k_n split."""
    rows, sec = jm.x[users], jm.sec[users]

    def loss_fn(p):
        loss, new_state, _ = jdiff.training_loss(
            jm.sched, lambda x_t, ts: jm._cam(p, x_t, sec, ts), key, rows, state, weights)
        return loss, new_state

    k_t, k_n = jax.random.split(key)
    ts, pt = jdiff.sample_timesteps(k_t, state, len(users), jm.sched.steps)
    noise = jax.random.normal(k_n, rows.shape)
    return loss_fn, [torch.from_numpy(np.array(a)) for a in (ts, pt, noise)]


def _port_loss(tm, tp, users, state, weights, draws):
    ts, pt, noise = draws
    rows, sec = tm.x[users], tm.sec[users]
    loss, new_state, _ = tdiff.loss_from_draws(
        tm.sched, lambda x_t, t: tm._cam(tp, x_t, sec, t), rows, state, weights,
        ts.long(), pt, noise)
    return loss, new_state


def _ready_state(steps=10, seed=0):
    rs = np.random.default_rng(seed)
    return (rs.random((steps, tdiff.HISTORY_PER_TERM)).astype(np.float32),
            np.full((steps,), tdiff.HISTORY_PER_TERM, np.int32))


@pytest.mark.parametrize("ready", [False, True])
def test_training_loss_state_and_grads_match_jax(tiny_dataset, monkeypatch, ready):
    jm, jp, tm, tp = _pair(tiny_dataset, monkeypatch, 64)
    users = np.arange(3, 40, dtype=np.int32)
    weights = np.ones(len(users), np.float32)
    weights[-5:] = 0.0
    hist, count = _ready_state() if ready else map(np.asarray, jm.init_state(None))
    loss_fn, draws = _jax_loss_and_draws(jm, jnp.asarray(users), (jnp.asarray(hist),
                                         jnp.asarray(count)), jnp.asarray(weights),
                                         jax.random.PRNGKey(11))
    (jloss, (jh, jc)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    loss, (th, tc) = _port_loss(tm, leaves, torch.from_numpy(users).long(),
                                (torch.from_numpy(np.array(hist)), torch.from_numpy(np.array(count))),
                                torch.from_numpy(weights), draws)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **GRAD_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **GRAD_TOL)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    _assert_grads_close({k: t.grad.numpy() for k, t in leaves.items()},
                        {k: np.asarray(g) for k, g in jgrads.items()})


def test_three_adam_steps_match_optax(tiny_dataset, monkeypatch):
    """torch.optim.Adam, as the port's trainer makes it, against optax.adam at
    lr 1e-3 with torch's defaults: three steps on the JAX package's CF_Diff
    gradients, handed to both. (Each package's own gradients differ by
    rounding, and Adam turns rounding on a zero gradient, such as the key
    bias's, into a full step of either sign.)"""
    import optax

    from chaorec_tpu_torch.train.loop import ADAM_BETAS, ADAM_EPS

    jm, jp, _, tp = _pair(tiny_dataset, monkeypatch, 64)
    opt = optax.adam(1e-3, b1=ADAM_BETAS[0], b2=ADAM_BETAS[1], eps=ADAM_EPS)
    jopt, jstate = opt.init(jp), jm.init_state(None)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    topt = torch.optim.Adam(leaves.values(), lr=1e-3, betas=ADAM_BETAS, eps=ADAM_EPS)
    for step in range(3):
        users = jnp.arange(step * 16, step * 16 + 24, dtype=jnp.int32)
        loss_fn, _ = _jax_loss_and_draws(jm, users, jstate, jnp.ones(24),
                                         jax.random.PRNGKey(step))
        (_, jstate), grads = jax.value_and_grad(loss_fn, has_aux=True)(jp)
        updates, jopt = opt.update(grads, jopt, jp)
        jp = optax.apply_updates(jp, updates)
        for k, t in leaves.items():
            t.grad = torch.from_numpy(np.array(grads[k]))
        topt.step()
    for name, t in leaves.items():
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[name]), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_loss_stateful_with_dropout(tiny_dataset, monkeypatch):
    """Every dropout branch on: the same generator seed gives the same loss,
    state and gradients, another seed another loss; the loss is finite and
    the state took one entry per drawn step."""
    _, _, tm, tp = _pair(tiny_dataset, monkeypatch, 64)
    batch = Batch(torch.arange(20), torch.ones(20))

    def run(seed):
        leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
        loss, state = tm.loss_stateful(leaves, tm.init_state("cpu"), batch,
                                       torch.Generator().manual_seed(seed))
        loss.backward()
        return loss.item(), state, {k: v.grad for k, v in leaves.items()}

    (la, sa, ga), (lb, sb, gb), (lc, _, _) = run(0), run(0), run(1)
    assert np.isfinite(la) and la == lb and la != lc
    assert torch.equal(sa[0], sb[0]) and int(sa[1].sum()) >= 1
    assert all(torch.equal(ga[k], gb[k]) for k in ga)
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in ga.values())


def test_checkpointed_micro_batches_recompute_the_same_masks(tiny_dataset, monkeypatch):
    """With dropout on, the CPU path's checkpointed micro-batches give the
    gradients of the same micro-batches run without checkpointing: the
    recomputation draws the forward's masks."""
    _, _, tm, tp = _pair(tiny_dataset, monkeypatch, 64)
    monkeypatch.setattr(tcf.CF_Diff, "micro", 8)
    batch = Batch(torch.arange(20), torch.ones(20))

    def grads():
        leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
        loss, _ = tm.loss_stateful(leaves, tm.init_state("cpu"), batch,
                                   torch.Generator().manual_seed(5))
        loss.backward()
        return loss.item(), {k: v.grad for k, v in leaves.items()}

    loss_ckpt, with_ckpt = grads()
    monkeypatch.setattr(tcf, "checkpoint", lambda fn, *args, **kw: fn(*args))
    loss_plain, without = grads()
    assert loss_ckpt == loss_plain
    for k in with_ckpt:
        torch.testing.assert_close(with_ckpt[k], without[k], rtol=1e-6, atol=1e-9, msg=k)


def test_cpu_micro_batches_do_not_change_gradients(tiny_dataset, monkeypatch):
    """Dropout off: micro-batches of 7 give one batch's loss and gradients."""
    _, _, tm, tp = _pair(tiny_dataset, monkeypatch, 64)
    users = torch.arange(20)
    x, sec, ts = tm.x[users], tm.sec[users], torch.arange(20) % 10

    def grads():
        leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
        (tm._cam(leaves, x, sec, ts) ** 2).mean().backward()
        return {k: v.grad for k, v in leaves.items()}

    whole = grads()
    monkeypatch.setattr(tcf.CF_Diff, "micro", 7)
    for k, g in grads().items():
        torch.testing.assert_close(g, whole[k], rtol=1e-5, atol=1e-7, msg=k)


@pytest.mark.cuda
def test_cuda_training_step_matches_plain_path(tiny_dataset, monkeypatch):
    """One training step at width 64 on the card, every dropout on: through
    the kernels, and through mha_reference with the same seeds, so every
    mask is equal. Loss to rtol 1e-5, gradients as GRAD_TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/fused_mha*.cu have no CPU mode")
    from chaorec_tpu_torch.ops import fused_attn

    monkeypatch.setattr(tcf.CF_Diff, "dim_inters", 64)
    tm = tbuild(TConfig(**CFG), tiny_dataset, "cuda")
    params = tm.init_params(torch.Generator("cuda").manual_seed(0))
    batch = Batch(torch.arange(24, device="cuda"), torch.ones(24, device="cuda"))

    def step():
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss, _ = tm.loss_stateful(leaves, tm.init_state("cuda"), batch,
                                   torch.Generator("cuda").manual_seed(3))
        loss.backward()
        return loss.item(), {k: v.grad.cpu().numpy() for k, v in leaves.items()}

    bwd = fused_attn.fused_mha_bwd.launches
    kernel_loss, kernel_grads = step()
    assert fused_attn.fused_mha_bwd.launches == bwd + tm.cam_layers
    monkeypatch.setattr(tcf, "fused_mha", fused_attn.mha_reference)
    plain_loss, plain_grads = step()
    assert kernel_loss == pytest.approx(plain_loss, rel=1e-5)
    _assert_grads_close(kernel_grads, plain_grads)
