"""ops/diffusion.py against chaorec_tpu/ops/diffusion.py.

The schedule is computed in float64 numpy and cast to float32 in both
packages, so it must be bit-identical. The embedding and the reverse process
are float32 arithmetic in another order: 1e-6 and 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chaorec_tpu.ops import diffusion as jdiff
from chaorec_tpu_torch.ops import diffusion as tdiff
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

SCHEDULES = [  # (noise_scale, noise_min, noise_max, steps)
    (0.1, 5e-4, 5e-3, 10),  # Model_YAML/CF_Diff.yaml
    (0.001, 0.005, 0.005, 5),
]
FIELDS = ["betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
          "sqrt_one_minus_alphas_cumprod", "posterior_mean_coef1",
          "posterior_mean_coef2", "posterior_log_variance_clipped"]


@pytest.mark.parametrize("args", SCHEDULES)
def test_schedule_is_identical(args):
    js, ts = jdiff.make_schedule(*args), tdiff.make_schedule(*args)
    assert ts.steps == js.steps and ts.noise_scale == js.noise_scale
    for f in FIELDS:
        got, want = getattr(ts, f), np.asarray(getattr(js, f))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)


@pytest.mark.parametrize("dim", [10, 7])
def test_timestep_embedding(dim):
    t = np.array([0, 1, 4, 9, 37], np.int32)
    got = tdiff.timestep_embedding(torch.from_numpy(t).long(), dim).numpy()
    want = np.asarray(jdiff.timestep_embedding(jnp.asarray(t), dim))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_q_sample():
    rs = np.random.default_rng(0)
    x, noise = rs.random((6, 9), np.float32), rs.standard_normal((6, 9)).astype(np.float32)
    t = np.array([0, 1, 2, 3, 4, 9], np.int32)
    js, ts = jdiff.make_schedule(*SCHEDULES[0]), tdiff.make_schedule(*SCHEDULES[0])
    got = tdiff.q_sample(ts, torch.from_numpy(x), torch.from_numpy(t).long(),
                         torch.from_numpy(noise)).numpy()
    want = np.asarray(jdiff.q_sample(js, jnp.asarray(x), jnp.asarray(t), jnp.asarray(noise)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("sampling_steps", [0, 3])
def test_p_sample_with_linear_denoiser(sampling_steps):
    """A fixed linear denoiser x0_hat = x_t W + 0.01 t: every step of the
    reverse chain, and its t order, must agree."""
    rs = np.random.default_rng(1)
    x = (rs.random((8, 12)) < 0.3).astype(np.float32)
    w = (0.3 * rs.standard_normal((12, 12))).astype(np.float32)
    js, ts = jdiff.make_schedule(*SCHEDULES[0]), tdiff.make_schedule(*SCHEDULES[0])
    wj, wt = jnp.asarray(w), torch.from_numpy(w)
    got = tdiff.p_sample(ts, lambda xt, t: xt @ wt + 0.01 * t[:, None],
                         torch.from_numpy(x), sampling_steps=sampling_steps).numpy()
    want = np.asarray(jdiff.p_sample(js, lambda xt, t: xt @ wj + 0.01 * t[:, None],
                                     jnp.asarray(x), sampling_steps=sampling_steps))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_init_lt_state():
    jh, jc = jdiff.init_lt_state(10)
    th, tc = tdiff.init_lt_state(10)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert th.dtype == torch.float32 and tc.dtype == torch.int32


# --- the training half ------------------------------------------------------
# Float32 arithmetic in another order on the same inputs: 1e-6.


def _history(ready: bool, steps: int = 10, seed: int = 2):
    rs = np.random.default_rng(seed)
    hist = rs.random((steps, tdiff.HISTORY_PER_TERM)).astype(np.float32)
    count = np.full((steps,), tdiff.HISTORY_PER_TERM, np.int32)
    if not ready:
        count[3] = 4
        hist[3, 4:] = 0.0
    return hist, count


@pytest.mark.parametrize("ready", [True, False])
def test_timestep_probabilities(ready):
    """The probability vector JAX's sample_timesteps draws from: with a full
    history pt = probs[ts] * steps, so a large batch reveals every entry."""
    hist, count = _history(ready)
    jts, jpt = jdiff.sample_timesteps(jax.random.PRNGKey(0), (jnp.asarray(hist), jnp.asarray(count)),
                                      4000, 10)
    jts, jpt = np.asarray(jts), np.asarray(jpt)
    probs, is_ready = tdiff.timestep_probs((torch.from_numpy(hist), torch.from_numpy(count)), 10)
    assert bool(is_ready) == ready
    assert set(jts.tolist()) == set(range(10))
    if ready:
        want = np.zeros(10, np.float32)
        want[jts] = jpt / 10
        np.testing.assert_allclose(probs.numpy(), want, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(jpt, 1.0)
        np.testing.assert_array_equal(probs.numpy(), np.full(10, 0.1, np.float32))
    ts, pt = tdiff.sample_timesteps((torch.from_numpy(hist), torch.from_numpy(count)), 4000, 10,
                                    torch.Generator().manual_seed(0))
    assert ts.dtype == torch.int64 and ts.shape == (4000,)
    np.testing.assert_allclose(pt.numpy(), probs.numpy()[ts.numpy()] * 10 if ready else 1.0,
                               rtol=1e-6)
    # the draws follow probs: every step's count within 5 sigma
    counts = np.bincount(ts.numpy(), minlength=10)
    p = probs.numpy().astype(np.float64)
    assert np.all(np.abs(counts - 4000 * p) <= 5 * np.sqrt(4000 * p * (1 - p)) + 1)


@pytest.mark.parametrize("ready", [True, False])
def test_update_lt_history(ready):
    hist, count = _history(ready, seed=3)
    rs = np.random.default_rng(4)
    ts = np.array([0, 3, 3, 5, 9, 9, 9, 1], np.int32)
    reloss = rs.random(8).astype(np.float32)
    weights = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32)
    jh, jc = jdiff.update_lt_history((jnp.asarray(hist), jnp.asarray(count)), jnp.asarray(ts),
                                     jnp.asarray(reloss), jnp.asarray(weights))
    th, tc = tdiff.update_lt_history((torch.from_numpy(hist), torch.from_numpy(count)),
                                     torch.from_numpy(ts).long(), torch.from_numpy(reloss),
                                     torch.from_numpy(weights))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tc.dtype == torch.int32


@pytest.mark.parametrize("ready", [True, False])
def test_training_loss_with_injected_draws(ready):
    """A fixed linear denoiser; JAX's training_loss draws (ts, pt, noise)
    from the split its code makes, and the port is handed those draws."""
    rs = np.random.default_rng(5)
    x = (rs.random((12, 9)) < 0.3).astype(np.float32)
    w = (0.3 * rs.standard_normal((9, 9))).astype(np.float32)
    weights = np.ones(12, np.float32)
    weights[-3:] = 0.0
    hist, count = _history(ready, seed=6)
    js, ts_ = jdiff.make_schedule(*SCHEDULES[0]), tdiff.make_schedule(*SCHEDULES[0])
    state = (jnp.asarray(hist), jnp.asarray(count))
    rng = jax.random.PRNGKey(7)
    jloss, (jh, jc), _ = jdiff.training_loss(js, lambda xt, t: xt @ jnp.asarray(w), rng,
                                             jnp.asarray(x), state, jnp.asarray(weights))
    k_t, k_n = jax.random.split(rng)
    draws_ts, draws_pt = jdiff.sample_timesteps(k_t, state, 12, 10)
    noise = jax.random.normal(k_n, x.shape)
    wt = torch.from_numpy(w)
    loss, (th, tc), (x_t, _, _) = tdiff.loss_from_draws(
        ts_, lambda xt, t: xt @ wt, torch.from_numpy(x),
        (torch.from_numpy(hist), torch.from_numpy(count)), torch.from_numpy(weights),
        torch.from_numpy(np.array(draws_ts)).long(), torch.from_numpy(np.array(draws_pt)),
        torch.from_numpy(np.array(noise)))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    want_xt = np.asarray(jdiff.q_sample(js, jnp.asarray(x), draws_ts, noise))
    np.testing.assert_allclose(x_t.numpy(), want_xt, rtol=0, atol=1e-6)


def test_training_loss_draws_from_its_generator():
    x = torch.from_numpy((np.random.default_rng(8).random((6, 5)) < 0.4).astype(np.float32))
    sched = tdiff.make_schedule(*SCHEDULES[0])
    state = tdiff.init_lt_state(10)

    def run(seed):
        return tdiff.training_loss(sched, lambda xt, t: 0.5 * xt, x, state, torch.ones(6),
                                   torch.Generator().manual_seed(seed))[0]

    assert run(1).item() == run(1).item() != run(2).item()
