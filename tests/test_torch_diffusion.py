"""ops/diffusion.py against chaorec_tpu/ops/diffusion.py.

The schedule is computed in float64 numpy and cast to float32 in both
packages, so it must be bit-identical. The embedding and the reverse process
are float32 arithmetic in another order: 1e-6 and 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chaorec_tpu.ops import diffusion as jdiff
from chaorec_tpu_torch.ops import diffusion as tdiff

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
