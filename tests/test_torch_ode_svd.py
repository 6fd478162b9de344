"""ops/ode.py and ops/svd.py against the JAX package's.

The Euler integrator on a random linear field, within 1e-6 of the JAX
``lax.scan``'s (relative, and of its largest entry); the randomized SVD on an exactly rank-q matrix, where its
factors are exact up to their signs: the singular values within 1e-4
(relative) of ``numpy.linalg.svd``'s, and the right subspace's projector
``V V^T`` within 1e-4 of the JAX function's (the two sketches are drawn by
different generators, so the factors are compared through what they span).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chaorec_tpu.ops import ode as jode
from chaorec_tpu.ops import svd as jsvd
from chaorec_tpu_torch.ops import ode as tode
from chaorec_tpu_torch.ops import svd as tsvd
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("steps,t1", [(1, 1.0), (3, 1.5), (7, 2.5)])
def test_euler_matches_jax_on_a_linear_field(steps, t1):
    rs = np.random.default_rng(steps)
    a = (rs.standard_normal((12, 12)) / 12).astype(np.float32)
    y0 = rs.standard_normal((5, 12)).astype(np.float32)
    ja, ta = jnp.asarray(a), torch.from_numpy(a)
    # a field that reads t too, so the carried time is held as well
    want = jode.odeint_euler(lambda t, y: -(y @ ja) + t * y, jnp.asarray(y0), 0.0, t1, steps)
    got = tode.odeint_euler(lambda t, y: -(y @ ta) + t * y, torch.from_numpy(y0), 0.0, t1,
                            steps)
    assert got.dtype == torch.float32
    # the two BLAS sum each product in another order: 1e-6 of the largest entry
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_euler_carries_time_in_the_state_dtype():
    seen = []
    y0 = torch.ones(3, dtype=torch.float64)
    tode.odeint_euler(lambda t, y: seen.append(t) or y, y0, 0.0, 1.0, 4)
    assert [t.dtype for t in seen] == [torch.float64] * 4
    assert [float(t) for t in seen] == [0.0, 0.25, 0.5, 0.75]


@pytest.mark.parametrize("m,n,q", [(60, 40, 5), (200, 90, 12), (48, 64, 47)])
def test_randomized_svd_of_an_exactly_rank_q_matrix(m, n, q):
    rs = np.random.default_rng(m)
    a = (rs.standard_normal((m, q)) @ rs.standard_normal((q, n))).astype(np.float32)
    u, s, v = tsvd.randomized_svd(torch.Generator().manual_seed(0), torch.from_numpy(a), q)
    assert u.shape == (m, q) and s.shape == (q,) and v.shape == (n, q)
    assert u.dtype == s.dtype == v.dtype == torch.float32
    want_s = np.linalg.svd(a.astype(np.float64), compute_uv=False)[:q]
    np.testing.assert_allclose(s.numpy(), want_s, rtol=1e-4)
    _, _, jv = jsvd.randomized_svd(jax.random.PRNGKey(0), jnp.asarray(a), q)
    jv = np.asarray(jv)
    np.testing.assert_allclose((v @ v.T).numpy(), jv @ jv.T, atol=1e-4)
    # and the factors rebuild the matrix
    np.testing.assert_allclose((u * s @ v.T).numpy(), a, atol=1e-4 * np.abs(a).max())


def test_randomized_svd_takes_a_bf16_matrix_in_float32():
    rs = np.random.default_rng(3)
    a = torch.from_numpy(rs.random((30, 20)).astype(np.float32)).to(torch.bfloat16)
    u, s, v = tsvd.randomized_svd(torch.Generator().manual_seed(1), a, 4)
    want = np.linalg.svd(a.float().numpy().astype(np.float64), compute_uv=False)[:4]
    assert u.dtype == torch.float32
    np.testing.assert_allclose(s.numpy(), want, rtol=1e-4)
