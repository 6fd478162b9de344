"""ops/ell.py's seg_edge_weighted_sum against the JAX package's.

The same (He, k) incidence, edge rows, slot weights and cotangent (numpy,
from a seed) go to both packages. The JAX function takes the incidence's
slots column by column (``h.T.reshape(-1)``, a TPU lane layout), the port
row by row (``h.reshape(-1)``); the test maps the weights between the two
orders. The incidence leaves nodes 0, 17 and 39 without a slot and puts
some slots on the sentinel node 40 (the padding of ragged hyperedges),
whose segment is the last one.

Tolerances. The sums are differences of one global fp32 prefix in another
order inside each segment: each package's result is held to the float64
sum under the prefix error model of ``chaorec_tpu/ops/ell.py:370-381``
(``test_torch_prefix_scan.scan_atol``, as tests/test_torch_seg.py holds
``seg_sum``), and the port's drift from it to 4 times the JAX package's own.
Empty segments are exactly 0. The edge gradient sums k products in the same
order in both packages (rtol 1e-6; one bf16 ulp for bf16 rows), the weight
gradient is a D-long dot (rtol 1e-5, atol 1e-6 of the largest entry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chaorec_tpu.ops import ell as jell
from chaorec_tpu_torch.ops import ell as tell
from chaorec_tpu_torch.ops import prefix_scan as tscan
from test_torch_prefix_scan import scan_atol

N_NODES = 40  # nodes 0..39; node 40 is the sentinel
EMPTY = [0, 17, 39]
HE, D = 300, 16


def _incidence(k, seed=0):
    """(HE, k) node slots over nodes outside EMPTY, 5% of them the sentinel."""
    rs = np.random.default_rng(seed + k)
    pool = np.setdiff1d(np.arange(N_NODES), EMPTY)
    h = rs.choice(pool, (HE, k))
    h[rs.random((HE, k)) < 0.05] = N_NODES
    return h.astype(np.int32)


def _case(k, dtype):
    rs = np.random.default_rng(100 + k)
    h = _incidence(k)
    edge = rs.standard_normal((HE, D)).astype(np.float32)
    if dtype == "bfloat16":  # the rows as bf16 values, in both packages
        edge = torch.from_numpy(edge).bfloat16().float().numpy()
    alpha = rs.uniform(0.1, 3.0, (HE, k)).astype(np.float32)  # exps: positive weights
    cot = rs.standard_normal((N_NODES + 1, D)).astype(np.float32)
    return h, edge, alpha, cot


def _jax(h, edge, alpha, cot, dtype):
    flat = jnp.asarray(h.T.reshape(-1))
    perm, ptr = jell.build_segment_transpose(flat, N_NODES + 1)
    edge_perm = (perm % HE).astype(jnp.int32)
    e = jnp.asarray(edge).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)

    def f(e, a):
        return jell.seg_edge_weighted_sum(e, a, flat, perm, edge_perm, ptr)

    out = f(e, jnp.asarray(alpha.T.reshape(-1)))
    d_e, d_a = jax.grad(lambda e, a: jnp.sum(jnp.asarray(cot) * f(e, a)), argnums=(0, 1))(
        e, jnp.asarray(alpha.T.reshape(-1)))
    k = h.shape[1]
    return (np.asarray(out), np.asarray(d_e.astype(jnp.float32)),
            np.asarray(d_a).reshape(k, HE).T)


def _port(h, edge, alpha, cot, dtype):
    flat = torch.from_numpy(h.reshape(-1)).long()
    perm, ptr = tell.build_segment_transpose(flat, N_NODES + 1)
    e = torch.from_numpy(edge).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    e.requires_grad_()
    a = torch.from_numpy(alpha.reshape(-1)).requires_grad_()
    out = tell.seg_edge_weighted_sum(e, a, flat, perm, perm // h.shape[1], ptr)
    (torch.from_numpy(cot) * out).sum().backward()
    assert out.dtype == torch.float32 and e.grad.dtype == e.dtype and a.grad.dtype == a.dtype
    return (out.detach().numpy(), e.grad.float().numpy(),
            a.grad.numpy().reshape(h.shape))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [2, 3])
def test_seg_edge_weighted_sum_matches_jax(k, dtype):
    h, edge, alpha, cot = _case(k, dtype)
    j_out, j_de, j_da = _jax(h, edge, alpha, cot, dtype)
    t_out, t_de, t_da = _port(h, edge, alpha, cot, dtype)
    # the float64 sums, and the prefix they are differences of (the port's order)
    msgs = alpha[:, :, None].astype(np.float64) * edge[:, None, :].astype(np.float64)
    exact = np.zeros((N_NODES + 1, D))
    np.add.at(exact, h.reshape(-1), msgs.reshape(-1, D))
    order = np.argsort(h.reshape(-1), kind="stable")
    bound = scan_atol(np.cumsum(msgs.reshape(-1, D)[order], axis=0), HE * k)
    j_drift, t_drift = np.abs(j_out - exact).max(), np.abs(t_out - exact).max()
    assert j_drift <= bound and t_drift <= bound, (j_drift, t_drift, bound)
    assert 0 < j_drift and t_drift <= 4 * j_drift, (t_drift, j_drift)
    assert not t_out[EMPTY].any() and np.abs(exact[N_NODES]).max() > 0
    ulps = 2.0 ** -7 if dtype == "bfloat16" else 0.0  # the bf16 edge gradient's rounding
    np.testing.assert_allclose(t_de, j_de, rtol=1e-6 + ulps, atol=1e-7)
    np.testing.assert_allclose(t_da, j_da, rtol=1e-5, atol=1e-6 * np.abs(j_da).max())


def test_needs_whole_hyperedges_and_launches_nothing_on_the_cpu():
    h, edge, alpha, _ = _case(2, "float32")
    flat = torch.from_numpy(h.reshape(-1)).long()
    perm, ptr = tell.build_segment_transpose(flat, N_NODES + 1)
    before = tscan.prefix_cumsum.launches
    out = tell.seg_edge_weighted_sum(torch.from_numpy(edge), torch.from_numpy(alpha.reshape(-1)),
                                     flat, perm, perm // 2, ptr)
    assert tscan.prefix_cumsum.launches == before and out.shape == (N_NODES + 1, D)
    with pytest.raises(ValueError):
        tell.seg_edge_weighted_sum(torch.from_numpy(edge[:-1]),
                                   torch.from_numpy(alpha.reshape(-1)), flat, perm, perm // 2, ptr)
