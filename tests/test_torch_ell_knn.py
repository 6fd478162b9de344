"""The port's counterparts of ``chaorec_tpu/ops/ell.py``'s kNN primitives and
fixed-topology operators against the JAX functions.

- ``graphs/knn.knn_topk`` against ``knn_topk_ell_host`` (indices equal,
  values to 1e-6; rows of tiny norm take the max(norm, 1e-12) clamp);
- ``graphs/knn.topk_sym_norm`` against ``topk_sym_norm_host`` (to 1e-6);
- ``graphs/knn.union_max`` against ``ell_union_max``: the same matrix,
  compared densified, with entries in one graph only that are negative;
- ``ops/ell.EdgeMatrix`` against ``EllMatrix.matvec`` and ``.t.matvec``,
  values and gradients;
- ``ops/ell.EdgePattern``'s weighted matvec, row sum and pair inner product
  against ``EllPattern.weighted_matvec`` / ``ellp_matvec_grouped``,
  ``weighted_rowsum`` and ``ellp_pair_inner_grouped``, values and the
  gradients of every input.

Sums taken in another order: 1e-5 relative, 1e-6 absolute, as
tests/test_torch_graphs.py holds float32 propagation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chaorec_tpu.ops import ell as jell
from chaorec_tpu_torch.graphs import knn as tknn
from chaorec_tpu_torch.ops import ell as tell
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

TOL = dict(rtol=1e-5, atol=1e-6)


def _features(n=40, f=12, seed=5):
    """Rows with distinct similarities (no ties in any top-k)."""
    return np.random.default_rng(seed).standard_normal((n, f)).astype(np.float32)


def _dense(vals, idx, n):
    d = np.zeros((n, n), np.float64)
    np.add.at(d, (np.repeat(np.arange(n), idx.shape[1]), np.asarray(idx).ravel()),
              np.asarray(vals, np.float64).ravel())
    return d


@pytest.mark.parametrize("tiny_row", [False, True], ids=["plain", "tiny_norm_row"])
def test_knn_topk_and_sym_norm_match_jax(tiny_row):
    """A row scaled to norm ~3e-13 is normalized to norm ~0.3 by the clamp
    (norm + 1e-12 would give ~0.23): its similarities, and so the graph,
    follow the JAX function's."""
    feats = _features()
    if tiny_row:
        feats[3] *= 1e-13 / np.linalg.norm(feats[3]) * 3
    jv, ji = jell.knn_topk_ell_host(feats, 7)
    tv, ti = tknn.knn_topk(torch.from_numpy(feats), 7, row_chunk=16)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-6, atol=1e-7)
    if tiny_row:  # norm + 1e-12 would scale row 3's similarities by another factor
        f = feats / (np.linalg.norm(feats, axis=1, keepdims=True) + 1e-12)
        other = np.sort(f[3] @ f.T)[::-1][:7]
        assert np.abs(tv[3].numpy() - other).max() > 1e-2
    jw, jidx = jell.topk_sym_norm_host(jv, ji)
    g = tknn.topk_sym_norm(tv, ti)
    assert g.weights.dtype == torch.float32
    np.testing.assert_array_equal(g.indices.numpy(), jidx)
    np.testing.assert_allclose(g.weights.numpy(), jw, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("k", [5, 30], ids=["k5", "k30_negative_one_sided"])
def test_union_max_matches_jax(k):
    """The fusion graph: the same matrix as the JAX package's; at k 30 of 40
    rows the top-k holds negative similarities, and some of them are in one
    graph only, where max(v, 0) drops them."""
    n = 40
    fa, fb = _features(n, 12, 5), _features(n, 9, 6)
    ga = tknn.topk_sym_norm(*tknn.knn_topk(torch.from_numpy(fa), k))
    gb = tknn.topk_sym_norm(*tknn.knn_topk(torch.from_numpy(fb), k))
    got = tknn.union_max(ga, gb)
    jv, ji = jell.ell_union_max(ga.weights.numpy(), ga.indices.numpy(), gb.weights.numpy(),
                                gb.indices.numpy())
    da, db = (_dense(g.weights.numpy(), g.indices.numpy(), n) for g in (ga, gb))
    want = _dense(jv, ji, n)
    np.testing.assert_array_equal(_dense(got.weights.numpy(), got.indices.numpy(), n), want)
    one_sided = (da != 0) != (db != 0)
    negative = one_sided & (np.minimum(da, db) < 0)
    if k == 30:
        assert negative.sum() > 0 and not want[negative].any()
    assert got.weights.dtype == torch.float32
    x = np.random.default_rng(7).standard_normal((n, 4)).astype(np.float32)
    np.testing.assert_allclose(got.propagate(torch.from_numpy(x)).numpy(),
                               np.asarray(jell.ell_rows_matvec(jnp.asarray(jv), jnp.asarray(ji),
                                                               jnp.asarray(x))), **TOL)


def _coo(seed=0, rows=30, cols=20, n=150):
    """A random COO list with repeated pairs and a row and a column without
    an entry."""
    rs = np.random.default_rng(seed)
    r = rs.integers(0, rows - 1, n)
    c = rs.integers(0, cols - 1, n)
    return r, c, rs.uniform(0.1, 1.0, n).astype(np.float32), rows, cols


def test_edge_matrix_matches_ell_matrix():
    """A @ x and A^T @ x, and the gradient of x of each (the other
    orientation), against EllMatrix with a small cap (so that rows spill
    into its overflow)."""
    r, c, w, nr, nc = _coo()
    jm = jell.EllMatrix.from_coo(r, c, w, nr, nc, cap=8, cap_t=8)
    tm = tell.EdgeMatrix.from_coo(r, c, w, nr, nc, "cpu")
    rs = np.random.default_rng(1)
    x, g = rs.standard_normal((nc, 5)).astype(np.float32), rs.standard_normal((nr, 5))
    for jmat, tmat, xin, gin in ((jm, tm, x, g.astype(np.float32)),
                                 (jm.t, tm.t, g.astype(np.float32), x)):
        jout, jvjp = jax.vjp(jmat.matvec, jnp.asarray(xin))
        tx = torch.from_numpy(xin).requires_grad_()
        tout = tmat.matvec(tx)
        tout.backward(torch.from_numpy(gin))
        assert tout.dtype == torch.float32 and tout.shape == jout.shape
        np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jvjp(jnp.asarray(gin))[0]),
                                   **TOL)
    assert not tm.w.requires_grad


def _pattern(seed=2, n=25, e=160):
    rs = np.random.default_rng(seed)
    return rs.integers(0, n - 1, e), rs.integers(0, n - 1, e), n


def test_edge_pattern_matvec_and_rowsum_match_ell_pattern():
    """weighted_matvec and weighted_rowsum with their gradients in the
    weights and in x against EllPattern's, and two groups side by side
    against ellp_matvec_grouped (GRCN's packed towers)."""
    rows, cols, n = _pattern()
    jp = jell.EllPattern.from_coo(rows, cols, n, n)
    tp = tell.EdgePattern.from_coo(rows, cols, n, n, "cpu")
    rs = np.random.default_rng(3)
    w = rs.uniform(0.0, 1.0, rows.shape[0]).astype(np.float32)
    x, g, gs = (rs.standard_normal(s).astype(np.float32) for s in ((n, 6), (n, 6), (n,)))

    def jfn(w_, x_):
        return jp.weighted_matvec(w_, x_), jp.weighted_rowsum(w_)

    (jout, jsum), jvjp = jax.vjp(jfn, jnp.asarray(w), jnp.asarray(x))
    jgw, jgx = jvjp((jnp.asarray(g), jnp.asarray(gs)))
    tw, tx = torch.from_numpy(w).requires_grad_(), torch.from_numpy(x).requires_grad_()
    tout, tsum = tp.weighted_matvec(tw, tx), tp.weighted_rowsum(tw)
    torch.autograd.backward((tout, tsum), (torch.from_numpy(g), torch.from_numpy(gs)))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tsum.detach().numpy(), np.asarray(jsum), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)

    # two towers' weights and tables, lane-packed on the JAX side
    w2 = rs.uniform(0.0, 1.0, (rows.shape[0], 2)).astype(np.float32)
    x2 = rs.standard_normal((n, 12)).astype(np.float32)
    g2 = rs.standard_normal((n, 12)).astype(np.float32)
    jout2, jvjp2 = jax.vjp(lambda a, b: jell.ellp_matvec_grouped(jp, a, b), jnp.asarray(w2),
                           jnp.asarray(x2))
    jgw2, jgx2 = jvjp2(jnp.asarray(g2))
    tw2, tx2 = torch.from_numpy(w2).requires_grad_(), torch.from_numpy(x2).requires_grad_()
    tout2 = torch.cat([tp.weighted_matvec(tw2[:, m], tx2[:, 6 * m:6 * (m + 1)])
                       for m in range(2)], 1)
    tout2.backward(torch.from_numpy(g2))
    np.testing.assert_allclose(tout2.detach().numpy(), np.asarray(jout2), **TOL)
    np.testing.assert_allclose(tw2.grad.numpy(), np.asarray(jgw2), **TOL)
    np.testing.assert_allclose(tx2.grad.numpy(), np.asarray(jgx2), **TOL)


def test_edge_pattern_pair_inner_and_gathers_match_jax():
    """pair_inner per tower against ellp_pair_inner_grouped on the packed
    table, with the gradient of x; row_gather and col_gather are v[rows] and
    v[cols] with the scatter-add's gradient."""
    rows, cols, n = _pattern(4)
    jp = jell.EllPattern.from_coo(rows, cols, n, n)
    tp = tell.EdgePattern.from_coo(rows, cols, n, n, "cpu")
    rs = np.random.default_rng(5)
    x = rs.standard_normal((n, 8)).astype(np.float32)
    g = rs.standard_normal((rows.shape[0], 2)).astype(np.float32)
    jout, jvjp = jax.vjp(lambda a: jell.ellp_pair_inner_grouped(jp, a, 2), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    tout = torch.stack([tp.pair_inner(tx[:, 4 * m:4 * (m + 1)]) for m in range(2)], 1)
    tout.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jvjp(jnp.asarray(g))[0]), **TOL)

    v = torch.from_numpy(rs.standard_normal((n, 2)).astype(np.float32))
    gv = torch.from_numpy(rs.standard_normal((rows.shape[0], 2)).astype(np.float32))
    for gather, idx in ((tp.row_gather, rows), (tp.col_gather, cols)):
        a, b = v.clone().requires_grad_(), v.clone().requires_grad_()
        gather(a).backward(gv)
        b[torch.from_numpy(idx)].backward(gv)
        assert torch.equal(gather(v), v[torch.from_numpy(idx)])
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), **TOL)
