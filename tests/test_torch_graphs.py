"""graphs/ (norm_adj, knn, dropout) against the JAX package's.

The same numpy edges and features go through both packages. Tolerances:
host-built arrays (degrees, weights, orders, the float32 R) are equal;
a bf16 R equals the JAX package's bf16 R (both round the same float32
values once); propagation in float32 agrees to 1e-5 relative (sums in
another order), in bf16 to 1e-4 relative (bf16 products are exact in
float32, only the order of the float32 sums differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chaorec_tpu import native as jnative
from chaorec_tpu.graphs import dropout as jdropout
from chaorec_tpu.graphs import knn as jknn
from chaorec_tpu.graphs import norm_adj as jnorm
from chaorec_tpu_torch.graphs import dropout as tdropout
from chaorec_tpu_torch.graphs import knn as tknn
from chaorec_tpu_torch.graphs import norm_adj as tnorm
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

PROP_TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "bfloat16": dict(rtol=1e-4, atol=1e-5)}


def _edges(seed=0, num_user=40, num_item=30, n=260):
    """Random edges with duplicates and a user and an item with no edge."""
    rs = np.random.default_rng(seed)
    e = np.stack([rs.integers(0, num_user - 1, n), rs.integers(0, num_item - 1, n)], 1)
    return e.astype(np.int32), num_user, num_item


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_build_adj_and_fill_dense_equal_jax():
    """Degrees, weights (d_u+eps)^-1/2 (d_i+eps)^-1/2, both stable orders
    and the dense fill are equal to the JAX package's host builders."""
    edges, nu, ni = _edges()
    want = jnative.build_adj(edges, nu, ni)
    got = tnorm.build_adj(edges, nu, ni)
    for name, g, w in zip(("du", "di", "w", "order_u", "order_i"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(tnorm.fill_dense(edges, got[2], nu, ni),
                                  jnative.fill_dense(edges, want[3], want[2], nu, ni))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_norm_adj_equals_jax(dtype):
    edges, nu, ni = _edges(1)
    jg = jnorm.build_norm_adj(edges, nu, ni, use_dense=True, compute_dtype=dtype)
    tg = tnorm.build_norm_adj(edges, nu, ni, "cpu", use_dense=True, compute_dtype=dtype)
    for name in ("u_by_u", "i_by_u", "w_by_u", "u_by_i", "i_by_i", "w_by_i"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)),
                                      err_msg=name)
    assert tg.dense_r.dtype == tnorm.COMPUTE_DTYPES[dtype]
    np.testing.assert_array_equal(tg.dense_r.float().numpy(), _f32(jg.dense_r))
    assert tg.num_edges == jg.num_edges


def test_dense_path_follows_the_threshold():
    edges, nu, ni = _edges(2)
    assert tnorm.build_norm_adj(edges, nu, ni, "cpu", dense_threshold=nu * ni).use_dense
    small = tnorm.build_norm_adj(edges, nu, ni, "cpu", dense_threshold=nu * ni - 1)
    assert not small.use_dense and small.dense_r is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dense", [True, False])
def test_propagation_matches_jax(dtype, dense):
    """propagate / apply_r / apply_rt on the dense and the segment path
    against the JAX package's graph on the same path: its dense R, or its
    sparse (ELL) graph, which at bf16 rounds the input as the segment path
    does."""
    edges, nu, ni = _edges(3)
    rs = np.random.default_rng(4)
    xu = rs.standard_normal((nu, 8)).astype(np.float32)
    xi = rs.standard_normal((ni, 8)).astype(np.float32)
    jg = jnorm.build_norm_adj(edges, nu, ni, use_dense=dense, compute_dtype=dtype)
    tg = tnorm.build_norm_adj(edges, nu, ni, "cpu", use_dense=dense, compute_dtype=dtype)
    ju, ji = jg.propagate(jnp.asarray(xu), jnp.asarray(xi))
    tu, ti = tg.propagate(torch.from_numpy(xu), torch.from_numpy(xi))
    # the segment path's products are of float32 weights and (bf16-rounded)
    # inputs, exact in float32 in both packages: only the order of the sums
    # differs
    tol = PROP_TOL[dtype if dense else "float32"]
    assert tu.dtype == ti.dtype == torch.float32
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **tol)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **tol)
    np.testing.assert_allclose(tg.apply_r(torch.from_numpy(xi)).numpy(), np.asarray(ju), **tol)
    np.testing.assert_allclose(tg.apply_rt(torch.from_numpy(xu)).numpy(), np.asarray(ji), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_graph_matches_jax_sparse_graph(dtype):
    """The segment path against the JAX package's sparse graph
    (``use_dense=False``: its ELL matrices) at the same dtype, on the values
    of propagate, apply_r and apply_rt and on their gradients with respect to
    both inputs. At bf16 the forward is float32 weights times bf16-rounded
    inputs; the gradients are float32 R^T g and R g, not rounded."""
    edges, nu, ni = _edges(3)
    rs = np.random.default_rng(4)
    xu, xi, gu, gi = (rs.standard_normal((n, 8)).astype(np.float32)
                      for n in (nu, ni, nu, ni))
    jg = jnorm.build_norm_adj(edges, nu, ni, use_dense=False, compute_dtype=dtype)
    tg = tnorm.build_norm_adj(edges, nu, ni, "cpu", use_dense=False, compute_dtype=dtype)
    assert jg.ell is not None and not tg.use_dense and tg.dense_r is None

    def jax_fn(a, b):
        u, i = jg.propagate(a, b)
        return u, i, jg.apply_r(b), jg.apply_rt(a)

    jouts, jvjp = jax.vjp(jax_fn, jnp.asarray(xu), jnp.asarray(xi))
    jgrads = jvjp((jnp.asarray(gu), jnp.asarray(gi), jnp.asarray(gu), jnp.asarray(gi)))
    txu, txi = (torch.from_numpy(a).requires_grad_() for a in (xu, xi))
    tu, ti = tg.propagate(txu, txi)
    touts = (tu, ti, tg.apply_r(txi), tg.apply_rt(txu))
    torch.autograd.backward(touts, [torch.from_numpy(a) for a in (gu, gi, gu, gi)])
    tol = PROP_TOL["float32"]
    for name, got, want in zip(("propagate_u", "propagate_i", "apply_r", "apply_rt"),
                               touts, jouts):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol, err_msg=name)
    for name, got, want in zip(("d user_emb", "d item_emb"), (txu.grad, txi.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_path_rounds_its_input_not_its_gradient(dtype):
    """apply_r is exactly index_add_ of float32 weights times the input,
    rounded to bf16 at bf16 and as it is at float32 (the bits the float32
    path always had); its gradient is exactly the float32 R^T g at both;
    the dense path is the bf16 or float32 product of the dense R."""
    edges, nu, ni = _edges(5)
    rs = np.random.default_rng(6)
    xi0 = rs.standard_normal((ni, 8)).astype(np.float32)
    g = torch.from_numpy(rs.standard_normal((nu, 8)).astype(np.float32))
    tg = tnorm.build_norm_adj(edges, nu, ni, "cpu", use_dense=False, compute_dtype=dtype)
    xi = torch.from_numpy(xi0).requires_grad_()
    out = tg.apply_r(xi)
    out.backward(g)
    x_in = torch.from_numpy(xi0)
    if dtype == "bfloat16":
        x_in = x_in.to(torch.bfloat16).float()
        assert not torch.equal(x_in, torch.from_numpy(xi0))
    want = torch.zeros(nu, 8).index_add_(0, tg.u_by_u, tg.w_by_u[:, None] * x_in[tg.i_by_u])
    assert torch.equal(out, want)
    xg = torch.from_numpy(xi0).requires_grad_()
    torch.zeros(nu, 8).index_add_(0, tg.u_by_u, tg.w_by_u[:, None] * xg[tg.i_by_u]).backward(g)
    assert torch.equal(xi.grad, xg.grad) and xi.grad.dtype == torch.float32
    dense = tnorm.build_norm_adj(edges, nu, ni, "cpu", use_dense=True, compute_dtype=dtype)
    r = dense.dense_r.float()
    x_d = torch.from_numpy(xi0).to(dense.dense_r.dtype).float()
    assert torch.equal(dense.apply_r(torch.from_numpy(xi0)), r @ x_d)


def _features(n=60, f=24, seed=5):
    """Rows with distinct similarities (no ties in any top-k)."""
    return np.random.default_rng(seed).standard_normal((n, f)).astype(np.float32)


@pytest.mark.parametrize("norm", ["ref_laplacian", "sym", "row_softmax_values"])
@pytest.mark.parametrize("row_chunk", [4096, 16])
def test_knn_graph_matches_jax(norm, row_chunk):
    """Indices equal and weights to 1e-6 under each norm, in one block and
    in row chunks."""
    feats = _features()
    jg = jknn.build_knn_graph(jnp.asarray(feats), 6, norm=norm, row_chunk=row_chunk)
    tg = tknn.build_knn_graph(torch.from_numpy(feats), 6, norm=norm, row_chunk=row_chunk)
    assert tg.k == jg.k == 6 and tg.weights.dtype == torch.float32
    np.testing.assert_array_equal(tg.indices.numpy(), np.asarray(jg.indices))
    np.testing.assert_allclose(tg.weights.numpy(), np.asarray(jg.weights), rtol=1e-6, atol=1e-7)
    if norm == "ref_laplacian":
        assert torch.all(tg.weights == np.float32(1.0 / 6))


def test_knn_propagate_and_its_gradient_match_jax():
    """ELLGraph.propagate and its gradient (autograd of the gather) against
    the JAX custom VJP."""
    feats = _features()
    x = np.random.default_rng(6).standard_normal((60, 8)).astype(np.float32)
    g = np.random.default_rng(7).standard_normal((60, 8)).astype(np.float32)
    jg = jknn.build_knn_graph(jnp.asarray(feats), 6, norm="sym")
    tg = tknn.build_knn_graph(torch.from_numpy(feats), 6, norm="sym")
    jout, jvjp = jax.vjp(jg.propagate, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    tout = tg.propagate(tx)
    tout.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jvjp(jnp.asarray(g))[0]),
                               rtol=1e-5, atol=1e-6)


def test_knn_refuses_an_unknown_norm():
    with pytest.raises(ValueError):
        tknn.build_knn_graph(torch.from_numpy(_features()), 3, norm="cosine")


def test_masked_dense_r_matches_jax():
    """R over the kept edges, with degrees counted again over them, on an
    injected keep mask: to 1e-6."""
    edges, nu, ni = _edges(8)
    keep = (np.random.default_rng(9).random(edges.shape[0]) < 0.7).astype(np.float32)
    jr, _, _ = jdropout.masked_dense_r(jnp.asarray(edges[:, 0]), jnp.asarray(edges[:, 1]),
                                       jnp.asarray(keep), nu, ni)
    e64 = torch.from_numpy(edges.astype(np.int64))
    tr = tdropout.masked_dense_r(e64[:, 0], e64[:, 1], torch.from_numpy(keep), nu, ni)
    assert tr.dtype == torch.float32 and tr.shape == (nu, ni)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6, atol=1e-7)
    # every kept edge has weight, and nothing else does
    assert set(zip(*np.nonzero(tr.numpy()))) == set(map(tuple, edges[keep == 1]))


# (users, items, edges as (user, item) pairs): a random list with a user
# and an item without an edge; a star of 3000 edges into one item (three
# levels of bags: 3000 edges, 94 chunks, 3 of those); each degree from 31
# to 33 and 1024 to 1025 on the item side (a level's edge cases)
def _bag_edges(case):
    rs = np.random.default_rng(5)
    if case == "random":
        return _edges(seed=2)
    if case == "star":
        u = rs.integers(0, 200, 3000)
        i = np.where(np.arange(3000) < 2990, 7, rs.integers(0, 12, 3000))
        return np.stack([u, i], 1).astype(np.int32), 200, 12
    degrees = [31, 32, 33, 1024, 1025, 0, 1]
    i = np.repeat(np.arange(len(degrees)), degrees)
    u = rs.integers(0, 90, i.shape[0])
    return np.stack([u, i], 1).astype(np.int32), 90, len(degrees)


@pytest.mark.parametrize("case", ["random", "star", "edges"])
def test_edge_bags_hop_matches_index_add(case):
    """The fixed-order bag sums of ``edge_propagate`` (and their backward,
    the same sums of the cotangents, and the weights' gradient) against a
    float64 index_add_ of the same hop: 1e-5 relative of each output's
    largest entry; the same bits twice."""
    edges, nu, ni = _bag_edges(case)
    rs = np.random.default_rng(0)
    eu, ei = torch.from_numpy(edges[:, 0]).long(), torch.from_numpy(edges[:, 1]).long()
    bags = tdropout.EdgeBags.build(eu, ei, nu, ni)
    w0 = rs.uniform(0.0, 1.0, edges.shape[0]).astype(np.float32)
    xu0 = rs.standard_normal((nu, 8)).astype(np.float32)
    xi0 = rs.standard_normal((ni, 8)).astype(np.float32)
    cu, ci = (torch.from_numpy(rs.standard_normal((n, 8))) for n in (nu, ni))

    def run(dtype, hop):
        w, xu, xi = (torch.from_numpy(a).to(dtype).requires_grad_() for a in (w0, xu0, xi0))
        out = hop(w, xu, xi)
        (torch.sum(out[0] * cu.to(dtype)) + torch.sum(out[1] * ci.to(dtype))).backward()
        return [t.detach() for t in out] + [w.grad, xu.grad, xi.grad]

    def plain(w, xu, xi):
        return (torch.zeros(nu, 8, dtype=xu.dtype).index_add(0, eu, w[:, None] * xi[ei]),
                torch.zeros(ni, 8, dtype=xu.dtype).index_add(0, ei, w[:, None] * xu[eu]))

    def kernel(w, xu, xi):
        return tdropout.edge_propagate(eu, ei, w, xu, xi, nu, ni, bags)

    got, again, want = run(torch.float32, kernel), run(torch.float32, kernel), run(
        torch.float64, plain)
    for g, a, r in zip(got, again, want):
        assert torch.equal(g, a)
        assert (g.double() - r).abs().max().item() <= 1e-5 * r.abs().max().item()
    if case == "star":
        assert len(bags.items.levels) == 3 and len(bags.users.levels) == 1
    empty = {"random": ni - 1, "edges": 5}.get(case)  # an item without an edge sums to 0
    if empty is not None:
        assert not got[1][empty].any()
