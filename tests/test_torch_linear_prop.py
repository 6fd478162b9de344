"""ops/linear_prop.py against chaorec_tpu/ops/linear_prop.py.

Both packages build the operator from the dense R of ``tiny_dataset`` (64
users x 48 items) for LightGCN's layer weights (the uniform mean over
layers 0..n) and SimGCL's (the mean over layers 1..n), n = 1, 2, 3.

Tolerances: float32 blocks to rtol 1e-5, atol 1e-6 (float32 sums in
another order); bf16 blocks within one bf16 ulp of the JAX block (the
float32 sums round to either neighbour at a near-tie). The row gathers and
``full`` to rtol 1e-5, atol 1e-6 given the same blocks, and their
gradients through bf16 blocks within one bf16 ulp of the JAX gradient
(both round the float32 cotangent product to bf16); ``full`` against the
port's own layer stack to rtol 1e-5, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chaorec_tpu.graphs.norm_adj import build_norm_adj as jbuild_norm_adj
from chaorec_tpu.ops import linear_prop as jlp
from chaorec_tpu_torch import params as tparams
from chaorec_tpu_torch.graphs.norm_adj import build_norm_adj
from chaorec_tpu_torch.models.lightgcn import LightGCN
from chaorec_tpu_torch.models.simgcl import SimGCL
from chaorec_tpu_torch.ops import linear_prop as tlp
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

TOL = dict(rtol=1e-5, atol=1e-6)
BLOCKS = ("m_uu", "m_ui", "m_iu", "m_ii")


def weights(kind, n):
    if kind == "lightgcn":
        return [1.0 / (n + 1)] * (n + 1)
    return [0.0] + [1.0 / n] * n


def graphs(ds):
    jg = jbuild_norm_adj(ds.train_edges, ds.num_user, ds.num_item, use_dense=True)
    tg = build_norm_adj(ds.train_edges, ds.num_user, ds.num_item, "cpu", use_dense=True)
    np.testing.assert_array_equal(tg.dense_r.numpy(), np.asarray(jg.dense_r))
    return jg, tg


def bf16_ulp(x):
    mag = np.maximum(np.abs(x), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def assert_within_bf16_ulp(got, want, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    worst = float(np.max(np.abs(got - want) / bound))
    assert worst <= 1.0, f"{name}: {worst} bf16 ulps"


def to_np(t):
    return t.float().numpy()


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("kind", ["lightgcn", "simgcl"])
def test_float32_blocks_match_jax(tiny_dataset, kind, n):
    jg, tg = graphs(tiny_dataset)
    jop = jlp.build_weighted_op(jg.dense_r, tuple(weights(kind, n)), store_bf16=False)
    top = tlp.build_weighted_op(tg.dense_r, weights(kind, n), store_bf16=False)
    for name in BLOCKS:
        got = getattr(top, name)
        assert got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jop, name)), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["lightgcn", "simgcl"])
def test_bf16_blocks_within_one_ulp_of_jax(tiny_dataset, kind):
    jg, tg = graphs(tiny_dataset)
    jop = jlp.build_weighted_op(jg.dense_r, tuple(weights(kind, 3)), store_bf16=True)
    top = tlp.build_weighted_op(tg.dense_r, weights(kind, 3), store_bf16=True)
    for name in BLOCKS:
        got = getattr(top, name)
        assert got.dtype == torch.bfloat16
        assert_within_bf16_ulp(to_np(got), np.asarray(getattr(jop, name), np.float32), name)


def test_build_combined_op_is_lightgcns_weighting(tiny_dataset):
    _, tg = graphs(tiny_dataset)
    a = tlp.build_combined_op(tg.dense_r, 2, store_bf16=False)
    b = tlp.build_weighted_op(tg.dense_r, [1 / 3] * 3, store_bf16=False)
    for name in BLOCKS:
        assert torch.equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("store_bf16", [False, True], ids=["float32", "bf16"])
def test_rows_and_full_match_jax(tiny_dataset, store_bf16):
    """Given the JAX package's blocks, user_rows, item_rows (with repeated
    rows) and full, and the tables' gradients through the row gathers."""
    jg, _ = graphs(tiny_dataset)
    jop = jlp.build_weighted_op(jg.dense_r, tuple(weights("lightgcn", 2)), store_bf16=store_bf16)
    top = tlp.CombinedLinearOp(*(tparams.from_numpy(np.asarray(getattr(jop, n))) for n in BLOCKS))
    rs = np.random.default_rng(0)
    eu = rs.standard_normal((64, 16)).astype(np.float32)
    ei = rs.standard_normal((48, 16)).astype(np.float32)
    urows = rs.integers(0, 64, 40).astype(np.int32)
    irows = np.concatenate([rs.integers(0, 48, 40), [0, 0, 47]]).astype(np.int32)
    teu, tei = torch.from_numpy(eu).requires_grad_(), torch.from_numpy(ei).requires_grad_()
    tu = top.user_rows(torch.from_numpy(urows).long(), teu, tei)
    ti = top.item_rows(torch.from_numpy(irows).long(), teu, tei)
    ju = jop.user_rows(jnp.asarray(urows), jnp.asarray(eu), jnp.asarray(ei))
    ji = jop.item_rows(jnp.asarray(irows), jnp.asarray(eu), jnp.asarray(ei))
    assert tu.dtype == ti.dtype == torch.float32
    np.testing.assert_allclose(tu.detach().numpy(), np.asarray(ju), **TOL)
    np.testing.assert_allclose(ti.detach().numpy(), np.asarray(ji), **TOL)
    with torch.no_grad():
        fu, fi = top.full(teu, tei)
    jfu, jfi = jop.full(jnp.asarray(eu), jnp.asarray(ei))
    np.testing.assert_allclose(fu.numpy(), np.asarray(jfu), **TOL)
    np.testing.assert_allclose(fi.numpy(), np.asarray(jfi), **TOL)

    cu = rs.standard_normal(tu.shape).astype(np.float32)
    ci = rs.standard_normal(ti.shape).astype(np.float32)
    (torch.sum(torch.from_numpy(cu) * tu) + torch.sum(torch.from_numpy(ci) * ti)).backward()
    jgrad = jax.grad(lambda a, b: jnp.sum(cu * jop.user_rows(jnp.asarray(urows), a, b))
                     + jnp.sum(ci * jop.item_rows(jnp.asarray(irows), a, b)),
                     argnums=(0, 1))(jnp.asarray(eu), jnp.asarray(ei))
    for got, want, name in ((teu.grad, jgrad[0], "user"), (tei.grad, jgrad[1], "item")):
        if store_bf16:
            assert_within_bf16_ulp(got.numpy(), np.asarray(want), name)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=name)


@pytest.mark.parametrize("n", [1, 3])
def test_full_matches_the_layer_stack(tiny_dataset, n):
    """The port's operator against its own layer stack: LightGCN's
    propagate (layers 0..n) and SimGCL's unperturbed forward (1..n)."""
    _, tg = graphs(tiny_dataset)
    rs = np.random.default_rng(1)
    params = {"user_embedding": torch.from_numpy(rs.standard_normal((64, 16)).astype(np.float32)),
              "item_embedding": torch.from_numpy(rs.standard_normal((48, 16)).astype(np.float32))}
    for kind, model in (("lightgcn", LightGCN(64, 48, tg, 16, 1e-3, n)),
                        ("simgcl", SimGCL(64, 48, tg, 16, 1e-3, n, 0.2, 0.1))):
        op = tlp.build_weighted_op(tg.dense_r, weights(kind, n), store_bf16=False)
        want = model.propagate(params) if kind == "lightgcn" else model.forward(params)
        got = op.full(params["user_embedding"], params["item_embedding"])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL, err_msg=kind)


@pytest.mark.parametrize("name,fits", [("beauty", True), ("sports", True),
                                       ("electronics", False)])
def test_fits_linear_op(name, fits):
    """(U + I)^2 <= 2.2e9 entries: beauty 5.8e8, sports 1.95e9; not
    electronics. The same answer as the JAX package's."""
    u, i = {"beauty": (15482, 8643), "sports": (28940, 15207),
            "electronics": (150179, 51901)}[name]
    assert tlp.fits_linear_op(u, i) is fits is jlp.fits_linear_op(u, i)
