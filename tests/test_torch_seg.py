"""ops/ell.py's segment sums and ops/edge_softmax.py against the JAX package's.

The same flat indices, values and cotangents (numpy, from a seed) go to
both packages. The indices leave segments empty and give others one edge.
``perm`` and ``ptr`` must be equal (both argsorts are stable). Values and
gradients agree to the prefix error model of ``chaorec_tpu/ops/ell.py:
370-381`` (a few ulp of the running total per level of the summation
tree, ``test_torch_prefix_scan.scan_atol``); gathers are exact. The edge
softmax agrees to rtol 1e-5, atol 1e-7 (fp32 exps and sums in another
order); its gradient to rtol 1e-5 and an atol of one ulp of the largest
cotangent per term of the longest segment's sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chaorec_tpu.ops import edge_softmax as jsoftmax
from chaorec_tpu.ops import ell as jell
from chaorec_tpu_torch.ops import edge_softmax as tsoftmax
from chaorec_tpu_torch.ops import ell as tell
from chaorec_tpu_torch.ops import prefix_scan as tscan
from test_torch_prefix_scan import scan_atol

N_SEG = 40


def _indices(m=700, seed=0):
    """``m`` indices over N_SEG segments: segments 0, 17 and 39 empty,
    segments 5 and 23 with one edge each, the rest random."""
    rs = np.random.default_rng(seed)
    pool = np.setdiff1d(np.arange(N_SEG), [0, 17, 39, 5, 23])
    idx = np.concatenate([[5, 23], rs.choice(pool, m - 2)])
    return rs.permutation(idx).astype(np.int32)


def _values(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(idx):
    jperm, jptr = jell.build_segment_transpose(jnp.asarray(idx), N_SEG)
    tidx = torch.from_numpy(idx).long()
    tperm, tptr = tell.build_segment_transpose(tidx, N_SEG)
    return (jnp.asarray(idx), jperm, jptr), (tidx, tperm, tptr)


def test_segment_transpose_equals_jax():
    idx = _indices()
    (_, jperm, jptr), (_, tperm, tptr) = _both(idx)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(tptr.numpy(), np.asarray(jptr))
    assert tptr.shape == (N_SEG + 1,) and int(tptr[0]) == 0 and int(tptr[-1]) == idx.shape[0]


@pytest.mark.parametrize("d", [None, 1, 32])
def test_seg_sum_matches_jax(d):
    """Values (1-D and 2-D) and the gradient of a weighted sum, which is the
    gather of the weights; empty segments are exactly 0."""
    idx = _indices()
    m = idx.shape[0]
    vals = _values((m,) if d is None else (m, d))
    cot = _values((N_SEG,) if d is None else (N_SEG, d), seed=2)
    (jidx, jperm, jptr), (tidx, tperm, tptr) = _both(idx)
    want = jell.seg_sum(jnp.asarray(vals), jidx, jperm, jptr)
    jgrad = jax.grad(lambda v: jnp.sum(jnp.asarray(cot) * jell.seg_sum(v, jidx, jperm, jptr)))(
        jnp.asarray(vals))
    tv = torch.from_numpy(vals).requires_grad_()
    got = tell.seg_sum(tv, tidx, tperm, tptr)
    (torch.from_numpy(cot) * got).sum().backward()
    exact = np.cumsum(vals[np.argsort(idx, kind="stable")].astype(np.float64), axis=0)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                               atol=2 * scan_atol(exact, m))
    assert float(got.detach()[[0, 17, 39]].abs().max()) == 0.0
    np.testing.assert_array_equal(tv.grad.numpy(), np.asarray(jgrad))


@pytest.mark.parametrize("d", [None, 16])
def test_seg_gather_matches_jax(d):
    """The gather is exact; its gradient is seg_sum of the cotangent (the
    prefix sum, to the error model), 0 on rows no index reads."""
    idx = _indices()
    m = idx.shape[0]
    x = _values((N_SEG,) if d is None else (N_SEG, d))
    cot = _values((m,) if d is None else (m, d), seed=3)
    (jidx, jperm, jptr), (tidx, tperm, tptr) = _both(idx)
    want = jell.seg_gather(jnp.asarray(x), jidx, jperm, jptr)
    jgrad = jax.grad(lambda a: jnp.sum(jnp.asarray(cot) * jell.seg_gather(a, jidx, jperm, jptr)))(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = tell.seg_gather(tx, tidx, tperm, tptr)
    (torch.from_numpy(cot) * got).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    exact = np.cumsum(cot[np.argsort(idx, kind="stable")].astype(np.float64), axis=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=2 * scan_atol(exact, m))
    assert float(tx.grad[[0, 17, 39]].abs().max()) == 0.0


def test_index_arguments_get_no_gradient_and_ptr_is_checked():
    idx = _indices()
    _, (tidx, tperm, tptr) = _both(idx)
    x = torch.from_numpy(_values((N_SEG, 4))).double().requires_grad_()
    out = tell.seg_sum(tell.seg_gather(x, tidx, tperm, tptr), tidx, tperm, tptr)
    assert out.dtype == torch.float32
    out.sum().backward()
    assert x.grad.dtype == torch.float64 and tidx.grad is None and tptr.grad is None
    with pytest.raises(ValueError):
        tell.seg_gather(x[:-1], tidx, tperm, tptr)


def test_cpu_segment_sums_launch_nothing():
    idx = _indices()
    _, (tidx, tperm, tptr) = _both(idx)
    before = tscan.prefix_cumsum.launches
    tell.seg_sum(torch.ones(idx.shape[0], 3), tidx, tperm, tptr)
    assert tscan.prefix_cumsum.launches == before


def test_caveat_error_model_holds():
    """The CAVEAT's error model (tests/test_ell.py:341-358 for the JAX
    package): non-negative values over 3e5 edges. The prefix difference's
    error rides the global total, far above index_add_'s per-segment sums,
    and stays within the model's bound of the total."""
    rs = np.random.default_rng(11)
    n_edges, n_seg = 300_000, 4096
    idx = torch.from_numpy(np.sort(rs.integers(0, n_seg, n_edges)))
    vals = torch.from_numpy(rs.uniform(0.5, 1.5, n_edges).astype(np.float32))
    exact = torch.zeros(n_seg, dtype=torch.float64).index_add_(0, idx, vals.double())
    perm, ptr = tell.build_segment_transpose(idx, n_seg)
    err_scan = (tell.seg_sum(vals, idx, perm, ptr).double() - exact).abs().max().item()
    err_scatter = (torch.zeros(n_seg).index_add_(0, idx, vals).double() - exact).abs().max().item()
    assert err_scatter < 1e-3, err_scatter
    assert err_scan > 10 * err_scatter, (err_scan, err_scatter)
    total = np.cumsum(vals.double().numpy())
    assert err_scan <= 2 * scan_atol(total, n_edges), err_scan


def test_segment_softmax_matches_jax():
    """Scores on a segment with no edge, one edge and many; large scores;
    the gradient of a weighted sum (the detached max changes nothing)."""
    idx = _indices(300)
    scores = _values(300) * 8.0
    cot = _values(300, seed=5)
    want = jsoftmax.segment_softmax(jnp.asarray(scores), jnp.asarray(idx), N_SEG)
    jgrad = jax.grad(lambda s: jnp.sum(jnp.asarray(cot) * jsoftmax.segment_softmax(
        s, jnp.asarray(idx), N_SEG)))(jnp.asarray(scores))
    ts = torch.from_numpy(scores).requires_grad_()
    got = tsoftmax.segment_softmax(ts, torch.from_numpy(idx).long(), N_SEG)
    (torch.from_numpy(cot) * got).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    # d score_j = p_j (c_j - sum_seg p c): the segment's sum of up to
    # max_len terms no larger than max |c| carries fp32 rounding of about
    # max_len ulps of max |c|, whatever the size of the result
    max_len = int(np.bincount(idx).max())
    grad_atol = max_len * 2.0 ** -23 * float(np.abs(cot).max())
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=grad_atol)
    assert float(got.detach()[idx == 5]) == 1.0
    sums = torch.zeros(N_SEG, dtype=torch.float64).index_add_(0, torch.from_numpy(idx).long(),
                                                               got.detach().double())
    present = np.isin(np.arange(N_SEG), idx)
    np.testing.assert_allclose(sums.numpy()[present], 1.0, atol=1e-6)


# --- on the card ------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_seg_sum_and_gather_backward_launch_the_kernel():
    """On the card seg_sum's forward and seg_gather's backward each launch
    the prefix kernel once, and agree with the CPU's plain path to the
    error model of both (the CPU's torch.cumsum adds rows one after
    another: ``scan_atol(..., sequential=True)``) over the sorted values
    each sums: the gathered rows of x, and of the cotangent."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/prefix_scan.cu has no CPU mode")
    idx = _indices(5000)
    x = _values((N_SEG, 64))
    cot = _values((N_SEG, 64), seed=4)
    results = []
    for dev in ("cpu", "cuda"):
        tidx = torch.from_numpy(idx).long().to(dev)
        perm, ptr = tell.build_segment_transpose(tidx, N_SEG)
        tx = torch.from_numpy(x).to(dev).requires_grad_()
        before = tscan.prefix_cumsum.launches
        out = tell.seg_sum(tell.seg_gather(tx, tidx, perm, ptr), tidx, perm, ptr)
        (torch.from_numpy(cot).to(dev) * out).sum().backward()
        launched = tscan.prefix_cumsum.launches - before
        assert launched == (2 if dev == "cuda" else 0)
        results.append((out.detach().cpu(), tx.grad.cpu()))
    sorted_idx = np.sort(idx)
    for a, b, src in zip(*results, (x, cot)):
        exact = np.cumsum(src[sorted_idx].astype(np.float64), axis=0)
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=2 * scan_atol(exact, idx.shape[0], sequential=True))
