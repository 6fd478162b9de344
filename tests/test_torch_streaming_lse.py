"""ops/streaming_lse.py and losses.catalog_logsumexp against the JAX package's.

On the CPU the port's ``streaming_logsumexp`` is its plain version; it is
held to the JAX Pallas kernel in interpret mode (as tests/test_pallas_lse.py
runs it) on inputs made with numpy from a seed: values to rtol/atol 1e-5,
both gradients under a random weight per row to rtol 1e-4, atol 1e-5 (fp32
sums in another order). The card-only tests hold the CUDA kernels to the
plain version and its autograd on the card, at the shapes SGL and NCL give
them on sports.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chaorec_tpu.ops import losses as jlosses
from chaorec_tpu.ops.pallas_lse import streaming_logsumexp as jlse
from chaorec_tpu_torch.ops import losses as tlosses
from chaorec_tpu_torch.ops import streaming_lse as tlse

VAL_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)

# (B, N, E, q scale): tests/test_pallas_lse.py's shapes (N not a multiple of
# the TPU's 512-row tile), an N below one tile, and unit rows over a
# temperature of 0.01 (logits up to +-100, NCL's range)
CASES = [(64, 600, 16, 3.0), (130, 1100, 32, 3.0), (9, 37, 16, 1.0), (48, 300, 16, "unit/0.01")]


def _inputs(b, n, e, scale, seed=0):
    rs = np.random.default_rng(seed)
    q = rs.standard_normal((b, e)).astype(np.float32)
    k = rs.standard_normal((n, e)).astype(np.float32)
    if scale == "unit/0.01":
        q = q / np.linalg.norm(q, axis=1, keepdims=True) / 0.01
        k = k / np.linalg.norm(k, axis=1, keepdims=True)
    else:
        q = q * scale
    w = rs.standard_normal(b).astype(np.float32)
    return q, k, w


@pytest.mark.parametrize("b,n,e,scale", CASES)
def test_matches_jax_kernel_in_interpret_mode(b, n, e, scale):
    q, k, w = _inputs(b, n, e, scale)
    want = jlse(jnp.asarray(q), jnp.asarray(k), interpret=True)
    got = tlse.streaming_logsumexp(torch.from_numpy(q), torch.from_numpy(k))
    assert got.dtype == torch.float32 and got.shape == (b,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL_TOL)

    jgq, jgk = jax.grad(lambda a, c: jnp.sum(jnp.asarray(w) * jlse(a, c, interpret=True)),
                        argnums=(0, 1))(jnp.asarray(q), jnp.asarray(k))
    tq, tk = torch.from_numpy(q).requires_grad_(), torch.from_numpy(k).requires_grad_()
    torch.sum(torch.from_numpy(w) * tlse.streaming_logsumexp(tq, tk)).backward()
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jgq), **GRAD_TOL)
    np.testing.assert_allclose(tk.grad.numpy(), np.asarray(jgk), **GRAD_TOL)


@pytest.mark.parametrize("temperature", [0.1, 0.01])
def test_catalog_logsumexp_matches_jax(temperature):
    """catalog_logsumexp against the JAX function (its XLA path on the
    CPU), value and gradients, unit rows as SGL and NCL give it."""
    q, k, w = _inputs(40, 70, 16, "unit/0.01", seed=3)
    q = q * 0.01
    want = jlosses.catalog_logsumexp(jnp.asarray(q), jnp.asarray(k), temperature)
    tq, tk = torch.from_numpy(q).requires_grad_(), torch.from_numpy(k).requires_grad_()
    got = tlosses.catalog_logsumexp(tq, tk, temperature)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **VAL_TOL)
    jgq, jgk = jax.grad(
        lambda a, c: jnp.sum(jnp.asarray(w) * jlosses.catalog_logsumexp(a, c, temperature)),
        argnums=(0, 1))(jnp.asarray(q), jnp.asarray(k))
    torch.sum(torch.from_numpy(w) * got).backward()
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jgq), **GRAD_TOL)
    np.testing.assert_allclose(tk.grad.numpy(), np.asarray(jgk), **GRAD_TOL)


def test_gradient_comes_back_in_the_inputs_dtype():
    q, k, _ = _inputs(6, 20, 8, 1.0)
    tq = torch.from_numpy(q).double().requires_grad_()
    tlse.streaming_logsumexp(tq, torch.from_numpy(k)).sum().backward()
    assert tq.grad.dtype == torch.float64


@pytest.mark.parametrize("b,n,sms,want", [
    (1024, 28940, 132, (33, 14)), (1024, 15207, 132, (30, 8)), (381, 15207, 132, (80, 3)),
    (1024, 200, 132, (4, 1)), (7, 513, 132, (9, 1)), (1, 1, 132, (1, 1))])
def test_catalog_splits_cover_the_catalog(b, n, sms, want):
    splits, per = tlse.catalog_splits(b, n, sms)
    tiles = -(-n // tlse.TILE)
    assert (splits, per) == want
    assert splits * per >= tiles and (splits - 1) * per < tiles


# (rows kept by a block, rows streamed, SMs, expected (splits, tiles per
# split)): the E = 64 backward pair's layouts at the path's shapes. dq keeps
# q and streams the catalog (SGL's user and item sides, the ragged last
# batch, NCL's 200 prototypes, a small case); dk keeps the catalog and
# streams q (B split where ceil(N / 128) blocks leave SMs idle: the item
# side), and edge cases (one row, more SMs than rows, a catalog of one tile).
@pytest.mark.parametrize("rows,streamed,sms,want", [
    (1024, 28940, 132, (33, 14)), (1024, 15207, 132, (30, 8)), (381, 15207, 132, (80, 3)),
    (1024, 200, 132, (4, 1)), (7, 513, 132, (9, 1)),
    (28940, 1024, 132, (1, 16)), (15207, 1024, 132, (2, 8)), (15207, 381, 132, (2, 3)),
    (513, 7, 132, (1, 1)), (1, 1, 132, (1, 1)), (1, 100000, 132, (261, 6)),
    (100000, 1, 132, (1, 1)), (128, 64, 1, (1, 1))])
def test_catalog_splits_cover_the_catalog_backward(rows, streamed, sms, want):
    """backward_splits covers every streamed tile exactly once, leaves no
    split empty, and gives the layout the kernels were timed at."""
    splits, per = tlse.backward_splits(rows, streamed, sms)
    tiles = -(-streamed // tlse.TILE)
    assert (splits, per) == want
    assert splits * per >= tiles and (splits - 1) * per < tiles
    covered = [t for s in range(splits) for t in range(s * per, min((s + 1) * per, tiles))]
    assert covered == list(range(tiles))
    assert 1 <= splits <= 65535


def test_backward_path_follows_width_and_alignment():
    """lse_bwd64_kernel takes E 64 with q and k 16-byte aligned; any other
    width or an unaligned view goes to the generic kernels."""
    q, k = torch.zeros(8, 64), torch.zeros(20, 64)
    assert tlse.takes_e64(q, k)
    assert not tlse.takes_e64(torch.zeros(8, 32), torch.zeros(20, 32))
    assert not tlse.takes_e64(torch.zeros(8 * 64 + 1)[1:].view(8, 64), k)
    assert not tlse.takes_e64(q, torch.zeros(20 * 64 + 2)[2:].view(20, 64))


# (B, N, SMs, expected (splits, tiles per split)) of lse_fwd64_kernel: SGL's
# user and item sides, the ragged last batch, NCL's 200 prototypes (the
# layouts timed on the card), a small case, and edge cases (one row
# and column, one q row against a long catalog, a long q against one
# column, B past one wave, one SM)
@pytest.mark.parametrize("b,n,sms,want", [
    (1024, 28940, 132, (33, 14)), (1024, 15207, 132, (30, 8)), (381, 15207, 132, (80, 3)),
    (1024, 200, 132, (4, 1)), (7, 513, 132, (9, 1)), (1, 1, 132, (1, 1)),
    (1, 100000, 132, (261, 6)), (100000, 1, 132, (1, 1)), (200000, 64, 132, (1, 1)),
    (128, 64, 1, (1, 1))])
def test_forward_splits_cover_the_catalog(b, n, sms, want):
    """forward_splits covers every k tile exactly once, leaves no split
    empty, and puts at most FWD_BLOCKS_PER_SM blocks on an SM unless B
    alone needs more (one split)."""
    splits, per = tlse.forward_splits(b, n, sms)
    tiles = -(-n // tlse.TILE)
    assert (splits, per) == want
    covered = [t for s in range(splits) for t in range(s * per, min((s + 1) * per, tiles))]
    assert covered == list(range(tiles))
    assert 1 <= splits <= 65535
    blocks = -(-b // tlse.ENGINE_ROWS) * splits
    assert blocks <= tlse.FWD_BLOCKS_PER_SM * sms or splits == 1


@pytest.mark.parametrize("q,k,kernel", [
    ((8, 64), (20, 64), "lse_fwd64_kernel"), ((8, 32), (20, 32), "lse_fwd_kernel"),
    ((8, 256), (20, 256), "lse_fwd_kernel"), ("q+1", (20, 64), "lse_fwd_kernel"),
    ((8, 64), "k+2", "lse_fwd_kernel")])
def test_forward_path_follows_width_and_alignment(q, k, kernel):
    """The forward runs lse_fwd64_kernel, laid out by forward_splits, only
    at E 64 with q and k 16-byte aligned; else lse_fwd_kernel, laid out by
    catalog_splits. "q+1" and "k+2" are views 4 and 8 bytes off a 16-byte
    boundary."""
    views = {"q+1": torch.zeros(8 * 64 + 1)[1:].view(8, 64),
             "k+2": torch.zeros(20 * 64 + 2)[2:].view(20, 64)}
    q = views[q] if isinstance(q, str) else torch.zeros(q)
    k = views[k] if isinstance(k, str) else torch.zeros(k)
    splits = tlse.forward_splits if kernel == "lse_fwd64_kernel" else tlse.catalog_splits
    assert tlse.forward_layout(q, k, 132) == (kernel, *splits(8, 20, 132))


LOG2E = np.float32(1.4426950408889634)
NEG = np.float32(-1e30)


def _merge(m, s, mo, so):
    """csrc/streaming_lse.cu:merge in fp32: the pair of (m, s) and (mo, so)."""
    mn = np.maximum(m, mo)
    return mn, s * np.exp(m - mn) + so * np.exp(mo - mn)


def fwd64_order(logits: np.ndarray, splits: int, per: int) -> np.ndarray:
    """lse_fwd64_kernel's order of fp32 operations, in numpy, from fp32
    logits (B, N): per split, each of the 8 threads of a row (columns
    cg + 8 j of each 64-column tile) keeps a running (max, sum) with one
    rescale exp2 a tile and one exp2 a logit of fmaf(logit, log2 e,
    -max log2 e); the 8 pairs merge by shuffles xor 1, 2, 4; then the
    splits merge in order (lse_combine_kernel). exp2 and fmaf are numpy's
    correctly rounded ones, not the card's ex2.approx."""
    b, n = logits.shape
    tiles = -(-n // 64)
    padded = np.full((b, tiles * 64), -np.inf, np.float32)
    padded[:, :n] = logits
    cols = padded.reshape(b, tiles, 8, 8)  # (row, tile, j, cg): column 64 t + cg + 8 j
    big_m, big_s = np.full(b, NEG, np.float32), np.zeros(b, np.float32)
    for split in range(splits):
        m, l = np.full((b, 8), NEG, np.float32), np.zeros((b, 8), np.float32)
        for t in range(split * per, min((split + 1) * per, tiles)):
            s = cols[:, t]  # (row, j, cg)
            mn = np.maximum(m, s.max(axis=1))
            neg = -mn * LOG2E
            acc = l * np.exp2((m - mn) * LOG2E)
            for j in range(8):
                arg = (s[:, j].astype(np.float64) * LOG2E + neg).astype(np.float32)
                acc = acc + np.exp2(arg)
            m, l = mn, acc
        for off in (1, 2, 4):
            partner = np.arange(8) ^ off
            m, l = _merge(m, l, m[:, partner], l[:, partner])
        big_m, big_s = _merge(big_m, big_s, m[:, 0], l[:, 0])
    return big_m + np.log(big_s)


@pytest.mark.parametrize("temperature", [0.1, 0.01])
@pytest.mark.parametrize("b,n", [(1024, 28940), (1024, 15207), (381, 15207), (1024, 200),
                                 (7, 513), (1, 1)])
def test_forward_order_within_the_gate(b, n, temperature):
    """lse_fwd64_kernel's summation order (fwd64_order) over the grid
    forward_splits gives at the path's shapes, on 16 of the rows (the
    order of a row does not depend on the others), stays within the
    kernel gate (rtol/atol 1e-5) of a float64 logsumexp of the same fp32
    logits, with logits to +-100 at temperature 0.01."""
    rows = min(b, 16)
    q, k, _ = _inputs(rows, n, 64, "unit/0.01", seed=n)
    logits = (q * np.float32(0.01 / temperature)) @ k.T
    splits, per = tlse.forward_splits(b, n, 132)
    got = fwd64_order(logits, splits, per)
    x = logits.astype(np.float64)
    top = x.max(axis=1, keepdims=True)
    want = (top + np.log(np.exp(x - top).sum(axis=1, keepdims=True)))[:, 0]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **VAL_TOL)


@pytest.mark.parametrize("case", ["rank", "width", "empty", "devices", "wide", "dtype",
                                  "layout", "rows"])
def test_check_args_refuses(case):
    """What the kernels do not take is refused before any launch."""
    q, k, lse, g = torch.zeros(4, 8), torch.zeros(10, 8), torch.zeros(4), torch.zeros(4)
    tlse._check_kernel_args(q, k, lse, g)
    bad = {"rank": (torch.zeros(4), k), "width": (q, torch.zeros(10, 9)),
           "empty": (q, torch.zeros(0, 8)), "devices": (q, torch.zeros(10, 8, device="meta")),
           "wide": (torch.zeros(4, tlse.MAX_E + 1), torch.zeros(10, tlse.MAX_E + 1)),
           "dtype": (q.double(), k, lse, g), "layout": (q, torch.zeros(8, 10).T, lse, g),
           "rows": (q, k, torch.zeros(5), g)}
    with pytest.raises(ValueError):
        tlse._check_kernel_args(*bad[case])


# --- on the card ------------------------------------------------------------
def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/streaming_lse.cu has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32


# (B, N, E, temperature, k needs a gradient): SGL's user and item sides, the
# last batch of an epoch, NCL's prototype term over 200 centroids, a small
# ragged case, E at its limit, and an E that is not a multiple of 4
CARD_CASES = [(1024, 28940, 64, 0.1, True), (1024, 15207, 64, 0.1, True),
              (381, 15207, 64, 0.1, True), (1024, 200, 64, 0.01, False),
              (7, 513, 64, 0.1, True), (33, 1000, 256, 0.1, True), (70, 130, 18, 0.5, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,e,temp,k_grad", CARD_CASES)
def test_cuda_kernels_match_plain(b, n, e, temp, k_grad):
    """Forward to rtol/atol 1e-5 of the plain version; dq and dk within
    1e-5 of the largest plain entry, scaled by max(1, 0.1 / temperature)
    (the logits' own fp32 rounding grows with 1 / temperature); dk is not
    launched when k needs no gradient."""
    _on_card()
    gen = torch.Generator("cuda").manual_seed(b + n)
    q = torch.nn.functional.normalize(torch.randn(b, e, generator=gen, device="cuda"), dim=1)
    k = torch.nn.functional.normalize(torch.randn(n, e, generator=gen, device="cuda"), dim=1)
    q = (q / temp).requires_grad_()
    k = k.requires_grad_(k_grad)
    g = torch.randn(b, generator=gen, device="cuda")
    counts = [f.launches for f in (tlse.streaming_lse_fwd, tlse.streaming_lse_dq,
                                   tlse.streaming_lse_dk)]
    got = tlse.streaming_logsumexp(q, k)
    grads = torch.autograd.grad(got, (q, k) if k_grad else (q,), g)
    torch.cuda.synchronize()
    after = [f.launches for f in (tlse.streaming_lse_fwd, tlse.streaming_lse_dq,
                                  tlse.streaming_lse_dk)]
    assert after == [counts[0] + 1, counts[1] + 1, counts[2] + int(k_grad)]
    want = tlse.streaming_logsumexp_reference(q, k)
    wgrads = torch.autograd.grad(want, (q, k) if k_grad else (q,), g)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    rel = 1e-5 * max(1.0, 0.1 / temp)
    for a, w in zip(grads, wgrads):
        assert (a - w).abs().max().item() <= rel * w.abs().max().item()


@pytest.mark.cuda
def test_cuda_kernels_are_deterministic():
    """No atomics: the same inputs give the same bits twice."""
    _on_card()
    gen = torch.Generator("cuda").manual_seed(0)
    q = torch.randn(300, 64, generator=gen, device="cuda").requires_grad_()
    k = torch.randn(5000, 64, generator=gen, device="cuda").requires_grad_()
    runs = []
    for _ in range(2):
        lse = tlse.streaming_logsumexp(q, k)
        runs.append((lse, *torch.autograd.grad(lse.sum(), (q, k))))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _card_inputs(b, n, e, temp, seed=0, offset=0):
    """q unit rows over ``temp``, k unit rows, both requiring a gradient,
    and g; ``offset`` floats in front of q's data (an unaligned view)."""
    gen = torch.Generator("cuda").manual_seed(seed)
    q = torch.nn.functional.normalize(torch.randn(b, e, generator=gen, device="cuda"), dim=1)
    k = torch.nn.functional.normalize(torch.randn(n, e, generator=gen, device="cuda"), dim=1)
    if offset:
        buf = torch.empty(b * e + offset, device="cuda")
        buf[offset:].copy_((q / temp).view(-1))
        q = buf[offset:].view(b, e)
    else:
        q = q / temp
    return (q.requires_grad_(), k.requires_grad_(),
            torch.randn(b, generator=gen, device="cuda"))


def _hold_backward(b, n, e, temp, offset=0):
    """dq and dk of the kernels against the plain version's autograd, each
    within 1e-5 x max(1, 0.1 / temperature) of the largest plain entry."""
    q, k, g = _card_inputs(b, n, e, temp, seed=b + n + e, offset=offset)
    got = torch.autograd.grad(tlse.streaming_logsumexp(q, k), (q, k), g)
    want = torch.autograd.grad(tlse.streaming_logsumexp_reference(q, k), (q, k), g)
    rel = 1e-5 * max(1.0, 0.1 / temp)
    for name, a, w in zip(("dq", "dk"), got, want):
        assert a.dtype == w.dtype == torch.float32 and a.shape == w.shape
        err = (a - w).abs().max().item()
        assert err <= rel * w.abs().max().item(), (name, err, w.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("e", [1, 3, 64, 100, 256])
def test_cuda_backward_at_every_width(e):
    """The generic kernels (E 1, 3, 100, 256) and the E = 64 engine."""
    _on_card()
    _hold_backward(300, 2000, e, 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 7, 381, 1024])
@pytest.mark.parametrize("n", [1, 200, 513, 28940])
def test_cuda_backward_at_ragged_shapes(b, n):
    """The E = 64 engine at every B against every N: one row, one column,
    partial tiles on both sides, SGL's user side."""
    _on_card()
    _hold_backward(b, n, 64, 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(1024, 200), (381, 15207)])
def test_cuda_backward_with_logits_to_100(b, n):
    """Unit rows over a temperature of 0.01: logits reach +-100."""
    _on_card()
    _hold_backward(b, n, 64, 0.01)


@pytest.mark.cuda
def test_cuda_backward_of_an_unaligned_q():
    """A q view 4 bytes off a 16-byte boundary takes the generic kernels."""
    _on_card()
    q, k, _ = _card_inputs(7, 513, 64, 0.1, offset=1)
    assert not tlse.takes_e64(q, k)
    _hold_backward(70, 513, 64, 0.1, offset=1)


def _backward_pair(q, k, g):
    lse = tlse.streaming_lse_fwd(q, k)
    return tlse.streaming_lse_dq(q, k, lse, g), tlse.streaming_lse_dk(q, k, lse, g)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(1024, 28940), (1024, 15207), (381, 15207)])
def test_cuda_backward_bits_in_calls_and_graph_replays(b, n):
    """The same bits from two calls and from two replays of one CUDA graph
    (which also equal the calls'): no atomics, and the splits' combine
    passes sum in a fixed order."""
    _on_card()
    q, k, g = (t.detach() for t in _card_inputs(b, n, 64, 0.1))
    first, second = _backward_pair(q, k, g), _backward_pair(q, k, g)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _backward_pair(q, k, g)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _backward_pair(q, k, g)
    graph.replay()
    torch.cuda.synchronize()
    replay1 = [t.clone() for t in out]
    graph.replay()
    torch.cuda.synchronize()
    for a, b_, c, d in zip(first, second, replay1, out):
        assert torch.equal(a, b_) and torch.equal(a, c) and torch.equal(a, d)


@pytest.mark.cuda
def test_cuda_backward_back_to_back_shapes():
    """Calls at two shapes in turn (other splits, other scratch sizes) give
    what each shape gives alone."""
    _on_card()
    small = [t.detach() for t in _card_inputs(381, 15207, 64, 0.1, seed=1)]
    large = [t.detach() for t in _card_inputs(1024, 28940, 64, 0.1, seed=2)]
    alone = [_backward_pair(*small), _backward_pair(*large)]
    for _ in range(2):
        for inputs, want in zip((small, large), alone):
            for a, w in zip(_backward_pair(*inputs), want):
                assert torch.equal(a, w)


def _hold_forward(b, n, e, temp, offset=0):
    """streaming_lse_fwd against the plain version at rtol/atol 1e-5, one
    launch, on the kernel forward_layout names."""
    q, k, _ = (t.detach() for t in _card_inputs(b, n, e, temp, seed=b + n + e, offset=offset))
    before = tlse.streaming_lse_fwd.launches
    got = tlse.streaming_lse_fwd(q, k)
    torch.cuda.synchronize()
    assert tlse.streaming_lse_fwd.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (b,)
    torch.testing.assert_close(got, tlse.streaming_logsumexp_reference(q, k), rtol=1e-5,
                               atol=1e-5)
    return q, k


@pytest.mark.cuda
@pytest.mark.parametrize("e", [1, 3, 64, 100, 256])
def test_cuda_forward_at_every_width(e):
    """The generic forward (E 1, 3, 100, 256) and lse_fwd64_kernel (E 64)."""
    _on_card()
    q, k = _hold_forward(300, 2000, e, 0.1)
    assert tlse.forward_layout(q, k, 132)[0] == ("lse_fwd64_kernel" if e == 64
                                                 else "lse_fwd_kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 7, 381, 1024])
@pytest.mark.parametrize("n", [1, 200, 513, 28940])
def test_cuda_forward_at_ragged_shapes(b, n):
    """lse_fwd64_kernel at every B against every N: one row, one column
    (7 of a thread's 8 columns and 63 of the tile masked), partial tiles on
    both sides, SGL's user side."""
    _on_card()
    _hold_forward(b, n, 64, 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(1024, 200), (381, 15207), (1024, 28940)])
def test_cuda_forward_with_logits_to_100(b, n):
    """Unit rows over a temperature of 0.01: logits reach +-100, and each
    split's online rescale spans many decades."""
    _on_card()
    _hold_forward(b, n, 64, 0.01)


@pytest.mark.cuda
def test_cuda_forward_of_an_unaligned_q():
    """A q view 4 bytes off a 16-byte boundary takes lse_fwd_kernel."""
    _on_card()
    q, k = _hold_forward(70, 513, 64, 0.1, offset=1)
    assert not tlse.takes_e64(q, k)
    assert tlse.forward_layout(q, k, 132)[0] == "lse_fwd_kernel"


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,temp", [(1024, 28940, 0.1), (1024, 15207, 0.1),
                                      (381, 15207, 0.1), (1024, 200, 0.01)])
def test_cuda_forward_bits_in_calls_and_graph_replays(b, n, temp):
    """The same bits from two calls and from two replays of one CUDA graph
    (which also equal the calls'): no atomics, and the splits' combine
    pass merges in a fixed order."""
    _on_card()
    q, k, _ = (t.detach() for t in _card_inputs(b, n, 64, temp))
    first, second = tlse.streaming_lse_fwd(q, k), tlse.streaming_lse_fwd(q, k)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tlse.streaming_lse_fwd(q, k)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tlse.streaming_lse_fwd(q, k)
    graph.replay()
    torch.cuda.synchronize()
    replay1 = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, replay1)
    assert torch.equal(first, out)


@pytest.mark.cuda
def test_cuda_forward_blocks_an_sm():
    """One SM holds FWD_BLOCKS_PER_SM blocks of lse_fwd64_kernel (68 KB of
    shared memory each, and its registers), as forward_splits assumes."""
    _on_card()
    assert tlse.fwd64_blocks_per_sm() == tlse.FWD_BLOCKS_PER_SM
