"""ops/prefix_scan.py against the JAX package's prefix sum.

On the CPU the port's ``prefix_cumsum`` is its plain version, held to the
JAX Pallas kernel in interpret mode (``chunked_cumsum``, as
tests/test_pallas_scan.py runs it) and to ``jnp.cumsum``, on inputs made
with numpy from a seed, ragged M around the TPU's 512-row block included.

Tolerance, from the error model of ``chaorec_tpu/ops/ell.py:370-381``: an
fp32 prefix carries an absolute error of a few ulp of the running total per
level of its summation tree, so two prefixes summed in different orders
agree to ``4 ulp(max |prefix|) x ceil(log2 M)``. The card-only tests hold
the CUDA kernel to a float64 prefix with that bound, and to the plain
version (torch.cumsum, whose rows are added one after another on the card)
with ``ulp x sqrt(M)`` more, at the shapes DGCF, DCCF and MGAT give it on
sports.

``kernel_order`` (``ops/prefix_scan.py``) is the kernel's fp32 summation
order written in numpy. On the CPU it shows that order inside the gate
(also carried over 10,607 tiles); on the card the kernel's bits equal it,
so the look-back's carry is the serial running total whatever window each
tile found.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chaorec_tpu.ops.pallas_scan import chunked_cumsum
from chaorec_tpu_torch.ops import prefix_scan as tscan
from chaorec_tpu_torch.ops.prefix_scan import kernel_order

MS = [1, 7, 511, 513, 1300]
DS = [1, 32, 100, 256]


def scan_atol(prefix: np.ndarray, m: int, sequential: bool = False) -> float:
    """4 ulp of the largest absolute prefix, times ceil(log2 M) (at least
    1); with ``sequential``, plus ulp x sqrt(M), for a version that adds
    a column's rows one after another (torch.cumsum along dim 0 on the card
    and on the CPU), whose error is a random walk of M roundings."""
    top = float(np.abs(prefix).max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 23) if top > 0 else 0.0
    return ulp * (4 * max(1, math.ceil(math.log2(m))) + (math.sqrt(m) if sequential else 0))


def _x(m, d, seed=0):
    return np.random.default_rng(seed + 7 * m + d).standard_normal((m, d)).astype(np.float32)


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("d", DS)
def test_matches_jax_kernel_and_cumsum(m, d):
    x = _x(m, d)
    got = tscan.prefix_cumsum(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (m, d)
    exact = np.cumsum(x.astype(np.float64), axis=0)
    atol = scan_atol(exact, m)
    for want in (chunked_cumsum(jnp.asarray(x), interpret=True), jnp.cumsum(jnp.asarray(x), 0)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("m", [7, 1300])
def test_one_dimensional_input(m):
    """(M,) in, (M,) out, as the squeezed 1-D seg_sum calls it."""
    x = _x(m, 1)[:, 0]
    got = tscan.prefix_cumsum(torch.from_numpy(x))
    assert got.shape == (m,)
    want = np.asarray(chunked_cumsum(jnp.asarray(x[:, None]), interpret=True))[:, 0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=scan_atol(np.cumsum(x.astype(np.float64)), m))


def test_out_and_bf16_input():
    """``out`` receives the prefix; bf16 input is summed in fp32; the CPU
    path launches nothing."""
    x = torch.from_numpy(_x(300, 16)).to(torch.bfloat16)
    before = tscan.prefix_cumsum.launches
    buf = torch.full((301, 16), 5.0)
    got = tscan.prefix_cumsum(x, out=buf[1:])
    assert got.data_ptr() == buf[1:].data_ptr() and float(buf[0].abs().max()) == 5.0
    torch.testing.assert_close(buf[1:], torch.cumsum(x.double(), 0).float(), rtol=0, atol=1e-4)
    assert tscan.prefix_cumsum.launches == before


# the 8 shapes of the parent's chunk layout test: DGCF's, DCCF's, MGAT's
# 256- and 100-wide, the 1-D seg_sum, one row, a ragged column tile, a
# short wide input
LAYOUT_SHAPES = [(159101, 32), (159101, 64), (318202, 256), (318202, 100), (159101, 1), (1, 1),
                 (513, 300), (5, 2000)]


@pytest.mark.parametrize("m,d", LAYOUT_SHAPES)
def test_tile_layout_covers_every_row(m, d):
    """Every row falls in exactly one tile and one group's run, every
    column in one column tile; the tile count and the scratch are what the
    C entry checks (csrc/prefix_scan.cu:chaorec_prefix_scan)."""
    vec = d % tscan.VEC == 0
    lay = tscan.tile_layout(m, d, vec)
    units = d // tscan.VEC if vec else d
    assert lay.units == units and lay.col_tiles == -(-units // tscan.MAX_UNITS)
    assert lay.tile_units == -(-units // lay.col_tiles) <= tscan.MAX_UNITS
    assert lay.groups == tscan.THREADS // lay.tile_units
    assert lay.tile_rows <= lay.groups * tscan.RUN_ROWS and lay.run_rows <= tscan.RUN_ROWS
    assert lay.row_tiles == -(-m // lay.tile_rows) and lay.tiles == lay.row_tiles * lay.col_tiles
    assert lay.scratch_words == 2 * lay.row_tiles * d + 1
    hits = np.zeros(m, np.int64)
    for t in range(lay.row_tiles):
        t0, t1 = t * lay.tile_rows, min((t + 1) * lay.tile_rows, m)
        for g in range(lay.groups):
            r0 = min(t0 + g * lay.run_rows, t1)
            hits[r0:min(r0 + lay.run_rows, t1)] += 1
    assert (hits == 1).all()
    cols = np.zeros(units, np.int64)
    for c in range(lay.col_tiles):
        cols[c * lay.tile_units:(c + 1) * lay.tile_units] += 1
    assert (cols == 1).all()
    if m * d >= 4_000_000:  # a path shape: 64 KB fp32 tiles, a few hundred or more
        assert lay.tile_rows * lay.tile_units * (tscan.VEC if vec else 1) * 4 >= 60_000
        assert lay.tiles >= 264


@pytest.mark.parametrize("d", [1, 3, 7, 32, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vector_path_follows_alignment(d, dtype):
    """``out`` one row into its allocation, as ops/ell.py passes ``cs[1:]``:
    16-byte units only where D % 4 == 0 keeps out aligned; a shifted v
    takes the scalar path."""
    v = torch.zeros((9, d), dtype=dtype)
    cs = torch.empty((10, d))
    assert cs.data_ptr() % 16 == 0
    assert tscan.vector_path(v, cs[1:]) == (d % 4 == 0)
    assert not tscan.vector_path(torch.zeros(9 * d + 1, dtype=dtype)[1:].view(9, d), cs[1:])


@pytest.mark.parametrize("m,d,tile_rows", [(1300, 32, None), (1300, 100, None), (5000, 1, None),
                                           (159101, 32, 15)])
def test_kernel_order_within_error_gate(m, d, tile_rows):
    """The kernel's summation order, carried over 10,607 tiles at DGCF's
    shape at its most, is within the gate the card holds it to."""
    x = _x(m, d)
    lay = tscan.tile_layout(m, d, d % 4 == 0, tile_rows)
    got = kernel_order(x, lay)
    exact = np.cumsum(x.astype(np.float64), axis=0)
    assert np.abs(got - exact).max() <= scan_atol(exact, m)
    if tile_rows:
        assert lay.tiles >= 10_000


@pytest.mark.parametrize("case", ["empty", "rank", "dtype", "out_dtype", "out_shape", "layout"])
def test_check_args_refuses(case):
    """What the kernel does not take is refused before any launch."""
    v, out = torch.zeros(10, 4), torch.zeros(10, 4)
    tscan.check_args(v, out)
    bad = {"empty": (torch.zeros(0, 4), torch.zeros(0, 4)),
           "rank": (torch.zeros(2, 3, 4), torch.zeros(2, 3, 4)),
           "dtype": (v.double(), out), "out_dtype": (v, out.double()),
           "out_shape": (v, torch.zeros(10, 5)),
           "layout": (torch.zeros(4, 10).T, out)}
    with pytest.raises((ValueError, TypeError)):
        tscan.check_args(*bad[case])


# --- on the card ------------------------------------------------------------
def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/prefix_scan.cu has no CPU mode")


# (M, D): DGCF's (train edges, dim_E / n_factors), DCCF's (train edges,
# dim_E), MGAT's doubled edges at its conv widths 256, 100 and 64, the 1-D
# seg_sum, and small ragged shapes (one row, a ragged column tile above 256)
CARD_SHAPES = [(159101, 32), (159101, 64), (318202, 256), (318202, 100), (318202, 64),
               (159101, 1), (1, 1), (7, 3), (513, 100), (1300, 257), (70000, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", CARD_SHAPES)
def test_cuda_kernel_matches_plain(m, d):
    """The kernel against torch.cumsum on the card and a float64 prefix,
    to the error model's bound; one launch a call; the same bits twice."""
    _on_card()
    gen = torch.Generator("cuda").manual_seed(m + d)
    x = torch.randn((m, d), generator=gen, device="cuda")
    before = tscan.prefix_cumsum.launches
    got = tscan.prefix_cumsum(x)
    again = tscan.prefix_cumsum(x)
    torch.cuda.synchronize()
    assert tscan.prefix_cumsum.launches == before + 2
    exact = torch.cumsum(x.double(), 0).cpu().numpy()
    err = np.abs(got.double().cpu().numpy() - exact).max()
    assert err <= scan_atol(exact, m), err
    err_plain = (got - tscan.prefix_cumsum_reference(x)).abs().max().item()
    assert err_plain <= scan_atol(exact, m, sequential=True), err_plain
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_cuda_kernel_bf16_one_dimensional_and_out():
    _on_card()
    gen = torch.Generator("cuda").manual_seed(3)
    x = torch.randn(159101, generator=gen, device="cuda").to(torch.bfloat16)
    out = torch.empty(159102, device="cuda")
    got = tscan.prefix_cumsum(x, out=out[1:])
    assert got.shape == (159101,) and got.data_ptr() == out[1:].data_ptr()
    exact = torch.cumsum(x.double(), 0)
    assert (got.double() - exact).abs().max().item() <= scan_atol(exact.cpu().numpy(), 159101)


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,tile_rows", [(159101, 32, 15), (159101, 32, None), (318202, 100, None),
                                           (70000, 7, None), (5000, 1, 1)])
def test_cuda_kernel_bits_equal_its_order(m, d, tile_rows):
    """The kernel's bits equal kernel_order's, at its own tiles and at
    15-row tiles (10,607 of them at DGCF's shape, so that the look-back
    walks long windows); with 1-row tiles the carry is the whole scan."""
    _on_card()
    x = _x(m, d)
    xc = torch.from_numpy(x).cuda()
    before = tscan.prefix_cumsum.launches
    got = tscan._launch(xc, tile_rows=tile_rows).cpu().numpy()
    assert tscan.prefix_cumsum.launches == before + 1
    lay = tscan.tile_layout(m, d, d % 4 == 0, tile_rows)
    if tile_rows == 15:
        assert lay.tiles >= 10_000
    np.testing.assert_array_equal(got, kernel_order(x, lay))


@pytest.mark.cuda
def test_cuda_kernel_same_bits_ten_calls():
    """Ten calls at DGCF's shape give the same bits, whatever window each
    tile's look-back found."""
    _on_card()
    gen = torch.Generator("cuda").manual_seed(10)
    x = torch.randn((159101, 32), generator=gen, device="cuda")
    first = tscan.prefix_cumsum(x)
    for _ in range(9):
        assert torch.equal(tscan.prefix_cumsum(x), first)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 7, 32, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_out_one_row_in(d, dtype):
    """``out`` one row into its allocation, as ops/ell.py passes ``cs[1:]``
    (not 16-byte aligned at D = 1, 3 and 7): the prefix lands there and
    the row in front stays as it was."""
    _on_card()
    m = 20000
    gen = torch.Generator("cuda").manual_seed(d)
    x = torch.randn((m, d), generator=gen, device="cuda").to(dtype)
    cs = torch.full((m + 1, d), 5.0, device="cuda")
    got = tscan.prefix_cumsum(x, out=cs[1:])
    assert got.data_ptr() == cs[1:].data_ptr()
    assert tscan.vector_path(x, cs[1:]) == (d % 4 == 0)
    assert bool((cs[0] == 5.0).all())
    exact = torch.cumsum(x.double(), 0)
    assert (cs[1:].double() - exact).abs().max().item() <= scan_atol(exact.cpu().numpy(), m)


@pytest.mark.cuda
def test_cuda_back_to_back_shapes_reset_the_scratch():
    """Calls of different shapes queued on one stream without a sync: each
    clears its own scratch (values and counter), so each is right."""
    _on_card()
    gen = torch.Generator("cuda").manual_seed(5)
    shapes = [(159101, 32), (513, 100), (70000, 7), (159101, 32), (1, 1), (318202, 64),
              (1300, 257)]
    xs = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    outs = [tscan.prefix_cumsum(x) for x in xs for _ in range(2)]
    torch.cuda.synchronize()
    for i, x in enumerate(xs):
        exact = torch.cumsum(x.double(), 0)
        for got in outs[2 * i:2 * i + 2]:
            err = (got.double() - exact).abs().max().item()
            assert err <= scan_atol(exact.cpu().numpy(), x.shape[0]), (x.shape, err)
        assert torch.equal(outs[2 * i], outs[2 * i + 1])


@pytest.mark.cuda
def test_cuda_graph_replay_resets_the_scratch():
    """One call captured in a CUDA graph replays right on new data, with the
    bits of an eager call: the memset captured with it clears the scratch
    at every replay."""
    _on_card()
    gen = torch.Generator("cuda").manual_seed(11)
    x = torch.randn((159101, 32), generator=gen, device="cuda")
    out = torch.empty_like(x)
    tscan.prefix_cumsum(x, out=out)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tscan.prefix_cumsum(x, out=out)
    for _ in range(3):
        x.copy_(torch.randn(x.shape, generator=gen, device="cuda"))
        graph.replay()
        torch.cuda.synchronize()
        exact = torch.cumsum(x.double(), 0)
        assert (out.double() - exact).abs().max().item() <= scan_atol(exact.cpu().numpy(), 159101)
        assert torch.equal(out, tscan.prefix_cumsum(x))
