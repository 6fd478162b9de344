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
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chaorec_tpu.ops.pallas_scan import chunked_cumsum
from chaorec_tpu_torch.ops import prefix_scan as tscan

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


@pytest.mark.parametrize("m,d,sms", [(159101, 32, 132), (159101, 64, 132), (318202, 256, 132),
                                     (318202, 100, 132), (159101, 1, 132), (1, 1, 132),
                                     (513, 300, 132), (5, 2000, 8)])
def test_chunk_layout_covers_every_row(m, d, sms):
    """Every row lands in exactly one chunk and one group's run, and the
    grid gives the 132 SMs a few blocks each once the input is large."""
    chunk_rows, chunks, groups = tscan.chunk_layout(m, d, sms)
    width = min(d, tscan.THREADS)
    assert groups == tscan.THREADS // width >= 1
    assert chunks * chunk_rows >= m > (chunks - 1) * chunk_rows
    run = -(-chunk_rows // groups)
    assert groups * run >= chunk_rows
    if m * d >= 4_000_000:
        assert chunks * -(-d // width) >= 2 * sms


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
