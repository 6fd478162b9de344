"""ops/indexed_adam.py and ops/row_adam.py against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages. The
tolerances are the JAX package's own for its row-sparse Adam
(tests/test_indexed_adam.py, tests/test_pallas_row_adam.py): rtol 2e-5
with atol 2e-7 for the table and m, atol 1e-9 for v (float32 Adam in
another operation order). bf16 storage is held to one bf16 ulp of the
stored value, since fp32 math in another order can round the other way
(on the card, on top of the fp32 tolerances: see the card-only test).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chaorec_tpu.ops import indexed_adam as jadam
from chaorec_tpu.ops import pallas_row_adam as jrow
from chaorec_tpu_torch.ops import indexed_adam as tadam
from chaorec_tpu_torch.ops import row_adam as trow

P_TOL = dict(rtol=2e-5, atol=2e-7)
V_TOL = dict(rtol=2e-5, atol=1e-9)


def _rows(rs, n, b, dup):
    if dup:
        return rs.integers(0, max(n // 6, 2), b).astype(np.int32)  # many duplicates
    return rs.choice(n, size=b, replace=False).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


def bf16_ulp(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of the larger of |got| and |want|, entry by entry."""
    mag = torch.maximum(got.float().abs(), want.float().abs()).clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in units of one bf16 ulp of the larger value."""
    return float(((got.float() - want.float()).abs() / bf16_ulp(got, want)).max())


@pytest.mark.parametrize("dup", [False, True])
def test_matches_jax_and_dense_adam(dup):
    """Five steps of row_adam_update against the JAX package's and against
    torch.optim.Adam on the scattered dense gradient."""
    rs = np.random.default_rng(0)
    n, d, b, lr = 37, 8, 12, 1e-2
    table = rs.standard_normal((n, d)).astype(np.float32)
    jt, js = jnp.asarray(table), jadam.init_table_state(jnp.asarray(table))
    tt = _t(table)
    ts = tadam.init_table_state(tt)
    dense = _t(table).clone().requires_grad_()
    opt = torch.optim.Adam([dense], lr=lr)
    for step in range(1, 6):
        rows = _rows(rs, n, b, dup)
        g = rs.standard_normal((b, d)).astype(np.float32)
        jt, js = jadam.row_adam_update(jt, js, jnp.asarray(rows), jnp.asarray(g),
                                       jnp.asarray(step, jnp.int32), lr)
        tt, ts = tadam.row_adam_update(tt, ts, _t(rows), _t(g),
                                       torch.tensor(step, dtype=torch.int32), lr)
        dense.grad = torch.zeros(n, d).index_add_(0, _t(rows).long(), _t(g))
        opt.step()
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **P_TOL)
        np.testing.assert_allclose(tt.numpy(), dense.detach().numpy(), **P_TOL)
    adam = opt.state[dense]
    np.testing.assert_allclose(ts.m.numpy(), np.asarray(js.m), **P_TOL)
    np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v), **V_TOL)
    np.testing.assert_allclose(ts.m.numpy(), adam["exp_avg"].numpy(), **P_TOL)
    np.testing.assert_allclose(ts.v.numpy(), adam["exp_avg_sq"].numpy(), **V_TOL)


def test_zero_rows_pure_decay():
    """Rows hit with a zero gradient keep moving on their momentum; rows
    never touched stay at their initial values."""
    rs = np.random.default_rng(1)
    table = _t(rs.standard_normal((10, 4)).astype(np.float32))
    state = tadam.init_table_state(table)
    rows = torch.tensor([0, 1], dtype=torch.int32)
    g = _t(rs.standard_normal((2, 4)).astype(np.float32))
    t1, s1 = tadam.row_adam_update(table, state, rows, g, torch.tensor(1, dtype=torch.int32), 1e-2)
    t2, _ = tadam.row_adam_update(t1, s1, rows, torch.zeros_like(g),
                                  torch.tensor(2, dtype=torch.int32), 1e-2)
    assert not torch.allclose(t2[:2], t1[:2])
    assert torch.equal(t2[2:], table[2:])


def test_bf16_storage_matches_jax_and_tracks_fp32():
    """bf16 tables and moments, fp32 math: within one bf16 ulp of the JAX
    package's bf16 run at every step, bf16 end to end, and within 1% of
    the largest entry of the fp32 run after five steps (the JAX package's
    bound, tests/test_indexed_adam.py)."""
    rs = np.random.default_rng(7)
    t32 = _t(rs.standard_normal((64, 16)).astype(np.float32))
    t16 = t32.to(torch.bfloat16)
    j16 = jnp.asarray(t32.numpy()).astype(jnp.bfloat16)
    s32, s16, js16 = (tadam.init_table_state(t32), tadam.init_table_state(t16),
                      jadam.init_table_state(j16))
    for step in range(1, 6):
        rows = rs.integers(0, 64, 32).astype(np.int32)
        g = rs.standard_normal((32, 16)).astype(np.float32)
        count = torch.tensor(step, dtype=torch.int32)
        t32, s32 = tadam.row_adam_update(t32, s32, _t(rows), _t(g), count, 1e-2)
        t16, s16 = tadam.row_adam_update(t16, s16, _t(rows), _t(g), count, 1e-2)
        j16, js16 = jadam.row_adam_update(j16, js16, jnp.asarray(rows), jnp.asarray(g),
                                          jnp.asarray(step, jnp.int32), 1e-2)
        for got, want in ((t16, j16), (s16.m, js16.m), (s16.v, js16.v)):
            assert bf16_ulps(got, _t(np.asarray(want.astype(jnp.float32)))) <= 1.0
    assert t16.dtype == s16.m.dtype == s16.v.dtype == torch.bfloat16
    np.testing.assert_allclose(t16.float().numpy(), t32.numpy(), rtol=0,
                               atol=0.01 * float(t32.abs().max()))


@pytest.mark.parametrize("dup", [False, True])
def test_prepare_sorted_rows_matches_jax(dup):
    rs = np.random.default_rng(3)
    n, d, b = 50, 6, 24
    rows = _rows(rs, n, b, dup)
    g = rs.standard_normal((b, d)).astype(np.float32)
    jr, jg = jrow.prepare_sorted_rows(jnp.asarray(rows), jnp.asarray(g), n)
    tr, tg = trow.prepare_sorted_rows(_t(rows), _t(g), n)
    assert tr.dtype == torch.int32 and tg.dtype == torch.float32
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)
    n_distinct = len(set(rows.tolist()))
    assert (tr[:n_distinct] < n).all() and (tr[n_distinct:] == n).all()
    assert torch.equal(tg[n_distinct:], torch.zeros(b - n_distinct, d))


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("shape", [(40, 128), (37, 256)])
def test_fused_row_adam_matches_jax_kernel(dup, shape):
    """The port's fused_row_adam on the CPU (its plain version) against the
    JAX Pallas kernel in interpret mode, four steps, as
    tests/test_pallas_row_adam.py runs it."""
    rs = np.random.default_rng(0)
    n, d = shape
    b, lr = 16, 1e-2
    table = rs.standard_normal((n, d)).astype(np.float32)
    jt, jm, jv = jnp.asarray(table), jnp.zeros((n, d)), jnp.zeros((n, d))
    tt, tm, tv = _t(table).clone(), torch.zeros(n, d), torch.zeros(n, d)
    for step in range(1, 5):
        rows = _rows(rs, n, b, dup)
        g = rs.standard_normal((b, d)).astype(np.float32)
        r_s, g_s = jrow.prepare_sorted_rows(jnp.asarray(rows), jnp.asarray(g), n)
        jt, jm, jv = jrow.fused_row_adam(jt, jm, jv, r_s, g_s, jnp.asarray(step, jnp.int32),
                                         lr, interpret=True)
        tr, tg = trow.prepare_sorted_rows(_t(rows), _t(g), n)
        trow.fused_row_adam(tt, tm, tv, tr, tg, torch.tensor(step, dtype=torch.int32), lr)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **P_TOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **P_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **V_TOL)


def test_table_adam_update_on_cpu_is_row_adam_update():
    rs = np.random.default_rng(4)
    table = _t(rs.standard_normal((30, 5)).astype(np.float32))
    rows = _t(_rows(rs, 30, 9, True))
    g = _t(rs.standard_normal((9, 5)).astype(np.float32))
    count = torch.tensor(3, dtype=torch.int32)
    state = tadam.TableOptState(torch.rand(30, 5), torch.rand(30, 5))
    got = tadam.table_adam_update(table, state, rows, g, count, 1e-3)
    want = tadam.row_adam_update(table, state, rows, g, count, 1e-3)
    for a, w in zip((got[0], *got[1]), (want[0], *want[1])):
        assert torch.equal(a, w)


@pytest.mark.parametrize("case", ["dtype", "moment", "rows", "grad", "count", "layout"])
def test_check_args_refuses(case):
    """What the kernel does not take is refused before any launch."""
    n, d, b = 20, 8, 4
    args = dict(table=torch.zeros(n, d), m=torch.zeros(n, d), v=torch.zeros(n, d),
                rows_sorted=torch.arange(b, dtype=torch.int32), g_agg=torch.zeros(b, d),
                count=torch.ones((), dtype=torch.int32))
    trow.check_args(**args)
    if case == "dtype":
        args.update(table=torch.zeros(n, d, dtype=torch.float16))
    elif case == "moment":
        args.update(m=torch.zeros(n, d, dtype=torch.bfloat16))
    elif case == "rows":
        args.update(rows_sorted=torch.arange(b))
    elif case == "grad":
        args.update(g_agg=torch.zeros(b, d + 1))
    elif case == "count":
        args.update(count=torch.ones((), dtype=torch.int64))
    elif case == "layout":
        args.update(v=torch.zeros(d, n).T)
    with pytest.raises((TypeError, ValueError)):
        trow.check_args(**args)


# (N, D, bytes an element, blocks an SM holds, expected (rows a block,
# blocks) on 132 SMs): FREEDOM's v_feat and t_feat in fp32 (78 registers: 3
# blocks an SM) and bf16 (60: 4), a one-wide table and D 13 (the scalar
# route, 40: 6), a short table and one row
@pytest.mark.parametrize("n,d,size,resident,want", [
    (15207, 4096, 4, 3, (1, 15207)), (15207, 4096, 2, 4, (2, 7604)),
    (15207, 384, 4, 3, (10, 1521)), (15207, 384, 2, 4, (29, 525)),
    (15207, 1, 4, 6, (20, 761)), (15207, 13, 2, 6, (20, 761)), (777, 384, 2, 4, (2, 389)),
    (1, 8192, 4, 3, (1, 1))])
def test_tile_rows_cover_every_row(n, d, size, resident, want):
    """tile_rows covers every row once in whole rows, stays within the
    shared row map and gives the layout the kernel was timed at; a grid of
    fewer than FEW_WAVES waves ends in a wave at least half full."""
    rows = trow.tile_rows(n, d, size, 132, resident)
    blocks = -(-n // rows)
    assert (rows, blocks) == want
    assert 1 <= rows <= trow.MAX_TILE_ROWS
    assert blocks * rows >= n and (blocks - 1) * rows < n
    slots = 132 * resident
    if n >= slots and blocks < trow.FEW_WAVES * slots:
        assert blocks % slots == 0 or blocks % slots >= slots / 2
    covered = np.zeros(n, np.int64)
    for blk in range(blocks):
        covered[blk * rows:min((blk + 1) * rows, n)] += 1
    assert (covered == 1).all()


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/row_adam.cu has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1000, 4096), (777, 384), (301, 13), (64, 8)])
def test_cuda_kernel_matches_plain(dtype, shape):
    """Three steps of the kernel path (table_adam_update on the card)
    against row_adam_update on the card, each from equal tables and
    moments (a bf16 value rounded to the other neighbour in one step would
    grow by cancellation in the next), with duplicates, rows 0 and N-1,
    tile edges and sentinel padding; D 13 takes the scalar form. fp32 to
    the module's tolerances; bf16 to one bf16 ulp on top of them (the
    kernel's fma and the order of duplicate rows' sums differ from the
    plain version in fp32, and a nearly cancelled moment is small enough
    for that to pass its ulp)."""
    _on_card()
    rs = np.random.default_rng(5)
    n, d = shape
    p = torch.from_numpy(rs.standard_normal(shape).astype(np.float32)).cuda().to(dtype)
    state = tadam.init_table_state(p)
    plain_p, plain_state = p.clone(), tadam.init_table_state(p)
    for step in range(1, 4):
        rows = np.concatenate([[0, n - 1, n - 1, n // 2], _rows(rs, n, 60, step == 2)])
        rows = torch.from_numpy(rows.astype(np.int32)).cuda()
        g = torch.from_numpy(rs.standard_normal((rows.shape[0], d)).astype(np.float32)).cuda()
        count = torch.tensor(step, dtype=torch.int32, device="cuda")
        before = trow.fused_row_adam.launches
        p, state = tadam.table_adam_update(p, state, rows, g, count, 1e-2)
        torch.cuda.synchronize()
        assert trow.fused_row_adam.launches == before + 1
        plain_p, plain_state = tadam.row_adam_update(plain_p, plain_state, rows, g, count, 1e-2)
        for got, want, tol in ((p, plain_p, P_TOL), (state.m, plain_state.m, P_TOL),
                               (state.v, plain_state.v, V_TOL)):
            ulps = 1.0 if dtype == torch.bfloat16 else 0.0
            bound = tol["atol"] + tol["rtol"] * want.float().abs() + ulps * bf16_ulp(got, want)
            assert ((got.float() - want.float()).abs() <= bound).all()
            got.copy_(want)  # the next step starts from equal tables and moments


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [384, 13])
def test_cuda_kernel_at_full_height(dtype, d):
    """fused_row_adam against row_adam_reference on a 15207-row table:
    t_feat's width (16-byte vectors) and D 13 (the
    scalar route), 2048 raw rows with duplicates, rows 0 and N-1 and
    sentinel padding, one step from equal tables, to the module's
    tolerances (bf16: one bf16 ulp on top)."""
    _on_card()
    rs = np.random.default_rng(d)
    n = 15207
    p = torch.from_numpy(rs.standard_normal((n, d)).astype(np.float32)).cuda().to(dtype)
    m = (torch.from_numpy(rs.random((n, d)).astype(np.float32)).cuda() * 1e-3).to(dtype)
    v = (torch.from_numpy(rs.random((n, d)).astype(np.float32)).cuda() * 1e-6).to(dtype)
    raw = np.concatenate([[0, n - 1, n - 1], rs.integers(0, n, 2045)]).astype(np.int32)
    g = torch.from_numpy(rs.standard_normal((2048, d)).astype(np.float32)).cuda()
    rows, g_agg = trow.prepare_sorted_rows(torch.from_numpy(raw).cuda(), g, n)
    assert (rows == n).any()  # sentinel padding
    count = torch.tensor(3, dtype=torch.int32, device="cuda")
    want = [t.clone() for t in (p, m, v)]
    trow.row_adam_reference(*want, rows, g_agg, count, 1e-3)
    before = trow.fused_row_adam.launches
    trow.fused_row_adam(p, m, v, rows, g_agg, count, 1e-3)
    torch.cuda.synchronize()
    assert trow.fused_row_adam.launches == before + 1
    ulps = 1.0 if dtype == torch.bfloat16 else 0.0
    for got, w, tol in ((p, want[0], P_TOL), (m, want[1], P_TOL), (v, want[2], V_TOL)):
        bound = tol["atol"] + tol["rtol"] * w.float().abs() + ulps * bf16_ulp(got, w)
        assert ((got.float() - w.float()).abs() <= bound).all()
