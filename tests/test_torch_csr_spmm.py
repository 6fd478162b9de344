"""ops/csr_spmm.py and the segment graph's CSRs (graphs/norm_adj.py).

The CSR gather-sum keeps the order in which the segment graph's scatter adds
(``index_add_`` of the messages, and the gather's backward, ``index_put_``
with accumulate): per destination, its messages in ascending position of the
message array, from 0. So its sums equal that scatter's bit for bit, and
every comparison here is ``torch.equal``.

On the CPU: the four CSRs ``build_norm_adj`` builds against the stable sort
of each scatter's destinations, on edges that are not sorted by user (so
that apply_r's gradient order differs from the item order) and on edges
that are (so that each gradient's CSR holds the other direction's order);
the row pointers and the longest-first row order, empty rows included;
``stable_order`` against numpy's stable argsort; the segment path's
``apply_r`` and ``apply_rt`` (on the CPU, ``csr_apply``'s plain path)
against the parent path's forward and input gradient; the wrapper's
refusals. On the
card (``-m cuda``): the kernel against the parent path under the
deterministic mode at the microlens and electronics catalogs
(``chip_smoke.catalog_dataset``), at both compute dtypes, at D 64 and 45,
the electronics item side holding rows of over 10 k edges; two runs' bits;
a 3-layer LightGCN step's 12 launches; an input off the two-element
alignment and an odd D.
"""

import numpy as np
import pytest
import torch

from chaorec_tpu_torch.graphs import norm_adj as tnorm
from chaorec_tpu_torch.ops import csr_spmm as tcsr
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

DTYPES = ["float32", "bfloat16"]


def _edges(seed=0, num_user=70, num_item=40, n=900, user_sorted=False):
    """Edges with duplicates, a hot item (a third of the edges), and the
    last user and item with no edge; in a random order, or sorted by
    (user, item)."""
    rs = np.random.default_rng(seed)
    u = rs.integers(0, num_user - 1, n)
    i = np.where(rs.random(n) < 0.33, 3, rs.integers(0, num_item - 1, n))
    e = np.stack([u, i], 1).astype(np.int32)
    if user_sorted:
        e = e[np.lexsort((e[:, 1], e[:, 0]))]
    return e, num_user, num_item


def _graph(user_sorted=False, dtype="float32", seed=0):
    edges, nu, ni = _edges(seed, user_sorted=user_sorted)
    return tnorm.build_norm_adj(edges, nu, ni, "cpu", use_dense=False, compute_dtype=dtype)


def _by_row(csr: tcsr.Csr):
    """Each output row's (src, w) sequence, as numpy arrays by row id."""
    ptr, rows = csr.ptr.numpy(), csr.rows.numpy()
    out = {}
    for t, r in enumerate(rows):
        out[int(r)] = (csr.src.numpy()[ptr[t]:ptr[t + 1]], csr.w.numpy()[ptr[t]:ptr[t + 1]])
    return out


def _scatter_order(dst, src, w, n_rows):
    """Each destination's (src, w) in the order a scatter over the message
    positions adds them: the stable sort of ``dst``."""
    perm = np.argsort(dst, kind="stable")
    ds, ss, ws = dst[perm], src[perm], w[perm]
    return {r: (ss[ds == r], ws[ds == r]) for r in range(n_rows)}


def _csrs(g):
    """(name, CSR, its scatter's destinations, sources, weights, rows)."""
    uu, iu, wu = (t.numpy() for t in (g.u_by_u, g.i_by_u, g.w_by_u))
    ui, ii, wi = (t.numpy() for t in (g.u_by_i, g.i_by_i, g.w_by_i))
    return [("csr_r", g.csr_r, uu, iu, wu, g.num_user),
            ("csr_r_grad", g.csr_r_grad, iu, uu, wu, g.num_item),
            ("csr_rt", g.csr_rt, ii, ui, wi, g.num_item),
            ("csr_rt_grad", g.csr_rt_grad, ui, ii, wi, g.num_user)]


@pytest.mark.parametrize("user_sorted", [False, True])
def test_csr_orders_equal_the_scatters_stable_sort(user_sorted):
    """Each CSR's rows hold the stable sort of its scatter's destinations
    over the message positions: apply_r's messages are the user-sorted
    edges, apply_rt's the item-sorted ones, and each gradient scatters the
    same messages to their sources. On unsorted edges apply_r's gradient
    order is not the item order; on edges sorted by (user, item) each
    gradient's CSR holds the other direction's forward CSR."""
    g = _graph(user_sorted)
    for name, csr, dst, src, w, n_rows in _csrs(g):
        assert csr.n_rows == n_rows and csr.src.dtype == torch.int32, name
        got, want = _by_row(csr), _scatter_order(dst, src, w, n_rows)
        assert sorted(got) == list(range(n_rows)), name
        for r in range(n_rows):
            np.testing.assert_array_equal(got[r][0], want[r][0], err_msg=f"{name} row {r}")
            np.testing.assert_array_equal(got[r][1], want[r][1], err_msg=f"{name} row {r}")
    grad_order = np.argsort(g.i_by_u.numpy(), kind="stable")
    same = np.array_equal(g.u_by_u.numpy()[grad_order], g.u_by_i.numpy())
    assert same == user_sorted
    for grad, fwd in ((g.csr_r_grad, g.csr_rt), (g.csr_rt_grad, g.csr_r)):
        assert grad is not fwd
        assert all(torch.equal(getattr(grad, k), getattr(fwd, k))
                   for k in ("ptr", "rows", "src", "w")) == user_sorted


@pytest.mark.parametrize("n_keys", [1, 7, 40_000])
def test_stable_order_is_numpys_stable_argsort(n_keys):
    """The radix sort behind the CSRs and the graph's edge orders gives
    numpy's stable argsort, ties in input order, negative keys included."""
    keys = np.random.default_rng(n_keys).integers(-n_keys, n_keys, 50_000)
    np.testing.assert_array_equal(tnorm.stable_order(keys), np.argsort(keys, kind="stable"))
    np.testing.assert_array_equal(tnorm.stable_order(keys.astype(np.int32)),
                                  np.argsort(keys, kind="stable"))


def test_row_pointers_and_longest_first_order():
    """ptr rises from 0 to E by each slot's degree; rows is every output row
    once, by falling degree, ties by row id; the rows with no edge come
    last, with empty slots."""
    g = _graph()
    for name, csr, dst, _, _, n_rows in _csrs(g):
        ptr, rows = csr.ptr.numpy(), csr.rows.numpy()
        deg = np.bincount(dst, minlength=n_rows)
        assert ptr[0] == 0 and ptr[-1] == dst.shape[0] and ptr.dtype == np.int32, name
        np.testing.assert_array_equal(np.diff(ptr), deg[rows], err_msg=name)
        np.testing.assert_array_equal(rows, np.lexsort((np.arange(n_rows), -deg)), err_msg=name)
        assert deg[rows[-1]] == 0 and rows[-1] == n_rows - 1, name  # the row with no edge
    assert g.csr_rt.rows[0].item() == 3  # the hot item first


def _parent(g, fn, x, gout):
    """The parent's segment path (the gather, the product and
    ``index_add_``; its autograd's ``index_put_`` with accumulate, sorted
    under the deterministic mode on the card): the output and the input's
    gradient. At bf16 the input is read rounded and its gradient passes
    unrounded."""
    from chaorec_tpu_torch.train.loop import deterministic_mode

    if fn == "apply_r":
        n_out, dst, src, w = g.num_user, g.u_by_u, g.i_by_u, g.w_by_u
    else:
        n_out, dst, src, w = g.num_item, g.i_by_i, g.u_by_i, g.w_by_i
    xr = x.detach().clone()
    if g.compute_dtype == "bfloat16":
        xr = xr.to(torch.bfloat16).float()
    xr.requires_grad_()
    with deterministic_mode():
        out = xr.new_zeros((n_out, x.shape[1])).index_add_(0, dst, w[:, None] * xr[src])
        out.backward(gout)
    return out.detach(), xr.grad


@pytest.mark.parametrize("fn", ["apply_r", "apply_rt"])
@pytest.mark.parametrize("d", [64, 192])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_path_bit_equal_to_parent(dtype, d, fn):
    """The segment path on the CPU (``csr_apply``'s plain path: index_add_
    in the CSR's order, forward and backward) gives the parent path's
    output and input gradient bit for bit; the input is read rounded at
    bf16 and its gradient is not rounded. The item order in place of
    apply_r's gradient order gives other bits, so the order is what is
    held."""
    g = _graph(dtype=dtype, seed=d)
    rs = np.random.default_rng(d)
    n_in, n_out = (g.num_item, g.num_user) if fn == "apply_r" else (g.num_user, g.num_item)
    x0 = torch.from_numpy(rs.standard_normal((n_in, d)).astype(np.float32))
    gout = torch.from_numpy(rs.standard_normal((n_out, d)).astype(np.float32))
    want, want_grad = _parent(g, fn, x0, gout)
    x = x0.clone().requires_grad_()
    got = getattr(g, fn)(x)
    got.backward(gout)
    assert got.dtype == x.grad.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(x.grad, want_grad)
    if fn == "apply_r":
        assert not torch.equal(tcsr.csr_spmm(gout, g.csr_rt), want_grad)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    g = _graph()
    x = torch.zeros((g.num_item, 8))
    tcsr.csr_spmm(x, g.csr_r)
    tcsr.csr_spmm(x.to(torch.bfloat16), g.csr_r)
    with pytest.raises(TypeError):
        tcsr.csr_spmm(x.double(), g.csr_r)
    with pytest.raises(ValueError):
        tcsr.csr_spmm(torch.zeros((8, g.num_item)).t(), g.csr_r)  # not contiguous
    with pytest.raises(ValueError):
        tcsr.csr_spmm(torch.zeros((g.num_item + 1, 8)), g.csr_r)  # a wrong row count
    with pytest.raises(ValueError):
        tcsr.csr_spmm(torch.zeros(g.num_item), g.csr_r)  # not (n_src, D)


def test_dense_graph_has_no_csrs_and_cpu_calls_launch_nothing():
    edges, nu, ni = _edges()
    dense = tnorm.build_norm_adj(edges, nu, ni, "cpu", use_dense=True)
    assert dense.csr_r is dense.csr_rt is dense.csr_r_grad is dense.csr_rt_grad is None
    before = tcsr.csr_spmm.launches
    g = _graph()
    tcsr.csr_spmm(torch.zeros((g.num_item, 4)), g.csr_r)
    assert tcsr.csr_spmm.launches == before


# --- on the card ---------------------------------------------------------

CATALOGS = ("microlens", "electronics")


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/csr_spmm.cu has no CPU mode")


_CARD_GRAPHS = {}


def _card_graph(name, dtype):
    """The catalog's segment graph on the card (one draw a catalog)."""
    import chip_smoke

    if name not in _CARD_GRAPHS:
        ds = chip_smoke.catalog_dataset(name, 7, "cuda")
        _CARD_GRAPHS[name] = (ds.train_edges, ds.num_user, ds.num_item)
    edges, nu, ni = _CARD_GRAPHS[name]
    return tnorm.build_norm_adj(edges, nu, ni, "cuda", use_dense=False, compute_dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 45])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", CATALOGS)
def test_cuda_kernel_bits_equal_parent_at_catalogs(name, dtype, d):
    """apply_r and apply_rt on the card, forward and input gradient, equal
    the parent path's bits at the catalog's shapes; two launches a call
    (the sum, then its gradient) and no index_add_ on the way."""
    _on_card()
    g = _card_graph(name, dtype)
    if name == "electronics":
        assert int(g.csr_rt.ptr[1] - g.csr_rt.ptr[0]) > 10_000  # its hottest item
    gen = torch.Generator("cuda").manual_seed(d)
    for fn, n_in, n_out in (("apply_r", g.num_item, g.num_user),
                            ("apply_rt", g.num_user, g.num_item)):
        x = torch.randn((n_in, d), generator=gen, device="cuda").requires_grad_()
        gout = torch.randn((n_out, d), generator=gen, device="cuda")
        before = tcsr.csr_spmm.launches
        got = getattr(g, fn)(x)
        got.backward(gout)
        torch.cuda.synchronize()
        assert tcsr.csr_spmm.launches == before + 2, fn
        want, want_grad = _parent(g, fn, x, gout)
        assert torch.equal(got, want), (name, dtype, d, fn)
        assert torch.equal(x.grad, want_grad), (name, dtype, d, fn)


@pytest.mark.cuda
def test_cuda_two_runs_same_bits():
    _on_card()
    g = _card_graph("microlens", "bfloat16")
    gen = torch.Generator("cuda").manual_seed(3)
    x = torch.randn((g.num_user, 64), generator=gen, device="cuda")
    gout = torch.randn((g.num_item, 64), generator=gen, device="cuda")
    runs = []
    for _ in range(2):
        xr = x.clone().requires_grad_()
        out = g.apply_rt(xr)
        out.backward(gout)
        runs.append((out.detach(), xr.grad))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


@pytest.mark.cuda
def test_cuda_lightgcn_step_launches_twelve():
    """A 3-layer LightGCN step at microlens: 6 sums forward, 6 backward."""
    _on_card()
    from chaorec_tpu_torch.models.base import Batch
    from chaorec_tpu_torch.models.lightgcn import LightGCN

    g = _card_graph("microlens", "bfloat16")
    model = LightGCN(g.num_user, g.num_item, g, 64, 1e-3, 3)
    gen = torch.Generator("cuda").manual_seed(0)
    params = {k: v.to("cuda").requires_grad_()
              for k, v in model.init_params(torch.Generator().manual_seed(0)).items()}
    rows = torch.randint(0, g.num_edges, (1024,), generator=gen, device="cuda")
    batch = Batch(users=g.u_by_u[rows], weights=torch.ones(1024, device="cuda"),
                  pos_items=g.i_by_u[rows],
                  neg_items=torch.randint(0, g.num_item, (1024,), generator=gen, device="cuda"))
    before = tcsr.csr_spmm.launches
    model.loss(params, batch, gen).backward()
    torch.cuda.synchronize()
    assert tcsr.csr_spmm.launches == before + 12


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_misaligned_and_odd_inputs(dtype):
    """An even D reads two columns a lane from an x aligned to two
    elements, else one: an x one element off that boundary, and an odd D,
    give the plain version's bits."""
    from chaorec_tpu_torch.train.loop import deterministic_mode

    _on_card()
    g = _card_graph("microlens", "float32")
    gen = torch.Generator("cuda").manual_seed(5)
    for d in (64, 7):
        x = torch.randn((g.num_user, d), generator=gen, device="cuda").to(dtype)
        buf = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
        xm = buf[1:].view(x.shape)
        xm.copy_(x)
        with deterministic_mode():
            want = tcsr.csr_spmm_reference(x, g.csr_rt)
        assert torch.equal(tcsr.csr_spmm(x, g.csr_rt), want), d
        assert torch.equal(tcsr.csr_spmm(xm, g.csr_rt), want), d
