"""ops/fused_attn.py against chaorec_tpu/ops/pallas_attn.py.

Inputs are made with numpy from a seed and handed to both packages. Values
at keep 1.0 are held to the JAX package's own tolerance for its kernel
(tests/test_pallas_attn.py): rtol = atol = 2e-5 in fp32, and 3e-5 for the
gradients. The two packages draw different dropout streams (the TPU's
hardware PRNG against Philox), so at keep 0.5 the port is held to the
distribution of its mask and to the dense formula under its own mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chaorec_tpu.ops import pallas_attn as jattn
from chaorec_tpu_torch.ops import fused_attn

SHAPES = [(2, 3, 70, 70, 4), (2, 3, 300, 130, 4), (1, 4, 1034, 1034, 4)]
GRAD_SHAPES = [(1, 2, 90, 50, 4), (2, 3, 70, 70, 4)]
TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=3e-5, atol=3e-5)
# Random123's known-answer vectors for Philox4x32-10: (counter, key, output).
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def _qkv(shape, seed=0):
    b, h, lq, lk, dh = shape
    rs = np.random.default_rng(seed)
    return [rs.standard_normal(s).astype(np.float32)
            for s in ((b, h, lq, dh), (b, h, lk, dh), (b, h, lk, dh))]


def _philox_python(ctr, key):
    """Philox4x32-10 on Python ints: an independent statement of the mask's
    generator, for the int64 torch version to be held to."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    m32 = 0xFFFFFFFF
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = (p1 >> 32) ^ c1 ^ k0, p1 & m32, (p0 >> 32) ^ c3 ^ k1, p0 & m32
        k0, k1 = (k0 + 0x9E3779B9) & m32, (k1 + 0xBB67AE85) & m32
    return c0, c1, c2, c3


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_jax_reference(shape):
    q, k, v = _qkv(shape)
    got = fused_attn.mha_reference(*map(torch.from_numpy, (q, k, v))).numpy()
    want = np.asarray(jattn.mha_reference(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_cpu_fused_mha_matches_pallas_interpret(shape):
    """The TPU kernel in interpret mode, at keep 1.0, against the port's
    fused_mha on CPU tensors (which takes the plain path)."""
    q, k, v = _qkv(shape, seed=1)
    got = fused_attn.fused_mha(*map(torch.from_numpy, (q, k, v)), 0).numpy()
    want = np.asarray(jattn.fused_mha(*map(jnp.asarray, (q, k, v)),
                                      jnp.zeros((1,), jnp.int32), 1.0, True))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape", GRAD_SHAPES)
def test_grads_match_pallas_interpret(shape):
    """jax.grad through the TPU kernel's VJP (interpret mode) against torch
    autograd through the port's fused_mha, for a weighted sum of the output."""
    q, k, v = _qkv(shape, seed=3)
    w = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    seed = jnp.zeros((1,), jnp.int32)
    want = jax.grad(lambda *a: jnp.sum(jattn.fused_mha(*a, seed, 1.0, True) * w),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    (fused_attn.fused_mha(*leaves, 0) * torch.from_numpy(w)).sum().backward()
    for name, t, j in zip("qkv", leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), err_msg=name, **GRAD_TOL)


def test_cpu_tensors_take_the_plain_path():
    q, k, v = map(torch.from_numpy, _qkv(SHAPES[1], seed=2))
    before = fused_attn.fused_mha.launches
    got = fused_attn.fused_mha(q, k, v, seed=7)
    assert torch.equal(got, fused_attn.mha_reference(q, k, v))
    assert torch.equal(fused_attn.fused_mha(q, k, v, 7, 0.5),
                       fused_attn.mha_reference(q, k, v, 7, 0.5))
    assert fused_attn.fused_mha.launches == before


@pytest.mark.parametrize("keep", [0.0, -0.5, 1.5])
def test_keep_prob_outside_unit_interval_is_refused(keep):
    q, k, v = map(torch.from_numpy, _qkv(SHAPES[0]))
    with pytest.raises(ValueError):
        fused_attn.fused_mha(q, k, v, seed=0, keep_prob=keep)


@pytest.mark.parametrize("case", range(len(PHILOX_KAT)))
def test_philox_known_answers(case):
    ctr, key, want = PHILOX_KAT[case]
    got = fused_attn.philox4x32(*(torch.tensor(c) for c in ctr), *(torch.tensor(x) for x in key))
    assert tuple(int(w) for w in got) == want
    assert _philox_python(ctr, key) == want


def test_philox_int64_matches_python_ints():
    rs = np.random.default_rng(5)
    ctr = rs.integers(0, 2 ** 32, (4, 200), dtype=np.int64)
    key = rs.integers(0, 2 ** 32, (2, 200), dtype=np.int64)
    got = fused_attn.philox4x32(*map(torch.from_numpy, ctr), *map(torch.from_numpy, key))
    got = torch.stack(got, dim=1).numpy()
    want = [_philox_python(tuple(ctr[:, n].tolist()), tuple(key[:, n].tolist()))
            for n in range(200)]
    np.testing.assert_array_equal(got, np.array(want, np.int64))


def test_mask_is_philox_of_seed_group_row_and_key():
    """Bit (g, i, j) is word j % 4 of Philox((j // 4, i, g, 0), (seed, 0)),
    whichever slice of groups it is drawn in."""
    seed, keep = 123, 0.5
    mask = fused_attn.dropout_mask(seed, 5, 9, 11, keep)
    thresh = fused_attn.keep_threshold(keep)
    for g, i, j in [(0, 0, 0), (4, 8, 10), (2, 3, 7), (1, 6, 4)]:
        word = _philox_python((j // 4, i, g, 0), (seed, 0))[j % 4]
        assert bool(mask[g, i, j]) == (word < thresh), (g, i, j)
    assert torch.equal(fused_attn.dropout_mask(seed, 2, 9, 11, keep, first_group=3), mask[3:])


@pytest.mark.parametrize("keep", [0.5, 0.2])
def test_mask_mean_within_4_sigma(keep):
    mask = fused_attn.dropout_mask(7, 16, 64, 67, keep)
    n = mask.numel()
    sigma = (keep * (1 - keep) / n) ** 0.5
    assert abs(mask.double().mean().item() - keep) < 4 * sigma


def test_mask_depends_on_seed():
    a = fused_attn.dropout_mask(1, 4, 32, 32, 0.5)
    assert torch.equal(a, fused_attn.dropout_mask(1, 4, 32, 32, 0.5))
    for other in (2, 2 ** 32 + 1, -1):
        b = fused_attn.dropout_mask(other, 4, 32, 32, 0.5)
        assert abs((a == b).double().mean().item() - 0.5) < 0.05, other


@pytest.mark.parametrize("axis", ["g", "i", "j"])
def test_mask_coordinates_change_bits_independently(axis):
    """Moving one of (g, i, j) by one, the bits agree with the old ones half
    of the time (to 4 sigma), as independent draws do."""
    m = fused_attn.dropout_mask(11, 8, 64, 64, 0.5)
    a, b = {"g": (m[1:], m[:-1]), "i": (m[:, 1:], m[:, :-1]),
            "j": (m[..., 1:], m[..., :-1])}[axis]
    agree = (a == b).double().mean().item()
    assert abs(agree - 0.5) < 4 * (0.25 / a.numel()) ** 0.5, agree


def test_dropout_output_is_the_dense_formula_under_its_mask():
    q, k, v = map(torch.from_numpy, _qkv((2, 3, 50, 41, 4), seed=6))
    got = fused_attn.fused_mha(q, k, v, seed=9, keep_prob=0.5)
    keep = fused_attn.dropout_mask(9, 6, 50, 41, 0.5).view(2, 3, 50, 41)
    a = torch.softmax(q @ k.transpose(-1, -2) / 2.0, dim=-1)
    want = (a * keep * 2.0) @ v
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert not torch.allclose(got, fused_attn.mha_reference(q, k, v), atol=1e-3)


def test_dropout_grad_regenerates_the_mask():
    """out is linear in v, so sum(out(v)) == <d sum(out) / dv, v> holds only
    if the backward saw the forward's mask (tests/test_pallas_attn.py)."""
    q, k, v = map(torch.from_numpy, _qkv((1, 2, 64, 64, 4), seed=7))
    v.requires_grad_(True)
    out = fused_attn.fused_mha(q, k, v, seed=3, keep_prob=0.5)
    (g,) = torch.autograd.grad(out.sum(), v)
    np.testing.assert_allclose(float((g * v.detach()).sum()), float(out.detach().sum()), rtol=1e-4)


@pytest.mark.parametrize("keep", [1.0, 0.5])
def test_backward_formula_of_the_kernels(keep):
    """What csrc/fused_mha_bwd.cu computes, written with dense tensors (P from
    the log-sum-exp, D the mask, delta = dO . O), against autograd of the
    plain version (mha_reference_grads), the kernel's oracle on the card."""
    q, k, v, dout = map(torch.from_numpy, _qkv((2, 3, 37, 29, 4), seed=8) +
                        _qkv((2, 3, 37, 29, 4), seed=9)[:1])
    seed = 17
    out = fused_attn.mha_reference(q, k, v, seed, keep)
    s = q @ k.transpose(-1, -2) / 2.0
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    d = torch.ones_like(p) if keep == 1.0 else \
        fused_attn.dropout_mask(seed, 6, 37, 29, keep).view(p.shape) / keep
    delta = (dout * out).sum(-1, keepdim=True)
    ds = p * (d * (dout @ v.transpose(-1, -2)) - delta)
    want = (ds @ k / 2.0, ds.transpose(-1, -2) @ q / 2.0, (p * d).transpose(-1, -2) @ dout)
    got = fused_attn.mha_reference_grads(q, k, v, dout, seed, keep)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=name)


@pytest.mark.parametrize("lk", [1, 31, 32, 33, 70])
def test_pack_keep_bits_layout(lk):
    """Bit j % 32 of word j // 32 of row (g, i) is the keep bit of weight
    (g, i, j), as Philox draws it; the bits past Lk are 0."""
    seed, keep = 77, 0.5
    words = fused_attn.pack_keep_bits(fused_attn.dropout_mask(seed, 2, 3, lk, keep))
    assert words.shape == (2, 3, -(-lk // 32)) and words.dtype == torch.int32
    thresh = fused_attn.keep_threshold(keep)
    for g in range(2):
        for i in range(3):
            for w in range(words.shape[2]):
                word = int(words[g, i, w]) & 0xFFFFFFFF
                for bit in range(32):
                    j = 32 * w + bit
                    want = j < lk and _philox_python((j // 4, i, g, 0), (seed, 0))[j % 4] < thresh
                    assert (word >> bit) & 1 == want, (g, i, j)


@pytest.mark.parametrize("case", ["dtype", "contiguity", "alignment", "shape", "dh",
                                  "device", "empty", "dout"])
def test_wrapper_checks_reject_bad_inputs(case):
    """The checks the CUDA wrappers run before any launch; they need no card."""
    q, k, v = map(torch.from_numpy, _qkv((1, 2, 8, 8, 4)))
    extra = {}
    if case == "dtype":
        q = q.double()
    elif case == "contiguity":
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "alignment":  # contiguous, but one float past an aligned start
        q = torch.empty(q.numel() + 1)[1:].view(q.shape).copy_(q)
    elif case == "shape":
        v = v[:, :, :5]
    elif case == "dh":
        q, k, v = (t.repeat(1, 1, 1, 2) for t in (q, k, v))
    elif case == "device":
        k = k.to("meta")
    elif case == "empty":
        q = q[:, :, :0]
    elif case == "dout":
        extra = {"dout": q[:, :, :4].contiguous()}
    with pytest.raises((TypeError, ValueError)):
        fused_attn._check(q, k, v, **extra)


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/fused_mha*.cu have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernel_matches_reference(shape):
    _on_card()
    q, k, v = (torch.from_numpy(t).cuda() for t in _qkv(shape, seed=3))
    before = fused_attn.fused_mha.launches
    got = fused_attn.fused_mha(q, k, v, 0)
    torch.cuda.synchronize()
    assert fused_attn.fused_mha.launches == before + 1
    torch.testing.assert_close(got, fused_attn.mha_reference(q, k, v), rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_dropout_forward_matches_reference(shape):
    _on_card()
    q, k, v = (torch.from_numpy(t).cuda() for t in _qkv(shape, seed=4))
    seed = torch.tensor([12345], device="cuda")
    got = fused_attn.fused_mha(q, k, v, seed, 0.5)
    torch.testing.assert_close(got, fused_attn.mha_reference(q, k, v, seed, 0.5),
                               rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("keep", [1.0, 0.5])
@pytest.mark.parametrize("shape", SHAPES[:2] + GRAD_SHAPES)
def test_cuda_backward_matches_autograd_of_reference(shape, keep):
    """Relative to the largest gradient entry: 1e-5 (fp32 sums over up to
    1034 terms in another order)."""
    _on_card()
    q, k, v = (torch.from_numpy(t).cuda().requires_grad_() for t in _qkv(shape, seed=5))
    dout = torch.from_numpy(_qkv(shape, seed=6)[0]).cuda()
    fwd, bwd = fused_attn.fused_mha.launches, fused_attn.fused_mha_bwd.launches
    got = torch.autograd.grad(fused_attn.fused_mha(q, k, v, 99, keep), (q, k, v), dout)
    torch.cuda.synchronize()
    assert (fused_attn.fused_mha.launches, fused_attn.fused_mha_bwd.launches) == (fwd + 1, bwd + 1)
    want = fused_attn.mha_reference_grads(q, k, v, dout, 99, keep)
    for name, a, b in zip("qkv", got, want):
        err = (a - b).abs().max().item() / b.abs().max().item()
        assert err <= 1e-5, (name, err)


# B = 1 (CF_Diff's serving batch; 1 query row a thread) at ragged Lq and
# Lk, 4100 keys passing the 4096 the forward stages at once so its tile
# loop runs; and 32 users, where 128 groups of 11 warps fill 8 warps on
# each of up to 176 SMs and 11 x 96 rows are within 5% of Lq, so the
# forward runs 3 rows a thread (as at CF_Diff's training and export
# batches) over a ragged last warp.
RAGGED_CARD = ([(1, 4, lq, lk, 4) for lq in (1, 129, 257, 1034)
                for lk in (1, 3, 5, 513, 1034, 4100)]
               + [(32, 4, 1034, 5, 4), (32, 4, 1010, 1034, 4), (32, 4, 1034, 4100, 4)])


@pytest.mark.cuda
@pytest.mark.parametrize("keep", [1.0, 0.5])
@pytest.mark.parametrize("shape", RAGGED_CARD)
def test_cuda_forward_and_lse_at_ragged_shapes(shape, keep):
    """out within 1e-5 of mha_reference under the same mask, and lse within
    1e-5 of the plain log-sum-exp of the scaled scores (|lse| is below 12
    here, so 1e-5 is ~100 fp32 ulps of it; the backward reads it)."""
    _on_card()
    q, k, v = (torch.from_numpy(t).cuda() for t in _qkv(shape, seed=shape[2] + shape[3]))
    seed = torch.tensor([2024], device="cuda")
    seed_t = seed if keep < 1.0 else None
    before = fused_attn.fused_mha.launches
    out, lse = fused_attn._launch_fwd(q, k, v, seed_t, keep, with_lse=True)
    torch.cuda.synchronize()
    assert fused_attn.fused_mha.launches == before + 1
    torch.testing.assert_close(out, fused_attn.mha_reference(q, k, v, seed, keep),
                               rtol=0, atol=1e-5)
    want = torch.logsumexp(torch.einsum("bhqd,bhkd->bhqk", q, k) / 2.0, dim=-1)
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("keep", [1.0, 0.5])
@pytest.mark.parametrize("shape", RAGGED_CARD)
def test_cuda_backward_at_ragged_shapes(shape, keep):
    """dq, dk and dv within 1e-5 of the largest entry of each plain gradient
    (autograd of mha_reference under the same mask), at B = 1 with 1 query
    row a thread and at 32 users with 3, ragged Lq and Lk, and 4100 keys
    past the 4096 the dq kernel stages at once. At Lk = 1 the weight is 1
    and dq is 0 exactly; a gradient that is 0 throughout is held to 1e-5 of
    the largest entry of the three."""
    _on_card()
    q, k, v = (torch.from_numpy(t).cuda().requires_grad_()
               for t in _qkv(shape, seed=shape[2] + 2 * shape[3]))
    dout = torch.from_numpy(_qkv(shape, seed=shape[3])[0]).cuda()
    seed = torch.tensor([31337], device="cuda")
    before = fused_attn.fused_mha_bwd.launches
    got = torch.autograd.grad(fused_attn.fused_mha(q, k, v, seed, keep), (q, k, v), dout)
    torch.cuda.synchronize()
    assert fused_attn.fused_mha_bwd.launches == before + 1
    want = fused_attn.mha_reference_grads(q, k, v, dout, seed, keep)
    largest = max(b.abs().max().item() for b in want)
    for name, a, b in zip("qkv", got, want):
        assert torch.isfinite(a).all(), name
        err = (a - b).abs().max().item() / (b.abs().max().item() or largest)
        assert err <= 1e-5, (name, err)


def _bwd_inputs(shape, keep, seed=7):
    """q, k, v, out, dout and lse of one forward on the card."""
    q, k, v = (torch.from_numpy(t).cuda() for t in _qkv(shape, seed=seed))
    dout = torch.from_numpy(_qkv(shape, seed=seed + 1)[0]).cuda()
    seed_t = torch.tensor([4242], device="cuda")
    out, lse = fused_attn._launch_fwd(q, k, v, seed_t if keep < 1.0 else None, keep,
                                      with_lse=True)
    return q, k, v, out, dout, lse, seed_t


@pytest.mark.cuda
@pytest.mark.parametrize("keep", [1.0, 0.5])
def test_cuda_backward_twice_gives_the_same_bits(keep):
    """No atomics: two backward calls on the same inputs agree bit for bit."""
    _on_card()
    args = _bwd_inputs((3, 4, 300, 1034, 4), keep)
    first = fused_attn._launch_bwd(*args, keep)
    second = fused_attn._launch_bwd(*args, keep)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv", "bits"), first, second):
        assert (a is None and b is None and keep == 1.0) or torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 70, 45, 4), (1, 4, 129, 1034, 4)])
def test_cuda_keep_bits_scratch_is_the_mask(shape):
    """The bits the dq kernel writes for the dk/dv kernel, at Lk % 32 != 0,
    are the forward's mask (dropout_mask) in pack_keep_bits' layout, zero
    past Lk; at keep 1 there is no scratch."""
    _on_card()
    b, h, lq, lk, _ = shape
    args = _bwd_inputs(shape, 0.5)
    bits = fused_attn._launch_bwd(*args, 0.5)[3]
    torch.cuda.synchronize()
    mask = fused_attn.dropout_mask(args[-1], b * h, lq, lk, 0.5, device="cuda")
    assert torch.equal(bits, fused_attn.pack_keep_bits(mask))
    unpacked = (bits.to(torch.int64)[..., None] >> torch.arange(32, device="cuda")) & 1
    assert torch.equal(unpacked.reshape(b * h, lq, -1)[..., :lk].bool(), mask)
    assert fused_attn._launch_bwd(*_bwd_inputs(shape, 1.0), 1.0)[3] is None
