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
