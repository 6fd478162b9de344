"""ops/fused_attn.py against chaorec_tpu/ops/pallas_attn.py.

Inputs are made with numpy from a seed and handed to both packages. The
tolerance is the JAX package's own for its kernel (tests/test_pallas_attn.py):
rtol = atol = 2e-5 in fp32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chaorec_tpu.ops import pallas_attn as jattn
from chaorec_tpu_torch.ops import fused_attn

SHAPES = [(2, 3, 70, 70, 4), (2, 3, 300, 130, 4), (1, 4, 1034, 1034, 4)]
TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(shape, seed=0):
    b, h, lq, lk, dh = shape
    rs = np.random.default_rng(seed)
    return [rs.standard_normal(s).astype(np.float32)
            for s in ((b, h, lq, dh), (b, h, lk, dh), (b, h, lk, dh))]


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


def test_cpu_tensors_take_the_plain_path():
    q, k, v = map(torch.from_numpy, _qkv(SHAPES[1], seed=2))
    before = fused_attn.fused_mha.launches
    got = fused_attn.fused_mha(q, k, v, seed=7)
    assert torch.equal(got, fused_attn.mha_reference(q, k, v))
    assert fused_attn.fused_mha.launches == before


def test_dropout_is_refused_until_ported():
    q, k, v = map(torch.from_numpy, _qkv(SHAPES[0]))
    with pytest.raises(NotImplementedError):
        fused_attn.fused_mha(q, k, v, seed=0, keep_prob=0.5)


@pytest.mark.parametrize("case", ["dtype", "contiguity", "alignment", "shape", "dh",
                                  "device", "empty"])
def test_wrapper_checks_reject_bad_inputs(case):
    """The checks the CUDA wrapper runs before any launch; they need no card."""
    q, k, v = map(torch.from_numpy, _qkv((1, 2, 8, 8, 4)))
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
    with pytest.raises((TypeError, ValueError)):
        fused_attn._check(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernel_matches_reference(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/fused_mha.cu has no CPU mode")
    q, k, v = (torch.from_numpy(t).cuda() for t in _qkv(shape, seed=3))
    before = fused_attn.fused_mha.launches
    got = fused_attn.fused_mha(q, k, v, 0)
    torch.cuda.synchronize()
    assert fused_attn.fused_mha.launches == before + 1
    torch.testing.assert_close(got, fused_attn.mha_reference(q, k, v), rtol=0, atol=1e-5)
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError):
        fused_attn.fused_mha(q, k, v, 0)
