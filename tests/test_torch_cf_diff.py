"""models/cf_diff.py against chaorec_tpu/models/cf_diff.py.

The JAX package's ``init_params(PRNGKey(0))`` goes through
``params.from_numpy``, so both packages score with the same weights. Scores
are float32 after 10 diffusion steps of the CAM_AE denoiser; the port holds
them to rtol 1e-4 and atol 1e-5 (what is reached is ~1e-7 absolute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chaorec_tpu.config import Config as JConfig
from chaorec_tpu.models import build_model as jbuild
from chaorec_tpu.models import cf_diff as jcf
from chaorec_tpu.ops import pallas_attn
from chaorec_tpu_torch import params as tparams
from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.models import build_model as tbuild
from chaorec_tpu_torch.models import cf_diff as tcf

# Model_YAML/CF_Diff.yaml, first combo
CFG = dict(Model="CF_Diff", steps=10, noise_scale=0.1, noise_min=5e-4, noise_max=5e-3)
TOL = dict(rtol=1e-4, atol=1e-5)


def _pair(ds, monkeypatch, width):
    monkeypatch.setattr(jcf.CF_Diff, "dim_inters", width)
    monkeypatch.setattr(tcf.CF_Diff, "dim_inters", width)
    jm = jbuild(JConfig(**CFG), ds)
    tm = tbuild(TConfig(**CFG), ds, "cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = tparams.from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    return jm, jp, tm, tp


def _scores(jm, jp, tm, tp, n):
    want = np.asarray(jm.score_users(jp, jnp.arange(n, dtype=jnp.int32)))
    got = tm.score_users(tp, torch.arange(n)).numpy()
    return got, want


def test_buffers_and_param_shapes(tiny_dataset, monkeypatch):
    jm, jp, tm, _ = _pair(tiny_dataset, monkeypatch, 64)
    np.testing.assert_array_equal(tm.x.numpy(), np.asarray(jm.x))
    np.testing.assert_allclose(tm.sec.numpy(), np.asarray(jm.sec), rtol=1e-7)
    own = tm.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert all(v.dtype == torch.float32 for v in own.values())
    assert tm.seq_len == jm.seq_len and tm.rank_mode == jm.rank_mode
    assert tm.mask_value == float(jm.mask_value) == float("-inf")
    th, tc = tm.init_state("cpu")
    jh, jc = jm.init_state(jax.random.PRNGKey(0))
    assert th.shape == jh.shape and tc.shape == jc.shape


def test_score_users_small_width(tiny_dataset, monkeypatch):
    jm, jp, tm, tp = _pair(tiny_dataset, monkeypatch, 64)
    got, want = _scores(jm, jp, tm, tp, tiny_dataset.num_user)
    np.testing.assert_allclose(got, want, **TOL)


def test_score_users_full_width(tiny_dataset, monkeypatch):
    """The published 1034-token width, for a few users."""
    jm, jp, tm, tp = _pair(tiny_dataset, monkeypatch, tcf.CF_Diff.dim_inters)
    assert tm.seq_len == 1034
    got, want = _scores(jm, jp, tm, tp, 3)
    np.testing.assert_allclose(got, want, **TOL)


def test_score_users_against_pallas_interpret(tiny_dataset, monkeypatch):
    """The JAX side through its Pallas kernel in interpret mode."""
    calls = []

    def interpret(q, k, v, seed, keep):
        calls.append(q.shape)
        return pallas_attn.fused_mha(q, k, v, seed, keep, True)

    monkeypatch.setattr(jcf, "use_fused_attn", lambda: True)
    monkeypatch.setattr(jcf, "fused_mha", interpret)
    jm, jp, tm, tp = _pair(tiny_dataset, monkeypatch, 64)
    got, want = _scores(jm, jp, tm, tp, 8)
    assert calls, "the JAX side did not reach the Pallas kernel"
    np.testing.assert_allclose(got, want, **TOL)


def test_cpu_path_micro_batches_match_one_batch(tiny_dataset, monkeypatch):
    """The CPU path's micro-batching does not change the scores."""
    _, _, tm, tp = _pair(tiny_dataset, monkeypatch, 64)
    whole = tm.score_users(tp, torch.arange(20))
    monkeypatch.setattr(tcf.CF_Diff, "micro", 7)
    np.testing.assert_allclose(tm.score_users(tp, torch.arange(20)).numpy(),
                               whole.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("state", [True, False])
def test_params_round_trip(state):
    rs = np.random.default_rng(0)
    tree = ((rs.random((3, 2), np.float32), np.arange(4, dtype=np.int32)) if state
            else {"w": rs.random((2, 5), np.float32), "b": np.zeros(5, np.float32)})
    back = tparams.to_numpy(tparams.from_numpy(tree, "cpu"))
    flat = back if state else back.values()
    want = tree if state else tree.values()
    assert type(back) is type(tree)
    for a, b in zip(flat, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
