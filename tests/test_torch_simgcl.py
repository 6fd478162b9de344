"""models/simgcl.py, models/xsimgcl.py and ops/losses.info_nce against the
JAX package's.

Both packages build each model from ``tiny_dataset`` (64 users x 48 items)
at dim 16 on a float32 graph, with the combined linear operator (``build_model``'s
default) and without it (``use_linear_op: false``). The port
takes the JAX package's initial params, its batches and negatives
(``make_epoch_batches``, ``sample_negatives``) and its noise: the U[0,1)
tables the JAX loss draws from its key (``jax_noise``, repeating the JAX
split order), given to ``loss_with_noise``.

Tolerances: the loss to rtol 1e-5; every gradient to 1e-4 of its tensor's
largest entry plus 1e-6; the embeddings to rtol 1e-5, atol 1e-6;
``info_nce`` to rtol 1e-6 (float32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chaorec_tpu.ops import losses as jlosses
from chaorec_tpu_torch.models.simgcl import SimGCL
from chaorec_tpu_torch.models.xsimgcl import XSimGCL
from chaorec_tpu_torch.ops import losses as tlosses
from test_torch_lightgcn import (assert_grads_close, both_batches, jax_batches, make_pair,
                                 three_steps_match)
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

SIMGCL = dict(Model="SimGCL", batch_size=100, dim_E=16, learning_rate=0.01, reg_weight=1e-4,
              n_layers=3, ssl_temp=0.2, ssl_alpha=0.01, graph_compute_dtype="float32",
              topk=(5, 10, 20))
XSIMGCL = dict(SIMGCL, Model="XSimGCL", n_layers=2, reg_weight=0.01, ssl_alpha=0.2)
FLAGS = {"SimGCL": SIMGCL, "XSimGCL": XSIMGCL}
TOL = dict(rtol=1e-5, atol=1e-6)
CASES = [pytest.param(name, op, id=f"{name}-{'operator' if op else 'layer_stack'}")
         for name in FLAGS for op in (True, False)]


def view_noise(key, jm):
    """One view's per-layer (user, item) U[0,1) tables, as the JAX forward
    draws them from ``key`` (simgcl.py:67-71)."""
    out = []
    for _ in range(jm.n_layers):
        key, ku, ki = jax.random.split(key, 3)
        out.append((torch.from_numpy(np.array(jax.random.uniform(ku, (jm.num_user, jm.dim_E)))),
                    torch.from_numpy(np.array(jax.random.uniform(ki, (jm.num_item, jm.dim_E))))))
    return out


def jax_noise(jm, rng):
    """The noise the JAX loss draws from ``rng``: SimGCL's two views
    (``split(rng)``, simgcl.py:90), XSimGCL's one (xsimgcl.py:72)."""
    if jm.name == "SimGCL":
        k1, k2 = jax.random.split(rng)
        return view_noise(k1, jm), view_noise(k2, jm)
    return view_noise(rng, jm)


def test_info_nce_matches_jax():
    rs = np.random.default_rng(0)
    a = rs.standard_normal((12, 5)).astype(np.float32)
    b = rs.standard_normal((12, 5)).astype(np.float32)
    a[3] = 0.0  # a zero row stays finite
    w = np.ones(12, np.float32)
    w[-4:] = 0.0
    for weights in (w, None):
        got = tlosses.info_nce(torch.from_numpy(a), torch.from_numpy(b), 0.2,
                               None if weights is None else torch.from_numpy(weights))
        want = jlosses.info_nce(jnp.asarray(a), jnp.asarray(b), 0.2,
                                None if weights is None else jnp.asarray(weights))
        assert got.item() == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("name", list(FLAGS))
def test_build_goes_through_build_model(tiny_dataset, name):
    _, tm, _, _ = make_pair(tiny_dataset, FLAGS[name])
    assert isinstance(tm, {"SimGCL": SimGCL, "XSimGCL": XSimGCL}[name])
    assert type(tm).__name__ == name and tm.name == name
    f = FLAGS[name]
    assert (tm.n_layers, tm.ssl_temp, tm.ssl_reg, tm.reg_weight) == (
        f["n_layers"], f["ssl_temp"], f["ssl_alpha"], f["reg_weight"])
    assert tm.eps == {"SimGCL": 0.1, "XSimGCL": 0.2}[name]
    assert tm.linear_op is not None
    noise = tm.noise_draws(torch.Generator().manual_seed(0))
    views = noise if name == "SimGCL" else (noise,)
    assert len(views) == (2 if name == "SimGCL" else 1)
    for view in views:
        assert len(view) == tm.n_layers
        for nu, ni in view:
            assert nu.shape == (64, 16) and ni.shape == (48, 16)
            assert float(nu.min()) >= 0.0 and float(nu.max()) < 1.0


@pytest.mark.parametrize("name,use_op", CASES)
def test_embeddings_match_jax(tiny_dataset, name, use_op):
    jm, tm, jp, tp = make_pair(tiny_dataset, FLAGS[name], use_op)
    ju, ji = jm.embeddings(jp)
    with torch.no_grad():
        tu, ti = tm.embeddings(tp)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **TOL)


@pytest.mark.parametrize("name,use_op", CASES)
def test_loss_and_gradients_match_jax_under_its_noise(tiny_dataset, name, use_op):
    """The loss and both tables' gradients, with the JAX package's noise,
    on the JAX trainer's padded last batch."""
    jm, tm, jp, tp = make_pair(tiny_dataset, FLAGS[name], use_op)
    jb, tb = both_batches(jax_batches(tiny_dataset, 100, steps=(-1,))[0])
    rng = jax.random.PRNGKey(7)
    jloss, jg = jax.value_and_grad(jm.loss)(jp, jb, rng)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tloss = tm.loss_with_noise(leaves, tb, jax_noise(jm, rng))
    tloss.backward()
    assert tloss.item() == pytest.approx(float(jloss), rel=1e-5)
    for k in jg:
        assert_grads_close(leaves[k].grad.numpy(), np.asarray(jg[k]), k)


@pytest.mark.parametrize("name", list(FLAGS))
def test_three_trainer_steps_match_jax(tiny_dataset, name):
    """Three Trainer.train_step calls with the operator, each fed the JAX
    noise of its step."""
    jm, tm, jp, tp = make_pair(tiny_dataset, FLAGS[name])

    def set_draw(noise):
        tm.noise_draws = lambda gen: noise

    three_steps_match(tiny_dataset, FLAGS[name], jm, tm, jp, tp,
                      lambda rng: jax_noise(jm, rng), set_draw)
