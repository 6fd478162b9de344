"""models/mgat.py against the JAX package's.

Both packages build MGAT from ``tiny_dataset`` (64 users x 48 items, the
conftest's 64- and 32-wide item features) at dim 16, reg 0.1. The port
takes the JAX package's initial params (``params.from_numpy``) and, for
the trainer, the JAX package's batches and negatives. Tolerances: the loss
to rtol 1e-5; every gradient to 1e-4 of its tensor's largest entry plus
1e-6 (float32 sums in another order: the messages' segment sums are prefix
differences in both packages, summed in another order, and the edge
softmax's sums are scatters); the embeddings to rtol 1e-5 and 1e-5 of
the table's largest entry (each entry sums three GAT rounds' terms, up to
the table's scale, in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chaorec_tpu.config import Config as JConfig
from chaorec_tpu.data import sampling as jsampling
from chaorec_tpu.models import build_model as jbuild
from chaorec_tpu.models.base import Batch as JBatch
from chaorec_tpu_torch import params as tparams
from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.models import build_model as tbuild
from chaorec_tpu_torch.models.base import Batch as TBatch
from chaorec_tpu_torch.models.mgat import MGAT
from chaorec_tpu_torch.train import loop as tloop
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

CFG = dict(Model="MGAT", batch_size=100, dim_E=16, learning_rate=0.1, reg_weight=0.1,
           graph_compute_dtype="float32", topk=(5, 10, 20))
TOL = dict(rtol=1e-5, atol=1e-6)


def _pair(tiny_dataset, **over):
    flags = dict(CFG, **over)
    jm = jbuild(JConfig(**flags), tiny_dataset)
    tm = tbuild(TConfig(**flags), tiny_dataset, "cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = tparams.from_numpy({k: np.asarray(v) for k, v in jp.items()})
    return jm, tm, jp, tp


def _batch(tiny_dataset, b=40, seed=0, pad=5):
    rs = np.random.default_rng(seed)
    edges = tiny_dataset.train_edges[rs.choice(tiny_dataset.num_edges, b, replace=False)]
    neg = rs.integers(0, tiny_dataset.num_item, b).astype(np.int32)
    w = np.ones(b, np.float32)
    w[b - pad:] = 0.0
    return edges[:, 0].astype(np.int32), edges[:, 1].astype(np.int32), neg, w


def _batches_both(arrays):
    u, p, n, w = (np.array(a) for a in arrays)
    jb = JBatch(jnp.asarray(u), jnp.asarray(p), jnp.asarray(n), jnp.asarray(w))
    tb = TBatch(torch.from_numpy(u).long(), torch.from_numpy(w),
                pos_items=torch.from_numpy(p).long(), neg_items=torch.from_numpy(n).long())
    return jb, tb


def _assert_grads_close(got, want, name):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale + 1e-6, err_msg=name)


def test_build_and_graph_match_jax(tiny_dataset):
    """The doubled edge list, the source degrees, the segment layouts and
    the params' names and shapes are the JAX package's."""
    jm, tm, jp, _ = _pair(tiny_dataset)
    assert isinstance(tm, MGAT) and (tm.dim_E, tm.reg_weight) == (16, 0.1)
    assert tm.n_nodes == tiny_dataset.num_user + tiny_dataset.num_item
    assert tm.src.shape[0] == 2 * tiny_dataset.num_edges
    for name in ("src", "dst", "_perm_src", "_ptr_src", "_perm_dst", "_ptr_dst"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)),
                                      err_msg=name)
    np.testing.assert_allclose(tm.deg_inv_sqrt_src.numpy(), np.asarray(jm.deg_inv_sqrt_src),
                               rtol=1e-6)
    init = tm.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in init.items()} == {k: v.shape for k, v in jp.items()}
    assert not tm.v_feat.requires_grad and not tm.t_feat.requires_grad


def test_embeddings_match_jax(tiny_dataset):
    jm, tm, jp, tp = _pair(tiny_dataset)
    ju, ji = jm.embeddings(jp)
    with torch.no_grad():
        tu, ti = tm.embeddings(tp)
    assert tu.shape == (64, 3 * 16) and ti.shape == (48, 3 * 16)
    for got, want in ((tu, ju), (ti, ji)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("pad", [5, 0])
def test_loss_and_gradients_match_jax(tiny_dataset, pad):
    jm, tm, jp, tp = _pair(tiny_dataset)
    jb, tb = _batches_both(_batch(tiny_dataset, pad=pad))
    jloss, jg = jax.value_and_grad(jm.loss)(jp, jb, jax.random.PRNGKey(1))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tloss = tm.loss(leaves, tb, None)
    tloss.backward()
    assert tloss.item() == pytest.approx(float(jloss), rel=1e-5)
    for k in jg:
        _assert_grads_close(leaves[k].grad.numpy(), np.asarray(jg[k]), k)


def test_three_trainer_steps_match_jax(tiny_dataset):
    """Trainer.train_step against value_and_grad of the JAX loss +
    optax.adam on the JAX package's batches and negatives (the last batch
    padded), each step from equal params: per-batch losses and gradients."""
    ds = tiny_dataset
    jm, tm, jp, tp = _pair(ds)
    trainer = tloop.Trainer(tm, ds, TConfig(**CFG))
    params = {k: v.clone().requires_grad_() for k, v in tp.items()}
    opt = trainer.make_optimizer(params)
    jopt_fn = optax.adam(CFG["learning_rate"])
    jopt = jopt_fn.init(jp)
    users, pos, weights, _ = jsampling.make_epoch_batches(
        jax.random.PRNGKey(5), jnp.asarray(ds.train_edges), CFG["batch_size"])
    history = jnp.asarray(ds.history.values)
    for n, b in enumerate((0, 1, users.shape[0] - 1)):
        neg = jsampling.sample_negatives(jax.random.PRNGKey(50 + b), users[b], history,
                                         ds.num_item)
        jb, tb = _batches_both((users[b], pos[b], neg, weights[b]))
        jloss, jg = jax.value_and_grad(jm.loss)(jp, jb, jax.random.PRNGKey(b))
        with torch.no_grad():
            for k, v in jp.items():
                params[k].copy_(torch.from_numpy(np.array(v)))
        tloss = trainer.train_step(params, opt, tb)
        assert tloss.item() == pytest.approx(float(jloss), rel=1e-5), n
        for k in jg:
            _assert_grads_close(params[k].grad.numpy(), np.asarray(jg[k]), f"{k} step {n}")
        upd, jopt = jopt_fn.update(jg, jopt, jp)
        jp = optax.apply_updates(jp, upd)
