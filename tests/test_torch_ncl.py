"""models/ncl.py and ops/kmeans.py against the JAX package's.

Both packages build NCL from ``tiny_dataset`` (64 users x 48 items, so
k = min(200, 64, 48) = 48 clusters) at dim 16, 2 layers, on a float32
graph. The port takes the JAX package's initial params
(``params.from_numpy``) and its prototypes: the JAX loss's own k-means
draw (``kmeans`` on ``jax.random.split(rng)``), repeated here and given to
``loss_with_prototypes``. k-means is compared from the same initial rows
on well-separated clusters, where no assignment is a near tie.
Tolerances: the loss to rtol 1e-5; gradients to 1e-4 of their tensor's
largest entry plus 1e-6; centroids and embeddings to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chaorec_tpu.config import Config as JConfig
from chaorec_tpu.models import build_model as jbuild
from chaorec_tpu.models import ncl as jncl
from chaorec_tpu.models.base import Batch as JBatch
from chaorec_tpu.ops import kmeans as jkmeans
from chaorec_tpu.ops.losses import l2norm as jl2norm
from chaorec_tpu_torch import params as tparams
from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.models import build_model as tbuild
from chaorec_tpu_torch.models import ncl as tncl
from chaorec_tpu_torch.models.base import Batch as TBatch
from chaorec_tpu_torch.ops import kmeans as tkmeans
from chaorec_tpu_torch.train import loop as tloop
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

CFG = dict(Model="NCL", batch_size=64, dim_E=16, learning_rate=1e-3, reg_weight=1e-5,
           n_layers=2, ssl_temp=0.1, ssl_alpha=1e-2, graph_compute_dtype="float32",
           topk=(5, 10, 20))
TOL = dict(rtol=1e-5, atol=1e-6)


def _pair(tiny_dataset, **over):
    flags = dict(CFG, **over)
    jm = jbuild(JConfig(**flags), tiny_dataset)
    tm = tbuild(TConfig(**flags), tiny_dataset, "cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = tparams.from_numpy({k: np.asarray(v) for k, v in jp.items()})
    return jm, tm, jp, tp


def jax_prototypes(jm, jp, rng):
    """The centroids and assignments the JAX package's loss draws from
    ``rng`` (ncl.py:101-107), as tensors."""
    ku, ki = jax.random.split(rng)
    cu, au = jkmeans.kmeans(ku, jp["user_embedding"], jm.k, jm.kmeans_iters)
    ci, ai = jkmeans.kmeans(ki, jp["item_embedding"], jm.k, jm.kmeans_iters)
    cu, au, ci, ai = (torch.from_numpy(np.array(x)) for x in (jl2norm(cu), au, jl2norm(ci), ai))
    return cu, au.long(), ci, ai.long()


def _batch(tiny_dataset, b=40, seed=0, pad=5):
    rs = np.random.default_rng(seed)
    edges = tiny_dataset.train_edges[rs.choice(tiny_dataset.num_edges, b, replace=False)]
    hist = tiny_dataset.history
    neg = np.array([rs.choice(np.setdiff1d(np.arange(tiny_dataset.num_item),
                                           hist.values[u, :hist.lengths[u]]))
                    for u in edges[:, 0]], np.int32)
    w = np.ones(b, np.float32)
    w[b - pad:] = 0.0
    u, p = edges[:, 0].astype(np.int32), edges[:, 1].astype(np.int32)
    jb = JBatch(jnp.asarray(u), jnp.asarray(p), jnp.asarray(neg), jnp.asarray(w))
    tb = TBatch(torch.from_numpy(u).long(), torch.from_numpy(w),
                pos_items=torch.from_numpy(p).long(), neg_items=torch.from_numpy(neg).long())
    return jb, tb


def _assert_grads_close(got, want, name):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale + 1e-6, err_msg=name)


def _clusters(seed, n=300, k=7, d=16):
    """``n`` points around ``k`` far-apart centres."""
    rs = np.random.default_rng(seed)
    centres = rs.standard_normal((k, d)).astype(np.float32) * 10.0
    labels = rs.integers(0, k, n)
    return (centres[labels] + 0.3 * rs.standard_normal((n, d))).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_kmeans_from_the_same_start_matches_jax(seed):
    x = _clusters(seed)
    k = 7
    rng = jax.random.PRNGKey(seed)
    # the JAX kmeans draws its initial rows like this (kmeans.py:28)
    init_idx = np.array(jax.random.choice(rng, x.shape[0], (k,), replace=False))
    jc, ja = jkmeans.kmeans(rng, jnp.asarray(x), k, 15)
    tc, ta = tkmeans.kmeans_from(torch.from_numpy(x), torch.from_numpy(init_idx).long(), 15)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)


def test_kmeans_keeps_an_empty_cluster():
    """Two initial rows at the same point: every tie goes to the first
    centroid, so the second is empty and stays where it was."""
    x = torch.tensor([[0.0, 0.0], [0.0, 0.0], [10.0, 10.0], [10.2, 10.0]])
    c, a = tkmeans.kmeans_from(x, torch.tensor([0, 1, 2]), iters=3)
    assert a.tolist() == [0, 0, 2, 2]
    assert torch.equal(c[1], x[1])
    torch.testing.assert_close(c[2], torch.tensor([10.1, 10.0]))


def test_kmeans_draws_distinct_initial_rows():
    gen = torch.Generator().manual_seed(0)
    x = _clusters(2)
    c, a = tkmeans.kmeans(gen, torch.from_numpy(x), 7, iters=0)
    assert len({tuple(r) for r in c.tolist()}) == 7 and a.shape == (300,)


@pytest.mark.parametrize("temp", [0.1, 0.01])
def test_nce_sum_matches_jax(temp):
    """The full-catalog term alone, value and the gradients of all three
    inputs."""
    rs = np.random.default_rng(4)
    cur, prev = rs.standard_normal((30, 16)).astype(np.float32), rs.standard_normal((30, 16))
    allp, w = rs.standard_normal((48, 16)).astype(np.float32), rs.random(30).astype(np.float32)
    prev = prev.astype(np.float32)
    jv, jg = jax.value_and_grad(jncl._full_catalog_nce_sum, argnums=(0, 1, 2))(
        jnp.asarray(cur), jnp.asarray(prev), jnp.asarray(allp), temp, jnp.asarray(w))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (cur, prev, allp)]
    tv = tncl._full_catalog_nce_sum(*leaves, temp, torch.from_numpy(w))
    tv.backward()
    assert tv.item() == pytest.approx(float(jv), rel=1e-5)
    for t, j, name in zip(leaves, jg, ("cur", "prev", "all")):
        _assert_grads_close(t.grad.numpy(), np.asarray(j), name)


def test_build_goes_through_build_model(tiny_dataset):
    _, tm, _, _ = _pair(tiny_dataset)
    assert isinstance(tm, tncl.NCL)
    assert tm.k == 48 and (tm.hyper_layers, tm.alpha, tm.proto_reg) == (1, 1.0, 1e-7)
    assert (tm.dim_E, tm.n_layers, tm.ssl_temp, tm.ssl_reg) == (16, 2, 0.1, 1e-2)


@pytest.mark.parametrize("n_layers", [2, 3])
def test_embeddings_match_jax(tiny_dataset, n_layers):
    jm, tm, jp, tp = _pair(tiny_dataset, n_layers=n_layers)
    ju, ji = jm.embeddings(jp)
    with torch.no_grad():
        tu, ti = tm.embeddings(tp)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **TOL)


@pytest.mark.parametrize("temp", [0.1, 0.01])
def test_loss_and_gradients_match_jax_with_its_prototypes(tiny_dataset, temp):
    jm, tm, jp, tp = _pair(tiny_dataset, ssl_temp=temp)
    jb, tb = _batch(tiny_dataset)
    rng = jax.random.PRNGKey(11)
    jloss, jg = jax.value_and_grad(jm.loss)(jp, jb, rng)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    protos = jax_prototypes(jm, jp, rng)
    tloss = tm.loss_with_prototypes(leaves, tb, protos)
    tloss.backward()
    assert tloss.item() == pytest.approx(float(jloss), rel=1e-5)
    for k in jg:
        _assert_grads_close(leaves[k].grad.numpy(), np.asarray(jg[k]), k)
    # the prototypes the port draws itself are normalized and in range
    cu, au, ci, ai = tm.prototypes(tp, torch.Generator().manual_seed(0))
    assert cu.shape == (48, 16) and ci.shape == (48, 16)
    np.testing.assert_allclose(cu.norm(dim=1).numpy(), 1.0, rtol=1e-5)
    assert int(au.max()) < 48 and int(ai.max()) < 48 and au.shape == (64,) and ai.shape == (48,)


def test_ncl_learns(tiny_dataset):
    """Test recall@20 of the untrained model (~0.42, random on the planted
    24-item blocks) rises after one epoch (lr 0.05, ssl_alpha 1e-5, as
    tests/test_models_e2e.py trains NCL)."""
    cfg = TConfig(**dict(CFG, learning_rate=0.05, ssl_alpha=1e-5), num_epoch=1)
    trainer = tloop.Trainer(tbuild(cfg, tiny_dataset, "cpu"), tiny_dataset, cfg)
    params = trainer.init_params()
    opt = trainer.make_optimizer(params)
    before = trainer.evaluate(params)[1][20]["recall"]
    loss = trainer.train_epoch(params, opt)
    after = trainer.evaluate(params)[1][20]["recall"]
    assert np.isfinite(loss) and after > before and after > 0.5, (before, after)
