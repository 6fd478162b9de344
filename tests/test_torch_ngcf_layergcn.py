"""models/ngcf.py and models/layergcn.py against the JAX package's.

Both packages build each model from ``tiny_dataset`` (64 users x 48 items,
384 train edges) at dim 16 on a float32 graph, with the first combo of
its Model_YAML file otherwise (3 layers; NGCF's dropout 0.2, LayerGCN's
0.1). The port takes the JAX package's initial params, its batches and
negatives, and for NGCF its keep mask (``bernoulli_keep`` on the loss's
key), given to ``loss_with_keep``. LayerGCN's pruning is the same host
draw in both packages, so its kept edges are compared as they are.

Tolerances: the loss to rtol 1e-5; every gradient to 1e-4 of its tensor's
largest entry plus 1e-6; NGCF's edge and self-loop weights, LayerGCN's
pruned R and the embeddings to rtol 1e-5, atol 1e-6. LayerGCN's edge
weights and kept edge sets must be equal.
"""

import jax
import numpy as np
import pytest
import torch

from chaorec_tpu.graphs import dropout as jdropout
from chaorec_tpu_torch.graphs.dropout import masked_edge_weights
from chaorec_tpu_torch.models.layergcn import LayerGCN
from chaorec_tpu_torch.models.ngcf import NGCF
from test_torch_lightgcn import (assert_grads_close, both_batches, jax_batches, make_pair,
                                 three_steps_match)
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

NGCF_FLAGS = dict(Model="NGCF", batch_size=100, dim_E=16, learning_rate=0.01, reg_weight=1e-3,
                  n_layers=3, dropout=0.2, graph_compute_dtype="float32", topk=(5, 10, 20))
LAYERGCN = dict(NGCF_FLAGS, Model="LayerGCN", dropout=0.1)
TOL = dict(rtol=1e-5, atol=1e-6)


def jax_keep(jm, rng):
    """NGCF's keep mask as the JAX loss draws it (ngcf.py:69)."""
    return torch.from_numpy(np.array(jdropout.bernoulli_keep(
        rng, jm.graph.u_by_u.shape[0], 1.0 - jm.dropout)))


def test_ngcf_build_and_edge_weights_match_jax(tiny_dataset):
    """The user-sorted edges are the JAX package's (so its masks line up),
    and the renormalized edge and self-loop weights under its mask."""
    jm, tm, _, tp = make_pair(tiny_dataset, NGCF_FLAGS)
    assert isinstance(tm, NGCF) and (tm.n_layers, tm.dropout) == (3, 0.2)
    assert sorted(tp) == sorted(["user_embedding", "item_embedding"]
                                + [f"W{j}_{l}" for l in range(3) for j in (1, 2)])
    np.testing.assert_array_equal(tm.graph.u_by_u.numpy(), np.asarray(jm._arrs[0]))
    np.testing.assert_array_equal(tm.graph.i_by_u.numpy(), np.asarray(jm._arrs[1]))
    keep = jax_keep(jm, jax.random.PRNGKey(3))
    assert 0 < float(keep.sum()) < keep.numel()
    jw, jsu, jsi = jdropout.sorted_masked_edge_weights(
        jax.numpy.asarray(keep.numpy()), jm._arrs, 64, 48, self_loops=True)
    g = tm.graph
    tw, tsu, tsi = masked_edge_weights(g.u_by_u, g.i_by_u, keep, 64, 48, self_loops=True)
    for got, want in ((tw, jw), (tsu, jsu), (tsi, jsi)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _, no_drop, _, _ = make_pair(tiny_dataset, dict(NGCF_FLAGS, dropout=0.0))
    assert torch.equal(no_drop.keep_mask(None), torch.ones(384))


def test_ngcf_embeddings_match_jax(tiny_dataset):
    jm, tm, jp, tp = make_pair(tiny_dataset, NGCF_FLAGS)
    ju, ji = jm.embeddings(jp)
    with torch.no_grad():
        tu, ti = tm.embeddings(tp)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **TOL)


@pytest.mark.parametrize("step", [0, -1], ids=["full_batch", "padded_batch"])
def test_ngcf_loss_and_gradients_match_jax_under_its_mask(tiny_dataset, step):
    jm, tm, jp, tp = make_pair(tiny_dataset, NGCF_FLAGS)
    jb, tb = both_batches(jax_batches(tiny_dataset, 100, steps=(step,))[0])
    rng = jax.random.PRNGKey(11)
    jloss, jg = jax.value_and_grad(jm.loss)(jp, jb, rng)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tloss = tm.loss_with_keep(leaves, tb, jax_keep(jm, rng))
    tloss.backward()
    assert tloss.item() == pytest.approx(float(jloss), rel=1e-5)
    for k in jg:
        assert_grads_close(leaves[k].grad.numpy(), np.asarray(jg[k]), k)


def test_ngcf_three_trainer_steps_match_jax(tiny_dataset):
    jm, tm, jp, tp = make_pair(tiny_dataset, NGCF_FLAGS)

    def set_draw(keep):
        tm.keep_mask = lambda gen: keep

    three_steps_match(tiny_dataset, NGCF_FLAGS, jm, tm, jp, tp,
                      lambda rng: jax_keep(jm, rng), set_draw)


def test_layergcn_prunes_the_same_edges_as_jax(tiny_dataset):
    """Equal float32 edge weights, then at epochs 0-3 (weighted, uniform,
    weighted, uniform draws) the same kept edges and the same pruned R."""
    jm, tm, jp, tp = make_pair(tiny_dataset, LAYERGCN)
    assert isinstance(tm, LayerGCN) and tm.graph.use_dense and tm.dropout == 0.1
    np.testing.assert_array_equal(tm._edge_w, np.asarray(jm._edge_w))
    keep_len = int(384 * 0.9)
    for epoch in range(4):
        jm.pre_epoch(jp, jax.random.PRNGKey(epoch), epoch)
        tm.pre_epoch(tp, epoch)
        jr, tr = np.asarray(jm.masked_r), tm.masked_r.numpy()
        assert tr.dtype == np.float32
        np.testing.assert_array_equal(tr != 0, jr != 0, err_msg=f"epoch {epoch}")
        assert int((tr != 0).sum()) == keep_len
        np.testing.assert_allclose(tr, jr, **TOL, err_msg=f"epoch {epoch}")
    assert not tm.pruning_random  # four flips


def test_layergcn_loss_and_gradients_on_the_pruned_r(tiny_dataset):
    """The loss and gradients on epoch 0's pruned R; the embeddings on the
    unpruned one."""
    jm, tm, jp, tp = make_pair(tiny_dataset, LAYERGCN)
    jm.pre_epoch(jp, jax.random.PRNGKey(0), 0)
    tm.pre_epoch(tp, 0)
    assert not np.array_equal(tm.masked_r.numpy(), tm.graph.dense_r.numpy())
    jb, tb = both_batches(jax_batches(tiny_dataset, 100, steps=(-1,))[0])
    jloss, jg = jax.value_and_grad(jm.loss)(jp, jb, jax.random.PRNGKey(1))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tloss = tm.loss(leaves, tb, None)
    tloss.backward()
    assert tloss.item() == pytest.approx(float(jloss), rel=1e-5)
    for k in jg:
        assert_grads_close(leaves[k].grad.numpy(), np.asarray(jg[k]), k)
    ju, ji = jm.embeddings(jp)
    with torch.no_grad():
        tu, ti = tm.embeddings(tp)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **TOL)


def test_layergcn_without_dropout_trains_on_the_whole_graph(tiny_dataset):
    _, tm, _, tp = make_pair(tiny_dataset, dict(LAYERGCN, dropout=0.0))
    tm.pre_epoch(tp, 0)
    assert tm.masked_r is tm.graph.dense_r


def test_layergcn_three_trainer_steps_match_jax(tiny_dataset):
    jm, tm, jp, tp = make_pair(tiny_dataset, LAYERGCN)
    jm.pre_epoch(jp, jax.random.PRNGKey(0), 0)
    tm.pre_epoch(tp, 0)
    three_steps_match(tiny_dataset, LAYERGCN, jm, tm, jp, tp)
