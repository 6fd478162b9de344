"""The port's epoch batches against the JAX package's, and the losses they give.

``data/sampling.py:pack_batches`` pads the last batch as
``chaorec_tpu/data/sampling.py:make_epoch_batches`` does: real rows weigh
1, pad rows repeat row 0 of the unshuffled table with weight 0. Both
packages get the same permutation (the JAX package's), so the batches are
held equal entry for entry. Then the port's own last batch goes through
DCCF, DGCF and FREEDOM and is held to the JAX package's result on its
padded batch, within the tolerances of tests/test_torch_{dccf,dgcf,
freedom}.py: the loss to rtol 1e-5, DGCF's routing scores to atol 1e-5,
FREEDOM's stepped params to rtol = atol = 1e-5. DCCF's short batch (the
port's batch before it padded) misses the JAX loss by more than that.

The trainer refuses the flags it does not port.
"""

import dataclasses

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
from chaorec_tpu.ops import indexed_adam as jadam
from chaorec_tpu_torch import params as tparams
from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.data.sampling import pack_batches
from chaorec_tpu_torch.models import build_model as tbuild
from chaorec_tpu_torch.models.base import Batch as TBatch
from chaorec_tpu_torch.train import loop as tloop
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

LOSS_RTOL = 1e-5
S_TOL = dict(rtol=0, atol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)
DCCF = dict(Model="DCCF", batch_size=100, dim_E=16, learning_rate=1e-3, reg_weight=1e-3,
            n_layers=1, n_intents=8, ssl_temp=1.0, ssl_alpha=0.1, cen_reg=1e-3,
            graph_compute_dtype="float32", topk=(5, 10, 20))
DGCF = dict(Model="DGCF", batch_size=100, dim_E=16, learning_rate=0.01, reg_weight=0.01,
            corDecay=0.01, n_factors=2, n_iterations=1, n_layers=3, topk=(5, 10, 20))
# dropout 0: no pruning draw, so both packages hold the same R (at half)
FREEDOM = dict(Model="FREEDOM", batch_size=100, dim_E=16, feature_embed=16,
               learning_rate=0.05, reg_weight=1e-3, n_layers=2, mm_layers=1, ii_topk=5,
               dropout=0.0, lambda_coeff=0.8, graph_compute_dtype="float32",
               topk=(5, 10, 20))


def _pair(ds, flags):
    jm = jbuild(JConfig(**flags), ds)
    tm = tbuild(TConfig(**flags), ds, "cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    return jm, tm, jp, tparams.from_numpy({k: np.asarray(v) for k, v in jp.items()})


def _jax_batches(ds, batch_size, key=5):
    """The JAX package's epoch: (users, pos, weights, perm), numpy."""
    out = jsampling.make_epoch_batches(jax.random.PRNGKey(key), jnp.asarray(ds.train_edges),
                                       batch_size)
    return tuple(np.array(a) for a in out)


def _port_batches(ds, perm, batch_size):
    return pack_batches(torch.from_numpy(perm).long(),
                        torch.from_numpy(ds.train_edges).long(), batch_size)


def _negatives(ds, users, key):
    neg = jsampling.sample_negatives(jax.random.PRNGKey(key), jnp.asarray(users),
                                     jnp.asarray(ds.history.values), ds.num_item)
    return np.array(neg)


def _jax_batch(users, pos, neg, weights):
    return JBatch(jnp.asarray(users), jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(weights))


def _last(ds, cfg):
    """The JAX package's last batch with its negatives, and the port's own
    last batch of the same permutation given the same negatives."""
    users, pos, weights, perm = _jax_batches(ds, cfg["batch_size"])
    neg = _negatives(ds, users[-1], 7)
    tb = _port_batches(ds, perm, cfg["batch_size"])[-1]
    assert 0 < weights[-1].sum() < cfg["batch_size"], "the last batch has pad rows"
    np.testing.assert_array_equal(tb.users.numpy(), users[-1])
    tb = dataclasses.replace(tb, neg_items=torch.from_numpy(neg).long())
    return _jax_batch(users[-1], pos[-1], neg, weights[-1]), tb


def _short(tb):
    """The batch cut to its real rows, as the port's trainer once fed it."""
    real = tb.weights > 0
    return TBatch(tb.users[real], tb.weights[real], pos_items=tb.pos_items[real],
                  neg_items=tb.neg_items[real], index=tb.index)


@pytest.mark.parametrize("rows,batch_size", [("edges", 96), ("edges", 100), ("users", 24)])
def test_pack_batches_matches_jax(tiny_dataset, rows, batch_size):
    """384 edges in batches of 96 (no pad) and of 100 (16 pad rows); 64
    user rows in batches of 24 (8 pad rows of user 0), as the JAX trainer
    packs user-rows models: edges (user, 0)."""
    ds = tiny_dataset
    if rows == "edges":
        edges = ds.train_edges
        table = torch.from_numpy(edges).long()
    else:
        edges = np.stack([np.arange(ds.num_user), np.zeros(ds.num_user)], 1).astype(np.int32)
        table = torch.arange(ds.num_user)
    users, pos, weights, perm = (np.array(a) for a in jsampling.make_epoch_batches(
        jax.random.PRNGKey(3), jnp.asarray(edges), batch_size))
    got = pack_batches(torch.from_numpy(perm).long(), table, batch_size)
    assert len(got) == users.shape[0]
    for b, batch in enumerate(got):
        assert batch.index == b
        np.testing.assert_array_equal(batch.users.numpy(), users[b])
        np.testing.assert_array_equal(batch.weights.numpy(), weights[b])
        if rows == "edges":
            np.testing.assert_array_equal(batch.pos_items.numpy(), pos[b])
        else:
            assert batch.pos_items is None
    assert (weights[-1] == 0).any() == (len(edges) % batch_size != 0)


def test_dccf_last_batch_matches_jax_and_the_short_batch_does_not(tiny_dataset):
    """The in-batch InfoNCE puts every row, pad rows included, into each
    logsumexp: the padded batch gives the JAX loss, the short one does not."""
    jm, tm, jp, tp = _pair(tiny_dataset, DCCF)
    jb, tb = _last(tiny_dataset, DCCF)
    want = float(jm.loss(jp, jb, jax.random.PRNGKey(1)))
    with torch.no_grad():
        got = tm.loss(tp, tb, None).item()
        short = tm.loss(tp, _short(tb), None).item()
    assert got == pytest.approx(want, rel=LOSS_RTOL)
    assert abs(short - want) > LOSS_RTOL * abs(want) * 100, (short, want)


def test_dgcf_last_batch_matches_jax(tiny_dataset):
    """distance_correlation over [u; pos] takes no weights: the padded
    batch gives the JAX loss and the JAX routing scores."""
    jm, tm, jp, tp = _pair(tiny_dataset, DGCF)
    jb, tb = _last(tiny_dataset, DGCF)
    s = np.random.default_rng(3).uniform(-1.0, 2.0, (tm.n_factors, tm.edge_u.shape[0]))
    s = s.astype(np.float32)
    jloss, jnew = jm.loss_stateful(jp, jnp.asarray(s), jb, jax.random.PRNGKey(1))
    with torch.no_grad():
        tloss, tnew = tm.loss_stateful(tp, torch.from_numpy(s), tb, None)
    assert tloss.item() == pytest.approx(float(jloss), rel=LOSS_RTOL)
    np.testing.assert_allclose(tnew.numpy(), np.asarray(jnew), **S_TOL)


def test_freedom_last_batch_steps_the_jax_table_rows(tiny_dataset):
    """Two trainer steps, the epoch's first batch and then its padded last
    one, against the JAX loop (loss_tables, optax.adam, row_adam_update):
    the pad rows' items are in the row set, so rows with moments from the
    first step move on the second in both packages."""
    ds = tiny_dataset
    jm, tm, jp, tp = _pair(ds, FREEDOM)
    names = jm.table_params
    lr = FREEDOM["learning_rate"]
    jdense = {k: v for k, v in jp.items() if k not in names}
    opt = optax.adam(lr)
    jopt = opt.init(jdense)
    jtab = {n: jp[n] for n in names}
    jstate = {n: jadam.init_table_state(jp[n]) for n in names}
    trainer = tloop.Trainer(tm, ds, TConfig(**FREEDOM))
    params = {k: v if k in names else v.requires_grad_() for k, v in tp.items()}
    topt = trainer.make_optimizer(params)

    users, pos, weights, perm = _jax_batches(ds, FREEDOM["batch_size"])
    tbatches = _port_batches(ds, perm, FREEDOM["batch_size"])
    pad_item = int(ds.train_edges[0, 1])  # the positive of every pad row
    assert (pos[-1][weights[-1] == 0] == pad_item).all()
    for step, b in enumerate((0, len(tbatches) - 1), start=1):
        neg = _negatives(ds, users[b], 50 + b)
        jb = _jax_batch(users[b], pos[b], neg, weights[b])
        tb = dataclasses.replace(tbatches[b], neg_items=torch.from_numpy(neg).long())
        rows = jm.table_rows(jb)
        if step == 1:
            assert pad_item in np.asarray(rows["v_feat"]), "the pad item gets moments"
        before = np.array(jtab["v_feat"][pad_item])
        gath = {n: jtab[n][rows[n]] for n in names}
        jloss, (gd, gr) = jax.value_and_grad(jm.loss_tables, argnums=(0, 1))(
            jdense, gath, jb, jax.random.PRNGKey(step))
        upd, jopt = opt.update(gd, jopt, jdense)
        jdense = optax.apply_updates(jdense, upd)
        for n in names:
            jtab[n], jstate[n] = jadam.row_adam_update(
                jtab[n], jstate[n], rows[n], gr[n], jnp.asarray(step, jnp.int32), lr)
        tloss = trainer.train_step(params, topt, tb)
        assert tloss.item() == pytest.approx(float(jloss), rel=LOSS_RTOL), step
    assert not np.array_equal(np.asarray(jtab["v_feat"][pad_item]), before), \
        "the JAX step moves the pad item's row"
    for k, want in {**jdense, **jtab}.items():
        np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(want),
                                   err_msg=k, **PARAM_TOL)


@pytest.mark.parametrize("flag,value", [("mesh_shape", "dp=4")])
def test_trainer_refuses_unported_flags(tiny_dataset, flag, value):
    """The mesh is ported: what it still refuses is a mesh the world
    cannot hold (this process is a world of one)."""
    tm = tbuild(TConfig(**DCCF), tiny_dataset, "cpu")
    with pytest.raises(ValueError, match=f"--{flag} {value} needs 4 ranks, the world has 1"):
        tloop.Trainer(tm, tiny_dataset, TConfig(**DCCF, **{flag: value}))
