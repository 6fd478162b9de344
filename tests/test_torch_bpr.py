"""The BPR trainer's pieces against the JAX package's: losses, negative
sampling, edge batches, embeddings ranking, and bf16 params carried over.

Inputs are made with numpy from seeds and handed to both packages.
Tolerances: the losses to 1e-6 relative (float32 in another order);
membership booleans and rank lists equal (scores have no ties); sampled
negatives are held to their distribution (the packages draw different
streams): never in the history, and uniform over the other items by a
chi-square test at p > 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from chaorec_tpu.data import sampling as jsampling
from chaorec_tpu.eval import ranking as jranking
from chaorec_tpu.ops import losses as jlosses
from chaorec_tpu_torch import params as tparams
from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.data import loading as tloading
from chaorec_tpu_torch.data import sampling as tsampling
from chaorec_tpu_torch.eval import ranking as tranking
from chaorec_tpu_torch.models.base import Batch, RecModel
from chaorec_tpu_torch.ops import losses as tlosses
from chaorec_tpu_torch.train import loop as tloop
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

LOSS_TOL = dict(rtol=1e-6, atol=1e-7)


def _t(x):
    return torch.from_numpy(np.array(x))


# --- losses -----------------------------------------------------------------
def test_losses_match_jax():
    rs = np.random.default_rng(0)
    a = rs.standard_normal((12, 5)).astype(np.float32)
    b = rs.standard_normal((12, 5)).astype(np.float32)
    a[3] = 0.0  # a zero row: the safe forms stay finite
    pos, neg = rs.standard_normal(12).astype(np.float32), rs.standard_normal(12).astype(np.float32)
    w = np.ones(12, np.float32)
    w[-4:] = 0.0
    pairs = [
        (tlosses.l2norm(_t(a)), jlosses.l2norm(jnp.asarray(a))),
        (tlosses.safe_norm(_t(a)), jlosses.safe_norm(jnp.asarray(a))),
        (tlosses.cosine_rows(_t(a), _t(b)), jlosses.cosine_rows(jnp.asarray(a), jnp.asarray(b))),
        (tlosses.masked_mean(_t(pos), _t(w)), jlosses.masked_mean(jnp.asarray(pos), jnp.asarray(w))),
        (tlosses.masked_mean(_t(pos), None), jlosses.masked_mean(jnp.asarray(pos), None)),
        (tlosses.bpr_loss(_t(pos), _t(neg), _t(w)),
         jlosses.bpr_loss(jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(w))),
        (tlosses.bpr_loss(_t(pos), _t(neg), eps=0.0),
         jlosses.bpr_loss(jnp.asarray(pos), jnp.asarray(neg), eps=0.0)),
        (tlosses.emb_l2_reg(1e-3, [_t(a), _t(pos)], _t(w)),
         jlosses.emb_l2_reg(1e-3, [jnp.asarray(a), jnp.asarray(pos)], jnp.asarray(w))),
    ]
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL, err_msg=str(i))


def test_bpr_loss_gradient_matches_jax():
    rs = np.random.default_rng(1)
    pos, neg = rs.standard_normal(9).astype(np.float32), rs.standard_normal(9).astype(np.float32)
    jg = jax.grad(lambda p, n: jlosses.bpr_loss(p, n), argnums=(0, 1))(jnp.asarray(pos),
                                                                       jnp.asarray(neg))
    tp, tn = _t(pos).requires_grad_(), _t(neg).requires_grad_()
    tlosses.bpr_loss(tp, tn).backward()
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg[0]), **LOSS_TOL)
    np.testing.assert_allclose(tn.grad.numpy(), np.asarray(jg[1]), **LOSS_TOL)


# --- sampling ---------------------------------------------------------------
def _history(rs, b, h, num_item):
    """(b, h) sorted histories of random lengths, padded with num_item."""
    out = np.full((b, h), num_item, np.int32)
    for r in range(b):
        n = int(rs.integers(0, h + 1))
        out[r, :n] = np.sort(rs.choice(num_item, n, replace=False))
    return out


@pytest.mark.parametrize("h", [40, 5000])
def test_in_sorted_matches_jax(h):
    """Both lowerings (the broadcast compare up to H = 4096, the binary
    search above) give the JAX package's booleans."""
    rs = np.random.default_rng(h)
    num_item = 2 * h
    hist = _history(rs, 6, h, num_item)
    cand = rs.integers(0, num_item, (6, 16)).astype(np.int32)
    cand[:, 0] = hist[:, 0]  # a sure hit where the row is not empty
    want = np.asarray(jsampling._in_sorted(jnp.asarray(hist), jnp.asarray(cand)))
    got = tsampling._in_sorted(_t(hist), _t(cand))
    np.testing.assert_array_equal(got.numpy(), want)
    truth = np.array([[c in set(row[row < num_item].tolist()) for c in cr]
                      for row, cr in zip(hist, cand)])
    np.testing.assert_array_equal(got.numpy(), truth)


def test_both_lowerings_agree(monkeypatch):
    rs = np.random.default_rng(3)
    hist = _t(_history(rs, 8, 30, 60))
    cand = _t(rs.integers(0, 60, (8, 12)).astype(np.int32))
    bcast = tsampling._in_sorted(hist, cand)
    monkeypatch.setattr(tsampling, "_BCAST_MAX_H", 4)
    np.testing.assert_array_equal(tsampling._in_sorted(hist, cand).numpy(), bcast.numpy())


def test_negatives_are_outside_the_history_and_uniform():
    """20000 draws for users with long histories (30 of 200 items seen, so
    all 8 candidates are seen with probability 2.6e-7): none is a seen
    item, and the counts over the unseen items pass a chi-square test of
    uniformity."""
    rs = np.random.default_rng(4)
    num_item = 200
    hist = _history(rs, 4, 30, num_item)
    hist[0, :] = np.sort(rs.choice(num_item, 30, replace=False))
    gen = torch.Generator().manual_seed(0)
    users = torch.zeros(20000, dtype=torch.int64)
    neg = tsampling.sample_negatives(gen, users, _t(hist), num_item, 8)
    assert neg.dtype == torch.int64 and neg.shape == (20000,)
    seen = set(hist[0].tolist())
    assert not seen.intersection(neg.tolist())
    unseen = sorted(set(range(num_item)) - seen)
    counts = np.bincount(neg.numpy(), minlength=num_item)[unseen]
    assert scipy.stats.chisquare(counts).pvalue > 1e-4, counts
    # every user of a batch gets a negative outside its own history
    users = torch.arange(4).repeat(500)
    neg = tsampling.sample_negatives(gen, users, _t(hist), num_item, 8)
    for u, n in zip(users.tolist(), neg.tolist()):
        assert n not in set(hist[u].tolist())


def test_a_full_history_gives_the_last_candidate():
    """When every candidate is seen, the last one is taken, as in JAX."""
    hist = _t(np.arange(10, dtype=np.int32)[None])
    neg = tsampling.sample_negatives(torch.Generator().manual_seed(1), torch.zeros(5).long(),
                                     hist, 10, 4)
    cand = torch.randint(0, 10, (5, 4), generator=torch.Generator().manual_seed(1),
                         dtype=hist.dtype)
    assert torch.equal(neg, cand[:, -1].long())


def test_edge_batches_hold_every_edge_once():
    rs = np.random.default_rng(5)
    edges = _t(np.stack([rs.integers(0, 30, 1000), rs.integers(0, 20, 1000)], 1))
    batches = tsampling.make_edge_batches(torch.Generator().manual_seed(2), edges, 128)
    assert [b.users.shape[0] for b in batches] == [128] * 8  # every batch is full
    assert [b.index for b in batches] == list(range(8))
    got = torch.cat([torch.stack([b.users, b.pos_items], 1) for b in batches])
    weights = torch.cat([b.weights for b in batches])
    # every real row once with weight 1; the 24 pad rows repeat edge 0 with weight 0
    assert torch.equal(weights, (torch.arange(1024) < 1000).float())
    assert sorted(map(tuple, got[:1000].tolist())) == sorted(map(tuple, edges.tolist()))
    assert torch.equal(got[1000:], edges[:1].expand(24, 2))
    again = tsampling.make_edge_batches(torch.Generator().manual_seed(3), edges, 128)
    assert not torch.equal(again[0].users, batches[0].users)


# --- ranking ----------------------------------------------------------------
@pytest.mark.parametrize("chunk", [4096, 7])
def test_gene_ranklist_matches_jax(tiny_dataset, chunk):
    """Rank lists of bf16-rounded tables (so both packages score the same
    products exactly), seen items masked, in one chunk and in several.
    Every score is positive, so the masked items (1e-6, tied) rank last and
    the top 20 of the 42 unseen items hold no tie."""
    ds = tiny_dataset
    rs = np.random.default_rng(6)
    ue = np.abs(rs.standard_normal((ds.num_user, 16))).astype(np.float32)
    ie = np.abs(rs.standard_normal((ds.num_item, 16))).astype(np.float32)
    ue = np.asarray(jnp.asarray(ue, jnp.bfloat16).astype(jnp.float32))
    ie = np.asarray(jnp.asarray(ie, jnp.bfloat16).astype(jnp.float32))
    want = np.asarray(jranking.gene_ranklist(jnp.asarray(ue), jnp.asarray(ie),
                                             jnp.asarray(ds.history.values), ds.num_user,
                                             topk=20, user_chunk=chunk))
    got = tranking.gene_ranklist(_t(ue), _t(ie), _t(ds.history.values), ds.num_user,
                                 topk=20, user_chunk=chunk)
    assert got.shape == (ds.num_user, 20)
    np.testing.assert_array_equal(got.numpy(), want)
    seen = ds.history.values + ds.num_user
    assert not any(set(got[u].tolist()) & set(seen[u].tolist()) for u in range(ds.num_user))


# --- params and data ----------------------------------------------------------
def test_from_numpy_carries_bf16_bits():
    x = jnp.asarray(np.random.default_rng(7).standard_normal((5, 3)), jnp.bfloat16)
    got = tparams.from_numpy({"t": np.asarray(x), "f": np.ones(2, np.float32)})
    assert got["t"].dtype == torch.bfloat16 and got["f"].dtype == torch.float32
    np.testing.assert_array_equal(got["t"].float().numpy(), np.asarray(x.astype(jnp.float32)))


def test_synthetic_item_features_are_the_loaders_recipe(tiny_dataset):
    """The module-level recipe gives tests/conftest.py's features (the same
    recipe), in any edge chunking."""
    ds = tiny_dataset
    want = ds.v_feat
    for chunk in (65536, 50):
        got = tloading.synthetic_item_features(ds.train_edges, ds.num_user, ds.num_item,
                                               want.shape[1], 11, edge_chunk=chunk)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


# --- the trainer's BPR step without tables -------------------------------------
class _TinyMF(RecModel):
    """Matrix factorization with the reference's BPR loss and mean L2."""

    name = "TinyMF"
    device = torch.device("cpu")

    def init_params(self, generator):
        return {"u": torch.randn(self.num_user, 4, generator=generator),
                "i": torch.randn(self.num_item, 4, generator=generator)}

    def loss(self, params, batch, generator):
        u = params["u"][batch.users]
        p, n = params["i"][batch.pos_items], params["i"][batch.neg_items]
        return (tlosses.bpr_loss((u * p).sum(1), (u * n).sum(1), batch.weights)
                + tlosses.emb_l2_reg(1e-3, [u, p, n], batch.weights))


def test_bpr_step_without_tables_is_one_adam_step(tiny_dataset):
    """A "bpr" model without tables: the trainer's step is one torch Adam
    step on the model's loss (the same numbers to 1e-6)."""
    cfg = TConfig(Model="TinyMF", learning_rate=0.01)
    trainer = tloop.Trainer(_TinyMF(tiny_dataset.num_user, tiny_dataset.num_item),
                            tiny_dataset, cfg)
    params = trainer.init_params()
    want = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    batch = Batch(torch.tensor([0, 1, 2, 3]), torch.tensor([1.0, 1.0, 1.0, 0.0]),
                  pos_items=torch.tensor([4, 5, 6, 7]), neg_items=torch.tensor([30, 31, 32, 33]))
    loss = trainer.train_step(params, trainer.make_optimizer(params), batch)
    opt = torch.optim.Adam(want.values(), lr=0.01)
    want_loss = trainer.model.loss(want, batch, None)
    want_loss.backward()
    opt.step()
    assert loss.item() == pytest.approx(want_loss.item(), rel=1e-6)
    for k in params:
        np.testing.assert_allclose(params[k].detach().numpy(), want[k].detach().numpy(),
                                   rtol=1e-6, atol=1e-7)
    assert int(trainer.table_count) == 0
