"""models/dualgnn.py, dragon.py, cohesion.py and lightgt.py against the JAX
package's, with the trainer's eval-resample hook.

Both packages build each model from ``tiny_dataset`` (64 users x 48 items,
384 train edges, 32- and 16-wide item features) at dim 16 on a float32
graph, with its Model_YAML file's first combo otherwise (DualGNN uu_topk
10; DRAGON 2 item-graph layers, uu_topk 40, ii_topk 10, lambda_coeff 0.6;
COHESION 1 layer, 1 item-graph layer, ii_topk 10, image weight 0.1,
dropout 0, and also dropout 0.1; LightGT 4 layers; the feature width 16 =
dim_E, as DualGNN's towers need). The port takes the JAX package's initial
params, the JAX trainer's batches and negatives, COHESION's pruning keep
mask (``apply_keep_mask``), and LightGT's draws from its key (the training
sequences and the attention keep masks, given to ``loss_with_draws``) and
evaluation subsets. The user graphs are numpy's draws on both sides, seeded
alike.

Tolerances are those of tests/test_torch_mm_towers3.py: each loss to rtol
1e-5, every gradient to 1e-4 of its tensor's largest entry plus 1e-6, the
embeddings and scores to ``TOL`` (rtol 1e-5, atol 1e-6); at
``graph_compute_dtype`` bfloat16 the embeddings to ``PROP_TOL["bfloat16"]``
and the step to a loss rtol of 1e-4 and gradients within 2^-6 of their
tensor's largest entry. COHESION's products are of bf16 operands at every
graph dtype, so its step is always held at the bf16 bounds; its towers'
forward at float32 graph dtype is held at ``TOL``: with both operands
rounded to bf16 each product is exact in float32 and only the order of the
sums differs, where float32 operands would miss by R's bf16 rounding.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.eval.ranking import rank_from_scores
from chaorec_tpu_torch.graphs.knn import ELLGraph
from chaorec_tpu_torch.models.cohesion import COHESION
from chaorec_tpu_torch.models.dragon import DRAGON
from chaorec_tpu_torch.models.dualgnn import DualGNN
from chaorec_tpu_torch.models.lightgt import LightGT
from chaorec_tpu_torch.serve import Recommender, export_artifact
from chaorec_tpu_torch.train import loop as tloop
from test_torch_graphs import PROP_TOL
from test_torch_lightgcn import TOL, assert_grads_close, both_batches, jax_batches, make_pair
from test_torch_mm_towers import grad_np
from test_torch_vae import cli_logs_match, one_torch_thread, t  # noqa: F401

BASE = dict(batch_size=100, dim_E=16, graph_compute_dtype="float32", topk=(5, 10, 20))
FLAGS = {
    "DualGNN": dict(BASE, Model="DualGNN", learning_rate=1e-4, reg_weight=0.01, uu_topk=10,
                    feature_embed=16),
    "DRAGON": dict(BASE, Model="DRAGON", learning_rate=1e-3, reg_weight=0.01, n_layers=2,
                   uu_topk=40, ii_topk=10, lambda_coeff=0.6, feature_embed=16),
    "COHESION": dict(BASE, Model="COHESION", learning_rate=1e-3, reg_weight=1e-3, dropout=0.0,
                     n_layers=1, mm_layers=1, ii_topk=10, mm_image_weight=0.1),
    "LightGT": dict(BASE, Model="LightGT", n_layers=4, learning_rate=0.01, reg_weight=1e-3),
}
CLASSES = {"DualGNN": DualGNN, "DRAGON": DRAGON, "COHESION": COHESION, "LightGT": LightGT}
EMBEDDING = ("DualGNN", "DRAGON", "COHESION")
EXPORTED = ("COHESION", "LightGT")
VARIANTS = {**FLAGS, "COHESION-dropout": dict(FLAGS["COHESION"], dropout=0.1)}
BF16_LOSS_RTOL, BF16_GRAD_SHARE = 1e-4, 2.0 ** -6


def lightgt_draws(jm, rng, users):
    """The port's form of LightGT's draws from ``rng`` for ``users``."""
    k_seq, k_drop = jax.random.split(rng)
    user_item, mask = jm._train_sequences(jnp.asarray(users), k_seq)
    out = {"user_item": t(user_item).long(), "mask": t(mask)}
    shape = (user_item.shape[0], user_item.shape[1], user_item.shape[1])
    for m, pre in enumerate(("v", "t")):
        for l in range(jm.n_layers):
            key = jax.random.fold_in(jax.random.fold_in(k_drop, m), l)
            out[f"keep_{pre}{l}"] = t(jax.random.bernoulli(key, 1.0 - jm.attn_dropout, shape)
                                      .astype(jnp.float32))
    return out


def jax_keep_mask(jm, epoch):
    """COHESION's pruning keep mask, as its JAX pre_epoch draws it
    (cohesion.py:110-117)."""
    e = jm._edge_u.shape[0]
    key = jax.random.fold_in(jax.random.PRNGKey(92821), epoch)
    scores = jnp.log(jnp.asarray(jm._edge_w, jnp.float32)) + jax.random.gumbel(key, (e,))
    keep_idx = jax.lax.top_k(scores, int(e * (1.0 - jm.dropout)))[1]
    return jnp.zeros((e,), jnp.float32).at[keep_idx].set(1.0)


def prepare(jm, tm, jp, epoch=0):
    """Both models at the start of ``epoch``: the JAX pre_epoch, and the
    port's with COHESION's JAX keep mask."""
    jm.pre_epoch(jp, jax.random.PRNGKey(0), epoch)
    if isinstance(tm, COHESION) and tm.dropout > 0:
        tm.prune_mask = lambda e: t(jax_keep_mask(jm, e))
    tm.pre_epoch(None, epoch)


def port_loss(tm, params, batch, rng, jm):
    if isinstance(tm, LightGT):
        return tm.loss_with_draws(params, batch, lightgt_draws(jm, rng, batch.users.numpy()))
    return tm.loss(params, batch, None)


@functools.partial(jax.jit, static_argnums=1)
def _value_and_grad(jp, jm, jb, rng):
    return jax.value_and_grad(lambda p: jm.loss(p, jb, rng))(jp)


def bf16_step(name, flags):
    return name.startswith("COHESION") or flags["graph_compute_dtype"] == "bfloat16"


def assert_step_close(jloss, jg, tloss, grads, bf16, what=""):
    if not bf16:
        assert tloss == pytest.approx(float(jloss), rel=1e-5), what
        for k in jg:
            assert_grads_close(grads[k], np.asarray(jg[k]), f"{k} {what}")
        return
    assert tloss == pytest.approx(float(jloss), rel=BF16_LOSS_RTOL), what
    for k in jg:
        want = np.asarray(jg[k])
        np.testing.assert_allclose(grads[k], want, rtol=0,
                                   atol=BF16_GRAD_SHARE * float(np.abs(want).max()) + 1e-6,
                                   err_msg=f"{k} {what}")


def loss_and_grads(ds, flags, step, rng_seed):
    """(JAX loss, JAX gradients, port loss, port gradients) of one batch at
    epoch 0."""
    jm, tm, jp, tp = make_pair(ds, flags)
    prepare(jm, tm, jp)
    jb, tb = both_batches(jax_batches(ds, flags["batch_size"], (step,))[0])
    rng = jax.random.PRNGKey(rng_seed)
    jloss, jg = _value_and_grad(jp, jm, jb, rng)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tloss = port_loss(tm, leaves, tb, rng, jm)
    tloss.backward()
    return jloss, jg, tloss.item(), {k: grad_np(v) for k, v in leaves.items()}


@pytest.mark.parametrize("name", list(CLASSES))
def test_build_goes_through_build_model(tiny_dataset, name):
    jm, tm, jp, _ = make_pair(tiny_dataset, FLAGS[name])
    assert isinstance(tm, CLASSES[name]) and tm.name == name
    mode = "scores" if name == "LightGT" else "embeddings"
    assert (tm.rank_mode, tm.stateful, tm.trainer_mode) == (mode, False, "bpr")
    assert getattr(tm, "trainer_cls", tloop.Trainer) is tloop.Trainer and not tm.table_params
    assert not getattr(tm, "epoch0_params", None) and not getattr(tm, "frozen_state_epoch", None)
    own = tm.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    if name == "LightGT":  # every layer starts from one init, as separate params
        assert tm.mask_value == 1e-5 and (tm.eval_items.shape, tm.eval_mask.shape) == \
            ((64, 21), (64, 21))
        for pre in ("v", "t"):
            for m in ("q", "k", "v", "o"):
                w0 = own[f"{pre}_{m}_w0"]
                assert all(torch.equal(own[f"{pre}_{m}_w{l}"], w0) for l in range(4))
                assert own[f"{pre}_{m}_w1"].data_ptr() != w0.data_ptr()


@pytest.mark.parametrize("name", EMBEDDING)
def test_graphs_match_jax(tiny_dataset, name):
    """The co-occurrence graph and the user graph drawn at construction and
    at epochs 0-2, equal; the kNN item graph's neighbours equal, weights to
    1e-6."""
    jm, tm, jp, _ = make_pair(tiny_dataset, FLAGS[name])
    for got, want in zip(tm._uu, jm._uu):
        np.testing.assert_array_equal(got, np.asarray(want))
    for epoch in (None, 0, 1, 2):
        if epoch is not None:
            jm.pre_epoch(jp, jax.random.PRNGKey(0), epoch)
            tm.pre_epoch(None, epoch)
        np.testing.assert_array_equal(tm.user_nbr_idx.numpy(), np.asarray(jm.user_nbr_idx))
        np.testing.assert_array_equal(tm.user_nbr_w.numpy(), np.asarray(jm.user_nbr_w))
    assert tm.user_nbr_idx.shape == (64, tm.uu_k if name == "COHESION" else tm.k)
    if name != "DualGNN":
        assert isinstance(tm.mm_graph, ELLGraph)
        np.testing.assert_array_equal(tm.mm_graph.indices.numpy(),
                                      np.asarray(jm.mm_graph.indices))
        np.testing.assert_allclose(tm.mm_graph.weights.numpy(),
                                   np.asarray(jm.mm_graph.weights), rtol=1e-6, atol=1e-7)


def test_cohesion_pruned_r_matches_jax(tiny_dataset):
    """At dropout 0.1, R over the JAX package's kept edges: bf16, the JAX
    package's float32 R rounded, entry for entry."""
    jm, tm, jp, _ = make_pair(tiny_dataset, VARIANTS["COHESION-dropout"])
    prepare(jm, tm, jp, epoch=1)
    assert tm.masked_r.dtype == torch.bfloat16
    want = torch.from_numpy(np.array(jm.masked_r, np.float32))
    assert int((want != 0).sum()) == int(384 * 0.9)
    np.testing.assert_array_equal(tm.masked_r.float().numpy(),
                                  want.to(torch.bfloat16).float().numpy())


CASES = [(v, s) for v in VARIANTS for s in (0, -1)]


@pytest.mark.parametrize("variant,step", CASES,
                         ids=[f"{v}-{'full' if s == 0 else 'padded'}_batch" for v, s in CASES])
def test_loss_and_gradients_match_jax(tiny_dataset, variant, step):
    flags = VARIANTS[variant]
    jloss, jg, tloss, grads = loss_and_grads(tiny_dataset, flags, step, 11 + step)
    assert_step_close(jloss, jg, tloss, grads, bf16_step(variant, flags))


@pytest.mark.parametrize("name", list(CLASSES))
def test_three_trainer_steps_match_jax(tiny_dataset, name):
    """Trainer.train_step on the JAX trainer's batches (the last one padded)
    against value_and_grad of the JAX loss and optax.adam, each step from
    equal params (LightGT under the JAX loss's draws): each step's loss and
    gradients."""
    ds, flags = tiny_dataset, FLAGS[name]
    jm, tm, jp, tp = make_pair(ds, flags)
    prepare(jm, tm, jp)
    trainer = tloop.Trainer(tm, ds, TConfig(**flags))
    params = {k: v.clone().requires_grad_() for k, v in tp.items()}
    opt = trainer.make_optimizer(params)
    jopt_fn = optax.adam(flags["learning_rate"])
    jopt = jopt_fn.init(jp)
    for step, arrays in enumerate(jax_batches(ds, flags["batch_size"])):
        jb, tb = both_batches(arrays)
        rng = jax.random.PRNGKey(100 + step)
        jloss, jg = _value_and_grad(jp, jm, jb, rng)
        with torch.no_grad():
            for k, v in jp.items():
                params[k].copy_(torch.from_numpy(np.array(v)))
        if name == "LightGT":
            drawn = lightgt_draws(jm, rng, arrays[0])
            tm.draws = lambda *args: drawn
        tloss = trainer.train_step(params, opt, tb)
        assert_step_close(jloss, jg, tloss.item(), {k: grad_np(v) for k, v in params.items()},
                          bf16_step(name, flags), f"step {step}")
        upd, jopt = jopt_fn.update(jg, jopt, jp)
        jp = optax.apply_updates(jp, upd)


def ranking_outputs(jm, tm, jp, tp):
    """(JAX, port) ranking tables: the embeddings, or LightGT's scores of
    every user over the JAX package's evaluation subsets."""
    if isinstance(tm, LightGT):
        tm.eval_items, tm.eval_mask = t(jm.eval_items).long(), t(jm.eval_mask)
        ids = np.arange(64)
        with torch.no_grad():
            got = tm.score_users(tp, torch.from_numpy(ids))
        return [np.asarray(jm.score_users(jp, jnp.asarray(ids)))], [got.numpy()]
    with torch.no_grad():
        got = tm.embeddings(tp)
    return [np.asarray(x) for x in jm.embeddings(jp)], [x.numpy() for x in got]


@pytest.mark.parametrize("name", list(CLASSES))
def test_ranking_tables_match_jax(tiny_dataset, name):
    """Embeddings (COHESION's at TOL: bf16 operands on both sides), or
    LightGT's scores with the JAX package's evaluation subsets carried in."""
    jm, tm, jp, tp = make_pair(tiny_dataset, FLAGS[name])
    want, got = ranking_outputs(jm, tm, jp, tp)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    if name == "COHESION":
        # float32 products with R would miss by R's bf16 rounding
        r32 = tm.graph.dense_r
        x = [tm._tower_input(tp, m, f) for m, f in (("id", tp["id_feat"]), ("v", tm.v_feat),
                                                     ("t", tm.t_feat))]
        ci = torch.cat(x, 1)[64:]
        assert r32.dtype == torch.float32
        assert (r32 @ ci - tm.masked_r.float() @ ci.to(torch.bfloat16).float()).abs().max() > 1e-4


@pytest.mark.parametrize("name", list(CLASSES))
def test_bf16_graph_matches_jax(tiny_dataset, name):
    """At graph_compute_dtype bfloat16: the ranking tables at
    PROP_TOL["bfloat16"], and one full batch's loss and gradients at the
    bf16 bounds."""
    flags = dict(FLAGS[name], graph_compute_dtype="bfloat16")
    jm, tm, jp, tp = make_pair(tiny_dataset, flags)
    assert tm.graph.dense_r.dtype == torch.bfloat16
    want, got = ranking_outputs(jm, tm, jp, tp)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **PROP_TOL["bfloat16"])
    jloss, jg, tloss, grads = loss_and_grads(tiny_dataset, flags, 0, 11)
    assert_step_close(jloss, jg, tloss, grads, True)


def test_resample_eval_once_per_evaluation_never_at_export(tiny_dataset, tmp_path,
                                                           monkeypatch):
    """Trainer.evaluate redraws LightGT's subsets once per ranking pass
    (then ranks with the new ones); export_artifact ranks with the last
    draw's and draws none."""
    ds = tiny_dataset
    cfg = TConfig(**FLAGS["LightGT"], num_epoch=2)
    _, tm, _, tp = make_pair(ds, FLAGS["LightGT"])
    trainer = tloop.Trainer(tm, ds, cfg)
    calls, real = [], tm.resample_eval

    def counted():
        calls.append(1)
        real()

    monkeypatch.setattr(tm, "resample_eval", counted)
    seen = []
    for _ in range(2):
        before = tm.eval_items.clone()
        _, _, rank = trainer.evaluate(tp)
        seen.append(tm.eval_items.clone())
        assert not torch.equal(before, tm.eval_items)
        np.testing.assert_array_equal(rank.numpy(), rank_from_scores(
            tm, tp, trainer.history, cfg.rank_topk).numpy())
    assert len(calls) == 2 and tm._eval_draws == 3
    trainer.run()
    assert len(calls) == 4
    last = tm.eval_items.clone()
    path = export_artifact(tm, tp, None, ds, str(tmp_path / "lightgt.npz"))
    assert len(calls) == 4 and torch.equal(tm.eval_items, last)
    with np.load(path) as z:
        want = rank_from_scores(tm, tp, trainer.history, 200).numpy()
        np.testing.assert_array_equal(z["rank_ids"], want)


@pytest.mark.parametrize("name", list(CLASSES))
def test_cli_log_matches_jax_cli(tiny_dataset, monkeypatch, tmp_path, name):
    """Each package's cli.run of the first combo, 2 epochs: the same line
    shapes. COHESION's and LightGT's best epochs are exported and served:
    COHESION's answers are the artifact tables' own top 10 (bf16 inputs,
    summed in float64 here), LightGT's its rank lists' first 10; neither
    holds a seen item."""
    ds = tiny_dataset
    _, art = cli_logs_match(ds, monkeypatch, tmp_path, FLAGS[name], export=name in EXPORTED,
                            num_epoch=2)
    if not art:
        return
    rec = Recommender.load(art, "cpu")
    users = list(range(ds.num_user))
    with np.load(art) as z:
        assert str(z["model"]) == name
        if name == "LightGT":
            assert str(z["kind"]) == "ranklists" and z["rank_ids"].shape == (64, 48)
            rank_ids, rank_scores = z["rank_ids"], z["rank_scores"]
        else:
            assert str(z["kind"]) == "embeddings"
            user_emb, item_emb = z["user_emb"], z["item_emb"]
            assert user_emb.shape == (64, 48) and item_emb.shape == (48, 48)
    for u, recs in zip(users, rec.recommend(users, k=10)):
        seen = set(ds.history.values[u, :ds.history.lengths[u]].tolist())
        got = [(i - ds.num_user, s) for i, s in recs]
        assert len(got) == 10 and not seen & {i for i, _ in got}
        if name == "LightGT":
            assert [i for i, _ in recs] == rank_ids[u, :10].tolist()
            assert [s for _, s in recs] == rank_scores[u, :10].tolist()
            continue
        ub, ib = (torch.from_numpy(x).to(torch.bfloat16).double().numpy()
                  for x in (user_emb[u], item_emb))
        want = ib @ ub
        want[list(seen)] = -np.inf
        kth = np.sort(want)[-10]
        for i, score in got:
            assert score == pytest.approx(want[i], rel=1e-5, abs=1e-6)
            assert want[i] >= kth - 1e-6
