"""models/dhcf.py, lightgode.py, selfcf.py, fkan_gcf.py, mcln.py and
ops/kan.py against the JAX package's, and the trainer's interest items
(``Batch.int_items``).

Both packages build each model from ``tiny_dataset`` (64 users x 48 items,
384 train edges, 32- and 16-wide features) at dim 16 on a float32 graph,
with its Model_YAML file's first combo otherwise (DHCF 1 layer, dropout 0;
SelfCF 2 layers, dropout 0.5; FKAN_GCF 3 layers, so 2, grid 1; MCLN 3
layers, 4 blocks), and DHCF and FKAN_GCF also with their dropouts on. The
port takes the JAX package's initial params, DHCF's frozen DJconv weights
(``DHCF.load_frozen_weights``), its batches, negatives and interest items,
and the draws its loss makes from its key (dropout masks, SelfCF's rate
and edge uniforms), given to ``loss_with_draws``.

Tolerances: each loss to rtol 1e-5; every gradient to 1e-4 of its
tensor's largest entry plus 1e-6; the embeddings to rtol 1e-5, atol 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chaorec_tpu.data import sampling as jsampling
from chaorec_tpu.models.base import Batch as JBatch
from chaorec_tpu.ops import kan as jkan
from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.graphs.dropout import EdgeBags, edge_propagate
from chaorec_tpu_torch.models import build_model as tbuild
from chaorec_tpu_torch.models.base import Batch as TBatch
from chaorec_tpu_torch.models.dhcf import DHCF
from chaorec_tpu_torch.models.fkan_gcf import FKAN_GCF
from chaorec_tpu_torch.models.lightgode import LightGODE
from chaorec_tpu_torch.models.mcln import MCLN
from chaorec_tpu_torch.models.selfcf import SelfCF
from chaorec_tpu_torch.ops import kan as tkan
from chaorec_tpu_torch.ops.init import xavier_uniform
from chaorec_tpu_torch.train import loop as tloop
from chip_smoke import Kinks, device_step, draws_step
from test_torch_lightgcn import assert_grads_close, jax_batches, make_pair
from test_torch_vae import adam_step, cli_logs_match, one_torch_thread, t  # noqa: F401

BASE = dict(batch_size=100, dim_E=16, graph_compute_dtype="float32", topk=(5, 10, 20))
DHCF_F = dict(BASE, Model="DHCF", n_layers=1, learning_rate=0.001, reg_weight=0.001, dropout=0.0)
LIGHTGODE = dict(BASE, Model="LightGODE", gamma=0.2, learning_rate=0.001, t=1.2)
SELFCF = dict(BASE, Model="SelfCF", n_layers=2, learning_rate=0.01, reg_weight=1e-4,
              dropout=0.5)
FKAN = dict(BASE, Model="FKAN_GCF", n_layers=3, learning_rate=0.001, reg_weight=1.0,
            node_dropout=0.0, message_dropout=0.0, grid_size=1)
MCLN_F = dict(BASE, Model="MCLN", n_layers=3, learning_rate=0.001, reg_weight=1e-7, n_mca=4)
FLAGS = {"DHCF": DHCF_F, "LightGODE": LIGHTGODE, "SelfCF": SELFCF, "FKAN_GCF": FKAN,
         "MCLN": MCLN_F,
         # the dropouts on, beside the first combos' zeros
         "DHCF-dropout": dict(DHCF_F, dropout=0.1, n_layers=2),
         "FKAN_GCF-dropout": dict(FKAN, node_dropout=0.1, message_dropout=0.2, grid_size=2)}
CLASSES = {"DHCF": DHCF, "LightGODE": LightGODE, "SelfCF": SelfCF, "FKAN_GCF": FKAN_GCF,
           "MCLN": MCLN}
TOL = dict(rtol=1e-5, atol=1e-6)


def pair(ds, name):
    """(JAX model, port model, JAX params, port params); DHCF's frozen
    weights carried over."""
    jm, tm, jp, tp = make_pair(ds, FLAGS[name])
    if isinstance(tm, DHCF):
        tm.load_frozen_weights([np.asarray(w) for w in jm.frozen_w])
    return jm, tm, jp, tp


@functools.partial(jax.jit, static_argnums=2)
def _jax_draws(jm, rng, b):
    """The draws each JAX loss makes from ``rng`` for a batch of ``b`` rows,
    repeating its split order (dhcf.py:91-96, selfcf.py:54-60 and :85-93,
    fkan_gcf.py:61-64 and :77-92); masks as float32, None where none."""
    if jm.name == "DHCF":
        if jm.dropout <= 0:
            return None
        keep, out = 1.0 - jm.dropout, []
        for _ in range(jm.n_layers):
            rng, ku, ki = jax.random.split(rng, 3)
            out.append((jax.random.bernoulli(ku, keep, (jm.num_user, jm.dim_E)) * 1.0,
                        jax.random.bernoulli(ki, keep, (jm.num_item, jm.dim_E)) * 1.0))
        return out
    if jm.name == "SelfCF":
        k_enc, k_du, k_di = jax.random.split(rng, 3)
        k_rate, k_mask = jax.random.split(k_enc)
        keep = 1.0 - jm.dropout
        return {"rate": jax.random.uniform(k_rate, ()),
                "edge_u": jax.random.uniform(k_mask, jm.graph.w_by_u.shape),
                "keep_u": jax.random.bernoulli(k_du, keep, (b, jm.dim_E)) * 1.0,
                "keep_i": jax.random.bernoulli(k_di, keep, (b, jm.dim_E)) * 1.0}
    out = []
    for _ in range(jm.n_gnn):
        rng, k_adj, k_mu, k_mi = jax.random.split(rng, 4)
        d = {}
        if jm.node_dropout > 0:
            ku, ki = jax.random.split(k_adj)
            keep = 1.0 - jm.node_dropout
            d["node_u"] = jax.random.bernoulli(ku, keep, jm.graph.w_by_u.shape) * 1.0
            d["node_i"] = jax.random.bernoulli(ki, keep, jm.graph.w_by_i.shape) * 1.0
        if jm.message_dropout > 0:
            keep = 1.0 - jm.message_dropout
            d["msg_u"] = jax.random.bernoulli(k_mu, keep, (jm.num_user, jm.dim_E)) * 1.0
            d["msg_i"] = jax.random.bernoulli(k_mi, keep, (jm.num_item, jm.dim_E)) * 1.0
        out.append(d)
    return out


def jax_draws(jm, rng, b):
    """``_jax_draws`` as tensors; None for the models that draw nothing."""
    if jm.name in ("LightGODE", "MCLN"):
        return None
    d = _jax_draws(jm, rng, b)
    if d is None:
        return None
    if isinstance(d, dict):
        return {k: t(v) for k, v in d.items()}
    return [tuple(t(v) for v in x) if isinstance(x, tuple) else {k: t(v) for k, v in x.items()}
            for x in d]


def _loss(p, m, b, r):
    return m.loss(p, b, r)


_VALUE_AND_GRAD = jax.jit(jax.value_and_grad(_loss))


def grad_np(p):
    """A leaf's gradient as numpy; zeros where the loss never read it
    (MCLN's image and text user tables are read by the ranking only, and
    JAX's gradient is zero there)."""
    return np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()


def batches_both(ds, name, steps=(0, 1, -1)):
    """The JAX trainer's batches ``steps`` with their negatives and, for
    MCLN, interest items (``sample_negatives`` on a second key), as a JAX
    and a port ``Batch`` each."""
    history = jnp.asarray(ds.history.values)
    out = []
    for n, (u, p, neg, w) in zip(steps, jax_batches(ds, 100, steps)):
        ints = None
        if name == "MCLN":
            ints = np.asarray(jsampling.sample_negatives(
                jax.random.PRNGKey(70 + n % 4), jnp.asarray(u), history, ds.num_item))
        jb = JBatch(jnp.asarray(u), jnp.asarray(p), jnp.asarray(neg), jnp.asarray(w),
                    None, None if ints is None else jnp.asarray(ints))
        tb = TBatch(torch.from_numpy(np.array(u)).long(), torch.from_numpy(np.array(w)),
                    pos_items=torch.from_numpy(np.array(p)).long(),
                    neg_items=torch.from_numpy(np.array(neg)).long(),
                    int_items=None if ints is None else torch.from_numpy(ints).long())
        out.append((jb, tb))
    return out


@pytest.mark.parametrize("name", list(CLASSES))
def test_build_goes_through_build_model(tiny_dataset, name):
    jm, tm, jp, tp = pair(tiny_dataset, name)
    assert isinstance(tm, CLASSES[name]) and tm.name == name
    assert (tm.rank_mode, tm.stateful, tm.trainer_mode) == ("embeddings", False, "bpr")
    assert tm.needs_int_items == (name == "MCLN")
    own = tm.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    if name == "FKAN_GCF":
        assert tm.n_gnn == 2 and own["kan_0"].shape == (2, 16, 16, 1)  # the zip quirk
    if name == "DHCF":
        np.testing.assert_allclose(tm.g.numpy(), np.asarray(jm.g), rtol=1e-6)
        for a, b in ((tm.dv_u, jm.dv_u), (tm.de_u, jm.de_u), (tm.dv_i, jm.dv_i),
                     (tm.de_i, jm.de_i)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    if name == "MCLN":
        assert tm.v_feat.shape == (48, 32) and tm.t_feat.shape == (48, 16)


@pytest.mark.parametrize("name,step", [(n, s) for n in FLAGS for s in (0, -1)],
                         ids=[f"{n}-{'full' if s == 0 else 'padded'}_batch" for n in FLAGS
                              for s in (0, -1)])
def test_loss_and_gradients_match_jax(tiny_dataset, name, step):
    jm, tm, jp, tp = pair(tiny_dataset, name)
    jb, tb = batches_both(tiny_dataset, name.split("-")[0], (step,))[0]
    rng = jax.random.PRNGKey(11)
    jloss, jg = _VALUE_AND_GRAD(jp, jm, jb, rng)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tloss, _ = draws_step(tm, leaves, None, tb, jax_draws(jm, rng, 100))
    tloss.backward()
    assert tloss.item() == pytest.approx(float(jloss), rel=1e-5)
    for k in jg:
        assert_grads_close(grad_np(leaves[k]), np.asarray(jg[k]), k)


@pytest.mark.parametrize("name", list(FLAGS))
def test_three_trainer_steps_match_jax(tiny_dataset, name):
    """Trainer.train_step on the JAX trainer's batches (the last one
    padded) against value_and_grad of the JAX loss and optax.adam, each
    step from equal params, under the JAX loss's draws: each step's loss
    and gradients."""
    ds = tiny_dataset
    jm, tm, jp, tp = pair(ds, name)
    flags = FLAGS[name]
    trainer = tloop.Trainer(tm, ds, TConfig(**flags))
    params = {k: v.clone().requires_grad_() for k, v in tp.items()}
    opt = trainer.make_optimizer(params)
    jopt = optax.adam(flags["learning_rate"]).init(jp)
    for step, (jb, tb) in enumerate(batches_both(ds, name.split("-")[0])):
        rng = jax.random.PRNGKey(100 + step)
        jloss, jg = _VALUE_AND_GRAD(jp, jm, jb, rng)
        with torch.no_grad():
            for k, v in jp.items():
                params[k].copy_(torch.from_numpy(np.array(v)))
        drawn = jax_draws(jm, rng, 100)
        tm.draws = lambda *args: drawn
        tloss = trainer.train_step(params, opt, tb)
        assert tloss.item() == pytest.approx(float(jloss), rel=1e-5), step
        for k in jg:
            assert_grads_close(grad_np(params[k]), np.asarray(jg[k]), f"{k} step {step}")
        jp, jopt = adam_step(jg, jopt, jp, flags["learning_rate"])


@pytest.mark.parametrize("name", list(CLASSES))
def test_embeddings_match_jax(tiny_dataset, name):
    jm, tm, jp, tp = pair(tiny_dataset, name)
    ju, ji = jm.embeddings(jp)
    with torch.no_grad():
        tu, ti = tm.embeddings(tp)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **TOL)


def test_dhcf_djconv_weights_are_frozen_buffers(tiny_dataset):
    """DHCF's W are drawn from a generator seeded seed + 7, are no params,
    never reach the optimizer and stay as they are through training steps
    (at dropout 0.1, where the loss does read them)."""
    ds = tiny_dataset
    cfg = TConfig(**dict(FLAGS["DHCF-dropout"], seed=3))
    tm = tbuild(cfg, ds, "cpu")
    gen = torch.Generator().manual_seed(3 + 7)
    want = [xavier_uniform(gen, (16, 16)) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(tm.frozen_w, want))
    assert not any(w.requires_grad for w in tm.frozen_w)
    trainer = tloop.Trainer(tm, ds, cfg)
    params = trainer.init_params()
    opt = trainer.make_optimizer(params)
    in_opt = {id(p) for g in opt.param_groups for p in g["params"]}
    assert in_opt == {id(p) for p in params.values()}
    assert not {id(w) for w in tm.frozen_w} & in_opt
    before = [w.clone() for w in tm.frozen_w]
    trainer.train_epoch(params, opt)
    assert all(torch.equal(a, b) for a, b in zip(tm.frozen_w, before))
    with pytest.raises(ValueError):
        tm.load_frozen_weights(before[:1])


def test_bpr_batch_draws_interest_items_only_when_asked(tiny_dataset):
    """Trainer.bpr_batch: the negatives, then (MCLN only) the interest
    items, both from the trainer's generator by ``sample_negatives`` and
    from outside each user's history; a model that does not ask gets none
    and its negatives are the same draw."""
    from chaorec_tpu_torch.data.sampling import make_edge_batches, sample_negatives

    ds = tiny_dataset
    hist = {u: set(ds.history.values[u][:ds.history.lengths[u]].tolist())
            for u in range(ds.num_user)}
    out = {}
    for name in ("MCLN", "LightGODE"):
        cfg = TConfig(**FLAGS[name])
        trainer = tloop.Trainer(tbuild(cfg, ds, "cpu"), ds, cfg)
        batch = make_edge_batches(trainer.generator, trainer.edges, 100)[-1]
        state = trainer.generator.get_state()
        full = trainer.bpr_batch(batch)
        trainer.generator.set_state(state)
        neg = sample_negatives(trainer.generator, batch.users, trainer.history, 48)
        assert torch.equal(full.neg_items, neg)
        if name == "MCLN":
            ints = sample_negatives(trainer.generator, batch.users, trainer.history, 48)
            assert torch.equal(full.int_items, ints)
            assert not torch.equal(full.int_items, full.neg_items)
            for u, i in zip(full.users.tolist(), full.int_items.tolist()):
                assert 0 <= i < 48 and i not in hist[u]
        else:
            assert full.int_items is None
        out[name] = full
    assert torch.equal(out["MCLN"].neg_items, out["LightGODE"].neg_items)


def test_fourier_kan_matches_jax():
    rs = np.random.default_rng(0)
    x = rs.standard_normal((7, 5)).astype(np.float32)
    c = jkan.fourier_kan_init(jax.random.PRNGKey(0), 5, 3, 4)
    cc = np.asarray(rs.standard_normal((5, 3, 4)), np.float32)
    got = tkan.fourier_kan(torch.from_numpy(x), torch.from_numpy(np.asarray(c)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jkan.fourier_kan(jnp.asarray(x), c)),
                               **TOL)
    got = tkan.cheby_kan(torch.from_numpy(x), torch.from_numpy(cc))
    np.testing.assert_allclose(got.numpy(), np.asarray(jkan.cheby_kan(jnp.asarray(x),
                                                                      jnp.asarray(cc))), **TOL)
    own = tkan.fourier_kan_init(torch.Generator().manual_seed(0), 64, 64, 1)
    assert own.shape == (2, 64, 64, 1) and abs(float(own.std()) - 1 / 8) < 0.01


def test_two_sided_edge_hop_gradients(tiny_dataset):
    """edge_propagate with an item side of its own weights (FKAN_GCF's node
    dropout): the sums are those of the two weighted incidences, and the
    gradients in both tables and both weight vectors pass gradcheck."""
    ds = tiny_dataset
    e = ds.train_edges[:60].astype(np.int64)
    eu, ei = torch.from_numpy(e[:, 0]), torch.from_numpy(e[:, 1])
    bags = EdgeBags.build(eu, ei, 64, 48)
    rs = np.random.default_rng(1)
    w, w_i = (torch.from_numpy(rs.random(60)).double().requires_grad_() for _ in range(2))
    xu = torch.from_numpy(rs.standard_normal((64, 3))).double().requires_grad_()
    xi = torch.from_numpy(rs.standard_normal((48, 3))).double().requires_grad_()
    gu, gi = edge_propagate(eu, ei, w, xu, xi, 64, 48, bags, w_item=w_i)
    a = torch.zeros(64, 48, dtype=torch.float64).index_put_((eu, ei), w.detach(), accumulate=True)
    b = torch.zeros(64, 48, dtype=torch.float64).index_put_((eu, ei), w_i.detach(),
                                                            accumulate=True)
    # float32 sums against float64 products
    np.testing.assert_allclose(gu.detach().numpy(), (a @ xi.detach()).numpy(), **TOL)
    np.testing.assert_allclose(gi.detach().numpy(), (b.t() @ xu.detach()).numpy(), **TOL)

    def hop(w, w_i, xu, xi):
        # float32 sums inside: checked in float64 through the double casts
        out = edge_propagate(eu, ei, w, xu, xi, 64, 48, bags, w_item=w_i)
        return tuple(o.double() for o in out)

    assert torch.autograd.gradcheck(hop, (w, w_i, xu, xi), eps=1e-3, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("name", list(CLASSES))
def test_cli_log_matches_jax_cli(tiny_dataset, monkeypatch, tmp_path, name):
    _, art = cli_logs_match(tiny_dataset, monkeypatch, tmp_path, FLAGS[name],
                            export=name == "MCLN")
    if art:
        with np.load(art) as z:
            assert str(z["kind"]) == "embeddings"
            assert z["user_emb"].shape == (64, 48) and z["item_emb"].shape == (48, 48)


def _card_cases():
    from test_torch_diffrec import F32 as DIFFREC
    from test_torch_vae import FLAGS as VAES

    return {**VAES, "DiffRec": DIFFREC, **{n: FLAGS[n] for n in CLASSES},
            "FKAN_GCF-dropout": FLAGS["FKAN_GCF-dropout"]}


def card_vs_cpu_step(ds, name, device):
    """One step of ``name`` on ``device`` against the same step on the CPU,
    as chip_smoke.py's phase 37 takes it: equal params, batch, state and
    draws, the card held to the CPU's side of every ReLU kink
    (``chip_smoke.Kinks``); the loss to rtol 1e-5, the gradients and the
    new state to 1e-4 of their tensor's largest entry plus 1e-6."""
    from chaorec_tpu_torch.data.sampling import make_edge_batches, make_epoch_batches

    cfg = TConfig(**_card_cases()[name])
    cpu_model, card_model = tbuild(cfg, ds, "cpu"), tbuild(cfg, ds, device)
    if isinstance(cpu_model, DHCF):  # each device's generator draws its own W
        card_model.load_frozen_weights(cpu_model.frozen_w)
    trainer = tloop.Trainer(cpu_model, ds, cfg)
    params, state = trainer.init_params(), trainer.model_state
    batch = (make_epoch_batches(trainer.generator, ds.num_user, 24)[-1] if trainer.user_rows
             else trainer.bpr_batch(make_edge_batches(trainer.generator, trainer.edges, 100)[-1]))
    draws = (cpu_model.draws(trainer.generator, batch, state)
             if hasattr(cpu_model, "draws") else None)
    kinks = Kinks()
    c_loss, c_grads, c_new = device_step(cpu_model, params, state, batch, draws, kinks.record())
    g_loss, g_grads, g_new = device_step(card_model, params, state, batch, draws,
                                         kinks.replay())
    assert g_loss == pytest.approx(c_loss, rel=1e-5)
    for k in c_grads:
        assert_grads_close(g_grads[k].numpy(), c_grads[k].numpy(), k)
    for k, v in (c_new or {}).items():
        assert_grads_close(g_new[k].numpy(), v.numpy(), f"state {k}")


CARD_CASES = ["MultVAE", "MacridVAE", "DualVAE", "DiffRec", *CLASSES, "FKAN_GCF-dropout"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_CASES)
def test_card_step_matches_cpu_step(tiny_dataset, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card_vs_cpu_step(tiny_dataset, name, "cuda")


@pytest.mark.parametrize("name", ["MCLN", "FKAN_GCF"])
def test_kinks_hold_a_step_to_its_recorded_relu_sides(tiny_dataset, name):
    """chip_smoke.Kinks, through which the card's step takes the CPU's side
    of every ReLU (MCLN) and LeakyReLU (FKAN_GCF) kink: replaying a step's
    own record gives that step's bits with no flip; a record with one unit
    on the other side is counted, and moves that unit's gradient."""
    from chaorec_tpu_torch.data.sampling import make_edge_batches

    cfg = TConfig(**FLAGS[name])
    model = tbuild(cfg, tiny_dataset, "cpu")
    trainer = tloop.Trainer(model, tiny_dataset, cfg)
    params = trainer.init_params()
    batch = trainer.bpr_batch(make_edge_batches(trainer.generator, trainer.edges, 100)[0])
    kinks = Kinks()
    loss, grads, _ = device_step(model, params, None, batch, None, kinks.record())
    assert kinks.masks and kinks.flips == 0
    again, same, _ = device_step(model, params, None, batch, None, kinks.replay())
    assert kinks.flips == 0 and again == loss
    assert all(torch.equal(same[k], grads[k]) for k in grads)
    kinks.masks[-1] = kinks.masks[-1].clone()
    kinks.masks[-1].view(-1)[0] ^= True
    _, moved, _ = device_step(model, params, None, batch, None, kinks.replay())
    assert kinks.flips == 1
    assert any(not torch.equal(moved[k], grads[k]) for k in grads)
