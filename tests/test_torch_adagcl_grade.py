"""models/adagcl.py and models/grade.py, with their multi-optimizer trainers,
against the JAX package's.

Both packages build each model from ``tiny_dataset`` (64 users x 48 items,
384 train edges) at dim 16 on a float32 graph, with its Model_YAML file's
first combo otherwise: AdaGCL at n_layers 1 (the first combo) and 2 (where
generator 2's second gate layer and the gradient through a gate's input
run), Grade at 2 layers (its combo has 5). The port takes the JAX
package's initial params, AdaGCL's frozen embedding copy
(``AdaGCL.load_frozen_feats``), the JAX trainer's batches and negatives,
and the draws the JAX step makes from its keys (AdaGCL: generator 1's
normal noise and generator 2's per-layer uniforms; Grade: loss_1's two
uniform noises and gen_loss's three normal ones).

The steps are held optimizer step by optimizer step over two batches: the
params after each step and the state (count, first and second moment) of
the optimizer that took it, against ``alternating_step`` and
``grade_step`` driven by optax, each package carrying its own params. A
missed double update, a skipped zero-gradient param (optax moves it by its
momentum) or a step count that falls behind fails there.

Tolerances are those of tests/test_torch_contrastive.py: each loss to rtol
1e-5; every gradient, and every first moment (0.1 g at the first step,
then a running mean of gradients), to 1e-4 of its tensor's largest entry
plus 1e-6; the embeddings and the params to rtol 1e-5, atol 1e-6; the
second moments (running means of g^2) to 1e-4 of their tensor's largest
entry plus 1e-12.
"""

import functools
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chaorec_tpu.models.adagcl import alternating_step as j_alternating_step
from chaorec_tpu.models.adagcl import generator_labels
from chaorec_tpu.models.grade import grade_step as j_grade_step
from chaorec_tpu.ops.losses import bpr_loss as j_bpr_loss
from chaorec_tpu.ops.losses import emb_l2_reg as j_emb_l2_reg
from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.models import adagcl as tada
from chaorec_tpu_torch.models import grade as tgrade
from chaorec_tpu_torch.ops.ell import build_segment_transpose, seg_sum, segment_bags
from test_torch_bspm import both_clis_export
from test_torch_lightgcn import (TOL, assert_grads_close, both_batches, jax_batches,
                                 make_pair)
from test_torch_vae import t
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

BASE = dict(batch_size=100, dim_E=16, graph_compute_dtype="float32", topk=(5, 10, 20))
ADAGCL_F = dict(BASE, Model="AdaGCL", n_layers=1, learning_rate=0.001, reg_weight=0.1,
                ssl_alpha=0.1, ssl_temp=0.1)
GRADE_F = dict(BASE, Model="Grade", n_layers=2, learning_rate=0.001, reg_weight=0.1,
               ssl_alpha=0.2, ssl_temp=0.3, ssl_temp2=0.3, noise_alpha=0.2)
FLAGS = {"AdaGCL": ADAGCL_F, "AdaGCL-2": dict(ADAGCL_F, n_layers=2), "Grade": GRADE_F}
ADAGCL = ["AdaGCL", "AdaGCL-2"]
V_TOL = 1e-4  # the second moments: share of the tensor's largest entry


def pair(ds, name):
    """(JAX model, port model, JAX params, port params); AdaGCL's port
    model takes the JAX model's frozen embedding copy."""
    jm, tm, jp, tp = make_pair(ds, FLAGS[name])
    if name.startswith("AdaGCL"):
        tm.load_frozen_feats(np.asarray(jm.frozen_feats))
    return jm, tm, jp, tp


def leaves_of(tp):
    return {k: v.clone().requires_grad_() for k, v in tp.items()}


def grads_np(leaves):
    return {k: np.zeros(tuple(v.shape), np.float32) if v.grad is None else v.grad.numpy()
            for k, v in leaves.items()}


def _tree(x):
    return jax.tree_util.tree_map(lambda a: t(a), x)


@functools.partial(jax.jit, static_argnums=0)
def _adagcl_draws(jm, k1, k2):
    """The draws of alternating_step's loss 3 (adagcl.py:139, :206)."""
    us = [jax.random.uniform(k, (jm.src.shape[0],), minval=1e-7, maxval=1 - 1e-7)
          for k in jax.random.split(k2, jm.n_layers)]
    return {"g1": jax.random.normal(k1, (jm.n_nodes, jm.dim_E)), "g2": us}


@functools.partial(jax.jit, static_argnums=0)
def _grade_draws(jm, k1, k3):
    """The draws of grade_step's loss_1 and gen_loss (grade.py:207, :250)."""
    k_nv, k_nt = jax.random.split(k1)
    shape = (jm.n_nodes, jm.dim_E)
    out = {"noise_v": jax.random.uniform(k_nv, shape), "noise_t": jax.random.uniform(k_nt, shape)}
    for i, k in enumerate(jax.random.split(k3, 3)):
        out[f"g{i + 1}"] = jax.random.normal(k, shape)
    return out


def jax_draws(jm, k1, k2):
    return _tree((_adagcl_draws if jm.name == "AdaGCL" else _grade_draws)(jm, k1, k2))


# the three AdaGCL losses as alternating_step writes them (adagcl.py:283-320)
def _j_loss1(pp, m, b):
    out1 = m.forward_graphcl(pp, m.g1_generate(pp))
    out2 = m.forward_graphcl_g2(pp)
    return m.ssl_alpha * m.loss_graphcl(out1, out2, b.users, b.pos_items, b.weights), (out1, out2)


def _j_loss2(pp, m, b, det1, det2):
    v1 = m.forward_graphcl(pp, m.g1_generate(pp))
    v2 = m.forward_graphcl_g2(pp)
    return m.ib_reg * (m.loss_graphcl(v1, det1, b.users, b.pos_items, b.weights)
                       + m.loss_graphcl(v2, det2, b.users, b.pos_items, b.weights))


def _j_loss3(pp, m, b, k1, k2):
    x = m.forward_graphcl(pp)
    xu, xi = x[:m.num_user], x[m.num_user:]
    uu, ppos, nneg = xu[b.users], xi[b.pos_items], xi[b.neg_items]
    w = b.weights
    bpr = j_bpr_loss(jnp.sum(uu * ppos, 1), jnp.sum(uu * nneg, 1), w, eps=1e-5)
    reg = j_emb_l2_reg(m.reg_weight, (pp["uEmbeds"][b.users], pp["iEmbeds"][b.pos_items],
                                      pp["iEmbeds"][b.neg_items]), w)
    return bpr + reg + m.g1_loss(pp, b, k1) + m.g2_loss(pp, b, k2)


_VG1 = jax.jit(jax.value_and_grad(_j_loss1, has_aux=True), static_argnums=1)
_VG2 = jax.jit(jax.value_and_grad(_j_loss2), static_argnums=1)
_VG3 = jax.jit(jax.value_and_grad(_j_loss3), static_argnums=1)
_VG_L1 = jax.jit(jax.value_and_grad(lambda p, m, b, r: m.loss_1(p, b, r)), static_argnums=1)
_VG_BPR = jax.jit(jax.value_and_grad(lambda p, m, b: m.bpr_reg_loss(p, b)), static_argnums=1)
_VG_GEN = jax.jit(jax.value_and_grad(lambda p, m, b, r: m.gen_loss(p, b, r)), static_argnums=1)


def assert_loss_and_grads(tloss, leaves, jloss, jg, what):
    assert tloss.item() == pytest.approx(float(jloss), rel=1e-5), what
    got = grads_np(leaves)
    for k in jg:
        assert_grads_close(got[k], np.asarray(jg[k]), f"{what}: {k}")


# ---------------------------------------------------------------------------
# build


@pytest.mark.parametrize("name", list(FLAGS))
def test_build_goes_through_build_model(tiny_dataset, name):
    jm, tm, jp, _ = pair(tiny_dataset, name)
    cls, trainer = ((tada.AdaGCL, tada.AdaGCLTrainer) if name.startswith("AdaGCL")
                    else (tgrade.Grade, tgrade.GradeTrainer))
    assert isinstance(tm, cls) and tm.trainer_cls is trainer
    assert (tm.rank_mode, tm.stateful, tm.trainer_mode) == ("embeddings", False, "bpr")
    np.testing.assert_array_equal(tm.src.numpy(), np.asarray(jm.src))
    np.testing.assert_array_equal(tm.dst.numpy(), np.asarray(jm.dst))
    np.testing.assert_array_equal(tm.w_norm.numpy(), np.asarray(jm.w_norm))
    own = tm.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert list(own) == list(jp)
    if name == "Grade":
        np.testing.assert_allclose(tm.mm_graph.weights.numpy(), np.asarray(jm.mm_graph.weights))
        np.testing.assert_array_equal(np.sort(tm.mm_graph.indices.numpy(), 1),
                                      np.sort(np.asarray(jm.mm_graph.indices), 1))


def test_adagcl_frozen_copy_is_carried_and_returned(tiny_dataset):
    """The builder draws the frozen copy from seed + 41 (the same copy for
    one seed, another for another); ``init_params`` returns copies of it
    (the generator draws the generator layers only); the carry sets it from
    the JAX model's, and g2_loss reads it, not the params."""
    from chaorec_tpu_torch.models import build_model

    ds = tiny_dataset
    cfg = TConfig(**ADAGCL_F)
    a, b = build_model(cfg, ds, "cpu"), build_model(cfg, ds, "cpu")
    c = build_model(cfg.replace(seed=cfg.seed + 1), ds, "cpu")
    assert torch.equal(a.frozen_feats, b.frozen_feats)
    assert not torch.equal(a.frozen_feats, c.frozen_feats)
    p = a.init_params(torch.Generator().manual_seed(5))
    assert torch.equal(torch.cat([p["uEmbeds"], p["iEmbeds"]]), a.frozen_feats)
    p["uEmbeds"].add_(1.0)  # the params own their memory
    assert torch.equal(a.frozen_feats, b.frozen_feats)

    jm, tm, jp, tp = pair(ds, "AdaGCL")
    np.testing.assert_array_equal(tm.frozen_feats.numpy(), np.asarray(jm.frozen_feats))
    own = tm.init_params(torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(own["iEmbeds"].numpy(), np.asarray(jp["iEmbeds"]))
    jb, tb = both_batches(jax_batches(ds, 100, (0,))[0])
    k = jax.random.PRNGKey(3)
    us = jax_draws(jm, k, k)["g2"]
    want = float(jm.g2_loss(jp, jb, k))
    assert tm.g2_loss(tp, tb, us).item() == pytest.approx(want, rel=1e-5)
    tm.frozen_feats = a.frozen_feats  # another copy: another loss, equal params
    assert tm.g2_loss(tp, tb, us).item() != pytest.approx(want, rel=1e-3)


# ---------------------------------------------------------------------------
# losses and gradients


@pytest.mark.parametrize("name", ADAGCL)
@pytest.mark.parametrize("step", [0, -1], ids=["full_batch", "padded_batch"])
def test_adagcl_losses_and_gradients_match_jax(tiny_dataset, name, step):
    """The three losses of alternating_step and their gradients at one set
    of params; loss 2 against loss 1's views, detached."""
    jm, tm, jp, tp = pair(tiny_dataset, name)
    jb, tb = both_batches(jax_batches(tiny_dataset, 100, (step,))[0])
    k1, k2 = jax.random.split(jax.random.PRNGKey(11 + step))

    (jl1, (o1, o2)), jg1 = _VG1(jp, jm, jb)
    leaves = leaves_of(tp)
    tl1, views = tm.loss_1(leaves, tb)
    tl1.backward()
    assert_loss_and_grads(tl1, leaves, jl1, jg1, "loss 1")
    for got, want in zip(views, (o1, o2)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)

    jl2, jg2 = _VG2(jp, jm, jb, o1, o2)
    leaves = leaves_of(tp)
    tl2 = tm.loss_2(leaves, tb, (t(o1), t(o2)))
    tl2.backward()
    assert_loss_and_grads(tl2, leaves, jl2, jg2, "loss 2")

    jl3, jg3 = _VG3(jp, jm, jb, k1, k2)
    leaves = leaves_of(tp)
    tl3 = tm.loss_3(leaves, tb, jax_draws(jm, k1, k2))
    tl3.backward()
    assert_loss_and_grads(tl3, leaves, jl3, jg3, "loss 3")


@pytest.mark.parametrize("step", [0, -1], ids=["full_batch", "padded_batch"])
def test_grade_losses_and_gradients_match_jax(tiny_dataset, step):
    jm, tm, jp, tp = pair(tiny_dataset, "Grade")
    jb, tb = both_batches(jax_batches(tiny_dataset, 100, (step,))[0])
    k1, k3 = jax.random.split(jax.random.PRNGKey(11 + step))
    draws = jax_draws(jm, k1, k3)
    for what, (jl, jg), fn in (
            ("loss_1", _VG_L1(jp, jm, jb, k1), lambda p: tm.loss_1(p, tb, draws)),
            ("bpr_reg_loss", _VG_BPR(jp, jm, jb), lambda p: tm.bpr_reg_loss(p, tb)),
            ("gen_loss", _VG_GEN(jp, jm, jb, k3), lambda p: tm.gen_loss(p, tb, draws))):
        leaves = leaves_of(tp)
        loss = fn(leaves)
        loss.backward()
        assert_loss_and_grads(loss, leaves, jl, jg, what)


# ---------------------------------------------------------------------------
# the steps, optimizer by optimizer, over two batches


def _recording(opt, log, label):
    """``opt`` whose every update appends (label, params after the update,
    the new state) to ``log``, as alternating_step and grade_step apply it."""
    def update(g, state, params=None):
        upd, new = opt.update(g, state, params)
        log.append((label, optax.apply_updates(params, upd), new))
        return upd, new
    return optax.GradientTransformation(opt.init, update)


def _adam_state(state):
    """The ScaleByAdamState inside an optax adam or multi_transform state."""
    if isinstance(state, optax.ScaleByAdamState):
        return state
    if isinstance(state, optax.MultiTransformState):
        return _adam_state(state.inner_states["g"])
    if hasattr(state, "inner_state"):
        return _adam_state(state.inner_state)
    if isinstance(state, tuple):
        for s in state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


def _jax_optimizers(jm, lr):
    """(main Adam, the generators' Adams) as the JAX trainers build them."""
    if jm.name == "AdaGCL":
        gens = [optax.multi_transform({"g": optax.adam(lr), "f": optax.set_to_zero()},
                                      generator_labels(jm, "g1_")),
                optax.multi_transform({"g": optax.adam(lr, eps=1e-3), "f": optax.set_to_zero()},
                                      generator_labels(jm, "g2_"))]
    else:
        gens = [optax.multi_transform({"g": optax.adam(lr), "f": optax.set_to_zero()},
                                      generator_labels(jm, f"g{i}_")) for i in (1, 2, 3)]
    return optax.adam(lr), gens


@functools.lru_cache(maxsize=None)
def _jax_step_fn(jm, lr):
    """A jitted step of the JAX package's own alternating_step or
    grade_step, returning its loss and, per optimizer step, (label, params
    after it, that optimizer's new state)."""
    main, gens = _jax_optimizers(jm, lr)
    labels = ["main1", "main2", "main3", "g1", "g2"] if jm.name == "AdaGCL" else \
        ["main1", "main2", "g1", "g2", "g3"]

    def step(params, o, os_, batch, k1, k2):
        log = []
        n_main = 3 if jm.name == "AdaGCL" else 2
        calls = iter(labels)

        class Main:  # one transformation, its calls labelled in turn
            init = main.init

            @staticmethod
            def update(g, state, params=None):
                return _recording(main, log, next(calls)).update(g, state, params)

        rec_gens = [_recording(g, log, lab) for g, lab in zip(gens, labels[n_main:])]
        if jm.name == "AdaGCL":
            out = j_alternating_step(jm, Main, *rec_gens, params, o, *os_, batch, k1, k2)
        else:
            out = j_grade_step(jm, Main, tuple(rec_gens), params, o, tuple(os_), batch, k1, k2)
        if not order:  # recorded when traced: the labels in the order they were called
            order.extend(entry[0] for entry in log)
        return out[-1], [entry[1:] for entry in log]

    order = []
    jitted = jax.jit(step)

    def run(*args):
        loss, log = jitted(*args)
        return loss, [(label, *entry) for label, entry in zip(order, log)]

    return run, main, gens


def _port_state(opt, params):
    """{name: (step, exp_avg, exp_avg_sq)} of the params ``opt`` steps (a
    param it has never stepped: step 0)."""
    mine = {id(p) for g in opt.param_groups for p in g["params"]}
    zeros = {"step": 0, "exp_avg": torch.zeros(()), "exp_avg_sq": torch.zeros(())}
    return {k: (int(s["step"]), s["exp_avg"].numpy().copy(), s["exp_avg_sq"].numpy().copy())
            for k, p in params.items() if id(p) in mine
            for s in (opt.state.get(p) or zeros,)}


def _assert_state_close(got, want, what):
    """``_port_state`` against an optax ScaleByAdamState: the same params,
    one count, the moments within the first and second moment tolerances."""
    assert set(got) == {k for k, v in want.mu.items()
                        if not isinstance(v, optax.MaskedNode)}, what
    assert {c for c, _, _ in got.values()} == {int(want.count)}, what
    for k, (_, m, v) in got.items():
        assert_grads_close(m, np.asarray(want.mu[k]), f"{what}: first moment of {k}")
        wv = np.asarray(want.nu[k])
        np.testing.assert_allclose(v, wv, rtol=0, atol=V_TOL * float(np.abs(wv).max()) + 1e-12,
                                   err_msg=f"{what}: second moment of {k}")


@pytest.mark.parametrize("name", list(FLAGS))
def test_steps_match_jax_optimizer_by_optimizer(tiny_dataset, name):
    """Two batches of the family trainer's step (its own optimizers, as
    ``make_optimizer`` builds them) against the JAX step driven by optax:
    after every optimizer step, every param and the state of the optimizer
    that stepped, each package carrying its own params from batch to
    batch."""
    ds = tiny_dataset
    jm, tm, jp, tp = pair(ds, name)
    flags = FLAGS[name]
    family = tm.trainer_cls(tm, ds, TConfig(**flags))
    params = leaves_of(tp)
    opt = family.make_optimizer(params)
    step_fn, main, gens = _jax_step_fn(jm, flags["learning_rate"])
    o, os_ = main.init(jp), [g.init(jp) for g in gens]
    n_main = 3 if name.startswith("AdaGCL") else 2
    by_label = {**{f"main{i + 1}": opt for i in range(n_main)},
                **{f"g{i + 1}": g for i, g in enumerate(family.gen_opts)}}
    port_step = tada.alternating_step if name.startswith("AdaGCL") else tgrade.grade_step
    for b, arrays in enumerate(jax_batches(ds, flags["batch_size"], (0, 1))):
        jb, tb = both_batches(arrays)
        k1, k2 = jax.random.split(jax.random.PRNGKey(100 + b))
        jloss, log = step_fn(jp, o, os_, jb, k1, k2)
        seen = []

        def on_step(label):
            seen.append((label, {k: v.detach().numpy().copy() for k, v in params.items()},
                         _port_state(by_label[label], params)))

        tloss = port_step(tm, (opt, *family.gen_opts), params, tb, jax_draws(jm, k1, k2),
                          on_step=on_step)
        assert tloss.item() == pytest.approx(float(jloss), rel=1e-5), f"batch {b}"
        assert [s[0] for s in seen] == [entry[0] for entry in log]
        for (label, got, state), (_, want, jstate) in zip(seen, log):
            what = f"batch {b} after {label}"
            for k in want:
                np.testing.assert_allclose(got[k], np.asarray(want[k]), **TOL,
                                           err_msg=f"{what}: {k}")
            _assert_state_close(state, _adam_state(jstate), what)
        jp = log[-1][1]
        o = log[n_main - 1][2]
        os_ = [entry[2] for entry in log[n_main:]]


def test_trainer_steps_every_optimizer_each_batch(tiny_dataset):
    """AdaGCLTrainer.train_epoch takes alternating_step on every batch: at
    the epoch's end each optimizer has stepped once a batch (the main Adam
    three times), and every param of each has the same count."""
    ds = tiny_dataset
    _, tm, _, tp = pair(ds, "AdaGCL-2")
    family = tm.trainer_cls(tm, ds, TConfig(**FLAGS["AdaGCL-2"]))
    params = leaves_of(tp)
    opt = family._base.make_optimizer(params)  # the family's: it makes the generators' Adams
    assert len(family.gen_opts) == 2
    loss = family._base.train_epoch(params, opt)
    n = -(-ds.num_edges // 100)
    assert np.isfinite(loss)
    for o, per_batch in ((opt, 3), *((g, 1) for g in family.gen_opts)):
        counts = {int(o.state[p]["step"]) for grp in o.param_groups for p in grp["params"]}
        assert counts == {per_batch * n}


# ---------------------------------------------------------------------------
# the degree sums stay off the prefix path


def _fake_graph(n_nodes, n_edges, seed):
    rs = np.random.default_rng(seed)
    src = rs.integers(0, n_nodes, n_edges)
    dst = rs.integers(0, n_nodes, n_edges)
    entries = np.arange(n_edges)
    return SimpleNamespace(
        src=torch.from_numpy(src), dst=torch.from_numpy(dst), n_nodes=n_nodes,
        bags_src=segment_bags(src, entries, n_nodes, "cpu"),
        bags_dst=segment_bags(dst, entries, n_nodes, "cpu")), rs


def _oracle(vals, src, dst, n_nodes, eps, clip):
    d = np.zeros(n_nodes, np.float64)
    np.add.at(d, dst, vals)
    dis = (d + eps) ** -0.5
    if clip:
        dis = np.clip(dis, 0.0, 10.0)
    return vals * dis[src] * dis[dst]


def test_renormalized_weights_match_a_float64_oracle():
    """AdaGCL's ``_g2_renorm`` and Grade's ``_renorm_view`` at 300000 edges
    over 30000 nodes (the recipe of tests/test_ell.py:362): within 1e-4 of
    a float64 np.add.at oracle (Grade's, whose d^-1/2 has no clip, also
    to 1e-6 of itself). Self-calibrating: the same degree sums taken
    as prefix differences (``seg_sum``) miss that bound."""
    fake, rs = _fake_graph(30_000, 300_000, 3)
    src, dst = fake.src.numpy(), fake.dst.numpy()
    mask = torch.from_numpy(rs.uniform(0.3, 1.0, src.shape[0]).astype(np.float32))
    got = tada.AdaGCL._g2_renorm(fake, mask).numpy().astype(np.float64)
    oracle = _oracle(mask.numpy().astype(np.float64), src, dst, fake.n_nodes, 1e-6, True)
    assert np.abs(got - oracle).max() < 1e-4

    # Grade's view: edge probabilities, the ones under 0.5 cut
    pred = torch.from_numpy(rs.uniform(0.0, 1.0, src.shape[0]).astype(np.float32))
    got = tgrade.Grade._renorm_view(fake, pred).numpy().astype(np.float64)
    vals = np.where(pred.numpy() >= 0.5, pred.numpy(), 0.0).astype(np.float64)
    # unclipped: a source whose kept in-edges are all cut weighs up to
    # 1e-7^-1/2 = 3162 times more, held to the float32 rounding of itself
    np.testing.assert_allclose(got, _oracle(vals, src, dst, fake.n_nodes, 1e-7, False),
                               rtol=1e-6, atol=1e-4)

    perm, ptr = build_segment_transpose(fake.dst, fake.n_nodes)
    d_scan = seg_sum(mask, fake.dst, perm, ptr).double() + 1e-6
    dis = torch.clamp(d_scan ** -0.5, 0.0, 10.0).numpy()
    evil = mask.numpy() * dis[src] * dis[dst]
    assert np.abs(evil - oracle).max() > 1e-4, "seg_sum became accurate enough here"


def test_renorm_takes_its_gradient_through_the_bags():
    """``_g2_renorm``'s gradient (g2_loss differentiates through it)
    against float64 autograd of the same function with index_add_."""
    fake, rs = _fake_graph(500, 4000, 5)
    mask = torch.from_numpy(rs.uniform(0.0, 1.0, 4000).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rs.standard_normal(4000).astype(np.float32))
    (got,) = torch.autograd.grad(tada.AdaGCL._g2_renorm(fake, mask), mask, g)
    m64 = mask.detach().double().requires_grad_()
    d = torch.zeros(500, dtype=torch.float64).index_add(0, fake.dst, m64) + 1e-6
    dis = torch.clamp(d ** -0.5, 0.0, 10.0)
    (want,) = torch.autograd.grad(m64 * dis[fake.src] * dis[fake.dst], m64, g.double())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the CLI


@pytest.mark.parametrize("name", ["AdaGCL", "Grade"])
def test_cli_log_matches_jax_cli_and_skips_the_export(tiny_dataset, monkeypatch, tmp_path,
                                                      name):
    """Each package's cli.run of the model's first combo (Grade's 5
    layers), 1 epoch, through the ``trainer_cls`` dispatch: the same line
    shapes; ``--export_artifact`` logs the JAX CLI's warning and writes no
    file, as the JAX CLI does (neither trainer keeps weights)."""
    built = []
    cls = tada.AdaGCLTrainer if name == "AdaGCL" else tgrade.GradeTrainer
    init = cls.__init__
    monkeypatch.setattr(cls, "__init__", lambda self, *a: built.append(self) or init(self, *a))
    jlines, tlines, arts = both_clis_export(tiny_dataset, monkeypatch, tmp_path, FLAGS[name])
    assert tlines == jlines
    assert len(built) == 1 and not hasattr(built[0], "best_params_host")
    assert not any(os.path.exists(a) for a in arts)
    assert "WARNING export_artifact: best combo's trainer kept no weights - skipping export" \
        in tlines
    assert sum(x == "INFO Epoch #, Loss: #" for x in tlines) == 1


# ---------------------------------------------------------------------------
# on the card: K4 at AdaGCL's and Grade's shape


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
@pytest.mark.parametrize("m", [278_202, 300_001])
def test_k4_at_the_doubled_edges_matches_its_plain_version(m):
    """K4 at (2E, 64): the doubled edge list of the beauty-sized set (and a
    ragged height) against prefix_cumsum_reference and a float64 prefix,
    under chip_smoke's gate (4 ulp of the largest prefix x ceil(log2 M),
    + ulp x sqrt(M) against the sequential torch.cumsum), the same bits
    twice."""
    import math

    from chaorec_tpu_torch.ops.prefix_scan import prefix_cumsum, prefix_cumsum_reference

    gen = torch.Generator(device="cuda").manual_seed(m)
    x = torch.randn((m, 64), generator=gen, device="cuda")
    before = prefix_cumsum.launches
    got = prefix_cumsum(x)
    assert torch.equal(got, prefix_cumsum(x)) and prefix_cumsum.launches == before + 2
    exact = torch.cumsum(x.double(), 0)
    top = exact.abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(top)) - 23)
    tree = ulp * 4 * math.ceil(math.log2(m))
    assert (got.double() - exact).abs().max().item() <= tree
    assert (got - prefix_cumsum_reference(x)).abs().max().item() <= tree + ulp * math.sqrt(m)


@pytest.mark.parametrize("name", list(FLAGS))
def test_prefix_scans_a_step_match_the_count(tiny_dataset, monkeypatch, name):
    """The prefix scans (K4 launches on the card) of one training step and
    of one evaluation forward: AdaGCL 18 L - 3 and L, Grade 18 L and L
    (chip_smoke.scan_launches, PERF.md), counted here on the CPU where the
    plain version stands in for the kernel."""
    from chaorec_tpu_torch.ops import ell

    ds = tiny_dataset
    _, tm, _, tp = pair(ds, name)
    calls = []
    scan = ell.prefix_cumsum
    monkeypatch.setattr(ell, "prefix_cumsum", lambda v, out=None: calls.append(v.shape)
                        or scan(v, out=out))
    family = tm.trainer_cls(tm, ds, TConfig(**FLAGS[name]))
    params = leaves_of(tp)
    opt = family.make_optimizer(params)
    batch = both_batches(jax_batches(ds, 100, (0,))[0])[1]
    family.train_step(params, opt, batch)
    layers = tm.n_layers
    assert len(calls) == (18 * layers - 3 if name.startswith("AdaGCL") else 18 * layers)
    assert set(calls) == {(2 * ds.num_edges, 16)}  # (2E, dim_E): the doubled edges
    calls.clear()
    with torch.no_grad():
        tm.embeddings(params)
    assert len(calls) == layers


def test_cuts_hold_the_generated_views_half_cut():
    """chip_smoke.Cuts pins the 0.5 cut of both models' generated views as
    it pins clip bounds: a replayed call keeps the recorded side of each
    edge whatever its own probability says, and counts the edges whose side
    moved."""
    from chip_smoke import Cuts

    p = torch.tensor([0.2, 0.5, 0.49999997, 0.9])
    q = torch.tensor([0.2, 0.49999997, 0.5, 0.9])
    cuts = Cuts()
    with cuts.record():
        want = [tada.kept_edges(p), tgrade.kept_edges(p)]
    with cuts.replay():
        got = [tada.kept_edges(q), tgrade.kept_edges(q)]
    assert all(torch.equal(g, w) for g, w in zip(got, want)) and cuts.flips == 4
    assert torch.equal(want[0], torch.tensor([0.0, 1.0, 0.0, 1.0]))
    assert tada.kept_edges is tgrade.kept_edges  # restored on exit
