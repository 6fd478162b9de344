"""models/mhrec.py, with its three-phase trainer, against the JAX package's.

Both packages build MHRec from ``tiny_dataset`` (64 users x 48 items, 384
train edges, so 384 hyperedges of 22 nodes a modality; 32- and 16-wide item
features) at dim 16, batch 200 (two batches in each phase, the second
padded), with its Model_YAML file's first combo but ``ssl_alpha`` 0.1 (so
that the four contrasts weigh in). The port takes the JAX package's initial
params (the denoisers' nested params flattened as ``img_dn.<name>``), the
JAX trainer's batches and negatives, and every draw the JAX functions make
from their keys: phase A's timesteps, noise and keep masks
(``phase_a_draws``), phase B's start noise, one draw a chunk of 1024 rows
(``phase_b_noise``), and the hypergraph dropout masks of each forward
(``forward_draws``). The JAX incidences are taken slot by slot: the JAX
layout orders the slots column by column, the port's row by row, so the
segment sums differ in the order of their fp32 prefix only.

The models are built once per module and graph dtype (``pairs``), and one
test takes the JAX steps it holds the port to, as in
tests/test_torch_diffmm.py: each modality's two
phase-A steps of its fresh Adam against the JAX trainer's ``multi_transform``
over both denoisers (the other denoiser's update is exactly zero), then two
phase-C steps of the main Adam (every param but the denoisers) against the
JAX trainer's ``multi_transform`` (``set_to_zero`` on the denoisers): after
each, every param and the stepping optimizer's count and moments.

Tolerances at a float32 graph are tests/test_torch_diffmm.py's, the
params' with its Adam drift bound. The hypergraph's message sums are
differences of one global fp32 prefix (ops/ell.py's CAVEAT), laid out
slot by slot in the port and column by column in the JAX package: the
attention's output is held to the prefix error model of its running total
over each node's denominator, and so is ``a``'s gradient, which reads the
sums through the denominators; ``loss_hyper``'s gradients and cached
output to the larger of their bound and 4 times their largest spread from
the same step on params nudged by one rounding of the graph's dtype
(2^-24, 2^-8 at bf16; three nudges: ``nudged``, as chip_smoke.py holds
MMSSL's card steps with one): the
attention params' gradients nearly cancel over a node's slots, as a
softmax's do, and carry the rounding of terms a thousand times larger, at
bf16 that of cotangents rounded to bf16 on the way. The self half of an
attention vector gets no gradient at all in exact arithmetic (every slot
of a node adds the node's own score term, which the node's softmax
cancels): each package's is rounding noise (the JAX package's at bf16 up
to a few percent of the edge half's largest entry), which Adam steps by
its learning rate on the noise's sign, as tests/test_torch_mmssl.py finds
for the biases before its batch norms. Only the edge half is compared;
the params after the steps carry that through their Adam drift bound (at
most 2 learning rates a step). At ``graph_compute_dtype`` bfloat16 the
slot rows and the U-I graph's operands are bf16 in both packages, rounded
alike; the float32 sums in another order can land a bf16-rounded gradient
one bf16 ulp away: the loss to rtol 1e-4 and each gradient to 2^-6 of its
tensor's largest entry (chip_smoke.py's BF16_STEP_RTOL). Phase B's picks
are equal at float32.
"""

import functools
import logging
import os
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chaorec_tpu.config import Config as JConfig
from chaorec_tpu.models import build_model as jbuild
from chaorec_tpu.models.builders import _mhrec_hyperedges
from chaorec_tpu_torch import params as tparams
from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.models import build_model as tbuild
from chaorec_tpu_torch.models import diffmm as tdiffmm
from chaorec_tpu_torch.models import mhrec as tmhrec
from test_torch_bspm import both_clis_export
from test_torch_diffmm import (adam_drift, assert_adam_state, assert_params, dn_optimizer,
                               flat_params, leaves, moment_slack)
from test_torch_lightgcn import assert_grads_close, both_batches, jax_batches
from test_torch_mm_towers import grad_np
from test_torch_prefix_scan import scan_atol
from test_torch_vae import one_torch_thread, t  # noqa: F401

FLAGS = dict(Model="MHRec", batch_size=200, dim_E=16, graph_compute_dtype="float32",
             topk=(5, 10, 20), learning_rate=1e-3, reg_weight=1e-4, n_layers=3, h_layers=2,
             uu_topk=10, ii_topk=10, num_hypernodes=2, ssl_alpha=0.1, ssl_temp=0.1, beta1=0.5,
             beta2=0.5)
BF16_RTOL = 2.0 ** -6
MODALITIES = (("img_dn", "hyper_nodes_v"), ("txt_dn", "hyper_nodes_t"))
NUDGES = (1, 2, 3)  # the nudged runs whose largest spread bounds a step's rounding
SCORE_VECTOR = re.compile(r"h[vt]_a\d+$")  # an attention layer's [a_self; a_edge]


def phase_a_draws(jm, key, b):
    """The draws ``hyper_diff_loss`` makes from ``key`` for ``b`` rows
    (mhrec.py:156-160)."""
    k_t, k_n, k_d = jax.random.split(key, 3)
    return {"ts": t(jax.random.randint(k_t, (b,), 0, jm.steps)).long(),
            "noise": t(jax.random.normal(k_n, (b, jm.num_nodes))),
            "keep": t(jax.random.bernoulli(k_d, 0.5, (b, jm.num_nodes)).astype(jnp.float32))}


def forward_draws(jm, key):
    """The dropout keep masks ``forward`` draws from ``key`` (mhrec.py:300-304)."""
    out = {}
    for m, k in zip(("v", "t"), jax.random.split(key)):
        for layer in range(jm.h_layers):
            out[f"keep_{m}{layer}"] = t(jax.random.bernoulli(
                jax.random.fold_in(k, layer), 0.5, (jm.num_nodes, jm.dim_E)).astype(jnp.float32))
    return out


def phase_b_keys(key, he):
    return jax.random.split(key, -(-he // tmhrec.REBUILD_CHUNK))


def phase_b_noise(jm, key, he):
    """The start noise of each chunk (mhrec.py:455, diffusion.py:178)."""
    return torch.stack([t(jax.random.normal(k, (tmhrec.REBUILD_CHUNK, jm.num_nodes)))
                        for k in phase_b_keys(key, he)])


def jax_phase_b(jm, jp, prefix, nodes, key):
    """The JAX phase B of mhrec.py:441-459, chunk by chunk."""
    he, c = nodes.shape[0], tmhrec.REBUILD_CHUNK
    keys = phase_b_keys(key, he)
    pad = len(keys) * c - he
    nd = jnp.concatenate([nodes, jnp.full((pad, nodes.shape[1]), jm.num_nodes, nodes.dtype)])
    return np.concatenate([np.asarray(jm.rebuild_rows(jp, prefix, nd[i * c:(i + 1) * c], k))
                           for i, k in enumerate(keys)])[:he]


def phase_a_batches(n, bs, key):
    from chaorec_tpu.data.sampling import make_epoch_batches

    ids = jnp.stack([jnp.arange(n, dtype=jnp.int32), jnp.zeros((n,), jnp.int32)], axis=1)
    users, _, weights, _ = make_epoch_batches(key, ids, bs)
    return [(np.array(u), np.array(w)) for u, w in zip(users, weights)]


@functools.partial(jax.jit, static_argnums=(1, 2))
def _j_diff(jp, jm, prefix, nodes, w, key):
    return jax.value_and_grad(lambda p: jm.hyper_diff_loss(p, prefix, nodes, w, key))(jp)


_STRICT = {}


def _j_loss(jp, jm, jb, h_v, h_t, key):
    """value_and_grad of ``loss_hyper``, compiled without XLA's excess
    precision: XLA may otherwise skip a bf16 rounding the program states
    (and the port takes), which moves the attention vectors' gradients, sums
    that nearly cancel, by a third at bf16."""
    if jm not in _STRICT:
        fn = jax.jit(lambda *a: jax.value_and_grad(jm.loss_hyper, has_aux=True)(*a))
        _STRICT[jm] = fn.lower(jp, jb, h_v, h_t, key).compile(
            compiler_options={"xla_allow_excess_precision": False})
    return _STRICT[jm](jp, jb, h_v, h_t, key)


def main_optimizer(jp, lr):
    """The JAX trainer's phase-C optimizer (mhrec.py:405-414)."""
    labels = {k: jax.tree_util.tree_map(lambda _: "dn" if k.endswith("_dn") else "frozen", v)
              for k, v in jp.items()}
    return optax.multi_transform({"dn": optax.set_to_zero(), "frozen": optax.adam(lr)}, labels)


@pytest.fixture(scope="module")
def pairs(tiny_dataset):
    """pairs(dtype): both models at that graph dtype, the JAX initial params
    and phase C's two batches and keys; built once per dtype."""
    cache = {}

    def get(dtype="float32"):
        if dtype not in cache:
            flags = dict(FLAGS, graph_compute_dtype=dtype)
            jm = jbuild(JConfig(**flags), tiny_dataset)
            jp = jm.init_params(jax.random.PRNGKey(0))
            cache[dtype] = SimpleNamespace(
                jm=jm, tm=tbuild(TConfig(**flags), tiny_dataset, "cpu"), jp=jp,
                tp=tparams.from_numpy(flat_params(jp)),
                c_batches=[both_batches(a) for a in
                           jax_batches(tiny_dataset, FLAGS["batch_size"], (0, 1))],
                c_keys=[jax.random.PRNGKey(500 + b) for b in range(2)])
        return cache[dtype]

    return get


def _messages(tm, a, layout, x):
    """(the attention's weighted messages (He k, D) in slot order, float64;
    each node's softmax denominator (N,); the largest slot row or edge
    entry) as ``_hyper_attn`` forms them."""
    h_nodes = layout[0]
    he, k = h_nodes.shape
    dt = tm.sample_dtype or x.dtype
    d = x.shape[1]
    xi = torch.cat([x, x.new_zeros((1, d))]).to(dt)[h_nodes.reshape(-1)].float()
    edge = xi.view(he, k, d).sum(1)
    a32 = a.to(dt).float()
    e = torch.exp(xi @ a32[:d, 0] + (edge @ a32[d:, 0]).repeat_interleave(k))
    msgs = (e[:, None] * edge.repeat_interleave(k, 0)).double().numpy()
    sums = np.zeros(tm.num_nodes + 1)
    np.add.at(sums, h_nodes.reshape(-1).numpy(), e.double().numpy())
    return msgs, sums[:tm.num_nodes], max(xi.abs().max().item(), edge.abs().max().item())


def _prefix_slack(tm, a, layout, x, h):
    """(the prefix error model's bound on each node's message sum, twice
    scan_atol of their running total: each package's sum carries it, and
    the two lay the slots out in other orders; each node's softmax
    denominator; the largest slot row or edge entry) of the attention."""
    with torch.no_grad():
        msgs, sums, vmax = _messages(tm, a, layout, x)
    prefix = np.cumsum(msgs[np.argsort(h.reshape(-1), kind="stable")], axis=0)
    return 2 * scan_atol(prefix, msgs.shape[0]), sums, vmax


def _assert_within_prefix_model(slack, got, want, bf16, what):
    """The attention's output against JAX's: the message sums' prefix
    error (ops/ell.py's CAVEAT) over each node's denominator, the rest to
    rtol 1e-5 (1e-4 at bf16)."""
    scan2, sums, _ = slack
    np.testing.assert_array_less(np.abs(got - want),
                                 scan2 / (sums[:, None] + 1e-16)
                                 + (1e-4 if bf16 else 1e-5) * np.abs(want) + 1e-6, err_msg=what)


def nudged(tp, seed, bits):
    """The params each times 1 + 2^-bits N(0, 1): the same step from inputs
    one rounding apart (24 bits: float32's; 8: bf16's) shows how far
    rounding alone moves its outputs."""
    gen = torch.Generator().manual_seed(seed)
    return {k: v * (1 + 2.0 ** -bits * torch.randn(v.shape, generator=gen))
            for k, v in tp.items()}


def _state(tm, h_v, h_t):
    return tm.with_incidence(tm.init_state(), torch.from_numpy(np.array(h_v)).long(),
                             torch.from_numpy(np.array(h_t)).long())


def test_hyperedges_match_jax_built_and_loaded(tiny_dataset, pairs, tmp_path):
    """The runtime hyperedges (co-occurrence users from topk_sample at seed
    + 3, the rsqrt-scaled item kNN without the item itself) equal the JAX
    builder's; with the data root's visual file present both packages load
    it for both modalities, its ragged rows padded with the sentinel; the
    model holds the builder's lists and its trainer."""
    r = pairs()
    jm, tm = r.jm, r.tm
    assert isinstance(tm, tmhrec.MHRec) and tm.trainer_cls is tmhrec.MHRecTrainer
    for attr in ("hyper_nodes_v", "hyper_nodes_t"):
        np.testing.assert_array_equal(getattr(tm, attr).numpy(), np.asarray(getattr(jm, attr)))
    hv = tm.hyper_nodes_v.numpy()
    assert hv.shape == (384, 22) and (hv[:, 12:] >= 64).all() and (hv[:, 1:11] < 64).all()
    assert not (hv[:, 13:] == hv[:, 12:13]).any()  # the item is not its own neighbour
    own = tm.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == {k: tuple(v.shape) for k, v in r.tp.items()}
    assert torch.equal(own["v_feat"], tm.v_feat0) and own["v_feat"] is not tm.v_feat0
    seq = np.empty(3, dtype=object)
    seq[:] = [[0, 70, 3], [5, 64, 80, 1, 90], [7]]
    os.makedirs(tmp_path / "tiny")
    np.save(tmp_path / "tiny" / "hyperedges_visual_u10_i10.npy", seq, allow_pickle=True)
    flags = dict(FLAGS, data_root=str(tmp_path))
    want = _mhrec_hyperedges(JConfig(**flags), tiny_dataset, tiny_dataset.v_feat,
                             tiny_dataset.t_feat)
    got = tmhrec.mhrec_hyperedges(TConfig(**flags), tiny_dataset, r.tm.v_feat0, r.tm.t_feat0,
                                  "cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0][2].tolist() == [7] + [112] * 4 and np.array_equal(got[0], got[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hyper_attn_and_loss_match_jax(pairs, dtype):
    """At both graph dtypes, on a seeded incidence of 384 hyperedges of 2
    nodes a modality: the attention layer of each modality on the input
    its first layer sees
    (its output to the prefix error model of its message sums, the
    gradients of its input and of ``a``) and on inputs of unit scale (its
    output), then ``loss_hyper`` under the JAX dropout masks
    (the loss, every gradient, none for the denoisers, and the cached
    output)."""
    r = pairs(dtype)
    jm, tm = r.jm, r.tm
    bf16 = dtype == "bfloat16"
    assert tm.sample_dtype == (torch.bfloat16 if bf16 else None)
    rs = np.random.default_rng(3)
    h_v, h_t = (rs.integers(0, jm.num_nodes, (384, 2)).astype(np.int32) for _ in range(2))
    state = _state(tm, h_v, h_t)
    gtol = BF16_RTOL if bf16 else 1e-4
    for h, lay, a, pre in ((h_v, state["lay_v"], "hv_a0", "v"), (h_t, state["lay_t"], "ht_a1", "t")):
        jh = jnp.asarray(h)

        def jf(xx, aa):
            return jm._hyper_attn(aa, jh, jm.build_layout(jh), xx)

        # the input the first layer sees: [user modal table; normalized features]
        feats = np.asarray(r.jp[f"{pre}_feat"]) @ np.asarray(
            r.jp["img_w" if pre == "v" else "txt_w"]).T
        feats = feats / np.sqrt((feats ** 2).sum(1, keepdims=True) + 1e-12)
        x0 = np.concatenate([np.asarray(r.jp[f"u_{pre}_emb"]), feats]).astype(np.float32)
        cot = rs.standard_normal(x0.shape).astype(np.float32)
        jout, jvjp = jax.vjp(jf, jnp.asarray(x0), r.jp[a])
        tx, ta = t(x0).requires_grad_(), r.tp[a].clone().requires_grad_()
        out = tm._hyper_attn(ta, lay, tx)
        (out * t(cot)).sum().backward()
        slack = _prefix_slack(tm, ta, lay, tx, h)
        _assert_within_prefix_model(slack, out.detach().numpy(), np.asarray(jout), bf16, a)
        # a's gradient reads the sums through the denominators' gradient,
        # cot . agg / sums^2 a node, summed over its slots' exps: the sums'
        # error reaches it as sum_n |cot_n|_1 / sums_n times the largest row
        scan2, sums, vmax = slack
        a_slack = scan2 * vmax * float((np.abs(cot).sum(1) / (sums + 1e-16)).sum())
        for got, want, extra in zip((tx.grad, ta.grad), jvjp(jnp.asarray(cot)), (0.0, a_slack)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                       atol=gtol * np.abs(np.asarray(want)).max() + 1e-6 + extra,
                                       err_msg=f"{a} gradient")
        # inputs of unit scale: exps of several units, messages far from zero-mean
        x = t(rs.standard_normal(x0.shape).astype(np.float32))
        with torch.no_grad():
            out = tm._hyper_attn(ta, lay, x).numpy()
        _assert_within_prefix_model(_prefix_slack(tm, ta, lay, x, h), out,
                                    np.asarray(jf(jnp.asarray(x.numpy()), r.jp[a])), bf16, a)
    for b, ((jb, tb), k) in enumerate(zip(r.c_batches, r.c_keys)):
        (jloss, (ju, ji)), jg = _j_loss(r.jp, jm, jb, jnp.asarray(h_v), jnp.asarray(h_t), k)
        grads, outs = {}, {}
        for side in ("port",) + NUDGES:
            lv = leaves(r.tp if side == "port" else nudged(r.tp, 10 * b + side, 8 if bf16 else 24))
            loss, outs[side] = tm.loss_stateful_with_draws(lv, state, tb, forward_draws(jm, k))
            loss.backward()
            grads[side] = {n: grad_np(v) for n, v in lv.items()}
            if side == "port":
                assert loss.item() == pytest.approx(float(jloss), rel=1e-4 if bf16 else 1e-5), b
        for name, want in flat_params(jg).items():
            got = grads["port"][name]
            if name.split(".")[0] in tdiffmm.DENOISERS:
                assert not got.any() and not want.any(), name
                continue
            rows = slice(None)
            if SCORE_VECTOR.match(name):
                # the self half: a node's slots share it and its softmax
                # cancels it, so either package's gradient there is noise
                assert np.isfinite(got[:jm.dim_E]).all(), name
                rows = slice(jm.dim_E, None)
            got, want = got[rows], want[rows]
            spread = max(np.abs(got - grads[i][name][rows]).max() for i in NUDGES)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=max(gtol * np.abs(want).max() + 1e-6, 4 * spread),
                                       err_msg=f"batch {b}: {name}")
        new = outs["port"]
        for name, want in (("user", ju), ("item", ji)):
            want = np.asarray(want)
            spread = max((new[name] - outs[i][name]).abs().max().item() for i in NUDGES)
            np.testing.assert_array_less(np.abs(new[name].numpy() - want),
                                         np.maximum((1e-4 if bf16 else 1e-5) * np.abs(want)
                                                    + 1e-6, 4 * spread), err_msg=name)
        assert new["lay_v"] is state["lay_v"]


def test_three_phases_match_jax_optimizer_by_optimizer(pairs, tiny_dataset):
    """An epoch's three phases, each package carrying its own params:
    ``dense_rows`` (the sentinel drops out, repeated nodes set once); each
    modality's two phase-A steps of its own fresh Adam against the JAX
    trainer's ``multi_transform`` over both denoisers, before each the loss
    and gradients from the JAX params (the modality's denoiser only; the
    second batch padded), after each every param and the Adam's state (the
    other denoiser and every other param keep their bits); phase B under
    the JAX chunk noise (the 20-step chain from t = 4, each hyperedge's
    top nodes, ties to the lower node, the padded chunk's sentinel rows
    dropped) equal to the JAX picks; then two phase-C steps of the main
    Adam through ``Trainer.train_step`` against the JAX trainer's
    ``multi_transform`` (``set_to_zero`` on the denoisers, which keep their
    bits), after each every param and its state; evaluation ranks the
    cached output of the last step's forward."""
    r = pairs()
    jm, tm, lr, bs = r.jm, r.tm, FLAGS["learning_rate"], FLAGS["batch_size"]
    nodes = np.array([[0, 3, 3, 112], [111, 112, 112, 5]], np.int64)
    np.testing.assert_array_equal(tm.dense_rows(torch.from_numpy(nodes)).numpy(),
                                  np.asarray(jm.dense_rows(jnp.asarray(nodes))))
    family = tm.trainer_cls(tm, tiny_dataset, TConfig(**FLAGS))
    params = leaves(r.tp)
    jp, drift = r.jp, {}
    for j, (prefix, attr) in enumerate(MODALITIES):
        jnodes, tnodes = getattr(jm, attr), getattr(tm, attr)
        opt, jopt = family.denoiser_adam(params, (prefix,)), dn_optimizer(r.jp, lr)
        jst, steps = jopt.init(jp), []
        mine = [n for n in params if n.startswith(prefix + ".")]
        for b, (ids, w) in enumerate(phase_a_batches(jnodes.shape[0], bs,
                                                     jax.random.PRNGKey(40 + j))):
            k = jax.random.PRNGKey(200 + 10 * j + b)
            draws = phase_a_draws(jm, k, ids.shape[0])
            rows, weights = tnodes[torch.from_numpy(ids).long()], torch.from_numpy(w)
            jloss, jg = _j_diff(jp, jm, prefix, jnodes[ids], jnp.asarray(w), k)
            lv = leaves(tparams.from_numpy(flat_params(jp)))
            loss = tm.hyper_diff_loss_with_draws(lv, prefix, rows, weights, draws)
            loss.backward()
            assert loss.item() == pytest.approx(float(jloss), rel=1e-5), (prefix, b)
            for name, want in flat_params(jg).items():
                if name in mine:
                    assert_grads_close(grad_np(lv[name]), want, f"{prefix} batch {b}: {name}")
                else:
                    assert lv[name].grad is None and not want.any(), name
            upd, jst = jopt.update(jg, jst, jp)
            jp = optax.apply_updates(jp, upd)
            steps.append((float(jloss), jg, jp, jst))
            before = {n: v.detach().clone() for n, v in params.items()}
            loss = family.denoise_step(opt, tm.hyper_diff_loss_with_draws(params, prefix, rows,
                                                                          weights, draws))
            assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
            a_drift = adam_drift(steps, lr)[b]
            assert_params(params, jp, f"{prefix} step {b}",
                          {**drift, **{n: a_drift[n] for n in mine}})
            assert_adam_state(opt, params, jst, f"{prefix} step {b}", mine)
            assert all(torch.equal(params[n], before[n]) for n in params if n not in mine)
        drift.update({n: a_drift[n] for n in mine})
    b_keys = {prefix: jax.random.PRNGKey(300 + j) for j, (prefix, _) in enumerate(MODALITIES)}
    jh = {prefix: jax_phase_b(jm, jp, prefix, getattr(jm, attr), b_keys[prefix])
          for prefix, attr in MODALITIES}
    base = family._base
    h = {prefix: tm.rebuild_incidence(params, prefix, getattr(tm, attr), None,
                                      phase_b_noise(jm, b_keys[prefix], 384))
         for prefix, attr in MODALITIES}
    for prefix in h:
        assert h[prefix].shape == (384, 2)
        np.testing.assert_array_equal(h[prefix].numpy(), jh[prefix])
    base.model_state = tm.with_incidence(base.model_state, h["img_dn"], h["txt_dn"])
    main, jmain = base.make_optimizer(params), main_optimizer(r.jp, lr)
    dn = tdiffmm.denoiser_names(params, tdiffmm.DENOISERS)
    dn_before = {n: params[n].detach().clone() for n in dn}
    jst, steps, g_tols, out_spread = jmain.init(jp), [], [], {}
    for b, ((jb, tb), k) in enumerate(zip(r.c_batches, r.c_keys)):
        (jloss, (ju, ji)), jg = _j_loss(jp, jm, jb, jnp.asarray(jh["img_dn"]),
                                        jnp.asarray(jh["txt_dn"]), k)
        upd, jst = jmain.update(jg, jst, jp)
        jp = optax.apply_updates(jp, upd)
        steps.append((float(jloss), jg, jp, jst))
        draws = forward_draws(jm, k)
        # the step's own rounding: its gradients and output from params
        # nudged by 2^-24 (the attention vectors' gradients nearly cancel)
        near = []
        for i in NUDGES:
            lv = leaves(nudged({n: v.detach() for n, v in params.items()}, 10 * b + i, 24))
            loss, new = tm.loss_stateful_with_draws(lv, base.model_state, tb, draws)
            loss.backward()
            near.append(({n: grad_np(v) for n, v in lv.items()}, new))
        tm.draws = lambda generator, batch, d=draws: d
        try:
            loss = base.train_step(params, main, tb)
        finally:
            del tm.draws
        g_tols.append({n: 4 * max(np.abs(grad_np(params[n]) - g[n]).max() for g, _ in near)
                       for n in params if n not in dn})
        out_spread = {n: max((base.model_state[n] - o[n]).abs().max().item() for _, o in near)
                      for n in ("user", "item")}
        assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
        c_drift = adam_drift(steps, lr, g_tols=g_tols)[b]
        assert_params(params, jp, f"phase C step {b}",
                      {**drift, **{n: drift.get(n, 0.0) + v for n, v in c_drift.items()}})
        assert_adam_state(main, params, jst, f"phase C step {b}",
                          [n for n in params if n not in dn],
                          extra=moment_slack(steps, g_tols)[b])
        assert all(torch.equal(params[n], dn_before[n]) for n in dn)
    with torch.no_grad():
        assert base.evaluate(params)[2].shape == (64, 48)  # every item ranked
        cached = tm.embeddings_stateful(params, base.model_state)
    for got, want, n in zip(cached, (ju, ji), ("user", "item")):
        want = np.asarray(want)
        np.testing.assert_array_less(np.abs(got.numpy() - want),
                                     np.maximum(1e-5 * np.abs(want) + 1e-6, 4 * out_spread[n]))


@pytest.mark.parametrize("phase_c_only", [False, True], ids=["three_phases", "phase_c_only"])
def test_cli_log_matches_jax_cli_and_skips_the_export(tiny_dataset, monkeypatch, tmp_path,
                                                      phase_c_only):
    """Each package's cli.run of the first combo, 1 epoch, through the
    trainer_cls dispatch: the same line shapes, the phase lines word for
    word; ``--export_artifact`` logs the JAX CLI's warning and writes no
    file. With CHAOREC_MHREC_PHASE_C_ONLY=1 both run phase C alone."""
    if phase_c_only:
        monkeypatch.setenv("CHAOREC_MHREC_PHASE_C_ONLY", "1")
    flags = dict(Model="MHRec", dim_E=16, topk=(5, 10, 20), batch_size=200)
    jlines, tlines, arts = both_clis_export(tiny_dataset, monkeypatch, tmp_path, flags)
    assert tlines == jlines
    phase_lines = [x for x in tlines if "diffusion" in x or "hypergraph" in x or "Diffusion" in x
                   or "PHASE-C-ONLY" in x]
    if phase_c_only:
        assert phase_lines == ["INFO MHRec PHASE-C-ONLY measurement mode (matching the "
                               "reference log's workload)"]
    else:
        step = "INFO Diffusion Step #/#; Diffusion Loss #"
        assert phase_lines == (["INFO Start to visual hyperedges diffusion", step, step,
                                "INFO Start to textual hyperedges diffusion", step, step,
                                "INFO Start to re-build hypergraph matrix",
                                "INFO hypergraph matrix built!"])
        raw = open(tmp_path / "torch" / "MHRec_tiny.log").read()
        assert "Diffusion Step 1/1; Diffusion Loss " in raw
    assert not any(os.path.exists(a) for a in arts)
    assert "WARNING export_artifact: best combo's trainer kept no weights - skipping export" \
        in tlines
    logging.getLogger().handlers.clear()
