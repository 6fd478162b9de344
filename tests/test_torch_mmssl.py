"""models/mmssl.py, with its two-optimizer trainer, against the JAX package's.

Both packages build MMSSL from ``tiny_dataset`` (64 users x 48 items, 384
train edges, 32- and 16-wide item features) at dim 16, with its Model_YAML
file's first combo otherwise (lr 5.5e-4, reg 1e-5, ssl_alpha 0.1, ssl_temp
0.5, G_rate 1e-4, mm_layers 2). The port takes the JAX package's initial
params, the JAX trainer's batches and negatives, and every draw the JAX
losses make from their keys (``jax_draws``: the forwards' feature dropout
masks, the Gumbel uniforms, the interpolation weights, the discriminator's
dropout masks of each pass), given to ``loss_d_with_draws`` and
``loss_stateful_with_draws``.

``k_top`` = int(48 * 1e-4) is 0 here, as at beauty: every rebuild gives zero
count matrices. The state machine is also held with ``k_top`` raised to 3 on
both models before ``init_state`` (an attribute set by the test), where the
rebuilt matrices count each stored top item.

The steps are held optimizer step by optimizer step over two batches, as
tests/test_torch_adagcl_grade.py holds AdaGCL's: the params after each step
and the state (count, first and second moment) of the optimizer that took it,
against the JAX trainer's step driven by optax (its discriminator Adam under
``multi_transform``, its AdamW over every param), each package carrying its
own params and model state.

Tolerances are those of tests/test_torch_adagcl_grade.py: each loss to rtol
1e-5; every gradient, and every first moment, to 1e-4 of its tensor's
largest entry plus 1e-6; the embeddings and the params to rtol 1e-5, atol
1e-6; the second moments to 1e-4 of their tensor's largest entry plus 1e-12.
The two biases the batch norms follow (``D_b1``, ``D_b2``) are the
exception: the norm subtracts them again, so their gradient is zero in exact
arithmetic (6e-12 in float64 here) and each package's float32 gradient is
the rounding of a cancelling sum, of either sign. Their gradients and
moments are held to 1e-4 (1e-4 squared for the second moments) of the
largest entry of the same quantity of the bias after that norm
(``D_bn1_b``, ``D_bn2_b``), whose gradient is the sum that cancels; Adam
moves them by about its learning rate on the sign of that noise, so after
the steps they are held to 3 times the sum of the learning rates of the
steps taken. Nothing downstream reads them.
"""

import dataclasses
import functools
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.models import mmssl as tmmssl
from test_torch_adagcl_grade import _adam_state, _assert_state_close, _port_state
from test_torch_bspm import both_clis_export
from test_torch_lightgcn import TOL, assert_grads_close, jax_batches, make_pair
from test_torch_mm_towers import grad_np
from test_torch_rebuild_gated import both_indexed
from test_torch_vae import one_torch_thread, t  # noqa: F401

FLAGS = dict(Model="MMSSL", batch_size=100, dim_E=16, graph_compute_dtype="float32",
             topk=(5, 10, 20), learning_rate=5.5e-4, reg_weight=1e-5, ssl_alpha=0.1,
             ssl_temp=0.5, G_rate=1e-4, mm_layers=2)
RAISED_K = 3


def _d_masks(jm, rng, rows):
    """The two keep masks discriminate(rng=...) draws for ``rows`` inputs."""
    rng, k1 = jax.random.split(rng)
    _, k2 = jax.random.split(rng)
    i4, i8 = max(jm.num_item // 4, 1), max(jm.num_item // 8, 1)
    return (t(jax.random.bernoulli(k1, 1 - 0.31, (rows, i4)).astype(jnp.float32)),
            t(jax.random.bernoulli(k2, 0.5, (rows, i8)).astype(jnp.float32)))


def _feat_masks(jm, rng):
    k1, k2 = jax.random.split(rng)
    shape = (jm.num_item, jm.dim_E)
    return [t(jax.random.bernoulli(k, 1.0 - jm.drop_rate, shape).astype(jnp.float32))
            for k in (k1, k2)]


def jax_draws(jm, k_d, k_g, b):
    """The port's form of the draws ``loss_d`` makes from ``k_d`` and
    ``loss_stateful`` from ``k_g`` (mmssl.py:259-356), for a batch of ``b``."""
    k_f, k_gum, k_alpha, k_d1, k_d2, k_gp = jax.random.split(k_d, 6)
    out = dict(zip(("d_keep_image", "d_keep_text"), _feat_masks(jm, k_f)))
    out["gumbel_u"] = t(jax.random.uniform(k_gum, (b, jm.num_item)))
    out["alpha"] = t(jax.random.uniform(k_alpha, (2 * b, 1)))
    for name, k in (("d_fake", k_d1), ("d_real", k_d2), ("d_gp", k_gp)):
        out[name] = _d_masks(jm, k, 2 * b)
    g_f, g_d = jax.random.split(k_g)
    out.update(zip(("g_keep_image", "g_keep_text"), _feat_masks(jm, g_f)))
    out["g_d"] = _d_masks(jm, g_d, 2 * b)
    return out


BN_BIASES = {"D_b1": "D_bn1_b", "D_b2": "D_bn2_b"}  # a bias before a batch norm: the one after


def assert_grads_bn(got, want, what):
    """``assert_grads_close`` for each of ``want``'s tensors, but the biases
    before the batch norms, held to 1e-4 of the largest gradient of the bias
    after their norm (see the docstring)."""
    for k in want:
        w = np.asarray(want[k])
        if k in BN_BIASES:
            scale = float(np.abs(np.asarray(want[BN_BIASES[k]])).max())
            for x in (got[k], w, got[k] - w):
                assert np.abs(x).max() <= 1e-4 * scale + 1e-6, f"{what} {k}"
        else:
            assert_grads_close(got[k], w, f"{what} {k}")


def assert_opt_state_bn(got, want, what):
    """``_assert_state_close`` with the biases before the batch norms held
    to the moments of the biases after them."""
    _assert_state_close({k: v for k, v in got.items() if k not in BN_BIASES},
                        want._replace(mu={k: v for k, v in want.mu.items() if k not in BN_BIASES},
                                      nu={k: v for k, v in want.nu.items()
                                          if k not in BN_BIASES}), what)
    for k, after in BN_BIASES.items():
        if k not in got:
            continue
        for i, share in ((1, 1e-4), (2, 1e-8)):
            w = np.asarray((want.mu, want.nu)[i - 1][k])
            scale = float(np.abs(np.asarray((want.mu, want.nu)[i - 1][after])).max())
            assert np.abs(got[k][i] - w).max() <= share * scale + 1e-12, f"{what}: {k} moment {i}"


def to_port_state(state):
    return {k: torch.from_numpy(np.array(v)).long() if np.asarray(v).dtype.kind == "i"
            else t(v) for k, v in state.items()}


def assert_state_equal(got, want, what):
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=f"{what}: {k}")


@jax.jit
def _j_losses(jp, jm, state, jb, k_d, k_g):
    ld, gd = jax.value_and_grad(jm.loss_d)(jp, state, jb, k_d)
    (lg, new_state), gg = jax.value_and_grad(jm.loss_stateful, has_aux=True)(jp, state, jb, k_g)
    return ld, gd, lg, gg, new_state


@pytest.fixture(scope="module")
def pairs(tiny_dataset):
    """pairs(k_top): both models (``k_top`` set on each before anything
    reads it), their params and the epoch's batches 0, 1 and 2 (the last
    padded); built once per value."""
    cache = {}

    def get(k_top):
        if k_top not in cache:
            jm, tm, jp, tp = make_pair(tiny_dataset, FLAGS)
            if k_top is not None:
                jm.k_top = tm.k_top = k_top
            batches = [both_indexed(a, i) for i, a in
                       enumerate(jax_batches(tiny_dataset, FLAGS["batch_size"], (0, 1, -1)))]
            cache[k_top] = SimpleNamespace(jm=jm, tm=tm, jp=jp, tp=tp, batches=batches)
        return cache[k_top]

    return get


def _keys(b):
    return jax.random.split(jax.random.PRNGKey(70 + b))


def test_build_goes_through_build_model(pairs):
    p = pairs(None)
    jm, tm = p.jm, p.tm
    assert isinstance(tm, tmmssl.MMSSL) and tm.trainer_cls is tmmssl.MMSSLTrainer
    assert (tm.stateful, tm.k_top, jm.k_top) == (True, 0, 0)
    own = tm.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in p.jp.items()}
    np.testing.assert_allclose(tm.ui_graph.numpy(), np.asarray(jm.ui_graph), **TOL)
    np.testing.assert_allclose(tm.iu_graph.numpy(), np.asarray(jm.iu_graph), **TOL)
    assert tm.d_widths == (12, 6)


@pytest.mark.parametrize("step", [0, 2], ids=["full_batch", "padded_batch"])
def test_losses_and_gradients_match_jax(pairs, step):
    """``loss_d`` (the penalty's gradient taken twice) and the generator
    loss under the JAX draws, on the initial state: each loss, every
    gradient (``loss_d`` reaches the D_ params only; w_q, w_k and w_v get
    none), and the accumulating batch's buffer."""
    p = pairs(None)
    jb, tb = p.batches[step]
    jb, tb = jb._replace(index=jnp.asarray(0, jnp.int32)), dataclasses.replace(tb, index=0)
    k_d, k_g = _keys(step)
    jstate = p.jm.init_state(jax.random.PRNGKey(1))
    ld, gd, lg, gg, jnew = _j_losses(p.jp, p.jm, jstate, jb, k_d, k_g)
    draws = jax_draws(p.jm, k_d, k_g, tb.users.shape[0])
    leaves = {k: v.clone().requires_grad_() for k, v in p.tp.items()}
    state = p.tm.init_state()
    tld = p.tm.loss_d_with_draws(leaves, state, tb, draws)
    tld.backward()
    assert tld.item() == pytest.approx(float(ld), rel=1e-5)
    assert_grads_bn({k: grad_np(v) for k, v in leaves.items()}, gd, "loss_d")
    assert all(k.startswith("D_") or not np.asarray(gd[k]).any() for k in gd)
    leaves = {k: v.clone().requires_grad_() for k, v in p.tp.items()}
    tlg, new_state = p.tm.loss_stateful_with_draws(leaves, state, tb, draws)
    tlg.backward()
    assert tlg.item() == pytest.approx(float(lg), rel=1e-5)
    assert_grads_bn({k: grad_np(v) for k, v in leaves.items()}, gg, "loss")
    for k in ("w_q", "w_k", "w_v"):
        assert leaves[k].grad is None and not np.asarray(gg[k]).any()
    assert_state_equal({k: v for k, v in new_state.items() if k.startswith("buf")},
                       {k: v for k, v in jnew.items() if k.startswith("buf")}, "buffer")


@pytest.mark.parametrize("k_top", [None, RAISED_K], ids=["k_top_0", "k_top_raised"])
def test_state_machine_over_three_batches(pairs, k_top):
    """Batches 0, 1 and 2 of an epoch, each package carrying its own state
    from the same initial params: batch 0 stores its users' top items, batch
    1 rebuilds the count matrices from them (at k_top 0: zeros; raised: one
    count a stored item, a user's repeats adding), batch 2 from the used
    buffer (zeros); each state equal, each loss to rtol 1e-5."""
    p = pairs(k_top)
    jstate = p.jm.init_state(jax.random.PRNGKey(1))
    state = p.tm.init_state()
    for b, (jb, tb) in enumerate(p.batches):
        k_d, k_g = _keys(b)
        _, _, lg, _, jstate = _j_losses(p.jp, p.jm, jstate, jb, k_d, k_g)
        with torch.no_grad():
            tlg, state = p.tm.loss_stateful_with_draws(
                p.tp, state, tb, jax_draws(p.jm, k_d, k_g, tb.users.shape[0]))
        assert tlg.item() == pytest.approx(float(lg), rel=1e-5), f"batch {b}"
        assert_state_equal(state, jstate, f"after batch {b}")
        cnt = state["image_cnt"].numpy()
        if b == 0:
            assert np.array_equal(cnt, p.tm.raw_ui.numpy())
        elif b == 1 and k_top:
            buf = state["buf_image"].numpy()
            assert buf.shape == (100, k_top) and cnt.sum() == buf.size
        else:
            assert not cnt.any()


def test_embeddings_match_jax(pairs):
    """The ranking tables (no dropout) on the initial state and on a zero
    one, as after a rebuild at k_top 0."""
    p = pairs(None)
    jstate = p.jm.init_state(jax.random.PRNGKey(1))
    zero = dict(jstate, image_cnt=jnp.zeros_like(jstate["image_cnt"]),
                text_cnt=jnp.zeros_like(jstate["text_cnt"]))
    for s in (jstate, zero):
        want = p.jm.embeddings_stateful(p.jp, s)
        with torch.no_grad():
            got = p.tm.embeddings_stateful(p.tp, to_port_state(s))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# ---------------------------------------------------------------------------
# the trainer, optimizer step by optimizer step


@functools.lru_cache(maxsize=None)
def _jax_optimizers(lr):
    """(the discriminator's Adam, the main AdamW), as MMSSLTrainer builds
    them (mmssl.py:375-384), the D subtree labelled "g"."""
    return (lambda labels: optax.multi_transform(
        {"g": optax.adam(3e-4, b1=0.5, b2=0.9), "f": optax.set_to_zero()}, labels),
        optax.adamw(lr, weight_decay=0.01))


def _jax_step(jm, jp, od, om, opt_d, opt_main, mstate, jb, k_d, k_g):
    """The JAX trainer's batch (mmssl.py:403-419): the D step on loss_d,
    then the AdamW step on the generator loss. Returns the two losses and,
    per optimizer step, (params after it, its optimizer's new state), and
    the new model state."""
    ld, g_d = jax.value_and_grad(jm.loss_d)(jp, mstate, jb, k_d)
    upd, od = opt_d.update(g_d, od, jp)
    jp = optax.apply_updates(jp, upd)
    after_d = jp
    (lg, mstate), g = jax.value_and_grad(jm.loss_stateful, has_aux=True)(jp, mstate, jb, k_g)
    upd, om = opt_main.update(g, om, jp)
    jp = optax.apply_updates(jp, upd)
    return ld, lg, [(after_d, od), (jp, om)], mstate


def test_two_batches_match_jax_optimizer_by_optimizer(pairs, tiny_dataset):
    """Two batches of ``mmssl_step`` with the trainer's optimizers
    (``make_optimizer``) against the JAX trainer's step driven by optax:
    after each optimizer step every param and the state of the optimizer
    that stepped (the discriminator's over the D_ params, the AdamW over
    every param, w_q, w_k and w_v included), each package carrying its own
    params and model state; the logged loss is loss_d + the generator
    loss."""
    p = pairs(None)
    jm, tm = p.jm, p.tm
    family = tm.trainer_cls(tm, tiny_dataset, TConfig(**FLAGS))
    params = {k: v.clone().requires_grad_() for k, v in p.tp.items()}
    opt = family.make_optimizer(params)
    assert isinstance(opt, torch.optim.AdamW) and len(family.gen_opts) == 1
    labels = {k: "g" if k.startswith("D_") else "f" for k in p.jp}
    make_d, opt_main = _jax_optimizers(FLAGS["learning_rate"])
    opt_d = make_d(labels)
    jp = p.jp
    od, om = opt_d.init(jp), opt_main.init(jp)
    jstate, state = jm.init_state(jax.random.PRNGKey(1)), tm.init_state()
    by_label = {"d": family.gen_opts[0], "main": opt}
    LRS = {"d": tmmssl.MMSSLTrainer.D_LR, "main": FLAGS["learning_rate"]}
    lrs = 0.0
    for b in (0, 1):
        jb, tb = p.batches[b]
        k_d, k_g = _keys(b)
        ld, lg, log, jstate = jax.jit(_jax_step, static_argnums=(4, 5))(
            jm, jp, od, om, opt_d, opt_main, jstate, jb, k_d, k_g)
        seen = []

        def on_step(label):
            seen.append((label, {k: v.detach().numpy().copy() for k, v in params.items()},
                         _port_state(by_label[label], params)))

        loss, state = tmmssl.mmssl_step(tm, (opt, *family.gen_opts), params, state, tb,
                                        jax_draws(jm, k_d, k_g, tb.users.shape[0]),
                                        on_step=on_step)
        assert loss.item() == pytest.approx(float(ld + lg), rel=1e-5), f"batch {b}"
        assert [s[0] for s in seen] == ["d", "main"]
        for (label, got, pstate), (want, jopt) in zip(seen, log):
            what = f"batch {b} after {label}"
            lrs += LRS[label]
            for k in want:
                if k in BN_BIASES:
                    assert np.abs(got[k] - np.asarray(want[k])).max() <= 3 * lrs, f"{what}: {k}"
                    continue
                np.testing.assert_allclose(got[k], np.asarray(want[k]), **TOL,
                                           err_msg=f"{what}: {k}")
            assert_opt_state_bn(pstate, _adam_state(jopt), what)
        jp, od, om = log[-1][0], log[0][1], log[1][1]
        assert_state_equal({k: v for k, v in state.items() if k.startswith("buf")},
                           {k: v for k, v in jstate.items() if k.startswith("buf")}, "buffer")


def test_trainer_makes_both_optimizers_anew_each_epoch(pairs, tiny_dataset):
    """Two epochs of MMSSLTrainer.train_epoch: after each, both optimizers
    have stepped once a batch of that epoch only (fresh each epoch, as the
    reference re-creates them), every param of each at one count."""
    p = pairs(None)
    family = p.tm.trainer_cls(p.tm, tiny_dataset, TConfig(**FLAGS))
    params = {k: v.clone().requires_grad_() for k, v in p.tp.items()}
    made, make = [], family.make_optimizer
    family.make_optimizer = lambda ps: made.append(make(ps)) or made[-1]
    run_opt = family._base.make_optimizer(params)
    n = -(-tiny_dataset.num_edges // FLAGS["batch_size"])
    seen = []
    for _ in range(2):
        loss = family._base.train_epoch(params, run_opt)
        assert np.isfinite(loss)
        opts = (made[-1], *family.gen_opts)
        seen.append(opts)
        for o in opts:
            counts = {int(o.state[q]["step"]) for g in o.param_groups for q in g["params"]}
            assert counts == {n}
    assert not set(map(id, seen[0])) & set(map(id, seen[1])) and not run_opt.state
    assert len(seen[0][0].param_groups[0]["params"]) == len(params)
    assert len(seen[0][1].param_groups[0]["params"]) == sum(k.startswith("D_") for k in params)


def test_cli_log_matches_jax_cli_and_skips_the_export(tiny_dataset, monkeypatch, tmp_path):
    """Each package's cli.run of the first combo, 1 epoch, through the
    ``trainer_cls`` dispatch: the same line shapes; ``--export_artifact``
    logs the JAX CLI's warning and writes no file (the family trainer keeps
    no weights)."""
    jlines, tlines, arts = both_clis_export(tiny_dataset, monkeypatch, tmp_path, FLAGS)
    assert tlines == jlines
    assert not any(os.path.exists(a) for a in arts)
    assert "WARNING export_artifact: best combo's trainer kept no weights - skipping export" \
        in tlines
    assert sum(x == "INFO Epoch #, Loss: #" for x in tlines) == 1
