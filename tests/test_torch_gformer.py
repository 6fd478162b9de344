"""models/gformer.py against the JAX package's GFormer and GFormerTrainer.

Both packages build GFormer from ``tiny_dataset`` (64 users x 48 items, 112
nodes, 32 anchors) at dim 16 with its Model_YAML file's first combo
otherwise (1 layer, 1 PNN layer, ssl_alpha 1, b2 1, ctra 0.01), and at 2
layers. The port takes the JAX package's initial params, its batches and
negatives and its trainer's padded sampled graphs (``graphs_from_arrays``).

Tolerances: the anchors, distances, scramble and the host sampler's numpy
half exactly equal; each loss to rtol 1e-5; every gradient to 1e-4 of its
tensor's largest entry plus 1e-6; the clipped gradients and the params
after a step to the same bound; the embeddings and the sampler's
attention to rtol 1e-5, atol 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chaorec_tpu.config import Config as JConfig
from chaorec_tpu.models import build_model as jbuild
from chaorec_tpu.models import gformer as jgf
from chaorec_tpu_torch import params as tparams
from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.models import build_model as tbuild
from chaorec_tpu_torch.models import gformer as tgf
from test_torch_bspm import both_clis_export
from test_torch_lightgcn import assert_grads_close, both_batches, jax_batches
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

FIRST = dict(Model="GFormer", batch_size=100, dim_E=16, learning_rate=0.001, reg_weight=1e-4,
             n_layers=1, pnn_layer=1, ssl_alpha=1.0, b2=1.0, ctra=0.01, topk=(5, 10, 20))
FLAGS = {"first": FIRST, "two_layers": dict(FIRST, n_layers=2, pnn_layer=2, ssl_alpha=0.1)}
TOL = dict(rtol=1e-5, atol=1e-6)


def pair(ds, flags):
    """(JAX model, port model, JAX params, port params, JAX trainer)."""
    jm = jbuild(JConfig(**flags), ds)
    tm = tbuild(TConfig(**flags), ds, "cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = tparams.from_numpy({k: np.asarray(v) for k, v in jp.items()})
    return jm, tm, jp, tp, jgf.GFormerTrainer(jm, ds, JConfig(**flags))


def port_graphs(jg, n):
    return tgf.graphs_from_arrays({k: np.asarray(v) for k, v in jg._asdict().items()}, n, "cpu")


def grad_np(p):
    """A leaf's gradient; zeros where the loss never read it (the sampler's
    PNN, whose gradient is zero in JAX)."""
    return np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()


def test_bag_gather_is_a_gather_whose_gradient_sums_per_row():
    """ops/ell.bag_gather: x[idx] forward; its gradient, the per-row sum of
    the cotangent in a fixed order, passes gradcheck (rows never gathered
    get 0, rows gathered 40 times sum through two bag levels)."""
    from chaorec_tpu_torch.ops.ell import bag_gather, segment_bags

    rs = np.random.default_rng(0)
    idx = np.concatenate([rs.integers(0, 30, 200), np.full(40, 7)])
    bags = segment_bags(idx, np.arange(len(idx)), 33, "cpu")
    x = torch.from_numpy(rs.standard_normal((33, 3))).double().requires_grad_()
    t_idx = torch.from_numpy(idx)
    assert torch.equal(bag_gather(x, t_idx, bags), x[t_idx])
    g = torch.from_numpy(rs.standard_normal((len(idx), 3)))
    got, = torch.autograd.grad(bag_gather(x, t_idx, bags), x, g)
    want, = torch.autograd.grad(x[t_idx], x, g)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    assert (got[30:] == 0).all()
    assert torch.autograd.gradcheck(lambda v: bag_gather(v, t_idx, bags).double(), (x,),
                                    eps=1e-3, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_sorted_unique_is_numpys_unique(seed):
    a = np.random.default_rng(seed).integers(0, 500, 3000) * 7919
    np.testing.assert_array_equal(tgf.sorted_unique(a), np.unique(a))
    assert tgf.sorted_unique(a[:0]).shape == (0,)


def test_anchors_distances_and_scramble_equal_jax(tiny_dataset):
    jm = jbuild(JConfig(**FIRST), tiny_dataset)
    tm = tbuild(TConfig(**FIRST), tiny_dataset, "cpu")
    np.testing.assert_array_equal(tm.anchor_ids.numpy(), np.asarray(jm.anchor_ids))
    np.testing.assert_array_equal(tm.dists.numpy(), np.asarray(jm.dists))
    np.testing.assert_array_equal(tm.scramble.numpy(), np.asarray(jm.scramble).reshape(-1))
    np.testing.assert_array_equal(tm.base_rows_np, jm.base_rows_np)
    np.testing.assert_array_equal(tm.base_cols_np, jm.base_cols_np)
    np.testing.assert_array_equal(tm.adj.w.numpy(), np.asarray(jm.adj_w))
    # the planted blocks are two components: the other block is unreachable (0)
    d = tm.dists.numpy()
    assert d.shape == (32, 112) and (d == 0).any() and ((d == 0) | (d <= 1.0)).all()


@pytest.mark.parametrize("seed", [0, 3])
def test_host_sampler_numpy_half_equals_jax(tiny_dataset, seed):
    """Given equal attention and an equal numpy generator state, the port's
    ``candidate_edges`` then ``mask_subgraphs`` make the JAX trainer's
    graphs, edge for edge (the JAX ones padded with zeros)."""
    jm, tm, jp, _, jt = pair(tiny_dataset, FIRST)
    n = jm.num_nodes
    rng = np.random.default_rng(seed)
    er, ec = tgf.candidate_edges(rng, tm.base_rows_np, tm.base_cols_np, n, jt.n_add)
    att = np.random.default_rng(100 + seed).random(len(er)).astype(np.float32) * 4.0
    got = tgf.mask_subgraphs(att, er, ec, n, rng)
    att_pad = np.zeros(jt.cap_add, np.float32)
    att_pad[:len(er)] = att
    jt._att_fn = lambda *args: jnp.asarray(att_pad)
    jt.np_rng = np.random.default_rng(seed)
    want = jt._host_sample(jp)._asdict()
    assert set(got) == set(want)
    for name, arr in got.items():
        w = np.asarray(want[name])
        assert arr.dtype == w.dtype, name
        np.testing.assert_array_equal(arr, w[:len(arr)], err_msg=name)
        assert not w[len(arr):].any(), name


def test_sampler_attention_matches_jax(tiny_dataset):
    jm, tm, jp, tp, _ = pair(tiny_dataset, FIRST)
    rows, cols = tm.base_rows_np, tm.base_cols_np
    want = jm.sampler_att(jp, jnp.asarray(rows), jnp.asarray(cols), jnp.ones(len(rows)))
    got = tm.sampler_att(tp, tgf.EdgeList.build(rows, cols, tm.num_nodes, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _step_inputs(ds, jt, jp, steps=(0, 1, -1)):
    graphs = jt._host_sample(jp)
    return graphs, [both_batches(a) for a in jax_batches(ds, 100, steps)]


@pytest.mark.parametrize("flags", list(FLAGS))
def test_loss_and_gradients_match_jax_on_its_padded_graphs(tiny_dataset, flags):
    jm, tm, jp, tp, jt = pair(tiny_dataset, FLAGS[flags])
    jgraphs, batches = _step_inputs(tiny_dataset, jt, jp)
    tgraphs = port_graphs(jgraphs, jm.num_nodes)
    vg = jax.jit(jax.value_and_grad(jm.loss_graphs))
    for step, (jb, tb) in enumerate(batches):
        jloss, jg = vg(jp, jb, jgraphs)
        leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
        tloss = tm.loss_graphs(leaves, tb, tgraphs)
        tloss.backward()
        assert tloss.item() == pytest.approx(float(jloss), rel=1e-5), step
        for k in jg:
            assert_grads_close(grad_np(leaves[k]), np.asarray(jg[k]), f"{k} step {step}")


def test_graphs_at_their_own_length_give_the_padded_loss(tiny_dataset):
    """The JAX graphs cut to their valid edges give the padded graphs' loss
    and gradients: a padded edge weighs 0 or is not valid."""
    jm, tm, jp, tp, jt = pair(tiny_dataset, FIRST)
    jgraphs, batches = _step_inputs(tiny_dataset, jt, jp, (0,))
    arrays = {k: np.asarray(v) for k, v in jgraphs._asdict().items()}
    cut, padded = dict(arrays), 0
    for name, (r, c, w, v) in tgf.GRAPH_FIELDS.items():
        n_real = int(arrays[v].sum()) if v else int((arrays[w] != 0).sum())
        padded += n_real < len(arrays[r])
        for f in (r, c, w, v):
            if f:
                cut[f] = arrays[f][:n_real]
    assert padded >= 1  # the decoder at least (its capacity counts every resample)
    out = []
    for a in (arrays, cut):
        leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
        loss = tm.loss_graphs(leaves, batches[0][1], tgf.graphs_from_arrays(a, tm.num_nodes,
                                                                            "cpu"))
        loss.backward()
        out.append((loss.item(), {k: grad_np(v) for k, v in leaves.items()}))
    assert out[1][0] == pytest.approx(out[0][0], rel=1e-6)
    for k, g in out[0][1].items():
        assert_grads_close(out[1][1][k], g, k)


@pytest.mark.parametrize("scale", [0.3, 1.0, 50.0])
def test_clip_by_global_norm_matches_optax(scale):
    rs = np.random.default_rng(int(scale * 10))
    grads = {f"g{i}": (rs.standard_normal(s) * scale).astype(np.float32)
             for i, s in enumerate([(7, 3), (11,), (2, 2, 5)])}
    want, _ = optax.clip_by_global_norm(20.0).update(
        {k: jnp.asarray(v) for k, v in grads.items()}, optax.EmptyState())
    got = [torch.from_numpy(v.copy()) for v in grads.values()]
    norm = tgf.clip_by_global_norm_(got, 20.0)
    assert float(norm) == pytest.approx(float(np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                                                          for v in grads.values()))), rel=1e-6)
    for g, k in zip(got, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]), rtol=1e-6, atol=0)
    assert (float(norm) >= 20.0) == (scale == 50.0)


@pytest.mark.parametrize("max_norm", [20.0, 0.5])
def test_clipped_adam_steps_match_optax(tiny_dataset, monkeypatch, max_norm):
    """Three of GFormerTrainer's steps on the JAX trainer's batches and
    graphs against value_and_grad of the JAX loss and optax's clip + Adam
    chain: each step's loss, the clipped gradients and the params after the
    step. At 20 (the reference's bound) these tiny steps are not clipped;
    at 0.5 every one is."""
    ds = tiny_dataset
    jm, tm, jp, tp, jt = pair(ds, FIRST)
    monkeypatch.setattr(tgf.GFormerTrainer, "max_grad_norm", max_norm)
    trainer = tgf.GFormerTrainer(tm, ds, TConfig(**FIRST))
    params = {k: v.clone().requires_grad_() for k, v in tp.items()}
    opt = trainer._base.make_optimizer(params)
    chain = optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(FIRST["learning_rate"]))
    jopt = chain.init(jp)
    jgraphs, batches = _step_inputs(ds, jt, jp)
    tgraphs = port_graphs(jgraphs, jm.num_nodes)
    vg = jax.jit(jax.value_and_grad(jm.loss_graphs))
    for step, (jb, tb) in enumerate(batches):
        jloss, jg = vg(jp, jb, jgraphs)
        clipped, _ = optax.clip_by_global_norm(max_norm).update(jg, optax.EmptyState())
        norm = float(optax.global_norm(jg))
        assert (norm >= max_norm) == (max_norm == 0.5), norm
        upd, jopt = chain.update(jg, jopt, jp)
        jp = optax.apply_updates(jp, upd)
        tloss = trainer.train_step(params, opt, tb, tgraphs)
        assert tloss.item() == pytest.approx(float(jloss), rel=1e-5), step
        for k in jg:
            assert_grads_close(grad_np(params[k]), np.asarray(clipped[k]), f"{k} step {step}")
            np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{k} step {step}")
        with torch.no_grad():  # the next step from the JAX params again
            for k, v in jp.items():
                params[k].copy_(torch.from_numpy(np.array(v)))


@pytest.mark.parametrize("flags", list(FLAGS))
def test_embeddings_match_jax(tiny_dataset, flags):
    jm, tm, jp, tp, _ = pair(tiny_dataset, FLAGS[flags])
    ju, ji = jm.embeddings(jp)
    with torch.no_grad():
        tu, ti = tm.embeddings(tp)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **TOL)


def test_an_epoch_resamples_every_fix_steps_batches(tiny_dataset, monkeypatch):
    """GFormerTrainer.train_epoch: one sample per group of fix_steps
    batches, the trainer's negatives a step, the sum of the step losses."""
    cfg = TConfig(**dict(FIRST, batch_size=32))  # 384 edges: 12 batches, 2 groups
    tm = tbuild(cfg, tiny_dataset, "cpu")
    trainer = tgf.GFormerTrainer(tm, tiny_dataset, cfg)
    samples, steps = [], []
    sample, step = trainer.sample_graphs, trainer.train_step
    monkeypatch.setattr(trainer, "sample_graphs", lambda p: samples.append(1) or sample(p))
    monkeypatch.setattr(trainer, "train_step",
                        lambda *a: steps.append(a[2].neg_items is not None) or step(*a))
    params = trainer._base.init_params()
    opt = trainer._base.make_optimizer(params)
    total = trainer._base.train_epoch(params, opt)
    assert len(samples) == 2 and steps == [True] * 12 and np.isfinite(total)


def test_the_cli_runs_gformer_trainer_and_exports_nothing(tiny_dataset, monkeypatch, tmp_path):
    """cli.run builds GFormerTrainer, whose weights sit on its inner trainer
    as in the JAX package: the JAX CLI's lines, and ``--export_artifact``
    logs the skip and writes no file."""
    built = []
    init = tgf.GFormerTrainer.__init__
    monkeypatch.setattr(tgf.GFormerTrainer, "__init__",
                        lambda self, *a: built.append(self) or init(self, *a))
    jlines, tlines, arts = both_clis_export(tiny_dataset, monkeypatch, tmp_path, FIRST)
    assert tlines == jlines
    assert len(built) == 1 and not hasattr(built[0], "best_params_host")
    assert not any(os.path.exists(a) for a in arts)
    assert "WARNING export_artifact: best combo's trainer kept no weights - skipping export" \
        in tlines
    assert sum(x == "INFO Epoch #, Loss: #" for x in tlines) == 1


# ---------------------------------------------------------------------------
# on the card: K2 at GFormer's three shapes on beauty


def _lse_cases():
    # (B, N): the user self-contrast, the item self-contrast and the cross term
    return [(1024, 15482, "self"), (1024, 8643, "self"), (1024, 8643, "cross"), (97, 513, "self")]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,kind", _lse_cases())
def test_k2_at_gformer_shapes_on_the_card(b, n, kind):
    """catalog_logsumexp as GFormer's loss calls it, on the card, against the
    plain version's autograd: the forward to rtol/atol 1e-5, the table's
    gradient (dq and dk summed by autograd where q and k are rows of one
    table) to 1e-5 of its largest plain entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from chaorec_tpu_torch.ops.losses import catalog_logsumexp
    from chaorec_tpu_torch.ops.streaming_lse import (streaming_logsumexp_reference,
                                                     streaming_lse_dk, streaming_lse_dq,
                                                     streaming_lse_fwd)

    gen = torch.Generator("cuda").manual_seed(b + n)
    table = (0.1 * torch.randn(n, 64, generator=gen, device="cuda")).requires_grad_()
    other = (0.1 * torch.randn(b * 2, 64, generator=gen, device="cuda")).requires_grad_()
    rows = torch.randint(0, n if kind == "self" else b * 2, (b,), generator=gen, device="cuda")
    g = torch.randn(b, generator=gen, device="cuda")

    def run(fn):
        q = table[rows] if kind == "self" else other[rows]
        out = fn(q, table)
        return (out, *torch.autograd.grad(out, (table, other) if kind == "cross" else (table,), g))

    before = [f.launches for f in (streaming_lse_fwd, streaming_lse_dq, streaming_lse_dk)]
    got = run(catalog_logsumexp)
    after = [f.launches for f in (streaming_lse_fwd, streaming_lse_dq, streaming_lse_dk)]
    assert [a - c for a, c in zip(after, before)] == [1, 1, 1]
    want = run(lambda q, k: streaming_logsumexp_reference(q, k))
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    for a, w in zip(got[1:], want[1:]):
        assert (a - w).abs().max().item() <= 1e-5 * w.abs().max().item()
