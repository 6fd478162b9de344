"""models/lightgcn.py and models/bpr.py against the JAX package's.

Both packages build each model from ``tiny_dataset`` (64 users x 48 items,
384 train edges) at dim 16 on a float32 graph, LightGCN with the combined
linear operator (``build_model``'s default) and without it
(``use_linear_op: false``, the layer stack). The port takes the JAX
package's initial params (``params.from_numpy``) and, for the trainer,
the JAX package's batches and negatives (``make_epoch_batches``,
``sample_negatives``), the last batch padded with weight-0 rows.

Tolerances: each batch's loss to rtol 1e-5; every gradient to 1e-4 of its
tensor's largest entry plus 1e-6 (float32 sums in another order); the
embeddings to rtol 1e-5, atol 1e-6.
"""

import logging
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chaorec_tpu import cli as jcli
from chaorec_tpu.config import Config as JConfig
from chaorec_tpu.data import sampling as jsampling
from chaorec_tpu.models import build_model as jbuild
from chaorec_tpu.models.base import Batch as JBatch
from chaorec_tpu_torch import cli as tcli
from chaorec_tpu_torch import params as tparams
from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.config import grid_combinations, load_yaml_config
from chaorec_tpu_torch.models import build_model as tbuild
from chaorec_tpu_torch.models.base import Batch as TBatch
from chaorec_tpu_torch.models.bpr import BPRMF
from chaorec_tpu_torch.models.lightgcn import LightGCN
from chaorec_tpu_torch.ops.linear_prop import CombinedLinearOp
from chaorec_tpu_torch.train import loop as tloop
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

LIGHTGCN = dict(Model="LightGCN", batch_size=100, dim_E=16, learning_rate=0.01,
                reg_weight=1e-3, n_layers=2, graph_compute_dtype="float32", topk=(5, 10, 20))
BPR = dict(LIGHTGCN, Model="BPR")
TOL = dict(rtol=1e-5, atol=1e-6)


def make_pair(ds, flags, use_linear_op=True):
    """(JAX model, port model, JAX params, the same params as tensors)."""
    jcfg, tcfg = JConfig(**flags), TConfig(**flags)
    if not use_linear_op:
        jcfg, tcfg = jcfg.replace(use_linear_op=False), tcfg.replace(use_linear_op=False)
    jm = jbuild(jcfg, ds)
    tm = tbuild(tcfg, ds, "cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = tparams.from_numpy({k: np.asarray(v) for k, v in jp.items()})
    return jm, tm, jp, tp


def jax_batches(ds, batch_size, steps=(0, 1, -1), seed=5):
    """The JAX trainer's batches ``steps`` of one epoch, each with its
    negatives, as numpy (users, pos, neg, weights)."""
    users, pos, weights, _ = jsampling.make_epoch_batches(
        jax.random.PRNGKey(seed), jnp.asarray(ds.train_edges), batch_size)
    history = jnp.asarray(ds.history.values)
    out = []
    for b in steps:
        neg = jsampling.sample_negatives(jax.random.PRNGKey(50 + b % users.shape[0]), users[b],
                                         history, ds.num_item)
        out.append(tuple(np.asarray(x) for x in (users[b], pos[b], neg, weights[b])))
    return out


def both_batches(arrays):
    u, p, n, w = arrays
    jb = JBatch(jnp.asarray(u), jnp.asarray(p), jnp.asarray(n), jnp.asarray(w))
    tb = TBatch(torch.from_numpy(np.array(u)).long(), torch.from_numpy(np.array(w)),
                pos_items=torch.from_numpy(np.array(p)).long(),
                neg_items=torch.from_numpy(np.array(n)).long())
    return jb, tb


def assert_grads_close(got, want, name):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale + 1e-6, err_msg=name)


def three_steps_match(ds, flags, jm, tm, jp, tp, jax_draw=None, set_draw=None):
    """Three steps of the port's Trainer.train_step against value_and_grad
    of the JAX loss, each from equal params, on the JAX trainer's batches
    (the last one padded): each step's loss and gradients. ``jax_draw(rng)``
    gives the random draws the JAX loss makes from its key and
    ``set_draw(draws)`` makes the port's loss use them."""
    trainer = tloop.Trainer(tm, ds, TConfig(**flags))
    params = {k: v.clone().requires_grad_() for k, v in tp.items()}
    opt = trainer.make_optimizer(params)
    jopt_fn = optax.adam(flags["learning_rate"])
    jopt = jopt_fn.init(jp)
    for step, arrays in enumerate(jax_batches(ds, flags["batch_size"])):
        jb, tb = both_batches(arrays)
        rng = jax.random.PRNGKey(100 + step)
        jloss, jg = jax.value_and_grad(jm.loss)(jp, jb, rng)
        with torch.no_grad():
            for k, v in jp.items():
                params[k].copy_(torch.from_numpy(np.array(v)))
        if jax_draw is not None:
            set_draw(jax_draw(rng))
        tloss = trainer.train_step(params, opt, tb)
        assert tloss.item() == pytest.approx(float(jloss), rel=1e-5), step
        for k in jg:
            assert_grads_close(params[k].grad.numpy(), np.asarray(jg[k]), f"{k} step {step}")
        upd, jopt = jopt_fn.update(jg, jopt, jp)
        jp = optax.apply_updates(jp, upd)


def test_build_model_makes_the_operator_by_default(tiny_dataset):
    """On a dense graph that fits, ``build_model`` makes the operator (bf16
    blocks on a bf16 graph, float32 on a float32 one); ``use_linear_op:
    false`` turns it off."""
    _, tm, _, _ = make_pair(tiny_dataset, LIGHTGCN)
    assert isinstance(tm, LightGCN) and isinstance(tm.linear_op, CombinedLinearOp)
    assert tm.linear_op.m_uu.dtype == torch.float32
    bf16 = tbuild(TConfig(**dict(LIGHTGCN, graph_compute_dtype="bfloat16")), tiny_dataset, "cpu")
    assert {m.dtype for m in (bf16.linear_op.m_uu, bf16.linear_op.m_ui, bf16.linear_op.m_iu,
                              bf16.linear_op.m_ii)} == {torch.bfloat16}
    assert bf16.linear_op.nbytes == 2 * (64 + 48) ** 2
    _, off, _, _ = make_pair(tiny_dataset, LIGHTGCN, use_linear_op=False)
    assert off.linear_op is None
    sparse = tbuild(TConfig(**dict(LIGHTGCN, dense_prop_threshold=0)), tiny_dataset, "cpu")
    assert not sparse.graph.use_dense and sparse.linear_op is None


@pytest.mark.parametrize("use_op", [True, False], ids=["operator", "layer_stack"])
def test_lightgcn_embeddings_match_jax(tiny_dataset, use_op):
    jm, tm, jp, tp = make_pair(tiny_dataset, LIGHTGCN, use_op)
    assert (jm.linear_op is not None) == (tm.linear_op is not None) == use_op
    ju, ji = jm.embeddings(jp)
    with torch.no_grad():
        tu, ti = tm.embeddings(tp)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **TOL)


@pytest.mark.parametrize("name,use_op", [("LightGCN", True), ("LightGCN", False), ("BPR", True)],
                         ids=["lightgcn-operator", "lightgcn-layer_stack", "bpr"])
def test_three_trainer_steps_match_jax(tiny_dataset, name, use_op):
    flags = LIGHTGCN if name == "LightGCN" else BPR
    jm, tm, jp, tp = make_pair(tiny_dataset, flags, use_op)
    three_steps_match(tiny_dataset, flags, jm, tm, jp, tp)


def test_bpr_keeps_the_reference_quirks(tiny_dataset):
    """No epsilon inside the log, the negative term of the regularizer
    unsquared (Model/BPR.py:58-60), and ranking without the item bias."""
    jm, tm, jp, tp = make_pair(tiny_dataset, BPR)
    assert isinstance(tm, BPRMF) and tm.name == "BPR"
    rs = np.random.default_rng(3)
    tp["item_bias"] = torch.from_numpy(rs.standard_normal(48).astype(np.float32))
    u, p, n, w = jax_batches(tiny_dataset, 100, steps=(-1,))[0]
    _, tb = both_batches((u, p, n, w))
    got = tm.loss(tp, tb, None).item()
    ue, ie, bias = (x.numpy().astype(np.float64) for x in
                    (tp["user_embedding"], tp["item_embedding"], tp["item_bias"]))
    x = (np.sum(ue[u] * ie[p], 1) + bias[p]) - (np.sum(ue[u] * ie[n], 1) + bias[n])
    wm = lambda v: np.sum(v * w) / max(np.sum(w), 1.0)  # noqa: E731
    want = (-wm(np.log(1.0 / (1.0 + np.exp(-x))))
            + 1e-3 * (wm(np.mean(ue[u] ** 2, 1)) + wm(np.mean(ie[p] ** 2, 1))
                      + wm(np.mean(ie[n], 1))))
    assert got == pytest.approx(want, rel=1e-5)
    jp = dict(jp, item_bias=jnp.asarray(tp["item_bias"].numpy()))
    assert got == pytest.approx(float(jm.loss(jp, both_batches((u, p, n, w))[0], None)), rel=1e-5)
    emb = tm.embeddings(tp)
    assert emb[0] is tp["user_embedding"] and emb[1] is tp["item_embedding"]


def test_lightgcn_learns(tiny_dataset):
    """Test recall@20 of the untrained model (random ranking gives ~0.42 on
    the planted 24-item blocks) rises after two epochs, and stays finite."""
    cfg = TConfig(**LIGHTGCN, num_epoch=2)
    trainer = tloop.Trainer(tbuild(cfg, tiny_dataset, "cpu"), tiny_dataset, cfg)
    params = trainer.init_params()
    opt = trainer.make_optimizer(params)
    before = trainer.evaluate(params)[1][20]["recall"]
    losses = [trainer.train_epoch(params, opt) for _ in range(2)]
    after = trainer.evaluate(params)[1][20]["recall"]
    assert np.all(np.isfinite(losses)) and after > before and after > 0.5, (before, after)


# --- the CLI ----------------------------------------------------------------
DATE = r"[A-Z][a-z]{2} \d{2} [A-Z][a-z]{2} \d{4} \d{2}:\d{2}:\d{2} INFO "
NUMBER = re.compile(r"-?\d+(\.\d+)?(e-?\d+)?")


def _shapes(path):
    messages = [re.sub(DATE, "", line) for line in open(path).read().splitlines()]
    start = next(i for i, m in enumerate(messages) if m.startswith("=========1/"))
    return [NUMBER.sub("#", m) for m in messages[start:]]


def test_cli_grid_log_matches_jax_cli(tiny_dataset, monkeypatch, tmp_path):
    """LightGCN's three-combo grid (Model_YAML/LightGCN.yaml: n_layers 1, 2,
    3), one epoch each, through each package's cli.run: the same line
    shapes, three combos, and an embeddings artifact of the best one."""
    monkeypatch.setattr(jcli, "data_load", lambda *a, **kw: tiny_dataset)
    grid = load_yaml_config("LightGCN")
    assert len(list(grid_combinations(grid))) == 3
    flags = dict(LIGHTGCN, data_path="tiny", num_epoch=1)
    root = logging.getLogger()
    handlers = list(root.handlers)
    art = str(tmp_path / "lightgcn.npz")
    try:
        jcli.run(JConfig(**flags, log_dir=str(tmp_path / "jax")), grid)
        best = tcli.run(TConfig(**flags, log_dir=str(tmp_path / "torch"), export_artifact=art),
                        grid, tiny_dataset, "cpu")
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
            h.close()
        for h in handlers:
            root.addHandler(h)
    jlines = _shapes(tmp_path / "jax" / "LightGCN_tiny.log")
    tlines = [line for line in _shapes(tmp_path / "torch" / "LightGCN_tiny.log")
              if not line.startswith(("export_artifact", "serving artifact"))]
    assert tlines == jlines
    assert sum(line.startswith("=========") for line in tlines) == 3
    assert sum(line == "Epoch #, Loss: #" for line in tlines) == 3
    assert sorted(best) == [5, 10, 20]
    with np.load(art) as z:
        assert str(z["kind"]) == "embeddings" and str(z["model"]) == "LightGCN"
        assert z["user_emb"].shape == (64, 16) and z["item_emb"].shape == (48, 16)
