"""The branches the large catalogs take, forced on tiny sets, in both packages.

Microlens (46420 x 14079 = 653.5 M cells) is above ``dense_prop_threshold``
(600 M), and electronics (150179 x 51901) above the user co-occurrence's
dense threshold (1.5 B cells) and BSPM's 20000 items; ``chip_smoke.py``
phases 73-79 run those branches on the card at the sets' shapes. Here each
gate is forced on ``tiny_dataset`` (64 users x 48 items) and the port is
held to the JAX package on the branch it picks: the CLI's log lines of
LightGCN and SGL on the segment graph, LATTICE's U-I graph under
``_ui_graph``'s bf16 budget, GUME's own dense-bf16 gate (its budget
lowered below U x I in both packages), and FREEDOM's and COHESION's refusal
of a graph without a dense R. ``chip_smoke.catalog_dataset``, the sets'
maker, is checked at a small shape on the CPU, and the port's loader's
synthetic features (summed by torch's CPU ``index_add_`` for the catalogs'
feature tables) against the JAX loader's bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from chaorec_tpu import cli as jcli
from chaorec_tpu.config import Config as JConfig
from chaorec_tpu.data import loading as jloading
from chaorec_tpu.models import build_model as jbuild
from chaorec_tpu.models import gume as jgume
from chaorec_tpu_torch import cli as tcli
from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.data import loading as tloading
from chaorec_tpu_torch.models import build_model as tbuild
from chaorec_tpu_torch.models import gume as tgume
from chaorec_tpu_torch.ops.ell import EdgeMatrix
from test_torch_freedom import CFG as FREEDOM
from test_torch_graphs import PROP_TOL
from test_torch_lightgcn import LIGHTGCN, make_pair
from test_torch_mm_towers3 import FLAGS as TOWERS3
from test_torch_mm_towers4 import FLAGS as TOWERS4
from test_torch_rebuild_gated import LATTICE_F
from test_torch_sgl import CFG as SGL
from test_torch_vae import cli_logs_match
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def _built(monkeypatch, module):
    """The models ``module.build_model`` builds from now on."""
    built, build = [], module.build_model

    def recorded(*a, **kw):
        built.append(build(*a, **kw))
        return built[-1]

    monkeypatch.setattr(module, "build_model", recorded)
    return built


@pytest.mark.parametrize("name", ["LightGCN", "SGL"])
def test_cli_log_on_the_segment_graph_matches_jax_cli(tiny_dataset, monkeypatch, tmp_path,
                                                       name):
    """``dense_prop_threshold`` below U x I, as at microlens: both CLIs
    build the graph without a dense R (LightGCN without its combined
    operator) and log the same lines."""
    flags = dict({"LightGCN": LIGHTGCN, "SGL": SGL}[name], dense_prop_threshold=0)
    jbuilt, tbuilt = _built(monkeypatch, jcli), _built(monkeypatch, tcli)
    cli_logs_match(tiny_dataset, monkeypatch, tmp_path, flags)
    (jm,), (tm,) = jbuilt, tbuilt
    assert not jm.graph.use_dense and jm.graph.dense_r is None
    assert not tm.graph.use_dense and tm.graph.dense_r is None
    if name == "LightGCN":
        assert jm.linear_op is None and tm.linear_op is None


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_lattice_ui_graph_follows_the_bf16_budget(tiny_dataset, dtype):
    """LATTICE's U-I graph with ``dense_prop_threshold`` 0: the bf16 budget
    of 8e8 cells keeps the dense R at bfloat16, and the segment graph is
    taken at float32, in both packages; either propagates as the JAX
    graph does."""
    flags = dict(LATTICE_F, graph_compute_dtype=dtype, dense_prop_threshold=0)
    jm, tm, _, _ = make_pair(tiny_dataset, flags)
    dense = dtype == "bfloat16"
    assert jm.graph.use_dense == tm.graph.use_dense == dense
    assert (tm.graph.dense_r is not None) == dense
    if dense:
        assert tm.graph.dense_r.dtype == torch.bfloat16
    rs = np.random.default_rng(1)
    xu = rs.standard_normal((tiny_dataset.num_user, 8)).astype(np.float32)
    xi = rs.standard_normal((tiny_dataset.num_item, 8)).astype(np.float32)
    ju, ji = jm.graph.propagate(jnp.asarray(xu), jnp.asarray(xi))
    tu, ti = tm.graph.propagate(torch.from_numpy(xu), torch.from_numpy(xi))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju, np.float32), **PROP_TOL[dtype])
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji, np.float32), **PROP_TOL[dtype])


@pytest.mark.parametrize("dtype,budget", [("bfloat16", None), ("bfloat16", "below"),
                                          ("float32", None)],
                         ids=["bf16-within", "bf16-above", "fp32"])
def test_gume_dense_gate_follows_its_budget(tiny_dataset, monkeypatch, dtype, budget):
    """GUME's own gate: the dense bf16 R while U x I is at most its budget
    (8e8 cells; microlens' 653.5 M is within it) at bfloat16, else
    ``ops/ell.EdgeMatrix`` (the JAX ``EllMatrix``); the budget lowered below
    U x I in both packages forces the second branch at bfloat16. On the
    sparse branch both packages hold the same R."""
    if budget == "below":
        below = tiny_dataset.num_user * tiny_dataset.num_item - 1
        monkeypatch.setattr(jgume.GUME, "dense_entry_budget", below)
        monkeypatch.setattr(tgume.GUME, "dense_entry_budget", below)
    jm, tm, _, _ = make_pair(tiny_dataset, dict(TOWERS3["GUME"], graph_compute_dtype=dtype))
    dense = dtype == "bfloat16" and budget is None
    assert jm.graph_bf16 == tm.graph_bf16 == dense
    if dense:
        assert tm.r_norm.dtype == torch.bfloat16
        np.testing.assert_array_equal(tm.r_norm.float().numpy(),
                                      np.asarray(jm.r_norm, np.float32))
    else:
        assert isinstance(tm.r_norm, EdgeMatrix) and isinstance(tm.ii_norm, EdgeMatrix)
        eye_u = torch.eye(tiny_dataset.num_item)
        np.testing.assert_array_equal(
            tm.r_norm.matvec(eye_u).numpy(),
            np.asarray(jm.r_norm.matvec(jnp.eye(tiny_dataset.num_item, dtype=jnp.float32))))


@pytest.mark.parametrize("name", ["FREEDOM", "COHESION"])
def test_dense_r_models_refuse_a_graph_above_the_threshold(tiny_dataset, name):
    """Above ``dense_prop_threshold`` (microlens, electronics) the graph has
    no dense R. The port's FREEDOM and COHESION refuse it at build; the JAX
    package builds them with ``masked_r`` None and fails at their first use
    of it (FREEDOM's pruning in ``pre_epoch``, COHESION's products with R
    in its forward). The port does not make a dense R there."""
    flags = dict(FREEDOM if name == "FREEDOM" else TOWERS4["COHESION"],
                 dense_prop_threshold=0)
    with pytest.raises(ValueError, match="dense_prop_threshold"):
        tbuild(TConfig(**flags), tiny_dataset, "cpu")
    jm = jbuild(JConfig(**flags), tiny_dataset)
    assert not jm.graph.use_dense and jm.masked_r is None
    params = jm.init_params(jax.random.PRNGKey(0))
    with pytest.raises((AttributeError, TypeError), match="NoneType"):
        if name == "FREEDOM":
            jm.pre_epoch(params, jax.random.PRNGKey(1), 0)
        else:
            jm.embeddings(params)


def test_catalog_dataset_draws_weighted_histories_and_unseen_held_items():
    """``chip_smoke.catalog_dataset`` at a small shape on the CPU: 5-13
    distinct train items a user, the sorted padded history equal to the
    edges, one val and one test item each, distinct and unseen; the items'
    degrees follow the weights (the most popular tenth of the weights draws
    far more than its share); the same seed gives the same set, and
    ``first_users`` keeps the first users' rows and every item."""
    ds = chip_smoke.catalog_dataset("microlens", 3, "cpu", shape=(3000, 400))
    again = chip_smoke.catalog_dataset("microlens", 3, "cpu", shape=(3000, 400))
    assert np.array_equal(ds.train_edges, again.train_edges)
    lens = np.bincount(ds.train_edges[:, 0], minlength=3000)
    assert lens.min() >= 5 and lens.max() <= 13 and np.array_equal(lens, ds.history.lengths)
    pairs = ds.train_edges[:, 0].astype(np.int64) * 400 + ds.train_edges[:, 1]
    assert np.unique(pairs).size == pairs.size
    hist = ds.history.values
    assert hist.shape == (3000, 13) and (np.diff(hist, axis=1) >= 0).all()
    for u in (0, 7, 2999):
        row = hist[u, :lens[u]]
        assert np.array_equal(row, np.sort(ds.train_edges[ds.train_edges[:, 0] == u, 1]))
        assert (hist[u, lens[u]:] == 400).all()
    val, test = ds.val_pos.values[:, 0], ds.test_pos.values[:, 0]
    assert (val != test).all() and ((val >= 0) & (val < 400)).all()
    seen = (hist == val[:, None]).any(1) | (hist == test[:, None]).any(1)
    assert not seen.any()
    rng = np.random.default_rng(3)
    w = (1.0 / (np.arange(400) + 10.0))[rng.permutation(400)]
    deg = np.bincount(ds.train_edges[:, 1], minlength=400)
    top = np.argsort(-w)[:40]
    assert deg[top].sum() > 2.5 * pairs.size / 10
    cut = chip_smoke.first_users(ds, 100)
    assert cut.num_user == 100 and cut.num_item == 400
    assert np.array_equal(cut.train_edges, ds.train_edges[ds.train_edges[:, 0] < 100])
    assert np.array_equal(cut.history.values, hist[:100])


def test_synthetic_features_are_the_jax_loaders_bits(tmp_path):
    """Both loaders on a dataset without feature files: the port sums each
    item's projected users with torch's CPU ``index_add_`` (under half of
    ``np.add.at``'s host time at microlens' size), the JAX loader
    with ``np.add.at`` over the whole edge list; the image and text tables
    are equal bit for bit, popular items' hundreds of repeats included, and
    so in any edge chunking."""
    rs = np.random.default_rng(5)
    num_user, num_item, n = 300, 50, 4000
    edges = np.stack([rs.integers(0, num_user, n), (rs.zipf(1.5, n) - 1) % num_item], 1)
    d = tmp_path / "zipf"
    d.mkdir()
    np.save(d / "train.npy", np.stack([edges[:, 0], edges[:, 1] + num_user], 1))
    for split in ("val", "test"):
        rows = np.empty(num_user, dtype=object)
        for u in range(num_user):
            rows[u] = [u, num_user + int(rs.integers(num_item))]
        np.save(d / f"{split}.npy", rows, allow_pickle=True)
    (d / "stats.json").write_text(f'{{"num_user": {num_user}, "num_item": {num_item}}}')
    want = jloading.data_load("zipf", str(tmp_path), has_v=True, has_t=True)
    got = tloading.data_load("zipf", str(tmp_path), has_v=True, has_t=True)
    assert np.bincount(edges[:, 1]).max() > 500
    for name in ("v_feat", "t_feat"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    chunked = tloading.synthetic_item_features(got.train_edges, num_user, num_item,
                                               tloading.T_FEAT_DIM, tloading.T_FEAT_SEED,
                                               edge_chunk=37)
    np.testing.assert_array_equal(chunked, want.t_feat)
