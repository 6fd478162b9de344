"""models/bspm.py and the CLI's family-trainer dispatch against the JAX
package's.

Both packages build BSPM from ``tiny_dataset`` (64 users x 48 items, so q =
min(128, 47) = 47 factors). BSPM has no params and draws nothing at
scoring time; its one random draw is the spectral build's start vector,
which differs between the packages (the port draws it from the seed with
numpy, the JAX package leaves it to ARPACK), while the subspace it finds is
the same. Tolerances: the scores within 1e-4 of the largest score; the
Gram matrix to rtol 1e-6.
"""

import logging
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chaorec_tpu import cli as jcli
from chaorec_tpu.config import Config as JConfig
from chaorec_tpu.models import build_model as jbuild
from chaorec_tpu_torch import cli as tcli
from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.config import grid_combinations, load_yaml_config
from chaorec_tpu_torch.models import bspm as tbspm
from chaorec_tpu_torch.models import build_model as tbuild
from test_torch_vae import NUMBER
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

FIRST = dict(Model="BSPM", K_s=1, T_s=1.0, K_b=1, T_b=1.0, idl_beta=1.0, topk=(5, 10, 20))
COMBOS = {"first": FIRST, "k2": dict(FIRST, K_s=2, T_s=1.5, idl_beta=0.7),
          "k4": dict(FIRST, K_s=4, T_s=2.5)}


def scores_close(got, want, what=""):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("combo", list(COMBOS))
def test_scores_match_jax(tiny_dataset, combo):
    flags = COMBOS[combo]
    tbspm._SPECTRAL_CACHE.clear()
    jm = jbuild(JConfig(**flags), tiny_dataset)
    tm = tbuild(TConfig(**flags), tiny_dataset, "cpu")
    assert (tm.rank_mode, tm.k_s, tm.t_s, tm.t_b) == ("scores", flags["K_s"], flags["T_s"],
                                                      float(flags["K_s"]))  # the T_b quirk
    assert tm.init_params(torch.Generator()) == {}
    assert tm.b.shape == (48, 47) and tm.c.dtype == torch.float32
    np.testing.assert_allclose(tm.c.numpy(), np.asarray(jm.c), rtol=1e-6, atol=1e-7)
    users = np.arange(64)
    want = np.asarray(jm.score_users({}, jnp.asarray(users)))
    got = tm.score_users({}, torch.from_numpy(users)).numpy()
    scores_close(got, want)


def test_the_cache_builds_once_per_dataset_and_seeded_builds_agree(tiny_dataset):
    import dataclasses

    tbspm._SPECTRAL_CACHE.clear()
    m1 = tbuild(TConfig(**FIRST), tiny_dataset, "cpu")
    assert len(tbspm._SPECTRAL_CACHE) == 1 and m1.build_seconds > 0
    m2 = tbuild(TConfig(**COMBOS["k4"]), tiny_dataset, "cpu")
    assert m2.b is m1.b and m2.c is m1.c and m2.build_seconds == 0.0
    ds2 = dataclasses.replace(tiny_dataset, train_edges=np.array(tiny_dataset.train_edges)[:-2])
    m3 = tbuild(TConfig(**FIRST), ds2, "cpu")
    assert m3.b is not m1.b and len(tbspm._SPECTRAL_CACHE) == 1
    # a second build on one seed, the cache cleared: the same bits (the
    # start vector is drawn from the seed, not by ARPACK)
    tbspm._SPECTRAL_CACHE.clear()
    m4 = tbuild(TConfig(**FIRST), tiny_dataset, "cpu")
    assert m4.b is not m1.b and torch.equal(m4.b, m1.b)
    ids = torch.arange(64)
    assert torch.equal(m4.score_users({}, ids), m1.score_users({}, ids))


def test_float64_control(tiny_dataset, monkeypatch):
    tbspm._SPECTRAL_CACHE.clear()
    f32 = tbuild(TConfig(**FIRST), tiny_dataset, "cpu").score_users({}, torch.arange(64))
    monkeypatch.setenv("CHAOREC_BSPM_DTYPE", "float64")
    tbspm._SPECTRAL_CACHE.clear()
    m = tbuild(TConfig(**FIRST), tiny_dataset, "cpu")
    f64 = m.score_users({}, torch.arange(64))
    tbspm._SPECTRAL_CACHE.clear()
    assert m.r.dtype == m.c.dtype == m.b.dtype == f64.dtype == torch.float64
    scores_close(f64.float().numpy(), f32.numpy())


def test_the_randomized_route_above_the_eigsh_limit(tiny_dataset, monkeypatch):
    """Above EIGSH_MAX_ITEMS the factors come from the randomized SVD of R
    (oversample 128, 8 power iterations): the same subspace, so the same
    scores as the eigsh route to 1e-4 of the largest."""
    tbspm._SPECTRAL_CACHE.clear()
    exact = tbuild(TConfig(**FIRST), tiny_dataset, "cpu").score_users({}, torch.arange(64))
    monkeypatch.setattr(tbspm, "EIGSH_MAX_ITEMS", 10)
    tbspm._SPECTRAL_CACHE.clear()
    m = tbuild(TConfig(**FIRST), tiny_dataset, "cpu")
    tbspm._SPECTRAL_CACHE.clear()
    assert m.b.shape == (48, 47)
    scores_close(m.score_users({}, torch.arange(64)).numpy(), exact.numpy())


def both_clis_export(ds, monkeypatch, tmp_path, flags):
    """Each package's cli.run of ``flags["Model"]`` at its Model_YAML file's
    first combo, 1 epoch, with ``--export_artifact``: (the JAX log's and
    the port's line shapes from the grid's first line on, dates and
    numbers blanked; the two artifact paths)."""
    name = flags["Model"]
    monkeypatch.setattr(jcli, "data_load", lambda *a, **kw: ds)
    combo = next(grid_combinations(load_yaml_config(name)))
    grid = {k: [v] for k, v in combo.items()}
    grid["hyper_parameters"] = list(combo)
    run_flags = dict(flags, data_path="tiny", num_epoch=1)
    arts = [str(tmp_path / f"{side}.npz") for side in ("jax", "torch")]
    root = logging.getLogger()
    handlers = list(root.handlers)
    try:
        jcli.run(JConfig(**run_flags, log_dir=str(tmp_path / "jax"), export_artifact=arts[0]),
                 grid)
        tcli.run(TConfig(**run_flags, log_dir=str(tmp_path / "torch"), export_artifact=arts[1]),
                 grid, ds, "cpu")
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
            h.close()
        for h in handlers:
            root.addHandler(h)

    def shapes(side):
        lines = open(tmp_path / side / f"{name}_tiny.log").read().splitlines()
        lines = [re.sub(r"^\w{3} \d{2} \w{3} \d{4} \d{2}:\d{2}:\d{2} ", "", x) for x in lines]
        start = next(i for i, x in enumerate(lines) if x.startswith("INFO =========1/"))
        return [NUMBER.sub("#", x) for x in lines[start:]]

    return shapes("jax"), shapes("torch"), arts


def test_the_cli_dispatches_to_the_train_free_trainer(tiny_dataset, monkeypatch, tmp_path):
    """cli.run builds the model's ``trainer_cls``: BSPM's one pass logs the
    JAX CLI's lines (no epoch line), and ``--export_artifact`` logs the
    skip and writes no file, as the JAX CLI does."""
    built = []
    monkeypatch.setattr(tbspm.TrainFreeTrainer, "__init__", (
        lambda init: lambda self, *a: built.append(self) or init(self, *a))(
            tbspm.TrainFreeTrainer.__init__))
    jlines, tlines, arts = both_clis_export(tiny_dataset, monkeypatch, tmp_path, FIRST)
    assert tlines == jlines
    assert len(built) == 1 and not hasattr(built[0], "best_params_host")
    assert not any(os.path.exists(a) for a in arts)
    assert "WARNING export_artifact: best combo's trainer kept no weights - skipping export" \
        in tlines
    assert not any(x.startswith("INFO Epoch") for x in tlines)
    assert "INFO Validation Metrics:" in tlines and "INFO Test Metrics:" in tlines


def test_the_whole_grid_builds_the_spectrum_once(tiny_dataset, tmp_path):
    grid = load_yaml_config("BSPM")
    combos = list(grid_combinations(grid))
    assert len(combos) == 16 and combos[0] == {k: FIRST[k] for k in combos[0]}
    tbspm._SPECTRAL_CACHE.clear()
    builds = []
    orig = tbspm.BSPM.__init__

    def counted(self, *a, **kw):
        orig(self, *a, **kw)
        builds.append(self.build_seconds > 0)

    tbspm.BSPM.__init__ = counted
    try:
        best = tcli.run(TConfig(Model="BSPM", data_path="tiny", topk=(5, 10, 20),
                                log_dir=str(tmp_path)), grid, tiny_dataset, "cpu")
    finally:
        tbspm.BSPM.__init__ = orig
        tbspm._SPECTRAL_CACHE.clear()
    assert builds == [True] + [False] * 15
    assert sorted(best) == [5, 10, 20]
