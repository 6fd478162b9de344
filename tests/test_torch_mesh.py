"""parallel/mesh.py: the dp split, the shard rule and the CLI's mesh runs.

- Every model that declares ``dp_split``: two slices of a padded batch,
  each loss scaled by its share of the weight, sum to the whole batch's
  loss (rtol 1e-5) and gradients (rtol 1e-4, atol 1e-6), and each slice
  leaves the generator where the whole batch leaves it; once with shares
  1 and 0, once with both slices weighted (0.7 and 0.3).
- For every registry model at mp=2 the port shards the params the JAX
  package's ``shard_params`` shards.
- The CLI spawns its ranks (gloo on the CPU, one torch thread a rank):
  LightGCN under dp=2,mp=2 learns as tests/test_parallel.py's does; MMSSL
  and AdaGCL under mp=2 log the single-device run's epochs; a world size other
  than dp x mp raises; spawning a rank loads no JAX.

The steps against the JAX package's sharded steps are in
tests/test_torch_mesh_steps.py, the family trainers and checkpoints across
meshes in tests/test_torch_mesh_family.py.
"""

import logging
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import mesh_workers as mw
from chaorec_tpu.config import Config as JConfig
from chaorec_tpu.models import build_model as jbuild
from chaorec_tpu.parallel import mesh as jmesh
from chaorec_tpu_torch import cli as tcli
from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.data.sampling import make_edge_batches
from chaorec_tpu_torch.models import build_model as tbuild
from chaorec_tpu_torch.parallel import mesh as tmesh
from chaorec_tpu_torch.train import loop as tloop
from test_torch_determinism import CONFIGS
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parent.parent
# the models that declare dp_split (held to that list by test_shard_rule_matches_jax)
DP_SPLIT = ("BPR", "LightGCN", "NGCF", "LayerGCN", "DHCF", "FKAN_GCF", "MGAT", "FREEDOM", "SGL",
            "NCL", "VBPR", "GRCN", "MMGCN", "DualGNN", "DRAGON")
SPLIT_BATCH = 160  # tiny_dataset's 384 edges: the last batch 64 rows and 96 of weight 0
# the last batch 160 rows and 64 of weight 0: slices of 112 rows (share 0.7) and
# of 48 rows and 64 padding (share 0.3)
WEIGHTED_BATCH = 224


def split_against_whole(tiny_dataset, name: str, batch_size: int, **over):
    """The last padded batch of ``batch_size`` rows: (the batch, its loss,
    gradients and generator state after it, the same of each of its two
    dp slices, each loss scaled by the slice's share, and the shares)."""
    ds = mw.port_dataset(tiny_dataset)
    cfg = TConfig(**{**CONFIGS[name], "batch_size": batch_size, "seed": 3, **over})
    model = tbuild(cfg, ds, "cpu")
    assert model.dp_split
    tr = tloop.Trainer(model, ds, cfg)
    params = tr.init_params()
    for k in model.table_params:
        params[k].requires_grad_()
    batch = tr.bpr_batch(make_edge_batches(tr.generator, tr.edges, batch_size)[-1])
    model.pre_epoch(params, 0)
    leaves = [v for v in params.values() if v.requires_grad]
    start = tr.generator.get_state()

    def run(b, scale=None):
        tr.generator.set_state(start)
        loss = model.loss(params, b, tr.generator)
        if scale is not None:
            loss = loss * scale
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return (loss.detach(), [torch.zeros_like(p) if g is None else g
                                for p, g in zip(leaves, grads)], tr.generator.get_state())

    halves = [tmesh.split_rows(batch, 2, r) for r in range(2)]
    return batch, run(batch), [run(*h) for h in halves], [float(s) for _, s in halves]


def assert_parts_sum(whole, parts):
    loss, grads, state = whole
    np.testing.assert_allclose(float(parts[0][0] + parts[1][0]), float(loss), rtol=1e-5)
    for g, a, b in zip(grads, parts[0][1], parts[1][1]):
        np.testing.assert_allclose((a + b).numpy(), g.numpy(), rtol=1e-4, atol=1e-6)
    for _, _, s in parts:
        assert torch.equal(s, state), "a slice moved the generator elsewhere"


@pytest.mark.parametrize("name", DP_SPLIT)
def test_dp_split_sums_to_the_whole_batch(tiny_dataset, name):
    """Slices 80 + 80 of the last batch: 64 rows and 16 padding, then only
    padding (a share of 0)."""
    batch, whole, parts, shares = split_against_whole(tiny_dataset, name, SPLIT_BATCH)
    assert float(batch.weights.sum()) == 64.0
    assert shares == [1.0, 0.0] and float(parts[1][0]) == 0.0
    assert_parts_sum(whole, parts)


@pytest.mark.parametrize("name", DP_SPLIT)
def test_dp_split_with_both_slices_weighted(tiny_dataset, name):
    """Slices 112 + 112 of the last batch: 112 rows, then 48 rows and 64
    padding (shares 0.7 and 0.3). A term summed over the rows and not
    divided by the share, or one that couples a batch's rows, fails here.
    The graph products run in float32: a bf16 product's backward rounds
    the gradient it propagates to bf16 (``ops/mxu.py``), once a slice
    where one device rounds once a batch, which no split gives back (FREEDOM's
    default bf16 graphs move gradients by up to ~1% of an element here)."""
    batch, whole, parts, shares = split_against_whole(tiny_dataset, name, WEIGHTED_BATCH,
                                                      graph_compute_dtype="float32")
    assert float(batch.weights.sum()) == 160.0
    np.testing.assert_allclose(shares, [0.7, 0.3], rtol=1e-6)
    assert_parts_sum(whole, parts)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_shard_rule_matches_jax(tiny_dataset, name):
    """The params sharded at mp=2 on both sides; ``dp_split`` only on the
    models of DP_SPLIT."""
    jm = jbuild(JConfig(**CONFIGS[name]), tiny_dataset)
    jp = jm.init_params(jax.random.PRNGKey(0))
    jsh = jmesh.shard_params(jp, jmesh.make_mesh(8))
    flat = {f"{k}.{kk}" if isinstance(v, dict) else k: vv
            for k, v in jsh.items() for kk, vv in (v.items() if isinstance(v, dict) else [(k, v)])}
    want = sorted(k for k, v in flat.items() if "mp" in str(v.sharding.spec))
    tm = tbuild(TConfig(**CONFIGS[name]), mw.port_dataset(tiny_dataset), "cpu")
    tp = tm.init_params(torch.Generator().manual_seed(0))
    assert sorted(k for k, v in tp.items() if tmesh.shard_rule(tuple(v.shape), 2)) == want
    assert tm.dp_split == (name in DP_SPLIT)


def test_mesh_spec_and_defaults():
    assert tmesh.parse_mesh_spec("dp=4,mp=2") == (4, 2)
    assert tmesh.parse_mesh_spec("mp=3") == (1, 3)
    assert tmesh.parse_mesh_spec("dp=2") == (2, 1)
    assert (tmesh.make_mesh(8).dp, tmesh.make_mesh(8).mp) == (4, 2)
    assert (tmesh.make_mesh(1).dp, tmesh.make_mesh(1).mp) == (1, 1)
    assert (tmesh.make_mesh(3).dp, tmesh.make_mesh(3).mp) == (3, 1)
    with pytest.raises(ValueError, match="unknown axes"):
        tmesh.parse_mesh_spec("tp=2")
    m = tmesh.Mesh(dp=2, mp=3, rank=4)
    assert (m.world, m.dp_index, m.mp_index) == (6, 1, 1)
    assert tmesh.choose_backend(torch.device("cpu"), 2) == "gloo"


def write_set(ds, root: Path) -> str:
    """``ds`` in the loader's files under ``root``."""
    import chip_smoke

    return chip_smoke.write_loader_files(ds, str(root / "data"))


def cli_log(tmp_path: Path, monkeypatch, name: str, flags: dict, grid: dict) -> list:
    """The log's messages of a CLI run of ``name`` under ``flags`` (the
    YAML ``grid`` in the run's directory), through ``cli.main``."""
    run_dir = tmp_path / f"{name}-{flags.get('--mesh_shape', 'single')}"
    (run_dir / "Model_YAML").mkdir(parents=True)
    with open(run_dir / "Model_YAML" / f"{name}.yaml", "w") as fh:
        for k, v in grid.items():
            fh.write(f"{k}: {v!r}\n".replace("'", '"'))
        fh.write(f"hyper_parameters: {list(grid)!r}\n".replace("'", '"'))
    monkeypatch.chdir(run_dir)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks' torch threads
    argv = ["--device", "cpu", "--Model", name, "--log_dir", str(run_dir / "log")]
    for k, v in flags.items():
        argv += [k, str(v)]
    tcli.main(argv)
    logging.getLogger().handlers.clear()
    with open(run_dir / "log" / f"{name}_tiny.log") as fh:
        return [re.sub(r"^.*? (INFO|WARNING) ", "", line) for line in fh.read().splitlines()]


def data_flags(tiny_dataset, tmp_path) -> dict:
    return {"--data_path": "tiny", "--data_root": write_set(tiny_dataset, tmp_path)}


def test_cli_lightgcn_learns_under_dp2_mp2(tiny_dataset, tmp_path, monkeypatch):
    """tests/test_parallel.py's LightGCN run under --mesh_shape dp=2,mp=2:
    four ranks spawned by the CLI, recall@20 above 0.55, one log."""
    flags = {**data_flags(tiny_dataset, tmp_path), "--num_epoch": 12, "--batch_size": 64,
             "--dim_E": 16, "--learning_rate": 0.05, "--reg_weight": 1e-4, "--patience": 12,
             "--mesh_shape": "dp=2,mp=2"}
    msgs = cli_log(tmp_path, monkeypatch, "LightGCN", flags, {"n_layers": [2]})
    best = float(next(m for m in msgs if m.startswith("Best performance:")).split()[-1])
    assert best > 0.55, best
    assert any(m.startswith("mesh dp=2,mp=2: rank 0 of 4") for m in msgs)
    assert sum(m.startswith("mesh dp=2,mp=2 epoch ") for m in msgs) == 12
    ranks = [m for m in msgs if re.match(r"mesh dp=2,mp=2 rank \d \(dp", m)]
    assert len(ranks) == 4, ranks


@pytest.mark.parametrize("name,extra", [
    ("MMSSL", dict(ssl_alpha=0.1, ssl_temp=0.5, G_rate=1e-4, mm_layers=1, learning_rate=0.005,
                   reg_weight=1e-5)),
    ("AdaGCL", dict(ssl_alpha=0.01, ssl_temp=0.5, reg_weight=1e-3, learning_rate=0.05)),
])
def test_cli_family_trainers_under_the_mesh(tiny_dataset, tmp_path, monkeypatch, name, extra):
    """tests/test_parallel.py's family-trainer CLI runs under mp=2 (two
    ranks): every epoch's lines equal the single-device run's (mp shards
    storage only; these trainers take the whole batch on every dp rank)."""
    flags = {**data_flags(tiny_dataset, tmp_path), "--num_epoch": 2, "--batch_size": 64,
             "--dim_E": 8, "--patience": 2, **{f"--{k}": v for k, v in extra.items()}}
    grid = {"n_layers": [1]}
    single = cli_log(tmp_path, monkeypatch, name, flags, grid)
    mesh = cli_log(tmp_path, monkeypatch, name, {**flags, "--mesh_shape": "mp=2"}, grid)

    def epochs(msgs):
        return [m for m in msgs if re.match(r"(Epoch \d|\d+: precision)", m)]

    assert epochs(mesh) == epochs(single)
    assert sum(m.startswith("Epoch ") for m in single) == 2


def test_world_size_must_be_dp_times_mp(tiny_dataset):
    tm = tbuild(TConfig(Model="BPR", dim_E=8), mw.port_dataset(tiny_dataset), "cpu")
    with pytest.raises(ValueError, match="--mesh_shape dp=4 needs 4 ranks, the world has 1"):
        tloop.Trainer(tm, tiny_dataset, TConfig(Model="BPR", dim_E=8, mesh_shape="dp=4"))


def test_a_spawned_rank_imports_no_jax(tmp_path):
    """A CLI rank process (spawned, a world of one) runs to its end and
    loads neither jax nor the JAX package."""
    probe = (
        "import sys, torch.multiprocessing as m\n"
        "sys.path.insert(0, 'tests')\n"
        "import mesh_workers as mw\n"
        "if __name__ == '__main__':\n"
        f"    print(mw.run_world(__import__('pathlib').Path({str(tmp_path)!r}), 'dp=1',\n"
        "                       'loaded', {}))\n")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[[]]", proc.stdout
