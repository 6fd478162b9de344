"""Same seed, same bits: the port's counterpart of tests/test_determinism.py.

For each model the port trains, two fresh ``Trainer``s on one seed run 2
epochs and an evaluation; their per-epoch losses and rank lists must be
equal bit for bit, not merely close. The JAX package gets this from XLA's
fixed programs; the port gets it from one ``torch.Generator`` per trainer
and, on the card, from the trainer's deterministic mode
(``train/loop.py:deterministic_mode``), under which no sum is taken by
atomics. The CPU cases pin that the seed alone fixes a run; the ``cuda``
cases run the same on the card, where atomic sums in a racing order would
show. Each model runs at the small configuration its own port tests use,
on ``tiny_dataset``.
"""

import numpy as np
import pytest
import torch

from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.models import bspm as tbspm
from chaorec_tpu_torch.models import build_model as tbuild
from chaorec_tpu_torch.models import cf_diff as tcf
from chaorec_tpu_torch.train import loop as tloop
from test_torch_adagcl_grade import FLAGS as FAMILY2
from test_torch_bspm import FIRST as BSPM
from test_torch_contrastive import FLAGS as CONTRASTIVE
from test_torch_dccf import CFG as DCCF
from test_torch_dgcf import CFG as DGCF
from test_torch_diffmm import FLAGS as DIFFMM
from test_torch_diffrec import FLAGS as DIFFREC
from test_torch_freedom import CFG as FREEDOM
from test_torch_gformer import FIRST as GFORMER
from test_torch_idonly import FLAGS as IDONLY
from test_torch_lightgcn import BPR, LIGHTGCN
from test_torch_mgat import CFG as MGAT
from test_torch_mhrec import FLAGS as MHREC
from test_torch_mm_towers import FLAGS as MM_TOWERS
from test_torch_mm_towers2 import FLAGS as MM_TOWERS2
from test_torch_mm_towers3 import FLAGS as MM_TOWERS3
from test_torch_mm_towers4 import FLAGS as MM_TOWERS4
from test_torch_mmssl import FLAGS as MMSSL
from test_torch_ncl import CFG as NCL
from test_torch_ngcf_layergcn import LAYERGCN, NGCF_FLAGS
from test_torch_rebuild_gated import FLAGS as REBUILD_GATED
from test_torch_sgl import CFG as SGL
from test_torch_simgcl import SIMGCL, XSIMGCL
from test_torch_train import LEARN as CF_DIFF
from test_torch_vae import FLAGS as VAES

CONFIGS = {"CF_Diff": CF_DIFF, "FREEDOM": FREEDOM, "SGL": SGL, "NCL": NCL, "DGCF": DGCF,
           "DCCF": DCCF, "MGAT": MGAT, "BPR": BPR, "LightGCN": LIGHTGCN, "SimGCL": SIMGCL,
           "XSimGCL": XSIMGCL, "NGCF": NGCF_FLAGS, "LayerGCN": LAYERGCN, **VAES,
           "DiffRec": DIFFREC, **{n: IDONLY[n] for n in ("DHCF", "LightGODE", "SelfCF",
                                                          "FKAN_GCF", "MCLN")},
           "BSPM": BSPM, "GFormer": GFORMER,
           **{n: CONTRASTIVE[n] for n in ("HCCF", "LightGCL", "VGCL", "GraphAug")},
           "AdaGCL": FAMILY2["AdaGCL"], "Grade": FAMILY2["Grade"], **MM_TOWERS, **MM_TOWERS2,
           **MM_TOWERS3, **MM_TOWERS4, **REBUILD_GATED, "MMSSL": MMSSL, "DiffMM": DIFFMM,
           "MHRec": MHREC}
SEED = 42


def _run(ds, name, device, seed=SEED, epochs=2):
    """(per-epoch losses, rank list) of a fresh trainer: pre_epoch and a
    training epoch per epoch, as ``Trainer.run`` does, then ``evaluate``.
    A family trainer's epochs are its own (GFormer's resampling groups,
    AdaGCL's and Grade's multi-optimizer steps, DiffMM's and MHRec's three
    phases) on the standard trainer it wraps; BSPM, which trains nothing, is built
    from an empty spectral cache and only evaluated."""
    cfg = TConfig(**CONFIGS[name], seed=seed, num_epoch=epochs)
    if name == "BSPM":
        tbspm._SPECTRAL_CACHE.clear()
        trainer = tloop.Trainer(tbuild(cfg, ds, device), ds, cfg)
        tbspm._SPECTRAL_CACHE.clear()
        return np.zeros(0), trainer.evaluate({})[2].cpu().numpy()
    model = tbuild(cfg, ds, device)
    trainer = getattr(model, "trainer_cls", tloop.Trainer)(model, ds, cfg)
    trainer = getattr(trainer, "_base", trainer)
    params = trainer.init_params()
    opt = trainer.make_optimizer(params)
    losses = []
    for epoch in range(epochs):
        with tloop.deterministic_mode():  # as Trainer.run enters it around pre_epoch
            model.pre_epoch(params, epoch)
        losses.append(trainer.train_epoch(params, opt))
    _, _, rank = trainer.evaluate(params)
    return np.asarray(losses), rank.cpu().numpy()


CASES = [pytest.param(name, "cpu", id=f"{name}-cpu") for name in CONFIGS] + [
    pytest.param(name, "cuda", id=f"{name}-cuda", marks=pytest.mark.cuda) for name in CONFIGS]


@pytest.fixture
def threads(device):
    """One torch thread for the CPU cases, as the port's own tests run
    (torch_threads.one_torch_thread): on the default pool the xdist
    workers' threads contend for the cores (GraphAug's and Grade's cases,
    10 s together on one thread, took 100 s so beside another test run)."""
    n = torch.get_num_threads()
    if device == "cpu":
        torch.set_num_threads(1)
    yield torch.get_num_threads()
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,device", CASES)
def test_same_seed_runs_are_bit_identical(tiny_dataset, monkeypatch, threads, name, device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the atomic sums this pins exist only there")
    monkeypatch.setattr(tcf.CF_Diff, "dim_inters", 64)  # CF_Diff's small width
    l1, r1 = _run(tiny_dataset, name, device)
    l2, r2 = _run(tiny_dataset, name, device)
    assert np.all(np.isfinite(l1)) and (len(l1) == 2 or name == "BSPM"), l1
    np.testing.assert_array_equal(l1, l2)  # exact, not allclose
    np.testing.assert_array_equal(r1, r2)


def test_different_seed_runs_differ(tiny_dataset):
    l1, _ = _run(tiny_dataset, "SGL", "cpu")
    l2, _ = _run(tiny_dataset, "SGL", "cpu", seed=7)
    assert not np.array_equal(l1, l2)


def test_deterministic_mode_restores_the_previous_state():
    """Scoped, not global: the mode is on inside and as before outside."""
    fill = torch.utils.deterministic.fill_uninitialized_memory
    assert not torch.are_deterministic_algorithms_enabled()
    with tloop.deterministic_mode():
        assert torch.are_deterministic_algorithms_enabled()
        assert not torch.utils.deterministic.fill_uninitialized_memory
        with tloop.deterministic_mode():
            pass
        assert torch.are_deterministic_algorithms_enabled()
    assert not torch.are_deterministic_algorithms_enabled()
    assert torch.utils.deterministic.fill_uninitialized_memory == fill
