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
from chaorec_tpu_torch.models import build_model as tbuild
from chaorec_tpu_torch.models import cf_diff as tcf
from chaorec_tpu_torch.train import loop as tloop
from test_torch_dccf import CFG as DCCF
from test_torch_dgcf import CFG as DGCF
from test_torch_freedom import CFG as FREEDOM
from test_torch_mgat import CFG as MGAT
from test_torch_ncl import CFG as NCL
from test_torch_sgl import CFG as SGL
from test_torch_train import LEARN as CF_DIFF

CONFIGS = {"CF_Diff": CF_DIFF, "FREEDOM": FREEDOM, "SGL": SGL, "NCL": NCL, "DGCF": DGCF,
           "DCCF": DCCF, "MGAT": MGAT}
SEED = 42


def _run(ds, name, device, seed=SEED, epochs=2):
    """(per-epoch losses, rank list) of a fresh trainer: pre_epoch and a
    training epoch per epoch, as ``Trainer.run`` does, then ``evaluate``."""
    cfg = TConfig(**CONFIGS[name], seed=seed, num_epoch=epochs)
    model = tbuild(cfg, ds, device)
    trainer = tloop.Trainer(model, ds, cfg)
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


@pytest.mark.parametrize("name,device", CASES)
def test_same_seed_runs_are_bit_identical(tiny_dataset, monkeypatch, name, device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the atomic sums this pins exist only there")
    monkeypatch.setattr(tcf.CF_Diff, "dim_inters", 64)  # CF_Diff's small width
    l1, r1 = _run(tiny_dataset, name, device)
    l2, r2 = _run(tiny_dataset, name, device)
    assert np.all(np.isfinite(l1)), l1
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
