"""The port's trainer core against the JAX package's: sampling, ranking,
metrics, early stopping, the CLI's log, and CF_Diff learning end to end.

Inputs come from numpy with a seed. Rank lists are compared id for id on
tie-free scores; metrics to 1e-6 (float32 sums in another order); early
stopping decision for decision.
"""

import logging
import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chaorec_tpu import cli as jcli
from chaorec_tpu.config import Config as JConfig
from chaorec_tpu.eval import metrics as jmetrics
from chaorec_tpu.eval import ranking as jranking
from chaorec_tpu.models import cf_diff as jcf
from chaorec_tpu.train import loop as jloop
from chaorec_tpu_torch import cli as tcli
from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.data.loading import _pad_lists
from chaorec_tpu_torch.data.sampling import make_epoch_batches
from chaorec_tpu_torch.eval import metrics as tmetrics
from chaorec_tpu_torch.eval import ranking as tranking
from chaorec_tpu_torch.models import build_model as tbuild
from chaorec_tpu_torch.models import cf_diff as tcf
from chaorec_tpu_torch.train import loop as tloop
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

# the e2e learn test's CF_Diff settings (tests/test_models_e2e.py)
LEARN = dict(Model="CF_Diff", batch_size=64, learning_rate=0.001, noise_scale=0.001,
             noise_min=0.005, noise_max=0.005, steps=5, topk=(5, 10, 20))


@pytest.mark.parametrize("num_users,batch_size", [(64, 64), (100, 32), (7, 1024)])
def test_epoch_batches_hold_every_user_once(num_users, batch_size):
    gen = torch.Generator().manual_seed(0)
    batches = make_epoch_batches(gen, num_users, batch_size)
    sizes = [b.users.shape[0] for b in batches]
    assert len(batches) == -(-num_users // batch_size)
    assert sizes == [batch_size] * len(batches)  # every batch is full
    assert [b.index for b in batches] == list(range(len(batches)))
    users = torch.cat([b.users for b in batches])
    weights = torch.cat([b.weights for b in batches])
    # every real row once with weight 1; pad rows repeat user 0 with weight 0
    assert torch.equal(weights, (torch.arange(users.shape[0]) < num_users).float())
    assert users.dtype == torch.int64 and sorted(users[:num_users].tolist()) == list(range(num_users))
    assert not users[num_users:].any()
    again = torch.cat([b.users for b in make_epoch_batches(gen, num_users, batch_size)])
    if num_users > 1:
        assert not torch.equal(users, again), "the next epoch reshuffles"


@pytest.mark.parametrize("mask_value", [1e-6, float("-inf")])
def test_mask_and_topk_matches_jax(mask_value):
    rs = np.random.default_rng(0)
    n, num_item, num_user, topk = 12, 40, 100, 10
    scores = rs.permutation(n * num_item).reshape(n, num_item).astype(np.float32) / 7.0
    lens = rs.integers(0, 9, n)
    hist = _pad_lists([sorted(rs.choice(num_item, size=m, replace=False).tolist())
                       for m in lens], fill=num_item, sort=True, min_width=8).values
    got = tranking.mask_and_topk(torch.from_numpy(scores), torch.from_numpy(hist), topk,
                                 num_user, mask_value)
    want = jranking.mask_and_topk(jnp.asarray(scores), jnp.asarray(hist), topk, num_user,
                                  mask_value)
    seen = np.zeros((n, num_item), np.uint8)
    for r in range(n):
        seen[r, hist[r][hist[r] < num_item]] = 1
    dense = jranking.mask_and_topk_dense(jnp.asarray(scores), jnp.asarray(seen), topk,
                                         num_user, mask_value)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(dense))


def test_rank_from_scores_matches_jax(tiny_dataset, monkeypatch):
    """CF_Diff at width 64 over every user, in chunks that do not divide."""
    monkeypatch.setattr(jcf.CF_Diff, "dim_inters", 64)
    monkeypatch.setattr(tcf.CF_Diff, "dim_inters", 64)
    from chaorec_tpu.models import build_model as jbuild
    from chaorec_tpu_torch import params as tparams

    import jax

    jm = jbuild(JConfig(**LEARN), tiny_dataset)
    tm = tbuild(TConfig(**LEARN), tiny_dataset, "cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = tparams.from_numpy({k: np.asarray(v) for k, v in jp.items()})
    hist = tiny_dataset.history.values
    got = tranking.rank_from_scores(tm, tp, torch.from_numpy(hist), topk=20, user_chunk=24)
    scores = jm.score_users(jp, jnp.arange(tiny_dataset.num_user))
    want = jranking.mask_and_topk(scores, jnp.asarray(hist), 20, tiny_dataset.num_user,
                                  float(jm.mask_value))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _metrics_dataset(seed):
    """A split of 30 users, some with empty truth lists, over 60 items."""
    rs = np.random.default_rng(seed)
    num_user, num_item = 30, 60
    truth = [sorted(rs.choice(num_item, size=int(m), replace=False).tolist())
             for m in rs.integers(0, 6, num_user)]
    truth[3] = truth[17] = []
    split = _pad_lists(truth, fill=-1)
    users = rs.permutation(num_user).astype(np.int32)
    ranked = np.stack([rs.permutation(num_item)[:50] for _ in range(num_user)]) + num_user
    return SimpleNamespace(num_user=num_user, num_item=num_item, val_users=users,
                           val_pos=split, test_users=users[::-1].copy(),
                           test_pos=split), ranked


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(seed):
    ds, ranked = _metrics_dataset(seed)
    ks = [5, 10, 20, 50]
    rank_t = torch.from_numpy(ranked)
    for split in ("val", "test"):
        want = jmetrics.gene_metrics(ds, jnp.asarray(ranked, jnp.int32), ks, split)
        got = tmetrics.gene_metrics(ds, rank_t, ks, split)
        _assert_metrics_close(got, want)
    val, test = tmetrics.gene_metrics_pair(rank_t, ks, tmetrics.split_tensors(ds, "val", "cpu"),
                                           tmetrics.split_tensors(ds, "test", "cpu"))
    jval, jtest = jmetrics.gene_metrics_pair(ds, jnp.asarray(ranked, jnp.int32), ks)
    _assert_metrics_close(val, jval)
    _assert_metrics_close(test, jtest)


def test_metrics_of_a_perfect_ranking():
    """Users whose truth leads the ranking score 1 on recall, ndcg, hit and
    map at every k; empty-truth rows pull the average down by their share."""
    ds, ranked = _metrics_dataset(2)
    pos = ds.val_pos
    for u, row in enumerate(ds.val_users):
        n = int(pos.lengths[u])
        rest = [i for i in ranked[row] if i - ds.num_user not in pos.values[u, :n]]
        ranked[row] = np.array(list(pos.values[u, :n] + ds.num_user) + rest)[:50]
    got = tmetrics.gene_metrics(ds, torch.from_numpy(ranked), [50], "val")[50]
    share = float(np.mean(pos.lengths > 0))
    for name in ("recall", "ndcg", "hit_rate", "map"):
        assert got[name] == pytest.approx(share, abs=1e-6), name


def _assert_metrics_close(got, want):
    assert list(got) == list(want)
    for k in want:
        assert list(got[k]) == list(want[k]) == list(tmetrics.METRIC_NAMES)
        for name, value in want[k].items():
            assert got[k][name] == pytest.approx(value, abs=1e-6), (k, name)


SCORES = [0.1, 0.2, 0.2, 0.15, 0.19, 0.3, 0.1, 0.1, 0.1, 0.29, 0.3]


@pytest.mark.parametrize("patience", [1, 3, 20])
def test_early_stopping_decides_as_jax(patience, capsys):
    jes, tes = jloop.EarlyStopping(patience), tloop.EarlyStopping(patience)
    for epoch, score in enumerate(SCORES):
        jes(score, {"epoch": epoch})
        tes(score, {"epoch": epoch})
        assert (tes.counter, tes.best_score, tes.early_stop, tes.best_metrics) == \
            (jes.counter, jes.best_score, jes.early_stop, jes.best_metrics)
    out = capsys.readouterr().out.splitlines()
    assert out[0::2] == out[1::2]  # the same counter lines, printed in turn


# --- the CLI ----------------------------------------------------------------
# A log line is "<date> INFO <message>"; its shape is the message with each
# number replaced by "#".
DATE = r"[A-Z][a-z]{2} \d{2} [A-Z][a-z]{2} \d{4} \d{2}:\d{2}:\d{2} INFO "
NUMBER = re.compile(r"-?\d+(\.\d+)?(e-?\d+)?")


def _shapes(path):
    lines = open(path).read().splitlines()
    assert lines and all(re.match(DATE, line) for line in lines), lines[:3]
    messages = [re.sub(DATE, "", line) for line in lines]
    start = next(i for i, m in enumerate(messages) if m.startswith("=========1/"))
    return messages[:start], [NUMBER.sub("#", m) for m in messages[start:]]


def test_cli_log_matches_jax_cli(tiny_dataset, monkeypatch, tmp_path):
    """Two epochs of CF_Diff through each package's cli.run: the log file
    has the same name, the same argument keys and the same line shapes."""
    monkeypatch.setattr(jcf.CF_Diff, "dim_inters", 64)
    monkeypatch.setattr(tcf.CF_Diff, "dim_inters", 64)
    monkeypatch.setattr(jcli, "data_load", lambda *a, **kw: tiny_dataset)
    grid = {"learning_rate": [0.001], "hyper_parameters": ["learning_rate"]}
    flags = dict(LEARN, data_path="tiny", num_epoch=2)
    root = logging.getLogger()
    handlers = list(root.handlers)
    try:
        jcli.run(JConfig(**flags, log_dir=str(tmp_path / "jax")), dict(grid))
        best = tcli.run(TConfig(**flags, log_dir=str(tmp_path / "torch")), dict(grid),
                        tiny_dataset, "cpu")
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
            h.close()
        for h in handlers:
            root.addHandler(h)
    jargs, jlines = _shapes(tmp_path / "jax" / "CF_Diff_tiny.log")
    targs, tlines = _shapes(tmp_path / "torch" / "CF_Diff_tiny.log")
    assert tlines == jlines
    assert [a.split(":")[0] for a in targs] == [a.split(":")[0] for a in jargs]
    assert sum(line == "Epoch #, Loss: #" for line in tlines) == 2
    assert sorted(best) == [5, 10, 20]
    assert all(np.isfinite(v) for m in best.values() for v in m.values())


def test_cf_diff_learns(tiny_dataset, monkeypatch):
    """The port's counterpart of tests/test_models_e2e.py::test_cf_diff_learns:
    recall@20 above 0.5 within 30 epochs at width 64 (random ranking gives
    ~0.42 on the planted 24-item blocks)."""
    monkeypatch.setattr(tcf.CF_Diff, "dim_inters", 64)
    cfg = TConfig(**LEARN, num_epoch=30, patience=30)
    best = tloop.train_and_evaluate(tbuild(cfg, tiny_dataset, "cpu"), tiny_dataset, cfg)
    assert best[20]["recall"] > 0.5, best
