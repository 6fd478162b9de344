"""data/loading.py and config.py against the JAX package's counterparts.

The loaders must produce identical arrays from the same npy files: history
sorted and padded with num_item, eval positives padded with -1, 0-based ids.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from chaorec_tpu import config as jconfig
from chaorec_tpu import native
from chaorec_tpu.data import loading as jload
from chaorec_tpu_torch import config as tconfig
from chaorec_tpu_torch.data import loading as tload

REPO = Path(__file__).resolve().parent.parent


def _write_dataset(root: Path, name: str, num_user: int, num_item: int,
                   with_dict: bool, seed: int = 0) -> None:
    """npy files in the reference's format: items offset by the dataset's
    user count (the reference table's, where it has one)."""
    offset = tload.DATASET_STATS.get(name, (num_user,))[0]
    rs = np.random.default_rng(seed)
    d = root / name
    d.mkdir(parents=True)
    hist = {u: sorted(rs.choice(num_item, size=int(rs.integers(1, 7)), replace=False).tolist(),
                      key=lambda _: rs.random())  # unsorted rows
            for u in range(num_user)}
    train = np.array([(u, i + offset) for u, items in hist.items() for i in items], np.int64)
    np.save(d / "train.npy", train[rs.permutation(len(train))])
    for split in ("val", "test"):
        rows = np.empty(num_user, dtype=object)
        for u in range(num_user):
            rows[u] = [u] + (rs.choice(num_item, size=int(rs.integers(1, 4)), replace=False)
                             + offset).tolist()
        np.save(d / f"{split}.npy", rows, allow_pickle=True)
    if with_dict:
        np.save(d / "user_item_dict.npy",
                {u: [i + offset for i in items] for u, items in hist.items()},
                allow_pickle=True)


def _assert_same_dataset(t, j):
    assert (t.name, t.num_user, t.num_item) == (j.name, j.num_user, j.num_item)
    np.testing.assert_array_equal(t.train_edges, j.train_edges)
    for f in ("history", "val_pos", "test_pos"):
        tp, jp = getattr(t, f), getattr(j, f)
        assert tp.fill == jp.fill and tp.values.dtype == jp.values.dtype
        np.testing.assert_array_equal(tp.values, jp.values, err_msg=f)
        np.testing.assert_array_equal(tp.lengths, jp.lengths, err_msg=f)
    np.testing.assert_array_equal(t.val_users, j.val_users)
    np.testing.assert_array_equal(t.test_users, j.test_users)
    np.testing.assert_array_equal(tload.dense_interactions(t), jload.dense_interactions(j))
    assert t.user_item_dict() == j.user_item_dict()


@pytest.mark.parametrize("with_dict", [True, False])
@pytest.mark.parametrize("name", ["toy", "baby"])
def test_loaders_agree(tmp_path, with_dict, name):
    """"toy" infers its counts from the data; "baby" takes the reference's
    table, which declares more users and items than the files hold."""
    _write_dataset(tmp_path, name, 40, 25, with_dict)
    t = tload.data_load(name, str(tmp_path))
    j = jload.data_load(name, str(tmp_path))
    _assert_same_dataset(t, j)
    assert t.history.values.dtype == np.int32
    if name == "baby":
        assert (t.num_user, t.num_item) == tload.DATASET_STATS["baby"]


@pytest.mark.parametrize("width,sort", [(9, True), (9, False), (3, True), (3, False)])
def test_pad_ragged_matches_native(width, sort):
    """Including rows longer than ``width``, which are cut before sorting."""
    rs = np.random.default_rng(width)
    lens = rs.integers(0, 8, 30)
    indptr = np.concatenate([[0], np.cumsum(lens)])
    values = rs.integers(0, 100, int(indptr[-1])).astype(np.int32)
    got = tload._pad_ragged(indptr, values, width, -1, sort_rows=sort)
    want = native.pad_ragged(indptr, values, width, -1, sort_rows=sort)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def test_config_fields_and_defaults_match():
    tf = [(f.name, f.type) for f in dataclasses.fields(tconfig.Config)]
    jf = [(f.name, f.type) for f in dataclasses.fields(jconfig.Config)]
    assert tf == jf
    assert tconfig.Config().as_flat_dict() == jconfig.Config().as_flat_dict()


@pytest.mark.parametrize("argv", [
    [],
    ["--Model", "CF_Diff", "--data_path", "baby", "--steps", "10", "--noise_scale", "0.1",
     "--eval_pipeline", "false", "--topk", "10", "20"],
])
def test_parse_cli_matches(argv):
    assert tconfig.parse_cli(argv).as_flat_dict() == jconfig.parse_cli(argv).as_flat_dict()


@pytest.mark.parametrize("model", ["CF_Diff", "SMORE"])
def test_yaml_grid_matches(model):
    ydir = str(REPO / "Model_YAML")
    ty, jy = tconfig.load_yaml_config(model, ydir), jconfig.load_yaml_config(model, ydir)
    assert ty == jy
    tg, jg = list(tconfig.grid_combinations(ty)), list(jconfig.grid_combinations(jy))
    assert tg == jg and tg
    for combo in tg:
        assert tconfig.Config().replace(**combo).as_flat_dict() == \
            jconfig.Config().replace(**combo).as_flat_dict()
