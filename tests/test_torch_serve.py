"""serve.py against chaorec_tpu/serve.py: artifacts, Recommender, HTTP.

Both artifact kinds cross between the packages: a CF_Diff ranklists artifact
exported by each from the same weights, and a BPR embeddings artifact built
by the JAX package as tests/test_serve.py builds it. Rankings are compared
id for id except where the reference's neighbouring scores lie within
``GAP`` (``lax.top_k`` and ``torch.topk`` may order near-ties differently);
scores to 1e-5.
"""

import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from chaorec_tpu import serve as jserve
from chaorec_tpu.config import Config as JConfig
from chaorec_tpu.models import build_model as jbuild
from chaorec_tpu.models import cf_diff as jcf
from chaorec_tpu.train.loop import Trainer
from chaorec_tpu_torch import params as tparams
from chaorec_tpu_torch import serve as tserve
from chaorec_tpu_torch.config import Config as TConfig
from chaorec_tpu_torch.models import build_model as tbuild
from chaorec_tpu_torch.models import cf_diff as tcf
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

GAP = 1e-5


def _assert_same_ranking(got, want):
    """got/want: lists (one per query) of [(id, score), ...]."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        gi, gs = np.array([i for i, _ in g]), np.array([s for _, s in g])
        wi, ws = np.array([i for i, _ in w]), np.array([s for _, s in w])
        np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-5)
        near = np.zeros(len(ws), bool)
        with np.errstate(invalid="ignore"):
            tie = ~(np.abs(np.diff(ws)) > GAP)  # -inf next to -inf is a tie
        near[:-1] |= tie
        near[1:] |= tie
        np.testing.assert_array_equal(gi[~near], wi[~near])


def _rows(ids, scores):
    return [list(zip(i.tolist(), s.tolist())) for i, s in zip(ids, scores)]


@pytest.fixture(scope="module")
def bpr_artifact(tiny_dataset, tmp_path_factory):
    ds = tiny_dataset
    cfg = JConfig(Model="BPR", batch_size=64, num_epoch=20, dim_E=16,
                  learning_rate=0.05, reg_weight=1e-4, patience=20)
    model = jbuild(cfg, ds)
    trainer = Trainer(model, ds, cfg)
    trainer.run()
    path = str(tmp_path_factory.mktemp("serve") / "bpr.npz")
    jserve.export_artifact(model, trainer.final_params, trainer.model_state, ds, path)
    return path


@pytest.fixture(scope="module")
def cf_diff_artifacts(tiny_dataset, tmp_path_factory):
    """CF_Diff at width 64 exported by each package from the same weights."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jcf.CF_Diff, "dim_inters", 64)
    mp.setattr(tcf.CF_Diff, "dim_inters", 64)
    try:
        cfg = dict(Model="CF_Diff", steps=10, noise_scale=0.1, noise_min=5e-4,
                   noise_max=5e-3)
        jm = jbuild(JConfig(**cfg), tiny_dataset)
        tm = tbuild(TConfig(**cfg), tiny_dataset, "cpu")
        jp = jm.init_params(jax.random.PRNGKey(0))
        tp = tparams.from_numpy({k: np.asarray(v) for k, v in jp.items()})
        d = tmp_path_factory.mktemp("cf_diff")
        jpath, tpath = str(d / "jax.npz"), str(d / "torch.npz")
        jserve.export_artifact(jm, jp, jm.init_state(None), tiny_dataset, jpath,
                               score_topk=20, eval_user_chunk=24)
        tserve.export_artifact(tm, tp, tm.init_state("cpu"), tiny_dataset, tpath,
                               score_topk=20, eval_user_chunk=24)
    finally:
        mp.undo()
    return jpath, tpath


def test_cf_diff_ranklists_match(cf_diff_artifacts, tiny_dataset):
    jpath, tpath = cf_diff_artifacts
    with np.load(jpath) as j, np.load(tpath) as t:
        assert set(j.files) == set(t.files)
        for key in j.files:
            if key not in ("rank_ids", "rank_scores"):
                np.testing.assert_array_equal(t[key], j[key], err_msg=key)
        assert t["rank_ids"].dtype == j["rank_ids"].dtype == np.int32
        _assert_same_ranking(_rows(t["rank_ids"], t["rank_scores"]),
                             _rows(j["rank_ids"], j["rank_scores"]))


@pytest.mark.parametrize("loader", ["torch", "jax"])
def test_ranklists_artifact_loads_in_either_package(cf_diff_artifacts, loader):
    """The port's artifact answers the same through both Recommenders."""
    _, tpath = cf_diff_artifacts
    rec = (tserve.Recommender.load(tpath, "cpu") if loader == "torch"
           else jserve.Recommender.load(tpath))
    with np.load(tpath) as z:
        ids = z["rank_ids"]
    got = rec.recommend([0, 5, 63], k=8)
    assert [[i for i, _ in r] for r in got] == ids[[0, 5, 63], :8].tolist()
    with pytest.raises(ValueError):
        rec.recommend([0], k=50)  # beyond the cached top-20
    with pytest.raises(ValueError):
        rec.similar_items([0])  # needs embeddings


@pytest.mark.parametrize("exclude_seen", [True, False])
def test_recommend_matches_jax(bpr_artifact, tiny_dataset, exclude_seen):
    trec = tserve.Recommender.load(bpr_artifact, "cpu")
    jrec = jserve.Recommender.load(bpr_artifact)
    users = list(range(tiny_dataset.num_user))
    _assert_same_ranking(trec.recommend(users, k=10, exclude_seen=exclude_seen),
                         jrec.recommend(users, k=10, exclude_seen=exclude_seen))


def test_recommend_excludes_history_and_validates(bpr_artifact, tiny_dataset):
    ds = tiny_dataset
    rec = tserve.Recommender.load(bpr_artifact, "cpu")
    for u, recs in zip([0, 1, 2], rec.recommend([0, 1, 2], k=10)):
        seen = set((ds.history.values[u, :ds.history.lengths[u]] + ds.num_user).tolist())
        assert not seen.intersection(i for i, _ in recs)
    with pytest.raises(ValueError):
        rec.recommend([10_000_000])
    assert rec.recommend([]) == []


@pytest.mark.parametrize("items", [[3], [0, 5, 47], [64 + 3, 64 + 20]])
def test_similar_items_match_jax(bpr_artifact, items):
    trec = tserve.Recommender.load(bpr_artifact, "cpu")
    jrec = jserve.Recommender.load(bpr_artifact)
    _assert_same_ranking(trec.similar_items(items, k=5), jrec.similar_items(items, k=5))


@pytest.mark.parametrize("history", [[0, 1, 2, 3], [64 + 30, 64 + 31]])
def test_fold_in_matches_jax(bpr_artifact, history):
    trec = tserve.Recommender.load(bpr_artifact, "cpu")
    jrec = jserve.Recommender.load(bpr_artifact)
    _assert_same_ranking([trec.fold_in(history, k=8)], [jrec.fold_in(history, k=8)])
    with pytest.raises(ValueError):
        trec.fold_in([])


def test_embeddings_export_matches_jax(bpr_artifact, tiny_dataset, tmp_path):
    """The port writes the same embeddings artifact from the same tables."""
    with np.load(bpr_artifact) as z:
        want = {k: z[k] for k in z.files}

    class Tables:
        name, rank_mode = "BPR", "embeddings"

        def embeddings(self, params):
            return params["u"], params["i"]

    path = str(tmp_path / "bpr_torch.npz")
    tserve.export_artifact(Tables(), tparams.from_numpy(
        {"u": want["user_emb"], "i": want["item_emb"]}), None, tiny_dataset, path)
    with np.load(path) as z:
        assert set(z.files) == set(want)
        for k in z.files:
            np.testing.assert_array_equal(z[k], want[k], err_msg=k)
    assert tserve.Recommender.load(path, "cpu").info() == jserve.Recommender.load(path).info()


def test_http_endpoint(bpr_artifact):
    rec = tserve.Recommender.load(bpr_artifact, "cpu")
    srv = tserve.serve_http(rec, port=0)
    port = srv.server_address[1]

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return json.load(r)

    try:
        health = get("/healthz")
        assert health["ok"] and health["model"] == "BPR" and health["kind"] == "embeddings"
        resp = get("/recommend?user=0,1&k=3")
        assert [r["user"] for r in resp["results"]] == [0, 1]
        assert [[it["item"] for it in r["items"]] for r in resp["results"]] == \
            [[i for i, _ in r] for r in rec.recommend([0, 1], k=3)]
        sim = get("/similar?item=2&k=4")
        assert len(sim["results"][0]["items"]) == 4
        for bad, code in (("/recommend?user=999999&k=3", 400), ("/nowhere", 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                get(bad)
            assert e.value.code == code
    finally:
        srv.shutdown()
        srv.server_close()


def test_mask_rows_ignores_padding():
    scores = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    hist = torch.tensor([[0, 2, 4], [4, 4, 4], [3, 1, 4]])
    got = tserve._mask_rows(scores, hist, float("-inf"))
    inf = float("-inf")
    assert torch.equal(got, torch.tensor([[inf, 1, inf, 3], [4, 5, 6, 7], [8, inf, 10, inf]]))
