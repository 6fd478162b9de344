"""graphs/user_graph.py against the JAX package's.

A tie-heavy set: 120 users over 30 items, each user 2-4 items from a pool
of 12 popular ones (a few users outside it, one with no edge, two
duplicate edges), so most co-interaction counts are 1 or 2 and a row holds
far more than ``topk + 1`` users of one count. The order of each row is
then the tie order, (-count, user id) in both packages; every array is
held to the JAX package's exactly. ``topk_sample``'s draws are numpy's on
both sides, seeded alike: equal bits.
"""

import numpy as np
import pytest

from chaorec_tpu import native
from chaorec_tpu.graphs import user_graph as juser_graph
from chaorec_tpu_torch.graphs import user_graph
from chaorec_tpu_torch.models import cohesion, dualgnn

NUM_USER, NUM_ITEM = 120, 30


def tie_heavy_edges():
    rs = np.random.default_rng(7)
    edges = []
    for u in range(NUM_USER - 1):  # the last user has no edge
        pool = np.arange(12) if u % 10 else np.arange(12, NUM_ITEM)
        for i in rs.choice(pool, size=int(rs.integers(2, 5)), replace=False):
            edges.append((u, int(i)))
    edges += [edges[0], edges[5]]  # duplicates: the dense B is binary, the sparse counts them
    return np.asarray(edges, np.int32)


@pytest.fixture(scope="module")
def edges():
    return tie_heavy_edges()


def without_native(monkeypatch):
    monkeypatch.setenv("CHAOREC_DISABLE_NATIVE", "1")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)


def assert_equal_graphs(got, want):
    for g, w, name in zip(got, want, ("indices", "counts", "lengths")):
        w = np.asarray(w)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("topk,row_chunk", [(8, 4096), (8, 50), (200, 4096)],
                         ids=["topk8", "topk8-chunks", "topk200"])
def test_dense_path_matches_jax(edges, topk, row_chunk):
    """The dense path: the rows hold more tied users than topk + 1 (topk 8),
    or all U - 1 others (topk 200 > U - 1); in one chunk and in 50-row ones."""
    want = juser_graph.build_user_cooccurrence(edges, NUM_USER, NUM_ITEM, topk=topk)
    got = user_graph.build_user_cooccurrence(edges, NUM_USER, NUM_ITEM, topk=topk,
                                             row_chunk=row_chunk)
    assert_equal_graphs(got, want)
    idx, cnt, lengths = got
    assert idx.shape == (NUM_USER, min(topk, NUM_USER - 1)) and lengths[-1] == 0
    # the ties are there: a row's last kept count is shared with users it left out
    full = user_graph.build_user_cooccurrence(edges, NUM_USER, NUM_ITEM, topk=200)[1]
    assert any((full[u] == cnt[u, -1]).sum() > (cnt[u] == cnt[u, -1]).sum()
               for u in range(NUM_USER) if cnt[u, -1] > 0) or topk == 200


@pytest.mark.parametrize("topk", [8, 200])
def test_sparse_path_matches_jax_numpy_path(edges, monkeypatch, topk):
    """dense_threshold 0: the sparse path against the JAX package's native
    path on its numpy fallback; the duplicate edges count twice in both."""
    without_native(monkeypatch)
    want = juser_graph.build_user_cooccurrence(edges, NUM_USER, NUM_ITEM, topk=topk,
                                               dense_threshold=0)
    for row_chunk in (4096, 37):
        got = user_graph.build_user_cooccurrence(edges, NUM_USER, NUM_ITEM, topk=topk,
                                                 dense_threshold=0, row_chunk=row_chunk)
        assert_equal_graphs(got, want)
    dense = juser_graph.build_user_cooccurrence(edges, NUM_USER, NUM_ITEM, topk=topk)
    assert not np.array_equal(np.asarray(dense[1]), got[1])  # the duplicates show


@pytest.mark.parametrize("model,k", [(dualgnn, 10), (cohesion, 40)], ids=["DualGNN", "COHESION"])
def test_topk_sample_matches_jax(edges, model, k):
    """The construction draw (default_rng(0)) and epochs 0-2 of each model's
    seed: the same (U, k) neighbours and weights, bit for bit."""
    uu = juser_graph.build_user_cooccurrence(edges, NUM_USER, NUM_ITEM)
    a, b = model.EPOCH_SEED
    for seed in [0] + [epoch * a + b for epoch in range(3)]:
        want = juser_graph.topk_sample(*uu, k, np.random.default_rng(seed))
        got = user_graph.topk_sample(*uu, k, np.random.default_rng(seed))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    idx, w = got
    assert np.all(w[-1] == 0) and np.allclose(w[:-1].sum(1), 1.0, rtol=1e-6)
