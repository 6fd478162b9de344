"""data/homograph.py against the JAX package's, on the cases of
tests/test_homograph.py: the same neighbour tables (numpy, from a seed) go
to both packages and the rows must be equal, counts of small integers, so
exactly: duplicate neighbours sum, and the last short batch repeats node
N-1 past its ``valid`` count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chaorec_tpu.data import homograph as jhomograph
from chaorec_tpu_torch.data import homograph as thomograph


def _table(seed, n, k):
    return np.random.default_rng(seed).integers(0, n, size=(n, k)).astype(np.int32)


def test_rows_match_jax_with_duplicates_summed():
    n, k = 37, 5
    neighbors = _table(0, n, k)
    neighbors[3] = 7
    neighbors[10, :2] = neighbors[10, 2]
    idx = np.arange(n, dtype=np.int32)
    want = np.asarray(jhomograph.homograph_rows(jnp.asarray(neighbors), jnp.asarray(idx), n))
    got = thomograph.homograph_rows(torch.from_numpy(neighbors), torch.from_numpy(idx), n)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[3, 7] == k and got[10, neighbors[10, 2]] >= 3


@pytest.mark.parametrize("idx", [[0, 49, 17, 17], [5]], ids=["repeated_ids", "one_row"])
def test_subset_rows_match_jax(idx):
    n = 50
    neighbors = _table(2, n, 3)
    idx = np.asarray(idx, np.int32)
    want = np.asarray(jhomograph.homograph_rows(jnp.asarray(neighbors), jnp.asarray(idx), n))
    got = thomograph.homograph_rows(torch.from_numpy(neighbors), torch.from_numpy(idx), n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bs", [8, 23, 30])
def test_batches_match_jax_with_the_clamped_tail(bs):
    n = 23
    neighbors = _table(1, n, 4)
    jb = list(jhomograph.homograph_batches(neighbors, bs))
    tb = list(thomograph.homograph_batches(neighbors, bs))
    assert len(tb) == len(jb) == -(-n // bs)
    for (jrows, jidx, jvalid), (trows, tidx, tvalid) in zip(jb, tb):
        assert tvalid == jvalid and trows.shape == (bs, n)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
    assert tb[-1][2] == n - bs * (len(tb) - 1) and int(tb[-1][1][-1]) == n - 1
