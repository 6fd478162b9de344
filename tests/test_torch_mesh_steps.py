"""The port's mesh steps against the JAX package's sharded steps.

Both sides start from the JAX package's initial params
(``params.from_numpy``) and take one step on one numpy batch (40 rows, the
last 5 of weight 0). The JAX side runs ``make_sharded_train_step`` (or
``make_sharded_stateful_step``) with ``shard_params``/``shard_batch`` on
the 8-device CPU mesh; the port runs ``Trainer.train_step`` in a gloo world
on the CPU (``tests/mesh_workers.py``): LightGCN and NCL under dp=2,mp=2
split their batch over dp, LATTICE takes it whole; FREEDOM under mp=3
shards its 48-row feature tables (the sports tables' 15207 rows shard at
mp=3 only). tests/test_parallel.py's tolerances: loss rtol 1e-4, params
rtol 1e-4 and atol 1e-5. NCL's k-means prototypes are the JAX loss's own
draw, given to the port; FREEDOM is pruned by the JAX mask.
``sharded_rank`` and ``sharded_rank_scores`` (MultVAE) equal the JAX
functions exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax

import mesh_workers as mw
from chaorec_tpu.config import Config as JConfig
from chaorec_tpu.models import build_model as jbuild
from chaorec_tpu.models.base import Batch as JBatch
from chaorec_tpu.parallel import mesh as jmesh
from test_torch_freedom import CFG as FREEDOM
from test_torch_freedom import jax_prune_mask
from test_torch_ncl import CFG as NCL
from test_torch_ncl import jax_prototypes
from test_torch_rebuild_gated import LATTICE_F
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

LOSS_RTOL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
LR = 1e-3
LIGHTGCN = dict(Model="LightGCN", batch_size=64, dim_E=16, learning_rate=LR, reg_weight=1e-4,
                n_layers=2, graph_compute_dtype="float32")


def batch_arrays(ds, b=40, pad=5, seed=0):
    """users, positives from the train edges, negatives outside each
    history, weights with a zeroed tail."""
    rs = np.random.default_rng(seed)
    edges = ds.train_edges[rs.choice(ds.num_edges, b, replace=False)]
    hist = ds.history
    neg = np.array([rs.choice(np.setdiff1d(np.arange(ds.num_item),
                                           hist.values[u, :hist.lengths[u]]))
                    for u in edges[:, 0]], np.int32)
    w = np.ones(b, np.float32)
    w[b - pad:] = 0.0
    return edges[:, 0].astype(np.int32), edges[:, 1].astype(np.int32), neg, w


def jax_step(flags, ds, arrays, stateful=False, prune=False, rng_seed=7):
    """(the JAX model, its initial params as numpy, (loss, params after
    the sharded step)) on the 8-device mesh."""
    jm = jbuild(JConfig(**flags, learning_rate=LR), ds)
    jp = jm.init_params(jax.random.PRNGKey(0))
    start = {k: np.asarray(v) for k, v in jp.items()}
    if prune:
        jm.pre_epoch(jp, None, 0)
    mesh = jmesh.make_mesh(8)
    u, p, n, w = (jnp.asarray(a) for a in arrays)
    batch = jmesh.shard_batch(JBatch(u, p, n, w, jnp.int32(0), None), mesh)
    opt = optax.adam(LR)
    sp = jmesh.shard_params(jp, mesh)
    rng = jax.random.PRNGKey(rng_seed)
    if stateful:
        step = jmesh.make_sharded_stateful_step(jm, opt, mesh)
        state = jmesh.shard_state(jm.init_state(jax.random.PRNGKey(1)), mesh)
        out, _, _, loss = step(sp, jmesh.init_stateful_opt_state(jm, opt, sp), state, batch, rng)
    else:
        out, _, loss = jmesh.make_sharded_train_step(jm, opt, mesh)(sp, opt.init(sp), batch, rng)
    return jm, jp, start, (float(loss), {k: np.asarray(v) for k, v in out.items()})


def assert_step(got, want, name):
    loss, params = want
    np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_RTOL, err_msg=name)
    assert sorted(got["params"]) == sorted(params), name
    for k, v in params.items():
        np.testing.assert_allclose(got["params"][k], v, err_msg=f"{name} {k}", **PARAM_TOL)


def same_on_every_rank(results, key):
    for r in results[1:]:
        for name in results[0][key]:
            a, b = results[0][key][name], r[key][name]
            assert a["loss"] == b["loss"] and a["digest"] == b["digest"], name
            for k in a["params"]:
                np.testing.assert_array_equal(a["params"][k], b["params"][k], err_msg=k)


def test_dp2_mp2_steps_and_rankings_match_jax(tiny_dataset, tmp_path):
    ds = mw.port_dataset(tiny_dataset)
    arrays = batch_arrays(tiny_dataset)
    cases, want = {}, {}
    for name, flags, stateful in (("LightGCN", LIGHTGCN, False), ("NCL", NCL, False),
                                  ("LATTICE", LATTICE_F, True)):
        flags = {k: v for k, v in flags.items() if k != "learning_rate"}
        jm, jp, start, want[name] = jax_step(flags, tiny_dataset, arrays, stateful)
        cases[name] = {"dataset": ds, "flags": dict(flags, learning_rate=LR), "params": start,
                       "batch": arrays}
        if name == "NCL":
            protos = jax_prototypes(jm, jp, jax.random.PRNGKey(7))
            cases[name]["protos"] = [t.numpy() for t in protos]
    rs = np.random.default_rng(2)
    ue = rs.standard_normal((ds.num_user, 16)).astype(np.float32)
    ie = rs.standard_normal((ds.num_item, 16)).astype(np.float32)
    hist = np.asarray(ds.history.values)
    mv_flags = dict(Model="MultVAE", batch_size=64, dim_E=16, learning_rate=LR)
    jmv = jbuild(JConfig(**mv_flags), tiny_dataset)
    mv_params = jmv.init_params(jax.random.PRNGKey(0))
    mesh8 = jmesh.make_mesh(8)
    rank_want = np.asarray(jmesh.sharded_rank(jnp.asarray(ue), jnp.asarray(ie),
                                              jnp.asarray(hist), ds.num_user, 10, mesh8))
    scores_want = np.asarray(jmesh.sharded_rank_scores(jmv, mv_params, jnp.asarray(hist),
                                                       ds.num_user, 10, mesh8))
    payload = {"steps": cases, "ue": ue, "ie": ie, "hist": hist, "num_user": ds.num_user,
               "dataset": ds, "multvae": mv_flags,
               "multvae_params": {k: np.asarray(v) for k, v in mv_params.items()}}
    results = mw.run_world(tmp_path, "dp=2,mp=2", "steps_and_ranks", payload)
    for name, w in want.items():
        assert_step(results[0]["steps"][name], w, name)
    # the tables and the embeddings shard; LightGCN's and NCL's two tables
    assert results[0]["steps"]["LightGCN"]["sharded"] == ["item_embedding", "user_embedding"]
    same_on_every_rank([r for r in results], "steps")
    for r in results:
        np.testing.assert_array_equal(r["ranks"]["rank"], rank_want)
        np.testing.assert_array_equal(r["ranks"]["scores"], scores_want)


def test_freedom_mp3_shards_its_tables_and_matches_jax(tiny_dataset, tmp_path):
    ds = mw.port_dataset(tiny_dataset)
    arrays = batch_arrays(tiny_dataset)
    flags = {k: v for k, v in FREEDOM.items() if k != "learning_rate"}
    jm, _, start, want = jax_step(flags, tiny_dataset, arrays, prune=True, rng_seed=3)
    case = {"dataset": ds, "flags": dict(flags, learning_rate=LR), "params": start,
            "batch": arrays, "keep_mask": jax_prune_mask(jm, 0)}
    results = mw.run_world(tmp_path, "mp=3", "steps", {"steps": {"FREEDOM": case}})
    got = results[0]["FREEDOM"]
    assert got["sharded"] == ["item_embedding", "t_feat", "v_feat"]
    assert_step(got, want, "FREEDOM")
    same_on_every_rank([{"s": r} for r in results], "s")
