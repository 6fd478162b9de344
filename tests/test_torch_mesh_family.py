"""The family trainers and checkpoints on a mesh, against one device.

Under mp=2 (two gloo ranks on the CPU, ``tests/mesh_workers.py``) mp
shards storage only, so an epoch of DiffMM's, Grade's, MHRec's and
GFormer's own trainers (every optimizer step, the gathers refreshed after
each; GFormer's clip over the whole gradient) gives the single-device
epoch's loss, params and rank lists bit for bit. A checkpoint keeps the
single-device schema: FREEDOM (its feature tables sharded) checkpointed
by the mesh resumes on one device, and the reverse, and both end on the
bits of an uninterrupted single-device run.
"""

import numpy as np

import mesh_workers as mw
from chaorec_tpu_torch.parallel.mesh import Mesh
from test_torch_adagcl_grade import FLAGS as FAMILY2
from test_torch_diffmm import FLAGS as DIFFMM
from test_torch_freedom import CFG as FREEDOM
from test_torch_gformer import FIRST as GFORMER
from test_torch_mhrec import FLAGS as MHREC
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

FAMILIES = {"DiffMM": DIFFMM, "Grade": FAMILY2["Grade"], "MHRec": MHREC, "GFormer": GFORMER}
SEED = dict(seed=5)


def assert_same(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


def test_family_trainers_and_checkpoints_across_meshes(tiny_dataset, tmp_path):
    ds = mw.port_dataset(tiny_dataset)
    single = Mesh()
    families = {n: dict(f, **SEED) for n, f in FAMILIES.items()}
    flags = dict(FREEDOM, **SEED)
    dirs = {k: str(tmp_path / k) for k in ("single", "mesh", "whole")}
    wrote = mw.resume_run(flags, ds, single, dirs["single"], 2)
    payload = {"dataset": ds, "families": families, "flags": flags,
               "to_single": dirs["mesh"], "from_single": dirs["single"]}
    results = mw.run_world(tmp_path / "world", "mp=2", "families_and_resumes", payload)
    got = results[0]
    for name, f in families.items():
        want = mw.family_epoch(f, ds, single)
        assert got["families"][name]["sharded"], f"{name}: nothing sharded at mp=2"
        assert got["families"][name]["loss"] == want["loss"], name
        np.testing.assert_array_equal(got["families"][name]["rank_list"], want["rank_list"])
        assert_same(got["families"][name]["params"], want["params"], name)
    whole = mw.resume_run(flags, ds, single, dirs["whole"], 3)
    resumed = mw.resume_run(flags, ds, single, dirs["mesh"], 3)
    assert_same(got["resumes"]["wrote"]["params"], wrote["params"], "2 epochs on the mesh")
    assert_same(got["resumes"]["resumed"]["params"], whole["params"], "single, then the mesh")
    assert got["resumes"]["resumed"]["best"] == whole["best"]
    assert_same(resumed["params"], whole["params"], "the mesh, then single")
    assert resumed["best"] == whole["best"]
    for r in results[1:]:
        for name in families:
            assert r["families"][name]["loss"] == got["families"][name]["loss"], name
