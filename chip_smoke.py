#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``chaorec_tpu_torch``) on one CUDA card.

Drives the port's serving path once, as a user would: CF_Diff at its
published width (1034 tokens, d_model 16, 4 heads, 2 cross-attention
rounds; the first combo of Model_YAML/CF_Diff.yaml) on a dataset of baby's
size (12351 users x 4794 items), random weights from ``--seed``. Phases,
each printing its own lines:

1. device   the card's name and power limit (nvidia-smi); fails without CUDA
2. build    compile csrc/fused_mha.cu with nvcc (sm_90a)
3. kernel   fused_mha against mha_reference on the card, and both timed
4. slice    export_artifact over every user (the count of kernel launches
            is reset just before and read just after), then the kernel
            path's scores against the plain path's and against the CPU
5. serve    Recommender + serve_http on 127.0.0.1: answers equal the
            artifact and hold no seen item; an embeddings artifact answers
            alike on the card and on the CPU
6. profile  device time by kernel over one export chunk

Then one JSON line about each kernel, and last the result line
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero without the result line.

    python3 chip_smoke.py [--seed 0] [--data_root DIR] [--out_dir log]

With ``--data_root`` pointing at a directory holding ``baby/train.npy``
etc., the real dataset is used instead of the synthetic one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

import numpy as np
import torch

# Model_YAML/CF_Diff.yaml, first grid combo (``dims`` is unused by CAM_AE).
MODEL_CONFIG = dict(Model="CF_Diff", learning_rate=0.001, noise_scale=0.1,
                    noise_min=0.0005, noise_max=0.005, steps=10)
DATASET = "baby"
# fp32 attention over 1034 keys with inputs ~N(0, 1): the kernel's online
# softmax sums in another order than the reference's; 1e-5 is expected.
ATTN_TOL = 1e-5
# CF_Diff scores after 10 diffusion steps, kernel path against plain path
# (both on the card) and against the CPU plain path: absolute bound.
SCORE_TOL = 1e-4
TOPK_AGREE_MIN = 0.98  # mean top-k overlap of two rankings of the same scores
ATTN_SHAPES = ((64, 4, 1034, 1034, 4), (2, 3, 300, 130, 4))


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def plain_in_slices(q, k, v, rows: int = 64):
    """mha_reference over the batch in slices: the whole (4096, 4, 1034,
    1034) score tensor of an export chunk would take 70 GB."""
    from chaorec_tpu_torch.ops.fused_attn import mha_reference

    return torch.cat([mha_reference(q[s:s + rows], k[s:s + rows], v[s:s + rows])
                      for s in range(0, q.shape[0], rows)])


@contextlib.contextmanager
def plain_attention():
    """CF_Diff's attention through mha_reference, for the comparison only."""
    from chaorec_tpu_torch.models import cf_diff
    from chaorec_tpu_torch.ops.fused_attn import mha_reference

    kernel = cf_diff.fused_mha
    cf_diff.fused_mha = lambda q, k, v, seed, keep_prob=1.0: mha_reference(q, k, v)
    try:
        yield
    finally:
        cf_diff.fused_mha = kernel


def synthetic_dataset(seed: int):
    """Baby's shape with ~9 train items per user, drawn with a popularity
    skew (item weight ~ 1 / (rank + 10)), one val and one test item each."""
    from chaorec_tpu_torch.data.loading import DATASET_STATS, RecDataset, _pad_lists

    num_user, num_item = DATASET_STATS[DATASET]
    rng = np.random.default_rng(seed)
    w = 1.0 / (np.arange(num_item) + 10.0)
    w = w[rng.permutation(num_item)]
    w /= w.sum()
    lens = rng.integers(5, 14, num_user)
    hist = [rng.choice(num_item, size=int(n), replace=False, p=w) for n in lens]
    held = []
    for h in hist:
        seen = set(h.tolist())
        picks = []
        while len(picks) < 2:
            i = int(rng.integers(num_item))
            if i not in seen and i not in picks:
                picks.append(i)
        held.append(picks)
    edges = np.array([(u, i) for u, h in enumerate(hist) for i in h], np.int32)
    users = np.arange(num_user, dtype=np.int32)
    return RecDataset(
        name=DATASET, num_user=num_user, num_item=num_item, train_edges=edges,
        history=_pad_lists([h.tolist() for h in hist], fill=num_item, sort=True),
        val_users=users, val_pos=_pad_lists([[p[0]] for p in held], fill=-1),
        test_users=users, test_pos=_pad_lists([[p[1]] for p in held], fill=-1),
    )


class RandomTables:
    """An embeddings-kind model whose params are its (user, item) tables."""

    name, rank_mode = "BPR", "embeddings"

    def embeddings(self, params):
        return params


def top_overlap(a: torch.Tensor, b: torch.Tensor, k: int) -> float:
    ia = torch.topk(a, k, dim=1).indices.cpu().numpy()
    ib = torch.topk(b, k, dim=1).indices.cpu().numpy()
    return float(np.mean([len(set(x) & set(y)) / k for x, y in zip(ia, ib)]))


def get_json(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.load(r)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data_root", default="")
    ap.add_argument("--out_dir", default="log")
    args = ap.parse_args(argv)

    # 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    from chaorec_tpu_torch import kernels
    from chaorec_tpu_torch.config import Config
    from chaorec_tpu_torch.data.loading import data_load
    from chaorec_tpu_torch.models import build_model
    from chaorec_tpu_torch.models.cf_diff import CF_Diff
    from chaorec_tpu_torch.ops.fused_attn import fused_mha, mha_reference
    from chaorec_tpu_torch.serve import Recommender, export_artifact, serve_http

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say("device", smi)
    say("device", f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    # Full fp32 products, as the CPU tests that hold the port to JAX use.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device", "tf32 off for matmul and cudnn")

    # 2. build ----------------------------------------------------------
    built = kernels.build("fused_mha")
    say("build", f"fused_mha: {built.seconds:.2f} s -> {built.path.name}")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            say("build", line.strip())

    # 3. kernel vs plain ------------------------------------------------
    gen = torch.Generator(device=device).manual_seed(args.seed)

    def qkv(b, h, lq, lk, dh):
        return [torch.randn(shape, generator=gen, device=device)
                for shape in ((b, h, lq, dh), (b, h, lk, dh), (b, h, lk, dh))]

    max_err = 0.0
    for shape in ATTN_SHAPES:
        q, k, v = qkv(*shape)
        got = fused_mha(q, k, v, 0)
        torch.cuda.synchronize()
        err = (got - mha_reference(q, k, v)).abs().max().item()
        max_err = max(max_err, err)
        check(err <= ATTN_TOL, f"fused_mha {shape}: max abs err {err} > {ATTN_TOL}")
        ms, plain_ms = cuda_ms(lambda: fused_mha(q, k, v, 0)), cuda_ms(lambda: mha_reference(q, k, v))
        say("kernel", f"{shape}: max_abs_err {err:.3e} (bound {ATTN_TOL:g}), "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    chunk = Config().eval_user_chunk
    q, k, v = qkv(chunk, 4, 1034, 1034, 4)
    got = fused_mha(q, k, v, 0)
    torch.cuda.synchronize()
    err = (got - plain_in_slices(q, k, v)).abs().max().item()
    max_err = max(max_err, err)
    check(err <= ATTN_TOL, f"fused_mha export chunk: max abs err {err} > {ATTN_TOL}")
    chunk_ms = cuda_ms(lambda: fused_mha(q, k, v, 0), 5)
    chunk_plain_ms = cuda_ms(lambda: plain_in_slices(q, k, v), 2)
    say("kernel", f"export chunk ({chunk}, 4, 1034, 1034, 4): max_abs_err {err:.3e}, "
        f"kernel {chunk_ms:.3f} ms, plain in 64-row slices {chunk_plain_ms:.3f} ms")
    del q, k, v, got

    # 4. slice: export over every user ----------------------------------
    t0 = time.perf_counter()
    ds = data_load(DATASET, args.data_root) if args.data_root else synthetic_dataset(args.seed)
    cfg = Config(data_path=DATASET, seed=args.seed, **MODEL_CONFIG)
    model = build_model(cfg, ds, device)
    params = model.init_params(torch.Generator(device=device).manual_seed(args.seed))
    state = model.init_state(device)
    torch.cuda.synchronize()
    say("slice", f"{'data_load' if args.data_root else 'synthetic'} {DATASET} "
        f"({ds.num_user}, {ds.num_item}), {ds.num_edges} train edges; model built "
        f"in {time.perf_counter() - t0:.2f} s; {model.seq_len} tokens, "
        f"d_model {model.d_model}, {model.num_heads} heads, {model.cam_layers} rounds, "
        f"{model.steps} steps")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cf_diff.npz")
        torch.cuda.reset_peak_memory_stats()
        fused_mha.launches = 0
        t0 = time.perf_counter()
        export_artifact(model, params, state, ds, path, eval_user_chunk=cfg.eval_user_chunk)
        torch.cuda.synchronize()
        export_s = time.perf_counter() - t0
        launches = fused_mha.launches
        n_chunks = math.ceil(ds.num_user / cfg.eval_user_chunk)
        expected = n_chunks * model.steps * model.cam_layers
        say("slice", f"export {ds.num_user} users: {export_s:.3f} s wall, "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"fused_mha launches {launches} (expected {n_chunks} chunks x "
            f"{model.steps} steps x {model.cam_layers} rounds = {expected})")
        check(launches == expected and launches > 0,
              f"fused_mha launched {launches} times, expected {expected}")

        with np.load(path) as z:
            rank_ids, rank_scores = z["rank_ids"], z["rank_scores"]
        check(rank_ids.shape == (ds.num_user, 200) and rank_scores.shape == rank_ids.shape,
              f"rank_ids shape {rank_ids.shape}")
        check(bool(np.isfinite(rank_scores).all()), "non-finite ranklist scores")
        check(bool((np.diff(rank_scores, axis=1) <= 0).all()), "ranklists not descending")
        check(bool(((rank_ids >= ds.num_user) & (rank_ids < ds.num_user + ds.num_item)).all()),
              "ranklist ids out of range")
        hist_global = np.where(ds.history.values < ds.num_item,
                               ds.history.values + ds.num_user, -1)
        seen_hits = sum(np.isin(rank_ids[u], hist_global[u]).sum() for u in range(ds.num_user))
        check(seen_hits == 0, f"{seen_hits} seen items in the ranklists")
        say("slice", f"artifact: rank_ids {rank_ids.shape}, finite, descending, "
            "no seen item")

        ids = torch.arange(64)
        kernel_scores = model.score_users(params, ids)
        with plain_attention():
            plain_scores = model.score_users(params, ids)
        diff = (kernel_scores - plain_scores).abs().max().item()
        overlap = top_overlap(kernel_scores, plain_scores, 50)
        say("slice", f"64 users, kernel path vs plain path on the card: max abs diff "
            f"{diff:.3e} (bound {SCORE_TOL:g}), top-50 agreement {overlap:.4f} "
            f"(bound {TOPK_AGREE_MIN})")
        check(diff <= SCORE_TOL and overlap >= TOPK_AGREE_MIN, "kernel path disagrees with plain path")

        cpu_model = CF_Diff(model.num_user, model.num_item, model.x.cpu(), cfg.noise_scale,
                            cfg.noise_min, cfg.noise_max, cfg.steps)
        cpu_params = {n: t.cpu() for n, t in params.items()}
        cpu_scores = cpu_model.score_users(cpu_params, ids[:4])
        diff_cpu = (kernel_scores[:4].cpu() - cpu_scores).abs().max().item()
        say("slice", f"4 users, card vs CPU plain path: max abs diff {diff_cpu:.3e} "
            f"(bound {SCORE_TOL:g})")
        check(diff_cpu <= SCORE_TOL, "card disagrees with the CPU path")
        del cpu_model, cpu_params

        # 5. serve ------------------------------------------------------
        rec = Recommender.load(path, device)
        srv = serve_http(rec, port=0, host="127.0.0.1")
        port = srv.server_address[1]
        try:
            health = get_json(port, "/healthz")
            check(health["ok"] and health["model"] == "CF_Diff", f"healthz: {health}")
            for users, k in (([0, 5, 17], 10), ([1, 2, 3, 100, 4095, 4096, ds.num_user - 1], 50)):
                resp = get_json(port, f"/recommend?user={','.join(map(str, users))}&k={k}")
                check(len(resp["results"]) == len(users), "wrong number of results")
                for u, res in zip(users, resp["results"]):
                    got_ids = [it["item"] for it in res["items"]]
                    check(res["user"] == u and got_ids == rank_ids[u, :k].tolist(),
                          f"user {u}: answer differs from the artifact")
                    check(not set(got_ids) & set(hist_global[u].tolist()),
                          f"user {u}: a seen item was recommended")
            try:
                get_json(port, "/nowhere")
                check(False, "unknown path answered")
            except urllib.error.HTTPError as e:
                check(e.code == 404, f"unknown path gave {e.code}")
            lat = []
            for _ in range(50):
                t0 = time.perf_counter()
                get_json(port, "/recommend?user=0,5,17&k=10")
                lat.append((time.perf_counter() - t0) * 1e3)
            say("serve", f"http on 127.0.0.1:{port}: healthz ok, 2 recommend requests "
                "equal the artifact and hold no seen item, 404 on unknown path; "
                f"/recommend 3 users k=10 latency p50 {np.median(lat):.3f} ms, "
                f"p99 {np.percentile(lat, 99):.3f} ms over {len(lat)} requests")
        finally:
            srv.shutdown()
            srv.server_close()

        # The usual serving configuration, an embeddings artifact (random
        # dim-64 tables at this dataset's size): the card against the CPU.
        tables = [torch.randn((n, 64), generator=gen, device=device)
                  for n in (ds.num_user, ds.num_item)]
        emb_path = os.path.join(tmp, "tables.npz")
        export_artifact(RandomTables(), tables, None, ds, emb_path)
        on_card, on_cpu = Recommender.load(emb_path, device), Recommender.load(emb_path, "cpu")
        users = list(range(0, ds.num_user, 48))
        for name, query in (("recommend", lambda r: r.recommend(users, k=10)),
                            ("similar_items", lambda r: r.similar_items(users[:64], k=10)),
                            ("fold_in", lambda r: [r.fold_in([3, 17, 400], k=10)])):
            a, b = query(on_card), query(on_cpu)
            score_err = max(abs(x[1] - y[1]) for ra, rb in zip(a, b) for x, y in zip(ra, rb))
            same = np.mean([len({i for i, _ in ra} & {i for i, _ in rb}) / 10
                            for ra, rb in zip(a, b)])
            say("serve", f"embeddings {name}, {len(a)} queries, card vs CPU: max score "
                f"diff {score_err:.3e} (bound {SCORE_TOL:g}), top-10 agreement {same:.4f}")
            check(score_err <= SCORE_TOL and same >= TOPK_AGREE_MIN, f"embeddings {name} disagrees")
        lat = []
        for _ in range(50):
            t0 = time.perf_counter()
            on_card.recommend([0, 5, 17], k=10)
            lat.append((time.perf_counter() - t0) * 1e3)
        say("serve", f"embeddings recommend 3 users k=10 on the card, in process: "
            f"p50 {np.median(lat):.3f} ms, p99 {np.percentile(lat, 99):.3f} ms")

    # 6. profile: where one export chunk's device time goes ---------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ids = torch.arange(cfg.eval_user_chunk)
    model.score_users(params, ids)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.score_users(params, ids)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.score_users(params, ids)
        torch.cuda.synchronize()
    events = prof.key_averages()
    # device kernels only: an op's own row would count its kernels twice
    rows = sorted(((e.self_device_time_total, e.key, e.count) for e in events
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    check(busy_ms > 0, "the profiler saw no device kernel")
    say("profile", f"one chunk of {cfg.eval_user_chunk} users (score_users, "
        f"{model.steps} steps): wall {wall_ms:.1f} ms unprofiled, device kernels "
        f"{busy_ms:.1f} ms, idle share {100 * max(0.0, 1 - busy_ms / wall_ms):.1f}%")
    for us, key, count in rows[:8]:
        say("profile", f"{us / 1e3:9.2f} ms  {100 * us / 1e3 / busy_ms:5.1f}%  "
            f"x{count:<4d} {key[:90]}")
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "chip_smoke_profile.txt"), "w") as fh:
        fh.write(events.table(sort_by="self_device_time_total", row_limit=40))

    # result -----------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "fused_mha", "route": "cuda",
        "source": "chaorec_tpu_torch/csrc/fused_mha.cu",
        "replaces": "chaorec_tpu/ops/pallas_attn.py:65",
        "launches": launches, "max_abs_err": max_err,
        "ms": chunk_ms, "plain_ms": chunk_plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
