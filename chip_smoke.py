#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``chaorec_tpu_torch``) on one CUDA card.

Drives the port's two paths once, as a user would, with CF_Diff at its
published width (1034 tokens, d_model 16, 4 heads, 2 cross-attention
rounds; the first combo of Model_YAML/CF_Diff.yaml) on a dataset of baby's
size (12351 users x 4794 items), random weights from ``--seed``: the
serving path (export, serve) and the training path (the CLI's grid run:
epochs of Adam steps, evaluation, early stopping, export of the best
epoch). Phases, each printing its own lines:

1. device   the card's name and power limit (nvidia-smi); fails without CUDA
2. build    compile csrc/fused_mha.cu and csrc/fused_mha_bwd.cu with nvcc
            (sm_90a), both at once, and print ptxas's registers and spills
3. kernel   fused_mha at keep 1.0 and 0.5 against mha_reference under the
            same mask; its backward against autograd of mha_reference;
            both timed against the plain version at the export chunk and
            the training batch shapes, and held to it at both (the
            backward at the training batch, slice by slice)
4. slice    export_artifact over every user (the kernel launch counts are
            reset just before and read just after), then the kernel path's
            scores against the plain path's and against the CPU
5. serve    Recommender + serve_http on 127.0.0.1: answers equal the
            artifact and hold no seen item; an embeddings artifact answers
            alike on the card and on the CPU
6. profile  device time by kernel over one export chunk
7. train    cli.run: 2 epochs at batch 1024 with --export_artifact (counts
            reset just before, read just after); per-epoch times and peak
            memory; the exported best epoch goes through phase 5's checks
8. step     one training step at 8 users, kernel path against plain path
            with every dropout mask equal: loss and every gradient
9. profile  device time by kernel over one training step at 1024 users

Then one JSON line about the kernels, and last the result line
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
import logging
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# Model_YAML/CF_Diff.yaml, first grid combo (``dims`` is unused by CAM_AE).
MODEL_CONFIG = dict(Model="CF_Diff", learning_rate=0.001, noise_scale=0.1,
                    noise_min=0.0005, noise_max=0.005, steps=10)
DATASET = "baby"
KERNELS = ("fused_mha", "fused_mha_bwd")
# fp32 attention over 1034 keys with inputs ~N(0, 1): the kernel's online
# softmax sums in another order than the reference's; 1e-5 is expected,
# with or without dropout (both draw the same Philox mask).
ATTN_TOL = 1e-5
# Backward: max abs error over the largest entry of each plain gradient.
# dK and dV sum up to 1034 query rows in fp32, in another order.
BWD_REL_TOL = 1e-5
# CF_Diff scores after 10 diffusion steps, kernel path against plain path
# (both on the card) and against the CPU plain path: absolute bound.
SCORE_TOL = 1e-4
TOPK_AGREE_MIN = 0.98  # mean top-k overlap of two rankings of the same scores
# One training step, kernel path against plain path with equal masks: the
# loss to rtol 1e-5; each gradient entry to rtol 1e-4 of its tensor's
# largest entry plus 1e-6 of the whole gradient's largest (the SNR weights
# make entries span ~10 decades; as tests/test_torch_cf_diff.py holds it).
STEP_LOSS_RTOL, STEP_RTOL, STEP_ATOL = 1e-5, 1e-4, 1e-6
ATTN_SHAPES = ((64, 4, 1034, 1034, 4), (2, 3, 300, 130, 4))
BWD_SHAPES = ((16, 4, 1034, 1034, 4), (2, 3, 300, 130, 4))
TRAIN_EPOCHS, TRAIN_BATCH = 2, 1024


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


def plain_in_slices(q, k, v, seed=None, keep=1.0, rows: int = 64):
    """mha_reference over the batch in slices (each with its groups' mask):
    the whole (4096, 4, 1034, 1034) score tensor of an export chunk would
    take 70 GB."""
    from chaorec_tpu_torch.ops.fused_attn import mha_reference

    h = q.shape[1]
    return torch.cat([mha_reference(q[s:s + rows], k[s:s + rows], v[s:s + rows], seed,
                                    keep, first_group=s * h)
                      for s in range(0, q.shape[0], rows)])


def plain_bwd_in_slices(q, k, v, dout, seed, keep, got, rows: int = 32):
    """Autograd's backward through mha_reference, slice by slice, held
    against the kernel's gradients ``got`` (dq, dk, dv) row for row.
    Returns (device ms of the backward alone, each slice's forward being
    outside the timed region; per gradient the max abs error; per gradient
    the largest plain entry)."""
    from chaorec_tpu_torch.ops.fused_attn import mha_reference

    h, total = q.shape[1], 0.0
    errs, scale = [0.0] * 3, [0.0] * 3
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for s in range(0, q.shape[0], rows):
        leaves = [t[s:s + rows].detach().requires_grad_() for t in (q, k, v)]
        out = mha_reference(*leaves, seed, keep, first_group=s * h)
        start.record()
        want = torch.autograd.grad(out, leaves, dout[s:s + rows])
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
        for i, (a, w) in enumerate(zip(got, want)):
            errs[i] = max(errs[i], (a[s:s + rows] - w).abs().max().item())
            scale[i] = max(scale[i], w.abs().max().item())
    return total, errs, scale


@contextlib.contextmanager
def plain_attention():
    """CF_Diff's attention through mha_reference, with the kernel's seed and
    keep_prob, so the plain path draws the kernel's dropout mask. For the
    comparisons only."""
    from chaorec_tpu_torch.models import cf_diff
    from chaorec_tpu_torch.ops.fused_attn import mha_reference

    kernel = cf_diff.fused_mha
    cf_diff.fused_mha = mha_reference
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


class EpochProbe(logging.Filter):
    """Reads the trainer's own per-epoch log lines (the loss, then
    ``epoch_time_s``) as they are logged, and the device's peak memory
    since the previous epoch. A filter on the root logger, so it outlives
    the CLI's replacement of the handlers."""

    def __init__(self):
        super().__init__()
        self.epochs = []
        self._loss = None

    def filter(self, record):
        msg = record.getMessage()
        if m := re.match(r"Epoch (\d+), Loss: (\S+)$", msg):
            self._loss = float(m.group(2))
        elif m := re.match(r"epoch_time_s: total (\S+) \(train-dispatch (\S+) \| "
                           r"eval\+sync (\S+)\)", msg):
            self.epochs.append(dict(loss=self._loss, wall_s=float(m.group(1)),
                                    train_s=float(m.group(2)), eval_s=float(m.group(3)),
                                    peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30))
            torch.cuda.reset_peak_memory_stats()
        return True


def top_overlap(a: torch.Tensor, b: torch.Tensor, k: int) -> float:
    ia = torch.topk(a, k, dim=1).indices.cpu().numpy()
    ib = torch.topk(b, k, dim=1).indices.cpu().numpy()
    return float(np.mean([len(set(x) & set(y)) / k for x, y in zip(ia, ib)]))


def get_json(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.load(r)


def device_profile(phase: str, what: str, fn, out_path: str) -> None:
    """Wall time of ``fn`` unprofiled, then device time by kernel and the
    idle share over one profiled call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # device kernels only: an op's own row would count its kernels twice
    rows = sorted(((e.self_device_time_total, e.key, e.count) for e in events
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    check(busy_ms > 0, "the profiler saw no device kernel")
    say(phase, f"{what}: wall {wall_ms:.1f} ms unprofiled, device kernels {busy_ms:.1f} ms, "
        f"idle share {100 * max(0.0, 1 - busy_ms / wall_ms):.1f}%")
    for us, key, count in rows[:10]:
        say(phase, f"{us / 1e3:9.2f} ms  {100 * us / 1e3 / busy_ms:5.1f}%  "
            f"x{count:<4d} {key[:90]}")
    with open(out_path, "w") as fh:
        fh.write(events.table(sort_by="self_device_time_total", row_limit=40))


def check_artifact(path: str, ds, snapshot: str):
    """The ranklists artifact's shape, order and masking; returns its ids
    and each user's history as global ids."""
    with np.load(path) as z:
        rank_ids, rank_scores = z["rank_ids"], z["rank_scores"]
        check(str(z["snapshot"]) == snapshot, f"snapshot {z['snapshot']} != {snapshot}")
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
    return rank_ids, hist_global


def check_serving(phase: str, path: str, ds, device, rank_ids, hist_global) -> None:
    """HTTP answers of a ranklists artifact equal the artifact, hold no seen
    item, and 404 on an unknown path; request latency."""
    from chaorec_tpu_torch.serve import Recommender, serve_http

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
        say(phase, f"http on 127.0.0.1:{port} ({health['snapshot']} weights): healthz ok, "
            "2 recommend requests equal the artifact and hold no seen item, 404 on unknown "
            f"path; /recommend 3 users k=10 latency p50 {np.median(lat):.3f} ms, "
            f"p99 {np.percentile(lat, 99):.3f} ms over {len(lat)} requests")
    finally:
        srv.shutdown()
        srv.server_close()


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
    from chaorec_tpu_torch import cli, kernels
    from chaorec_tpu_torch.config import Config
    from chaorec_tpu_torch.data.loading import data_load
    from chaorec_tpu_torch.models import build_model
    from chaorec_tpu_torch.models.base import Batch
    from chaorec_tpu_torch.models.cf_diff import CF_Diff
    from chaorec_tpu_torch.ops.fused_attn import (dropout_mask, fused_mha, fused_mha_bwd,
                                                  mha_reference, mha_reference_grads)
    from chaorec_tpu_torch.serve import Recommender, export_artifact

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
    os.makedirs(args.out_dir, exist_ok=True)

    # 2. build: one nvcc per source, all at once --------------------------
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        builds = list(pool.map(kernels.build, KERNELS))
    for built in builds:
        say("build", f"{built.name}: {built.seconds:.2f} s -> {built.path.name}")
        for line in built.log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                say("build", line.strip())

    # 3. kernels vs plain -----------------------------------------------
    gen = torch.Generator(device=device).manual_seed(args.seed)

    def qkv(b, h, lq, lk, dh):
        return [torch.randn(shape, generator=gen, device=device)
                for shape in ((b, h, lq, dh), (b, h, lk, dh), (b, h, lk, dh))]

    seed_t = torch.tensor([args.seed * 7919 + 17], device=device)
    fwd_err = {1.0: 0.0, 0.5: 0.0}  # max abs error of the forward by keep_prob
    bwd_err = 0.0
    for keep in (1.0, 0.5):
        for shape in ATTN_SHAPES:
            q, k, v = qkv(*shape)
            got = fused_mha(q, k, v, seed_t, keep)
            torch.cuda.synchronize()
            err = (got - mha_reference(q, k, v, seed_t, keep)).abs().max().item()
            fwd_err[keep] = max(fwd_err[keep], err)
            check(err <= ATTN_TOL, f"fused_mha {shape} keep {keep}: max abs err {err} > {ATTN_TOL}")
            ms = cuda_ms(lambda: fused_mha(q, k, v, seed_t, keep))
            plain_ms = cuda_ms(lambda: mha_reference(q, k, v, seed_t, keep), 3)
            say("kernel", f"fwd {shape} keep {keep}: max_abs_err {err:.3e} (bound {ATTN_TOL:g}), "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    b, h, lq, lk, _ = BWD_SHAPES[0]
    kept = dropout_mask(seed_t, b * h, lq, lk, 0.5, device=device).float().mean().item()
    say("kernel", f"dropout keep 0.5: kept share {kept:.6f} of {b * h * lq * lk} weights "
        f"(4 sigma = {4 * math.sqrt(0.25 / (b * h * lq * lk)):.1e})")
    check(abs(kept - 0.5) <= 4 * math.sqrt(0.25 / (b * h * lq * lk)), "kept share is off")
    for keep in (1.0, 0.5):
        for shape in BWD_SHAPES:
            q, k, v = (t.requires_grad_() for t in qkv(*shape))
            dout = torch.randn(q.shape, generator=gen, device=device)
            before = fused_mha_bwd.launches
            got = torch.autograd.grad(fused_mha(q, k, v, seed_t, keep), (q, k, v), dout)
            torch.cuda.synchronize()
            check(fused_mha_bwd.launches == before + 1, "the backward kernel did not run")
            want = mha_reference_grads(q, k, v, dout, seed_t, keep)
            errs = [((a - w).abs().max() / w.abs().max()).item() for a, w in zip(got, want)]
            bwd_err = max(bwd_err, *[(a - w).abs().max().item() for a, w in zip(got, want)])
            say("kernel", f"bwd {shape} keep {keep}: dq, dk, dv max abs err / max |plain| "
                f"{errs[0]:.2e}, {errs[1]:.2e}, {errs[2]:.2e} (bound {BWD_REL_TOL:g})")
            check(max(errs) <= BWD_REL_TOL, f"fused_mha_bwd {shape} keep {keep} disagrees")
    del q, k, v, got, want, dout

    chunk = Config().eval_user_chunk
    q, k, v = qkv(chunk, 4, 1034, 1034, 4)
    got = fused_mha(q, k, v, 0)
    torch.cuda.synchronize()
    err = (got - plain_in_slices(q, k, v)).abs().max().item()
    fwd_err[1.0] = max(fwd_err[1.0], err)
    check(err <= ATTN_TOL, f"fused_mha export chunk: max abs err {err} > {ATTN_TOL}")
    chunk_ms = cuda_ms(lambda: fused_mha(q, k, v, 0), 5)
    chunk_plain_ms = cuda_ms(lambda: plain_in_slices(q, k, v), 2)
    say("kernel", f"export chunk ({chunk}, 4, 1034, 1034, 4) keep 1.0: max_abs_err {err:.3e}, "
        f"kernel {chunk_ms:.3f} ms, plain in 64-row slices {chunk_plain_ms:.3f} ms")
    del q, k, v, got

    # the training batch: forward and backward, keep 0.5
    q, k, v = (t.requires_grad_() for t in qkv(TRAIN_BATCH, 4, 1034, 1034, 4))
    dout = torch.randn(q.shape, generator=gen, device=device)
    with torch.no_grad():
        err = (fused_mha(q, k, v, seed_t, 0.5) - plain_in_slices(q, k, v, seed_t, 0.5)).abs().max().item()
    fwd_err[0.5] = max(fwd_err[0.5], err)
    check(err <= ATTN_TOL, f"fused_mha training batch: max abs err {err} > {ATTN_TOL}")
    with torch.no_grad():
        train_fwd_ms = cuda_ms(lambda: fused_mha(q, k, v, seed_t, 0.5), 5)
        train_fwd_plain_ms = cuda_ms(lambda: plain_in_slices(q, k, v, seed_t, 0.5), 2)
    out = fused_mha(q, k, v, seed_t, 0.5)
    grads = torch.autograd.grad(out, (q, k, v), dout, retain_graph=True)
    train_bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), dout, retain_graph=True), 5)
    train_bwd_plain_ms, errs, scale = plain_bwd_in_slices(q, k, v, dout, seed_t, 0.5, grads)
    rel = [e / m for e, m in zip(errs, scale)]
    bwd_err = max(bwd_err, *errs)
    say("kernel", f"training batch ({TRAIN_BATCH}, 4, 1034, 1034, 4) keep 0.5: fwd max_abs_err "
        f"{err:.3e}; bwd dq, dk, dv max abs err / max |plain| {rel[0]:.2e}, {rel[1]:.2e}, "
        f"{rel[2]:.2e} (bound {BWD_REL_TOL:g}); fwd kernel {train_fwd_ms:.3f} ms, plain in "
        f"64-row slices {train_fwd_plain_ms:.3f} ms; bwd kernel {train_bwd_ms:.3f} ms, plain "
        f"autograd in 32-row slices {train_bwd_plain_ms:.3f} ms")
    check(max(rel) <= BWD_REL_TOL, "fused_mha_bwd disagrees at the training batch")
    del q, k, v, dout, out, grads
    torch.cuda.empty_cache()

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
    n_chunks = math.ceil(ds.num_user / cfg.eval_user_chunk)
    export_launches = n_chunks * model.steps * model.cam_layers

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cf_diff.npz")
        torch.cuda.reset_peak_memory_stats()
        fused_mha.launches = fused_mha_bwd.launches = 0
        t0 = time.perf_counter()
        export_artifact(model, params, state, ds, path, eval_user_chunk=cfg.eval_user_chunk,
                        snapshot="final-epoch")
        torch.cuda.synchronize()
        export_s = time.perf_counter() - t0
        export_counts = (fused_mha.launches, fused_mha_bwd.launches)
        say("slice", f"export {ds.num_user} users: {export_s:.3f} s wall, "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"fused_mha launches {export_counts[0]} (expected {n_chunks} chunks x "
            f"{model.steps} steps x {model.cam_layers} rounds = {export_launches}), "
            f"fused_mha_bwd launches {export_counts[1]} (expected 0)")
        check(export_counts == (export_launches, 0) and export_launches > 0,
              f"export launched {export_counts}, expected ({export_launches}, 0)")
        rank_ids, hist_global = check_artifact(path, ds, "final-epoch")
        say("slice", f"artifact: rank_ids {rank_ids.shape}, finite, descending, no seen item")

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
        check_serving("serve", path, ds, device, rank_ids, hist_global)

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
        del tables, on_card, on_cpu

        # 6. profile: where one export chunk's device time goes ------------
        chunk_ids = torch.arange(cfg.eval_user_chunk)
        device_profile("profile", f"one export chunk of {cfg.eval_user_chunk} users "
                       f"(score_users, {model.steps} steps)",
                       lambda: model.score_users(params, chunk_ids),
                       os.path.join(args.out_dir, "chip_smoke_profile.txt"))
        del params, state
        torch.cuda.empty_cache()

        # 7. train: the CLI's grid run, 2 epochs, export of the best epoch --
        trained = os.path.join(tmp, "cf_diff_trained.npz")
        train_cfg = Config(data_path=DATASET, seed=args.seed, num_epoch=TRAIN_EPOCHS,
                           batch_size=TRAIN_BATCH, log_dir=args.out_dir,
                           export_artifact=trained, **MODEL_CONFIG)
        grid = {key: [MODEL_CONFIG[key]] for key in MODEL_CONFIG if key != "Model"}
        grid["hyper_parameters"] = list(grid)
        probe = EpochProbe()
        logging.getLogger().addFilter(probe)
        torch.cuda.reset_peak_memory_stats()
        fused_mha.launches = fused_mha_bwd.launches = 0
        t0 = time.perf_counter()
        try:
            best = cli.run(train_cfg, grid, ds, device)
            torch.cuda.synchronize()
        finally:
            logging.getLogger().removeFilter(probe)
        train_run_s = time.perf_counter() - t0
        train_launches = (fused_mha.launches, fused_mha_bwd.launches)
        n_batches = math.ceil(ds.num_user / TRAIN_BATCH)
        rounds = model.cam_layers
        expected = (TRAIN_EPOCHS * (n_batches * rounds + export_launches) + export_launches,
                    TRAIN_EPOCHS * n_batches * rounds)
        for e, ep in enumerate(probe.epochs):
            say("train", f"epoch {e + 1}: loss {ep['loss']:.5f}, wall {ep['wall_s']:.3f} s "
                f"(training {ep['train_s']:.3f} s, eval {ep['eval_s']:.3f} s), peak device "
                f"memory {ep['peak_gib']:.2f} GiB")
        say("train", f"cli.run {TRAIN_EPOCHS} epochs x {n_batches} batches of {TRAIN_BATCH} "
            f"+ export: {train_run_s:.3f} s wall; launches fused_mha {train_launches[0]}, "
            f"fused_mha_bwd {train_launches[1]} (expected {expected[0]} = {TRAIN_EPOCHS} x "
            f"({n_batches} batches x {rounds} rounds + {export_launches} eval) + "
            f"{export_launches} export, and {expected[1]} = {TRAIN_EPOCHS} x {n_batches} x "
            f"{rounds})")
        check(train_launches == expected, f"training launched {train_launches}, expected {expected}")
        check(len(probe.epochs) == TRAIN_EPOCHS, f"{len(probe.epochs)} epochs logged")
        check(all(math.isfinite(ep["loss"]) for ep in probe.epochs), "non-finite epoch loss")
        check(sorted(best) == [5, 10, 20] and all(
            math.isfinite(v) for m in best.values() for v in m.values()), f"best metrics {best}")
        say("train", "best test metrics: " + "; ".join(
            f"@{k} recall {m['recall']:.5f} ndcg {m['ndcg']:.5f}" for k, m in best.items()))
        rank_ids, hist_global = check_artifact(trained, ds, "best-epoch")
        say("train", f"exported best epoch: rank_ids {rank_ids.shape}, finite, descending, "
            "no seen item")
        check_serving("train", trained, ds, device, rank_ids, hist_global)
    torch.cuda.empty_cache()

    # 8. step parity: kernel path against plain path, equal masks -----------
    params = model.init_params(torch.Generator(device=device).manual_seed(args.seed + 1))
    batch = Batch(torch.arange(8, device=device), torch.ones(8, device=device))

    def one_step():
        leaves = {n: t.detach().clone().requires_grad_() for n, t in params.items()}
        loss, _ = model.loss_stateful(leaves, model.init_state(device), batch,
                                      torch.Generator(device=device).manual_seed(args.seed))
        loss.backward()
        return loss.item(), {n: t.grad for n, t in leaves.items()}

    before = (fused_mha.launches, fused_mha_bwd.launches)
    kernel_loss, kernel_grads = one_step()
    check((fused_mha.launches, fused_mha_bwd.launches) == (before[0] + rounds, before[1] + rounds),
          "the kernel step did not launch both kernels once per round")
    with plain_attention():
        plain_loss, plain_grads = one_step()
    scale = max(g.abs().max().item() for g in plain_grads.values())
    worst = max(((kernel_grads[n] - g).abs().max().item()
                 / (STEP_RTOL * g.abs().max().item() + STEP_ATOL * scale), n)
                for n, g in plain_grads.items())
    loss_rel = abs(kernel_loss - plain_loss) / abs(plain_loss)
    say("step", f"8 users, one training step, kernel vs plain path with equal masks: loss "
        f"{kernel_loss:.6f} vs {plain_loss:.6f} (rel {loss_rel:.2e}, bound {STEP_LOSS_RTOL:g}); "
        f"worst gradient {worst[1]} at {worst[0]:.3f} of its bound (rtol {STEP_RTOL:g} of "
        f"the tensor's max + {STEP_ATOL:g} of the gradient's max {scale:.3e})")
    check(loss_rel <= STEP_LOSS_RTOL and worst[0] <= 1.0, "training step disagrees")

    # 9. profile: where one training step's device time goes ---------------
    leaves = {n: t.detach().clone().requires_grad_() for n, t in params.items()}
    opt = torch.optim.Adam(leaves.values(), lr=MODEL_CONFIG["learning_rate"])
    step_gen = torch.Generator(device=device).manual_seed(args.seed)
    full = Batch(torch.randperm(ds.num_user, device=device, generator=step_gen)[:TRAIN_BATCH],
                 torch.ones(TRAIN_BATCH, device=device))
    step_state = model.init_state(device)

    def train_step():
        opt.zero_grad(set_to_none=True)
        loss, _ = model.loss_stateful(leaves, step_state, full, step_gen)
        loss.backward()
        opt.step()

    device_profile("profile", f"one training step of {TRAIN_BATCH} users (forward, backward, "
                   "Adam)", train_step, os.path.join(args.out_dir, "chip_smoke_train_profile.txt"))

    # result -----------------------------------------------------------
    # One entry per path and shape; each path's launches are its own run's
    # (the export of phase 4, the CLI run of phase 7).
    fwd = dict(route="cuda", source="chaorec_tpu_torch/csrc/fused_mha.cu",
               replaces="chaorec_tpu/ops/pallas_attn.py:65")
    print(json.dumps({"kernels": [
        {"name": "fused_mha@export", **fwd, "shape": [chunk, 4, 1034, 1034, 4],
         "keep_prob": 1.0, "launches": export_counts[0], "max_abs_err": fwd_err[1.0],
         "ms": chunk_ms, "plain_ms": chunk_plain_ms},
        {"name": "fused_mha@train", **fwd, "shape": [TRAIN_BATCH, 4, 1034, 1034, 4],
         "keep_prob": 0.5, "launches": train_launches[0], "max_abs_err": fwd_err[0.5],
         "ms": train_fwd_ms, "plain_ms": train_fwd_plain_ms,
         "note": "launches: the CLI run's training forwards at keep 0.5 and its eval "
                 "and export forwards at keep 1.0"},
        {"name": "fused_mha_bwd@train", "route": "cuda",
         "source": "chaorec_tpu_torch/csrc/fused_mha_bwd.cu",
         "replaces": "chaorec_tpu/ops/pallas_attn.py:82",
         "shape": [TRAIN_BATCH, 4, 1034, 1034, 4], "keep_prob": 0.5,
         "launches": train_launches[1], "max_abs_err": bwd_err, "ms": train_bwd_ms,
         "plain_ms": train_bwd_plain_ms,
         "note": "one launch is one backward call: the dq kernel, then the dk/dv kernel"},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
