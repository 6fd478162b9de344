#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``chaorec_tpu_torch``) on one CUDA card.

Drives the port's paths once, as a user would, each at its model's
published width with random weights from ``--seed``:

- CF_Diff (1034 tokens, d_model 16, 4 heads, 2 cross-attention rounds; the
  first combo of Model_YAML/CF_Diff.yaml) on a dataset of baby's size
  (12351 users x 4794 items): the serving path (export, serve) and the
  training path (the CLI's grid run: epochs of Adam steps, evaluation,
  early stopping, export of the best epoch);
- FREEDOM (dim 64, 2 layers, 1 modal layer, ii_topk 10, dropout 0.1; the
  one combo of Model_YAML/FREEDOM.yaml) on a dataset of sports' size
  (28940 users x 15207 items, 4096- and 384-wide item features): the
  CLI's grid run with BPR batches of 1024 edges, whose trainable feature
  tables are stepped by the row-sparse Adam kernel, then the export and
  serving of its embeddings;
- SGL (dim 64, 3 layers, lr 0.01, reg 0.1, ssl_alpha 1e-3, ssl_temp 0.1;
  the first combo of Model_YAML/SGL.yaml) and NCL (dim 64, 2 layers, lr
  1e-3, reg 1e-5, ssl_alpha 1e-5, ssl_temp 0.01, 200 k-means prototypes;
  the first combo of Model_YAML/NCL.yaml) on the same sports-sized set:
  the CLI's grid run with BPR batches of 1024 edges, whose full-catalog
  contrastive terms go through the streaming logsumexp kernels (forward,
  dq, dk), then (SGL) the export and serving of its embeddings;
- DGCF (dim 64, 3 layers, 2 factors, 1 routing iteration, lr 0.01, reg
  0.01, corDecay 0.01), DCCF (dim 64, 1 layer, 64 intents, lr 1e-3, reg
  1e-3, ssl_alpha 0.1, ssl_temp 1, cen_reg 1e-3) and MGAT (dim 64, its 256-
  and 100-wide towers, lr 0.1, reg 0.1), the first combo of each
  Model_YAML file, on the same sports-sized set: the CLI's grid run with
  BPR batches of 1024 edges, whose segment sums (and the backward of their
  gathers) go through the prefix-sum kernel, then (DGCF) the export of its
  best epoch, routing scores included, and the serving of its embeddings.

Phases, each printing its own lines:

1. device   the card's name and power limit (nvidia-smi); fails without CUDA
2. build    compile csrc/fused_mha.cu, csrc/fused_mha_bwd.cu,
            csrc/row_adam.cu, csrc/streaming_lse.cu and csrc/prefix_scan.cu
            with nvcc (sm_90a), all at once, and print ptxas's registers
            and spills
3. kernel   fused_mha at keep 1.0 and 0.5 against mha_reference under the
            same mask (also at the serving batch, B = 1, and at 5000
            keys, where the forward walks K and V in tiles; at keep 1.0
            each also timed against scaled_dot_product_attention); its
            backward against autograd of mha_reference (also at B = 1 with
            ragged Lq and Lk, and at 4100 keys, past the 4096 its dq kernel
            stages at once);
            both timed against the plain version at the export chunk and
            the training batch shapes, and held to it at both (the
            backward at the training batch, slice by slice, and run twice
            there for the same bits; its keep-bit scratch's bytes);
            scaled_dot_product_attention timed at the export chunk;
            fused_row_adam (through table_adam_update) against
            row_adam_update at (15207, 4096) and (15207, 384), fp32 and
            bf16 storage, three steps with duplicates, sentinels, tile
            edges, rows 0 and N-1, B 2048 and 1; timed against its plain
            version and against zeros + index_add_ + a fused torch Adam,
            fp32 and bf16;
            streaming_logsumexp's forward, dq and dk kernels against the
            plain version and its autograd at SGL's user and item sides
            (1024 x 28940 and 1024 x 15207, E 64, temperature 0.1), a
            ragged batch (381 x 15207), NCL's prototypes (1024 x 200 at
            temperature 0.01, k without gradient: no dk launch) and a
            small ragged case (7 x 513); ptxas's registers and spills of
            the E = 64 backward kernel (dq and dk); timed at the two SGL
            shapes against the plain version and the library route
            (torch.logsumexp(q @ k.T) and its autograd, two calls)
4. slice    CF_Diff export_artifact over every user (the kernel launch
            counts are reset just before and read just after), then the
            kernel path's scores against the plain path's and the CPU's
5. serve    Recommender + serve_http on 127.0.0.1: answers equal the
            artifact and hold no seen item; an embeddings artifact answers
            alike on the card and on the CPU
6. profile  device time by kernel over one CF_Diff export chunk
7. train    CF_Diff cli.run: 2 epochs at batch 1024 with --export_artifact
            (counts reset just before, read just after); per-epoch times
            and peak memory; the exported best epoch goes through phase 5
8. step     one CF_Diff training step at 8 users, kernel path against plain
            path with every dropout mask equal: loss and every gradient
9. profile  device time by kernel over one CF_Diff training step, and
            that step's peak device memory
10. freedom FREEDOM cli.run: 2 epochs with --export_artifact (counts reset
            just before, read just after: one fused_row_adam launch per
            table per step); per epoch the loss, pre_epoch (pruning and
            row operators), training and eval times and the peak memory;
            the exported embeddings served over HTTP equal their tables'
            top-k and hold no seen item
11. fstep   one FREEDOM training step, kernel path against plain path
            (row_adam_update) on the same batch and negatives: the loss,
            the tables, their moments and the dense params
12. profile device time by kernel over one FREEDOM training step and one
            pre_epoch; the time of the per-epoch products R R^T and R^T R
13. bf16    one FREEDOM epoch with --relaxed_precision bf16 (the tables
            and their moments stored in bf16, through the same kernel)
14. sgl     SGL cli.run on the sports-sized set of phase 10: 2 epochs with
            --export_artifact (counts reset just before, read just after:
            one forward, dq and dk launch per side per step); per epoch the
            loss, training and eval times and the peak memory; the
            exported embeddings served over HTTP
15. sstep   one SGL training step on a float32 R, kernel path against
            plain path on the same batch, negatives and view masks: the
            loss and gradients
16. profile device time by kernel over one SGL training step (bf16 R),
            split into K2, the propagation's GEMMs and fp32 copies, the
            gathers, scatters and bag sums, and the reductions
17. ncl     NCL cli.run: 1 epoch (four full-catalog terms a step, two of
            them over centroids without gradient: no dk launch for those)
18. nstep   one NCL training step on a float32 R, kernel path against
            plain path with equal prototypes: the loss and gradients
19. profile the same split over one NCL training step (bf16 R)
20. k4      prefix_cumsum against prefix_cumsum_reference and a float64
            prefix at the path shapes of phases 21-29 ((159101, 32) and
            (159101, 64) over the train edges; (318202, 256), (318202, 100)
            and (318202, 64) over the doubled edges), bf16 input, the 1-D
            seg_sum's (159101,) and small ragged shapes, each bit-identical
            on a second run (DGCF's shape over 10 runs); the kernel's
            registers and spills (ptxas); timed back to back, as every
            kernel, and as one CUDA graph of calls (the card's time without
            the host's issue time) against the plain version and
            torch.cumsum; seg_sum against zeros + index_add_ (printed)
21. dgcf    DGCF cli.run: 2 epochs with --export_artifact (counts reset
            just before, read just after: 24 prefix_cumsum launches a step,
            12 an eval or export forward); the exported embeddings served
22. gstep   one DGCF step, kernel path against plain path on the same
            batch, negatives and routing scores: loss, gradients, new S
23. profile device time by kernel over one DGCF step: K4, gathers and
            index_add_, GEMMs, reductions; the host's idle share
24-26.      DCCF: cli.run 1 epoch (8 launches a step, 2 an eval), one step
            on a float32 R kernel vs plain, the step profile
27-29.      MGAT: cli.run 1 epoch (18 launches a step, 6 an eval), one step
            kernel vs plain, the step profile and its peak memory
30. determinism  each of the seven models twice from a fresh Trainer on
            one seed at the path's shapes (CF_Diff one epoch, the others
            20 steps), then an evaluation: equal loss bits and equal rank
            lists, one JSON line per model with both runs' seconds

Then one JSON line about the kernels (each with its time, its plain
version's, its bound and, where one PyTorch call computes the same
function, that call's time), and last the result line ``{"ok": true,
"device": {...}}``. Any failed check raises and the script exits non-zero
without the result line.

    python3 chip_smoke.py [--seed 0] [--data_root DIR] [--out_dir log]

With ``--data_root`` pointing at a directory holding ``baby/train.npy`` and
``sports/train.npy`` etc., the real datasets are used instead of the
synthetic ones. TF32 is off for matmuls and convolutions throughout: the
plain versions the kernels are held to sum in full fp32, as the kernels do.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
# Model_YAML/FREEDOM.yaml's one combo is what cli.run reads; the rest of
# the configuration is the Config defaults (dim_E and feature_embed 64,
# batch 1024, graph_compute_dtype bfloat16), as bench.py's FREEDOM leg.
FREEDOM_DATASET, FREEDOM_EPOCHS = "sports", 2
KERNELS = ("fused_mha", "fused_mha_bwd", "row_adam", "streaming_lse", "prefix_scan")
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
# Row-sparse Adam: the JAX package's own tolerances for it
# (tests/test_pallas_row_adam.py), fp32 math in another order (the kernel
# contracts b1 m + (1 - b1) g into one fma; duplicate rows' gradients are
# summed by atomics in any order). bf16 storage: one bf16 ulp of the stored
# value on top of that, since a moment that nearly cancels (b1 m close to
# -(1 - b1) g) is small enough for the fp32 difference to exceed its ulp.
ROW_P_TOL, ROW_V_TOL = dict(rtol=2e-5, atol=2e-7), dict(rtol=2e-5, atol=1e-9)
ROW_ADAM_SHAPES = (("v_feat", (15207, 4096)), ("t_feat", (15207, 384)))
ROW_ADAM_LR = 1e-3  # FREEDOM's learning rate
# The card's published peaks (NVIDIA's H100 SXM data sheet, dense, at 700 W)
PEAK_FP32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 67e12, 989e12, 3.35e12
# The streaming logsumexp (B, N, E, temperature, k needs a gradient): SGL's
# user and item sides at batch 1024 on sports, a ragged batch of 381 rows
# (the real rows of an epoch's last batch, 159,101 edges = 155 x 1024 +
# 381; the trainer pads that batch to 1024 as the JAX package does), NCL's prototype term (200 centroids,
# N below one 512-row TPU tile, no gradient), and a small ragged case. q is
# unit rows over the temperature, k unit rows, as the models give them.
LSE_SHAPES = ((1024, 28940, 64, 0.1, True), (1024, 15207, 64, 0.1, True),
              (381, 15207, 64, 0.1, True), (1024, 200, 64, 0.01, False),
              (7, 513, 64, 0.1, True))
LSE_MAIN = {"user": LSE_SHAPES[0], "item": LSE_SHAPES[1]}
# Forward: rtol/atol 1e-5 against torch.logsumexp of the fp32 product (the
# kernel sums the logits and the exps in another order). dq and dk: max abs
# error within 1e-5 of the largest plain entry (as BWD_REL_TOL), times
# max(1, 0.1 / temperature): an fp32 logit of unit rows over t carries
# rounding of about 1e-7 / t, and p = exp(logit - lse) carries it relatively.
LSE_TOL = dict(rtol=1e-5, atol=1e-5)
LSE_BWD_REL_TOL = 1e-5
SSL_EPOCHS = {"SGL": 2, "NCL": 1}
# full-catalog logsumexp terms per step, and those whose k needs a gradient
SSL_TERMS = {"SGL": (2, 2), "NCL": (4, 2)}
SEG_EPOCHS = {"DGCF": 2, "DCCF": 1, "MGAT": 1}
# One step of a segment-sum model, kernel path against plain path. A
# segment sum is the difference of two fp32 prefixes, whose error is a few
# ulp of the running total, not of the segment (the CAVEAT of
# chaorec_tpu/ops/ell.py:370-381), and DGCF normalizes propagated rows,
# some of them near zero, in its routing update: two correct summation
# orders can part by more than the other models' step bounds. Each output
# (the loss, each gradient, DGCF's new S) is held to the larger of those
# bounds (S, O(1) entries: 1e-5 absolute) and SPREAD_FACTOR times the
# spread between the plain path and a path whose prefixes are summed in
# float64 and rounded once, which measures how far two correct orders of
# this step's sums drift apart.
S_STEP_ATOL, SPREAD_FACTOR = 1e-5, 4.0
# K4 at DGCF's shape is run this many times for the same bits: each run's
# tiles find their look-back windows by the timing of that run.
K4_BIT_RUNS = 10
# The forward is also held and timed at CF_Diff's serving batch (B = 1) and
# at 5000 keys, past the 4096 that csrc/fused_mha.cu stages at once.
ATTN_SHAPES = ((64, 4, 1034, 1034, 4), (2, 3, 300, 130, 4), (1, 4, 1034, 1034, 4),
               (1, 4, 1034, 5000, 4))
# The backward likewise at B = 1 (1 query row a thread in its dq kernel)
# with ragged Lq and Lk, and at 4100 keys.
BWD_SHAPES = ((16, 4, 1034, 1034, 4), (2, 3, 300, 130, 4), (1, 4, 257, 1033, 4),
              (2, 4, 300, 4100, 4))
TRAIN_EPOCHS, TRAIN_BATCH = 2, 1024
# Phase 30: every model twice on one seed, at the path's shapes, for equal
# bits (CF_Diff one epoch, the others this many steps, then an evaluation)
DET_MODELS = ("CF_Diff", "FREEDOM", "SGL", "NCL", "DGCF", "DCCF", "MGAT")
DET_STEPS = 20


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


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls captured in one CUDA
    graph and replayed, after a warm-up on a side stream: the card's time,
    without the host's time to issue each call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_FP32_FLOPS):
    """(ms, "operations" or "bytes"): the least time the card could take,
    the larger of the operations over the peak rate for their type and
    the bytes (each input read once, each output written once) over the
    memory rate."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attn_bound(shape, backward: bool = False):
    """Bound of fp32 attention at (B, H, Lq, Lk, dh): the forward's q.k and
    p.v take 2 dh flops each per score and move q, k, v and out; the
    backward's score recompute, dv, dp, dq and dk take 2 dh each and move
    q, k, v, out, dout, lse, dq, dk and dv. Dropout draws are not counted."""
    b, h, lq, lk, dh = shape
    scores, nq, nk = b * h * lq * lk, b * h * lq * dh, b * h * lk * dh
    if backward:
        return bound_ms(10 * dh * scores, 4 * (3 * nq + 2 * nk + b * h * lq + nq + 2 * nk))
    return bound_ms(4 * dh * scores, 4 * (2 * nq + 2 * nk))


def sdpa_ms(q, k, v):
    """(ms, output) of torch's scaled_dot_product_attention on the same
    inputs, in one call. A yardstick only: the port never calls it."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = sdpa(q, k, v)
    return cuda_ms(lambda: sdpa(q, k, v), 5), out


def tol_share(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float,
              bf16_ulps: int = 0, where: bool = False):
    """Largest |got - want| / (atol + rtol |want| + ``bf16_ulps`` bf16 ulps
    of the larger of the two): at most 1 passes. With ``where``, also the
    flat index of that entry."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    share = ((got - want).abs() / (atol + rtol * want.abs() + bf16_ulps * ulp)).view(-1)
    at = int(share.argmax())
    return (share[at].item(), at) if where else share[at].item()


def row_adam_rows(gen, n: int, b: int, device) -> torch.Tensor:
    """``b`` raw int64 rows of an (n, .) table: rows 0-63 and the last 64
    (so every tile edge at their heights, and rows 0 and n-1), a few of
    them twice, and the rest uniform (duplicates by chance)."""
    if b == 1:
        return torch.tensor([n - 1], device=device)
    ends = torch.cat([torch.arange(64, device=device), torch.arange(n - 64, n, device=device)])
    dups = ends[::16]
    rest = torch.randint(0, n, (b - ends.numel() - dups.numel(),), generator=gen, device=device)
    return torch.cat([ends, dups, rest])[torch.randperm(b, generator=gen, device=device)]


def row_adam_phase(gen, device) -> dict:
    """fused_row_adam (through table_adam_update, as the trainer calls it)
    against row_adam_update, each of three steps from equal tables and
    moments, then its times at the main path's shapes.
    Returns per (table, "float32" or "bfloat16") {max_abs_err, ms,
    plain_ms, library_ms, bound_ms, bound_by}."""
    from chaorec_tpu_torch.ops.indexed_adam import (init_table_state, row_adam_update,
                                                    table_adam_update)
    from chaorec_tpu_torch.ops.row_adam import (fused_row_adam, prepare_sorted_rows,
                                                row_adam_reference)

    results = {}
    for name, (n, d) in ROW_ADAM_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            p0 = torch.randn((n, d), generator=gen, device=device).to(dtype)
            kp, ks = p0.clone(), init_table_state(p0)
            pp, ps = p0.clone(), init_table_state(p0)
            worst, err = (0.0, ""), 0.0
            for step, b in enumerate((2048, 1, 2048), 1):
                rows = row_adam_rows(gen, n, b, device)
                g = torch.randn((b, d), generator=gen, device=device)
                count = torch.tensor(step, dtype=torch.int32, device=device)
                before = fused_row_adam.launches
                kp, ks = table_adam_update(kp, ks, rows, g, count, ROW_ADAM_LR)
                torch.cuda.synchronize()
                check(fused_row_adam.launches == before + 1, "table_adam_update did not launch")
                pp, ps = row_adam_update(pp, ps, rows, g, count, ROW_ADAM_LR)
                for t, got, want, tol in (("p", kp, pp, ROW_P_TOL), ("m", ks.m, ps.m, ROW_P_TOL),
                                          ("v", ks.v, ps.v, ROW_V_TOL)):
                    share, at = tol_share(got, want, **tol, bf16_ulps=int(dtype == torch.bfloat16),
                                          where=True)
                    if share > worst[0]:
                        worst = (share, f"{t} at step {step}, entry {at}: {got.view(-1)[at].item()!r}"
                                        f" vs {want.view(-1)[at].item()!r}")
                    err = max(err, (got.float() - want.float()).abs().max().item())
                    # each step starts from equal tables: a value rounded to the
                    # other neighbour would otherwise grow under cancellation
                    got.copy_(want)
            unit = " + 1 bf16 ulp" if dtype == torch.bfloat16 else ""
            say("kernel", f"fused_row_adam {name} ({n}, {d}) {str(dtype)[6:]}: 3 steps (B 2048, "
                f"1, 2048; duplicates, sentinels, rows 0..63 and N-64..N-1) vs row_adam_update: "
                f"max abs err {err:.3e}, worst entry at {worst[0]:.3f} of its tolerance (rtol "
                f"2e-5, atol 2e-7 for p and m, 1e-9 for v{unit}): {worst[1]}")
            check(worst[0] <= 1.0, f"fused_row_adam {name} {dtype} disagrees")
            results[name, str(dtype)[6:]] = dict(max_abs_err=err)
            del p0, kp, ks, pp, ps

        # times at the main path's shapes: one step's 2048 rows, fp32 and bf16
        for dtype in (torch.float32, torch.bfloat16):
            p = torch.randn((n, d), generator=gen, device=device).to(dtype)
            m = torch.rand((n, d), generator=gen, device=device).to(dtype) * 1e-3
            v = torch.rand((n, d), generator=gen, device=device).to(dtype) * 1e-6
            rows = row_adam_rows(gen, n, 2048, device)
            g = torch.randn((2048, d), generator=gen, device=device)
            count = torch.tensor(5, dtype=torch.int32, device=device)
            r_s, g_s = prepare_sorted_rows(rows, g, n)
            distinct = int((r_s < n).sum())
            ms = cuda_ms(lambda: fused_row_adam(p, m, v, r_s, g_s, count, ROW_ADAM_LR), 20)
            prep_ms = cuda_ms(lambda: prepare_sorted_rows(rows, g, n), 20)
            plain_ms = cuda_ms(lambda: row_adam_reference(p, m, v, r_s, g_s, count,
                                                          ROW_ADAM_LR), 5)
            size = p.element_size()
            bms, by = bound_ms(10 * n * d, 6 * n * d * size + distinct * d * 4 + 2048 * 4 + 4)
            # the same step by torch's own kernels: the dense gradient (in
            # the table's dtype), then a fused Adam (whose moments follow
            # the table's dtype), from the kernel's starting point
            lib_p = torch.nn.Parameter(p.clone())
            opt = torch.optim.Adam([lib_p], lr=ROW_ADAM_LR, fused=True)
            g_lib = g.to(dtype)

            def library():
                lib_p.grad = torch.zeros_like(lib_p).index_add_(0, rows, g_lib)
                opt.step()

            library()
            state = opt.state[lib_p]
            with torch.no_grad():
                lib_p.copy_(p)
                state["exp_avg"].copy_(m)
                state["exp_avg_sq"].copy_(v)
                state["step"].fill_(float(count) - 1)
                want = p.clone()
                fused_row_adam(want, m.clone(), v.clone(), r_s, g_s, count, ROW_ADAM_LR)
            library()
            lib_err = (lib_p.detach().float() - want.float()).abs().max().item()
            library_ms = cuda_ms(library, 10)
            results[name, str(dtype)[6:]].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                                 bound_ms=bms, bound_by=by)
            say("kernel", f"fused_row_adam {name} ({n}, {d}) {str(dtype)[6:]}, 2048 rows "
                f"({distinct} distinct): kernel {ms:.4f} ms (+ prepare_sorted_rows {prep_ms:.4f} "
                f"ms), plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}), library (zeros + "
                f"index_add_ + Adam(fused=True).step) {library_ms:.4f} ms, max abs diff from the "
                f"kernel {lib_err:.3e}")
            del lib_p, opt, state, want, g_lib
            del p, m, v, g, g_s
            torch.cuda.empty_cache()
    return results


def lse_inputs(gen, shape, device):
    """q (B, E) unit rows over the temperature and k (N, E) unit rows (with
    or without gradient), and a random weight g (B,) per row."""
    b, n, e, temp, k_grad = shape
    unit = [torch.nn.functional.normalize(torch.randn(rows, e, generator=gen, device=device), dim=1)
            for rows in (b, n)]
    q = (unit[0] / temp).requires_grad_()
    k = unit[1].requires_grad_(k_grad)
    return q, k, torch.randn(b, generator=gen, device=device)


def lse_counts():
    from chaorec_tpu_torch.ops.streaming_lse import (streaming_lse_dk, streaming_lse_dq,
                                                     streaming_lse_fwd)

    return tuple(f.launches for f in (streaming_lse_fwd, streaming_lse_dq, streaming_lse_dk))


def kernel_wrappers():
    """Every kernel wrapper, in the order of KERNELS' sources."""
    from chaorec_tpu_torch.ops.fused_attn import fused_mha, fused_mha_bwd
    from chaorec_tpu_torch.ops.prefix_scan import prefix_cumsum
    from chaorec_tpu_torch.ops.row_adam import fused_row_adam
    from chaorec_tpu_torch.ops.streaming_lse import (streaming_lse_dk, streaming_lse_dq,
                                                     streaming_lse_fwd)

    return (fused_mha, fused_mha_bwd, fused_row_adam, streaming_lse_fwd, streaming_lse_dq,
            streaming_lse_dk, prefix_cumsum)


def reset_counts():
    """Every kernel wrapper's launch count to 0."""
    for f in kernel_wrappers():
        f.launches = 0


def other_counts(*mine):
    """The launch counts of every wrapper but ``mine``."""
    return tuple(f.launches for f in kernel_wrappers() if f not in mine)


def lse_bound(b, n, e, kernel):
    """Bound of one K2 kernel: the logits take 2 E flops each and dq/dk's
    product 2 E more (exps not counted); q and k are read once, lse and g
    (B,) once each by the backward, and the output written once."""
    flops = (2 if kernel == "fwd" else 4) * b * n * e
    nbytes = 4 * (b * e + n * e + {"fwd": b, "dq": 2 * b + b * e, "dk": 2 * b + n * e}[kernel])
    return bound_ms(flops, nbytes)


def ptxas_entries(name: str, fragment: str):
    """[(kernel, "Used N registers ...", "... spill stores, ... spill
    loads")] of ptxas's log for csrc/{name}.cu, for each compiled entry
    whose mangled name holds ``fragment``; [] when the library was built
    before this run (no log)."""
    from chaorec_tpu_torch import kernels

    out, entry, spill = [], None, ""
    for line in kernels.build(name).log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, spill = m.group(1), ""
        elif entry and "spill" in line:
            spill = line.strip()
        elif entry and "registers" in line:
            if fragment in entry:
                out.append((entry, line.split(":", 1)[-1].strip(), spill))
            entry = None
    return out


def lse_phase(gen, device) -> dict:
    """The streaming logsumexp kernels against the plain version and its
    autograd at every shape of LSE_SHAPES, then their times at SGL's two
    main shapes. Returns {"max_abs_err": {kernel: err}, side: {kernel:
    {ms, plain_ms, library_ms, bound_ms, bound_by}}}."""
    from chaorec_tpu_torch.ops.streaming_lse import (streaming_logsumexp,
                                                     streaming_logsumexp_reference,
                                                     streaming_lse_dk, streaming_lse_dq,
                                                     streaming_lse_fwd)

    errs = {"fwd": 0.0, "dq": 0.0, "dk": 0.0}
    for shape in LSE_SHAPES:
        b, n, e, temp, k_grad = shape
        q, k, g = lse_inputs(gen, shape, device)
        inputs = (q, k) if k_grad else (q,)
        before = lse_counts()
        got = streaming_logsumexp(q, k)
        grads = torch.autograd.grad(got, inputs, g)
        torch.cuda.synchronize()
        launched = tuple(a - c for a, c in zip(lse_counts(), before))
        check(launched == (1, 1, int(k_grad)), f"lse {shape} launched {launched}")
        want = streaming_logsumexp_reference(q, k)
        wgrads = torch.autograd.grad(want, inputs, g)
        fwd_share = tol_share(got, want, **LSE_TOL)
        errs["fwd"] = max(errs["fwd"], (got - want).abs().max().item())
        rel_tol = LSE_BWD_REL_TOL * max(1.0, 0.1 / temp)
        rels = []
        for name, a, w in zip(("dq", "dk"), grads, wgrads):
            err = (a - w).abs().max().item()
            errs[name] = max(errs[name], err)
            rels.append(err / w.abs().max().item())
        say("kernel", f"streaming_logsumexp ({b}, {n}, {e}) at temperature {temp}, k "
            f"{'with' if k_grad else 'without'} gradient: launches fwd/dq/dk {launched}; "
            f"fwd max abs err {(got - want).abs().max().item():.3e} ({fwd_share:.3f} of rtol/atol "
            f"1e-5); dq{', dk' if k_grad else ''} max abs err / max |plain| "
            + ", ".join(f"{r:.2e}" for r in rels) + f" (bound {rel_tol:g})")
        check(fwd_share <= 1.0 and max(rels) <= rel_tol, f"streaming_logsumexp {shape} disagrees")
        del q, k, g, got, grads, want, wgrads

    ptxas = ptxas_entries("streaming_lse", "lse_bwd64_kernel")
    for entry, regs, spill in ptxas:
        kind = "dk" if "ILb1E" in entry else "dq"
        say("kernel", f"ptxas (csrc/streaming_lse.cu) lse_bwd64_kernel, {kind}: {regs}; {spill}")
    if not ptxas:
        say("kernel", "ptxas: no log for lse_bwd64_kernel (built before this run)")
    results = {"max_abs_err": errs}
    for side, shape in LSE_MAIN.items():
        b, n, e, _, _ = shape
        q, k, g = lse_inputs(gen, shape, device)
        q, k = q.detach(), k.detach()
        lse = streaming_lse_fwd(q, k)
        kq, kk = q.clone().requires_grad_(), k.clone().requires_grad_()
        plain = streaming_logsumexp_reference(kq, kk)
        # the library route: no single PyTorch call computes this; the
        # product and torch.logsumexp, two calls, and autograd through them
        lib = torch.logsumexp(torch.mm(kq, kk.T), dim=-1)
        row = {}
        for kernel, fn, plain_fn, lib_fn in (
                ("fwd", lambda: streaming_lse_fwd(q, k),
                 lambda: streaming_logsumexp_reference(q, k),
                 lambda: torch.logsumexp(torch.mm(q, k.T), dim=-1)),
                ("dq", lambda: streaming_lse_dq(q, k, lse, g),
                 lambda: torch.autograd.grad(plain, (kq,), g, retain_graph=True),
                 lambda: torch.autograd.grad(lib, (kq,), g, retain_graph=True)),
                ("dk", lambda: streaming_lse_dk(q, k, lse, g),
                 lambda: torch.autograd.grad(plain, (kk,), g, retain_graph=True),
                 lambda: torch.autograd.grad(lib, (kk,), g, retain_graph=True))):
            bms, by = lse_bound(b, n, e, kernel)
            row[kernel] = dict(ms=cuda_ms(fn, 20), plain_ms=cuda_ms(plain_fn, 10),
                               library_ms=cuda_ms(lib_fn, 10), bound_ms=bms, bound_by=by)
            say("kernel", f"streaming_lse_{kernel} {side} side ({b}, {n}, {e}): kernel "
                f"{row[kernel]['ms']:.4f} ms, plain {row[kernel]['plain_ms']:.4f} ms, library "
                f"(torch.logsumexp(q @ k.T){'' if kernel == 'fwd' else ' and its autograd'}, two "
                f"calls) {row[kernel]['library_ms']:.4f} ms, bound {bms:.4f} ms ({by})")
        results[side] = row
        del q, k, g, lse, kq, kk, plain, lib
        torch.cuda.empty_cache()
    return results


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


def synthetic_dataset(name: str, seed: int, lens=(5, 14), features: bool = False):
    """``name``'s shape with ``lens`` (low, high) train items per user, drawn
    with a popularity skew (item weight ~ 1 / (rank + 10)), one val and one
    test item each; with ``features``, the loader's synthetic image and text
    features (``data/loading.synthetic_item_features``)."""
    from chaorec_tpu_torch.data.loading import (DATASET_STATS, T_FEAT_DIM, T_FEAT_SEED,
                                                V_FEAT_DIM, V_FEAT_SEED, RecDataset,
                                                _pad_lists, synthetic_item_features)

    num_user, num_item = DATASET_STATS[name]
    rng = np.random.default_rng(seed)
    w = 1.0 / (np.arange(num_item) + 10.0)
    w = w[rng.permutation(num_item)]
    w /= w.sum()
    lens = rng.integers(*lens, num_user)
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
    feats = {}
    if features:
        feats = dict(
            v_feat=synthetic_item_features(edges, num_user, num_item, V_FEAT_DIM, V_FEAT_SEED),
            t_feat=synthetic_item_features(edges, num_user, num_item, T_FEAT_DIM, T_FEAT_SEED))
    return RecDataset(
        name=name, num_user=num_user, num_item=num_item, train_edges=edges,
        history=_pad_lists([h.tolist() for h in hist], fill=num_item, sort=True),
        val_users=users, val_pos=_pad_lists([[p[0]] for p in held], fill=-1),
        test_users=users, test_pos=_pad_lists([[p[1]] for p in held], fill=-1),
        **feats,
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


def device_profile(phase: str, what: str, fn, out_path: str, groups=None) -> None:
    """Wall time of ``fn`` unprofiled, then device time by kernel and the
    idle share over one profiled call; with ``groups`` ({label: name
    fragments}), also the device time of the kernels whose lowercased name
    holds one of a group's fragments."""
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
    # device kernels only: an op's own row, or a range such as
    # Optimizer.step's annotation on the device, would count its kernels twice
    rows = sorted(((e.self_device_time_total, e.key, e.count) for e in events
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                   and not getattr(e, "is_user_annotation", False)),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    check(busy_ms > 0, "the profiler saw no device kernel")
    say(phase, f"{what}: wall {wall_ms:.1f} ms unprofiled, device kernels {busy_ms:.1f} ms, "
        f"idle share {100 * max(0.0, 1 - busy_ms / wall_ms):.1f}%")
    for us, key, count in rows[:10]:
        say(phase, f"{us / 1e3:9.2f} ms  {100 * us / 1e3 / busy_ms:5.1f}%  "
            f"x{count:<4d} {key[:90]}")
    for label, frags in (groups or {}).items():
        ms = sum(r[0] for r in rows if any(f in r[1].lower() for f in frags)) / 1e3
        say(phase, f"{label}: {ms:.2f} ms, {100 * ms / busy_ms:.1f}% of device time")
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


class PreEpochTimer:
    """Times each ``pre_epoch`` of a model class while active, with the
    device synchronized at both ends, to split an epoch's training time."""

    def __init__(self, cls):
        self.cls, self.seconds = cls, []

    def __enter__(self):
        orig = self.orig = self.cls.pre_epoch

        def timed(model, params, epoch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            orig(model, params, epoch)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)

        self.cls.pre_epoch = timed
        return self

    def __exit__(self, *exc):
        self.cls.pre_epoch = self.orig


@contextlib.contextmanager
def plain_table_update():
    """The trainer's table step through row_adam_update (the plain path)
    instead of the kernel. For the comparisons only."""
    from chaorec_tpu_torch.ops.indexed_adam import row_adam_update
    from chaorec_tpu_torch.train import loop

    kernel = loop.table_adam_update
    loop.table_adam_update = row_adam_update
    try:
        yield
    finally:
        loop.table_adam_update = kernel


def check_embeddings_serving(phase: str, path: str, ds, device, model_name: str) -> None:
    """An embeddings artifact of the best epoch: its tables' shapes, and HTTP
    answers that are the tables' own top-k (bf16 inputs summed in float64
    here), hold no seen item, and 404 on an unknown path; request latency."""
    from chaorec_tpu_torch.serve import Recommender, serve_http

    with np.load(path) as z:
        check(str(z["kind"]) == "embeddings" and str(z["model"]) == model_name
              and str(z["snapshot"]) == "best-epoch", f"artifact {z['kind']} {z['model']}")
        ue, ie = z["user_emb"], z["item_emb"]
    check(ue.shape[0] == ds.num_user and ie.shape[0] == ds.num_item
          and ue.shape[1] == ie.shape[1], f"tables {ue.shape} {ie.shape}")
    check(bool(np.isfinite(ue).all() and np.isfinite(ie).all()), "non-finite tables")
    ub = torch.from_numpy(ue).to(torch.bfloat16).double().numpy()
    ib = torch.from_numpy(ie).to(torch.bfloat16).double().numpy()
    rec = Recommender.load(path, device)
    srv = serve_http(rec, port=0, host="127.0.0.1")
    port = srv.server_address[1]
    try:
        health = get_json(port, "/healthz")
        check(health["ok"] and health["model"] == model_name, f"healthz: {health}")
        users = [u for u in (0, 5, 17, 100, 4095, 4096) if u < ds.num_user] + [ds.num_user - 1]
        k = 10
        resp = get_json(port, f"/recommend?user={','.join(map(str, users))}&k={k}")
        check(len(resp["results"]) == len(users), "wrong number of results")
        worst = 0.0
        for u, res in zip(users, resp["results"]):
            want = ub[u] @ ib.T
            seen = ds.history.values[u, :ds.history.lengths[u]]
            want[seen] = -np.inf
            got = [(it["item"] - ds.num_user, it["score"]) for it in res["items"]]
            check(res["user"] == u and len(got) == k, f"user {u}: malformed answer")
            check(not set(seen.tolist()) & {i for i, _ in got}, f"user {u}: a seen item")
            kth = np.sort(want)[-k]
            for i, score in got:
                worst = max(worst, abs(score - want[i]), kth - want[i])
        check(worst <= SCORE_TOL, f"answers are not the tables' top-{k}: off by {worst}")
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
        say(phase, f"http on 127.0.0.1:{port} ({health['snapshot']} {model_name} tables "
            f"{ue.shape}, {ie.shape}): {len(users)} users' top-{k} are the tables' own to "
            f"{worst:.2e} (bound {SCORE_TOL:g}), no seen item, 404 on unknown path; "
            f"/recommend 3 users k=10 latency p50 {np.median(lat):.3f} ms, "
            f"p99 {np.percentile(lat, 99):.3f} ms over {len(lat)} requests")
    finally:
        srv.shutdown()
        srv.server_close()


def sports_dataset(args):
    """The sports-sized set phases 10-18 share: ``--data_root``'s, or the
    synthetic one with the loader's synthetic features."""
    from chaorec_tpu_torch.data.loading import data_load

    t0 = time.perf_counter()
    fds = (data_load(FREEDOM_DATASET, args.data_root, has_v=True, has_t=True) if args.data_root
           else synthetic_dataset(FREEDOM_DATASET, args.seed, lens=(4, 8), features=True))
    say("freedom", f"{'data_load' if args.data_root else 'synthetic'} {FREEDOM_DATASET} "
        f"({fds.num_user}, {fds.num_item}), {fds.num_edges} train edges, v_feat "
        f"{fds.v_feat.shape}, t_feat {fds.t_feat.shape}: {time.perf_counter() - t0:.2f} s")
    return fds


def freedom_phases(args, device, fds):
    """Phases 10-13: FREEDOM's CLI run on sports, one step kernel vs plain
    path, the profiles and the bf16 leg. Returns the fused_row_adam
    launches of the CLI run and of the bf16 epoch."""
    from chaorec_tpu_torch import cli
    from chaorec_tpu_torch.config import Config, grid_combinations, load_yaml_config
    from chaorec_tpu_torch.data.sampling import make_edge_batches, sample_negatives
    from chaorec_tpu_torch.models import build_model
    from chaorec_tpu_torch.models.freedom import FREEDOM
    from chaorec_tpu_torch.ops.mxu import bdot
    from chaorec_tpu_torch.ops.row_adam import fused_row_adam
    from chaorec_tpu_torch.train.loop import Trainer, deterministic_mode

    # 10. freedom: the CLI's grid run of FREEDOM on sports ------------------
    combo = next(grid_combinations(load_yaml_config("FREEDOM")))
    with tempfile.TemporaryDirectory() as tmp:
        art = os.path.join(tmp, "freedom.npz")
        fcfg = Config(Model="FREEDOM", data_path=FREEDOM_DATASET, seed=args.seed,
                      num_epoch=FREEDOM_EPOCHS, log_dir=args.out_dir, export_artifact=art)
        probe = EpochProbe()
        logging.getLogger().addFilter(probe)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        try:
            with PreEpochTimer(FREEDOM) as pre:
                fbest = cli.run(fcfg, None, fds, device)  # reads Model_YAML/FREEDOM.yaml
                torch.cuda.synchronize()
        finally:
            logging.getLogger().removeFilter(probe)
        freedom_run_s = time.perf_counter() - t0
        freedom_launches = fused_row_adam.launches
        others = other_counts(fused_row_adam)
        n_fbatches = math.ceil(fds.num_edges / fcfg.batch_size)
        expected = FREEDOM_EPOCHS * n_fbatches * 2
        for e, (ep, pre_s) in enumerate(zip(probe.epochs, pre.seconds)):
            say("freedom", f"epoch {e + 1}: loss {ep['loss']:.5f}, wall {ep['wall_s']:.3f} s "
                f"(pre_epoch {pre_s:.3f} s, training {ep['train_s'] - pre_s:.3f} s, eval "
                f"{ep['eval_s']:.3f} s), peak device memory {ep['peak_gib']:.2f} GiB")
        say("freedom", f"cli.run {combo}: {FREEDOM_EPOCHS} epochs x {n_fbatches} batches of "
            f"{fcfg.batch_size} + export: {freedom_run_s:.3f} s wall; fused_row_adam launches "
            f"{freedom_launches} (expected {expected} = {FREEDOM_EPOCHS} x {n_fbatches} x 2 "
            f"tables), other kernels {others} (expected none)")
        check(freedom_launches == expected and not any(others),
              f"FREEDOM launched {freedom_launches} and {others}")
        check(len(probe.epochs) == len(pre.seconds) == FREEDOM_EPOCHS,
              f"{len(probe.epochs)} epochs logged, {len(pre.seconds)} pre_epochs")
        check(all(math.isfinite(ep["loss"]) for ep in probe.epochs), "non-finite epoch loss")
        check(sorted(fbest) == [5, 10, 20] and all(
            math.isfinite(v) for m in fbest.values() for v in m.values()), f"best {fbest}")
        say("freedom", "best test metrics: " + "; ".join(
            f"@{k} recall {m['recall']:.5f} ndcg {m['ndcg']:.5f}" for k, m in fbest.items()))
        check_embeddings_serving("freedom", art, fds, device, "FREEDOM")
    torch.cuda.empty_cache()

    # 11. fstep: one FREEDOM step, kernel path against plain path -----------
    scfg = fcfg.replace(**combo, export_artifact="")
    fmodel = build_model(scfg, fds, device)
    trainer = Trainer(fmodel, fds, scfg)
    init = trainer.init_params()
    fmodel.pre_epoch(init, 0)
    fbatch = make_edge_batches(trainer.generator, trainer.edges, scfg.batch_size)[0]
    fbatch = dataclasses.replace(fbatch, neg_items=sample_negatives(
        trainer.generator, fbatch.users, trainer.history, fmodel.num_item, scfg.neg_candidates))
    tables = fmodel.table_params

    def freedom_step():
        params = {n: t.detach().clone() if n in tables else t.detach().clone().requires_grad_()
                  for n, t in init.items()}
        opt = trainer.make_optimizer(params)
        loss = trainer.train_step(params, opt, fbatch).item()
        return loss, params, trainer.table_state

    before = fused_row_adam.launches
    k_loss, k_params, k_state = freedom_step()
    check(fused_row_adam.launches == before + len(tables), "the kernel step did not launch")
    with plain_table_update():
        p_loss, p_params, p_state = freedom_step()
    check(fused_row_adam.launches == before + len(tables), "the plain step launched")
    worst = max((tol_share(k_params[n], p_params[n], **ROW_P_TOL), n) for n in p_params)
    for n in tables:
        worst = max(worst, (tol_share(k_state[n].m, p_state[n].m, **ROW_P_TOL), n + ".m"),
                    (tol_share(k_state[n].v, p_state[n].v, **ROW_V_TOL), n + ".v"))
    say("fstep", f"one FREEDOM step of {fbatch.users.shape[0]} edges, kernel vs plain table "
        f"update on the same batch and negatives: loss {k_loss:.7f} vs {p_loss:.7f}; worst "
        f"of params, tables and moments {worst[1]} at {worst[0]:.3f} of its tolerance")
    check(k_loss == p_loss and worst[0] <= 1.0, "FREEDOM step disagrees")
    del k_params, k_state, p_params, p_state

    # 12. profile: a FREEDOM step, a pre_epoch, and the row operators --------
    params = {n: t.detach().clone() if n in tables else t.detach().clone().requires_grad_()
              for n, t in init.items()}
    opt = trainer.make_optimizer(params)
    device_profile("profile", f"one FREEDOM training step of {scfg.batch_size} edges (forward, "
                   "backward, Adam, two row-sparse table updates)",
                   lambda: trainer.train_step(params, opt, fbatch),
                   os.path.join(args.out_dir, "chip_smoke_freedom_step_profile.txt"))
    device_profile("profile", "one FREEDOM pre_epoch (Gumbel top-k pruning, masked R, "
                   "R^T, R R^T, R^T R)",
                   deterministic_mode()(lambda: fmodel.pre_epoch(params, 1)),  # as the trainer
                   os.path.join(args.out_dir, "chip_smoke_freedom_pre_epoch_profile.txt"))
    r, rt = fmodel.masked_r, fmodel._rt
    nu, ni = r.shape
    rrt_ms = cuda_ms(lambda: bdot(r, rt), 3)
    rtr_ms = cuda_ms(lambda: bdot(rt, r), 3)
    rrt_bound = bound_ms(2 * nu * nu * ni, 2 * 2 * nu * ni + 4 * nu * nu, PEAK_BF16_FLOPS)
    rtr_bound = bound_ms(2 * ni * ni * nu, 2 * 2 * nu * ni + 4 * ni * ni, PEAK_BF16_FLOPS)
    say("profile", f"R R^T ({nu}x{ni} @ {ni}x{nu}, bf16 in, fp32 out): {rrt_ms:.3f} ms, bound "
        f"{rrt_bound[0]:.3f} ms ({rrt_bound[1]}); R^T R: {rtr_ms:.3f} ms, bound "
        f"{rtr_bound[0]:.3f} ms ({rtr_bound[1]})")
    # The same product with rows of whole 16-byte vectors (an item axis
    # padded with zero columns to a multiple of 8): a measurement for the
    # next step, not a path of the port.
    rp = torch.nn.functional.pad(r, (0, -ni % 8))
    rpt = rp.t().contiguous()
    say("profile", f"R R^T with the item axis padded to {rp.shape[1]} columns: "
        f"{cuda_ms(lambda: bdot(rp, rpt), 3):.3f} ms")
    del params, opt, init, trainer, r, rt, rp, rpt
    torch.cuda.empty_cache()

    # the bf16 leg (--relaxed_precision bf16): one epoch with the tables and
    # their moments stored in bf16, through the same kernel
    bcfg = scfg.replace(relaxed_precision="bf16", num_epoch=1)
    btrainer = Trainer(fmodel, fds, bcfg)
    before = fused_row_adam.launches
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bbest = btrainer.run()
    torch.cuda.synchronize()
    bf16_s = time.perf_counter() - t0
    blaunches = fused_row_adam.launches - before
    say("bf16", f"one FREEDOM epoch with bf16 tables and moments: {bf16_s:.3f} s wall (pre_epoch, "
        f"training and eval), fused_row_adam launches {blaunches} (expected {n_fbatches * 2}), "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; test "
        f"recall@20 {bbest[20]['recall']:.5f}")
    check(blaunches == n_fbatches * 2, f"the bf16 epoch launched {blaunches}")
    check(all(btrainer.table_state[n].m.dtype == torch.bfloat16 for n in tables),
          "the bf16 leg's moments are not bf16")
    check(all(math.isfinite(v) for m in bbest.values() for v in m.values()), f"bf16 {bbest}")
    del fmodel, btrainer
    torch.cuda.empty_cache()
    return freedom_launches, blaunches


@contextlib.contextmanager
def plain_logsumexp():
    """catalog_logsumexp through streaming_logsumexp_reference (the plain
    path) instead of the kernels. For the comparisons only."""
    from chaorec_tpu_torch.ops import losses
    from chaorec_tpu_torch.ops.streaming_lse import streaming_logsumexp_reference

    kernel = losses.streaming_logsumexp
    losses.streaming_logsumexp = streaming_logsumexp_reference
    try:
        yield
    finally:
        losses.streaming_logsumexp = kernel


def first_combo(model_name: str):
    """(combo, one-combo grid) of Model_YAML/{model_name}.yaml's first combo."""
    from chaorec_tpu_torch.config import grid_combinations, load_yaml_config

    combo = next(grid_combinations(load_yaml_config(model_name)))
    grid = {k: [v] for k, v in combo.items()}
    grid["hyper_parameters"] = list(combo)
    return combo, grid


def ssl_phases(args, device, fds) -> dict:
    """Phases 14-19: SGL's and NCL's CLI runs on sports through the
    streaming logsumexp kernels, SGL's export and serving, one step of each
    kernel vs plain path, and each one's step profile. Returns each model's
    (fwd, dq, dk) launches of its CLI run."""
    from chaorec_tpu_torch import cli
    from chaorec_tpu_torch.config import Config
    from chaorec_tpu_torch.data.sampling import make_edge_batches, sample_negatives
    from chaorec_tpu_torch.models import build_model
    from chaorec_tpu_torch.ops.streaming_lse import (streaming_lse_dk, streaming_lse_dq,
                                                     streaming_lse_fwd)
    from chaorec_tpu_torch.train.loop import Trainer

    launches = {}
    for name, phase in (("SGL", "sgl"), ("NCL", "ncl")):
        # 14 / 17. the CLI's grid run, first combo ---------------------------
        combo, grid = first_combo(name)
        epochs = SSL_EPOCHS[name]
        with tempfile.TemporaryDirectory() as tmp:
            art = os.path.join(tmp, f"{name}.npz") if name == "SGL" else ""
            cfg = Config(Model=name, data_path=FREEDOM_DATASET, seed=args.seed, num_epoch=epochs,
                         log_dir=args.out_dir, export_artifact=art)
            probe = EpochProbe()
            logging.getLogger().addFilter(probe)
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            try:
                best = cli.run(cfg, grid, fds, device)
                torch.cuda.synchronize()
            finally:
                logging.getLogger().removeFilter(probe)
            run_s = time.perf_counter() - t0
            launches[name] = lse_counts()
            others = other_counts(streaming_lse_fwd, streaming_lse_dq, streaming_lse_dk)
            n_batches = math.ceil(fds.num_edges / cfg.batch_size)
            terms, with_k_grad = SSL_TERMS[name]
            expected = tuple(epochs * n_batches * t for t in (terms, terms, with_k_grad))
            for e, ep in enumerate(probe.epochs):
                say(phase, f"epoch {e + 1}: loss {ep['loss']:.5f}, wall {ep['wall_s']:.3f} s "
                    f"(training {ep['train_s']:.3f} s, eval {ep['eval_s']:.3f} s), peak device "
                    f"memory {ep['peak_gib']:.2f} GiB")
            say(phase, f"cli.run {combo}: {epochs} epochs x {n_batches} batches of "
                f"{cfg.batch_size}{' + export' if art else ''}: {run_s:.3f} s wall; "
                f"streaming_lse fwd/dq/dk launches {launches[name]} (expected {expected} = "
                f"{epochs} x {n_batches} x {terms} terms, {with_k_grad} of them with a k "
                f"gradient), other kernels {others} (expected none)")
            check(launches[name] == expected and not any(others),
                  f"{name} launched {launches[name]} and {others}")
            check(len(probe.epochs) == epochs, f"{len(probe.epochs)} epochs logged")
            check(all(math.isfinite(ep["loss"]) for ep in probe.epochs), "non-finite epoch loss")
            check(sorted(best) == [5, 10, 20] and all(
                math.isfinite(v) for m in best.values() for v in m.values()), f"best {best}")
            say(phase, "best test metrics: " + "; ".join(
                f"@{k} recall {m['recall']:.5f} ndcg {m['ndcg']:.5f}" for k, m in best.items()))
            if art:
                check_embeddings_serving(phase, art, fds, device, name)
        torch.cuda.empty_cache()

        # 15 / 18. one step, kernel path against plain path ------------------
        # On a float32 R: bdot's backward rounds each propagated gradient to
        # bf16 (as the JAX package's transpose does), so on the bf16 R an
        # fp32-level difference from the kernel can flip one bf16 ulp of a
        # large gradient entry, which is 4e-3 of it.
        step_phase = {"SGL": "sstep", "NCL": "nstep"}[name]
        scfg = cfg.replace(**combo, export_artifact="")

        def setup(graph_dtype):
            model = build_model(scfg.replace(graph_compute_dtype=graph_dtype), fds, device)
            trainer = Trainer(model, fds, scfg)
            init = trainer.init_params()
            batch = make_edge_batches(trainer.generator, trainer.edges, scfg.batch_size)[0]
            batch = dataclasses.replace(batch, neg_items=sample_negatives(
                trainer.generator, batch.users, trainer.history, model.num_item,
                scfg.neg_candidates))
            return model, trainer, init, batch

        model, trainer, init, batch = setup("float32")
        if name == "SGL":
            draws = model.view_masks(trainer.generator)
            loss_fn = model.loss_with_masks
        else:
            draws = model.prototypes(init, trainer.generator)
            loss_fn = model.loss_with_prototypes

        def one_step():
            leaves = {n: t.detach().clone().requires_grad_() for n, t in init.items()}
            loss = loss_fn(leaves, batch, draws)
            loss.backward()
            return loss.item(), {n: t.grad for n, t in leaves.items()}

        before = lse_counts()
        k_loss, k_grads = one_step()
        step_launches = tuple(a - b for a, b in zip(lse_counts(), before))
        check(step_launches == (terms, terms, with_k_grad),
              f"the kernel step launched {step_launches}")
        with plain_logsumexp():
            p_loss, p_grads = one_step()
        check(lse_counts() == tuple(b + d for b, d in zip(before, step_launches)),
              "the plain step launched")
        scale = max(g.abs().max().item() for g in p_grads.values())
        worst = max(((k_grads[n] - g).abs().max().item()
                     / (STEP_RTOL * g.abs().max().item() + STEP_ATOL * scale), n)
                    for n, g in p_grads.items())
        loss_rel = abs(k_loss - p_loss) / abs(p_loss)
        say(step_phase, f"one {name} step of {batch.users.shape[0]} edges on a float32 R, kernel "
            f"vs plain logsumexp on the same batch, negatives and "
            f"{'masks' if name == 'SGL' else 'prototypes'}: launches {step_launches}; loss "
            f"{k_loss:.7f} vs {p_loss:.7f} (rel {loss_rel:.2e}, "
            f"bound {STEP_LOSS_RTOL:g}); worst gradient {worst[1]} at {worst[0]:.3f} of its bound "
            f"(rtol {STEP_RTOL:g} of the tensor's max + {STEP_ATOL:g} of the gradient's max "
            f"{scale:.3e})")
        check(loss_rel <= STEP_LOSS_RTOL and worst[0] <= 1.0, f"{name} step disagrees")
        del k_grads, p_grads, model, trainer, init, draws
        torch.cuda.empty_cache()

        # 16 / 19. profile: where one step's device time goes ----------------
        model, trainer, init, batch = setup(scfg.graph_compute_dtype)
        params = {n: t.detach().clone().requires_grad_() for n, t in init.items()}
        opt = trainer.make_optimizer(params)
        what = ("two edge-dropout views" if name == "SGL"
                else "k-means of both tables, 15 iterations each")
        device_profile(
            "profile", f"one {name} training step of {scfg.batch_size} edges (the dense bf16 "
            f"propagation of {max(model.n_layers, 2)} layers, {what}, {terms} streaming_lse "
            "terms, backward, Adam)",
            lambda: trainer.train_step(params, opt, batch),
            os.path.join(args.out_dir, f"chip_smoke_{name.lower()}_step_profile.txt"),
            groups={"K2 (streaming_lse kernels and their combine passes)": (
                        "lse_", "dq_combine"),
                    "GEMMs (the dense bf16 R propagation and its backward; k-means)": (
                        "gemm", "nvjet", "cutlass", "xmma"),
                    "bf16 -> fp32 copies (bdot's backward casts R)": ("copy",),
                    "gathers, scatters and bag sums (the views' hops, row gathers)": (
                        "index", "scatter", "gather", "embeddingbag"),
                    "reductions (argmax, norms, sums)": ("reduce_kernel",)})
        del params, opt, model, trainer, init
        torch.cuda.empty_cache()
    return launches


def scan_atol(exact: torch.Tensor, m: int, sequential: bool = False) -> float:
    """The prefix error model of chaorec_tpu/ops/ell.py:370-381: 4 ulp of
    the largest absolute prefix, times ceil(log2 M) (at least 1). With
    ``sequential``, plus ulp x sqrt(M): torch.cumsum along dim 0 on the card
    adds a column's rows one after another, so its error is a random walk
    of M roundings (the kernel's chains are a few hundred adds long)."""
    top = exact.abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(top)) - 23) if top > 0 else 0.0
    return ulp * (4 * max(1, math.ceil(math.log2(m))) + (math.sqrt(m) if sequential else 0))


def scan_shapes(fds) -> dict:
    """K4's (M, D) on the main paths over the sports-sized set: DGCF's
    factor chunks (dim_E / n_factors = 32) and DCCF's rows (dim_E 64) over
    the train edges, MGAT's conv widths (256 visual, 100 textual, then 64)
    over the doubled edges."""
    e = fds.num_edges
    return {"dgcf": (e, 32), "dccf": (e, 64), "mgat_v": (2 * e, 256), "mgat_t": (2 * e, 100),
            "mgat": (2 * e, 64)}


def scan_phase(gen, device, fds) -> dict:
    """K4 against prefix_cumsum_reference and a float64 prefix at every
    path shape, the 1-D seg_sum's and small ragged ones, with identical
    bits on a second run (K4_BIT_RUNS at DGCF's shape); ptxas's registers
    and spills; its times at the path shapes; seg_sum (gather,
    K4, pointer difference) against an index_add_ segment sum at DGCF's
    and MGAT's shapes. Returns per path shape {max_abs_err, ms, graph_ms,
    plain_ms, library_ms, bound_ms, bound_by} and the seg_sum times."""
    from chaorec_tpu_torch import kernels
    from chaorec_tpu_torch.ops.ell import build_segment_transpose, seg_sum
    from chaorec_tpu_torch.ops.prefix_scan import prefix_cumsum, prefix_cumsum_reference

    paths = scan_shapes(fds)
    e = fds.num_edges
    extra = {"1d": (e, None), "one_row": (1, 1), "ragged_7x3": (7, 3),
             "ragged_513x100": (513, 100), "two_tiles": (1300, 257)}
    results = {}
    for name, (m, d) in {**paths, **extra}.items():
        shape = (m,) if d is None else (m, d)
        for dtype in (torch.float32, torch.bfloat16) if name == "dgcf" else (torch.float32,):
            x = torch.randn(shape, generator=gen, device=device).to(dtype)
            runs = K4_BIT_RUNS if name == "dgcf" else 2
            before = prefix_cumsum.launches
            got = prefix_cumsum(x)
            same = all(torch.equal(got, prefix_cumsum(x)) for _ in range(runs - 1))
            torch.cuda.synchronize()
            check(prefix_cumsum.launches == before + runs, f"prefix_cumsum {shape} did not launch")
            exact = torch.cumsum(x.double(), 0)
            plain = prefix_cumsum_reference(x)
            atol, plain_atol = scan_atol(exact, m), scan_atol(exact, m, sequential=True)
            err = (got.double() - exact).abs().max().item()
            err_plain = (got - plain).abs().max().item()
            plain_exact = (plain.double() - exact).abs().max().item()
            say("k4", f"prefix_cumsum {shape} {str(dtype)[6:]}: max abs err vs float64 {err:.3e} "
                f"(bound {atol:.3e} = 4 ulp of max |prefix| x ceil(log2 M)), vs plain "
                f"{err_plain:.3e} (bound {plain_atol:.3e}, + ulp x sqrt(M); plain vs float64 "
                f"{plain_exact:.3e}); {runs} runs bit-identical: {same}")
            check(got.dtype == torch.float32 and got.shape == x.shape, f"{shape}: {got.shape}")
            check(err <= atol and err_plain <= plain_atol and same,
                  f"prefix_cumsum {shape} disagrees")
            if dtype == torch.float32:
                results[name] = dict(max_abs_err=err_plain)
            del x, got, exact, plain

    ptxas = [line.strip() for line in kernels.build("prefix_scan").log.splitlines()
             if "registers" in line or "spill" in line]
    for line in ptxas or ["no ptxas log: the library was built before this run"]:
        say("k4", f"ptxas (csrc/prefix_scan.cu): {line}")
    for name, (m, d) in paths.items():
        x = torch.randn((m, d), generator=gen, device=device)
        out = torch.empty_like(x)
        bms, by = bound_ms(m * d, 8 * m * d)
        results[name].update(ms=cuda_ms(lambda: prefix_cumsum(x, out=out), 20),
                             graph_ms=graph_ms(lambda: prefix_cumsum(x, out=out), 20),
                             plain_ms=cuda_ms(lambda: prefix_cumsum_reference(x), 5),
                             library_ms=cuda_ms(lambda: torch.cumsum(x, 0), 5),
                             bound_ms=bms, bound_by=by)
        r = results[name]
        say("k4", f"prefix_cumsum ({m}, {d}) {name}: kernel {r['ms']:.4f} ms (20 calls back "
            f"to back; {r['graph_ms']:.4f} ms as a CUDA graph of 20 calls), plain "
            f"{r['plain_ms']:.4f} ms, library (torch.cumsum) {r['library_ms']:.4f} ms, bound "
            f"{bms:.4f} ms ({by}: 8 M D bytes over 3.35 TB/s), {100 * bms / r['ms']:.1f}% of it "
            f"({100 * bms / r['graph_ms']:.1f}% in the graph)")
        del x, out

    # seg_sum as the models call it, against the atomics route, on the
    # segment ids of the path (DGCF's users over the train edges, MGAT's
    # destination nodes over the doubled edges); a printed yardstick only
    users = torch.from_numpy(fds.train_edges[:, 0]).to(device, torch.int64)
    items = torch.from_numpy(fds.train_edges[:, 1]).to(device, torch.int64) + fds.num_user
    dst = torch.cat([items, users])
    for name, idx, n_seg in (("dgcf", users, fds.num_user), ("mgat_v", dst, fds.num_user
                             + fds.num_item), ("mgat", dst, fds.num_user + fds.num_item)):
        m, d = paths[name]
        perm, ptr = build_segment_transpose(idx, n_seg)
        vals = torch.randn((m, d), generator=gen, device=device)
        ours = seg_sum(vals, idx, perm, ptr)
        theirs = torch.zeros((n_seg, d), device=device).index_add_(0, idx, vals)
        diff = (ours - theirs).abs().max().item()
        seg_ms = cuda_ms(lambda: seg_sum(vals, idx, perm, ptr), 20)
        add_ms = cuda_ms(lambda: torch.zeros((n_seg, d), device=device).index_add_(0, idx, vals), 20)
        results[name].update(seg_sum_ms=seg_ms, index_add_ms=add_ms)
        say("k4", f"segment sum of ({m}, {d}) into {n_seg} segments ({name}): seg_sum (permute "
            f"gather, K4, pointer difference) {seg_ms:.4f} ms, zeros + index_add_ {add_ms:.4f} "
            f"ms; max abs diff {diff:.3e}")
        del perm, ptr, vals, ours, theirs
    torch.cuda.empty_cache()
    return results


@contextlib.contextmanager
def plain_prefix_scan(float64: bool = False):
    """The segment sums' prefix through prefix_cumsum_reference (the plain
    path) instead of the kernel; with ``float64``, summed in float64 and
    rounded once. For the comparisons only."""
    from chaorec_tpu_torch.ops import ell
    from chaorec_tpu_torch.ops.prefix_scan import prefix_cumsum_reference

    def plain(v, out=None):
        ref = torch.cumsum(v.double(), 0).float() if float64 else prefix_cumsum_reference(v)
        return ref if out is None else out.copy_(ref)

    kernel = ell.prefix_cumsum
    ell.prefix_cumsum = plain
    try:
        yield
    finally:
        ell.prefix_cumsum = kernel


def scan_launches(cfg) -> tuple:
    """(K4 launches of one training step, of one forward without gradient)
    of ``cfg.Model`` under ``cfg``, read off the model's code: each seg_sum
    forward launches once, and each seg_gather whose input needs a gradient
    launches once in the backward. DGCF: 2 seg_sums and 2 seg_gathers per
    factor, iteration and layer. DCCF: per layer, 2 adaptive views of 1
    seg_sum and 3 seg_gathers. MGAT: per GAT round (3 a tower, 2 towers), 1
    seg_sum and 2 seg_gathers."""
    if cfg.Model == "DGCF":
        sums = 2 * cfg.n_factors * cfg.n_iterations * cfg.n_layers
        return 2 * sums, sums
    if cfg.Model == "DCCF":
        return 8 * cfg.n_layers, 2 * cfg.n_layers
    if cfg.Model == "MGAT":
        return 18, 6
    raise ValueError(cfg.Model)


def seg_phases(args, device, fds) -> dict:
    """Phases 21-29: DGCF's, DCCF's and MGAT's CLI runs on sports through
    K4, DGCF's export and serving, one step of each kernel vs plain path,
    and each one's step profile. Returns each model's K4 launches of its
    CLI run."""
    from chaorec_tpu_torch import cli
    from chaorec_tpu_torch.config import Config
    from chaorec_tpu_torch.data.sampling import make_edge_batches, sample_negatives
    from chaorec_tpu_torch.models import build_model
    from chaorec_tpu_torch.ops.prefix_scan import prefix_cumsum
    from chaorec_tpu_torch.train.loop import Trainer

    launches = {}
    for name in ("DGCF", "DCCF", "MGAT"):
        phase = name.lower()
        # 21 / 24 / 27. the CLI's grid run, first combo ---------------------
        combo, grid = first_combo(name)
        epochs = SEG_EPOCHS[name]
        with tempfile.TemporaryDirectory() as tmp:
            art = os.path.join(tmp, f"{name}.npz") if name == "DGCF" else ""
            cfg = Config(Model=name, data_path=FREEDOM_DATASET, seed=args.seed, num_epoch=epochs,
                         log_dir=args.out_dir, export_artifact=art)
            probe = EpochProbe()
            logging.getLogger().addFilter(probe)
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            try:
                best = cli.run(cfg, grid, fds, device)
                torch.cuda.synchronize()
            finally:
                logging.getLogger().removeFilter(probe)
            run_s = time.perf_counter() - t0
            launches[name] = prefix_cumsum.launches
            others = other_counts(prefix_cumsum)
            n_batches = math.ceil(fds.num_edges / cfg.batch_size)
            per_step, per_eval = scan_launches(cfg.replace(**combo))
            expected = epochs * (n_batches * per_step + per_eval) + (per_eval if art else 0)
            for e, ep in enumerate(probe.epochs):
                say(phase, f"epoch {e + 1}: loss {ep['loss']:.5f}, wall {ep['wall_s']:.3f} s "
                    f"(training {ep['train_s']:.3f} s, eval {ep['eval_s']:.3f} s), peak device "
                    f"memory {ep['peak_gib']:.2f} GiB")
            say(phase, f"cli.run {combo}: {epochs} epochs x {n_batches} batches of "
                f"{cfg.batch_size}{' + export' if art else ''}: {run_s:.3f} s wall; prefix_cumsum "
                f"launches {launches[name]} (expected {expected} = {epochs} x ({n_batches} x "
                f"{per_step} + {per_eval} eval){f' + {per_eval} export' if art else ''}), other "
                f"kernels {others} (expected none)")
            check(launches[name] == expected and not any(others),
                  f"{name} launched {launches[name]} and {others}")
            check(len(probe.epochs) == epochs, f"{len(probe.epochs)} epochs logged")
            check(all(math.isfinite(ep["loss"]) for ep in probe.epochs), "non-finite epoch loss")
            check(sorted(best) == [5, 10, 20] and all(
                math.isfinite(v) for m in best.values() for v in m.values()), f"best {best}")
            say(phase, "best test metrics: " + "; ".join(
                f"@{k} recall {m['recall']:.5f} ndcg {m['ndcg']:.5f}" for k, m in best.items()))
            if art:
                check_embeddings_serving(phase, art, fds, device, name)
        torch.cuda.empty_cache()

        # 22 / 25 / 28. one step, kernel path against plain path -------------
        # On a float32 R (DCCF's propagation; see the SGL step's note).
        step_phase = {"DGCF": "gstep", "DCCF": "cstep", "MGAT": "mstep"}[name]
        scfg = cfg.replace(**combo, export_artifact="")

        def setup(graph_dtype):
            model = build_model(scfg.replace(graph_compute_dtype=graph_dtype), fds, device)
            trainer = Trainer(model, fds, scfg)
            init = trainer.init_params()
            batch = make_edge_batches(trainer.generator, trainer.edges, scfg.batch_size)[0]
            batch = dataclasses.replace(batch, neg_items=sample_negatives(
                trainer.generator, batch.users, trainer.history, model.num_item,
                scfg.neg_candidates))
            return model, trainer, init, batch

        model, trainer, init, batch = setup("float32")
        state = None
        if model.stateful:  # routing scores away from the uniform start
            state = trainer.model_state + 0.5 * torch.randn(
                trainer.model_state.shape, generator=trainer.generator, device=device)

        def one_step():
            leaves = {n: t.detach().clone().requires_grad_() for n, t in init.items()}
            if state is None:
                loss, new_state = model.loss(leaves, batch, trainer.generator), None
            else:
                loss, new_state = model.loss_stateful(leaves, state, batch, trainer.generator)
            loss.backward()
            return loss.item(), {n: t.grad for n, t in leaves.items()}, new_state

        before = prefix_cumsum.launches
        kernel = one_step()
        check(prefix_cumsum.launches == before + per_step,
              f"the kernel step launched {prefix_cumsum.launches - before}, not {per_step}")
        with plain_prefix_scan():
            plain = one_step()
        with plain_prefix_scan(float64=True):
            exact = one_step()
        check(prefix_cumsum.launches == before + per_step, "the plain steps launched")

        def outputs(step):
            loss, grads, new_state = step
            return {"loss": torch.tensor(loss), **grads,
                    **({} if new_state is None else {"S": new_state})}

        k_out, p_out, e_out = (outputs(s) for s in (kernel, plain, exact))
        scale = max(g.abs().max().item() for n, g in p_out.items() if n not in ("loss", "S"))
        rows = []
        for n, want in p_out.items():
            base = (STEP_LOSS_RTOL * abs(want.item()) if n == "loss" else S_STEP_ATOL if n == "S"
                    else STEP_RTOL * want.abs().max().item() + STEP_ATOL * scale)
            diff = (k_out[n] - want).abs().max().item()
            spread = (want - e_out[n]).abs().max().item()
            rows.append((diff / max(base, SPREAD_FACTOR * spread), n, diff, base, spread))
        worst = max(rows)
        say(step_phase, f"one {name} step of {batch.users.shape[0]} edges on a float32 R, kernel "
            f"vs plain prefix sum on the same batch and negatives"
            f"{' and S' if state is not None else ''}: K4 launches {per_step}; loss "
            f"{kernel[0]:.7f} vs {plain[0]:.7f}; worst output {worst[1]} at {worst[0]:.3f} of its "
            f"bound (max abs diff {worst[2]:.3e}; the larger of {worst[3]:.3e} and "
            f"{SPREAD_FACTOR:g} x the plain path's spread from float64 prefixes {worst[4]:.3e})"
            + "".join(f"; {n} diff {d:.2e} spread {sp:.2e}" for _, n, d, _, sp in rows
                      if n in ("loss", "S")))
        check(worst[0] <= 1.0, f"{name} step disagrees")
        del kernel, plain, exact, k_out, p_out, e_out, model, trainer, init
        torch.cuda.empty_cache()

        # 23 / 26 / 29. profile: where one step's device time goes -----------
        model, trainer, init, batch = setup(scfg.graph_compute_dtype)
        params = {n: t.detach().clone().requires_grad_() for n, t in init.items()}
        opt = trainer.make_optimizer(params)
        torch.cuda.reset_peak_memory_stats()
        device_profile(
            "profile", f"one {name} training step of {scfg.batch_size} edges ({per_step} K4 "
            "launches, forward and backward, Adam)",
            lambda: trainer.train_step(params, opt, batch),
            os.path.join(args.out_dir, f"chip_smoke_{phase}_step_profile.txt"),
            groups={"K4 (prefix_scan: lookback_scan_kernel)": ("lookback_scan",),
                    "gathers, scatters and bag sums (seg_gather, permute gathers, pointer "
                    "differences, row gathers and their backward, softmax sums)": (
                        "index", "scatter", "gather", "embeddingbag"),
                    "GEMMs": ("gemm", "nvjet", "cutlass", "xmma"),
                    "reductions (norms, sums, softmax)": ("reduce_kernel", "softmax")})
        say("profile", f"{name} step peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        del params, opt, model, trainer, init
        torch.cuda.empty_cache()
    return launches


def path_config(name: str, args):
    """(Config, dataset name) of ``name`` as this script's CLI runs train
    it: CF_Diff at MODEL_CONFIG on the baby-sized set, every other model at
    its Model_YAML file's first combo on the sports-sized set."""
    from chaorec_tpu_torch.config import Config

    if name == "CF_Diff":
        return Config(data_path=DATASET, seed=args.seed, batch_size=TRAIN_BATCH,
                      **MODEL_CONFIG), DATASET
    return (Config(Model=name, data_path=FREEDOM_DATASET, seed=args.seed)
            .replace(**first_combo(name)[0]), FREEDOM_DATASET)


def seeded_run(cfg, ds, device, steps=None):
    """(losses, rank list, seconds) of a fresh Trainer on ``cfg``'s seed:
    pre_epoch, then one whole epoch (``steps`` None) or its first
    ``steps`` batches, then ``evaluate``; all under the trainer's
    deterministic mode, where the package has one."""
    from chaorec_tpu_torch.data.sampling import make_edge_batches, sample_negatives
    from chaorec_tpu_torch.models import build_model
    from chaorec_tpu_torch.train import loop

    t0 = time.perf_counter()
    model = build_model(cfg, ds, device)
    trainer = loop.Trainer(model, ds, cfg)
    params = trainer.init_params()
    opt = trainer.make_optimizer(params)
    with getattr(loop, "deterministic_mode", contextlib.nullcontext)():
        model.pre_epoch(params, 0)
        if steps is None:
            losses = [trainer.train_epoch(params, opt)]
        else:
            batches = make_edge_batches(trainer.generator, trainer.edges, cfg.batch_size)
            losses = []
            for batch in batches[:steps]:
                neg = sample_negatives(trainer.generator, batch.users, trainer.history,
                                       model.num_item, int(cfg.neg_candidates))
                losses.append(trainer.train_step(params, opt,
                                                 dataclasses.replace(batch, neg_items=neg)))
            losses = torch.stack([x.detach() for x in losses]).cpu().numpy()
        rank = trainer.evaluate(params)[2].cpu().numpy()
    torch.cuda.synchronize()
    return np.asarray(losses, np.float32), rank, time.perf_counter() - t0


def determinism_phase(args, device, datasets) -> dict:
    """Phase 30: each model twice from a fresh Trainer on one seed at the
    path's shapes (CF_Diff one epoch, the others DET_STEPS steps), then an
    evaluation: the losses' bits and the rank lists must be equal. One JSON
    line per model; returns {model: that line}."""
    out = {}
    for name in DET_MODELS:
        cfg, ds_name = path_config(name, args)
        steps = None if name == "CF_Diff" else DET_STEPS
        (l1, r1, s1), (l2, r2, s2) = (seeded_run(cfg, datasets[ds_name], device, steps)
                                      for _ in range(2))
        line = {"determinism": name, "steps": "1 epoch" if steps is None else steps,
                "equal_loss_bits": bool(np.array_equal(l1.view(np.int32), l2.view(np.int32))),
                "equal_rank_lists": bool(np.array_equal(r1, r2)),
                "finite": bool(np.isfinite(l1).all()), "seconds": [round(s1, 3), round(s2, 3)]}
        print(json.dumps(line), flush=True)
        check(line["equal_loss_bits"] and line["equal_rank_lists"] and line["finite"],
              f"{name}: two runs on one seed differ: {line}")
        out[name] = line
        torch.cuda.empty_cache()
    return out


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
    from chaorec_tpu_torch.train.loop import deterministic_mode

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
            library = ""
            if keep == 1.0:  # one library call computes the same function only without dropout
                lib_ms, lib_out = sdpa_ms(q, k, v)
                bms, by = attn_bound(shape)
                library = (f", scaled_dot_product_attention {lib_ms:.4f} ms (max abs diff from the "
                           f"kernel {(lib_out - got).abs().max().item():.3e}), bound {bms:.4f} ms ({by})")
            say("kernel", f"fwd {shape} keep {keep}: max_abs_err {err:.3e} (bound {ATTN_TOL:g}), "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{library}")
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
    chunk_sdpa_ms, sdpa_out = sdpa_ms(q, k, v)
    sdpa_err = (sdpa_out - got).abs().max().item()
    chunk_bound = attn_bound((chunk, 4, 1034, 1034, 4))
    say("kernel", f"export chunk ({chunk}, 4, 1034, 1034, 4) keep 1.0: max_abs_err {err:.3e}, "
        f"kernel {chunk_ms:.3f} ms, plain in 64-row slices {chunk_plain_ms:.3f} ms, "
        f"scaled_dot_product_attention {chunk_sdpa_ms:.3f} ms (max abs diff "
        f"from the kernel {sdpa_err:.3e}), bound {chunk_bound[0]:.3f} ms ({chunk_bound[1]})")
    del q, k, v, got, sdpa_out

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
    again = torch.autograd.grad(out, (q, k, v), dout, retain_graph=True)
    check(all(torch.equal(a, b) for a, b in zip(grads, again)),
          "fused_mha_bwd gave other bits on a second run at the training batch")
    del again
    scratch_mb = q.shape[0] * q.shape[1] * q.shape[2] * math.ceil(k.shape[2] / 32) * 4 / 1e6
    say("kernel", f"training batch backward: the same bits on a second run; keep-bit scratch "
        f"{scratch_mb:.1f} MB (int32 words, (B h, Lq, ceil(Lk / 32)))")
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
    train_shape = (TRAIN_BATCH, 4, 1034, 1034, 4)
    train_fwd_bound, train_bwd_bound = attn_bound(train_shape), attn_bound(train_shape, True)
    say("kernel", f"training batch bounds: fwd {train_fwd_bound[0]:.3f} ms "
        f"({train_fwd_bound[1]}), bwd {train_bwd_bound[0]:.3f} ms ({train_bwd_bound[1]})")

    # the row-sparse Adam and the streaming logsumexp: held to their plain
    # paths, then timed
    row_adam = row_adam_phase(gen, device)
    lse = lse_phase(gen, device)

    # 4. slice: export over every user ----------------------------------
    t0 = time.perf_counter()
    ds = (data_load(DATASET, args.data_root) if args.data_root
          else synthetic_dataset(DATASET, args.seed))
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

    @deterministic_mode()  # as the trainer steps
    def train_step():
        opt.zero_grad(set_to_none=True)
        loss, _ = model.loss_stateful(leaves, step_state, full, step_gen)
        loss.backward()
        opt.step()

    device_profile("profile", f"one training step of {TRAIN_BATCH} users (forward, backward, "
                   "Adam)", train_step, os.path.join(args.out_dir, "chip_smoke_train_profile.txt"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train_step()
    torch.cuda.synchronize()
    say("profile", f"one training step of {TRAIN_BATCH} users: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    del leaves, opt, params, full, step_state, model
    torch.cuda.empty_cache()

    fds = sports_dataset(args)
    freedom_launches, bf16_launches = freedom_phases(args, device, fds)
    ssl_launches = ssl_phases(args, device, fds)
    k4 = scan_phase(gen, device, fds)
    seg_launches = seg_phases(args, device, fds)
    t0 = time.perf_counter()
    determinism_phase(args, device, {DATASET: ds, FREEDOM_DATASET: fds})
    say("determinism", f"{len(DET_MODELS)} models twice on one seed: equal loss bits and rank "
        f"lists; {time.perf_counter() - t0:.1f} s added to the run")

    # result -----------------------------------------------------------
    # One entry per path and shape; each path's launches are its own run's
    # (the CF_Diff export of phase 4, the CLI runs of phases 7, 10, 14, 21,
    # 24 and 27, the bf16 epoch of phase 13).
    fwd = dict(route="cuda", source="chaorec_tpu_torch/csrc/fused_mha.cu",
               replaces="chaorec_tpu/ops/pallas_attn.py:65")
    no_library = "no PyTorch call draws this Philox dropout mask"
    entries = [
        {"name": "fused_mha@export", **fwd, "shape": [chunk, 4, 1034, 1034, 4],
         "keep_prob": 1.0, "launches": export_counts[0], "max_abs_err": fwd_err[1.0],
         "ms": chunk_ms, "plain_ms": chunk_plain_ms, "bound_ms": chunk_bound[0],
         "bound_by": chunk_bound[1], "library_ms": chunk_sdpa_ms,
         "note": "library: scaled_dot_product_attention, one call"},
        {"name": "fused_mha@train", **fwd, "shape": list(train_shape),
         "keep_prob": 0.5, "launches": train_launches[0], "max_abs_err": fwd_err[0.5],
         "ms": train_fwd_ms, "plain_ms": train_fwd_plain_ms, "bound_ms": train_fwd_bound[0],
         "bound_by": train_fwd_bound[1], "library_ms": None,
         "note": "launches: the CLI run's training forwards at keep 0.5 and its eval "
                 f"and export forwards at keep 1.0; {no_library}"},
        {"name": "fused_mha_bwd@train", "route": "cuda",
         "source": "chaorec_tpu_torch/csrc/fused_mha_bwd.cu",
         "replaces": "chaorec_tpu/ops/pallas_attn.py:82",
         "shape": list(train_shape), "keep_prob": 0.5,
         "launches": train_launches[1], "max_abs_err": bwd_err, "ms": train_bwd_ms,
         "plain_ms": train_bwd_plain_ms, "bound_ms": train_bwd_bound[0],
         "bound_by": train_bwd_bound[1], "library_ms": None,
         "note": "one launch is one backward call: the dq kernel (which draws each keep bit "
                 f"once into a scratch), then the dk/dv kernel (which reads it); {no_library}"},
    ]
    for dtype, launches, run in (("float32", freedom_launches, "the FREEDOM CLI run's"),
                                 ("bfloat16", bf16_launches, "the bf16 epoch's")):
        for name, shape in ROW_ADAM_SHAPES:
            entries.append({
                "name": f"fused_row_adam@train[{name}{'' if dtype == 'float32' else ',bf16'}]",
                "route": "cuda", "source": "chaorec_tpu_torch/csrc/row_adam.cu",
                "replaces": "chaorec_tpu/ops/pallas_row_adam.py:44", "shape": list(shape),
                "dtype": dtype, "launches": launches, **row_adam[name, dtype],
                "note": f"launches: {run} count over both tables (one launch per table per "
                        "step); library: zeros + index_add_ + Adam(fused=True).step"})
    nl = ssl_launches["NCL"]
    for side, (b, n, e, temp, _) in LSE_MAIN.items():
        for i, (kernel, line) in enumerate((("fwd", 44), ("dq", 95), ("dk", 116))):
            entries.append({
                "name": f"streaming_lse_{kernel}@sgl[{side}]", "route": "cuda",
                "source": "chaorec_tpu_torch/csrc/streaming_lse.cu",
                "replaces": f"chaorec_tpu/ops/pallas_lse.py:{line}", "shape": [b, n, e],
                "temperature": temp, "launches": ssl_launches["SGL"][i],
                "max_abs_err": lse["max_abs_err"][kernel], **lse[side][kernel],
                "note": f"launches: the SGL CLI run's, both sides (the NCL run's: {nl[i]}); one "
                        "launch is the kernel and its combine pass; library: no single "
                        "PyTorch call computes this: torch.mm and torch.logsumexp"
                        f"{'' if kernel == 'fwd' else ' and their autograd'}, timed together"})
    seg_names = {"dgcf": "DGCF", "dccf": "DCCF", "mgat_v": "MGAT", "mgat_t": "MGAT",
                 "mgat": "MGAT"}
    for name, (m, d) in scan_shapes(fds).items():
        model = seg_names[name]
        entries.append({
            "name": f"prefix_scan@{name}", "route": "cuda",
            "source": "chaorec_tpu_torch/csrc/prefix_scan.cu",
            "replaces": "chaorec_tpu/ops/pallas_scan.py:49", "shape": [m, d],
            "launches": seg_launches[model], **k4[name],
            "note": f"launches: the {model} CLI run's, over all its shapes (one launch is a "
                    "memset of its scratch and the one-pass kernel); ms: 20 calls back to back; "
                    "graph_ms: 20 calls in one CUDA graph; library: torch.cumsum, one call"})
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
