#!/usr/bin/env python3
"""Find which operation of MCLN's training step loses precision on a CUDA
card, against the CPU's step in float64.

One MCLN step as ``chip_smoke.py`` phase 37 takes it (its seeded 2048 x
1024 set with the synthetic 4096- and 384-wide features, MCLN's first
Model_YAML combo, a float32 R, the first batch of 1024 edges with its
interest items) is taken with each of its operations in float32 or in
float64, on the CPU and on the card:

- ``modal``: the feature projections; ``backbone``: the LightGCN layers;
  ``proj``: the attention's V, K and Q maps (and the interest items' K
  and Q); ``scores``: ``q k^T / sqrt(3d)``; ``softmax``; ``attn``: the
  softmax times V, then the cfl map; ``ln``: the three LayerNorms;
  ``ff``: the feed-forward's two maps;
- ``f32+X``: every operation in float32 but X in float64; ``f64-X``:
  every operation in float64 but X in float32; ``f32``, ``f64``: all in
  one dtype; ``f32 tf32``: all in float32 with TF32 products allowed (the
  card only); ``f64 ulp``: the float64 step from params and features each
  moved by one float32 ulp at random (the CPU only), which shows how far
  the step itself amplifies a rounding of its inputs; ``mcln``: the
  model's own float32 step (the probe's ``f32`` takes the same sums, its
  backward's in another order); ``f32 cpu:X``: the card's float32 step
  with X, forward and backward, taken on the CPU; ``... pinned``: the
  step held to the float64 step's side of every ReLU kink
  (``chip_smoke.Kinks``).

Each operation is computed in its dtype, forward and backward, and its
result is cast back to the step's dtype. Every line gives, for the
attention and feed-forward weights and for the worst leaf, each
gradient's largest error against the CPU's float64 step as a share of
``chip_smoke.py``'s step bound (1e-4 of the tensor's largest entry plus
1e-6 of the whole gradient's largest), and ``kink_flips``, the number of
ReLU units on the other side of 0 than in the float64 step.

    python3 scripts/probe_mcln_precision.py [--device cpu] [--out FILE]

Without a card, or with ``--device cpu``, only the CPU's lines are taken.
``--out`` also writes the lines as JSON, one a variant.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from chaorec_tpu_torch.models import build_model  # noqa: E402
from chaorec_tpu_torch.models.mcln import MCLN, layer_norm  # noqa: E402
from chaorec_tpu_torch.train.loop import Trainer, deterministic_mode  # noqa: E402

OPS = ("modal", "backbone", "proj", "scores", "softmax", "attn", "ln", "ff")
SHOWN = ("K1_w", "Q1_w", "V1_w", "K_int_w", "Q_int_w", "cfl1_w", "K2_w", "Q2_w", "inner_w",
         "output_w")


class ProbeMCLN(MCLN):
    """MCLN's step with each operation in a dtype of its own: ``base`` for
    all but the operations in ``flip``, which run in ``other``."""

    def __init__(self, model: MCLN, base: torch.dtype, flip=(), on_cpu=(), cpu_model=None):
        self.__dict__.update(model.__dict__)
        self.base = base
        self.other = torch.float64 if base == torch.float32 else torch.float32
        self.flip, self.on_cpu = set(flip), set(on_cpu)
        self.graphs, self.feats = {}, {}
        for m in (model, cpu_model or model):
            for dt in (torch.float32, torch.float64):
                key = (m.device.type, dt)
                self.graphs[key] = dataclasses.replace(m.graph, dense_r=m.graph.dense_r.to(dt))
                self.feats[key] = (m.v_feat.to(dt), m.t_feat.to(dt))

    def at(self, op, fn, *xs):
        dt = self.other if op in self.flip else self.base
        dev = torch.device("cpu") if op in self.on_cpu else self.device
        out = fn(*(x.to(dev, dt) for x in xs))
        if isinstance(out, tuple):
            return tuple(o.to(self.device, self.base) for o in out)
        return out.to(self.device, self.base)

    def _modal(self, params):
        def modal(vw, vb, tw, tb):
            v, t = self.feats[(vw.device.type, vw.dtype)]
            return v @ vw.t() + vb, t @ tw.t() + tb
        return self.at("modal", modal, params["image_trs_w"], params["image_trs_b"],
                       params["text_trs_w"], params["text_trs_b"])

    def _backbone(self, params):
        def backbone(xu, xi):
            graph = self.graphs[(xu.device.type, xu.dtype)]
            acc_u, acc_i = xu, xi
            for _ in range(self.n_layers):
                xu, xi = graph.dense_r @ xi, graph.dense_r.t() @ xu  # graph.propagate
                acc_u = acc_u + xu
                acc_i = acc_i + xi
            s = 1.0 / (self.n_layers + 1)
            return acc_u * s, acc_i * s
        return self.at("backbone", backbone, params["user_embedding"], params["item_embedding"])

    def _ff(self, params, x):
        h = self.at("ff", lambda x, w1, b1, w2, b2: F.relu(x @ w1.t() + b1) @ w2.t() + b2, x,
                    params["inner_w"], params["inner_b"], params["output_w"], params["output_b"])
        return self.at("ln", layer_norm, h + x, params["ln_ff_scale"], params["ln_ff_bias"])

    def _cf(self, params, x, x_int=None):
        n = "1" if x_int is not None else "2"
        scale = 1.0 / math.sqrt(x.shape[-1])

        def proj(name, a):
            return self.at("proj", lambda a, w: a @ w.t(), a, params[name])

        def scores(q, k):
            return self.at("scores", lambda q, k: (q @ k.t()) * scale, q, k)

        out = x
        for _ in range(self.n_mca):
            v, k, q = proj(f"V{n}_w", out), proj(f"K{n}_w", out), proj(f"Q{n}_w", out)
            score = scores(q, k)
            if x_int is not None:
                score = score - scores(proj("Q_int_w", x_int), proj("K_int_w", x_int))
            p = self.at("softmax", lambda s: torch.softmax(s, -1), score)
            cl = self.at("attn", lambda p, v, w: p @ v @ w.t(), p, v, params[f"cfl{n}_w"]) + out
            out = self._ff(params, self.at("ln", layer_norm, cl, params[f"ln{n}_scale"],
                                           params[f"ln{n}_bias"]))
        return out


def step(model, params, batch, device, kinks=contextlib.nullcontext()):
    """(loss, {leaf: gradient as a float64 CPU tensor}) of one step, under
    ``kinks`` (a ``chip_smoke.Kinks`` mode)."""
    leaves = {n: t.detach().to(device=device, dtype=model.base, copy=True).requires_grad_()
              for n, t in params.items()}
    on = cs.batch_to(batch, device)
    on = dataclasses.replace(on, weights=on.weights.to(model.base))
    with deterministic_mode(), kinks:
        loss = model.loss(leaves, on, None)
        loss.backward()
    return loss.item(), {n: (torch.zeros_like(t) if t.grad is None else t.grad).double().cpu()
                         for n, t in leaves.items()}


def own_step(model, params, batch, device, kinks):
    """``step`` through MCLN's own loss, in float32."""
    leaves = {n: t.detach().to(device, copy=True).requires_grad_() for n, t in params.items()}
    with deterministic_mode(), kinks:
        loss = model.loss(leaves, cs.batch_to(batch, device), None)
        loss.backward()
    return loss.item(), {n: (torch.zeros_like(t) if t.grad is None else t.grad).double().cpu()
                         for n, t in leaves.items()}


def shares(got, want):
    """{leaf: largest error over the step bound} and the worst leaf."""
    scale = max(w.abs().max().item() for w in want.values())
    out = {n: (got[n] - w).abs().max().item()
           / (cs.STEP_RTOL * w.abs().max().item() + cs.STEP_ATOL * scale)
           for n, w in want.items()}
    return out, max(out, key=out.get)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda" if torch.cuda.is_available() else "cpu")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    devices = ["cpu"] + (["cuda"] if args.device == "cuda" else [])
    torch.backends.cuda.matmul.allow_tf32 = False

    sds = cs.synthetic_dataset(cs.LINEAR_DATASET, args.seed + 1, shape=cs.STEP_SHAPE,
                               features=True)
    cfg, _ = cs.path_config("MCLN", args)
    cfg = cfg.replace(graph_compute_dtype="float32")
    cpu_model = build_model(cfg, sds, "cpu")
    trainer = Trainer(cpu_model, sds, cfg)
    params = trainer.init_params()
    batch = cs.first_batch(trainer, cfg)
    models = {d: cpu_model if d == "cpu" else build_model(cfg, sds, d) for d in devices}

    kinks = cs.Kinks()
    ref_loss, ref = step(ProbeMCLN(cpu_model, torch.float64), params, batch, "cpu",
                         kinks.record())
    variants = [("f32", torch.float32, ()), ("f64", torch.float64, ())]
    variants += [(f"f32+{op}", torch.float32, (op,)) for op in OPS]
    variants += [(f"f64-{op}", torch.float64, (op,)) for op in OPS]
    lines = []

    def report(name, device, loss, grads):
        sh, worst = shares(grads, ref)
        line = {"variant": name, "device": device, "loss_rel": abs(loss - ref_loss) / abs(ref_loss),
                "kink_flips": kinks.flips, "worst": worst, "worst_share": sh[worst],
                **{n: round(sh[n], 4) for n in SHOWN}}
        lines.append(line)
        print(json.dumps(line), flush=True)

    for d in devices:  # MCLN's own step, as the trainer takes it
        report("mcln", d, *own_step(models[d], params, batch, d, kinks.compare()))
    for name, base, flip in variants:
        for d in devices:
            report(name, d, *step(ProbeMCLN(models[d], base, flip), params, batch, d,
                                  kinks.compare()))
    for d in devices:  # float32 on the float64 step's side of every kink
        report("f32 pinned", d, *step(ProbeMCLN(models[d], torch.float32), params, batch, d,
                                      kinks.replay()))
    if "cuda" in devices:
        torch.backends.cuda.matmul.allow_tf32 = True
        report("f32 tf32", "cuda", *step(ProbeMCLN(models["cuda"], torch.float32), params,
                                          batch, "cuda", kinks.compare()))
        report("f32 tf32 pinned", "cuda", *step(ProbeMCLN(models["cuda"], torch.float32),
                                                 params, batch, "cuda", kinks.replay()))
        torch.backends.cuda.matmul.allow_tf32 = False
        for op in OPS:  # the card's float32 step with one operation on the CPU
            report(f"f32 cpu:{op}", "cuda", *step(
                ProbeMCLN(models["cuda"], torch.float32, on_cpu=(op,), cpu_model=cpu_model),
                params, batch, "cuda", kinks.compare()))
    # one float32 ulp on every input, at random, through the float64 step
    gen = torch.Generator().manual_seed(args.seed)

    def nudge(t):
        return t.double() * (1 + 2.0 ** -24 * torch.randn(t.shape, generator=gen,
                                                          dtype=torch.float64))
    moved = ProbeMCLN(cpu_model, torch.float64)
    moved.feats[("cpu", torch.float64)] = (nudge(cpu_model.v_feat), nudge(cpu_model.t_feat))
    report("f64 ulp", "cpu", *step(moved, {n: nudge(t) for n, t in params.items()}, batch,
                                   "cpu", kinks.compare()))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    if "cuda" in devices:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
