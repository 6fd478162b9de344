#!/usr/bin/env python3
"""How far each summation order of the segment sums' prefix moves Grade's
loss_1 gradients, against the same step with prefixes summed in float64
and rounded once.

One ``loss_1`` of Grade as ``chip_smoke.py`` phase 46 takes it (its seeded
2048 x 1024 set with the synthetic 4096- and 384-wide features, Grade's
first Model_YAML combo, 5 layers, a float32 R, the first batch of 1024
edges and its draws, the CPU's kNN graph on both devices), every gradient
taken with the prefix of ``ops/ell.seg_sum`` in one order:

- ``k4``: the kernel ``csrc/prefix_scan.cu`` (the card only);
- ``kernel_order``: the kernel's order modelled in numpy on the host
  (``ops/prefix_scan.kernel_order``, bit for bit the kernel's);
- ``sequential``: ``torch.cumsum`` on the card, which adds a column's rows
  one after another in float32 (the card only);
- ``once``: summed in float64 on the host and rounded once (the reference).

The card's runs are held to the CPU's side of every ReLU kink and cut
(``chip_smoke.Kinks``, ``Cuts``) recorded on the CPU's ``once`` run, and
run outside the trainer's deterministic mode (``torch.cumsum`` of a CUDA
float raises inside it). Each line gives, for uEmbeds and for the worst
leaf, the largest difference from the same device's ``once`` run as a
share of the gradient tensor's largest entry.

    python3 scripts/probe_grade_prefix_order.py [--device cpu]

Without a card, or with ``--device cpu``, only the host's orders run.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from chaorec_tpu_torch.data.sampling import make_edge_batches  # noqa: E402
from chaorec_tpu_torch.models import build_model  # noqa: E402
from chaorec_tpu_torch.ops import ell  # noqa: E402
from chaorec_tpu_torch.ops.prefix_scan import prefix_cumsum_kernel_order  # noqa: E402
from chaorec_tpu_torch.params import clone_to  # noqa: E402


@contextlib.contextmanager
def prefix_by(fn):
    """The segment sums' prefix through ``fn(v, out=None)``."""
    plain = ell.prefix_cumsum
    ell.prefix_cumsum = fn
    try:
        yield
    finally:
        ell.prefix_cumsum = plain


def once(v, out=None):
    r = torch.cumsum(v.detach().double().cpu(), 0).float().to(v.device)
    return r if out is None else out.copy_(r)


def sequential(v, out=None):
    r = torch.cumsum(v.float(), 0)
    return r if out is None else out.copy_(r)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda" if torch.cuda.is_available() else "cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(args.device)
    sds = cs.synthetic_dataset(cs.LINEAR_DATASET, args.seed + 1, shape=cs.STEP_SHAPE,
                               features=True)
    cfg, _ = cs.path_config("Grade", args)
    cfg = cfg.replace(graph_compute_dtype="float32")
    cpu_model = build_model(cfg, sds, "cpu")
    models = {"cpu": cpu_model}
    if dev.type == "cuda":
        card = build_model(cfg, sds, dev)
        g = cpu_model.mm_graph
        card.mm_graph = dataclasses.replace(g, indices=g.indices.to(dev),
                                            weights=g.weights.to(dev))
        models["card"] = card
    trainer = cpu_model.trainer_cls(cpu_model, sds, cfg)._base
    params = trainer.init_params()
    batch = trainer.bpr_batch(make_edge_batches(trainer.generator, trainer.edges,
                                                cfg.batch_size)[0])
    draws = cpu_model.draws(trainer.generator, batch)
    kinks, cuts = cs.Kinks(), cs.Cuts()

    def grads(side, order, pins):
        m = models[side]
        on = m.device
        leaves = {k: v.detach().to(on, copy=True).requires_grad_() for k, v in params.items()}
        with prefix_by(order), cs.pinned_sides(*pins):
            loss = m.loss_1(leaves, cs.batch_to(batch, on), clone_to(draws, on))
            got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        return {k: torch.zeros(v.shape) if g is None else g.cpu()
                for (k, v), g in zip(leaves.items(), got)}

    ref = {"cpu": grads("cpu", once, (kinks.record(), cuts.record()))}
    runs = [("cpu", "kernel_order", prefix_cumsum_kernel_order)]
    if "card" in models:
        ref["card"] = grads("card", once, (kinks.replay(), cuts.replay()))
        runs += [("card", "k4", ell.prefix_cumsum),
                 ("card", "kernel_order", prefix_cumsum_kernel_order),
                 ("card", "sequential", sequential)]
    for side, name, order in runs:
        got = grads(side, order, (kinks.replay(), cuts.replay()))
        shares = {k: ((got[k] - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
                  for k, w in ref[side].items()}
        worst = max(shares, key=shares.get)
        print(f"{side:4s} {name:13s}: uEmbeds {shares['uEmbeds']:.3e} of its largest entry; "
              f"worst {worst} {shares[worst]:.3e}; ReLU units on the other side "
              f"{kinks.flips}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
