"""LightGCN, plain (He et al., SIGIR 2020; the reference implementation's
Model/LightGCN.py): the mean of layers 0..L of the normalized graph, BPR
with 1e-5 inside the log and reg_weight times the mean-style L2 of the
propagated rows of the batch."""

from __future__ import annotations

import torch

from benchmark.reference.common import bpr, l2_rows, mean_of_layers
from benchmark.harness.peaks import bpr_flops, propagation_flops

# Read and printed, not held to a limit: at the draw every score is about 0
# and each step's loss is log 2 to a few ulps on every side, so nothing
# separates a fault from sound runs (PERF.md, the compared numbers).
NOT_COMPARED = {"loss_gap": "each step's loss is log 2 to a few ulps on every side"}


def draws(combo):
    return 0, 1.0


def embeddings(params, graph, combo, prec):
    return mean_of_layers(params["user_embedding"], params["item_embedding"],
                          graph.main_hop(prec), int(combo["n_layers"]))


def loss(params, graph, rows, combo, prec):
    user_emb, item_emb = embeddings(params, graph, combo, prec)
    u, pos, neg = user_emb[rows.users], item_emb[rows.pos], item_emb[rows.neg]
    w = rows.weights
    return (bpr(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w, 1e-5)
            + l2_rows(float(combo["reg_weight"]), (u, pos, neg), w))


def k2_calls(combo, num_user, num_item, batch):
    return []


def step_flops(combo, num_user, num_item, num_edges, batch):
    d, n = int(combo["dim_E"]), int(combo["n_layers"])
    return propagation_flops(num_edges, d, n) + bpr_flops(batch, d)
