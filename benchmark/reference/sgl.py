"""SGL's training loss, plain (Wu et al., SIGIR 2021; the reference
implementation's Model/SGL.py).

- the ranking tables: the mean of layers 0..L of the normalized graph;
- two edge-dropout views a step, each keeping 1 - ssl_ratio of the edges,
  the degrees counted again over the kept edges, the same mean of layers;
- BPR with 1e-5 inside the log, reg_weight times the mean-style L2 of the
  raw rows of the batch's users, positives and negatives;
- ssl_alpha times the full-catalog InfoNCE of the two views' unit rows at
  temperature ssl_temp, summed over the batch's users and positives:
  logsumexp(q / t @ k.T) - q . k / t, with k the whole table of view 2.
"""

from __future__ import annotations

import torch

from benchmark.reference.common import (bpr, l2_rows, l2norm, matmul_precision,
                                        mean_of_layers)
from benchmark.harness.peaks import bpr_flops, contrast_flops, propagation_flops

SSL_RATIO = 0.1
VIEWS = 2


def draws(combo):
    """(keep masks a step, keep probability)."""
    return VIEWS, 1.0 - SSL_RATIO


def loss(params, graph, rows, combo, prec):
    xu, xi = params["user_embedding"], params["item_embedding"]
    n = int(combo["n_layers"])
    w = rows.weights
    user_emb, item_emb = mean_of_layers(xu, xi, graph.main_hop(prec), n)
    u, pos, neg = user_emb[rows.users], item_emb[rows.pos], item_emb[rows.neg]
    total = (bpr(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w, 1e-5)
             + l2_rows(float(combo["reg_weight"]), (xu[rows.users], xi[rows.pos], xi[rows.neg]), w))
    views = []
    for keep in rows.keeps:
        kw = graph.kept_weights(keep)
        views.append(mean_of_layers(
            xu, xi, lambda a, b, kw=kw: graph.hop(a, b, kw, prec.views_in), n))
    (u1, i1), (u2, i2) = [(l2norm(a), l2norm(b)) for a, b in views]
    t = float(combo["ssl_temp"])
    bu1, bu2, bi1, bi2 = u1[rows.users], u2[rows.users], i1[rows.pos], i2[rows.pos]
    with matmul_precision(prec.contrast):
        c_u = torch.logsumexp((bu1 / t) @ u2.t(), dim=1) - torch.sum(bu1 * bu2, 1) / t
        c_i = torch.logsumexp((bi1 / t) @ i2.t(), dim=1) - torch.sum(bi1 * bi2, 1) / t
    return total + float(combo["ssl_alpha"]) * torch.sum((c_u + c_i) * w)


def k2_calls(combo, num_user, num_item, batch):
    """The (B, N, E) of each catalog logsumexp a step: users, then items."""
    d = int(combo["dim_E"])
    return [(batch, num_user, d), (batch, num_item, d)]


def step_flops(combo, num_user, num_item, num_edges, batch):
    d, n = int(combo["dim_E"]), int(combo["n_layers"])
    graphs = 1.0 + VIEWS * (1.0 - SSL_RATIO)  # the main graph and the views' expected edges
    return (propagation_flops(graphs * num_edges, d, n) + bpr_flops(batch, d)
            + sum(contrast_flops(*c) for c in k2_calls(combo, num_user, num_item, batch)))
