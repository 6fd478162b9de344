"""HCCF: hypergraph-enhanced contrastive CF.

Counterpart of ``chaorec_tpu/models/hccf.py`` (reference: Model/HCCF.py):

- each layer: a propagation on the normalized adjacency, its edge values
  dropped at 1 - keepRate and scaled 1/keepRate without renormalizing, plus
  the hypergraph channel ``H (H^T x)`` with ``H = mult * ego`` dropped
  elementwise at 1 - keepRate (Model/HCCF.py:54-61, 117-139; the learnable
  uHyper variant is commented out in the reference);
- a layer's state is gcn + hyper, the final embedding the SUM of the layer
  states with the ego (Model/HCCF.py:135-140);
- ssl: per layer i in 0..L-1, InfoNCE of the detached gcn list's entry i
  against the hyper list's at the batch's rows, in-batch negatives (both
  lists start with the ego, Model/HCCF.py:159-166, 190-197);
- BPR (1e-5 inside the log) and the mean reg on the final rows; total =
  bpr + ssl_alpha * ssl + reg.

At keepRate 1 (the first combo) nothing is drawn and a layer's
propagation is the graph's own. Below it, ``draws`` draws each layer's
edge masks (both edge orders of the graph) and hyper masks, and the
dropped propagation builds the two dense (U, I) and (I, U) matrices, as
the JAX package does. ``loss_with_draws`` takes the masks, so a test can
give both packages the same ones.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import xavier_uniform
from chaorec_tpu_torch.ops.losses import bpr_loss, emb_l2_reg, l2norm

LayerDraws = Dict[str, torch.Tensor]  # edge_u, edge_i, hyper_u, hyper_i: 0/1 float32


def ssl_pair(e1: torch.Tensor, e2: torch.Tensor, rows: torch.Tensor, temp: float,
             weights: torch.Tensor) -> torch.Tensor:
    """Weighted mean over the batch's rows of logsumexp of the in-batch
    logits minus the positive's, both views L2-normalized after + 1e-8."""
    p1 = l2norm(e1 + 1e-8)[rows]
    p2 = l2norm(e2 + 1e-8)[rows]
    nume = torch.sum(p1 * p2, dim=-1) / temp
    deno = torch.logsumexp((p1 @ p2.T) / temp, dim=-1)
    return torch.sum((deno - nume) * weights) / torch.clamp(torch.sum(weights), min=1.0)


class HCCF(RecModel):
    name = "HCCF"
    hyper_num = 128  # Model/HCCF.py:32, the width of the inactive learnable variant

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph, dim_E: int,
                 reg_weight: float, n_layers: int, ssl_alpha: float, ssl_temp: float,
                 keep_rate: float, leaky: float, mult: float):
        super().__init__(num_user, num_item)
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.n_layers = n_layers
        self.ssl_alpha = ssl_alpha
        self.ssl_temp = ssl_temp
        self.keep_rate = keep_rate
        self.leaky = leaky
        self.mult = mult

    def init_params(self, generator: torch.Generator) -> Params:
        return {
            "user_embedding": xavier_uniform(generator, (self.num_user, self.dim_E)),
            "item_embedding": xavier_uniform(generator, (self.num_item, self.dim_E)),
        }

    def draws(self, generator: torch.Generator, batch: Batch = None,
              state=None) -> Optional[List[LayerDraws]]:
        """Each layer's keep masks (edges in the graph's user order and in
        its item order, then the user and item hyper incidences), or None
        at keepRate 1, where nothing is dropped."""
        if self.keep_rate >= 1.0:
            return None
        g, keep, dev = self.graph, self.keep_rate, self.device

        def mask(shape):
            return (torch.rand(shape, generator=generator, device=dev) < keep).float()

        return [{"edge_u": mask(g.w_by_u.shape), "edge_i": mask(g.w_by_i.shape),
                 "hyper_u": mask((self.num_user, self.dim_E)),
                 "hyper_i": mask((self.num_item, self.dim_E))}
                for _ in range(self.n_layers)]

    def _dropped_propagate(self, d: LayerDraws, xu: torch.Tensor, xi: torch.Tensor):
        """The propagation on the edge-dropped adjacency, values scaled
        1/keepRate: two dense matrices, one a side, as the JAX package."""
        g, keep = self.graph, self.keep_rate
        r_u = torch.zeros((self.num_user, self.num_item), device=self.device).index_put_(
            (g.u_by_u, g.i_by_u), g.w_by_u.float() * d["edge_u"] / keep, accumulate=True)
        r_i = torch.zeros((self.num_item, self.num_user), device=self.device).index_put_(
            (g.i_by_i, g.u_by_i), g.w_by_i.float() * d["edge_i"] / keep, accumulate=True)
        return r_u @ xi, r_i @ xu

    def forward(self, params: Params, draws: Optional[List[LayerDraws]] = None):
        eu, ei = params["user_embedding"], params["item_embedding"]
        hu, hi = eu * self.mult, ei * self.mult  # the hyper incidences (U, D), (I, D)
        cur_u, cur_i = eu, ei
        acc_u, acc_i = eu, ei
        gcn_u, gcn_i, hyp_u, hyp_i = [eu], [ei], [eu], [ei]
        for layer in range(self.n_layers):
            if draws is not None:
                d = draws[layer]
                gu, gi = self._dropped_propagate(d, cur_u, cur_i)
                dhu = hu * d["hyper_u"] / self.keep_rate
                dhi = hi * d["hyper_i"] / self.keep_rate
            else:
                gu, gi = self.graph.propagate(cur_u, cur_i)
                dhu, dhi = hu, hi
            yu = dhu @ (dhu.T @ cur_u)  # H (H^T x)
            yi = dhi @ (dhi.T @ cur_i)
            gcn_u.append(gu)
            gcn_i.append(gi)
            hyp_u.append(yu)
            hyp_i.append(yi)
            cur_u, cur_i = gu + yu, gi + yi
            acc_u, acc_i = acc_u + cur_u, acc_i + cur_i
        return acc_u, acc_i, (gcn_u, gcn_i, hyp_u, hyp_i)

    def loss_with_draws(self, params: Params, batch: Batch,
                        draws: Optional[List[LayerDraws]]) -> torch.Tensor:
        w = batch.weights
        acc_u, acc_i, (gu_l, gi_l, hu_l, hi_l) = self.forward(params, draws)
        u = acc_u[batch.users]
        pos = acc_i[batch.pos_items]
        neg = acc_i[batch.neg_items]
        bpr = bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w, eps=1e-5)
        reg = emb_l2_reg(self.reg_weight, (u, pos, neg), w)
        ssl = 0.0
        for i in range(self.n_layers):
            ssl = ssl + ssl_pair(gu_l[i].detach(), hu_l[i], batch.users, self.ssl_temp, w) \
                + ssl_pair(gi_l[i].detach(), hi_l[i], batch.pos_items, self.ssl_temp, w)
        return bpr + self.ssl_alpha * ssl + reg

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        return self.loss_with_draws(params, batch, self.draws(generator, batch))

    def embeddings(self, params: Params):
        acc_u, acc_i, _ = self.forward(params)
        return acc_u, acc_i
