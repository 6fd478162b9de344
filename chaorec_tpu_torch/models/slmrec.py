"""SLMRec: self-supervised multimodal learning with FAC tasks.

Counterpart of ``chaorec_tpu/models/slmrec.py`` (reference:
Model/SLMRec.py):

- three LightGCN towers over the shared user table: id items, the
  L2-normalized visual features through a Linear, the textual ones
  likewise (Model/SLMRec.py:39-52, 111-129). The reference normalizes its
  edges by degrees counted over the already doubled edge list, so its
  operator is 0.5 D^-1/2 A D^-1/2 (Model/SLMRec.py:80-90): each layer
  halves ``BipartiteGraph.propagate``'s output. One 3 dim_E-wide
  propagation serves the three towers;
- fusion: a Linear over the three towers' outputs side by side, per side
  (Model/SLMRec.py:54-57, 131-134);
- the main loss: ``in_batch_ce`` of the normalized (user, positive)
  rows at ssl_temp (Model/SLMRec.py:158-175);
- the FAC tasks over the positive items: chained projections, id against
  visual, then (id, visual) against textual, on raw logits
  (Model/SLMRec.py:66-78, 136-155); loss = main + ssl_alpha * FAC.
"""

from __future__ import annotations

from typing import Tuple

import torch

from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_normal, xavier_uniform
from chaorec_tpu_torch.ops.losses import l2norm, masked_mean


def in_batch_ce(a: torch.Tensor, b: torch.Tensor, temp: float,
                weights: torch.Tensor) -> torch.Tensor:
    """CrossEntropy(a @ b.T / temp, arange): each row of a against every
    row of b, its own row the target; a weighted mean over the rows."""
    logits = (a @ b.T) / temp
    return masked_mean(torch.logsumexp(logits, dim=1) - torch.diagonal(logits), weights)


def _normalized(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-12)


class SLMRec(RecModel):
    name = "SLMRec"
    FAC = (("g_i_iv", 1), ("g_v_iv", 1), ("g_iv_iva", 1), ("g_a_iva", 1), ("g_iva_ivat", 2),
           ("g_t_ivat", 2))  # (projection, output width divisor)

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph,
                 v_feat: torch.Tensor, t_feat: torch.Tensor, dim_E: int, n_layers: int,
                 ssl_temp: float, ssl_alpha: float):
        super().__init__(num_user, num_item)
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.n_layers = n_layers
        self.ssl_temp = ssl_temp
        self.ssl_alpha = ssl_alpha
        self.v_feat, self.t_feat = _normalized(v_feat), _normalized(t_feat)

    def init_params(self, generator: torch.Generator) -> Params:
        d = self.dim_E
        p = {"user_embedding": xavier_normal(generator, (self.num_user, d)),
             "item_embedding": xavier_normal(generator, (self.num_item, d))}
        for name, width in (("v_dense", self.v_feat.shape[1]), ("t_dense", self.t_feat.shape[1]),
                            ("after_u", 3 * d), ("after_i", 3 * d)):
            p[f"{name}_w"] = xavier_uniform(generator, (d, width))
            p[f"{name}_b"] = torch_linear_init(generator, d, width)[1]
        for name, div in self.FAC:
            p[f"{name}_w"] = xavier_uniform(generator, (d // div, d))
            p[f"{name}_b"] = torch_linear_init(generator, d // div, d)[1]
        return p

    def tower(self, xu: torch.Tensor, xi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The mean of the ego and its layers over the halved operator."""
        acc_u, acc_i = cu, ci = xu, xi
        for _ in range(self.n_layers):
            cu, ci = self.graph.propagate(cu, ci)
            cu, ci = 0.5 * cu, 0.5 * ci
            acc_u, acc_i = acc_u + cu, acc_i + ci
        s = 1.0 / (self.n_layers + 1)
        return acc_u * s, acc_i * s

    def forward(self, params: Params):
        """(fused users, fused items, (id, visual, textual) item towers)."""
        xu = params["user_embedding"]
        v_emb = self.v_feat @ params["v_dense_w"].T + params["v_dense_b"]
        t_emb = self.t_feat @ params["t_dense_w"].T + params["t_dense_b"]
        au, ai = self.tower(torch.cat([xu, xu, xu], 1),
                            torch.cat([params["item_embedding"], v_emb, t_emb], 1))
        user = au @ params["after_u_w"].T + params["after_u_b"]
        item = ai @ params["after_i_w"].T + params["after_i_b"]
        return user, item, torch.chunk(ai, 3, dim=1)

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        user, item, (ii, vi, ti) = self.forward(params)
        w = batch.weights
        main = in_batch_ce(l2norm(user[batch.users]), l2norm(item[batch.pos_items]),
                           self.ssl_temp, w)
        idx = batch.pos_items

        def lin(name, x):
            return x @ params[f"{name}_w"].T + params[f"{name}_b"]

        x_i_iv = lin("g_i_iv", ii[idx])
        v_loss = in_batch_ce(x_i_iv, lin("g_v_iv", vi[idx]), self.ssl_temp, w)
        x_iva_ivat = lin("g_iva_ivat", lin("g_iv_iva", x_i_iv))
        t_loss = in_batch_ce(x_iva_ivat, lin("g_t_ivat", ti[idx]), self.ssl_temp, w)
        return main + self.ssl_alpha * (v_loss + t_loss)

    def embeddings(self, params: Params):
        user, item, _ = self.forward(params)
        return user, item
