"""DRAGON: DualGNN's towers, a frozen multimodal item graph, "cat" fusion.

Counterpart of ``chaorec_tpu/models/dragon.py`` (reference:
Model/DRAGON.py). What differs from DualGNN:

- "cat" fusion: user rep = [w_u0 * v_rep_u | w_u1 * t_rep_u] (U, 2d) plus
  the user-graph sum; item rep = [v_rep_i | t_rep_i] (I, 2d)
  (Model/DRAGON.py:282-296);
- the item rep adds ``n_layers`` passes over the multimodal kNN item graph
  (``graphs/knn.mixed_knn_graph``: the visual and textual ``ii_topk``-NN
  graphs, weights 1/k, mixed by ``mm_image_weight``; the builder passes
  ``lambda_coeff`` there, as main.py:284-286 does) (Model/DRAGON.py:
  303-310);
- the reg has no ``weight_i`` term (Model/DRAGON.py:331-341).

The loss takes the batch rows of the user graph's sum, and of the item
graph's when it has one layer; with more it propagates the whole table and
gathers the batch's items, as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

from chaorec_tpu_torch.graphs.knn import gather_weighted_sum, mixed_knn_graph
from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params
from chaorec_tpu_torch.models.dualgnn import DualGNN
from chaorec_tpu_torch.ops.losses import bpr_loss


class DRAGON(DualGNN):
    name = "DRAGON"

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph, edges: np.ndarray,
                 v_feat: torch.Tensor, t_feat: torch.Tensor, dim_E: int,
                 feature_embedding: int, reg_weight: float, n_layers: int, ii_topk: int,
                 uu_topk: int, mm_image_weight: float):
        super().__init__(num_user, num_item, graph, edges, v_feat, t_feat, dim_E,
                         feature_embedding, reg_weight, uu_topk)
        self.n_mm_layers = n_layers
        self.mm_graph = mixed_knn_graph(v_feat, t_feat, ii_topk, mm_image_weight)

    def _reps(self, params: Params):
        """(user rep (U, 2d) before the user graph, item rep (I, 2d) before
        the item graph)."""
        vu, vi, tu, ti = self._towers(params)
        w = params["weight_u"]  # (U, 2, 1)
        return torch.cat([w[:, 0] * vu, w[:, 1] * tu], 1), torch.cat([vi, ti], 1)

    def _mm(self, h: torch.Tensor) -> torch.Tensor:
        for _ in range(self.n_mm_layers):
            h = self.mm_graph.propagate(h)
        return h

    def forward(self, params: Params):
        user_rep, item_rep = self._reps(params)
        h_u = gather_weighted_sum(user_rep, self.user_nbr_w, self.user_nbr_idx)
        return user_rep + h_u, item_rep + self._mm(item_rep)

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        user_rep, item_rep = self._reps(params)
        u = self._batch_users(user_rep, batch.users)
        items2 = torch.cat([batch.pos_items, batch.neg_items])
        if self.n_mm_layers == 1:
            h_rows = gather_weighted_sum(item_rep, self.mm_graph.weights[items2],
                                         self.mm_graph.indices[items2])
        else:
            h_rows = self._mm(item_rep)[items2]
        both = item_rep[items2] + h_rows
        b = batch.pos_items.shape[0]
        pos, neg = both[:b], both[b:]
        bpr = bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), batch.weights, eps=1e-5)
        return bpr + self.reg_weight * self._pref_reg(params, batch)
