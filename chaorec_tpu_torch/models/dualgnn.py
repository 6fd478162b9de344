"""DualGNN: a dual user-item and user-user graph network.

Counterpart of ``chaorec_tpu/models/dualgnn.py`` (reference:
Model/DualGNN.py):

- a GCN tower per modality (Model/DualGNN.py:24-93): a trainable user
  preference table (xavier-normal) over the items' MLP(4d) -> LeakyReLU ->
  Linear(d) of the raw features, the rows normalized, two propagation
  layers (symmetric-normalized, no self loops), output x + h + h1. Both
  towers go through one 2d-wide propagation pair: the graph acts on each
  column alone, so the split result is each tower's;
- weighted-sum fusion: user rep = [v_rep_u | t_rep_u] (U, d, 2) times
  ``weight_u`` (U, 2, 1), initialized to softmaxed xavier values
  (Model/DualGNN.py:141-160, 171-186); item rep = v_rep + t_rep;
- the user-user aggregation over the co-occurrence graph
  (``graphs/user_graph.py``): each epoch's (U, k) neighbours with
  softmax(count) weights, h_u = sum_k w * rep[nbr] (Model/DualGNN.py:
  315-358). The draw is numpy's, seeded as the JAX package seeds it
  (``default_rng(0)`` at construction, then the epoch's), so both packages
  aggregate the same neighbours;
- loss = BPR (1e-5 inside the log) + reg_weight * (the batch's mean
  v_pref^2 and t_pref^2 + mean weight_u^2 + mean weight_i^2)
  (Model/DualGNN.py:282-300). ``weight_i`` reaches the loss only through
  the reg.

The loss aggregates only the batch users' rows of the user graph, the same
math as ``forward`` and a gather.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from chaorec_tpu_torch.graphs import user_graph
from chaorec_tpu_torch.graphs.knn import gather_weighted_sum
from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_normal
from chaorec_tpu_torch.ops.losses import bpr_loss, l2norm, masked_mean

EPOCH_SEED = (104729, 7)  # the epoch's neighbour draw: default_rng(epoch * a + b)


class DualGNN(RecModel):
    name = "DualGNN"
    dp_split = True  # weighted means over rows (tests/test_torch_mesh.py)

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph, edges: np.ndarray,
                 v_feat: torch.Tensor, t_feat: torch.Tensor, dim_E: int,
                 feature_embedding: int, reg_weight: float, uu_topk: int):
        super().__init__(num_user, num_item)
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_latent = dim_E
        self.dim_feat = feature_embedding
        self.reg_weight = reg_weight
        self.k = uu_topk
        self.v_feat, self.t_feat = v_feat, t_feat
        self._uu = user_graph.build_user_cooccurrence(np.asarray(edges), num_user, num_item,
                                                      device=self.device)
        self.user_nbr_idx, self.user_nbr_w = user_graph.draw_user_graph(self._uu, self.k, 0,
                                                                        self.device)

    def init_params(self, generator: torch.Generator) -> Params:
        d = self.dim_latent
        p = {
            "v_preference": xavier_normal(generator, (self.num_user, self.dim_feat)),
            "t_preference": xavier_normal(generator, (self.num_user, self.dim_feat)),
            "weight_u": torch.softmax(xavier_normal(generator, (self.num_user, 2, 1)), dim=1),
            "weight_i": torch.softmax(xavier_normal(generator, (self.num_item, 2, 1)), dim=1),
        }
        for mod, feat in (("v", self.v_feat), ("t", self.t_feat)):
            p[f"{mod}_mlp_w1"], p[f"{mod}_mlp_b1"] = torch_linear_init(generator, 4 * d,
                                                                       feat.shape[1])
            p[f"{mod}_mlp_w2"], p[f"{mod}_mlp_b2"] = torch_linear_init(generator, d, 4 * d)
        return p

    def pre_epoch(self, params: Params, epoch: int) -> None:
        a, b = EPOCH_SEED
        self.user_nbr_idx, self.user_nbr_w = user_graph.draw_user_graph(
            self._uu, self.k, epoch * a + b, self.device)

    def _towers(self, params: Params):
        """(vu, vi, tu, ti): each modality tower's user and item outputs."""
        cus, cis = [], []
        for mod, feat in (("v", self.v_feat), ("t", self.t_feat)):
            tf = F.leaky_relu(feat @ params[f"{mod}_mlp_w1"].T + params[f"{mod}_mlp_b1"], 0.01)
            tf = tf @ params[f"{mod}_mlp_w2"].T + params[f"{mod}_mlp_b2"]
            x = l2norm(torch.cat([params[f"{mod}_preference"], tf], 0))
            cus.append(x[:self.num_user])
            cis.append(x[self.num_user:])
        cu, ci = torch.cat(cus, 1), torch.cat(cis, 1)
        h_u, h_i = self.graph.propagate(cu, ci)
        h1_u, h1_i = self.graph.propagate(h_u, h_i)
        au, ai = cu + h_u + h1_u, ci + h_i + h1_i
        (vu, tu), (vi, ti) = torch.chunk(au, 2, 1), torch.chunk(ai, 2, 1)
        return vu, vi, tu, ti

    def _user_rep(self, params: Params, vu: torch.Tensor, tu: torch.Tensor) -> torch.Tensor:
        return torch.matmul(torch.stack([vu, tu], 2), params["weight_u"]).squeeze(2)

    def forward(self, params: Params):
        vu, vi, tu, ti = self._towers(params)
        user_rep = self._user_rep(params, vu, tu)
        h_u = gather_weighted_sum(user_rep, self.user_nbr_w, self.user_nbr_idx)
        return user_rep + h_u, vi + ti

    def _batch_users(self, user_rep: torch.Tensor, users: torch.Tensor) -> torch.Tensor:
        """The batch users' rows of user_rep plus their user-graph sums."""
        return user_rep[users] + gather_weighted_sum(user_rep, self.user_nbr_w[users],
                                                     self.user_nbr_idx[users])

    def _pref_reg(self, params: Params, batch: Batch) -> torch.Tensor:
        w = batch.weights
        return (masked_mean(torch.mean(params["v_preference"][batch.users] ** 2, 1), w)
                + masked_mean(torch.mean(params["t_preference"][batch.users] ** 2, 1), w)
                + torch.mean(params["weight_u"] ** 2))

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        vu, vi, tu, ti = self._towers(params)
        fi = vi + ti
        u = self._batch_users(self._user_rep(params, vu, tu), batch.users)
        pos, neg = fi[batch.pos_items], fi[batch.neg_items]
        bpr = bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), batch.weights, eps=1e-5)
        return bpr + self.reg_weight * (self._pref_reg(params, batch)
                                        + torch.mean(params["weight_i"] ** 2))

    def embeddings(self, params: Params):
        return self.forward(params)
