"""LayerGCN: layer-refined GCN with per-epoch edge pruning.

Counterpart of ``chaorec_tpu/models/layergcn.py`` (reference:
Model/LayerGCN.py):

- forward: each layer's embedding is weighted, row by row, by its cosine
  to the ego embedding; the final embedding is the SUM of layers 1..L
  (Model/LayerGCN.py:130-145), with float32 products of a float32 R;
- each epoch keeps ``int(E (1 - dropout))`` edges, drawn without
  replacement, alternately in proportion to the edge weights (first) and
  uniformly, and renormalizes R over them (Model/LayerGCN.py:105-124).
  The draw is the JAX package's own, on the host:
  ``np.random.default_rng(epoch * 7919 + 13)`` over the user-sorted edges
  and their float32 weights, so both packages keep the same edges at the
  same epoch;
- training uses the pruned R, ranking the unpruned ``graph.dense_r``
  (Model/LayerGCN.py:48-49);
- BPR (1e-5) on the propagated rows, the mean-style L2 on the raw tables'
  rows (Model/LayerGCN.py:162-169).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from chaorec_tpu_torch.graphs.dropout import masked_dense_r
from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import xavier_uniform
from chaorec_tpu_torch.ops.losses import bpr_loss, cosine_rows, emb_l2_reg


class LayerGCN(RecModel):
    name = "LayerGCN"
    dp_split = True  # weighted means over rows (tests/test_torch_mesh.py)

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph, dim_E: int,
                 reg_weight: float, n_layers: int, dropout: float):
        super().__init__(num_user, num_item)
        if not graph.use_dense:
            raise ValueError("LayerGCN runs on the dense R; build its graph with use_dense")
        self.graph = graph
        self.device = graph.dense_r.device
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.n_layers = n_layers
        self.dropout = dropout
        self.pruning_random = False  # Model/LayerGCN.py:51: the weighted draw first
        self.masked_r = graph.dense_r  # training's R, pruned by each pre_epoch
        # host copies for the draw
        self._edge_w = graph.w_by_u.cpu().numpy()

    def init_params(self, generator: torch.Generator) -> Params:
        return {
            "user_embedding": xavier_uniform(generator, (self.num_user, self.dim_E)),
            "item_embedding": xavier_uniform(generator, (self.num_item, self.dim_E)),
        }

    def kept_edges(self, epoch: int) -> np.ndarray:
        """The indices, into the user-sorted edges, that epoch ``epoch``
        keeps; flips the draw's kind for the next call."""
        e = self._edge_w.shape[0]
        keep_len = int(e * (1.0 - self.dropout))
        rs = np.random.default_rng(epoch * 7919 + 13)
        if self.pruning_random:
            idx = rs.choice(e, size=keep_len, replace=False)
        else:
            idx = rs.choice(e, size=keep_len, replace=False, p=self._edge_w / self._edge_w.sum())
        self.pruning_random = not self.pruning_random
        return idx

    def pre_epoch(self, params: Params, epoch: int) -> None:
        if self.dropout <= 0.0:
            self.masked_r = self.graph.dense_r
            return
        mask = np.zeros(self._edge_w.shape[0], np.float32)
        mask[self.kept_edges(epoch)] = 1.0
        g = self.graph
        self.masked_r = masked_dense_r(g.u_by_u, g.i_by_u, torch.from_numpy(mask).to(self.device),
                                       self.num_user, self.num_item)

    def forward(self, params: Params, r: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        xu, xi = params["user_embedding"], params["item_embedding"]
        ego_u, ego_i = xu, xi
        acc_u = acc_i = 0.0
        rr = r.to(torch.float32)
        for _ in range(self.n_layers):
            xu, xi = rr @ xi, rr.t() @ xu
            xu = cosine_rows(xu, ego_u)[:, None] * xu
            xi = cosine_rows(xi, ego_i)[:, None] * xi
            acc_u = acc_u + xu
            acc_i = acc_i + xi
        return acc_u, acc_i

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        user_emb, item_emb = self.forward(params, self.masked_r)
        u = user_emb[batch.users]
        pos = item_emb[batch.pos_items]
        neg = item_emb[batch.neg_items]
        w = batch.weights
        bpr = bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w, eps=1e-5)
        reg = emb_l2_reg(self.reg_weight,
                         (params["user_embedding"][batch.users],
                          params["item_embedding"][batch.pos_items],
                          params["item_embedding"][batch.neg_items]), w)
        return bpr + reg

    def embeddings(self, params: Params):
        return self.forward(params, self.graph.dense_r)
