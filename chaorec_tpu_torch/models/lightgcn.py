"""LightGCN: linear graph convolution.

Counterpart of ``chaorec_tpu/models/lightgcn.py`` (reference:
Model/LightGCN.py):

- symmetric-normalized propagation without self-loops or feature
  transforms, one ``BipartiteGraph.propagate`` a layer
  (Model/LightGCN.py:21-46);
- the final embedding is the uniform mean of layers 0..n
  (Model/LightGCN.py:86-93);
- BPR with 1e-5 inside the log and the mean-style L2 of the *propagated*
  rows (Model/LightGCN.py:108-121);
- ranking by the propagated tables.

With ``linear_op`` (``ops/linear_prop.py``, built by ``models/builders.py:_maybe_op`` on a
dense graph that fits) a step gathers only the batch's rows of the
operator: one gather for the users, one for the positive and negative
items together; the ranking tables are ``linear_op.full``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import xavier_uniform
from chaorec_tpu_torch.ops.linear_prop import CombinedLinearOp
from chaorec_tpu_torch.ops.losses import bpr_loss, emb_l2_reg


class LightGCN(RecModel):
    name = "LightGCN"
    dp_split = True  # weighted means over rows (tests/test_torch_mesh.py)

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph, dim_E: int,
                 reg_weight: float, n_layers: int,
                 linear_op: Optional[CombinedLinearOp] = None):
        super().__init__(num_user, num_item)
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.n_layers = n_layers
        self.linear_op = linear_op

    def init_params(self, generator: torch.Generator) -> Params:
        return {
            "user_embedding": xavier_uniform(generator, (self.num_user, self.dim_E)),
            "item_embedding": xavier_uniform(generator, (self.num_item, self.dim_E)),
        }

    def propagate(self, params: Params) -> Tuple[torch.Tensor, torch.Tensor]:
        u, i = params["user_embedding"], params["item_embedding"]
        acc_u, acc_i = u, i
        for _ in range(self.n_layers):
            u, i = self.graph.propagate(u, i)
            acc_u = acc_u + u
            acc_i = acc_i + i
        scale = 1.0 / (self.n_layers + 1)
        return acc_u * scale, acc_i * scale

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        if self.linear_op is not None:
            e_u, e_i = params["user_embedding"], params["item_embedding"]
            u = self.linear_op.user_rows(batch.users, e_u, e_i)
            b = batch.pos_items.shape[0]
            both = self.linear_op.item_rows(torch.cat([batch.pos_items, batch.neg_items]),
                                            e_u, e_i)
            pos, neg = both[:b], both[b:]
        else:
            user_emb, item_emb = self.propagate(params)
            u = user_emb[batch.users]
            pos = item_emb[batch.pos_items]
            neg = item_emb[batch.neg_items]
        w = batch.weights
        return (bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w, eps=1e-5)
                + emb_l2_reg(self.reg_weight, (u, pos, neg), w))

    def embeddings(self, params: Params):
        if self.linear_op is not None:
            return self.linear_op.full(params["user_embedding"], params["item_embedding"])
        return self.propagate(params)
