"""NGCF: neural graph CF with bi-interaction messages.

Counterpart of ``chaorec_tpu/models/ngcf.py`` (reference: Model/NGCF.py):

- each layer is ``leaky_relu(W1 (A x) + W2 ((A x) * x), 0.2)`` with A the
  symmetric-normalized adjacency with self-loops (Model/NGCF.py:20-82;
  the bi-interaction sum distributes over the elementwise product, so a
  layer is one hop and two products);
- training drops edges each step, keeping each with 1 - dropout, and
  renormalizes the degrees over the kept edges and the self-loops
  (``graphs/dropout.masked_edge_weights(self_loops=True)``,
  Model/NGCF.py:41-44);
- the final embedding is the SUM of layers 0..L (Model/NGCF.py:116-126);
- BPR (1e-5) + the mean-style L2 of the propagated rows
  (Model/NGCF.py:129-168).

A hop sums over the graph's user-sorted edges (``BipartiteGraph.u_by_u``,
``i_by_u``) in a fixed order (``graphs/dropout.EdgeBags``, built once),
so a keep mask drawn by the JAX package, over the same order, applies
here. ``keep_mask`` draws the step's mask from the generator and
``loss_with_keep`` computes the loss from it.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from chaorec_tpu_torch.graphs.dropout import (EdgeBags, bernoulli_keep, edge_propagate,
                                              masked_edge_weights)
from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import xavier_uniform
from chaorec_tpu_torch.ops.losses import bpr_loss, emb_l2_reg


class NGCF(RecModel):
    name = "NGCF"
    dp_split = True  # weighted means over rows (tests/test_torch_mesh.py)

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph, dim_E: int,
                 reg_weight: float, dropout: float, n_layers: int):
        super().__init__(num_user, num_item)
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.dropout = dropout
        self.n_layers = n_layers
        self.bags = EdgeBags.build(graph.u_by_u, graph.i_by_u, num_user, num_item)

    def init_params(self, generator: torch.Generator) -> Params:
        params = {
            "user_embedding": xavier_uniform(generator, (self.num_user, self.dim_E)),
            "item_embedding": xavier_uniform(generator, (self.num_item, self.dim_E)),
        }
        for layer in range(self.n_layers):
            params[f"W1_{layer}"] = xavier_uniform(generator, (self.dim_E, self.dim_E))
            params[f"W2_{layer}"] = xavier_uniform(generator, (self.dim_E, self.dim_E))
        return params

    def keep_mask(self, generator: torch.Generator) -> torch.Tensor:
        """The step's (E,) edge keep mask (all ones without dropout)."""
        if self.dropout > 0:
            return bernoulli_keep(generator, self.graph.num_edges, 1.0 - self.dropout)
        return torch.ones(self.graph.num_edges, dtype=torch.float32, device=self.device)

    def propagate(self, params: Params, keep: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The sum of layers 0..L over the edges ``keep`` holds."""
        g = self.graph
        w, s_u, s_i = masked_edge_weights(g.u_by_u, g.i_by_u, keep, self.num_user,
                                          self.num_item, self_loops=True)
        xu, xi = params["user_embedding"], params["item_embedding"]
        acc_u, acc_i = xu, xi
        for layer in range(self.n_layers):
            pu, pi = edge_propagate(g.u_by_u, g.i_by_u, w, xu, xi, self.num_user,
                                    self.num_item, self.bags)
            au = pu + s_u[:, None] * xu
            ai = pi + s_i[:, None] * xi
            w1, w2 = params[f"W1_{layer}"], params[f"W2_{layer}"]
            xu = F.leaky_relu(au @ w1.t() + (au * xu) @ w2.t(), 0.2)
            xi = F.leaky_relu(ai @ w1.t() + (ai * xi) @ w2.t(), 0.2)
            acc_u = acc_u + xu
            acc_i = acc_i + xi
        return acc_u, acc_i

    def loss_with_keep(self, params: Params, batch: Batch, keep: torch.Tensor) -> torch.Tensor:
        user_emb, item_emb = self.propagate(params, keep)
        u = user_emb[batch.users]
        pos = item_emb[batch.pos_items]
        neg = item_emb[batch.neg_items]
        w = batch.weights
        return (bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w, eps=1e-5)
                + emb_l2_reg(self.reg_weight, (u, pos, neg), w))

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        return self.loss_with_keep(params, batch, self.keep_mask(generator))

    def embeddings(self, params: Params):
        ones = torch.ones(self.graph.num_edges, dtype=torch.float32, device=self.device)
        return self.propagate(params, ones)
