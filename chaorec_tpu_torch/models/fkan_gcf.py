"""FKAN_GCF: Fourier-KAN bi-interaction graph CF.

Counterpart of ``chaorec_tpu/models/fkan_gcf.py`` (reference:
Model/FKAN_GCF.py and kanlayer.py):

- each layer: ``out = x + A x + FourierKAN(A x * x)`` on the normalized
  adjacency, then LeakyReLU(0.2), message dropout and a row L2 norm
  (Model/FKAN_GCF.py:30-41, 157-171);
- the reference builds its layers from ``zip(h[:-1], h[1:])`` of
  ``[dim_E] * n_layers``: n_layers - 1 layers (Model/FKAN_GCF.py:96-98),
  kept;
- node dropout: each side's normalized edge weights dropped by a mask of
  its own (the user side's over the user-sorted edges, the item side's
  over the item-sorted ones) and scaled 1 / keep (SparseDropout,
  Model/FKAN_GCF.py:45-64). Those hops go through
  ``graphs/dropout.edge_propagate`` in a fixed order; without node
  dropout (the first combo of Model_YAML/FKAN_GCF.yaml) a hop is
  ``BipartiteGraph.propagate``;
- the final rows concatenate every layer's output with the ego rows; BPR
  (1e-5 inside the log) + the mean-style L2 of the raw tables' rows
  (Model/FKAN_GCF.py:173-216).

``draws`` makes the step's node and message dropout masks, and
``loss_with_draws`` computes the loss from them.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from chaorec_tpu_torch.graphs.dropout import EdgeBags, edge_propagate
from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import xavier_uniform
from chaorec_tpu_torch.ops.kan import fourier_kan, fourier_kan_init
from chaorec_tpu_torch.ops.losses import bpr_loss, emb_l2_reg, l2norm

Draws = List[Dict[str, torch.Tensor]]


class FKAN_GCF(RecModel):
    name = "FKAN_GCF"
    dp_split = True  # weighted means over rows (tests/test_torch_mesh.py)

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph, dim_E: int,
                 reg_weight: float, n_layers: int, node_dropout: float,
                 message_dropout: float, grid_size: int):
        super().__init__(num_user, num_item)
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.n_gnn = max(n_layers - 1, 0)  # the zip quirk (see the module docstring)
        self.node_dropout = node_dropout
        self.message_dropout = message_dropout
        self.grid_size = grid_size
        self.bags = self.i_to_u = None
        if node_dropout > 0:
            self.bags = EdgeBags.build(graph.u_by_u, graph.i_by_u, num_user, num_item)
            self.i_to_u = _item_order_of_user_order(graph)

    def init_params(self, generator: torch.Generator) -> Params:
        params = {
            "user_embedding": xavier_uniform(generator, (self.num_user, self.dim_E)),
            "item_embedding": xavier_uniform(generator, (self.num_item, self.dim_E)),
        }
        for layer in range(self.n_gnn):
            params[f"kan_{layer}"] = fourier_kan_init(generator, self.dim_E, self.dim_E,
                                                      self.grid_size)
        return params

    def draws(self, generator: torch.Generator, batch: Optional[Batch] = None,
              state=None) -> Draws:
        """Each layer's masks: node dropout's over the user-sorted ("node_u")
        and item-sorted ("node_i") edges, message dropout's over the
        (U, dim_E) and (I, dim_E) outputs ("msg_u", "msg_i"); a rate of 0
        draws none."""
        def keep(shape, rate):
            return (torch.rand(shape, generator=generator, device=self.device)
                    < 1.0 - rate).float()

        out = []
        for _ in range(self.n_gnn):
            d = {}
            if self.node_dropout > 0:
                e = self.graph.num_edges
                d["node_u"], d["node_i"] = keep(e, self.node_dropout), keep(e, self.node_dropout)
            if self.message_dropout > 0:
                d["msg_u"] = keep((self.num_user, self.dim_E), self.message_dropout)
                d["msg_i"] = keep((self.num_item, self.dim_E), self.message_dropout)
            out.append(d)
        return out

    def _propagate(self, d: Optional[Dict[str, torch.Tensor]], xu, xi):
        g = self.graph
        if d is None or "node_u" not in d:
            return g.propagate(xu, xi)
        keep = 1.0 - self.node_dropout
        w_u = g.w_by_u * (d["node_u"] / keep)
        w_i = (g.w_by_i * (d["node_i"] / keep))[self.i_to_u]
        return edge_propagate(g.u_by_u, g.i_by_u, w_u, xu, xi, self.num_user, self.num_item,
                              self.bags, w_item=w_i)

    def forward(self, params: Params, draws: Optional[Draws] = None):
        xu, xi = params["user_embedding"], params["item_embedding"]
        outs_u, outs_i = [xu], [xi]
        for layer in range(self.n_gnn):
            d = None if draws is None else draws[layer]
            au, ai = self._propagate(d, xu, xi)
            cf = params[f"kan_{layer}"]
            nu = F.leaky_relu(xu + au + fourier_kan(au * xu, cf), 0.2)
            ni = F.leaky_relu(xi + ai + fourier_kan(ai * xi, cf), 0.2)
            if d is not None and "msg_u" in d:
                keep = 1.0 - self.message_dropout
                nu = nu * d["msg_u"] / keep
                ni = ni * d["msg_i"] / keep
            xu, xi = l2norm(nu), l2norm(ni)
            outs_u.append(xu)
            outs_i.append(xi)
        return torch.cat(outs_u, 1), torch.cat(outs_i, 1)

    def loss_with_draws(self, params: Params, batch: Batch, draws: Draws) -> torch.Tensor:
        fu, fi = self.forward(params, draws)
        u, pos, neg = fu[batch.users], fi[batch.pos_items], fi[batch.neg_items]
        w = batch.weights
        ue, ie = params["user_embedding"], params["item_embedding"]
        return (bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w, eps=1e-5)
                + emb_l2_reg(self.reg_weight, (ue[batch.users], ie[batch.pos_items],
                                               ie[batch.neg_items]), w))

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        return self.loss_with_draws(params, batch, self.draws(generator, batch))

    def embeddings(self, params: Params):
        return self.forward(params)


def _item_order_of_user_order(graph: BipartiteGraph) -> torch.Tensor:
    """(E,) for each edge of the user-sorted order, its position in the
    item-sorted order. Both orders sort the train edges stably, so a
    repeated (user, item) pair keeps its order in both and pairs up."""
    u_key = (graph.u_by_u * graph.num_item + graph.i_by_u).cpu().numpy()
    i_key = (graph.u_by_i * graph.num_item + graph.i_by_i).cpu().numpy()
    su, si = np.argsort(u_key, kind="stable"), np.argsort(i_key, kind="stable")
    out = np.empty_like(su)
    out[su] = si
    return torch.from_numpy(out).to(graph.u_by_u.device)
