"""SGL: self-supervised graph learning with edge-dropout views.

Counterpart of ``chaorec_tpu/models/sgl.py`` (reference: Model/SGL.py):

- the ranking embedding is the mean of layers 0..L of the normalized graph
  (``BipartiteGraph.propagate``, Model/SGL.py:123-136);
- every step draws two views: each keeps 1 - ssl_ratio (0.9) of the edges
  (aug 'ed', Model/SGL.py:48-51,96-104), renormalizes the degrees over the
  kept edges (:110-121) and propagates the same mean-of-layers GCN in edge
  space (``graphs/dropout.edge_propagate``);
- the SSL loss is the full-catalog InfoNCE of the two views, summed (not
  averaged) over the batch's users and positive items and weighted by the
  batch weights (Model/SGL.py:180-208). ``lse((x - pos) / t) = lse(x / t) -
  pos / t``, so the catalog term is ``ops/losses.catalog_logsumexp``, the
  streaming logsumexp kernels on the card, with k the whole user or item
  table of view 2;
- total = BPR (with the 1e-5 epsilon) + reg_weight * the mean-style L2 of
  the raw embedding rows + ssl_reg * SSL (Model/SGL.py:210-218).

``view_masks`` draws the two views' keep masks from the generator, and
``loss_with_masks`` computes the loss from them, so a test can give both
packages the same masks.
"""

from __future__ import annotations

from typing import Tuple

import torch

from chaorec_tpu_torch.graphs.dropout import (EdgeBags, bernoulli_keep, edge_propagate,
                                              masked_edge_weights)
from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import xavier_uniform
from chaorec_tpu_torch.ops.losses import (bpr_loss, catalog_logsumexp, emb_l2_reg, l2norm,
                                          unshare)


class SGL(RecModel):
    name = "SGL"
    dp_split = True  # weighted means over rows (tests/test_torch_mesh.py)
    ssl_ratio = 0.1  # Model/SGL.py:51

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph, dim_E: int,
                 reg_weight: float, n_layers: int, ssl_temp: float, ssl_reg: float):
        super().__init__(num_user, num_item)
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.n_layers = n_layers
        self.ssl_temp = ssl_temp
        self.ssl_reg = ssl_reg
        # the views' hop sums, laid out once over the graph's edges
        self.bags = EdgeBags.build(graph.u_by_u, graph.i_by_u, num_user, num_item)

    def init_params(self, generator: torch.Generator) -> Params:
        return {
            "user_embedding": xavier_uniform(generator, (self.num_user, self.dim_E)),
            "item_embedding": xavier_uniform(generator, (self.num_item, self.dim_E)),
        }

    def _gcn_mean(self, xu, xi, propagate) -> Tuple[torch.Tensor, torch.Tensor]:
        acc_u, acc_i = xu, xi
        cu, ci = xu, xi
        for _ in range(self.n_layers):
            cu, ci = propagate(cu, ci)
            acc_u = acc_u + cu
            acc_i = acc_i + ci
        s = 1.0 / (self.n_layers + 1)
        return acc_u * s, acc_i * s

    def view_masks(self, generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        """The two views' (E,) keep masks over the user-sorted edge order."""
        e = self.graph.num_edges
        return (bernoulli_keep(generator, e, 1.0 - self.ssl_ratio),
                bernoulli_keep(generator, e, 1.0 - self.ssl_ratio))

    def _view(self, params: Params, keep: torch.Tensor):
        g = self.graph
        w, _, _ = masked_edge_weights(g.u_by_u, g.i_by_u, keep, self.num_user, self.num_item)

        def prop(xu, xi):
            return edge_propagate(g.u_by_u, g.i_by_u, w, xu, xi, self.num_user, self.num_item,
                                  self.bags)

        return self._gcn_mean(params["user_embedding"], params["item_embedding"], prop)

    def _ssl_loss(self, users, items, weights, view1, view2) -> torch.Tensor:
        """Full-catalog InfoNCE, summed (Model/SGL.py:180-208)."""
        u1, i1 = l2norm(view1[0]), l2norm(view1[1])
        u2, i2 = l2norm(view2[0]), l2norm(view2[1])
        bu1, bu2 = u1[users], u2[users]
        bi1, bi2 = i1[items], i2[items]
        pos_u = torch.sum(bu1 * bu2, dim=1)
        pos_i = torch.sum(bi1 * bi2, dim=1)
        c_u = catalog_logsumexp(bu1, u2, self.ssl_temp) - pos_u / self.ssl_temp
        c_i = catalog_logsumexp(bi1, i2, self.ssl_temp) - pos_i / self.ssl_temp
        return torch.sum((c_u + c_i) * weights)

    def loss_with_masks(self, params: Params, batch: Batch,
                        keeps: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        w = batch.weights
        user_emb, item_emb = self.embeddings(params)
        u = user_emb[batch.users]
        pos = item_emb[batch.pos_items]
        neg = item_emb[batch.neg_items]
        bpr = bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w, eps=1e-5)
        reg = emb_l2_reg(
            self.reg_weight,
            (params["user_embedding"][batch.users], params["item_embedding"][batch.pos_items],
             params["item_embedding"][batch.neg_items]),
            w,
        )
        ssl = unshare(self._ssl_loss(batch.users, batch.pos_items, w,
                                     self._view(params, keeps[0]), self._view(params, keeps[1])),
                      batch.share)
        return bpr + reg + self.ssl_reg * ssl

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        return self.loss_with_masks(params, batch, self.view_masks(generator))

    def embeddings(self, params: Params):
        return self._gcn_mean(params["user_embedding"], params["item_embedding"],
                              self.graph.propagate)
