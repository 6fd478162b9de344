"""SelfCF: self-supervised CF without negatives (SimSiam-style).

Counterpart of ``chaorec_tpu/models/selfcf.py`` (reference:
Model/SelfCF.py):

- the online encoder is LightGCN (the mean of layers 0..L) whose edges are
  dropped on each forward at a rate itself drawn U[0, 1), the kept ones
  scaled by 1 / (1 - rate), without renormalizing
  (Model/SelfCF.py:103-119);
- the targets are detached copies of the online rows with elementwise
  dropout at ``dropout`` (Model/SelfCF.py:177-186);
- loss = -cos(pred(u), i_target) / 2 - cos(pred(i), u_target) / 2 +
  reg_weight 0.5 (sum u^2 + sum i^2) over the batch's online rows
  (Model/SelfCF.py:16-24, 192-208);
- ranking: pred(u) i^T + u pred(i)^T, as one dot product of the tables
  [pred(u), u] and [i, pred(i)] (Model/SelfCF.py:210-223), on the whole
  graph (``BipartiteGraph.propagate``).

The dropped graph's hops go through ``graphs/dropout.edge_propagate`` over
the graph's user-sorted edges, in a fixed order (``EdgeBags``, built
once), so an edge mask drawn by the JAX package over the same order
applies here. ``draws`` makes the step's rate, edge uniforms and target
masks, and ``loss_with_draws`` computes the loss from them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from chaorec_tpu_torch.graphs.dropout import EdgeBags, edge_propagate
from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import xavier_uniform
from chaorec_tpu_torch.ops.losses import l2norm, masked_mean


class SelfCF(RecModel):
    name = "SelfCF"

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph, dim_E: int,
                 reg_weight: float, n_layers: int, dropout: float):
        super().__init__(num_user, num_item)
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.n_layers = n_layers
        self.dropout = dropout
        self.bags = EdgeBags.build(graph.u_by_u, graph.i_by_u, num_user, num_item)

    def init_params(self, generator: torch.Generator) -> Params:
        return {
            "user_embedding": xavier_uniform(generator, (self.num_user, self.dim_E)),
            "item_embedding": xavier_uniform(generator, (self.num_item, self.dim_E)),
            "predictor_w": xavier_uniform(generator, (self.dim_E, self.dim_E)),
            "predictor_b": torch.zeros(self.dim_E, device=generator.device),
        }

    def encode(self, params: Params, draws: Optional[Dict[str, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The mean of layers 0..L: on the whole graph, or with ``draws``
        on the edges kept at its rate."""
        g = self.graph
        if draws is None:
            prop = g.propagate
        else:
            rate = draws["rate"]
            w = g.w_by_u * ((draws["edge_u"] >= rate).float()
                            / torch.clamp(1.0 - rate, min=1e-6))

            def prop(xu, xi):
                return edge_propagate(g.u_by_u, g.i_by_u, w, xu, xi, self.num_user,
                                      self.num_item, self.bags)
        xu, xi = params["user_embedding"], params["item_embedding"]
        acc_u, acc_i = xu, xi
        for _ in range(self.n_layers):
            xu, xi = prop(xu, xi)
            acc_u = acc_u + xu
            acc_i = acc_i + xi
        s = 1.0 / (self.n_layers + 1)
        return acc_u * s, acc_i * s

    def _predict(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return x @ params["predictor_w"].t() + params["predictor_b"]

    def draws(self, generator: torch.Generator, batch: Batch,
              state=None) -> Dict[str, torch.Tensor]:
        """The step's dropout rate (a 0-dim U[0, 1)), one U[0, 1) per edge
        (kept where at least the rate), and the targets' (B, dim_E) keep
        masks."""
        b = batch.users.shape[0]
        rate = torch.rand((), generator=generator, device=self.device)
        edge_u = torch.rand(self.graph.num_edges, generator=generator, device=self.device)
        keep = 1.0 - self.dropout
        du, di = ((torch.rand((b, self.dim_E), generator=generator, device=self.device)
                   < keep).float() for _ in range(2))
        return {"rate": rate, "edge_u": edge_u, "keep_u": du, "keep_i": di}

    def loss_with_draws(self, params: Params, batch: Batch,
                        draws: Dict[str, torch.Tensor]) -> torch.Tensor:
        user_all, item_all = self.encode(params, draws)
        u_online, i_online = user_all[batch.users], item_all[batch.pos_items]
        keep = 1.0 - self.dropout
        u_target = (u_online * draws["keep_u"] / keep).detach()
        i_target = (i_online * draws["keep_i"] / keep).detach()
        w = batch.weights
        reg = self.reg_weight * 0.5 * (torch.sum((u_online ** 2) * w[:, None])
                                       + torch.sum((i_online ** 2) * w[:, None]))

        def neg_cos(p, z):
            return -masked_mean(torch.sum(l2norm(p) * l2norm(z), 1), w)

        return (neg_cos(self._predict(params, u_online), i_target) / 2
                + neg_cos(self._predict(params, i_online), u_target) / 2 + reg)

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        return self.loss_with_draws(params, batch, self.draws(generator, batch))

    def embeddings(self, params: Params):
        u, i = self.encode(params)
        return (torch.cat([self._predict(params, u), u], 1),
                torch.cat([i, self._predict(params, i)], 1))
