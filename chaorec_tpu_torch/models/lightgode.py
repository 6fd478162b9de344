"""LightGODE: MF training, graph-ODE inference.

Counterpart of ``chaorec_tpu/models/lightgode.py`` (reference:
Model/LightGODE.py):

- training (its 'MF_init' strategy) is matrix factorization alone: the
  batch's user and positive-item rows, row-normalized; loss = alignment +
  gamma (uniformity(u) + uniformity(i)) / 2, alignment = mean ||u - i||^2
  and uniformity = log mean over the batch's pairs i < j of
  exp(-2 ||x_i - x_j||^2), pad rows masked out of both
  (Model/LightGODE.py:96-106, 135-147);
- inference: one Euler step of the graph ODE dx/dt = A x + e (e the
  initial embeddings) over [0, t], z = x0 + t (A x0 + x0), through
  ``BipartiteGraph.propagate``, ranked un-normalized
  (Model/LightGODE.py:26-35, 118-126).

Nothing in the loss is random.
"""

from __future__ import annotations

import torch

from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import xavier_normal
from chaorec_tpu_torch.ops.losses import l2norm, masked_mean


def uniformity(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """log mean_{i<j} exp(-2 ||x_i - x_j||^2) over the pairs of rows of
    weight 1."""
    sq = torch.sum(x ** 2, 1)
    d2 = torch.clamp(sq[:, None] - 2 * (x @ x.t()) + sq[None, :], min=0.0)
    iu = torch.triu(torch.ones_like(d2), diagonal=1) * (w[:, None] * w[None, :])
    val = torch.sum(torch.exp(-2.0 * d2) * iu) / torch.clamp(torch.sum(iu), min=1.0)
    return torch.log(val + 1e-12)


class LightGODE(RecModel):
    name = "LightGODE"

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph, dim_E: int,
                 gamma: float, t: float):
        super().__init__(num_user, num_item)
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.gamma = gamma
        self.t = t

    def init_params(self, generator: torch.Generator) -> Params:
        return {
            "user_embedding": xavier_normal(generator, (self.num_user, self.dim_E)),
            "item_embedding": xavier_normal(generator, (self.num_item, self.dim_E)),
        }

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        u = l2norm(params["user_embedding"][batch.users])
        i = l2norm(params["item_embedding"][batch.pos_items])
        w = batch.weights
        align = masked_mean(torch.sum((u - i) ** 2, 1), w)
        return align + self.gamma * (uniformity(u, w) + uniformity(i, w)) / 2.0

    def embeddings(self, params: Params):
        xu, xi = params["user_embedding"], params["item_embedding"]
        au, ai = self.graph.propagate(xu, xi)
        return xu + self.t * (au + xu), xi + self.t * (ai + xi)
