"""SimGCL: contrastive graph CF with noise-perturbed views.

Counterpart of ``chaorec_tpu/models/simgcl.py`` (reference:
Model/SimGCL.py):

- the forward is the mean of propagation layers 1..L: the ego layer is
  left out (Model/SimGCL.py:107-124);
- a perturbed forward adds ``sign(x) * normalize(U[0,1)) * eps`` to each
  layer's output, eps 0.1 (Model/SimGCL.py:115-118, :49);
- loss = BPR (1e-5 inside the log) + reg_weight * (mean u^2 + mean pos^2),
  with no negative term (Model/SimGCL.py:143-148), + ssl_reg * (InfoNCE of
  the users + InfoNCE of the positive items) over two perturbed views at
  the batch's rows, with in-batch negatives (Model/SimGCL.py:150-156);
- ranking by the unperturbed forward.

With ``linear_op`` (layer weights ``[0] + [1/L] * L``) the BPR terms
gather the batch's rows of the operator and the ranking tables are
``linear_op.full``; the two views go through the layer stack every step.

``noise_draws`` draws the views' U[0,1) noise from the generator, one
(user, item) pair of tables a layer and view, and ``loss_with_noise``
computes the loss from it, so a test can give both packages the same
draws.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import xavier_uniform
from chaorec_tpu_torch.ops.linear_prop import CombinedLinearOp
from chaorec_tpu_torch.ops.losses import bpr_loss, info_nce, masked_mean

# One view's noise: a (U, D) and an (I, D) U[0,1) table for each layer.
LayerNoise = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def perturb(x: torch.Tensor, noise: torch.Tensor, eps: float) -> torch.Tensor:
    """x + sign(x) * (noise over its row norm) * eps."""
    noise = noise / (torch.linalg.vector_norm(noise, dim=-1, keepdim=True) + 1e-12)
    return x + torch.sign(x) * noise * eps


def layer_mean(layers: Sequence[Tuple[torch.Tensor, torch.Tensor]]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    acc_u = acc_i = 0.0
    for xu, xi in layers:
        acc_u = acc_u + xu
        acc_i = acc_i + xi
    return acc_u / len(layers), acc_i / len(layers)


class SimGCL(RecModel):
    name = "SimGCL"
    eps = 0.1  # Model/SimGCL.py:49

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph, dim_E: int,
                 reg_weight: float, n_layers: int, ssl_temp: float, ssl_reg: float,
                 linear_op: Optional[CombinedLinearOp] = None):
        super().__init__(num_user, num_item)
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.n_layers = n_layers
        self.ssl_temp = ssl_temp
        self.ssl_reg = ssl_reg
        self.linear_op = linear_op

    def init_params(self, generator: torch.Generator) -> Params:
        return {
            "user_embedding": xavier_uniform(generator, (self.num_user, self.dim_E)),
            "item_embedding": xavier_uniform(generator, (self.num_item, self.dim_E)),
        }

    def layer_noise(self, generator: torch.Generator) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """One view's noise, on the generator's device."""
        dev = generator.device
        return [(torch.rand((self.num_user, self.dim_E), generator=generator, device=dev),
                 torch.rand((self.num_item, self.dim_E), generator=generator, device=dev))
                for _ in range(self.n_layers)]

    def noise_draws(self, generator: torch.Generator):
        """The two views' noise."""
        return self.layer_noise(generator), self.layer_noise(generator)

    def layers(self, params: Params, noise: Optional[LayerNoise] = None
               ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Layers 1..L's (user, item) outputs, each perturbed by its
        ``noise`` when given."""
        xu, xi = params["user_embedding"], params["item_embedding"]
        out = []
        for layer in range(self.n_layers):
            xu, xi = self.graph.propagate(xu, xi)
            if noise is not None:
                xu = perturb(xu, noise[layer][0], self.eps)
                xi = perturb(xi, noise[layer][1], self.eps)
            out.append((xu, xi))
        return out

    def forward(self, params: Params, noise: Optional[LayerNoise] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The mean of layers 1..L."""
        return layer_mean(self.layers(params, noise))

    def loss_with_noise(self, params: Params, batch: Batch,
                        noise: Tuple[LayerNoise, LayerNoise]) -> torch.Tensor:
        e_u, e_i = params["user_embedding"], params["item_embedding"]
        w = batch.weights
        if self.linear_op is not None:
            u = self.linear_op.user_rows(batch.users, e_u, e_i)
            pos = self.linear_op.item_rows(batch.pos_items, e_u, e_i)
            neg = self.linear_op.item_rows(batch.neg_items, e_u, e_i)
        else:
            user_emb, item_emb = self.forward(params)
            u = user_emb[batch.users]
            pos = item_emb[batch.pos_items]
            neg = item_emb[batch.neg_items]
        bpr = bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w, eps=1e-5)
        reg = self.reg_weight * (masked_mean(torch.mean(u ** 2, 1), w)
                                 + masked_mean(torch.mean(pos ** 2, 1), w))
        u1, i1 = self.forward(params, noise[0])
        u2, i2 = self.forward(params, noise[1])
        cl = (info_nce(u1[batch.users], u2[batch.users], self.ssl_temp, w)
              + info_nce(i1[batch.pos_items], i2[batch.pos_items], self.ssl_temp, w))
        return bpr + reg + self.ssl_reg * cl

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        return self.loss_with_noise(params, batch, self.noise_draws(generator))

    def embeddings(self, params: Params):
        if self.linear_op is not None:
            return self.linear_op.full(params["user_embedding"], params["item_embedding"])
        return self.forward(params)
