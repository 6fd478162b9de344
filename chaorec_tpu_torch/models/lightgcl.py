"""LightGCL: SVD-augmented contrastive graph CF.

Counterpart of ``chaorec_tpu/models/lightgcl.py`` (reference:
Model/LightGCL.py):

- the normalized R, ``R / sqrt(d_u d_i)`` with no epsilon
  (Model/LightGCL.py:75-95), and its rank-5 randomized SVD
  (``ops/svd.py``, in place of ``torch.svd_lowrank``, Model/LightGCL.py:
  43-49). The builder takes the SVD of R as the graph stores it: in
  ``graph_compute_dtype``, bf16 by default, cast to float32 after that
  rounding, as the JAX builder does;
- forward: layer k is the propagation of layer k-1, the embedding the SUM
  of layers 0..L (Model/LightGCL.py:129-153);
- the SVD view: ``G_u[k] = U S (V^T E_i[k-1])``, ``G_i[k] = V S (U^T
  E_u[k-1])``, summed with the ego over layers (Model/LightGCL.py:181-190);
- ssl = lambda_1 * (mean logsumexp of the view's batch rows against every
  row of the embedding table, over the temperature, minus the mean of the
  positive's score clipped to [-5, 5]) (Model/LightGCL.py:192-199). The
  logsumexp is a plain one over a (B, U) and a (B, I) product, as in the
  JAX package: it is not a catalog term there;
- BPR without epsilon, and lambda_2 times the sum of squares of every
  param (Model/LightGCL.py:155-176).

The model draws nothing at a step: its randomness is the SVD's sketch, at
build time.
"""

from __future__ import annotations

import torch

from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import xavier_uniform
from chaorec_tpu_torch.ops.losses import masked_mean


class LightGCL(RecModel):
    name = "LightGCL"
    q = 5  # Model/LightGCL.py:29

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph, dim_E: int,
                 reg_weight: float, n_layers: int, ssl_alpha: float, ssl_temp: float,
                 svd_u_s: torch.Tensor, svd_v_s: torch.Tensor, svd_ut: torch.Tensor,
                 svd_vt: torch.Tensor):
        super().__init__(num_user, num_item)
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.lambda_2 = reg_weight
        self.lambda_1 = ssl_alpha
        self.temp = ssl_temp
        self.n_layers = n_layers
        # u_mul_s (U, q), v_mul_s (I, q), ut (q, U), vt (q, I)
        self.u_mul_s = svd_u_s
        self.v_mul_s = svd_v_s
        self.ut = svd_ut
        self.vt = svd_vt

    def init_params(self, generator: torch.Generator) -> Params:
        return {
            "user_embedding": xavier_uniform(generator, (self.num_user, self.dim_E)),
            "item_embedding": xavier_uniform(generator, (self.num_item, self.dim_E)),
        }

    def forward(self, params: Params):
        """(summed user and item embeddings, the user and item layer lists)."""
        layers_u, layers_i = [params["user_embedding"]], [params["item_embedding"]]
        for _ in range(self.n_layers):
            nu, ni = self.graph.propagate(layers_u[-1], layers_i[-1])
            layers_u.append(nu)
            layers_i.append(ni)
        return sum(layers_u), sum(layers_i), layers_u, layers_i

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        w = batch.weights
        e_u, e_i, layers_u, layers_i = self.forward(params)
        u = e_u[batch.users]
        pos = e_i[batch.pos_items]
        neg = e_i[batch.neg_items]
        pos_scores = torch.sum(u * pos, dim=1)
        neg_scores = torch.sum(u * neg, dim=1)
        bpr = -masked_mean(torch.log(torch.sigmoid(pos_scores - neg_scores)), w)  # no epsilon
        reg = self.lambda_2 * sum(torch.sum(p ** 2) for p in params.values())

        acc_gu, acc_gi = params["user_embedding"], params["item_embedding"]
        for layer in range(1, self.n_layers + 1):
            acc_gu = acc_gu + self.u_mul_s @ (self.vt @ layers_i[layer - 1])
            acc_gi = acc_gi + self.v_mul_s @ (self.ut @ layers_u[layer - 1])
        gu, gi = acc_gu[batch.users], acc_gi[batch.pos_items]
        neg_score = masked_mean(torch.logsumexp((gu @ e_u.T) / self.temp, dim=1), w) \
            + masked_mean(torch.logsumexp((gi @ e_i.T) / self.temp, dim=1), w)
        pos_score = masked_mean(torch.clamp(torch.sum(gu * u, dim=1) / self.temp, -5.0, 5.0), w) \
            + masked_mean(torch.clamp(torch.sum(gi * pos, dim=1) / self.temp, -5.0, 5.0), w)
        return bpr + reg + self.lambda_1 * (neg_score - pos_score)

    def embeddings(self, params: Params):
        e_u, e_i, _, _ = self.forward(params)
        return e_u, e_i
