"""NCL: neighborhood-enriched contrastive learning.

Counterpart of ``chaorec_tpu/models/ncl.py`` (reference: Model/NCL.py):

- a LightGCN backbone propagated max(n_layers, 2 hyper_layers) layers;
  the ranking embedding is the mean of layers 0..n_layers
  (Model/NCL.py:139-155);
- structural contrast: layer 2 against layer 0 at the batch's rows, with
  the whole layer-0 table as negatives, summed over the batch and weighted
  ssl_reg * (user + alpha * item) (Model/NCL.py:206-245);
- prototype contrast: k-means (k = min(200, U, I)) of the raw embedding
  tables, rerun every step as the reference's per-batch ``e_step``
  (train_and_evaluate.py:107-115), on detached tables (faiss ran on numpy
  copies); centroids L2-normalized; weight proto_reg = 1e-7
  (Model/NCL.py:36,61-94). The k-means draws are not differentiated, and
  k, the centroids, carries no gradient: the dk kernel does not run for
  these two terms;
- BPR (with the 1e-5 epsilon) on the propagated rows, mean-style L2 on the
  raw rows (Model/NCL.py:278-286).

Every full-catalog term goes through ``ops/losses.catalog_logsumexp``.
``prototypes`` draws the centroids and assignments from the generator, and
``loss_with_prototypes`` takes them, so a test can give both packages the
same ones.
"""

from __future__ import annotations

from typing import Tuple

import torch

from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import xavier_uniform
from chaorec_tpu_torch.ops.kmeans import kmeans
from chaorec_tpu_torch.ops.losses import (bpr_loss, catalog_logsumexp, emb_l2_reg, l2norm,
                                          unshare)

Prototypes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _full_catalog_nce_sum(cur_batch, prev_batch, prev_all, temp, weights) -> torch.Tensor:
    """sum over the batch of -log(exp(pos / t) / sum_j exp(<cur, prev_all_j> / t))."""
    c = l2norm(cur_batch)
    p = l2norm(prev_batch)
    allp = l2norm(prev_all)
    pos = torch.sum(c * p, dim=1) / temp
    return torch.sum((catalog_logsumexp(c, allp, temp) - pos) * weights)


class NCL(RecModel):
    name = "NCL"
    dp_split = True  # weighted means over rows (tests/test_torch_mesh.py)
    hyper_layers = 1
    alpha = 1.0
    proto_reg = 1e-7
    k = 200
    kmeans_iters = 15

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph, dim_E: int,
                 reg_weight: float, n_layers: int, ssl_temp: float, ssl_reg: float):
        super().__init__(num_user, num_item)
        self.graph = graph
        self.device = graph.u_by_u.device
        self.k = min(NCL.k, num_user, num_item)  # capped for tiny catalogs
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.n_layers = n_layers
        self.ssl_temp = ssl_temp
        self.ssl_reg = ssl_reg

    def init_params(self, generator: torch.Generator) -> Params:
        return {
            "user_embedding": xavier_uniform(generator, (self.num_user, self.dim_E)),
            "item_embedding": xavier_uniform(generator, (self.num_item, self.dim_E)),
        }

    def forward(self, params: Params):
        xu, xi = params["user_embedding"], params["item_embedding"]
        layers_u, layers_i = [xu], [xi]
        cu, ci = xu, xi
        for _ in range(max(self.n_layers, self.hyper_layers * 2)):
            cu, ci = self.graph.propagate(cu, ci)
            layers_u.append(cu)
            layers_i.append(ci)
        fin_u = sum(layers_u[: self.n_layers + 1]) / (self.n_layers + 1)
        fin_i = sum(layers_i[: self.n_layers + 1]) / (self.n_layers + 1)
        return fin_u, fin_i, layers_u, layers_i

    @torch.no_grad()
    def prototypes(self, params: Params, generator: torch.Generator) -> Prototypes:
        """(user centroids, user assignment, item centroids, item assignment)
        of this step's k-means, centroids L2-normalized."""
        cent_u, asg_u = kmeans(generator, params["user_embedding"].detach(), self.k,
                               self.kmeans_iters)
        cent_i, asg_i = kmeans(generator, params["item_embedding"].detach(), self.k,
                               self.kmeans_iters)
        return l2norm(cent_u), asg_u, l2norm(cent_i), asg_i

    def loss_with_prototypes(self, params: Params, batch: Batch,
                             protos: Prototypes) -> torch.Tensor:
        w = batch.weights
        fin_u, fin_i, layers_u, layers_i = self.forward(params)

        # structural (layer) contrast: layer 2 against layer 0
        ctx = self.hyper_layers * 2
        ssl = _full_catalog_nce_sum(
            layers_u[ctx][batch.users], layers_u[0][batch.users], layers_u[0], self.ssl_temp, w,
        ) + self.alpha * _full_catalog_nce_sum(
            layers_i[ctx][batch.pos_items], layers_i[0][batch.pos_items], layers_i[0],
            self.ssl_temp, w,
        )
        ssl = self.ssl_reg * ssl

        # prototype contrast against this step's centroids
        cent_u, asg_u, cent_i, asg_i = protos
        proto = _full_catalog_nce_sum(
            layers_u[0][batch.users], cent_u[asg_u[batch.users]], cent_u, self.ssl_temp, w,
        ) + _full_catalog_nce_sum(
            layers_i[0][batch.pos_items], cent_i[asg_i[batch.pos_items]], cent_i,
            self.ssl_temp, w,
        )
        proto = self.proto_reg * proto

        u = fin_u[batch.users]
        pos = fin_i[batch.pos_items]
        neg = fin_i[batch.neg_items]
        bpr = bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w, eps=1e-5)
        reg = emb_l2_reg(
            self.reg_weight,
            (params["user_embedding"][batch.users], params["item_embedding"][batch.pos_items],
             params["item_embedding"][batch.neg_items]),
            w,
        )
        return bpr + reg + unshare(ssl, batch.share) + unshare(proto, batch.share)

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        return self.loss_with_prototypes(params, batch, self.prototypes(params, generator))

    def embeddings(self, params: Params):
        fin_u, fin_i, _, _ = self.forward(params)
        return fin_u, fin_i
