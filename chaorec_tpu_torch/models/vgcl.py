"""VGCL: variational graph contrastive learning.

Counterpart of ``chaorec_tpu/models/vgcl.py`` (reference: Model/VGCL.py):

- the variational encoder: the mean is the average of propagation layers
  1..L, ``logstd = mean @ W + b``, and two views ``mean + 0.01 *
  exp(logstd) * noise`` (Model/VGCL.py:107-128);
- node-level contrast (temperature ssl_temp) between the views at the
  batch's rows, in-batch negatives;
- cluster-level contrast (temperature 0.7 ssl_temp): k-means of each step's
  first view (50 user and 50 item clusters, 15 Lloyd iterations on the
  detached view, ``ops/kmeans.py``, in place of the reference's per-batch
  faiss e_step, train_and_evaluate.py:116-125) makes the same-cluster rows
  of the batch positives; the probability mass over the cluster mask,
  averaged (Model/VGCL.py:196-269);
- the KL term with the reference's formula and its hard-coded /1024
  (Model/VGCL.py:271-280);
- BPR (1e-5 inside the log) on the first view, the mean reg on the raw
  tables' rows; alpha scales both contrasts, beta = 1 the KL;
- ranking by the posterior mean (the reference ranks by the last sampled
  view).

``draws`` draws a step's two noise tables and the k-means' initial rows,
and ``loss_with_draws`` takes them, so a test can give both packages the
same ones.
"""

from __future__ import annotations

from typing import Dict

import torch

from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import xavier_uniform
from chaorec_tpu_torch.ops.kmeans import kmeans_from
from chaorec_tpu_torch.ops.losses import bpr_loss, emb_l2_reg, l2norm, masked_mean


class VGCL(RecModel):
    name = "VGCL"
    beta = 1.0
    n_user_cluster = 50
    n_item_cluster = 50
    kmeans_iters = 15

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph, dim_E: int,
                 reg_weight: float, n_layers: int, ssl_temp: float, ssl_alpha: float):
        super().__init__(num_user, num_item)
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.n_layers = n_layers
        self.temp_node = ssl_temp
        self.temp_cluster = 0.7 * ssl_temp
        self.alpha = ssl_alpha
        self.n_user_cluster = min(VGCL.n_user_cluster, num_user)
        self.n_item_cluster = min(VGCL.n_item_cluster, num_item)

    def init_params(self, generator: torch.Generator) -> Params:
        return {
            "user_embedding": xavier_uniform(generator, (self.num_user, self.dim_E)),
            "item_embedding": xavier_uniform(generator, (self.num_item, self.dim_E)),
            "eps_weight": xavier_uniform(generator, (self.dim_E, self.dim_E)),
            "eps_bias": torch.zeros((self.dim_E,), device=generator.device),
        }

    def encode(self, params: Params):
        """(mean (U + I, D), logstd (U + I, D))."""
        xu, xi = params["user_embedding"], params["item_embedding"]
        acc_u = acc_i = 0.0
        for _ in range(self.n_layers):
            xu, xi = self.graph.propagate(xu, xi)
            acc_u, acc_i = acc_u + xu, acc_i + xi
        mean = torch.cat([acc_u / self.n_layers, acc_i / self.n_layers], dim=0)
        return mean, mean @ params["eps_weight"] + params["eps_bias"]

    def draws(self, generator: torch.Generator, batch: Batch = None,
              state=None) -> Dict[str, torch.Tensor]:
        """The two views' N(0, 1) noise (U + I, D) and the user and item
        k-means' distinct initial rows."""
        n, dev = self.num_user + self.num_item, self.device
        noise = [torch.randn((n, self.dim_E), generator=generator, device=dev)
                 for _ in range(2)]
        init_u = torch.randperm(self.num_user, generator=generator, device=dev)
        init_i = torch.randperm(self.num_item, generator=generator, device=dev)
        return {"noise1": noise[0], "noise2": noise[1],
                "init_u": init_u[:self.n_user_cluster], "init_i": init_i[:self.n_item_cluster]}

    def loss_with_draws(self, params: Params, batch: Batch,
                        draws: Dict[str, torch.Tensor]) -> torch.Tensor:
        mean, logstd = self.encode(params)
        std = torch.exp(logstd)
        v1 = mean + 0.01 * std * draws["noise1"]
        v2 = mean + 0.01 * std * draws["noise2"]
        nu = self.num_user
        u1, i1, u2, i2 = v1[:nu], v1[nu:], v2[:nu], v2[nu:]

        bu, bi, bn, w = batch.users, batch.pos_items, batch.neg_items, batch.weights
        u, pos, neg = u1[bu], i1[bi], i1[bn]
        bpr = bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w, eps=1e-5)
        reg = emb_l2_reg(self.reg_weight, (params["user_embedding"][bu],
                                           params["item_embedding"][bi],
                                           params["item_embedding"][bn]), w)

        def node_cl(a, b):
            na, nb = l2norm(a), l2norm(b)
            pos_s = torch.sum(na * nb, 1) / self.temp_node
            return masked_mean(torch.logsumexp((na @ nb.T) / self.temp_node, 1) - pos_s, w)

        cl_node = self.alpha * (node_cl(u1[bu], u2[bu]) + node_cl(i1[bi], i2[bi]))

        # the step's k-means of the first view (the reference's faiss e_step)
        _, asg_u = kmeans_from(u1.detach(), draws["init_u"], self.kmeans_iters)
        _, asg_i = kmeans_from(i1.detach(), draws["init_i"], self.kmeans_iters)

        def cluster_cl(a, b, asg, rows, temp):
            na, nb = l2norm(a[rows]), l2norm(b[rows])
            cid = asg[rows]
            mask = (cid[:, None] == cid[None, :]).float() * w[None, :]
            n_pos = torch.clamp(mask.sum(1), min=1.0)
            logits = (na @ nb.T) / temp
            e = torch.exp(logits - torch.amax(logits, dim=1, keepdim=True))
            probs = e / torch.clamp(e.sum(1, keepdim=True), min=1e-12) * mask
            return -masked_mean(torch.log(torch.clamp(probs.sum(1) / n_pos, min=1e-12)), w)

        cl_cluster = self.alpha * (cluster_cl(u1, u2, asg_u, bu, self.temp_cluster)
                                   + cluster_cl(i1, i2, asg_i, bi, self.temp_cluster))

        # the reference's formula: its ``std`` is the encoder's logstd
        kl = -0.5 * (1 + 2 * logstd - mean ** 2 - torch.exp(logstd) ** 2)
        kl = self.beta * torch.mean(torch.sum(kl, 1)) / 1024.0
        return bpr + reg + cl_node + cl_cluster + kl

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        return self.loss_with_draws(params, batch, self.draws(generator, batch))

    def embeddings(self, params: Params):
        mean, _ = self.encode(params)
        return mean[:self.num_user], mean[self.num_user:]
