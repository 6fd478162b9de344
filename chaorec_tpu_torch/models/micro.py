"""MICRO: LATTICE's learned modal graphs with a modality-fusion contrast.

Counterpart of ``chaorec_tpu/models/micro.py`` (reference: Model/MICRO.py):

- per modality, a frozen original kNN laplacian and a learned one rebuilt on
  the first batch of each epoch (``batch.index == 0``) from the projected
  features, mixed as (1 - lambda) learned + lambda original, both kept as
  (vals, idx) rows, (I, 2k) (Model/MICRO.py:193-210); later batches read
  them detached (``frozen_state_epoch``), and the projections and feature
  tables get their gradient on batch 0 only (``epoch0_params``);
- the single-propagation quirk: the reference's item-graph loop never feeds
  its output back (Model/MICRO.py:214-218), so each modal view is exactly
  one propagation of the item table;
- attention fusion: a shared query MLP (Linear, tanh, Linear to 1), a softmax
  over the two modalities; the item output adds the normalized fused h
  (Model/MICRO.py:220-232);
- the contrast: ``full_catalog_cl`` of each modal view against h over every
  item, weight ``ssl_alpha`` (Model/MICRO.py:170-191); BPR (1e-5 inside the
  log) and the mean-style L2 of the final rows.

The U-I graph is the segment (sparse) graph, as the JAX builder forces it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from chaorec_tpu_torch.graphs.knn import gather_weighted_sum, knn_topk, topk_sym_norm
from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.models.lattice import Ell, detach_graph, ell_knn_graph
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_uniform
from chaorec_tpu_torch.ops.losses import bpr_loss, catalog_logsumexp, emb_l2_reg, l2norm

State = Tuple[Ell, Ell]


def full_catalog_cl(z1: torch.Tensor, z2: torch.Tensor, tau: float,
                    fast: bool = False) -> torch.Tensor:
    """mean_i -log(e(s(z1_i, z2_i)/t) / (sum_j e(s(z1_i, z1_j)/t) + sum_j
    e(s(z1_i, z2_j)/t) - e(s(z1_i, z1_i)/t))) (Model/MICRO.py:170-191), s the
    cosine.

    ``fast`` (the model's graph_compute_dtype bfloat16): the denominator in
    the log domain, one ``catalog_logsumexp`` of n1/t against [n1; n2] (the
    streaming logsumexp kernels on the card: forward, dq and dk, q rows of
    k's own table), the self term removed by log1p(-e(s_ii - lse)); no (I, I)
    matrix exists. Otherwise the reference's direct form over the (I, I)
    exponentials (MMSSL's batch-sized calls take it too)."""
    n1, n2 = l2norm(z1), l2norm(z2)
    pos_s = torch.sum(n1 * n2, 1) / tau
    if fast:
        lse = catalog_logsumexp(n1, torch.cat([n1, n2], 0), tau)
        self_s = torch.sum(n1 * n1, 1) / tau
        log_denom = lse + torch.log1p(-torch.exp(self_s - lse))
        return torch.mean(-torch.log(torch.exp(pos_s - log_denom) + 1e-12))
    refl = torch.exp(n1 @ n1.t() / tau)
    betw = torch.exp(n1 @ n2.t() / tau)
    denom = refl.sum(1) + betw.sum(1) - torch.diagonal(refl)
    return torch.mean(-torch.log(torch.exp(pos_s) / denom + 1e-12))


class MICRO(RecModel):
    name = "MICRO"
    stateful = True
    epoch0_params = ("v_feat", "t_feat", "image_trs_w", "image_trs_b",
                     "text_trs_w", "text_trs_b")
    frozen_state_epoch = True

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph,
                 v_feat: torch.Tensor, t_feat: torch.Tensor, dim_E: int, n_layers: int,
                 reg_weight: float, ii_topk: int, mm_layers: int, ssl_temp: float,
                 lambda_coeff: float, ssl_alpha: float, compute_dtype: str = "bfloat16"):
        super().__init__(num_user, num_item)
        # the modal graphs stay float32; the dtype only routes the contrast
        self.cl_fast = compute_dtype == "bfloat16"
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.n_ui_layers = n_layers
        self.reg_weight = reg_weight
        self.topk = ii_topk
        self.mm_layers = mm_layers  # one propagation whatever its value (the quirk)
        self.tau = ssl_temp
        self.lambda_coeff = lambda_coeff
        self.beta = ssl_alpha
        self._v_init, self._t_init = v_feat, t_feat
        self.image_original = ell_knn_graph(v_feat, ii_topk)
        self.text_original = ell_knn_graph(t_feat, ii_topk)

    def init_params(self, generator: torch.Generator) -> Params:
        d = self.dim_E
        p = {"user_embedding": xavier_uniform(generator, (self.num_user, d)),
             "item_embedding": xavier_uniform(generator, (self.num_item, d)),
             "v_feat": self._v_init.clone(), "t_feat": self._t_init.clone()}
        p["image_trs_w"], p["image_trs_b"] = torch_linear_init(generator, d,
                                                               self._v_init.shape[1])
        p["text_trs_w"], p["text_trs_b"] = torch_linear_init(generator, d, self._t_init.shape[1])
        p["query_w1"], p["query_b1"] = torch_linear_init(generator, d, d)
        p["query_w2"] = torch_linear_init(generator, 1, d)[0]
        return p

    def init_state(self, device: torch.device | str = "cpu",
                   generator: Optional[torch.Generator] = None) -> State:
        """The modal graphs' buffers, shaped as ``_build_adjs`` returns them:
        a zero-weighted learned block, then the original block."""
        def padded(orig: Ell) -> Ell:
            ov, oi = orig
            return torch.cat([torch.zeros_like(ov), ov], 1), torch.cat([oi, oi], 1)

        return padded(self.image_original), padded(self.text_original)

    def _build_adjs(self, params: Params) -> State:
        """Per modality (1 - lambda) norm(knn(projected)) + lambda original
        (Model/MICRO.py:118-137), the two blocks side by side."""
        image_feats = params["v_feat"] @ params["image_trs_w"].t() + params["image_trs_b"]
        text_feats = params["t_feat"] @ params["text_trs_w"].t() + params["text_trs_b"]
        lam = self.lambda_coeff

        def mix(feats: torch.Tensor, orig: Ell) -> Ell:
            g = topk_sym_norm(*knn_topk(feats, self.topk))
            ov, oi = orig
            return (torch.cat([(1 - lam) * g.weights, lam * ov], 1),
                    torch.cat([g.indices, oi], 1))

        return mix(image_feats, self.image_original), mix(text_feats, self.text_original)

    def _query(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(x @ params["query_w1"].t() + params["query_b1"])
        return h @ params["query_w2"].t()  # (N, 1)

    def _forward(self, params: Params, adjs: State):
        (iv, ii), (tv, ti) = adjs
        items = params["item_embedding"]
        image_item = gather_weighted_sum(items, iv, ii)
        text_item = gather_weighted_sum(items, tv, ti)
        att = torch.cat([self._query(params, image_item), self._query(params, text_item)], -1)
        w = torch.softmax(att, -1)
        h = w[:, :1] * image_item + w[:, 1:] * text_item
        xu, xi = params["user_embedding"], items
        acc_u, acc_i = xu, xi
        for _ in range(self.n_ui_layers):
            xu, xi = self.graph.propagate(xu, xi)
            acc_u, acc_i = acc_u + xu, acc_i + xi
        s = 1.0 / (self.n_ui_layers + 1)
        return acc_u * s, acc_i * s + l2norm(h), image_item, text_item, h

    def loss_stateful(self, params: Params, state: State, batch: Batch,
                      generator: Optional[torch.Generator] = None):
        """Batch 0 builds the modal graphs (the loss differentiates through
        them), a later batch reads the state detached; returns the graphs,
        detached, as the new state."""
        adjs = self._build_adjs(params) if batch.index == 0 else tuple(
            detach_graph(g) for g in state)
        fu, fi, img_i, txt_i, h = self._forward(params, adjs)
        u, pos, neg = fu[batch.users], fi[batch.pos_items], fi[batch.neg_items]
        w = batch.weights
        total = (bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w, eps=1e-5)
                 + emb_l2_reg(self.reg_weight, (u, pos, neg), w))
        cl = (full_catalog_cl(img_i, h, self.tau, self.cl_fast)
              + full_catalog_cl(txt_i, h, self.tau, self.cl_fast))
        return total + self.beta * cl, tuple(detach_graph(g) for g in adjs)

    def embeddings_stateful(self, params: Params, state: State):
        fu, fi, *_ = self._forward(params, state)
        return fu, fi
