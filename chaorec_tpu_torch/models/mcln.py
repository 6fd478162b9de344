"""MCLN: multimodal counterfactual learning network.

Counterpart of ``chaorec_tpu/models/mcln.py`` (reference: Model/MCLN.py):

- a LightGCN backbone (the mean of layers 0..n) for the id embeddings;
  the image and text features frozen, each through a trainable
  xavier-normal projection; separate image and text user tables
  (Model/MCLN.py:17-74);
- counterfactual layers over the batch's item rows (the 3d-wide concat
  of id, image and text rows): attention scores less the "interest"
  items' scores, residual and LayerNorm, a ReLU feed-forward 3d -> 12d ->
  3d with residual and LayerNorm, ``n_mca`` times; a plain attention
  branch of the same shape for the negatives (Model/MCLN.py:118-213);
- the interest items are a second uniform draw from outside each user's
  history (dataload.py:103-104): ``needs_int_items``, so the trainer
  fills ``Batch.int_items``;
- loss = four softplus BPR terms (id, image, text, counterfactual) +
  reg_weight times sums of squares (Model/MCLN.py:262-305);
- ranking: ua ia^T + u_v visual^T + u_t textual^T, as one dot product of
  concatenated tables (Model/MCLN.py:314-326).

Nothing in the loss is random: the trainer draws the interest items.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_normal
from chaorec_tpu_torch.ops.losses import masked_mean


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    mu = torch.mean(x, -1, keepdim=True)
    var = torch.var(x, -1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


class MCLN(RecModel):
    name = "MCLN"
    needs_int_items = True

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph,
                 v_feat: torch.Tensor, t_feat: torch.Tensor, dim_E: int, reg_weight: float,
                 n_layers: int, n_mca: int):
        super().__init__(num_user, num_item)
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.n_layers = n_layers
        self.n_mca = n_mca
        self.v_feat = v_feat  # frozen
        self.t_feat = t_feat

    def init_params(self, generator: torch.Generator) -> Params:
        d, d3 = self.dim_E, 3 * self.dim_E
        p = {
            "user_embedding": xavier_normal(generator, (self.num_user, d)),
            "item_embedding": xavier_normal(generator, (self.num_item, d)),
            "user_embedding_v": xavier_normal(generator, (self.num_user, d)),
            "user_embedding_t": xavier_normal(generator, (self.num_user, d)),
            "image_trs_w": xavier_normal(generator, (d, self.v_feat.shape[1])),
            "text_trs_w": xavier_normal(generator, (d, self.t_feat.shape[1])),
        }
        _, p["image_trs_b"] = torch_linear_init(generator, d, self.v_feat.shape[1])
        _, p["text_trs_b"] = torch_linear_init(generator, d, self.t_feat.shape[1])
        for name in ("V1", "K1", "Q1", "K_int", "Q_int", "cfl1", "V2", "K2", "Q2", "cfl2"):
            p[f"{name}_w"], _ = torch_linear_init(generator, d3, d3)
        for name, (o, i) in [("fc_pos", (d, d3)), ("fc_neg", (d, d3)),
                             ("inner", (12 * d, d3)), ("output", (d3, 12 * d))]:
            p[f"{name}_w"], p[f"{name}_b"] = torch_linear_init(generator, o, i)
        for name in ("ln1", "ln2", "ln_ff"):
            p[f"{name}_scale"] = torch.ones(d3, device=generator.device)
            p[f"{name}_bias"] = torch.zeros(d3, device=generator.device)
        return p

    def _backbone(self, params: Params):
        xu, xi = params["user_embedding"], params["item_embedding"]
        acc_u, acc_i = xu, xi
        for _ in range(self.n_layers):
            xu, xi = self.graph.propagate(xu, xi)
            acc_u = acc_u + xu
            acc_i = acc_i + xi
        s = 1.0 / (self.n_layers + 1)
        return acc_u * s, acc_i * s

    def _modal(self, params: Params):
        return (self.v_feat @ params["image_trs_w"].t() + params["image_trs_b"],
                self.t_feat @ params["text_trs_w"].t() + params["text_trs_b"])

    def _ff(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(x @ params["inner_w"].t() + params["inner_b"])
        h = h @ params["output_w"].t() + params["output_b"]
        return layer_norm(h + x, params["ln_ff_scale"], params["ln_ff_bias"])

    def _cf(self, params: Params, x: torch.Tensor, x_int=None) -> torch.Tensor:
        """The counterfactual stack (``x_int`` given: its scores are
        subtracted, block 1) or the plain one (block 2)."""
        n = "1" if x_int is not None else "2"
        scale = 1.0 / math.sqrt(x.shape[-1])
        out = x
        for _ in range(self.n_mca):
            v = out @ params[f"V{n}_w"].t()
            k = out @ params[f"K{n}_w"].t()
            q = out @ params[f"Q{n}_w"].t()
            score = (q @ k.t()) * scale
            if x_int is not None:
                k_i = x_int @ params["K_int_w"].t()
                q_i = x_int @ params["Q_int_w"].t()
                score = score - (q_i @ k_i.t()) * scale
            cl = torch.softmax(score, -1) @ v @ params[f"cfl{n}_w"].t() + out
            out = self._ff(params, layer_norm(cl, params[f"ln{n}_scale"], params[f"ln{n}_bias"]))
        return out

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        visual, textual = self._modal(params)
        ua, ia = self._backbone(params)
        bu, bp, bn, bi2, w = (batch.users, batch.pos_items, batch.neg_items,
                              batch.int_items, batch.weights)
        u = ua[bu]
        pos_v, pos_t, neg_v, neg_t = visual[bp], textual[bp], visual[bn], textual[bn]
        pos_in = torch.cat([ia[bp], pos_v, pos_t], 1)
        neg_in = torch.cat([ia[bn], neg_v, neg_t], 1)
        int_in = torch.cat([ia[bi2], visual[bi2], textual[bi2]], 1)
        pos_m = F.relu(self._cf(params, pos_in, int_in) @ params["fc_pos_w"].t()
                       + params["fc_pos_b"])
        neg_m = F.relu(self._cf(params, neg_in) @ params["fc_neg_w"].t() + params["fc_neg_b"])

        def softplus_bpr(p_s, n_s):
            return masked_mean(F.softplus(-(p_s - n_s)), w)

        mf = (softplus_bpr(torch.sum(u * ia[bp], 1), torch.sum(u * ia[bn], 1))
              + softplus_bpr(torch.sum(u * pos_v, 1), torch.sum(u * neg_v, 1))
              + softplus_bpr(torch.sum(u * pos_t, 1), torch.sum(u * neg_t, 1))
              + softplus_bpr(torch.sum(u * pos_m, 1), torch.sum(u * neg_m, 1)))
        wcol = w[:, None]
        ue, ie = params["user_embedding"], params["item_embedding"]
        reg = self.reg_weight * (
            torch.sum(ue[bu] ** 2 * wcol) + torch.sum(ie[bp] ** 2 * wcol)
            + torch.sum(ie[bn] ** 2 * wcol)
            + torch.sum(pos_v ** 2 * wcol) + torch.sum(neg_v ** 2 * wcol)
            + torch.sum(pos_t ** 2 * wcol) + torch.sum(neg_t ** 2 * wcol)
            + torch.sum(pos_m ** 2 * wcol) + torch.sum(neg_m ** 2 * wcol))
        return mf + reg

    def embeddings(self, params: Params):
        visual, textual = self._modal(params)
        ua, ia = self._backbone(params)
        return (torch.cat([ua, params["user_embedding_v"], params["user_embedding_t"]], 1),
                torch.cat([ia, visual, textual], 1))
