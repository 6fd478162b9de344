"""MGCL: modality-against-id contrastive graph CF.

Counterpart of ``chaorec_tpu/models/mgcl.py`` (reference: Model/MGCL.py):

- three LightGCN towers (the mean of layers 0..n): (id users, id items),
  (visual users, a Linear of the visual features), (textual users, a
  Linear of the textual features); each modality has its own user table
  (Model/MGCL.py:36-88). One 3 dim_E-wide propagation serves the three;
- loss = the three towers' BPR (1e-5 inside the log) + mean reg of the
  batch's rows, + ssl_alpha * ``in_batch_ce`` of the normalized id rows
  against each modality's, for the users and for the positive items
  (Model/MGCL.py:92-167);
- ranking by the id tower only (Model/MGCL.py:63-68, 170-194). ``lambda_m``
  is a param the loss never reads, kept for the reference's shapes.
"""

from __future__ import annotations

import torch

from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.models.slmrec import in_batch_ce
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_uniform
from chaorec_tpu_torch.ops.losses import bpr_loss, emb_l2_reg, l2norm


class MGCL(RecModel):
    name = "MGCL"

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph,
                 v_feat: torch.Tensor, t_feat: torch.Tensor, dim_E: int, reg_weight: float,
                 n_layers: int, ssl_temp: float, ssl_alpha: float):
        super().__init__(num_user, num_item)
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.n_layers = n_layers
        self.ssl_temp = ssl_temp
        self.ssl_alpha = ssl_alpha
        self.v_feat, self.t_feat = v_feat, t_feat

    def init_params(self, generator: torch.Generator) -> Params:
        d = self.dim_E
        p = {k: xavier_uniform(generator, (n, d)) for k, n in (
            ("user_embedding", self.num_user), ("item_embedding", self.num_item),
            ("user_embedding_v", self.num_user), ("user_embedding_t", self.num_user))}
        for name, feat in (("image_trs", self.v_feat), ("text_trs", self.t_feat)):
            p[f"{name}_w"] = xavier_uniform(generator, (d, feat.shape[1]))
            p[f"{name}_b"] = torch_linear_init(generator, d, feat.shape[1])[1]
        p["lambda_m"] = torch.tensor(0.1, dtype=torch.float32, device=generator.device)
        return p

    def forward(self, params: Params):
        """(u_g, i_g, u_v, i_v, u_t, i_t): the three towers' outputs."""
        v_emb = self.v_feat @ params["image_trs_w"].T + params["image_trs_b"]
        t_emb = self.t_feat @ params["text_trs_w"].T + params["text_trs_b"]
        acc_u = cu = torch.cat([params["user_embedding"], params["user_embedding_v"],
                                params["user_embedding_t"]], 1)
        acc_i = ci = torch.cat([params["item_embedding"], v_emb, t_emb], 1)
        for _ in range(self.n_layers):
            cu, ci = self.graph.propagate(cu, ci)
            acc_u, acc_i = acc_u + cu, acc_i + ci
        s = 1.0 / (self.n_layers + 1)
        u_g, u_v, u_t = torch.chunk(acc_u * s, 3, dim=1)
        i_g, i_v, i_t = torch.chunk(acc_i * s, 3, dim=1)
        return u_g, i_g, u_v, i_v, u_t, i_t

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        u_g, i_g, u_v, i_v, u_t, i_t = self.forward(params)
        bu, bi, bn, w = batch.users, batch.pos_items, batch.neg_items, batch.weights
        total = 0.0
        for uu, ii in ((u_g, i_g), (u_v, i_v), (u_t, i_t)):
            u, pos, neg = uu[bu], ii[bi], ii[bn]
            total = total + bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w,
                                     eps=1e-5) + emb_l2_reg(self.reg_weight, (u, pos, neg), w)
        t = self.ssl_temp
        cl = in_batch_ce(l2norm(u_g[bu]), l2norm(u_v[bu]), t, w)
        cl = cl + in_batch_ce(l2norm(u_g[bu]), l2norm(u_t[bu]), t, w)
        cl = cl + in_batch_ce(l2norm(i_g[bi]), l2norm(i_v[bi]), t, w)
        cl = cl + in_batch_ce(l2norm(i_g[bi]), l2norm(i_t[bi]), t, w)
        return total + self.ssl_alpha * cl

    def embeddings(self, params: Params):
        u_g, i_g, *_ = self.forward(params)
        return u_g, i_g
