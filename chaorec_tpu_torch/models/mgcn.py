"""MGCN: behavior-guided modality purifier and view fusion.

Counterpart of ``chaorec_tpu/models/mgcn.py`` (reference: Model/MGCN.py):

- fixed n_layers 1 (modal), n_ui_layers 2, knn_k 10 (Model/MGCN.py:82-95);
- the raw image and text features are trainable params, projected by a
  Linear each;
- modal item views: sigmoid gates of the projected features times the id
  item table, each propagated once over its frozen kNN graph
  (``graphs/knn.knn_topk`` + ``topk_sym_norm``); modal user views are
  R @ the modal item view (Model/MGCN.py:190-219);
- the behavior view is the mean of layers 0..2 of the U-I propagation
  (Model/MGCN.py:198-208), on the sparse graph the builder makes;
- fusion: one query MLP's softmax over the two modalities gives the common
  part, the residuals are gated by preference gates of the behavior view,
  side = (sep_v + sep_t + common) / 3, final = content + side
  (Model/MGCN.py:221-239);
- loss = BPR (1e-5 inside the log) + the batch's mean squared rows times
  reg_weight + ssl_alpha * (in-batch InfoNCE of side vs content, items and
  users) (Model/MGCN.py:299-325). No random draws.
"""

from __future__ import annotations

import torch

from chaorec_tpu_torch.graphs.knn import knn_topk, topk_sym_norm
from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.models.slmrec import in_batch_ce
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_uniform
from chaorec_tpu_torch.ops.losses import bpr_loss, emb_l2_reg, l2norm

GATES = ("gate_v", "gate_t", "gate_image_prefer", "gate_text_prefer")


class MGCN(RecModel):
    name = "MGCN"
    n_modal_layers = 1
    n_ui_layers = 2
    knn_k = 10

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph,
                 v_feat: torch.Tensor, t_feat: torch.Tensor, dim_E: int, reg_weight: float,
                 ssl_temp: float, ssl_alpha: float):
        super().__init__(num_user, num_item)
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.ssl_temp = ssl_temp
        self.ssl_alpha = ssl_alpha
        self._v_init, self._t_init = v_feat, t_feat
        k = min(self.knn_k, num_item)
        self.image_adj = topk_sym_norm(*knn_topk(v_feat, k))
        self.text_adj = topk_sym_norm(*knn_topk(t_feat, k))

    def init_params(self, generator: torch.Generator) -> Params:
        d = self.dim_E
        p = {"user_embedding": xavier_uniform(generator, (self.num_user, d)),
             "item_embedding": xavier_uniform(generator, (self.num_item, d)),
             "v_feat": self._v_init.clone(), "t_feat": self._t_init.clone()}
        p["image_trs_w"], p["image_trs_b"] = torch_linear_init(generator, d,
                                                               self._v_init.shape[1])
        p["text_trs_w"], p["text_trs_b"] = torch_linear_init(generator, d, self._t_init.shape[1])
        for name in GATES:
            p[f"{name}_w"], p[f"{name}_b"] = torch_linear_init(generator, d, d)
        p["query_w1"], p["query_b1"] = torch_linear_init(generator, d, d)
        p["query_w2"] = torch_linear_init(generator, 1, d)[0]
        return p

    @staticmethod
    def _gate(params: Params, name: str, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(x @ params[f"{name}_w"].T + params[f"{name}_b"])

    @staticmethod
    def _query(params: Params, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(x @ params["query_w1"].T + params["query_b1"]) @ params["query_w2"].T

    def forward(self, params: Params):
        """(final users, final items, side users, side items, content users,
        content items)."""
        image_feats = params["v_feat"] @ params["image_trs_w"].T + params["image_trs_b"]
        text_feats = params["t_feat"] @ params["text_trs_w"].T + params["text_trs_b"]
        items = params["item_embedding"]
        image_item = items * self._gate(params, "gate_v", image_feats)
        text_item = items * self._gate(params, "gate_t", text_feats)

        acc_u, acc_i = xu, xi = params["user_embedding"], items
        for _ in range(self.n_ui_layers):
            xu, xi = self.graph.propagate(xu, xi)
            acc_u, acc_i = acc_u + xu, acc_i + xi
        s = 1.0 / (self.n_ui_layers + 1)
        content_u, content_i = acc_u * s, acc_i * s

        for _ in range(self.n_modal_layers):
            image_item = self.image_adj.propagate(image_item)
            text_item = self.text_adj.propagate(text_item)
        image_user = self.graph.apply_r(image_item)
        text_user = self.graph.apply_r(text_item)

        def fuse(img, txt, content):
            att = torch.cat([self._query(params, img), self._query(params, txt)], -1)
            w = torch.softmax(att, dim=-1)
            common = w[:, :1] * img + w[:, 1:] * txt
            sep_i = (img - common) * self._gate(params, "gate_image_prefer", content)
            sep_t = (txt - common) * self._gate(params, "gate_text_prefer", content)
            return (sep_i + sep_t + common) / 3.0

        side_u = fuse(image_user, text_user, content_u)
        side_i = fuse(image_item, text_item, content_i)
        return (content_u + side_u, content_i + side_i, side_u, side_i, content_u, content_i)

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        fu, fi, side_u, side_i, content_u, content_i = self.forward(params)
        bu, bp, w = batch.users, batch.pos_items, batch.weights
        u, pos, neg = fu[bu], fi[bp], fi[batch.neg_items]
        total = bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w, eps=1e-5)
        total = total + emb_l2_reg(self.reg_weight, (u, pos, neg), w)
        ssl = (in_batch_ce(l2norm(side_i[bp]), l2norm(content_i[bp]), self.ssl_temp, w)
               + in_batch_ce(l2norm(side_u[bu]), l2norm(content_u[bu]), self.ssl_temp, w))
        return total + self.ssl_alpha * ssl

    def embeddings(self, params: Params):
        fu, fi, *_ = self.forward(params)
        return fu, fi
