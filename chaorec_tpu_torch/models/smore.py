"""SMORE: spectral fusion multimodal recommendation.

Counterpart of ``chaorec_tpu/models/smore.py`` (reference: Model/SMORE.py):

- spectral convolution: ``torch.fft.rfft`` over the embedding dim
  (norm "ortho"), a learned complex weight per modality ((1, dim/2 + 1, 2)
  real pairs), the fusion spectrum the product of both times its own
  weight, ``irfft`` back to dim_E (Model/SMORE.py:275-294);
- modal and fusion item views: sigmoid gates of the spectral features times
  the id item table, each propagated once over its graph: the image and
  text kNN graphs (``graphs/knn.knn_topk`` + ``topk_sym_norm``) and their
  elementwise maximum on the union of their patterns
  (``graphs/knn.union_max``; Model/SMORE.py:201-227, 296-346);
- modal user views: one R @ the three item views side by side, split in
  three (the operator is columnwise, so each third is that view's R @);
- per-view softmax attention (query_v, query_t over the fusion view),
  preference gates of the behavior view with dropout, side = the mean of
  the three views, final = content + side (Model/SMORE.py:348-375);
- loss = BPR (log-sigmoid) + reg_weight * 0.5 * sum of squares / 1024 (the
  reference's hard-coded batch size) + 0.01 * in-batch InfoNCE (side vs
  content, items and users) at temperature 0.2 (Model/SMORE.py:380-425).

``draws`` makes a step's preference-gate keep masks (none at dropout 0) and
``loss_with_draws`` takes them: one (rows, dim_E) mask a gate for the users
and one for the items, as the JAX package draws both from the same three
keys at the two shapes.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from chaorec_tpu_torch.graphs.knn import knn_topk, topk_sym_norm, union_max
from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.models.slmrec import in_batch_ce
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_uniform
from chaorec_tpu_torch.ops.losses import l2norm, masked_mean

Draws = Dict[str, torch.Tensor]
GATES = ("gate_v", "gate_t", "gate_f", "gate_image_prefer", "gate_text_prefer",
         "gate_fusion_prefer")
PREFER = ("image", "text", "fusion")


class SMORE(RecModel):
    name = "SMORE"
    cl_weight = 0.01  # Model/SMORE.py:101
    cl_temp = 0.2
    ref_batch = 1024.0
    n_modal_layers = 1

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph,
                 v_feat: torch.Tensor, t_feat: torch.Tensor, dim_E: int, reg_weight: float,
                 n_ui_layers: int, ii_topk: int, dropout: float):
        super().__init__(num_user, num_item)
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.n_ui_layers = n_ui_layers
        self.dropout = dropout
        self._v_init, self._t_init = v_feat, t_feat
        k = min(ii_topk, num_item)
        self.image_adj = topk_sym_norm(*knn_topk(v_feat, k))
        self.text_adj = topk_sym_norm(*knn_topk(t_feat, k))
        self.fusion_adj = union_max(self.image_adj, self.text_adj)

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
        for name in ("query_v", "query_t"):
            p[f"{name}_w1"], p[f"{name}_b1"] = torch_linear_init(generator, d, d)
            p[f"{name}_w2"] = torch_linear_init(generator, d, d)[0]
        nf = d // 2 + 1
        for name in ("image", "text", "fusion"):
            p[f"{name}_complex_weight"] = torch.randn((1, nf, 2), generator=generator,
                                                      device=generator.device)
        return p

    @staticmethod
    def _gate(params: Params, name: str, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(x @ params[f"{name}_w"].T + params[f"{name}_b"])

    @staticmethod
    def _query(params: Params, name: str, x: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(x @ params[f"{name}_w1"].T + params[f"{name}_b1"])
        return h @ params[f"{name}_w2"].T

    @staticmethod
    def _spectrum(params: Params, image_feats: torch.Tensor, text_feats: torch.Tensor):
        img_fft = torch.fft.rfft(image_feats, dim=1, norm="ortho")
        txt_fft = torch.fft.rfft(text_feats, dim=1, norm="ortho")

        def cw(name):
            w = params[f"{name}_complex_weight"]
            return torch.complex(w[..., 0], w[..., 1])

        n = image_feats.shape[1]
        img = torch.fft.irfft(img_fft * cw("image"), n=n, dim=1, norm="ortho")
        txt = torch.fft.irfft(txt_fft * cw("text"), n=n, dim=1, norm="ortho")
        fus = torch.fft.irfft(txt_fft * img_fft * cw("fusion"), n=n, dim=1, norm="ortho")
        return img, txt, fus

    def draws(self, generator: torch.Generator, batch: Optional[Batch] = None) -> Draws:
        """0/1 keep masks (keep 1 - dropout) of the preference gates:
        "{image,text,fusion}_u" (U, dim_E) and "{...}_i" (I, dim_E); none at
        dropout 0."""
        if self.dropout <= 0:
            return {}
        keep = 1.0 - self.dropout
        out = {}
        for side, n in (("u", self.num_user), ("i", self.num_item)):
            for name in PREFER:
                out[f"{name}_{side}"] = (torch.rand((n, self.dim_E), generator=generator,
                                                    device=self.device) < keep).float()
        return out

    def forward(self, params: Params, draws: Optional[Draws] = None):
        """(final users, final items, side users, side items, content users,
        content items); the preference gates dropped out under ``draws``."""
        image_feats = params["v_feat"] @ params["image_trs_w"].T + params["image_trs_b"]
        text_feats = params["t_feat"] @ params["text_trs_w"].T + params["text_trs_b"]
        img_c, txt_c, fus_c = self._spectrum(params, image_feats, text_feats)
        items = params["item_embedding"]
        img_i = items * self._gate(params, "gate_v", img_c)
        txt_i = items * self._gate(params, "gate_t", txt_c)
        fus_i = items * self._gate(params, "gate_f", fus_c)

        acc_u, acc_i = xu, xi = params["user_embedding"], items
        for _ in range(self.n_ui_layers):
            xu, xi = self.graph.propagate(xu, xi)
            acc_u, acc_i = acc_u + xu, acc_i + xi
        s = 1.0 / (self.n_ui_layers + 1)
        content_u, content_i = acc_u * s, acc_i * s

        for _ in range(self.n_modal_layers):
            img_i = self.image_adj.propagate(img_i)
            txt_i = self.text_adj.propagate(txt_i)
            fus_i = self.fusion_adj.propagate(fus_i)
        img_u, txt_u, fus_u = torch.chunk(self.graph.apply_r(torch.cat([img_i, txt_i, fus_i], 1)),
                                          3, dim=1)
        keep = 1.0 - self.dropout

        def assemble(img, txt, fus, content, side):
            agg_img = F.softmax(self._query(params, "query_v", fus), dim=-1) * img
            agg_txt = F.softmax(self._query(params, "query_t", fus), dim=-1) * txt
            prefer = [self._gate(params, f"gate_{name}_prefer", content) for name in PREFER]
            if draws:
                prefer = [p * draws[f"{name}_{side}"] / keep for p, name in zip(prefer, PREFER)]
            out = (prefer[0] * agg_img + prefer[1] * agg_txt + prefer[2] * fus) / 3.0
            return content + out, out

        fin_u, side_u = assemble(img_u, txt_u, fus_u, content_u, "u")
        fin_i, side_i = assemble(img_i, txt_i, fus_i, content_i, "i")
        return fin_u, fin_i, side_u, side_i, content_u, content_i

    def loss_with_draws(self, params: Params, batch: Batch, draws: Draws) -> torch.Tensor:
        fu, fi, side_u, side_i, content_u, content_i = self.forward(params, draws)
        bu, bp, w = batch.users, batch.pos_items, batch.weights
        u, pos, neg = fu[bu], fi[bp], fi[batch.neg_items]
        mf = -masked_mean(F.logsigmoid(torch.sum(u * pos, 1) - torch.sum(u * neg, 1)), w)
        reg = self.reg_weight * 0.5 * (
            torch.sum((u ** 2) * w[:, None]) + torch.sum((pos ** 2) * w[:, None])
            + torch.sum((neg ** 2) * w[:, None])) / self.ref_batch
        cl = (in_batch_ce(l2norm(side_i[bp]), l2norm(content_i[bp]), self.cl_temp, w)
              + in_batch_ce(l2norm(side_u[bu]), l2norm(content_u[bu]), self.cl_temp, w))
        return mf + reg + self.cl_weight * cl

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        return self.loss_with_draws(params, batch, self.draws(generator, batch))

    def embeddings(self, params: Params):
        fu, fi, *_ = self.forward(params)
        return fu, fi
