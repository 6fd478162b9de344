"""BM3: bootstrapped multimodal latent targets, no negatives.

Counterpart of ``chaorec_tpu/models/bm3.py`` (reference: Model/BM3.py):

- a LightGCN backbone (the mean of layers 0..n), the item output plus the
  raw item table (Model/BM3.py:53-68);
- the targets are dropout-perturbed copies, without gradient, of the online
  user and item embeddings and of the projected modality features; the
  online branches go through one shared predictor Linear(dim_E, dim_E)
  (Model/BM3.py:70-100);
- loss = the (1 - cos) pairs u-i and i-u, + cl_weight * (t-i, t-t, v-i,
  v-v), + reg_weight * (mean u^2 + mean i^2) over the FULL propagated
  tables (Model/BM3.py:102-118);
- ranking applies the predictor to both tables (Model/BM3.py:120-127);
- the raw modality tables are trainable (``freeze=False``), their
  projections xavier-normal.

``draws`` makes a step's four dropout keep masks (users, items, textual,
visual) and ``loss_with_draws`` takes them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_normal, xavier_uniform
from chaorec_tpu_torch.ops.losses import l2norm, masked_mean

Draws = Dict[str, torch.Tensor]


class BM3(RecModel):
    name = "BM3"

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph,
                 v_feat: torch.Tensor, t_feat: torch.Tensor, dim_E: int, feat_E: int,
                 reg_weight: float, dropout: float, n_layers: int, cl_weight: float):
        super().__init__(num_user, num_item)
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.feat_E = feat_E
        self.reg_weight = reg_weight
        self.dropout = dropout
        self.n_layers = n_layers
        self.cl_weight = cl_weight
        self._v_init, self._t_init = v_feat, t_feat

    def init_params(self, generator: torch.Generator) -> Params:
        d, fe = self.dim_E, self.feat_E
        p = {"user_embedding": xavier_uniform(generator, (self.num_user, d)),
             "item_embedding": xavier_uniform(generator, (self.num_item, d))}
        p["predictor_w"], p["predictor_b"] = torch_linear_init(generator, d, d)
        p["v_feat"], p["t_feat"] = self._v_init.clone(), self._t_init.clone()
        for name, feat in (("image_trs", self._v_init), ("text_trs", self._t_init)):
            p[f"{name}_w"] = xavier_normal(generator, (fe, feat.shape[1]))
            p[f"{name}_b"] = torch_linear_init(generator, fe, feat.shape[1])[1]
        return p

    def draws(self, generator: torch.Generator, batch: Optional[Batch] = None) -> Draws:
        """The targets' 0/1 keep masks (keep 1 - dropout): "u" (U, dim_E),
        "i" (I, dim_E), "t" and "v" (I, feat_E)."""
        keep = 1.0 - self.dropout
        shapes = {"u": (self.num_user, self.dim_E), "i": (self.num_item, self.dim_E),
                  "t": (self.num_item, self.feat_E), "v": (self.num_item, self.feat_E)}
        return {k: (torch.rand(s, generator=generator, device=self.device) < keep).float()
                for k, s in shapes.items()}

    def forward(self, params: Params):
        acc_u, acc_i = cu, ci = params["user_embedding"], params["item_embedding"]
        for _ in range(self.n_layers):
            cu, ci = self.graph.propagate(cu, ci)
            acc_u, acc_i = acc_u + cu, acc_i + ci
        s = 1.0 / (self.n_layers + 1)
        return acc_u * s, acc_i * s + params["item_embedding"]

    def _pred(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return x @ params["predictor_w"].T + params["predictor_b"]

    def loss_with_draws(self, params: Params, batch: Batch, draws: Draws) -> torch.Tensor:
        u_ori, i_ori = self.forward(params)
        t_online = params["t_feat"] @ params["text_trs_w"].T + params["text_trs_b"]
        v_online = params["v_feat"] @ params["image_trs_w"].T + params["image_trs_b"]
        keep = 1.0 - self.dropout

        def target(x, mask):
            return (x * mask / keep).detach()

        u_t, i_t = target(u_ori, draws["u"]), target(i_ori, draws["i"])
        t_t, v_t = target(t_online, draws["t"]), target(v_online, draws["v"])
        bu, bi, w = batch.users, batch.pos_items, batch.weights
        u_on = self._pred(params, u_ori)[bu]
        i_on = self._pred(params, i_ori)[bi]
        t_on = self._pred(params, t_online)[bi]
        v_on = self._pred(params, v_online)[bi]

        def one_minus_cos(a, b):
            return masked_mean(1.0 - torch.sum(l2norm(a) * l2norm(b), dim=1), w)

        loss_t = one_minus_cos(t_on, i_t[bi])
        loss_tv = one_minus_cos(t_on, t_t[bi])
        loss_v = one_minus_cos(v_on, i_t[bi])
        loss_vt = one_minus_cos(v_on, v_t[bi])
        loss_ui = one_minus_cos(u_on, i_t[bi])
        loss_iu = one_minus_cos(i_on, u_t[bu])
        reg = self.reg_weight * (torch.mean(u_ori ** 2) + torch.mean(i_ori ** 2))
        return (loss_ui + loss_iu) + reg + self.cl_weight * (loss_t + loss_v + loss_tv + loss_vt)

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        return self.loss_with_draws(params, batch, self.draws(generator, batch))

    def embeddings(self, params: Params):
        u, i = self.forward(params)
        return self._pred(params, u), self._pred(params, i)
