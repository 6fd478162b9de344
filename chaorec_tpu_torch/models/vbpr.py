"""VBPR: visual BPR.

Counterpart of ``chaorec_tpu/models/vbpr.py`` (reference: Model/VBPR.py):

- an item is its id embedding (dim_E) beside a Linear of its visual
  features (64 wide whatever ``feature_embedding`` says: the width is
  hard-coded, Model/VBPR.py:25-37, kept); a user's embedding is dim_E + 64
  wide;
- the raw visual features are a trainable table (``Embedding.from_pretrained``
  with ``freeze=False``, Model/VBPR.py:35), stepped by the dense Adam;
- BPR (1e-5 inside the log) + the mean reg of the batch's rows
  (Model/VBPR.py:49-73).
"""

from __future__ import annotations

import torch

from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_uniform
from chaorec_tpu_torch.ops.losses import bpr_loss, emb_l2_reg


class VBPR(RecModel):
    name = "VBPR"
    dp_split = True  # weighted means over rows (tests/test_torch_mesh.py)
    visual_embedding = 64  # Model/VBPR.py:25

    def __init__(self, num_user: int, num_item: int, v_feat: torch.Tensor, dim_E: int,
                 feature_embedding: int, reg_weight: float):
        super().__init__(num_user, num_item)
        self.device = v_feat.device
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.v_dim = int(v_feat.shape[1])
        self._v_feat_init = v_feat

    def init_params(self, generator: torch.Generator) -> Params:
        ve = self.visual_embedding
        return {
            "user_embedding": xavier_uniform(generator, (self.num_user, self.dim_E + ve)),
            "item_embedding": xavier_uniform(generator, (self.num_item, self.dim_E)),
            "v_feat": self._v_feat_init.clone(),  # trainable (freeze=False)
            "item_linear_w": xavier_uniform(generator, (ve, self.v_dim)),
            "item_linear_b": torch_linear_init(generator, ve, self.v_dim)[1],
        }

    def _item_table(self, params: Params) -> torch.Tensor:
        vis = params["v_feat"] @ params["item_linear_w"].T + params["item_linear_b"]
        return torch.cat([params["item_embedding"], vis], 1)

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        items = self._item_table(params)
        u = params["user_embedding"][batch.users]
        pos, neg = items[batch.pos_items], items[batch.neg_items]
        w = batch.weights
        return (bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w, eps=1e-5)
                + emb_l2_reg(self.reg_weight, (u, pos, neg), w))

    def embeddings(self, params: Params):
        return params["user_embedding"], self._item_table(params)
