"""BPR matrix factorization with an item bias.

Counterpart of ``chaorec_tpu/models/bpr.py`` (reference: Model/BPR.py,
class ``BPRMF``):

- xavier-normal id tables and a zero item bias (Model/BPR.py:21-31);
- scores <u, i> + b_i (Model/BPR.py:44-47);
- BPR loss -mean(log(sigmoid(pos - neg))) with *no* epsilon
  (Model/BPR.py:58);
- regularization reg_weight * (mean(u^2) + mean(pos^2) + mean(neg)): the
  reference leaves the negative term unsquared (Model/BPR.py:60), kept;
- ranking by the tables alone, without the bias (Model/BPR.py:71-78).
"""

from __future__ import annotations

import torch

from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import xavier_normal
from chaorec_tpu_torch.ops.losses import bpr_loss, masked_mean


class BPRMF(RecModel):
    name = "BPR"
    dp_split = True  # weighted means over rows (tests/test_torch_mesh.py)

    def __init__(self, num_user: int, num_item: int, dim_E: int, reg_weight: float,
                 device: torch.device | str = "cpu"):
        super().__init__(num_user, num_item)
        self.device = torch.device(device)
        self.dim_E = dim_E
        self.reg_weight = reg_weight

    def init_params(self, generator: torch.Generator) -> Params:
        return {
            "user_embedding": xavier_normal(generator, (self.num_user, self.dim_E)),
            "item_embedding": xavier_normal(generator, (self.num_item, self.dim_E)),
            "item_bias": torch.zeros(self.num_item, dtype=torch.float32,
                                     device=generator.device),
        }

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        u = params["user_embedding"][batch.users]
        pos = params["item_embedding"][batch.pos_items]
        neg = params["item_embedding"][batch.neg_items]
        pos_scores = torch.sum(u * pos, 1) + params["item_bias"][batch.pos_items]
        neg_scores = torch.sum(u * neg, 1) + params["item_bias"][batch.neg_items]
        w = batch.weights
        # the negative term unsquared, as the reference's
        reg = self.reg_weight * (masked_mean(torch.mean(u ** 2, 1), w)
                                 + masked_mean(torch.mean(pos ** 2, 1), w)
                                 + masked_mean(torch.mean(neg, 1), w))
        return bpr_loss(pos_scores, neg_scores, w, eps=0.0) + reg

    def embeddings(self, params: Params):
        return params["user_embedding"], params["item_embedding"]
