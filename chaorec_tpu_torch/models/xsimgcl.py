"""XSimGCL: SimGCL with one perturbed forward and a cross-layer view.

Counterpart of ``chaorec_tpu/models/xsimgcl.py`` (reference:
Model/XSimGCL.py):

- one perturbed forward a step: the final embedding is the mean of the
  perturbed layers 1..L, the contrastive view the perturbed layer
  ``layer_cl`` (1) (Model/XSimGCL.py:107-127; eps 0.2, :49-50);
- loss = BPR (1e-5) on the perturbed final embedding + reg (users and
  positives only) + ssl_reg * (InfoNCE(final u, view u) + InfoNCE(final
  i, view i)) at the batch's rows, in-batch negatives
  (Model/XSimGCL.py:153-171). The loss never uses the operator;
- ranking by the unperturbed forward, through ``linear_op.full`` when
  ``models/builders.py:_maybe_op`` made one.

It shares SimGCL's constructor and ranking. ``noise_draws`` draws the
one view's noise (``SimGCL.layer_noise``) and
``loss_with_noise`` computes the loss from it.
"""

from __future__ import annotations

import torch

from chaorec_tpu_torch.models.base import Batch, Params
from chaorec_tpu_torch.models.simgcl import LayerNoise, SimGCL, layer_mean
from chaorec_tpu_torch.ops.losses import bpr_loss, info_nce, masked_mean


class XSimGCL(SimGCL):
    name = "XSimGCL"
    eps = 0.2  # Model/XSimGCL.py:49
    layer_cl = 1  # Model/XSimGCL.py:50

    def noise_draws(self, generator: torch.Generator):
        return self.layer_noise(generator)

    def loss_with_noise(self, params: Params, batch: Batch, noise: LayerNoise) -> torch.Tensor:
        w = batch.weights
        layers = self.layers(params, noise)
        user_emb, item_emb = layer_mean(layers)
        cl_u, cl_i = layers[self.layer_cl - 1]
        u = user_emb[batch.users]
        pos = item_emb[batch.pos_items]
        neg = item_emb[batch.neg_items]
        bpr = bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w, eps=1e-5)
        reg = self.reg_weight * (masked_mean(torch.mean(u ** 2, 1), w)
                                 + masked_mean(torch.mean(pos ** 2, 1), w))
        cl = (info_nce(u, cl_u[batch.users], self.ssl_temp, w)
              + info_nce(pos, cl_i[batch.pos_items], self.ssl_temp, w))
        return bpr + reg + self.ssl_reg * cl
