"""DHCF: dual-channel hypergraph CF with jump connections.

Counterpart of ``chaorec_tpu/models/dhcf.py`` (reference: Model/DHCF.py):

- the hypergraph incidence with jumps: Hu = [H, H (H^T H)] for users and
  Hi = [H^T, (H (H^T H))^T] for items; a layer applies
  ``M x = D_v^-1/2 Hu D_e^-1 Hu^T D_v^-1/2 x + x``. G = H (H^T H) is
  computed once and the operator is applied factored, four float32
  products a side, never concatenated (the reference materializes Hu,
  Model/DHCF.py:32-52);
- each layer: elementwise dropout on its inputs, then the DJconv
  ``(M x) W`` (Model/DHCF.py:54-69, 115-127). The reference keeps its
  DJconv layers in a plain Python list, so W never reaches the optimizer
  and stays at its xavier-uniform init (main.py:397); its b, uninitialized
  memory in the reference, is zero in the JAX package and so absent here.
  The W are buffers, drawn from a generator seeded ``seed + 7`` (the JAX
  package's ``_dhcf`` uses ``PRNGKey(seed + 7)``); ``load_frozen_weights``
  sets them, to carry the JAX package's over;
- the output: ego and every layer's output concatenated per side; BPR
  (1e-5 inside the log) + the mean-style L2 of the concatenated rows
  (Model/DHCF.py:133-171).

``draws`` makes the step's dropout masks (none at dropout 0, the first
combo of Model_YAML/DHCF.yaml), and ``loss_with_draws`` computes the loss
from them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import xavier_uniform
from chaorec_tpu_torch.ops.losses import bpr_loss, emb_l2_reg


class DHCF(RecModel):
    name = "DHCF"
    dp_split = True  # weighted means over rows (tests/test_torch_mesh.py)

    def __init__(self, num_user: int, num_item: int, dense_h: torch.Tensor, dim_E: int,
                 reg_weight: float, n_layers: int, dropout: float, seed: int):
        super().__init__(num_user, num_item)
        self.device = dense_h.device
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.n_layers = n_layers
        self.dropout = dropout
        h = dense_h.to(torch.float32)  # (U, I)
        g = h @ (h.t() @ h)  # (U, I)
        self.h, self.g = h, g
        # user side: Hu = [H, G] (U x 2I); item side: Hi = [H^T, G^T] (I x 2U)
        self.dv_u = (torch.sum(h, 1) + torch.sum(g, 1) + 1e-7) ** -0.5
        self.de_u = 1.0 / (torch.cat([torch.sum(h, 0), torch.sum(g, 0)]) + 1e-7)
        self.dv_i = (torch.sum(h, 0) + torch.sum(g, 0) + 1e-7) ** -0.5
        self.de_i = 1.0 / (torch.cat([torch.sum(h, 1), torch.sum(g, 1)]) + 1e-7)
        gen = torch.Generator(self.device).manual_seed(seed + 7)
        self.frozen_w = [xavier_uniform(gen, (dim_E, dim_E)) for _ in range(n_layers)]

    def load_frozen_weights(self, weights: Sequence) -> None:
        """Set the frozen DJconv W of each layer (numpy arrays or tensors),
        e.g. the JAX package's ``frozen_w``."""
        if len(weights) != self.n_layers:
            raise ValueError(f"{len(weights)} weights for {self.n_layers} layers")
        self.frozen_w = [torch.tensor(np.asarray(w), dtype=torch.float32, device=self.device)
                         for w in weights]

    def init_params(self, generator: torch.Generator) -> Params:
        return {
            "user_embedding": xavier_uniform(generator, (self.num_user, self.dim_E)),
            "item_embedding": xavier_uniform(generator, (self.num_item, self.dim_E)),
        }

    def _m_user(self, x: torch.Tensor) -> torch.Tensor:
        xv = self.dv_u[:, None] * x
        y1, y2 = self.h.t() @ xv, self.g.t() @ xv
        z = (self.h @ (self.de_u[:self.num_item, None] * y1)
             + self.g @ (self.de_u[self.num_item:, None] * y2))
        return self.dv_u[:, None] * z + x

    def _m_item(self, x: torch.Tensor) -> torch.Tensor:
        xv = self.dv_i[:, None] * x
        y1, y2 = self.h @ xv, self.g @ xv
        z = (self.h.t() @ (self.de_i[:self.num_user, None] * y1)
             + self.g.t() @ (self.de_i[self.num_user:, None] * y2))
        return self.dv_i[:, None] * z + x

    def draws(self, generator: torch.Generator, batch: Batch, state=None
              ) -> Optional[List[Tuple[torch.Tensor, torch.Tensor]]]:
        """Each layer's (user (U, dim_E), item (I, dim_E)) keep masks, or
        None without dropout."""
        if self.dropout <= 0:
            return None
        keep = 1.0 - self.dropout
        return [tuple((torch.rand((n, self.dim_E), generator=generator, device=self.device)
                       < keep).float() for n in (self.num_user, self.num_item))
                for _ in range(self.n_layers)]

    def forward(self, params: Params, draws=None) -> Tuple[torch.Tensor, torch.Tensor]:
        cu, ci = params["user_embedding"], params["item_embedding"]
        out_u, out_i = [cu], [ci]
        for layer in range(self.n_layers):
            if draws is not None:
                keep = 1.0 - self.dropout
                cu = cu * draws[layer][0] / keep
                ci = ci * draws[layer][1] / keep
            w = self.frozen_w[layer]
            cu = self._m_user(cu) @ w
            ci = self._m_item(ci) @ w
            out_u.append(cu)
            out_i.append(ci)
        return torch.cat(out_u, 1), torch.cat(out_i, 1)

    def loss_with_draws(self, params: Params, batch: Batch, draws) -> torch.Tensor:
        fu, fi = self.forward(params, draws)
        u, pos, neg = fu[batch.users], fi[batch.pos_items], fi[batch.neg_items]
        w = batch.weights
        return (bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w, eps=1e-5)
                + emb_l2_reg(self.reg_weight, (u, pos, neg), w))

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        return self.loss_with_draws(params, batch, self.draws(generator, batch))

    def embeddings(self, params: Params):
        return self.forward(params)
