"""DGCF: disentangled graph CF with neighbour routing.

Counterpart of ``chaorec_tpu/models/dgcf.py`` (reference: Model/DGCF.py):

- the embeddings are split into ``n_factors`` chunks; per layer,
  ``n_iterations`` of routing: the scores S (n_factors, E), softmaxed
  across factors, weight each factor chunk's propagation with ``deg_norm *
  s_k`` per edge over the undirected graph (DGCFConv, Model/DGCF.py:20-46),
  and S grows by ``<normalize(x_k[u]), tanh(normalize(ego_k[i]))>`` per
  train edge, the updated user chunk against the item chunk from before
  the update (eq. 11, Model/DGCF.py:124-144);
- **S is training state** (ones at the start, Model/DGCF.py:75-76, carried
  from batch to batch): ``loss_stateful`` returns the new S, detached. It
  is in the order of ``dataset.train_edges``, which are not sorted;
- each propagation is two ``ops/ell.seg_gather``s and two ``seg_sum``s, so
  a step runs the prefix kernel 4 x n_factors x n_iterations x n_layers
  times (the sums forward, the gathers' backward);
- final = the SUM over the layers, ego included (Model/DGCF.py:149-152);
- loss = BPR (+1e-5) + the mean reg of the propagated rows + corDecay x the
  mean distance correlation of consecutive factor chunks of the batch's
  [user; positive] rows (Model/DGCF.py:180-199, utils.py:83-108).

The distance correlation takes every row of the batch, unweighted. Here
an epoch's last batch is short, as the reference's; the JAX package pads it
with weight-0 repeats of one edge, which enter its correlation.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.distcorr import distance_correlation
from chaorec_tpu_torch.ops.ell import build_segment_transpose, seg_gather, seg_sum
from chaorec_tpu_torch.ops.init import xavier_uniform
from chaorec_tpu_torch.ops.losses import bpr_loss, emb_l2_reg
from chaorec_tpu_torch.ops.losses import l2norm as _norm  # zero-row safe


class DGCF(RecModel):
    name = "DGCF"
    stateful = True

    def __init__(self, num_user: int, num_item: int, edges: np.ndarray, dim_E: int,
                 reg_weight: float, cor_decay: float, n_factors: int, n_iterations: int,
                 n_layers: int, device: torch.device | str = "cpu"):
        super().__init__(num_user, num_item)
        if dim_E % n_factors:
            raise ValueError(f"dim_E {dim_E} is not a multiple of n_factors {n_factors}")
        self.device = torch.device(device)
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.cor_decay = cor_decay
        self.n_factors = n_factors
        self.n_iterations = n_iterations
        self.n_layers = n_layers
        # The directed train edges in the dataset's order; the undirected
        # propagation gives both directions an edge's score.
        self.edge_u = torch.from_numpy(edges[:, 0].astype(np.int64)).to(self.device)
        self.edge_i = torch.from_numpy(edges[:, 1].astype(np.int64)).to(self.device)
        self._perm_u, self._ptr_u = build_segment_transpose(self.edge_u, num_user)
        self._perm_i, self._ptr_i = build_segment_transpose(self.edge_i, num_item)
        du = np.bincount(edges[:, 0], minlength=num_user).astype(np.float32)
        di = np.bincount(edges[:, 1], minlength=num_item).astype(np.float32)
        dd = 1.0 / np.sqrt(np.maximum(du[edges[:, 0]] * di[edges[:, 1]], 1.0))
        self.edge_w = torch.from_numpy(dd.astype(np.float32)).to(self.device)

    def init_params(self, generator: torch.Generator) -> Params:
        return {
            "user_embedding": xavier_uniform(generator, (self.num_user, self.dim_E)),
            "item_embedding": xavier_uniform(generator, (self.num_item, self.dim_E)),
        }

    def init_state(self, device: torch.device | str = "cpu", generator=None) -> torch.Tensor:
        return torch.ones((self.n_factors, self.edge_u.shape[0]), dtype=torch.float32,
                          device=device)

    def _propagate_factor(self, xu, xi, s):
        w = (self.edge_w * s)[:, None]
        new_u = seg_sum(w * seg_gather(xi, self.edge_i, self._perm_i, self._ptr_i),
                        self.edge_u, self._perm_u, self._ptr_u)
        new_i = seg_sum(w * seg_gather(xu, self.edge_u, self._perm_u, self._ptr_u),
                        self.edge_i, self._perm_i, self._ptr_i)
        return new_u, new_i

    def forward(self, params: Params, s_state: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        ego_u, ego_i = params["user_embedding"], params["item_embedding"]
        acc_u, acc_i = ego_u, ego_i
        s = s_state
        for _ in range(self.n_layers):
            chunks_u = torch.chunk(ego_u, self.n_factors, dim=1)
            chunks_i = torch.chunk(ego_i, self.n_factors, dim=1)
            layer_u, layer_i = None, None
            for _t in range(self.n_iterations):
                s_soft = torch.softmax(s, dim=0)
                iter_u, iter_i, s_updates = [], [], []
                for k in range(self.n_factors):
                    xu, xi = self._propagate_factor(chunks_u[k], chunks_i[k], s_soft[k])
                    iter_u.append(xu)
                    iter_i.append(xi)
                    # eq. 11: the updated user chunk against the item chunk
                    # from before the update
                    uk = _norm(xu[self.edge_u])
                    ik = _norm(chunks_i[k][self.edge_i])
                    s_updates.append(torch.sum(uk * torch.tanh(ik), dim=1))
                layer_u, layer_i = iter_u, iter_i
                s = s_soft + torch.stack(s_updates, dim=0)
            ego_u = torch.cat(layer_u, dim=1)
            ego_i = torch.cat(layer_i, dim=1)
            acc_u = acc_u + ego_u
            acc_i = acc_i + ego_i
        return acc_u, acc_i, s

    def loss_stateful(self, params: Params, state: torch.Tensor, batch: Batch,
                      generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        w = batch.weights
        fu, fi, new_s = self.forward(params, state)
        u = fu[batch.users]
        pos = fi[batch.pos_items]
        neg = fi[batch.neg_items]
        bpr = bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w, eps=1e-5)
        reg = emb_l2_reg(self.reg_weight, (u, pos, neg), w)
        chunks = torch.chunk(torch.cat([u, pos], dim=0), self.n_factors, dim=1)
        cor = 0.0
        for k in range(self.n_factors - 1):
            cor = cor + distance_correlation(chunks[k], chunks[k + 1])
        cor = cor / ((self.n_factors + 1) * self.n_factors / 2)
        return bpr + reg + self.cor_decay * cor, new_s.detach()

    def embeddings_stateful(self, params: Params, state: torch.Tensor):
        fu, fi, _ = self.forward(params, state)
        return fu, fi
