"""POWERec: prompt-enhanced towers with weak-modality negatives.

Counterpart of ``chaorec_tpu/models/powerec.py`` (reference:
Model/POWERec.py):

- three 4-layer LayerGCN towers (id, visual, textual) over the shared user
  table: each adds the SUM of its prompt embeddings to the users, and
  passes its item input through Linear + Tanh (the id tower its item
  embeddings, the modal ones the raw features); each layer's rows are
  weighted by their cosine to the tower's ego rows and the output is the
  sum of layers 0..4 (Model/POWERec.py:17-54). One 3 dim_E-wide
  propagation serves the three, the cosine taken per tower;
- each epoch keeps ``int(E (1 - dropout))`` edges, drawn without
  replacement, alternately in proportion to the edge weights (first) and
  uniformly, and renormalizes R over them (Model/POWERec.py:148-170). The
  draw is the JAX package's own, on the host:
  ``np.random.default_rng(epoch * 52361 + 11)`` over the user-sorted edges
  and their weights in float64, so both packages keep the same edges at the
  same epoch. Training uses the pruned R, ranking the unpruned
  ``graph.dense_r`` (Model/POWERec.py:255-258), both in float32;
- the weak-modality negatives: per row the three towers' score gaps
  (positive minus negative), softmaxed without gradient; the tower(s) at
  the minimum (``weakest``) take the negative's rows in place of the
  positive's, an extra BPR of weight neg_weight (Model/POWERec.py:186-231);
- BPR (1e-5 inside the log) + the mean-style L2 of the concatenated rows.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from chaorec_tpu_torch.graphs.dropout import masked_dense_r
from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_uniform
from chaorec_tpu_torch.ops.losses import bpr_loss, cosine_rows, emb_l2_reg


def weakest(indicator: torch.Tensor) -> torch.Tensor:
    """(B, M) float 0/1: the entries of each row at the row's minimum."""
    return (indicator == torch.min(indicator, dim=-1, keepdim=True).values).to(torch.float32)


class POWERec(RecModel):
    name = "POWERec"
    tower_layers = 4
    num_modal = 3

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph,
                 v_feat: torch.Tensor, t_feat: torch.Tensor, dim_E: int, reg_weight: float,
                 n_layers: int, prompt_num: float, neg_weight: float, dropout: float):
        super().__init__(num_user, num_item)
        if not graph.use_dense:
            raise ValueError("POWERec runs on the dense R; build its graph with use_dense")
        self.graph = graph
        self.device = graph.dense_r.device
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.prompt_num = max(int(prompt_num), 1)
        self.neg_weight = neg_weight
        self.dropout = dropout
        self.v_feat, self.t_feat = v_feat, t_feat
        self.pruning_random = False  # the weighted draw first
        self.masked_r = graph.dense_r  # training's R, pruned by each pre_epoch
        self._edge_w = graph.w_by_u.cpu().numpy().astype(np.float64)  # host copy for the draw

    def init_params(self, generator: torch.Generator) -> Params:
        d = self.dim_E
        p = {"user_embeddings": xavier_uniform(generator, (self.num_user, d)),
             "item_embeddings": xavier_uniform(generator, (self.num_item, d))}
        for name in ("id_prompt", "v_prompt", "t_prompt"):
            p[name] = xavier_uniform(generator, (self.prompt_num, d))
        for name, width in (("id_mlp", d), ("v_mlp", self.v_feat.shape[1]),
                            ("t_mlp", self.t_feat.shape[1])):
            p[f"{name}_w"], p[f"{name}_b"] = torch_linear_init(generator, d, width)
        return p

    def kept_edges(self, epoch: int) -> np.ndarray:
        """The indices, into the user-sorted edges, that epoch ``epoch``
        keeps; flips the draw's kind for the next call."""
        e = self._edge_w.shape[0]
        keep_len = int(e * (1.0 - self.dropout))
        rs = np.random.default_rng(epoch * 52361 + 11)
        if self.pruning_random:
            idx = rs.choice(e, size=keep_len, replace=False)
        else:
            idx = rs.choice(e, size=keep_len, replace=False, p=self._edge_w / self._edge_w.sum())
        self.pruning_random = not self.pruning_random
        return idx

    def pre_epoch(self, params: Params, epoch: int) -> None:
        if self.dropout <= 0.0:
            self.masked_r = self.graph.dense_r
            return
        mask = np.zeros(self._edge_w.shape[0], np.float32)
        mask[self.kept_edges(epoch)] = 1.0
        g = self.graph
        self.masked_r = masked_dense_r(g.u_by_u, g.i_by_u, torch.from_numpy(mask).to(self.device),
                                       self.num_user, self.num_item)

    def forward(self, params: Params, r: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        d = self.dim_E
        xus, xis = [], []
        for prompt, mlp, item_in in (("id_prompt", "id_mlp", params["item_embeddings"]),
                                     ("v_prompt", "v_mlp", self.v_feat),
                                     ("t_prompt", "t_mlp", self.t_feat)):
            xus.append(params["user_embeddings"] + torch.sum(params[prompt], 0)[None, :])
            xis.append(torch.tanh(item_in @ params[f"{mlp}_w"].T + params[f"{mlp}_b"]))
        ego_u, ego_i = torch.cat(xus, 1), torch.cat(xis, 1)

        def gate(x, ego):
            return torch.cat([cosine_rows(x[:, j * d:(j + 1) * d], ego[:, j * d:(j + 1) * d])
                              [:, None] * x[:, j * d:(j + 1) * d] for j in range(3)], 1)

        rr = r.to(torch.float32)
        acc_u, acc_i = cu, ci = ego_u, ego_i
        for _ in range(self.tower_layers):
            cu, ci = rr @ ci, rr.t() @ cu
            cu, ci = gate(cu, ego_u), gate(ci, ego_i)
            acc_u, acc_i = acc_u + cu, acc_i + ci
        return acc_u, acc_i

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        fu, fi = self.forward(params, self.masked_r)
        u, pos, neg = fu[batch.users], fi[batch.pos_items], fi[batch.neg_items]
        w = batch.weights
        pos_scores, neg_scores = torch.sum(u * pos, 1), torch.sum(u * neg, 1)
        bpr = bpr_loss(pos_scores, neg_scores, w, eps=1e-5)
        d = self.dim_E
        pos_m = torch.sum((u * pos).reshape(-1, self.num_modal, d), -1)
        neg_m = torch.sum((u * neg).reshape(-1, self.num_modal, d), -1)
        indicator = torch.softmax(pos_m - neg_m, -1).detach()
        weak = torch.repeat_interleave(weakest(indicator), d, dim=1)  # (B, 3 d)
        fake_scores = torch.sum(u * ((1.0 - weak) * pos + weak * neg), 1)
        weak_loss = bpr_loss(pos_scores, fake_scores, w, eps=1e-5)
        reg = emb_l2_reg(self.reg_weight, (u, pos, neg), w)
        return bpr + self.neg_weight * weak_loss + reg

    def embeddings(self, params: Params):
        return self.forward(params, self.graph.dense_r)
