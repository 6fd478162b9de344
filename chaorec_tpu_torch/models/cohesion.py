"""COHESION: tri-branch dual-stage fusion with adaptive optimization.

Counterpart of ``chaorec_tpu/models/cohesion.py`` (reference:
Model/COHESION.py, the reference's default CLI model):

- three towers (id, visual, textual), each a user preference table over
  the items' ``sqrt(|(id^2 + mlp(feat)^2) / 2| + 1e-8)`` (the id tower's
  MLP reads ``id_feat`` itself), the rows normalized, then LayerGCN-style
  layers: each layer's output scaled by its cosine with the ego rows,
  summed with the ego (Model/COHESION.py:13-45). The three run side by
  side, 3d wide, over one R; the cosine is taken per d-wide block;
- the id tower's output is detached (the reference's ``id_rep.data``,
  Model/COHESION.py:319-325): its MLP and preference train only through
  the other towers' use of ``id_feat``;
- user rep = the three towers' user parts (U, 3d) plus the user-graph sum
  over ``uu_k`` = 40 co-occurrence neighbours, redrawn each epoch
  (``graphs/user_graph.py``, numpy's draw seeded as the JAX package seeds
  it); item rep = the towers' item parts plus ``mm_layers`` passes of the
  multimodal kNN item graph (``graphs/knn.mixed_knn_graph``)
  (Model/COHESION.py:336-353);
- each epoch, with ``dropout`` > 0, ``1 - dropout`` of the U-I edges are
  kept, drawn without replacement in proportion to their weight, and R is
  renormalized over them, as FREEDOM prunes (``prune_mask`` draws the keep
  mask, ``apply_keep_mask`` rebuilds R);
- adaptive optimization: the detached ``1 - softmax`` of each modality
  block's score gap reweights the score dims (Model/COHESION.py:356-364);
- loss = -mean(log2(sigmoid(pos - neg) + 1e-12)) (base 2, a reference
  quirk) + reg_weight * (the batch's mean v_pref^2 and t_pref^2 + mean
  weight_u^2) (Model/COHESION.py:366-380). The id preference is not in the
  reg.

Every product with R is of bf16 operands, whatever the graph's dtype: the
JAX package's ``bdot`` casts both to bf16, and this model is the one that
calls it on its own R. So R is kept in bf16 (a pruned R is rounded once,
as in the JAX package's product) and each tower input is cast before its
product. The loss takes the batch rows of the user graph's sum, and of the
item graph's when it has one layer.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from chaorec_tpu_torch.graphs import user_graph
from chaorec_tpu_torch.graphs.dropout import masked_dense_r
from chaorec_tpu_torch.graphs.knn import gather_weighted_sum, mixed_knn_graph
from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_normal
from chaorec_tpu_torch.ops.losses import cosine_rows, l2norm, masked_mean
from chaorec_tpu_torch.ops.mxu import bdot

PRUNE_SEED = 92821  # the JAX package's pruning key, PRNGKey(92821) folded with the epoch
EPOCH_SEED = (92821, 3)  # the epoch's neighbour draw: default_rng(epoch * a + b)


class COHESION(RecModel):
    name = "COHESION"
    uu_k = 40  # Model/COHESION.py:83

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph, edges: np.ndarray,
                 v_feat: torch.Tensor, t_feat: torch.Tensor, dim_E: int, reg_weight: float,
                 dropout: float, n_layers: int, mm_layers: int, ii_topk: int,
                 mm_image_weight: float):
        super().__init__(num_user, num_item)
        if not graph.use_dense:
            raise ValueError("COHESION runs on the dense R; this graph is above "
                             "dense_prop_threshold")
        self.graph = graph
        self.device = graph.dense_r.device
        self.dim_latent = dim_E
        self.reg_weight = reg_weight
        self.dropout = dropout
        self.num_layer = n_layers
        self.mm_layers = mm_layers
        self.v_feat, self.t_feat = v_feat, t_feat
        self.mm_graph = mixed_knn_graph(v_feat, t_feat, ii_topk, mm_image_weight)
        self._uu = user_graph.build_user_cooccurrence(np.asarray(edges), num_user, num_item,
                                                      device=self.device)
        self.user_nbr_idx, self.user_nbr_w = user_graph.draw_user_graph(self._uu, self.uu_k, 0,
                                                                        self.device)
        self.masked_r = graph.dense_r.to(torch.bfloat16)
        self._edge_u, self._edge_i = graph.u_by_u, graph.i_by_u
        self._log_edge_w = torch.log(graph.w_by_u)

    def init_params(self, generator: torch.Generator) -> Params:
        d = self.dim_latent
        p = {"id_feat": xavier_normal(generator, (self.num_item, d)),
             "weight_u": torch.softmax(xavier_normal(generator, (self.num_user, 2, 1)), dim=1)}
        for mod, in_dim in (("id", d), ("v", self.v_feat.shape[1]), ("t", self.t_feat.shape[1])):
            p[f"{mod}_preference"] = xavier_normal(generator, (self.num_user, d))
            p[f"{mod}_mlp_w1"], p[f"{mod}_mlp_b1"] = torch_linear_init(generator, 4 * d, in_dim)
            p[f"{mod}_mlp_w2"], p[f"{mod}_mlp_b2"] = torch_linear_init(generator, d, 4 * d)
        return p

    # -- per-epoch user graph and edge pruning --------------------------------
    def prune_mask(self, epoch: int) -> torch.Tensor:
        """(E,) float 0/1 keep mask over the by-user edge order: the top
        ``int(E * (1 - dropout))`` of log(w) + Gumbel noise (a weighted draw
        without replacement), the noise from a generator seeded from
        PRUNE_SEED and the epoch."""
        e = self._edge_u.shape[0]
        gen = torch.Generator(self.device).manual_seed((PRUNE_SEED << 32) + epoch)
        gumbel = -torch.log(torch.empty(e, device=self.device).exponential_(generator=gen))
        keep_idx = torch.topk(self._log_edge_w + gumbel, int(e * (1.0 - self.dropout))).indices
        return torch.zeros(e, device=self.device).index_fill_(0, keep_idx, 1.0)

    def apply_keep_mask(self, keep: torch.Tensor) -> None:
        """R renormalized over the kept edges, rounded to bf16 once."""
        self.masked_r = None  # free the last epoch's first
        self.masked_r = masked_dense_r(self._edge_u, self._edge_i, keep, self.num_user,
                                       self.num_item).to(torch.bfloat16)

    def pre_epoch(self, params: Params, epoch: int) -> None:
        a, b = EPOCH_SEED
        self.user_nbr_idx, self.user_nbr_w = user_graph.draw_user_graph(
            self._uu, self.uu_k, epoch * a + b, self.device)
        if self.dropout > 0.0:
            self.apply_keep_mask(self.prune_mask(epoch))

    # -- forward ----------------------------------------------------------
    def _tower_input(self, params: Params, mod: str, feat: torch.Tensor) -> torch.Tensor:
        tf = F.leaky_relu(feat @ params[f"{mod}_mlp_w1"].T + params[f"{mod}_mlp_b1"], 0.01)
        tf = tf @ params[f"{mod}_mlp_w2"].T + params[f"{mod}_mlp_b2"]
        idf = params["id_feat"]
        tf = torch.sqrt(torch.abs((idf * idf + tf * tf) / 2.0) + 1e-8)
        return l2norm(torch.cat([params[f"{mod}_preference"], tf], 0))

    def _towers(self, params: Params):
        """(acc_u (U, 3d), acc_i (I, 3d)): the id, visual and textual towers
        side by side."""
        d = self.dim_latent
        x = torch.cat([self._tower_input(params, "id", params["id_feat"]),
                       self._tower_input(params, "v", self.v_feat),
                       self._tower_input(params, "t", self.t_feat)], 1)
        r = self.masked_r
        cu, ci = x[:self.num_user], x[self.num_user:]
        acc_u, acc_i, ego_u, ego_i = cu, ci, cu, ci

        def weighted(h, ego):
            h3 = h.reshape(-1, 3, d)
            return (h3 * cosine_rows(h3, ego.reshape(-1, 3, d))[:, :, None]).reshape(-1, 3 * d)

        for _ in range(self.num_layer):
            cu, ci = (bdot(r, ci.to(torch.bfloat16)), bdot(r.t(), cu.to(torch.bfloat16)))
            cu, ci = weighted(cu, ego_u), weighted(ci, ego_i)
            acc_u, acc_i = acc_u + cu, acc_i + ci
        return acc_u, acc_i

    def _detached_id(self, rep: torch.Tensor) -> torch.Tensor:
        d = self.dim_latent
        return torch.cat([rep[:, :d].detach(), rep[:, d:]], 1)

    def _mm(self, h: torch.Tensor) -> torch.Tensor:
        for _ in range(self.mm_layers):
            h = self.mm_graph.propagate(h)
        return h

    def forward(self, params: Params):
        acc_u, acc_i = self._towers(params)
        user_rep, item_rep = self._detached_id(acc_u), self._detached_id(acc_i)
        h_u = gather_weighted_sum(user_rep, self.user_nbr_w, self.user_nbr_idx)
        return user_rep + h_u, item_rep + self._mm(item_rep)

    def embeddings(self, params: Params):
        return self.forward(params)

    # -- loss -------------------------------------------------------------
    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        acc_u, acc_i = self._towers(params)
        user_rep, item_rep = self._detached_id(acc_u), self._detached_id(acc_i)
        bu = batch.users
        u = user_rep[bu] + gather_weighted_sum(user_rep, self.user_nbr_w[bu],
                                               self.user_nbr_idx[bu])
        items2 = torch.cat([batch.pos_items, batch.neg_items])
        if self.mm_layers == 1:
            h_rows = gather_weighted_sum(item_rep, self.mm_graph.weights[items2],
                                         self.mm_graph.indices[items2])
        else:
            h_rows = self._mm(item_rep)[items2]
        both = item_rep[items2] + h_rows
        b = batch.pos_items.shape[0]
        pos, neg = both[:b], both[b:]
        w, d = batch.weights, self.dim_latent
        pos_m = torch.sum((u * pos).reshape(-1, 3, d), -1)  # (B, 3)
        neg_m = torch.sum((u * neg).reshape(-1, 3, d), -1)
        indicator = (1.0 - torch.softmax(pos_m - neg_m, -1)).detach()
        aw = torch.repeat_interleave(indicator, d, dim=1)  # (B, 3d)
        pos_scores = torch.sum(u * pos * aw, 1)
        neg_scores = torch.sum(u * neg * aw, 1)
        bpr = -masked_mean(torch.log2(torch.sigmoid(pos_scores - neg_scores) + 1e-12), w)
        reg = self.reg_weight * (
            masked_mean(torch.mean(params["v_preference"][bu] ** 2, 1), w)
            + masked_mean(torch.mean(params["t_preference"][bu] ** 2, 1), w)
            + torch.mean(params["weight_u"] ** 2))
        return bpr + reg
