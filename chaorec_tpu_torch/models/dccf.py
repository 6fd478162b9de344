"""DCCF: disentangled contrastive CF with intent prototypes.

Counterpart of ``chaorec_tpu/models/dccf.py`` (reference: Model/DCCF.py):

- per layer, four views of the previous state: (1) gnn, the normalized
  graph's propagation (``BipartiteGraph.propagate``, the dense R); (2) int,
  softmax(x @ intent) @ intent^T with per-side (dim_E, n_intents)
  xavier-normal prototypes (Model/DCCF.py:139-143); (3)/(4) the adaptive
  views, where per-edge weights alpha = (cos(head, tail) + 1) / 2 on the
  gnn or int embeddings build an unnormalized operator that holds only
  (user, item) entries, so the item rows of these views are zero
  (Model/DCCF.py:106-118,146-158; the reference's quirk, kept). Each is
  three ``ops/ell.seg_gather``s and a user-side ``seg_sum``: the prefix
  kernel runs twice a forward and six times a backward;
- layer state = gnn + int + gaa + iaa + prev; final = the SUM over the
  layer states, ego included (Model/DCCF.py:166-176);
- ssl: per layer, 6 InfoNCE pairs (u/i x {gnn-int, gnn-gaa, gnn-iaa}) at
  the batch's rows with in-batch negatives, each a mean over the batch
  (Model/DCCF.py:180-215);
- loss = BPR (+1e-5, on the summed embeddings) + the mean reg of the raw
  rows + cen_reg (||u_intent||^2 + ||i_intent||^2) + ssl_alpha ssl
  (Model/DCCF.py:246-260).
"""

from __future__ import annotations

import torch

from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.ell import build_segment_transpose, seg_gather, seg_sum
from chaorec_tpu_torch.ops.init import xavier_normal
from chaorec_tpu_torch.ops.losses import bpr_loss, emb_l2_reg
from chaorec_tpu_torch.ops.losses import l2norm as _norm  # zero-row safe


def _pair_cl(e1, e2, temp, weights):
    """Mean over the batch of -log(exp(pos / t) / sum_j exp(<e1, e2_j> / t)),
    over the in-batch (B, B) logits."""
    pos = torch.sum(e1 * e2, dim=1) / temp
    logits = (e1 @ e2.T) / temp
    s = torch.sum((torch.logsumexp(logits, dim=1) - pos) * weights)
    return s / torch.clamp(torch.sum(weights), min=1.0)


class DCCF(RecModel):
    name = "DCCF"

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph, dim_E: int,
                 reg_weight: float, n_layers: int, ssl_temp: float, ssl_alpha: float,
                 n_intents: int, cen_reg: float):
        super().__init__(num_user, num_item)
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.n_layers = n_layers
        self.ssl_temp = ssl_temp
        self.ssl_alpha = ssl_alpha
        self.n_intents = n_intents
        self.cen_reg = cen_reg
        self._perm_u, self._ptr_u = build_segment_transpose(graph.u_by_u, num_user)
        self._perm_i, self._ptr_i = build_segment_transpose(graph.i_by_u, num_item)

    def init_params(self, generator: torch.Generator) -> Params:
        return {
            "user_embedding": xavier_normal(generator, (self.num_user, self.dim_E)),
            "item_embedding": xavier_normal(generator, (self.num_item, self.dim_E)),
            "user_intent": xavier_normal(generator, (self.dim_E, self.n_intents)),
            "item_intent": xavier_normal(generator, (self.dim_E, self.n_intents)),
        }

    def _adaptive_user_view(self, head_emb_u, tail_emb_i, prev_i):
        """The user rows of the alpha-weighted operator applied to prev_i."""
        g = self.graph
        h = seg_gather(_norm(head_emb_u), g.u_by_u, self._perm_u, self._ptr_u)
        t = seg_gather(_norm(tail_emb_i), g.i_by_u, self._perm_i, self._ptr_i)
        alpha = (torch.sum(h * t, dim=1) + 1.0) / 2.0
        msgs = alpha[:, None] * seg_gather(prev_i, g.i_by_u, self._perm_i, self._ptr_i)
        return seg_sum(msgs, g.u_by_u, self._perm_u, self._ptr_u)

    def forward(self, params: Params):
        eu, ei = params["user_embedding"], params["item_embedding"]
        prev_u, prev_i = eu, ei
        acc_u, acc_i = eu, ei
        views = []  # per layer: (gnn_u, gnn_i, int_u, int_i, gaa_u, iaa_u)
        for _ in range(self.n_layers):
            gnn_u, gnn_i = self.graph.propagate(prev_u, prev_i)
            int_u = torch.softmax(prev_u @ params["user_intent"], dim=1) @ params["user_intent"].T
            int_i = torch.softmax(prev_i @ params["item_intent"], dim=1) @ params["item_intent"].T
            gaa_u = self._adaptive_user_view(gnn_u, gnn_i, prev_i)
            iaa_u = self._adaptive_user_view(int_u, int_i, prev_i)
            views.append((gnn_u, gnn_i, int_u, int_i, gaa_u, iaa_u))
            # the item rows of gaa and iaa are zero (the reference's quirk)
            nxt_u = gnn_u + int_u + gaa_u + iaa_u + prev_u
            nxt_i = gnn_i + int_i + prev_i
            acc_u = acc_u + nxt_u
            acc_i = acc_i + nxt_i
            prev_u, prev_i = nxt_u, nxt_i
        return acc_u, acc_i, views

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        w = batch.weights
        acc_u, acc_i, views = self.forward(params)
        u = acc_u[batch.users]
        pos = acc_i[batch.pos_items]
        neg = acc_i[batch.neg_items]
        bpr = bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w, eps=1e-5)
        reg = emb_l2_reg(
            self.reg_weight,
            (params["user_embedding"][batch.users], params["item_embedding"][batch.pos_items],
             params["item_embedding"][batch.neg_items]),
            w,
        )
        cen = self.cen_reg * (torch.sum(params["user_intent"] ** 2)
                              + torch.sum(params["item_intent"] ** 2))
        ssl = 0.0
        bu, bi = batch.users, batch.pos_items
        for gnn_u, gnn_i, int_u, int_i, gaa_u, iaa_u in views:
            ug = _norm(gnn_u[bu])
            ssl = ssl + _pair_cl(ug, _norm(int_u[bu]), self.ssl_temp, w)
            ssl = ssl + _pair_cl(ug, _norm(gaa_u[bu]), self.ssl_temp, w)
            ssl = ssl + _pair_cl(ug, _norm(iaa_u[bu]), self.ssl_temp, w)
            ig = _norm(gnn_i[bi])
            ssl = ssl + _pair_cl(ig, _norm(int_i[bi]), self.ssl_temp, w)
            # the item rows of the gaa and iaa views are zero in the
            # reference: their normalized form is the zero vector, so pos = 0
            # and every logit is 0
            ssl = ssl + 2.0 * _pair_cl(ig, torch.zeros_like(ig), self.ssl_temp, w)
        return bpr + reg + self.ssl_alpha * ssl + cen

    def embeddings(self, params: Params):
        acc_u, acc_i, _ = self.forward(params)
        return acc_u, acc_i
