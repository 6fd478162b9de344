"""DDRec: dual denoising with threshold-filtered edges and cross-step state.

Counterpart of ``chaorec_tpu/models/ddrec.py`` (reference: Model/DDRec.py):

- fixed internals: 1 multimodal layer, 10-NN, image weight 0.5; the raw
  feature tables are frozen, their projections xavier-normal Linears
  (Model/DDRec.py:37-60);
- two modality towers over (the user table, a modality's item input): in
  each layer an edge is kept when the u.i similarity of its two ends'
  current rows is at least ``threshold`` (``kept_by_sim``), the degrees are
  counted again over the kept edges and the hop renormalized over them
  (filter_edges, Model/DDRec.py:116-175); the output is the mean of layers
  0..n;
- the cross-step state ``(has_prev, prev_items)``: the previous step's
  final id item embedding, detached, gates the modal inputs through the
  sigmoid "guide" Linears once a step has run (Model/DDRec.py:105-110);
  the trainer carries it from batch to batch and epoch to epoch, and
  ranking and the export read it (``embeddings_stateful``);
- the id tower is the LightGCN mean; every item output adds one
  propagation over the multimodal graph (``graphs/knn.mixed_knn_graph``);
- final = the three towers side by side; loss = BPR (1e-5 inside the log) +
  the mean-style L2 of the final rows + ssl_alpha * four ``in_batch_ce``
  terms, each modality against the id tower, users and items
  (Model/DDRec.py:248-281).

The JAX package scatters each filtered layer into a dense (U, I) R for the
TPU's matrix unit; here the hop is an edge-space sum in a fixed order
(``graphs/dropout.edge_propagate`` over ``EdgeBags`` built once), the
degrees counted the same way (``graphs/dropout.kept_edge_weights``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from chaorec_tpu_torch.graphs.dropout import EdgeBags, edge_propagate, kept_edge_weights
from chaorec_tpu_torch.graphs.knn import mixed_knn_graph
from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.models.slmrec import in_batch_ce
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_normal
from chaorec_tpu_torch.ops.losses import bpr_loss, emb_l2_reg, l2norm

State = Tuple[torch.Tensor, torch.Tensor]


def kept_by_sim(sim: torch.Tensor, threshold: float) -> torch.Tensor:
    """(E,) float 0/1: the edges whose similarity is at least ``threshold``."""
    return (sim >= threshold).to(torch.float32)


class DDRec(RecModel):
    name = "DDRec"
    stateful = True
    mm_layers = 1
    knn_k = 10
    mm_image_weight = 0.5

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph,
                 v_feat: torch.Tensor, t_feat: torch.Tensor, dim_E: int, feat_E: int,
                 reg_weight: float, n_layers: int, ssl_temp: float, ssl_alpha: float,
                 threshold: float):
        super().__init__(num_user, num_item)
        if feat_E != dim_E:
            raise ValueError(f"DDRec gates its modal inputs ({feat_E} wide) by the item "
                             f"embedding ({dim_E} wide): feature_embed must equal dim_E")
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.feat_E = feat_E
        self.reg_weight = reg_weight
        self.n_layers = n_layers
        self.ssl_temp = ssl_temp
        self.ssl_alpha = ssl_alpha
        self.threshold = threshold
        self.v_feat, self.t_feat = v_feat, t_feat  # frozen
        self.bags = EdgeBags.build(graph.u_by_u, graph.i_by_u, num_user, num_item)
        self.mm_graph = mixed_knn_graph(v_feat, t_feat, min(self.knn_k, num_item),
                                        self.mm_image_weight)

    def init_params(self, generator: torch.Generator) -> Params:
        d, fe = self.dim_E, self.feat_E
        p = {"user_embedding": xavier_normal(generator, (self.num_user, d)),
             "item_embedding": xavier_normal(generator, (self.num_item, d)),
             "image_trs_w": xavier_normal(generator, (fe, self.v_feat.shape[1])),
             "text_trs_w": xavier_normal(generator, (fe, self.t_feat.shape[1]))}
        p["image_trs_b"] = torch_linear_init(generator, fe, self.v_feat.shape[1])[1]
        p["text_trs_b"] = torch_linear_init(generator, fe, self.t_feat.shape[1])[1]
        for name in ("guide_image", "guide_text"):
            p[f"{name}_w"], p[f"{name}_b"] = torch_linear_init(generator, fe, fe)
        return p

    def init_state(self, device: torch.device | str = "cpu",
                   generator: Optional[torch.Generator] = None) -> State:
        """(has_prev, prev_items): 0 and zeros until a step has run."""
        return (torch.zeros((), device=device),
                torch.zeros((self.num_item, self.dim_E), device=device))

    def _filtered_tower(self, xu: torch.Tensor, xi: torch.Tensor):
        """The mean of the ego and its layers, each layer over the edges its
        input keeps, renormalized."""
        g = self.graph
        acc_u, acc_i = cu, ci = xu, xi
        for _ in range(self.n_layers):
            with torch.no_grad():
                sim = torch.sum(cu[g.u_by_u] * ci[g.i_by_u], dim=1)
                w = kept_edge_weights(g.u_by_u, g.i_by_u, kept_by_sim(sim, self.threshold),
                                      self.bags, self.num_user, self.num_item)
            cu, ci = edge_propagate(g.u_by_u, g.i_by_u, w, cu, ci, self.num_user, self.num_item,
                                    bags=self.bags)
            acc_u, acc_i = acc_u + cu, acc_i + ci
        s = 1.0 / (self.n_layers + 1)
        return acc_u * s, acc_i * s

    def _id_tower(self, xu: torch.Tensor, xi: torch.Tensor):
        acc_u, acc_i = cu, ci = xu, xi
        for _ in range(self.n_layers):
            cu, ci = self.graph.propagate(cu, ci)
            acc_u, acc_i = acc_u + cu, acc_i + ci
        s = 1.0 / (self.n_layers + 1)
        return acc_u * s, acc_i * s

    def forward(self, params: Params, state: State):
        """(final users, final items, (u_g, u_v, u_t, i_g, i_v, i_t) views);
        i_g is the id tower's final items, the next state's."""
        has_prev, prev_items = state
        v_emb = self.v_feat @ params["image_trs_w"].T + params["image_trs_b"]
        t_emb = self.t_feat @ params["text_trs_w"].T + params["text_trs_b"]
        gate_v = torch.sigmoid(v_emb @ params["guide_image_w"].T + params["guide_image_b"])
        gate_t = torch.sigmoid(t_emb @ params["guide_text_w"].T + params["guide_text_b"])
        visual = torch.where(has_prev > 0, prev_items * gate_v, v_emb)
        textual = torch.where(has_prev > 0, prev_items * gate_t, t_emb)

        xu = params["user_embedding"]
        u_v, i_v = self._filtered_tower(xu, visual)
        u_t, i_t = self._filtered_tower(xu, textual)
        u_g, i_g = self._id_tower(xu, params["item_embedding"])
        i_g = i_g + self.mm_graph.propagate(i_g)
        i_v = i_v + self.mm_graph.propagate(i_v)
        i_t = i_t + self.mm_graph.propagate(i_t)
        return (torch.cat([u_g, u_v, u_t], 1), torch.cat([i_g, i_v, i_t], 1),
                (u_g, u_v, u_t, i_g, i_v, i_t))

    def loss_stateful(self, params: Params, state: State, batch: Batch,
                      generator: Optional[torch.Generator] = None):
        fu, fi, (u_g, u_v, u_t, i_g, i_v, i_t) = self.forward(params, state)
        bu, bi, w = batch.users, batch.pos_items, batch.weights
        u, pos, neg = fu[bu], fi[bi], fi[batch.neg_items]
        bpr = bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w, eps=1e-5)
        reg = emb_l2_reg(self.reg_weight, (u, pos, neg), w)
        t = self.ssl_temp
        cl = (in_batch_ce(l2norm(u_v[bu]), l2norm(u_g[bu]), t, w)
              + in_batch_ce(l2norm(u_t[bu]), l2norm(u_g[bu]), t, w)
              + in_batch_ce(l2norm(i_v[bi]), l2norm(i_g[bi]), t, w)
              + in_batch_ce(l2norm(i_t[bi]), l2norm(i_g[bi]), t, w))
        new_state = (torch.ones((), device=i_g.device), i_g.detach())
        return bpr + reg + self.ssl_alpha * cl, new_state

    def embeddings_stateful(self, params: Params, state: State):
        fu, fi, _ = self.forward(params, state)
        return fu, fi
