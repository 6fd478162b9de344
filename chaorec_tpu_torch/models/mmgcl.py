"""MMGCL: multimodal graph contrastive learning (edge dropout, modality masking).

Counterpart of ``chaorec_tpu/models/mmgcl.py`` (reference: Model/MMGCL.py):

- three LightGCN towers (the mean of layers 0..n) over the shared user
  table: id items, the visual and the textual features (L2-normalized at
  build) through a Linear each; fused per side by the ``read_user`` and
  ``read_item`` Linears over the three side by side
  (Model/MMGCL.py:147-191). One 3 dim_E-wide propagation serves the three;
- the edge-dropout view: the three towers over the edges kept by a
  Bernoulli mask, renormalized (Model/MMGCL.py:136-145, 214-245);
- the modality-masking view: users and items each kept with 1 - dropout,
  an edge kept when both ends are, renormalized, for ONE tower picked at
  random (visual or textual, p 0.5); the other towers are the clean ones
  (Model/MMGCL.py:119-134, 247-287);
- loss = BPR (1e-5 inside the log) of the fused rows + ssl_alpha *
  (``in_batch_ce`` of the normalized fused view-1 users against view-1
  items, and against view-2 items); the reference's third "CN" term is
  computed but never added, so it is left out (Model/MMGCL.py:289-344).

The JAX package scatters each view's weights into a dense (U, I) R every
step for the TPU's matrix unit; here a view's hops are edge-space sums in
a fixed order (``graphs/dropout.edge_propagate`` over ``EdgeBags`` built
once), with the view's degrees counted the same way
(``graphs/dropout.kept_edge_weights``).

``draws`` makes a step's random draws (the edge keep mask over the
graph's user-sorted edges, the user and item keep masks, the modality
pick) and ``loss_with_draws`` takes them.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from chaorec_tpu_torch.graphs.dropout import EdgeBags, edge_propagate, kept_edge_weights
from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.models.slmrec import in_batch_ce
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_uniform
from chaorec_tpu_torch.ops.losses import bpr_loss, l2norm

Draws = Dict[str, torch.Tensor]


class MMGCL(RecModel):
    name = "MMGCL"
    p_vat = 0.5  # the chance that the visual tower is the masked one

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph,
                 v_feat: torch.Tensor, t_feat: torch.Tensor, dim_E: int, reg_weight: float,
                 n_layers: int, ssl_alpha: float, ssl_temp: float, dropout: float):
        super().__init__(num_user, num_item)
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.reg_weight = reg_weight  # the reference's reg term is commented out
        self.n_layers = n_layers
        self.ssl_alpha = ssl_alpha
        self.ssl_temp = ssl_temp
        self.dropout_rate = dropout
        self.v_feat, self.t_feat = l2norm(v_feat), l2norm(t_feat)
        self.bags = EdgeBags.build(graph.u_by_u, graph.i_by_u, num_user, num_item)

    def init_params(self, generator: torch.Generator) -> Params:
        d = self.dim_E
        p = {"user_embeddings": xavier_uniform(generator, (self.num_user, d)),
             "item_embeddings": xavier_uniform(generator, (self.num_item, d))}
        for name, width in (("v_dense", self.v_feat.shape[1]), ("t_dense", self.t_feat.shape[1]),
                            ("read_user", 3 * d), ("read_item", 3 * d)):
            p[f"{name}_w"] = xavier_uniform(generator, (d, width))
            p[f"{name}_b"] = torch_linear_init(generator, d, width)[1]
        return p

    def draws(self, generator: torch.Generator, batch: Optional[Batch] = None) -> Draws:
        """"edge" (E,), "user" (U,) and "item" (I,) 0/1 keep masks (keep
        1 - dropout) and "pick_image" (a 0-dim bool: the visual tower is the
        masked one)."""
        keep = 1.0 - self.dropout_rate

        def mask(n):
            return (torch.rand(n, generator=generator, device=self.device) < keep).float()

        return {"edge": mask(self.graph.num_edges), "user": mask(self.num_user),
                "item": mask(self.num_item),
                "pick_image": torch.rand((), generator=generator, device=self.device) < self.p_vat}

    def _tower(self, xu: torch.Tensor, xi: torch.Tensor, w: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The mean of the ego and its layers over the graph, or over the
        edges weighted ``w`` (a view)."""
        g = self.graph
        acc_u, acc_i = cu, ci = xu, xi
        for _ in range(self.n_layers):
            if w is None:
                cu, ci = g.propagate(cu, ci)
            else:
                cu, ci = edge_propagate(g.u_by_u, g.i_by_u, w, cu, ci, self.num_user,
                                        self.num_item, bags=self.bags)
            acc_u, acc_i = acc_u + cu, acc_i + ci
        s = 1.0 / (self.n_layers + 1)
        return acc_u * s, acc_i * s

    def _modal(self, params: Params) -> Tuple[torch.Tensor, torch.Tensor]:
        v_emb = self.v_feat @ params["v_dense_w"].T + params["v_dense_b"]
        t_emb = self.t_feat @ params["t_dense_w"].T + params["t_dense_b"]
        return v_emb, t_emb

    def _all_towers(self, params: Params, w: Optional[torch.Tensor] = None):
        """((id, visual, textual) user towers, the same item towers), one
        3 dim_E-wide propagation."""
        xu = params["user_embeddings"]
        v_emb, t_emb = self._modal(params)
        au, ai = self._tower(torch.cat([xu, xu, xu], 1),
                             torch.cat([params["item_embeddings"], v_emb, t_emb], 1), w)
        return torch.chunk(au, 3, dim=1), torch.chunk(ai, 3, dim=1)

    @staticmethod
    def _fused(params: Params, towers_u: Sequence[torch.Tensor],
               towers_i: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        u = torch.cat(list(towers_u), 1) @ params["read_user_w"].T + params["read_user_b"]
        i = torch.cat(list(towers_i), 1) @ params["read_item_w"].T + params["read_item_b"]
        return u, i

    def loss_with_draws(self, params: Params, batch: Batch, draws: Draws) -> torch.Tensor:
        g = self.graph
        tw_u, tw_i = self._all_towers(params)
        user, item = self._fused(params, tw_u, tw_i)
        bu, bi, bn, w = batch.users, batch.pos_items, batch.neg_items, batch.weights
        u = user[bu]
        bpr = bpr_loss(torch.sum(u * item[bi], 1), torch.sum(u * item[bn], 1), w, eps=1e-5)

        def weights(keep):
            return kept_edge_weights(g.u_by_u, g.i_by_u, keep, self.bags, self.num_user,
                                     self.num_item)

        # view 1: every tower over the edge-dropped graph
        u1_t, i1_t = self._all_towers(params, weights(draws["edge"]))
        u1, i1 = self._fused(params, [x[bu] for x in u1_t], [x[bi] for x in i1_t])
        u1, i1 = l2norm(u1), l2norm(i1)
        # view 2: the picked modality's tower over the node-dropped graph,
        # the other towers clean; both modal towers go through one
        # 2 dim_E-wide propagation and the pick selects. Only its items
        # enter the loss (the reference fuses its users too, unused).
        w_nd = weights(draws["user"][g.u_by_u] * draws["item"][g.i_by_u])
        xu = params["user_embeddings"]
        v_emb, t_emb = self._modal(params)
        _, ai = self._tower(torch.cat([xu, xu], 1), torch.cat([v_emb, t_emb], 1), w_nd)
        vi_nd, ti_nd = torch.chunk(ai, 2, dim=1)
        pick = draws["pick_image"]
        i2_t = (tw_i[0], torch.where(pick, vi_nd, tw_i[1]), torch.where(pick, tw_i[2], ti_nd))
        i2 = torch.cat([x[bi] for x in i2_t], 1) @ params["read_item_w"].T + params["read_item_b"]
        i2 = l2norm(i2)
        ssl = (in_batch_ce(u1, i1, self.ssl_temp, w) + in_batch_ce(u1, i2, self.ssl_temp, w))
        return bpr + self.ssl_alpha * ssl

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        return self.loss_with_draws(params, batch, self.draws(generator, batch))

    def embeddings(self, params: Params):
        tw_u, tw_i = self._all_towers(params)
        return self._fused(params, tw_u, tw_i)
