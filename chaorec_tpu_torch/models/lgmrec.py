"""LGMRec: local graph embeddings and global hypergraph embeddings.

Counterpart of ``chaorec_tpu/models/lgmrec.py`` (reference:
Model/LGMRec.py):

- fixed internals: 2 modal layers, 1 hypergraph layer, 4 hyperedges, keep
  0.2, tau 0.2, alpha 0.2 (Model/LGMRec.py:40-49);
- the raw feature tables are frozen (the reference's ``freeze=True``):
  model attributes, not params; their projections and the hyperedge
  mappings train (Model/LGMRec.py:74-84);
- cge: the LightGCN mean of layers 0..n; mge, per modality: the projected
  item features, the user side the raw interaction sum of its items times
  1 / (deg + 1e-7), propagated twice (the last layer only); the local
  embedding is cge + the normalized visual and textual mge
  (Model/LGMRec.py:108-135);
- the hypergraph: item and user hyperedge assignments by a Gumbel softmax
  (tau 0.2) of the feature projections (the users' from their items' raw
  sum), each kept with 0.2 and scaled by 1 / 0.2; HGNN ``H (H^T x)`` over
  the cge items (Model/LGMRec.py:16-29, 137-152);
- final = local + alpha * normalized(global); the hypergraph contrast, per
  side the visual against the textual hyperedge embedding with every row
  of the textual table as negatives, a weighted SUM over the rows, times
  ssl_alpha (Model/LGMRec.py:218-241); BPR (1e-5 inside the log) and the
  mean-style L2 of the final rows.

The raw interaction sums (users from their items) are taken over the
user-sorted edges in a fixed order (``EdgeBags``, built once), their
gradient by the items' sums (``_IncidenceSum``).

``draws`` makes a step's Gumbel uniforms and keep masks and
``loss_with_draws`` takes them; ranking (``embeddings``) draws nothing.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from chaorec_tpu_torch.graphs.dropout import EdgeBags
from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import xavier_uniform
from chaorec_tpu_torch.ops.losses import bpr_loss, emb_l2_reg, l2norm

Draws = Dict[str, torch.Tensor]
# (hyperedge assignment, its side): each gets Gumbel uniforms and a keep mask
ASSIGNMENTS = (("iv", "item"), ("uv", "user"), ("it", "item"), ("ut", "user"))


class _IncidenceSum(torch.autograd.Function):
    """A (U, D) = sum over each user's edges of x (I, D) rows; the gradient
    is the items' sums of the cotangent rows."""

    @staticmethod
    def forward(ctx, x, bags):
        ctx.bags = bags
        return bags.users.sum(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bags.items.sum(g), None


class LGMRec(RecModel):
    name = "LGMRec"
    n_mm_layer = 2
    n_hyper_layer = 1
    hyper_num = 4
    keep_rate = 0.2
    tau = 0.2
    alpha = 0.2

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph,
                 v_feat: torch.Tensor, t_feat: torch.Tensor, dim_E: int, reg_weight: float,
                 n_layers: int, ssl_alpha: float):
        super().__init__(num_user, num_item)
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.n_ui_layers = n_layers
        self.ssl_reg = ssl_alpha
        self.v_feat, self.t_feat = v_feat, t_feat  # frozen
        self.bags = EdgeBags.build(graph.u_by_u, graph.i_by_u, num_user, num_item)
        du = torch.bincount(graph.u_by_u, minlength=num_user).to(torch.float32)
        self.inv_deg_u = 1.0 / (du + 1e-7)

    def init_params(self, generator: torch.Generator) -> Params:
        d, h = self.dim_E, self.hyper_num
        return {
            "user_embedding": xavier_uniform(generator, (self.num_user, d)),
            "item_embedding": xavier_uniform(generator, (self.num_item, d)),
            "item_image_trs": xavier_uniform(generator, (self.v_feat.shape[1], d)),
            "item_text_trs": xavier_uniform(generator, (self.t_feat.shape[1], d)),
            "v_hyper": xavier_uniform(generator, (self.v_feat.shape[1], h)),
            "t_hyper": xavier_uniform(generator, (self.t_feat.shape[1], h)),
        }

    def draws(self, generator: torch.Generator, batch: Optional[Batch] = None) -> Draws:
        """For each assignment ``a`` of ASSIGNMENTS, ((U or I), 4):
        "{a}_gumbel" uniforms in [0, 1) and "{a}_keep" 0/1 masks (keep 0.2)."""
        rows = {"user": self.num_user, "item": self.num_item}
        out = {}
        for a, side in ASSIGNMENTS:
            out[f"{a}_gumbel"] = torch.rand((rows[side], self.hyper_num), generator=generator,
                                            device=self.device)
        for a, side in ASSIGNMENTS:
            out[f"{a}_keep"] = (torch.rand((rows[side], self.hyper_num), generator=generator,
                                           device=self.device) < self.keep_rate).float()
        return out

    def _adj_matvec(self, x_items: torch.Tensor) -> torch.Tensor:
        """The raw binary R @ x_items (Model/LGMRec.py:126)."""
        return _IncidenceSum.apply(x_items, self.bags)

    def _cge(self, params: Params) -> Tuple[torch.Tensor, torch.Tensor]:
        acc_u, acc_i = xu, xi = params["user_embedding"], params["item_embedding"]
        for _ in range(self.n_ui_layers):
            xu, xi = self.graph.propagate(xu, xi)
            acc_u, acc_i = acc_u + xu, acc_i + xi
        s = 1.0 / (self.n_ui_layers + 1)
        return acc_u * s, acc_i * s

    def _mge(self, params: Params, trs_key: str, feat: torch.Tensor):
        xi = feat @ params[trs_key]
        xu = self._adj_matvec(xi) * self.inv_deg_u[:, None]
        for _ in range(self.n_mm_layer):
            xu, xi = self.graph.propagate(xu, xi)
        return xu, xi

    def forward(self, params: Params, draws: Optional[Draws] = None):
        """(final users, final items, (uv, iv, ut, it) hypergraph rows);
        ``draws`` None: no Gumbel noise and no dropout (ranking)."""
        logits = {"iv": self.v_feat @ params["v_hyper"], "it": self.t_feat @ params["t_hyper"]}
        logits["uv"] = self._adj_matvec(logits["iv"])
        logits["ut"] = self._adj_matvec(logits["it"])
        hyper = {}
        for a, _ in ASSIGNMENTS:
            x = logits[a]
            if draws is not None:
                x = x - torch.log(-torch.log(draws[f"{a}_gumbel"] + 1e-10) + 1e-10)
            hyper[a] = torch.softmax(x / self.tau, dim=1)
            if draws is not None:
                hyper[a] = hyper[a] * draws[f"{a}_keep"] / self.keep_rate

        cge_u, cge_i = self._cge(params)
        v_u, v_i = self._mge(params, "item_image_trs", self.v_feat)
        t_u, t_i = self._mge(params, "item_text_trs", self.t_feat)
        lge_u = cge_u + l2norm(v_u) + l2norm(t_u)
        lge_i = cge_i + l2norm(v_i) + l2norm(t_i)

        def hgnn(i_hyper, u_hyper, item_embs):
            i_ret, u_ret = item_embs, None
            for _ in range(self.n_hyper_layer):
                lat = i_hyper.T @ i_ret
                i_ret, u_ret = i_hyper @ lat, u_hyper @ lat
            return u_ret, i_ret

        uv_h, iv_h = hgnn(hyper["iv"], hyper["uv"], cge_i)
        ut_h, it_h = hgnn(hyper["it"], hyper["ut"], cge_i)
        fin_u = lge_u + self.alpha * l2norm(uv_h + ut_h)
        fin_i = lge_i + self.alpha * l2norm(iv_h + it_h)
        return fin_u, fin_i, (uv_h, iv_h, ut_h, it_h)

    def _ssl(self, e1: torch.Tensor, e2: torch.Tensor, all_e: torch.Tensor,
             weights: torch.Tensor) -> torch.Tensor:
        n1, n2, na = l2norm(e1), l2norm(e2), l2norm(all_e)
        pos = torch.sum(n1 * n2, dim=1) / self.tau
        logits = (n1 @ na.T) / self.tau
        return torch.sum((torch.logsumexp(logits, dim=1) - pos) * weights)

    def loss_with_draws(self, params: Params, batch: Batch, draws: Draws) -> torch.Tensor:
        fu, fi, (uv_h, iv_h, ut_h, it_h) = self.forward(params, draws)
        bu, bi, w = batch.users, batch.pos_items, batch.weights
        u, pos, neg = fu[bu], fi[bi], fi[batch.neg_items]
        bpr = bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w, eps=1e-5)
        reg = emb_l2_reg(self.reg_weight, (u, pos, neg), w)
        hcl = self._ssl(uv_h[bu], ut_h[bu], ut_h, w) + self._ssl(iv_h[bi], it_h[bi], it_h, w)
        return bpr + self.ssl_reg * hcl + reg

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        return self.loss_with_draws(params, batch, self.draws(generator, batch))

    def embeddings(self, params: Params):
        fu, fi, _ = self.forward(params)
        return fu, fi
