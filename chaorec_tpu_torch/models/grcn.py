"""GRCN: graph-refined convolutional network.

Counterpart of ``chaorec_tpu/models/grcn.py`` (reference: Model/GRCN.py):

- the doubled edge list over N = U + I nodes: the first E edges user ->
  item, the next E item -> user, in the graph's user-sorted order; each
  step drops directed edges with probability ``dropout``, one keep mask
  shared by every branch (Model/GRCN.py:161-168);
- CGCN content towers, one per modality: LeakyReLU-projected features and
  the user preferences, each row L2-normalized; attention ``alpha =
  exp(<x_dst, x_src>) keep / max(sum over the destination's edges, 1e-16)``
  (the rows are unit vectors, so no max is subtracted), output x +
  LeakyReLU(sum over the destination's edges of alpha x_src). The
  reference's routing loop adds zeros (its directed edges all end at
  items), so it is skipped (Model/GRCN.py:89-121);
- edge weights: ReLU of the maximum over modalities of alpha times the
  source node's confidence, times the keep mask (Model/GRCN.py:169-230);
- EGCN id branch: x = the normalized id table, two weighted-sum
  convolutions with LeakyReLU, output x + x1 + x2 (Model/GRCN.py:63-87);
- the representation is [id, image, text] side by side (3 x 64 wide);
  loss = BPR (1e-12 inside the log) + reg on the batch's id rows and
  preferences (Model/GRCN.py:232-260).

Ranking uses the forward without dropout, as the JAX package's
``embeddings`` does (its docstring's "dropped edges" is not what its code
does). Every per-node sum is over ``ops/ell.EdgePattern`` (rows the
destinations, columns the sources), in a fixed order. The JAX package's
lane packing of the two towers is a TPU layout and is not ported.

``modal_max`` (the strongest modality of each edge) is a function of its
own, so that a test can hold two devices to the same modality. ``draws``
makes a step's (E,) edge keep mask and ``loss_with_draws`` takes it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.ell import EdgePattern
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_normal
from chaorec_tpu_torch.ops.losses import l2norm, masked_mean

Draws = Dict[str, torch.Tensor]
MODALITIES = ("v", "t")


def modal_max(x: torch.Tensor) -> torch.Tensor:
    """(E,) the maximum of each row of x (E, modalities); on a tie the
    gradient splits between the tied entries, as jnp.max's does."""
    return torch.amax(x, dim=1)


class GRCN(RecModel):
    name = "GRCN"
    dp_split = True  # weighted means over rows (tests/test_torch_mesh.py)

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph,
                 v_feat: torch.Tensor, t_feat: torch.Tensor, dim_E: int, dim_C: int,
                 reg_weight: float, dropout: float):
        super().__init__(num_user, num_item)
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.dim_C = dim_C
        self.reg_weight = reg_weight
        self.dropout = dropout
        self.feats = {"v": v_feat, "t": t_feat}
        self.n_nodes = num_user + num_item
        self.num_edges = graph.num_edges
        e_u = graph.u_by_u.cpu().numpy()
        e_i = graph.i_by_u.cpu().numpy() + num_user
        src, dst = np.concatenate([e_u, e_i]), np.concatenate([e_i, e_u])
        self.pat = EdgePattern.from_coo(dst, src, self.n_nodes, self.n_nodes, self.device)

    def init_params(self, generator: torch.Generator) -> Params:
        p = {"id_embedding": xavier_normal(generator, (self.n_nodes, self.dim_E)),
             "model_specific_conf": xavier_normal(generator, (self.n_nodes, 2)),
             "v_preference": xavier_normal(generator, (self.num_user, self.dim_C)),
             "t_preference": xavier_normal(generator, (self.num_user, self.dim_C))}
        for mod in MODALITIES:
            p[f"{mod}_mlp_w"], p[f"{mod}_mlp_b"] = torch_linear_init(
                generator, self.dim_C, self.feats[mod].shape[1])
        return p

    def draws(self, generator: torch.Generator, batch: Optional[Batch] = None) -> Draws:
        """"keep": the (E,) 0/1 keep mask of the directed edges (keep 1 -
        dropout); none at dropout 0."""
        if self.dropout <= 0:
            return {}
        keep = torch.rand((self.num_edges,), generator=generator, device=self.device)
        return {"keep": (keep < 1.0 - self.dropout).float()}

    def _cgcn(self, params: Params, mod: str, keep2: torch.Tensor):
        """(rep (N, dim_C), alpha (2E,)) of one modality's tower."""
        f = F.leaky_relu(self.feats[mod] @ params[f"{mod}_mlp_w"].T + params[f"{mod}_mlp_b"],
                         0.01)
        x = torch.cat([l2norm(params[f"{mod}_preference"]), l2norm(f)], 0)
        e = torch.exp(self.pat.pair_inner(x)) * keep2
        denom = torch.clamp(self.pat.weighted_rowsum(e), min=1e-16)
        alpha = e / self.pat.row_gather(denom)
        return x + F.leaky_relu(self.pat.weighted_matvec(alpha, x), 0.01), alpha

    def forward(self, params: Params, draws: Optional[Draws] = None):
        """(user reps (U, 3 dim), item reps (I, 3 dim)); edges dropped under
        ``draws``."""
        if draws:
            keep2 = torch.cat([draws["keep"], draws["keep"]])
        else:
            keep2 = torch.ones((2 * self.num_edges,), device=self.device)
        reps, alphas = zip(*(self._cgcn(params, mod, keep2) for mod in MODALITIES))
        conf = self.pat.col_gather(params["model_specific_conf"])  # the source's, (2E, 2)
        w_edge = F.relu(modal_max(torch.stack(alphas, 1) * conf)) * keep2

        x = l2norm(params["id_embedding"])
        x1 = F.leaky_relu(self.pat.weighted_matvec(w_edge, x), 0.01)
        x2 = F.leaky_relu(self.pat.weighted_matvec(w_edge, x1), 0.01)
        rep = torch.cat([x + x1 + x2, *reps], 1)
        return rep[:self.num_user], rep[self.num_user:]

    def loss_with_draws(self, params: Params, batch: Batch, draws: Draws) -> torch.Tensor:
        fu, fi = self.forward(params, draws)
        bu, w = batch.users, batch.weights
        u, pos, neg = fu[bu], fi[batch.pos_items], fi[batch.neg_items]
        bpr = -masked_mean(torch.log(torch.sigmoid(torch.sum(u * pos, 1)
                                                   - torch.sum(u * neg, 1)) + 1e-12), w)
        idt = params["id_embedding"]
        id_u = idt[bu] ** 2
        reg = self.reg_weight * (
            masked_mean(torch.mean(id_u + idt[self.num_user + batch.pos_items] ** 2, 1), w)
            + masked_mean(torch.mean(id_u + idt[self.num_user + batch.neg_items] ** 2, 1), w)
        ) / 2.0
        reg = reg + self.reg_weight * (
            masked_mean(torch.mean(params["v_preference"][bu] ** 2, 1), w)
            + masked_mean(torch.mean(params["t_preference"][bu] ** 2, 1), w))
        return bpr + reg

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        return self.loss_with_draws(params, batch, self.draws(generator, batch))

    def embeddings(self, params: Params):
        return self.forward(params)
