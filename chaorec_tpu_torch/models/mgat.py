"""MGAT: gated graph attention per modality.

Counterpart of ``chaorec_tpu/models/mgat.py`` (reference: Model/MGAT.py):

- the GraphGAT conv (Model/MGAT.py:18-70) over the doubled edge list (each
  train edge in both directions, in node-id space: users, then items):
  ``x W`` per node; per edge ``inner = <x_dst, LReLU(x_src)>``, gate =
  sigmoid(deg_src^-1/2 inner), attention = the per-destination softmax of
  inner x gate (``ops/edge_softmax``); output = the attention-weighted
  ``ops/ell.seg_sum`` of the source rows + bias, row-normalized. Both
  gathers are ``seg_gather``s, so a round runs the prefix kernel once
  forward and twice backward; the softmax's non-negative sums stay on
  ``index_add_``. Weights U(-1/sqrt(in), ..), the conv weight
  xavier-normal, as the GNN module re-initializes it;
- per modality, 3 rounds of x_{k+1} = LReLU(g_k(h) + LReLU(lin_k(x_k)) +
  id); the visual tower projects to 256 and the textual to 100 through a
  tanh MLP; its output is concat(x_1, x_2, x_3) (Model/MGAT.py:73-135);
- final = (v + t) / 2; BPR (+1e-5) + the mean reg of the final rows. The
  raw features are not trained (the reference never registers them,
  Model/MGAT.py:147-149; the quirk is kept).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.edge_softmax import segment_softmax, softmax_bags
from chaorec_tpu_torch.ops.ell import build_segment_transpose, seg_gather, seg_sum
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_normal
from chaorec_tpu_torch.ops.losses import bpr_loss, emb_l2_reg, l2norm


class MGAT(RecModel):
    name = "MGAT"
    dp_split = True  # weighted means over rows (tests/test_torch_mesh.py)
    dim_latent_v = 256
    dim_latent_t = 100

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph,
                 v_feat: torch.Tensor, t_feat: torch.Tensor, dim_E: int, reg_weight: float):
        super().__init__(num_user, num_item)
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.v_feat = v_feat  # not trained (the reference's quirk)
        self.t_feat = t_feat
        n = num_user + num_item
        self.src = torch.cat([graph.u_by_u, graph.i_by_u + num_user])
        self.dst = torch.cat([graph.i_by_u + num_user, graph.u_by_u])
        deg = torch.zeros(n, device=self.device).index_add_(
            0, self.src, torch.ones(self.src.shape[0], device=self.device))
        self.deg_inv_sqrt_src = torch.clamp(deg, min=1.0).pow(-0.5)[self.src]
        self.n_nodes = n
        self._perm_src, self._ptr_src = build_segment_transpose(self.src, n)
        self._perm_dst, self._ptr_dst = build_segment_transpose(self.dst, n)
        self._bags_dst = softmax_bags(self.dst, n)

    def init_params(self, generator: torch.Generator) -> Params:
        p = {"id_embedding": xavier_normal(generator, (self.n_nodes, self.dim_E))}
        for mod, dim_latent, feat in (("v", self.dim_latent_v, self.v_feat),
                                      ("t", self.dim_latent_t, self.t_feat)):
            p[f"{mod}_preference"] = xavier_normal(generator, (self.num_user, dim_latent))
            p[f"{mod}_mlp_w"], p[f"{mod}_mlp_b"] = torch_linear_init(generator, dim_latent,
                                                                   feat.shape[1])
            dims = [dim_latent, self.dim_E, self.dim_E]
            for i, d_in in enumerate(dims):
                p[f"{mod}_conv{i}_w"] = xavier_normal(generator, (d_in, d_in))
                bound = 1.0 / math.sqrt(d_in)
                u = torch.rand(d_in, generator=generator, device=generator.device)
                p[f"{mod}_conv{i}_b"] = (2.0 * u - 1.0) * bound
                p[f"{mod}_lin{i}_w"] = xavier_normal(generator, (self.dim_E, d_in))
                p[f"{mod}_lin{i}_b"] = torch_linear_init(generator, self.dim_E, d_in)[1]
                p[f"{mod}_g{i}_w"] = xavier_normal(generator, (self.dim_E, d_in))
                p[f"{mod}_g{i}_b"] = torch_linear_init(generator, self.dim_E, d_in)[1]
        return p

    def _gat(self, params: Params, mod: str, i: int, x: torch.Tensor) -> torch.Tensor:
        xw = x @ params[f"{mod}_conv{i}_w"]  # the weight applied as x @ W
        xw_src = seg_gather(xw, self.src, self._perm_src, self._ptr_src)
        xw_dst = seg_gather(xw, self.dst, self._perm_dst, self._ptr_dst)
        inner = torch.sum(xw_dst * F.leaky_relu(xw_src, 0.01), dim=1)
        gate = torch.sigmoid(self.deg_inv_sqrt_src * inner)
        att = segment_softmax(inner * gate, self.dst, self.n_nodes, bags=self._bags_dst)
        out = seg_sum(att[:, None] * xw_src, self.dst, self._perm_dst, self._ptr_dst)
        return l2norm(out + params[f"{mod}_conv{i}_b"])

    def _tower(self, params: Params, mod: str, feat: torch.Tensor,
               id_emb: torch.Tensor) -> torch.Tensor:
        tf = torch.tanh(feat @ params[f"{mod}_mlp_w"].T + params[f"{mod}_mlp_b"])
        x = l2norm(torch.cat([params[f"{mod}_preference"], tf], dim=0))
        outs = []
        for i in range(3):
            h = F.leaky_relu(self._gat(params, mod, i, x), 0.01)
            x_hat = F.leaky_relu(x @ params[f"{mod}_lin{i}_w"].T + params[f"{mod}_lin{i}_b"],
                                 0.01) + id_emb
            x = F.leaky_relu(h @ params[f"{mod}_g{i}_w"].T + params[f"{mod}_g{i}_b"] + x_hat,
                             0.01)
            outs.append(x)
        return torch.cat(outs, dim=1)

    def forward(self, params: Params):
        id_emb = params["id_embedding"]
        v = self._tower(params, "v", self.v_feat, id_emb)
        t = self._tower(params, "t", self.t_feat, id_emb)
        rep = (v + t) / 2.0
        return rep[:self.num_user], rep[self.num_user:]

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        fu, fi = self.forward(params)
        u = fu[batch.users]
        pos = fi[batch.pos_items]
        neg = fi[batch.neg_items]
        w = batch.weights
        return (bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w, eps=1e-5)
                + emb_l2_reg(self.reg_weight, (u, pos, neg), w))

    def embeddings(self, params: Params):
        return self.forward(params)
