"""MMGCN: per-modality multimodal GCN towers.

Counterpart of ``chaorec_tpu/models/mmgcn.py`` (reference: Model/MMGCN.py
and BasicGCN.py):

- one 4-round tower a modality: h = LeakyReLU(the self-loop normalized
  hop of conv_k(x)), u_hat = LeakyReLU(lin_k(x)) + id_embedding, x =
  LeakyReLU(g_k([h || u_hat])). The reference's main.py passes the string
  'False' as ``concate``, which is truthy, so the concat branch runs (a
  quirk, kept); has_id is True (Model/MMGCN.py:19-110);
- the visual tower projects its features to 256 wide first; the textual
  tower runs its first round at the raw feature width
  (Model/MMGCN.py:126-133);
- frozen by omission (a quirk, kept): ``id_embedding`` and the towers'
  user preference tables are plain tensors, never registered as
  parameters, so no optimizer steps them (Model/MMGCN.py:34-36, 135-139).
  They are model attributes drawn at build from a generator seeded
  ``seed + 21`` (the JAX builder's ``PRNGKey(seed + 21)``), and
  ``params.load_frozen`` puts another package's in their place (``frozen``
  names them); the raw feature tables are frozen too;
- the graph: R renormalized with one self loop a node
  (``graphs/dropout.masked_dense_r(self_loops=True)``), dense in float32;
- final = the mean of the two towers; loss = -mean(log(sigmoid(pos - neg)
  + 1e-12)) + reg_weight * (the id rows' mean squares, halved, + the mean
  square of the visual preference table) (Model/MMGCN.py:146-158).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from chaorec_tpu_torch.graphs.dropout import masked_dense_r
from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_normal
from chaorec_tpu_torch.ops.losses import l2norm, masked_mean


class MMGCN(RecModel):
    name = "MMGCN"
    dp_split = True  # weighted means over rows (tests/test_torch_mesh.py)
    dim_latent_v = 256
    n_rounds = 4
    frozen = ("id_embedding", "v_preference", "t_preference")

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph,
                 v_feat: torch.Tensor, t_feat: torch.Tensor, dim_E: int, reg_weight: float,
                 seed: int):
        super().__init__(num_user, num_item)
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.v_feat, self.t_feat = v_feat, t_feat  # frozen
        ones = torch.ones(graph.num_edges, dtype=torch.float32, device=self.device)
        self.r_sl, self.s_u, self.s_i = masked_dense_r(graph.u_by_u, graph.i_by_u, ones,
                                                       num_user, num_item, self_loops=True)
        gen = torch.Generator(self.device).manual_seed(seed + 21)
        self.id_embedding = xavier_normal(gen, (num_user + num_item, dim_E))
        self.v_preference = xavier_normal(gen, (num_user, self.dim_latent_v))
        self.t_preference = xavier_normal(gen, (num_user, t_feat.shape[1]))

    def _tower_dims(self, mod: str):
        first = self.dim_latent_v if mod == "v" else self.t_feat.shape[1]
        return [first] + [self.dim_E] * (self.n_rounds - 1)

    def init_params(self, generator: torch.Generator) -> Params:
        d = self.dim_E
        p = {}

        def linear(name, out_d, in_d, xavier=True):
            w, b = torch_linear_init(generator, out_d, in_d)
            p[f"{name}_w"] = xavier_normal(generator, (out_d, in_d)) if xavier else w
            p[f"{name}_b"] = b

        linear("v_mlp", self.dim_latent_v, self.v_feat.shape[1], xavier=False)
        for mod in ("v", "t"):
            for i, d_in in enumerate(self._tower_dims(mod)):
                linear(f"{mod}_conv{i}", d_in, d_in)
                linear(f"{mod}_lin{i}", d, d_in)
                linear(f"{mod}_g{i}", d, d_in + d)
        return p

    def _propagate_sl(self, xu: torch.Tensor, xi: torch.Tensor):
        r = self.r_sl
        return r @ xi + self.s_u[:, None] * xu, r.T @ xu + self.s_i[:, None] * xi

    def _tower(self, params: Params, mod: str, feat: torch.Tensor,
               pref: torch.Tensor) -> torch.Tensor:
        U = self.num_user
        if mod == "v":
            feat = feat @ params["v_mlp_w"].T + params["v_mlp_b"]
        x = l2norm(torch.cat([pref, feat], 0))
        for i in range(self.n_rounds):
            xc = x @ params[f"{mod}_conv{i}_w"].T + params[f"{mod}_conv{i}_b"]
            hu, hi = self._propagate_sl(xc[:U], xc[U:])
            h = F.leaky_relu(torch.cat([hu, hi], 0), 0.01)
            u_hat = F.leaky_relu(x @ params[f"{mod}_lin{i}_w"].T + params[f"{mod}_lin{i}_b"],
                                 0.01) + self.id_embedding
            x = F.leaky_relu(torch.cat([h, u_hat], 1) @ params[f"{mod}_g{i}_w"].T
                             + params[f"{mod}_g{i}_b"], 0.01)
        return x

    def forward(self, params: Params) -> Tuple[torch.Tensor, torch.Tensor]:
        rep = (self._tower(params, "v", self.v_feat, self.v_preference)
               + self._tower(params, "t", self.t_feat, self.t_preference)) / 2.0
        return rep[:self.num_user], rep[self.num_user:]

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        fu, fi = self.forward(params)
        bu, bi, bn, w = batch.users, batch.pos_items, batch.neg_items, batch.weights
        u = fu[bu]
        diff = torch.sum(u * fi[bi], 1) - torch.sum(u * fi[bn], 1)
        bpr = -masked_mean(torch.log(torch.sigmoid(diff) + 1e-12), w)
        idu = self.id_embedding[bu]
        idp = self.id_embedding[self.num_user + bi]
        idn = self.id_embedding[self.num_user + bn]
        reg = self.reg_weight * (masked_mean(torch.mean(idu ** 2 + idp ** 2, 1), w)
                                 + masked_mean(torch.mean(idu ** 2 + idn ** 2, 1), w)) / 2.0
        return bpr + reg + self.reg_weight * torch.mean(self.v_preference ** 2)

    def embeddings(self, params: Params):
        return self.forward(params)
