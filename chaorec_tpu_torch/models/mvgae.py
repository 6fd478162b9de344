"""MVGAE: multimodal variational graph autoencoder with a product of experts.

Counterpart of ``chaorec_tpu/models/mvgae.py`` (reference:
Model/MVGAE.py):

- the conv: xW over the self-loop normalized hop, + bias, rows
  L2-normalized, then dropout 0.1 in training (Model/MVGAE.py:24-68); the
  graph is R renormalized with one self loop a node
  (``graphs/dropout.masked_dense_r(self_loops=True)``), dense in float32;
- one tower a modality (visual, textual, collaborative): min(n_layers, 3)
  rounds of x = LeakyReLU(g_k(LeakyReLU(conv_k(x)))) (``concate`` False
  drops the x_hat the reference computes, a quirk, kept), then mu =
  g_3(LeakyReLU(conv_3 x)) + LeakyReLU(lin_3 x) and logvar the same by
  layer 4 (Model/MVGAE.py:103-226);
- frozen by omission (a quirk, kept): the collaborative "features" table
  and the towers' user preference tables are plain tensors, never
  registered as parameters (Model/MVGAE.py:51-56). They are model
  attributes drawn at build from a generator seeded ``seed + 31`` (the JAX
  builder's ``PRNGKey(seed + 31)``), and ``params.load_frozen`` puts
  another package's in their place (``frozen`` names them);
- the product of experts: (visual, textual), then (that, collaborative)
  (Model/MVGAE.py:71-100, 315-343); z = mu + 0.1 N(0, 1) exp(logvar / 2)
  in training, logvar clamped at 10; ranking by the fused mu;
- loss = BPR (1e-5 inside the log) on the fused sample + kl_weight (=
  reg_weight) * its KL, + the same pair for each modality's own sample
  (Model/MVGAE.py:364-416).

``draws`` makes a step's dropout keep masks (one a conv) and normal noise
(one a sample) and ``loss_with_draws`` takes them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from chaorec_tpu_torch.graphs.dropout import masked_dense_r
from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_normal
from chaorec_tpu_torch.ops.losses import bpr_loss, l2norm

MAX_LOGVAR = 10.0
MODALITIES = ("v", "t", "c")
Draws = Dict[str, torch.Tensor]


class MVGAE(RecModel):
    name = "MVGAE"
    dim_latent = 128
    conv_dropout = 0.1
    frozen = ("collaborative", "v_preference", "t_preference", "c_preference")

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph,
                 v_feat: torch.Tensor, t_feat: torch.Tensor, dim_E: int, reg_weight: float,
                 n_layers: int, seed: int):
        super().__init__(num_user, num_item)
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.kl_weight = reg_weight
        self.n_layers = min(n_layers, 3)
        self.v_feat, self.t_feat = v_feat, t_feat
        ones = torch.ones(graph.num_edges, dtype=torch.float32, device=self.device)
        self.r_sl, self.s_u, self.s_i = masked_dense_r(graph.u_by_u, graph.i_by_u, ones,
                                                       num_user, num_item, self_loops=True)
        gen = torch.Generator(self.device).manual_seed(seed + 31)
        self.collaborative = xavier_normal(gen, (num_item, dim_E))
        self.v_preference = xavier_normal(gen, (num_user, self.dim_latent))
        self.t_preference = xavier_normal(gen, (num_user, self.dim_latent))
        self.c_preference = xavier_normal(gen, (num_user, self.dim_latent))

    @property
    def convs(self) -> Tuple[int, ...]:
        """The conv layers a tower runs: its rounds, then mu's and logvar's."""
        return tuple(range(self.n_layers)) + (3, 4)

    def _feat(self, mod: str) -> torch.Tensor:
        return {"v": self.v_feat, "t": self.t_feat, "c": self.collaborative}[mod]

    def init_params(self, generator: torch.Generator) -> Params:
        d = self.dim_E
        p = {}
        for mod in MODALITIES:
            feat_dim = self._feat(mod).shape[1]
            _, p[f"{mod}_mlp_b"] = torch_linear_init(generator, self.dim_latent, feat_dim)
            p[f"{mod}_mlp_w"] = xavier_normal(generator, (self.dim_latent, feat_dim))
            for i in range(5):
                d_in = self.dim_latent if i == 0 else d
                p[f"{mod}_conv{i}_w"] = xavier_normal(generator, (d_in, d))
                bound = 1.0 / math.sqrt(d_in)
                p[f"{mod}_conv{i}_b"] = (torch.rand(d, generator=generator, device=generator.device)
                                         * 2 * bound - bound)
                _, p[f"{mod}_lin{i}_b"] = torch_linear_init(generator, d, d_in)
                p[f"{mod}_lin{i}_w"] = xavier_normal(generator, (d, d_in))
                _, p[f"{mod}_g{i}_b"] = torch_linear_init(generator, d, d)
                p[f"{mod}_g{i}_w"] = xavier_normal(generator, (d, d))
        return p

    def draws(self, generator: torch.Generator, batch: Optional[Batch] = None) -> Draws:
        """"{mod}_conv{i}" (U + I, dim_E) 0/1 keep masks (keep 0.9), one for
        each conv of each tower; "z" and "z_{mod}" (U + I, dim_E) standard
        normals, the fused and each modality's sample."""
        shape = (self.num_user + self.num_item, self.dim_E)
        keep = 1.0 - self.conv_dropout
        out = {f"{mod}_conv{i}": (torch.rand(shape, generator=generator, device=self.device)
                                  < keep).float() for mod in MODALITIES for i in self.convs}
        for name in ("z",) + tuple(f"z_{mod}" for mod in MODALITIES):
            out[name] = torch.randn(shape, generator=generator, device=self.device)
        return out

    def _conv(self, params: Params, mod: str, i: int, x: torch.Tensor,
              keep: Optional[torch.Tensor]) -> torch.Tensor:
        U = self.num_user
        xw = x @ params[f"{mod}_conv{i}_w"]
        nu = self.r_sl @ xw[U:] + self.s_u[:, None] * xw[:U]
        ni = self.r_sl.T @ xw[:U] + self.s_i[:, None] * xw[U:]
        out = l2norm(torch.cat([nu, ni], 0) + params[f"{mod}_conv{i}_b"])
        if keep is not None:
            out = out * keep / (1.0 - self.conv_dropout)
        return out

    def _tower(self, params: Params, mod: str, pref: torch.Tensor,
               draws: Optional[Draws]) -> Tuple[torch.Tensor, torch.Tensor]:
        def keep(i):
            return None if draws is None else draws[f"{mod}_conv{i}"]

        def lin(name, x):
            return x @ params[f"{mod}_{name}_w"].T + params[f"{mod}_{name}_b"]

        tf = lin("mlp", self._feat(mod))
        x = l2norm(torch.cat([pref, tf], 0))
        for i in range(self.n_layers):
            h = F.leaky_relu(self._conv(params, mod, i, x, keep(i)), 0.01)
            x = F.leaky_relu(lin(f"g{i}", h), 0.01)
        out = []
        for i in (3, 4):  # mu, logvar
            h = F.leaky_relu(self._conv(params, mod, i, x, keep(i)), 0.01)
            out.append(lin(f"g{i}", h) + F.leaky_relu(lin(f"lin{i}", x), 0.01))
        return out[0], out[1]

    @staticmethod
    def _poe(mus: List[torch.Tensor], logvars: List[torch.Tensor], eps: float = 1e-8):
        t = 1.0 / (torch.exp(torch.stack(logvars)) + eps)
        mu = torch.sum(torch.stack(mus) * t, 0) / torch.sum(t, 0)
        return mu, torch.log(1.0 / torch.sum(t, 0))

    def forward(self, params: Params, draws: Optional[Draws] = None):
        """(fused mu, fused logvar, {mod: (mu, logvar)}); ``draws`` None:
        no dropout (ranking)."""
        towers = {mod: self._tower(params, mod, getattr(self, f"{mod}_preference"), draws)
                  for mod in MODALITIES}
        (v_mu, v_lv), (t_mu, t_lv), (c_mu, c_lv) = (towers[m] for m in MODALITIES)
        pd_mu, pd_lv = self._poe([v_mu, t_mu], [v_lv, t_lv])
        pd_mu, pd_lv = self._poe([pd_mu, c_mu], [pd_lv, c_lv])
        return pd_mu, pd_lv, towers

    @staticmethod
    def _reparam(noise: torch.Tensor, mu: torch.Tensor, lv: torch.Tensor) -> torch.Tensor:
        return mu + noise * 0.1 * torch.exp(0.5 * torch.clamp(lv, max=MAX_LOGVAR))

    @staticmethod
    def _kl(mu: torch.Tensor, lv: torch.Tensor) -> torch.Tensor:
        lv = torch.clamp(lv, max=MAX_LOGVAR)
        return -0.5 * torch.mean(torch.sum(1 + lv - mu ** 2 - torch.exp(lv), 1))

    def loss_with_draws(self, params: Params, batch: Batch, draws: Draws) -> torch.Tensor:
        pd_mu, pd_lv, towers = self.forward(params, draws)
        U, w = self.num_user, batch.weights

        def bpr_on(z):
            u = z[:U][batch.users]
            pos, neg = z[U:][batch.pos_items], z[U:][batch.neg_items]
            return bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w, eps=1e-5)

        total = (bpr_on(self._reparam(draws["z"], pd_mu, pd_lv))
                 + self.kl_weight * self._kl(pd_mu, pd_lv))
        for mod in MODALITIES:
            mu, lv = towers[mod]
            total = (total + bpr_on(self._reparam(draws[f"z_{mod}"], mu, lv))
                     + self.kl_weight * self._kl(mu, lv))
        return total

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        return self.loss_with_draws(params, batch, self.draws(generator, batch))

    def embeddings(self, params: Params):
        pd_mu, _, _ = self.forward(params)
        return pd_mu[:self.num_user], pd_mu[self.num_user:]
