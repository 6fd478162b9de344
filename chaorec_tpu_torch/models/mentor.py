"""MENTOR: multi-level self-supervision with Gaussian alignment.

Counterpart of ``chaorec_tpu/models/mentor.py`` (reference:
Model/MENTOR.py):

- seven 2-layer towers, each with its own user preference table and item
  MLP (Linear, LeakyReLU, Linear): clean visual and textual, id (over a
  trainable id table), and two noisy copies a modality, whose every layer
  adds sign(x) * l2norm(U) * 0.1 with U uniform (Model/MENTOR.py:18-56,
  225-275). A tower's output is x + h + h^2; one 7 dim_E-wide propagation
  serves the seven, the noise added per tower;
- fusion: users are the visual and textual towers' side by side, scaled by
  the softmaxed ``weight_u``; the guide, visual and textual reps repeat
  their one tower twice; every item rep adds its own propagation over the
  multimodal graph (``graphs/knn.mixed_knn_graph``: the visual and the
  textual 10-NN graphs, weights 1/k, mixed 0.5 and 0.5;
  Model/MENTOR.py:60-66, 276-350);
- loss = BPR (1e-5 inside the log) + reg (the batch's preference rows and
  ``weight_u``) + align_weight * the Gaussian alignment (|var| and |mean|
  gaps over 6 pairs of reps) + mask_weight_f * the feature-mask term +
  mask_weight_g * the InfoNCE of the two noisy reps over the full user
  table and the full item table (Model/MENTOR.py:372-428). The reference
  computes the feature-mask term wholly under no_grad, so it is a constant
  and its MLP never trains (a quirk, kept).

The full-table InfoNCE is (U x U) and (I x I) logits: ``torch.mm`` and
``torch.logsumexp``, as the JAX package computes it directly.

``signs`` is the sign the noise takes (a function of its own, so a test
can hold two devices to the same side of 0). ``draws`` makes a step's noise
uniforms and feature-mask keep masks and ``loss_with_draws`` takes them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from chaorec_tpu_torch.graphs.knn import mixed_knn_graph
from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_normal
from chaorec_tpu_torch.ops.losses import bpr_loss, l2norm, masked_mean

Draws = Dict[str, torch.Tensor]
TOWERS = ("v", "t", "id", "v_n1", "t_n1", "v_n2", "t_n2")
NOISY = TOWERS[3:]
LAYERS = 2


def signs(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x)


def full_table_infonce(e1: torch.Tensor, e2: torch.Tensor, temp: float) -> torch.Tensor:
    """Each row of e1 against every row of e2, its own row the positive,
    over normalized rows; the mean over the rows."""
    n1, n2 = l2norm(e1), l2norm(e2)
    pos = torch.sum(n1 * n2, dim=1) / temp
    return torch.mean(torch.logsumexp((n1 @ n2.T) / temp, dim=1) - pos)


class MENTOR(RecModel):
    name = "MENTOR"
    knn_k = 10
    mm_image_weight = 0.5
    noise_eps = 0.1

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph,
                 v_feat: torch.Tensor, t_feat: torch.Tensor, dim_E: int, mm_layers: int,
                 reg_weight: float, ssl_temp: float, dropout: float, align_weight: float,
                 mask_weight_g: float, mask_weight_f: float):
        super().__init__(num_user, num_item)
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.mm_layers = mm_layers
        self.reg_weight = reg_weight
        self.temp = ssl_temp
        self.dropout = dropout
        self.align_weight = align_weight
        self.mask_weight_g = mask_weight_g
        self.mask_weight_f = mask_weight_f
        self.v_feat, self.t_feat = v_feat, t_feat
        self.mm_graph = mixed_knn_graph(v_feat, t_feat, min(self.knn_k, num_item),
                                        self.mm_image_weight)

    def init_params(self, generator: torch.Generator) -> Params:
        d = self.dim_E
        p = {"id_feat": xavier_normal(generator, (self.num_item, d)),
             "weight_u": torch.softmax(xavier_normal(generator, (self.num_user, 2, 1)), dim=1)}
        p["mlp_w"], p["mlp_b"] = torch_linear_init(generator, 2 * d, 2 * d)  # never trained
        for name in TOWERS:
            in_dim = {"v": self.v_feat.shape[1], "t": self.t_feat.shape[1],
                      "id": d}[name.split("_")[0]]
            p[f"{name}_preference"] = xavier_normal(generator, (self.num_user, d))
            p[f"{name}_mlp_w1"], p[f"{name}_mlp_b1"] = torch_linear_init(generator, 4 * d, in_dim)
            p[f"{name}_mlp_w2"], p[f"{name}_mlp_b2"] = torch_linear_init(generator, d, 4 * d)
        return p

    def draws(self, generator: torch.Generator, batch: Optional[Batch] = None) -> Draws:
        """"{tower}_{layer}_u" (U, dim_E) and "{tower}_{layer}_i" (I, dim_E)
        uniforms in [0, 1) for each noisy tower and layer; "mask_u" (U,
        2 dim_E) and "mask_i" (I, 2 dim_E) 0/1 keep masks (keep 1 - dropout)
        of the feature-mask term."""
        d, gen, dev = self.dim_E, generator, self.device
        out = {}
        for name in NOISY:
            for layer in range(LAYERS):
                out[f"{name}_{layer}_u"] = torch.rand((self.num_user, d), generator=gen, device=dev)
                out[f"{name}_{layer}_i"] = torch.rand((self.num_item, d), generator=gen, device=dev)
        keep = 1.0 - self.dropout
        for side, n in (("u", self.num_user), ("i", self.num_item)):
            out[f"mask_{side}"] = (torch.rand((n, 2 * d), generator=gen, device=dev)
                                   < keep).float()
        return out

    def _towers(self, params: Params, feats: Sequence[torch.Tensor],
                draws: Optional[Draws]) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Each tower's (user, item) output, from one 7 dim_E-wide
        propagation of two layers; the noisy towers get their noise only
        under ``draws``."""
        d = self.dim_E
        cus, cis = [], []
        for name, feat in zip(TOWERS, feats):
            tf = F.leaky_relu(feat @ params[f"{name}_mlp_w1"].T + params[f"{name}_mlp_b1"], 0.01)
            tf = tf @ params[f"{name}_mlp_w2"].T + params[f"{name}_mlp_b2"]
            x = l2norm(torch.cat([params[f"{name}_preference"], tf], 0))
            cus.append(x[:self.num_user])
            cis.append(x[self.num_user:])
        cu, ci = torch.cat(cus, 1), torch.cat(cis, 1)

        def perturbed(layer, xu, xi):
            if draws is None:
                return xu, xi
            outs_u, outs_i = [], []
            for j, name in enumerate(TOWERS):
                su, si = xu[:, j * d:(j + 1) * d], xi[:, j * d:(j + 1) * d]
                if name in NOISY:
                    su = su + signs(su) * l2norm(draws[f"{name}_{layer}_u"]) * self.noise_eps
                    si = si + signs(si) * l2norm(draws[f"{name}_{layer}_i"]) * self.noise_eps
                outs_u.append(su)
                outs_i.append(si)
            return torch.cat(outs_u, 1), torch.cat(outs_i, 1)

        acc_u, acc_i, hu, hi = cu, ci, cu, ci
        for layer in range(LAYERS):
            hu, hi = perturbed(layer, *self.graph.propagate(hu, hi))
            acc_u, acc_i = acc_u + hu, acc_i + hi
        n = len(TOWERS)
        return list(torch.chunk(acc_u, n, dim=1)), list(torch.chunk(acc_i, n, dim=1))

    def _mm(self, item_rep: torch.Tensor) -> torch.Tensor:
        h = item_rep
        for _ in range(self.mm_layers):
            h = self.mm_graph.propagate(h)
        return h

    def forward(self, params: Params, draws: Optional[Draws] = None):
        """{rep: (users, items)} for "main", "guide", "v", "t", "n1", "n2"."""
        feats = (self.v_feat, self.t_feat, params["id_feat"]) + (self.v_feat, self.t_feat) * 2
        us, is_ = self._towers(params, feats, draws)
        tower = {name: (u, i) for name, u, i in zip(TOWERS, us, is_)}
        w = params["weight_u"]  # (U, 2, 1)

        def item_rep(a, b):
            x = torch.cat([a, b], 1)
            return x + self._mm(x)

        def fused(a, b):
            (au, ai), (bu, bi) = tower[a], tower[b]
            return torch.cat([w[:, 0] * au, w[:, 1] * bu], 1), item_rep(ai, bi)

        def twice(a):
            au, ai = tower[a]
            return torch.cat([au, au], 1), item_rep(ai, ai)

        return {"main": fused("v", "t"), "guide": twice("id"), "v": twice("v"),
                "t": twice("t"), "n1": fused("v_n1", "t_n1"), "n2": fused("v_n2", "t_n2")}

    def loss_with_draws(self, params: Params, batch: Batch, draws: Draws) -> torch.Tensor:
        reps = self.forward(params, draws)
        fu, fi = reps["main"]
        bu, w = batch.users, batch.weights
        u, pos, neg = fu[bu], fi[batch.pos_items], fi[batch.neg_items]
        bpr = bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w, eps=1e-5)
        reg = self.reg_weight * (
            masked_mean(torch.mean(params["v_preference"][bu] ** 2, 1), w)
            + masked_mean(torch.mean(params["t_preference"][bu] ** 2, 1), w)
            + torch.mean(params["weight_u"] ** 2))

        # the feature-mask term: a constant (the reference's no_grad)
        with torch.no_grad():
            keep = 1.0 - self.dropout
            u2 = fu @ params["mlp_w"].T + params["mlp_b"]
            i2 = fi @ params["mlp_w"].T + params["mlp_b"]
            u1, i1 = fu * draws["mask_u"] / keep, fi * draws["mask_i"] / keep
            mask_f = self.mask_weight_f * (
                (1 - torch.mean(torch.sum(l2norm(u1) * l2norm(u2), 1)))
                + (1 - torch.mean(torch.sum(l2norm(i1) * l2norm(i2), 1))))

        def stats(name):
            e = torch.cat(reps[name], 0)
            return torch.var(e, unbiased=False), torch.mean(e)

        (r_v, r_m), (g_v, g_m), (v_v, v_m), (t_v, t_m) = (stats(n) for n in
                                                          ("main", "guide", "v", "t"))
        align = self.align_weight * (
            torch.abs(g_v - r_v) + torch.abs(g_m - r_m)
            + torch.abs(g_v - v_v) + torch.abs(g_m - v_m)
            + torch.abs(g_v - t_v) + torch.abs(g_m - t_m)
            + torch.abs(r_v - v_v) + torch.abs(r_m - v_m)
            + torch.abs(r_v - t_v) + torch.abs(r_m - t_m)
            + torch.abs(v_v - t_v) + torch.abs(v_m - t_m))

        (n1_u, n1_i), (n2_u, n2_i) = reps["n1"], reps["n2"]
        mask_g = self.mask_weight_g * (full_table_infonce(n1_u, n2_u, self.temp)
                                       + full_table_infonce(n1_i, n2_i, self.temp))
        return bpr + reg + align + mask_f + mask_g

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        return self.loss_with_draws(params, batch, self.draws(generator, batch))

    def embeddings(self, params: Params):
        return self.forward(params)["main"]
