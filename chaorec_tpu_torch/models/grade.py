"""Grade: multi-generator graph augmentation with noise-perturbed modal views,
and its four-optimizer trainer.

Counterpart of ``chaorec_tpu/models/grade.py`` (reference: Model/Grade.py
and the loop at train_and_evaluate.py:259-284):

- three towers (``_tower_x0``): id (uEmbeds; iEmbeds), visual (uvEmbeds;
  the frozen visual features through ``image_trs``) and textual
  (utEmbeds; ``text_trs``); each tower's items add their own propagation
  over the multimodal graph, the kNN graphs (k 10, the reference's
  laplacian) of the visual and of the textual features side by side,
  weighted 0.5 and 0.5 (Model/Grade.py:329-414);
- the stack (``_stack``): the ego and its propagation layers over the
  doubled edge list, summed, each layer a ``seg_gather`` and a
  ``seg_sum`` (the prefix-sum kernel ``csrc/prefix_scan.cu`` on the card),
  with uniform noise / sqrt(d) added after every layer where asked;
- three VGAE generators, one a tower (Model/Grade.py:107-152): mean and std
  heads over the tower's stack, an edge classifier; a generated view keeps
  the edges whose probability is at least 0.5, weighted by it, then
  D^-1/2 renormalized; the degree sums there are scalar sums of
  non-negative values, taken per segment in a fixed order
  (``ops/ell.SegmentBags``), not as prefix differences;
- ``loss_1``: ssl_alpha * (graphcl(id view, visual view) + graphcl(id
  view, textual view)) at ssl_temp + noise_alpha * (graphcl of each modal
  view against its tower stacked over the id view's weights with noise) at
  ssl_temp2; ``bpr_reg_loss``: BPR on the id tower and a 5-term mean reg;
  ``gen_loss``: the three generators' VGAE losses.

``grade_step`` is one batch: the main Adam steps on ``loss_1``, then on
``bpr_reg_loss``, then each generator's Adam (over its ``g{i}_*`` params)
applies ``gen_loss``'s gradient in turn. Every param of the main Adam gets
a gradient before its step, zeros where the loss does not reach it
(``train/loop.grads_into``): optax moves such a param by its momentum
(``image_trs`` and ``text_trs`` in the bpr_reg step). ``GradeTrainer``
is a ``models/adagcl.MultiOptimizerTrainer``, as AdaGCL's is, and keeps no
weights, so the CLI exports nothing for Grade. ``draws`` makes a
step's noise (two uniform and three normal (N, dim_E) tables).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from chaorec_tpu_torch.graphs.knn import mixed_knn_graph
from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.adagcl import (MultiOptimizerTrainer, graphcl, kept_edges,
                                             prefixed, vgae_edge_prob, vgae_heads, vgae_loss)
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.ell import build_segment_transpose, seg_gather, seg_sum, segment_bags
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_uniform
from chaorec_tpu_torch.ops.losses import bpr_loss, masked_mean

Draws = Dict[str, torch.Tensor]
TOWERS = ((1, "id"), (2, "v"), (3, "t"))  # (generator, tower)


class Grade(RecModel):
    name = "Grade"
    knn_k = 10
    mm_image_weight = 0.5
    mm_layers = 1

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph,
                 v_feat: torch.Tensor, t_feat: torch.Tensor, dim_E: int, reg_weight: float,
                 n_layers: int, ssl_temp: float, ssl_alpha: float, ssl_temp2: float,
                 noise_alpha: float):
        super().__init__(num_user, num_item)
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.n_layers = n_layers
        self.ssl_temp = ssl_temp
        self.ssl_alpha = ssl_alpha
        self.ssl_temp2 = ssl_temp2
        self.noise_alpha = noise_alpha
        self.v_feat, self.t_feat = v_feat, t_feat  # frozen
        self.mm_graph = mixed_knn_graph(v_feat, t_feat, min(self.knn_k, num_item),
                                        self.mm_image_weight)
        self.n_nodes = n = num_user + num_item
        g = graph
        self.src = torch.cat([g.u_by_u, g.i_by_u + num_user])
        self.dst = torch.cat([g.i_by_u + num_user, g.u_by_u])
        self.w_norm = torch.cat([g.w_by_u, g.w_by_u]).float()
        self.perm_src, self.ptr_src = build_segment_transpose(self.src, n)
        self.perm_dst, self.ptr_dst = build_segment_transpose(self.dst, n)
        dst_np = self.dst.cpu().numpy()
        self.bags_dst = segment_bags(dst_np, np.arange(dst_np.shape[0]), n, self.device)

    def init_params(self, generator: torch.Generator) -> Params:
        d = self.dim_E
        p = {"uEmbeds": xavier_uniform(generator, (self.num_user, d)),
             "uvEmbeds": xavier_uniform(generator, (self.num_user, d)),
             "utEmbeds": xavier_uniform(generator, (self.num_user, d)),
             "iEmbeds": xavier_uniform(generator, (self.num_item, d))}
        p["image_trs_w"], p["image_trs_b"] = torch_linear_init(generator, d,
                                                               self.v_feat.shape[1])
        p["text_trs_w"], p["text_trs_b"] = torch_linear_init(generator, d, self.t_feat.shape[1])
        for gi, _ in TOWERS:
            for name in ("enc_mean1", "enc_mean2", "enc_std1", "enc_std2", "dec1", "dec2"):
                p[f"g{gi}_{name}_w"], p[f"g{gi}_{name}_b"] = torch_linear_init(
                    generator, 1 if name == "dec2" else d, d)
        return p

    def draws(self, generator: torch.Generator, batch: Optional[Batch] = None) -> Draws:
        """A step's draws: ``loss_1``'s uniform noise of the visual and the
        textual stack ("noise_v", "noise_t"), then ``gen_loss``'s normal
        noise of each generator ("g1", "g2", "g3"), each (N, dim_E)."""
        shape = (self.n_nodes, self.dim_E)
        out = {k: torch.rand(shape, generator=generator, device=self.device)
               for k in ("noise_v", "noise_t")}
        for gi, _ in TOWERS:
            out[f"g{gi}"] = torch.randn(shape, generator=generator, device=self.device)
        return out

    # ------------ propagation ------------
    def _prop(self, x: torch.Tensor, w: Optional[torch.Tensor] = None) -> torch.Tensor:
        w = self.w_norm if w is None else w
        msgs = w[:, None] * seg_gather(x, self.src, self.perm_src, self.ptr_src)
        return seg_sum(msgs, self.dst, self.perm_dst, self.ptr_dst)

    def _stack(self, x0: torch.Tensor, w: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        acc = cur = x0
        for _ in range(self.n_layers):
            cur = self._prop(cur, w)
            if noise is not None:
                cur = cur + noise / math.sqrt(float(x0.shape[1]))
            acc = acc + cur
        return acc

    def _mm(self, h: torch.Tensor) -> torch.Tensor:
        for _ in range(self.mm_layers):
            h = self.mm_graph.propagate(h)
        return h

    def _tower_x0(self, params: Params, mode: str, with_mm: bool = True) -> torch.Tensor:
        if mode == "id":
            items, users = params["iEmbeds"], params["uEmbeds"]
        elif mode == "v":
            items = self.v_feat @ params["image_trs_w"].T + params["image_trs_b"]
            users = params["uvEmbeds"]
        else:
            items = self.t_feat @ params["text_trs_w"].T + params["text_trs_b"]
            users = params["utEmbeds"]
        if with_mm:
            items = items + self._mm(items)
        return torch.cat([users, items], 0)

    def forward_gcn(self, params: Params) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self._mm(params["iEmbeds"])
        out = self._stack(torch.cat([params["uEmbeds"], params["iEmbeds"]], 0))
        return out[:self.num_user], out[self.num_user:] + h

    # ------------ VGAE generators ------------
    def _encode(self, params: Params, gi: int, mode: str, noise: Optional[torch.Tensor] = None):
        return vgae_heads(params, f"g{gi}", self._stack(self._tower_x0(params, mode)), noise)

    @torch.no_grad()
    def _generate_view(self, params: Params, gi: int, mode: str) -> torch.Tensor:
        """Generator ``gi``'s view (no gradient): (2E,) weights, each kept
        edge's probability, D^-1/2 renormalized by the kept weights' sums
        by destination."""
        x, _, _ = self._encode(params, gi, mode)
        return self._renorm_view(vgae_edge_prob(params, f"g{gi}", x[self.src], x[self.dst]))

    def _renorm_view(self, pred: torch.Tensor) -> torch.Tensor:
        """The kept edges' probabilities times (d_src d_dst)^-1/2, the
        degrees their sums by destination (+ 1e-7)."""
        vals = pred * kept_edges(pred)
        d = self.bags_dst.sum(vals[:, None])[:, 0]
        dis = (d + 1e-7) ** -0.5
        return vals * dis[self.src] * dis[self.dst]

    def _gen_loss(self, params: Params, gi: int, mode: str, batch: Batch,
                  noise: torch.Tensor) -> torch.Tensor:
        z, mean, std = self._encode(params, gi, mode, noise)
        return vgae_loss(params, f"g{gi}", self.num_user, z, mean, std, batch, self.reg_weight)

    # ------------ trainer-facing losses ------------
    def loss_1(self, params: Params, batch: Batch, draws: Draws) -> torch.Tensor:
        w1, w2, w3 = (self._generate_view(params, gi, mode) for gi, mode in TOWERS)
        out1 = self._stack(self._tower_x0(params, "id"), w1)
        out2 = self._stack(self._tower_x0(params, "v"), w2)
        out3 = self._stack(self._tower_x0(params, "t"), w3)
        bu, bi, w = batch.users, batch.pos_items, batch.weights
        u, temp = self.num_user, self.ssl_temp
        loss = self.ssl_alpha * (graphcl(out1, out2, u, bu, bi, temp, w)
                                 + graphcl(out1, out3, u, bu, bi, temp, w))
        noise_v = self._stack(self._tower_x0(params, "v", with_mm=False), w1,
                              noise=draws["noise_v"])
        noise_t = self._stack(self._tower_x0(params, "t", with_mm=False), w1,
                              noise=draws["noise_t"])
        temp2 = self.ssl_temp2
        return loss + self.noise_alpha * (graphcl(out2, noise_v, u, bu, bi, temp2, w)
                                          + graphcl(out3, noise_t, u, bu, bi, temp2, w))

    def bpr_reg_loss(self, params: Params, batch: Batch) -> torch.Tensor:
        fu, fi = self.forward_gcn(params)
        u, pos, neg = fu[batch.users], fi[batch.pos_items], fi[batch.neg_items]
        w = batch.weights
        bpr = bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w, eps=1e-5)
        rows = ((params["uEmbeds"], batch.users), (params["iEmbeds"], batch.pos_items),
                (params["iEmbeds"], batch.neg_items), (params["utEmbeds"], batch.users),
                (params["uvEmbeds"], batch.users))
        reg = sum(masked_mean(torch.mean(t[idx] ** 2, 1), w) for t, idx in rows)
        return bpr + self.reg_weight * reg

    def gen_loss(self, params: Params, batch: Batch, draws: Draws) -> torch.Tensor:
        return sum(self._gen_loss(params, gi, mode, batch, draws[f"g{gi}"])
                   for gi, mode in TOWERS)

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        raise NotImplementedError("Grade trains through GradeTrainer")

    def embeddings(self, params: Params):
        return self.forward_gcn(params)


def grade_step(model: Grade, opts: Tuple, params: Params, batch: Batch, draws: Draws,
               on_step: Optional[Callable[[str], None]] = None) -> torch.Tensor:
    """One Grade batch (train_and_evaluate.py:259-284); ``opts`` is (the
    main Adam over every param, the three generators' Adams over their
    ``g{i}_*`` params). Updates ``params`` in place and returns the sum of
    the three losses (detached); ``on_step(label)`` is called after each
    optimizer step ("main1", "main2", "g1", "g2", "g3")."""
    from chaorec_tpu_torch.train.loop import grads_into, opt_params

    opt, *gen_opts = opts
    leaves = opt_params(opt)  # every param (on a mesh, the shards)

    def step(optimizer, label):
        optimizer.step()
        if on_step is not None:
            on_step(label)

    l1 = model.loss_1(params, batch, draws)
    grads_into(l1, leaves)
    step(opt, "main1")
    l2 = model.bpr_reg_loss(params, batch)
    grads_into(l2, leaves)
    step(opt, "main2")
    # only the generators' Adams take this gradient: the other params' is
    # never read, so it is not computed
    l3 = model.gen_loss(params, batch, draws)
    grads_into(l3, opt_params(*gen_opts))
    for (gi, _), g_opt in zip(TOWERS, gen_opts):
        step(g_opt, f"g{gi}")
    return (l1 + l2 + l3).detach()


class GradeTrainer(MultiOptimizerTrainer):
    """The 3-loss / 4-optimizer loop: each batch one ``grade_step``."""

    step = grade_step

    def generator_adams(self, params: Params, lr: float) -> Tuple:
        """The three generators' Adams, each over its ``g{i}_*`` params."""
        from chaorec_tpu_torch.train.loop import ADAM_BETAS, ADAM_EPS

        return tuple(torch.optim.Adam(prefixed(params, f"g{gi}_"), lr=lr, betas=ADAM_BETAS,
                                      eps=ADAM_EPS) for gi, _ in TOWERS)


Grade.trainer_cls = GradeTrainer
