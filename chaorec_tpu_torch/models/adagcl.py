"""AdaGCL: adaptive graph contrastive learning with two learned generators,
and its three-optimizer trainer.

Counterpart of ``chaorec_tpu/models/adagcl.py`` (reference:
Model/AdaGCL.py and the loop at train_and_evaluate.py:72-97):

- the main branch (``forward_graphcl``): the sum of the ego and its
  propagation layers over the doubled edge list, each layer a
  ``seg_gather`` and a ``seg_sum`` (``ops/ell.py``: the prefix-sum kernel
  ``csrc/prefix_scan.cu`` on the card, forward and backward);
- generator 1, a VGAE (Model/AdaGCL.py:370-505): mean and std heads over
  the main branch, an edge classifier ``sigmoid(dec(relu(x_src x_dst)))``;
  its view keeps the edges whose probability is at least 0.5 and scales
  the kept weights by total / kept;
- generator 2, the DenoisingNet (Model/AdaGCL.py:490-716): per-layer
  hard-concrete edge gates (gamma -0.45, zeta 1.05) from attention MLPs
  (the layer index capped at 1), each layer's gates renormalized with
  D^-1/2 clipped at 10, an L0 term with lambda0 1e-4. Its loss propagates
  the frozen copy of the initial embedding drawn at build time, not the
  params (a reference quirk, kept): ``frozen_feats``, a buffer, which
  ``load_frozen_feats`` sets from the JAX model's;
- the contrast (``graphcl``): the batch's users and positive items of two
  views against each other at ``ssl_temp``.

The gates' degree sums are scalar sums of non-negative values: they are
taken per segment in a fixed order (``ops/ell.bag_sum``, and ``bag_gather``
for the gathers whose gradient they need), not as prefix differences,
whose absolute error grows with the running total (the caveat of
``ops/ell.seg_sum``).

``alternating_step`` is one batch: (1) the main Adam steps on ssl_alpha *
graphcl of the two generated views; (2) the main Adam steps on ib_reg *
(graphcl of each new view against the detached view of step 1); (3) the
main Adam steps on BPR + reg + both generator losses, and then the same
gradient goes through generator 1's Adam over the ``g1_*`` params and
generator 2's (eps 1e-3) over the ``g2_*`` params: the reference's
shared-parameter double update, kept. optax steps every leaf every time,
a zero gradient included, and Adam then moves it by its momentum: every
param of an optimizer gets a gradient before its step, zeros where the
loss does not reach it (``train/loop.grads_into``).

``AdaGCLTrainer`` (a ``MultiOptimizerTrainer``, as Grade's is) takes the
shuffles, negatives, evaluation, early stopping and log lines from the
standard ``Trainer`` and keeps no weights of its own, so the CLI exports
nothing for AdaGCL, as the JAX CLI. ``draws``
makes a step's random draws (generator 1's normal noise, generator 2's
per-layer uniforms), and the step takes them, so a test can give both
packages the same ones.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.ell import (bag_gather, bag_sum, build_segment_transpose,
                                       seg_gather, seg_sum, segment_bags)
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_uniform
from chaorec_tpu_torch.ops.losses import bpr_loss, emb_l2_reg, l2norm, masked_mean

GAMMA, ZETA = -0.45, 1.05
Draws = Dict[str, object]


def kept_edges(prob: torch.Tensor) -> torch.Tensor:
    """1 where an edge's probability is at least 0.5, else 0 (a generated
    view's keep mask)."""
    return (prob >= 0.5).to(prob.dtype)


def linear(params: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ params[f"{name}_w"].T + params[f"{name}_b"]


def graphcl(x1: torch.Tensor, x2: torch.Tensor, num_user: int, users: torch.Tensor,
            items: torch.Tensor, temp: float, weights: torch.Tensor) -> torch.Tensor:
    """The batch's users and positive items of view x1 against view x2:
    -log(pos / (row sum - pos)) of exp(cosine / temp) of the row-normalized
    rows, a weighted mean over the 2B rows (Model/AdaGCL.py:153-168)."""
    u = num_user
    e1 = torch.cat([l2norm(x1[:u])[users], l2norm(x1[u:])[items]], 0)
    e2 = torch.cat([l2norm(x2[:u])[users], l2norm(x2[u:])[items]], 0)
    n1 = torch.sqrt(torch.sum(e1 ** 2, 1) + 1e-12)
    n2 = torch.sqrt(torch.sum(e2 ** 2, 1) + 1e-12)
    sim = torch.exp((e1 @ e2.T) / (n1[:, None] * n2[None, :]) / temp)
    pos = torch.diagonal(sim)
    w2 = torch.cat([weights, weights])
    per_row = -torch.log(pos / torch.clamp(sim.sum(1) - pos, min=1e-12) + 1e-12)
    return torch.sum(per_row * w2) / torch.clamp(torch.sum(w2), min=1.0)


def vgae_heads(params: Params, prefix: str, x: torch.Tensor,
               noise: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(z, mean, std) of a VGAE encoder's heads over x: z is the mean, or
    mean + std * noise when ``noise`` is given."""
    mean = linear(params, f"{prefix}_enc_mean2", F.relu(linear(params, f"{prefix}_enc_mean1", x)))
    std = F.softplus(linear(params, f"{prefix}_enc_std2",
                            F.relu(linear(params, f"{prefix}_enc_std1", x))))
    return (mean if noise is None else mean + std * noise), mean, std


def vgae_edge_prob(params: Params, prefix: str, a: torch.Tensor, b: torch.Tensor
                   ) -> torch.Tensor:
    """(n,) sigmoid(dec2(relu(dec1(relu(a b))))): the edge classifier."""
    h = F.relu(linear(params, f"{prefix}_dec1", F.relu(a * b)))
    return torch.sigmoid(linear(params, f"{prefix}_dec2", h))[:, 0]


def vgae_loss(params: Params, prefix: str, num_user: int, z: torch.Tensor, mean: torch.Tensor,
              std: torch.Tensor, batch: Batch, reg_weight: float) -> torch.Tensor:
    """A VGAE generator's loss on the batch: the edge classifier's BCE on
    the positive and negative items, 0.1 KL, BPR on z and the encoder's
    squared weights times ``reg_weight`` (Model/AdaGCL.py:420-470)."""
    u = z[:num_user][batch.users]
    pos = z[num_user:][batch.pos_items]
    neg = z[num_user:][batch.neg_items]
    w = batch.weights
    pos_pred = vgae_edge_prob(params, prefix, u, pos)
    neg_pred = vgae_edge_prob(params, prefix, u, neg)
    rec = -torch.log(pos_pred + 1e-8) - torch.log(1 - neg_pred + 1e-8)
    kl = -0.5 * torch.sum(1 + 2 * torch.log(std + 1e-8) - mean ** 2 - std ** 2, 1)
    bpr = bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w, eps=1e-5)
    reg = reg_weight * sum(torch.sum(v ** 2) for k, v in params.items()
                           if k.startswith(f"{prefix}_enc"))
    return masked_mean(rec, w) + 0.1 * torch.mean(kl) + bpr + reg


class AdaGCL(RecModel):
    name = "AdaGCL"
    ib_reg = 0.01
    lambda0 = 1e-4

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph, dim_E: int,
                 reg_weight: float, n_layers: int, ssl_temp: float, ssl_alpha: float,
                 seed: int):
        super().__init__(num_user, num_item)
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.n_layers = n_layers
        self.ssl_temp = ssl_temp
        self.ssl_alpha = ssl_alpha
        self.n_nodes = n = num_user + num_item
        g = graph
        # the doubled edges in node space: first user -> item, then item -> user
        self.src = torch.cat([g.u_by_u, g.i_by_u + num_user])
        self.dst = torch.cat([g.i_by_u + num_user, g.u_by_u])
        self.w_norm = torch.cat([g.w_by_u, g.w_by_u]).float()
        self.perm_src, self.ptr_src = build_segment_transpose(self.src, n)
        self.perm_dst, self.ptr_dst = build_segment_transpose(self.dst, n)
        src_np, dst_np = self.src.cpu().numpy(), self.dst.cpu().numpy()
        entries = np.arange(src_np.shape[0])
        self.bags_src = segment_bags(src_np, entries, n, self.device)
        self.bags_dst = segment_bags(dst_np, entries, n, self.device)
        # the frozen copy of the initial embedding (the JAX builder draws it
        # from PRNGKey(seed + 41); this one from a generator seeded so)
        gen = torch.Generator(self.device).manual_seed(seed + 41)
        self.frozen_feats = torch.cat([xavier_uniform(gen, (num_user, dim_E)),
                                       xavier_uniform(gen, (num_item, dim_E))], 0)

    def load_frozen_feats(self, feats) -> None:
        """Set the frozen initial-embedding copy (a numpy array or tensor),
        e.g. the JAX model's ``frozen_feats``; ``init_params`` returns it."""
        self.frozen_feats = torch.tensor(np.array(feats), dtype=torch.float32, device=self.device)

    def init_params(self, generator: torch.Generator) -> Params:
        """The tables are copies of ``frozen_feats`` (the generator draws the
        generators' layers only)."""
        d = self.dim_E
        p = {"uEmbeds": self.frozen_feats[:self.num_user].clone(),
             "iEmbeds": self.frozen_feats[self.num_user:].clone()}
        for name in ("enc_mean1", "enc_mean2", "enc_std1", "enc_std2", "dec1", "dec2"):
            p[f"g1_{name}_w"], p[f"g1_{name}_b"] = torch_linear_init(
                generator, 1 if name == "dec2" else d, d)
        for layer in (0, 1):
            for name in ("nb", "self"):
                p[f"g2_{name}{layer}_w"], p[f"g2_{name}{layer}_b"] = torch_linear_init(
                    generator, d, d)
            p[f"g2_att{layer}_w"], p[f"g2_att{layer}_b"] = torch_linear_init(generator, 1, 2 * d)
        return p

    def draws(self, generator: torch.Generator, batch: Optional[Batch] = None) -> Draws:
        """A step's draws: generator 1's normal noise (N, dim_E) ("g1") and
        generator 2's uniforms in (1e-7, 1 - 1e-7) over the doubled edges,
        one (2E,) a layer ("g2")."""
        noise = torch.randn((self.n_nodes, self.dim_E), generator=generator, device=self.device)
        e2 = self.src.shape[0]
        return {"g1": noise,
                "g2": [torch.rand(e2, generator=generator, device=self.device) * (1 - 2e-7) + 1e-7
                       for _ in range(self.n_layers)]}

    # ------------- propagation -------------
    def _prop(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        msgs = w[:, None] * seg_gather(x, self.src, self.perm_src, self.ptr_src)
        return seg_sum(msgs, self.dst, self.perm_dst, self.ptr_dst)

    def forward_graphcl(self, params: Params, w_edges: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """(N, D): the ego and its layers over ``w_edges`` (the normalized
        weights when None), summed."""
        x = torch.cat([params["uEmbeds"], params["iEmbeds"]], 0)
        w = self.w_norm if w_edges is None else w_edges
        acc = cur = x
        for _ in range(self.n_layers):
            cur = self._prop(cur, w)
            acc = acc + cur
        return acc

    # ------------- generator 1 (VGAE) -------------
    @torch.no_grad()
    def g1_generate(self, params: Params) -> torch.Tensor:
        """Generator 1's view: (2E,) weights, the normalized ones on the kept
        edges scaled by total / kept (no gradient)."""
        x, _, _ = vgae_heads(params, "g1", self.forward_graphcl(params))
        keep = kept_edges(vgae_edge_prob(params, "g1", x[self.src], x[self.dst]))
        scale = float(self.src.shape[0]) / torch.clamp(torch.sum(keep), min=1.0)
        return self.w_norm * keep * scale

    def g1_loss(self, params: Params, batch: Batch, noise: torch.Tensor) -> torch.Tensor:
        z, mean, std = vgae_heads(params, "g1", self.forward_graphcl(params), noise)
        return vgae_loss(params, "g1", self.num_user, z, mean, std, batch, self.reg_weight)

    # ------------- generator 2 (DenoisingNet) -------------
    def _g2_gate(self, params: Params, x: torch.Tensor, layer: int,
                 u: Optional[torch.Tensor] = None, beta: float = 1.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(hard-concrete mask (2E,), log alpha (2E,)) of ``layer``'s gates
        over x; ``u`` the uniforms of the stochastic gate, else its mean."""
        f1 = F.relu(linear(params, f"g2_nb{layer}",
                           seg_gather(x, self.src, self.perm_src, self.ptr_src)))
        f2 = F.relu(linear(params, f"g2_self{layer}",
                           seg_gather(x, self.dst, self.perm_dst, self.ptr_dst)))
        log_alpha = linear(params, f"g2_att{layer}", torch.cat([f1, f2], 1))[:, 0]
        if u is not None:
            gate = torch.sigmoid((torch.log(u) - torch.log(1 - u) + log_alpha) / beta)
        else:
            gate = torch.sigmoid(log_alpha)
        return torch.clamp(gate * (ZETA - GAMMA) + GAMMA, 0.0, 1.0), log_alpha

    def _g2_renorm(self, mask: torch.Tensor) -> torch.Tensor:
        """mask * d_src^-1/2 * d_dst^-1/2, the degrees the masks' sums by
        destination (+ 1e-6), each d^-1/2 clipped at 10; every sum in a
        fixed order per segment, differentiable."""
        d = bag_sum(mask, self.dst, self.bags_dst) + 1e-6
        dis = torch.clamp(d ** -0.5, 0.0, 10.0)
        return (mask * bag_gather(dis, self.src, self.bags_src)
                * bag_gather(dis, self.dst, self.bags_dst))

    def forward_graphcl_g2(self, params: Params) -> torch.Tensor:
        """The main branch over generator 2's view: each layer's weights are
        the renormalized mean gates over that layer's (detached) input."""
        x = torch.cat([params["uEmbeds"], params["iEmbeds"]], 0)
        acc = cur = x
        for layer in range(self.n_layers):
            with torch.no_grad():
                w = self._g2_renorm(self._g2_gate(params, cur.detach(), min(layer, 1))[0])
            cur = self._prop(cur, w)
            acc = acc + cur
        return acc

    def g2_loss(self, params: Params, batch: Batch, uniforms: List[torch.Tensor]
                ) -> torch.Tensor:
        """BPR on the frozen copy propagated over the stochastic gates
        (temperature ssl_temp), + reg over the g2 params + lambda0 L0."""
        temp = self.ssl_temp
        acc = cur = self.frozen_feats
        l0 = 0.0
        for layer in range(self.n_layers):
            mask, log_alpha = self._g2_gate(params, cur, min(layer, 1), uniforms[layer],
                                            beta=temp)
            cur = self._prop(cur, self._g2_renorm(mask))
            acc = acc + cur
            l0 = l0 + torch.mean(torch.sigmoid(log_alpha - temp * math.log(-GAMMA / ZETA)))
        u = acc[:self.num_user][batch.users]
        pos = acc[self.num_user:][batch.pos_items]
        neg = acc[self.num_user:][batch.neg_items]
        bpr = bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), batch.weights, eps=1e-5)
        reg = self.reg_weight * sum(torch.sum(v ** 2) for k, v in params.items()
                                    if k.startswith("g2_"))
        return bpr + reg + self.lambda0 * l0

    # ------------- the three losses of a step -------------
    def loss_graphcl(self, x1, x2, users, items, weights) -> torch.Tensor:
        return graphcl(x1, x2, self.num_user, users, items, self.ssl_temp, weights)

    def loss_1(self, params: Params, batch: Batch) -> Tuple[torch.Tensor, Tuple]:
        """(ssl_alpha * graphcl of the two generated views, the views)."""
        out1 = self.forward_graphcl(params, self.g1_generate(params))
        out2 = self.forward_graphcl_g2(params)
        loss = self.ssl_alpha * self.loss_graphcl(out1, out2, batch.users, batch.pos_items,
                                                  batch.weights)
        return loss, (out1, out2)

    def loss_2(self, params: Params, batch: Batch, views: Tuple) -> torch.Tensor:
        """ib_reg * graphcl of each new view against ``views`` (detached)."""
        v1 = self.forward_graphcl(params, self.g1_generate(params))
        v2 = self.forward_graphcl_g2(params)
        b, w = batch, batch.weights
        return self.ib_reg * (
            self.loss_graphcl(v1, views[0].detach(), b.users, b.pos_items, w)
            + self.loss_graphcl(v2, views[1].detach(), b.users, b.pos_items, w))

    def loss_3(self, params: Params, batch: Batch, draws: Draws) -> torch.Tensor:
        """BPR + the mean reg of the raw rows on the main branch, + both
        generators' losses."""
        x = self.forward_graphcl(params)
        u = x[:self.num_user][batch.users]
        pos = x[self.num_user:][batch.pos_items]
        neg = x[self.num_user:][batch.neg_items]
        w = batch.weights
        bpr = bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w, eps=1e-5)
        reg = emb_l2_reg(self.reg_weight, (params["uEmbeds"][batch.users],
                                           params["iEmbeds"][batch.pos_items],
                                           params["iEmbeds"][batch.neg_items]), w)
        return (bpr + reg + self.g1_loss(params, batch, draws["g1"])
                + self.g2_loss(params, batch, draws["g2"]))

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        raise NotImplementedError("AdaGCL trains through AdaGCLTrainer")

    def embeddings(self, params: Params):
        x = self.forward_graphcl(params)
        return x[:self.num_user], x[self.num_user:]


def prefixed(params: Params, prefix: str) -> List[torch.Tensor]:
    """The params whose name starts with ``prefix``, in the dict's order."""
    return [v for k, v in params.items() if k.startswith(prefix)]


def alternating_step(model: AdaGCL, opts: Tuple, params: Params, batch: Batch, draws: Draws,
                     on_step: Optional[Callable[[str], None]] = None) -> torch.Tensor:
    """One AdaGCL batch (train_and_evaluate.py:72-97): five optimizer steps
    on three losses; ``opts`` is (the main Adam over every param, generator
    1's Adam over the g1 params, generator 2's over the g2 params). Updates
    ``params`` in place and returns the sum of the three losses (detached);
    ``on_step(label)`` is called after each optimizer step ("main1",
    "main2", "main3", "g1", "g2")."""
    from chaorec_tpu_torch.train.loop import grads_into, opt_params

    opt, opt_g1, opt_g2 = opts
    leaves = opt_params(opt)  # every param (on a mesh, the shards)

    def step(optimizer, label):
        optimizer.step()
        if on_step is not None:
            on_step(label)

    l1, views = model.loss_1(params, batch)
    grads_into(l1, leaves)
    step(opt, "main1")
    l2 = model.loss_2(params, batch, views)
    grads_into(l2, leaves)
    step(opt, "main2")
    l3 = model.loss_3(params, batch, draws)
    grads_into(l3, leaves)
    # the same gradient through all three optimizers
    step(opt, "main3")
    step(opt_g1, "g1")
    step(opt_g2, "g2")
    return (l1 + l2 + l3).detach()


class MultiOptimizerTrainer:
    """A family trainer whose every batch is one ``step`` over several
    optimizers: the main Adam over every param (the standard trainer's)
    and the generators' Adams that ``generator_adams`` makes. The standard
    ``Trainer`` underneath draws the shuffles and negatives, evaluates,
    stops early and logs; this class keeps no weights of its own, so the
    CLI exports nothing, as the JAX CLI does for these trainers."""

    step: Callable = None  # (model, opts, params, batch, draws) -> the batch's loss

    def __init__(self, model: RecModel, dataset, cfg):
        from chaorec_tpu_torch.train.loop import Trainer

        self._base = base = Trainer(model, dataset, cfg)
        self.model = model
        self.cfg = cfg
        self.gen_opts: Tuple = ()
        base.make_optimizer = self.make_optimizer
        base.train_epoch = self.train_epoch

    def generator_adams(self, params: Params, lr: float) -> Tuple:
        raise NotImplementedError

    def make_optimizer(self, params: Params) -> torch.optim.Adam:
        """The main Adam over every param; makes the generators' Adams anew."""
        from chaorec_tpu_torch.train.loop import Trainer

        self.gen_opts = self.generator_adams(params, float(self.cfg.learning_rate))
        return Trainer.make_optimizer(self._base, params)

    def train_step(self, params: Params, optimizer: torch.optim.Optimizer,
                   batch: Batch) -> torch.Tensor:
        """One batch (with its negatives): the model's draws, then ``step``."""
        from chaorec_tpu_torch.train.loop import deterministic_mode

        with deterministic_mode():
            draws = self.model.draws(self._base.generator, batch)
            # on a mesh, the view is gathered anew after each optimizer step
            return type(self).step(self.model, (optimizer, *self.gen_opts), params, batch,
                                   draws, on_step=lambda _: self._base.refresh())

    def train_epoch(self, params: Params, optimizer: torch.optim.Optimizer) -> float:
        from chaorec_tpu_torch.data.sampling import make_edge_batches
        from chaorec_tpu_torch.train.loop import deterministic_mode

        base = self._base
        losses = []
        with deterministic_mode():
            for batch in make_edge_batches(base.generator, base.edges, int(self.cfg.batch_size)):
                losses.append(self.train_step(params, optimizer, base.bpr_batch(batch)))
        return float(torch.stack(losses).sum())

    def run(self):
        return self._base.run()


class AdaGCLTrainer(MultiOptimizerTrainer):
    """The 3-loss / 3-optimizer loop: each batch one ``alternating_step``."""

    step = alternating_step

    def generator_adams(self, params: Params, lr: float) -> Tuple:
        """optax.multi_transform's "g" labels: generator 1's Adam over the g1
        params, generator 2's (eps 1e-3) over the g2 params."""
        from chaorec_tpu_torch.train.loop import ADAM_BETAS, ADAM_EPS

        return (torch.optim.Adam(prefixed(params, "g1_"), lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS),
                torch.optim.Adam(prefixed(params, "g2_"), lr=lr, betas=ADAM_BETAS, eps=1e-3))


AdaGCL.trainer_cls = AdaGCLTrainer
