"""GraphAug: learned-view graph augmentation with an information bottleneck.

Counterpart of ``chaorec_tpu/models/graphaug.py`` (reference:
Model/GraphAug.py):

- the main branch: plain propagation layers summed with the ego (GCNLayer,
  Model/GraphAug.py:47-55, 411-423), on the float32 edge weights (the JAX
  package's segment sums, not the graph's dense R);
- the MixHop view learner (Model/GraphAug.py:99-245): 3 sparse NGCN layers
  (relu(dropout(X W + b)) propagated i - 1 times, concatenated to 600), 3
  dense ones (dropout(X W) propagated i - 1 times, + b, to 600), then a
  linear map to 2 IB_size = 64, on the detached main embedding. Both views
  take the learner's output from one key in the JAX package, so it is the
  same for both and computed once here;
- the view's edge weights (``view_edges``, Model/GraphAug.py:247-310): an
  edge MLP scores each directed edge of the doubled graph, the gumbel-noised
  sigmoid is detached and clipped to [0.01, 0.99], a RelaxedBernoulli at
  temperature 0.9 draws its weight, and weights at most 0.2 are cut to 0
  (``hard_cut``). No gradient reaches the edge MLP, as in the reference;
  the view learner learns through the KL term only;
- the random edges, with the reference's raw-coordinate quirk: 100000
  (capped at 10 E) (user, item id) pairs of weight 0.05 go from a user's
  node to the node whose index is the item id, in the user block for most
  ids (Model/GraphAug.py:553-558);
- loss = BPR (1e-5 inside the log) on the main branch + the mean reg on the
  raw rows + ssl_reg * the contrast of the two views' batch rows against
  every row of the other view + 1e-5 * KL(mu, softplus(s - IB_size)) / ln 2
  (Model/GraphAug.py:543-575).

A hop over the graph's edges sums each node's edges in a fixed order
(``graphs/dropout.EdgeBags``, built once): the view's weights differ by
direction, so each side takes its own. The random edges change every step
and are summed by ``index_add_`` (the trainer's deterministic mode makes
that a fixed order on the card). ``draws`` draws a step's dropout masks,
gate and RelaxedBernoulli uniforms and random edges; ``loss_with_draws``
takes them, so a test can give both packages the same ones.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from chaorec_tpu_torch.graphs.dropout import EdgeBags, edge_propagate
from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_uniform
from chaorec_tpu_torch.ops.losses import bpr_loss, emb_l2_reg, l2norm, masked_mean

View = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (weights (2E,), r_src, r_dst)


def hard_cut(x: torch.Tensor, threshold: float) -> torch.Tensor:
    """x where it is above ``threshold``, else 0."""
    return x * (x > threshold).to(x.dtype)


class GraphAug(RecModel):
    name = "GraphAug"
    IB_size = 32
    mixhop_width = 200
    mixhop_dropout = 0.5
    n_random_edges = 100000
    random_edge_weight = 0.05
    cut = 0.2

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph, dim_E: int,
                 reg_weight: float, n_layers: int, ssl_temp: float, ssl_reg: float):
        super().__init__(num_user, num_item)
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.n_layers = n_layers
        self.ssl_temp = ssl_temp
        self.ssl_reg = ssl_reg
        self.n_nodes = num_user + num_item
        # the doubled edges in node space: first user -> item, then item -> user
        g = graph
        self.src = torch.cat([g.u_by_u, g.i_by_u + num_user])
        self.dst = torch.cat([g.i_by_u + num_user, g.u_by_u])
        self.w_norm = g.w_by_u.float()
        self.n_rand = min(self.n_random_edges, 10 * int(self.src.shape[0]))
        self.bags = EdgeBags.build(g.u_by_u, g.i_by_u, num_user, num_item)

    def init_params(self, generator: torch.Generator) -> Params:
        d, wdt, ib = self.dim_E, self.mixhop_width, self.IB_size
        p = {"uEmbeds": xavier_uniform(generator, (self.num_user, d)),
             "iEmbeds": xavier_uniform(generator, (self.num_item, d))}
        for i in range(3):
            p[f"sp{i}_w"] = xavier_uniform(generator, (d, wdt))
            p[f"sp{i}_b"] = xavier_uniform(generator, (1, wdt))
        for i in range(3):
            p[f"dn{i}_w"] = xavier_uniform(generator, (3 * wdt, wdt))
            p[f"dn{i}_b"] = xavier_uniform(generator, (1, wdt))
        p["fc_w"], p["fc_b"] = torch_linear_init(generator, 2 * ib, 3 * wdt)
        # the edge MLP: Linear(2 * 2 IB -> dim) -> ReLU -> Linear(dim -> 1)
        p["edge_w1"] = xavier_uniform(generator, (d, 2 * 2 * ib))
        p["edge_b1"] = torch.zeros((d,), device=generator.device)
        p["edge_w2"] = xavier_uniform(generator, (1, d))
        p["edge_b2"] = torch.zeros((1,), device=generator.device)
        return p

    def _hop(self, x: torch.Tensor, w_user: torch.Tensor, w_item: torch.Tensor) -> torch.Tensor:
        """One hop of the node table x (N, D) over the graph's edges: a user
        sums its items weighted by ``w_user``, an item its users by ``w_item``
        (both (E,), in the graph's user order)."""
        nu = self.num_user
        gu, gi = edge_propagate(self.graph.u_by_u, self.graph.i_by_u, w_user, x[:nu], x[nu:],
                                nu, self.num_item, self.bags, w_item=w_item)
        return torch.cat([gu, gi], dim=0)

    def _prop(self, x: torch.Tensor, view: View = None) -> torch.Tensor:
        """One propagation step over the normalized graph, or over a view's
        weighted edges and random edges."""
        if view is None:
            return self._hop(x, self.w_norm, self.w_norm)
        w, r_src, r_dst = view
        e = self.graph.num_edges
        out = self._hop(x, w[e:], w[:e])
        return out.index_add(0, r_dst, self.random_edge_weight * x[r_src])

    def main(self, params: Params, view: View = None) -> torch.Tensor:
        """The ego and its propagation layers, summed: (N, D)."""
        x = torch.cat([params["uEmbeds"], params["iEmbeds"]], dim=0)
        acc = cur = x
        for _ in range(self.n_layers):
            cur = self._prop(cur, view)
            acc = acc + cur
        return acc

    def mixhop(self, params: Params, feats: torch.Tensor,
               keep: List[torch.Tensor]) -> torch.Tensor:
        """The view learner's (N, 2 IB) output; ``keep`` holds the six
        layers' 0/1 dropout masks."""
        scale = 1.0 / (1.0 - self.mixhop_dropout)
        ups = []
        for i in range(3):
            h = F.relu(keep[i] * (feats @ params[f"sp{i}_w"] + params[f"sp{i}_b"]) * scale)
            for _ in range(i):
                h = self._prop(h)
            ups.append(h)
        a1 = torch.cat(ups, dim=1)
        downs = []
        for i in range(3):
            h = keep[3 + i] * (a1 @ params[f"dn{i}_w"]) * scale
            for _ in range(i):
                h = self._prop(h)
            downs.append(h + params[f"dn{i}_b"])
        return torch.cat(downs, dim=1) @ params["fc_w"].T + params["fc_b"]

    @torch.no_grad()
    def view_edges(self, params: Params, node_emb: torch.Tensor,
                   d: Dict[str, torch.Tensor]) -> View:
        """A view's (edge weights, random sources, random destinations) from
        the view learner's detached output and the view's draws."""
        edge_emb = torch.cat([node_emb[self.src], node_emb[self.dst]], dim=1)
        h = F.relu(edge_emb @ params["edge_w1"].T + params["edge_b1"])
        logits = (h @ params["edge_w2"].T + params["edge_b2"])[:, 0]
        eps = d["gate_u"]
        gate = torch.sigmoid(torch.log(eps) - torch.log(1 - eps) + logits)
        att = torch.clamp(gate, 0.01, 0.99)
        u = d["relaxed_u"]  # the RelaxedBernoulli(0.9) draw
        lw = torch.sigmoid((torch.log(att) - torch.log(1 - att) + torch.log(u)
                            - torch.log(1 - u)) / 0.9)
        return hard_cut(lw, self.cut), d["r_src"], d["r_dst"]

    def draws(self, generator: torch.Generator, batch: Batch = None, state=None) -> Dict:
        """The learner's six dropout keep masks and, per view, the gate's
        U(1e-4, 1 - 1e-4), the RelaxedBernoulli's U(1e-6, 1 - 1e-6) and the
        random edges' users and raw item ids."""
        dev, n, wdt = self.device, self.n_nodes, self.mixhop_width
        keep = 1.0 - self.mixhop_dropout

        def uniform(shape, lo, hi):
            return lo + (hi - lo) * torch.rand(shape, generator=generator, device=dev)

        masks = [(torch.rand((n, wdt), generator=generator, device=dev) < keep).float()
                 for _ in range(6)]
        e2 = int(self.src.shape[0])
        views = [{"gate_u": uniform((e2,), 1e-4, 1 - 1e-4),
                  "relaxed_u": uniform((e2,), 1e-6, 1 - 1e-6),
                  "r_src": torch.randint(0, self.num_user, (self.n_rand,), generator=generator,
                                         device=dev),
                  "r_dst": torch.randint(0, self.num_item, (self.n_rand,), generator=generator,
                                         device=dev)}
                 for _ in range(2)]
        return {"keep": masks, "views": views}

    def loss_with_draws(self, params: Params, batch: Batch, draws: Dict) -> torch.Tensor:
        main = self.main(params)
        node_emb = self.mixhop(params, main.detach(), draws["keep"])
        views = [self.view_edges(params, node_emb.detach(), d) for d in draws["views"]]
        ib = self.IB_size
        mu = node_emb[:, :ib]
        std = F.softplus(node_emb[:, ib:] - ib)
        kl = -0.5 * torch.mean(torch.sum(1 + 2 * torch.log(std + 1e-12) - mu ** 2 - std ** 2,
                                         dim=1)) / math.log(2)

        v_embs = [self.main(params, v) for v in views]
        nu, w = self.num_user, batch.weights
        u = main[:nu][batch.users]
        pos = main[nu:][batch.pos_items]
        neg = main[nu:][batch.neg_items]
        bpr = bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w, eps=1e-5)
        reg = emb_l2_reg(self.reg_weight, (params["uEmbeds"][batch.users],
                                           params["iEmbeds"][batch.pos_items],
                                           params["iEmbeds"][batch.neg_items]), w)

        def contrast(e1, e2, rows):
            n1, n2 = l2norm(e1), l2norm(e2)
            p1, p2 = n1[rows], n2[rows]
            nume = torch.sum(p1 * p2, 1) / self.ssl_temp
            return masked_mean(torch.logsumexp((p1 @ n2.T) / self.ssl_temp, 1) - nume, w)

        cl = self.ssl_reg * (contrast(v_embs[0][:nu], v_embs[1][:nu], batch.users)
                             + contrast(v_embs[0][nu:], v_embs[1][nu:], batch.pos_items))
        return bpr + reg + cl + 1e-5 * kl

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        return self.loss_with_draws(params, batch, self.draws(generator, batch))

    def embeddings(self, params: Params):
        main = self.main(params)
        return main[:self.num_user], main[self.num_user:]
