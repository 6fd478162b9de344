"""MHRec: multimodal hypergraph diffusion recommendation, and its trainer.

Counterpart of ``chaorec_tpu/models/mhrec.py`` (reference: Model/MHRec.py,
its three-phase epoch at train_and_evaluate.py:332-512 and the hyperedges
of gen_hypergraph_u_i.py):

- hyperedges (``mhrec_hyperedges``): one a train interaction, [user, its
  ``uu_topk`` co-occurrence users, item, its ``ii_topk`` kNN items] a
  modality, or both modalities from the data root's
  ``hyperedges_visual_u{uu_topk}_i{ii_topk}.npy`` when it exists (the
  reference's loader reads the textual ones from the visual file), ragged
  rows padded with the sentinel node ``num_user + num_item``;
- (A) two DiffRec-style denoisers over the hyperedges' 0/1 incidence rows
  (``dense_rows``: the sentinel drops out), one a modality, each trained
  with a fresh Adam(lr) over the shuffled rows: uniform timesteps, the
  SNR-weighted x0 MSE only; (B) ``rebuild_incidence``: the reverse process from
  a noisy start at t = 4 through all 20 steps at ``sample_dtype``, each
  row's top ``num_hypernodes`` nodes the new incidence, in chunks of 1024
  rows; (C) BPR batches on it with the main Adam, which leaves the
  denoisers out (the JAX trainer's ``set_to_zero``);
- hypergraph attention (Model/MHRec.py:37-89, ``_hyper_attn``): an edge's
  embedding is the sum of its nodes', a slot's score ``x . a[:d] + edge .
  a[d:]`` in fp32, ``exp`` without a max shift, normalized per node by the
  node's sum of exps (+1e-16, an ``index_add_`` of scalars) after the
  messages are summed (``ops/ell.seg_edge_weighted_sum``, through K4 on the
  card); the slot rows are gathered by ``seg_gather`` at ``sample_dtype``
  (bf16 by default, float32 at ``graph_compute_dtype`` float32). The
  reference defines a Linear W and a LeakyReLU it never applies: they have
  no params here;
- the forward (Model/MHRec.py:708-779): per modality ``h_layers`` of
  attention over [user modal table; normalize(projected features)], each
  with the residual and dropout 0.5 (F.dropout's default training flag:
  in every forward, evaluation included), the mean of the stack + beta1
  times the mean-of-stack GCN; softmax-weighted fusion; the id tower's
  mean-of-stack GCN + beta2 times the normalized fusion. The three GCN
  towers run as one 3E-wide propagation. The feature tables are trainable
  copies (dense params of the main Adam);
- the loss (Model/MHRec.py:842-864): BPR (+1e-5), the mean-of-squares reg
  over the final embeddings and the initial id, visual and textual rows,
  and ``ssl_alpha`` times four full-catalog contrasts of the id tower
  against each modal tower (``catalog_logsumexp``: K2 on the card);
- evaluation ranks the output cached from the last training forward (the
  model state), as the reference's ``self.result``.

The state is a dict: the cached ``user`` and ``item`` tables and each
modality's incidence layout (``lay_v``, ``lay_t``: ``build_layout``) for the
epoch. Every draw enters through a ``*_with_draws`` entry: phase A's
timesteps, noise and keep masks, phase B's start noise, phase C's
hypergraph dropout masks.

``CHAOREC_MHREC_PHASE_C_ONLY=1`` runs phase C alone on each hyperedge's
first ``num_hypernodes`` nodes, as the JAX trainer's measurement mode does.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.models.diffmm import (DENOISERS, DiffusionFamilyTrainer, denoise_draws,
                                             dnn_forward, dnn_init, topk_by_value_then_index)
from chaorec_tpu_torch.ops import diffusion as diff
from chaorec_tpu_torch.ops.ell import build_segment_transpose, seg_edge_weighted_sum, seg_gather
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_normal, xavier_uniform
from chaorec_tpu_torch.ops.losses import bpr_loss, catalog_logsumexp, l2norm, masked_mean
from chaorec_tpu_torch.ops.mxu import bdot

Draws = Dict[str, torch.Tensor]
Layout = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
REBUILD_CHUNK = 1024  # hyperedge rows a phase-B chunk


def item_knn(feat: torch.Tensor, k: int, row_chunk: int = 4096) -> np.ndarray:
    """(I, k) int32: each item's k most similar other items by cosine of
    the rows scaled by rsqrt(sum f^2 + 1e-12), the item itself at -inf,
    ties to the lower index (``lax.top_k``'s order), in row chunks."""
    f = feat.to(torch.float32)
    f = f * torch.rsqrt(torch.sum(f * f, 1, keepdim=True) + 1e-12)
    n = f.shape[0]
    out = []
    for s in range(0, n, row_chunk):
        sim = f[s:s + row_chunk] @ f.t()
        rows = torch.arange(sim.shape[0], device=sim.device)
        sim[rows, rows + s] = -torch.inf
        out.append(topk_by_value_then_index(sim, k).cpu().numpy())
    return np.concatenate(out, 0).astype(np.int32)


def mhrec_hyperedges(cfg, ds, v: torch.Tensor, t: torch.Tensor, device
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The (He, W) int32 node lists of each modality (``_mhrec_hyperedges``
    of the JAX builders): the data root's visual file for both when it
    exists, ragged rows padded with the sentinel U + I; else one hyperedge
    a train edge, [user, ``uu_topk`` co-occurrence users (``topk_sample``
    with ``default_rng(seed + 3)``), item + U, ``ii_topk`` kNN items + U]."""
    from chaorec_tpu_torch.graphs.user_graph import build_user_cooccurrence, topk_sample

    n_sent = ds.num_user + ds.num_item
    vis_path = os.path.join(cfg.data_root, ds.name,
                            f"hyperedges_visual_u{cfg.uu_topk}_i{cfg.ii_topk}.npy")
    if os.path.exists(vis_path):
        seq = np.load(vis_path, allow_pickle=True).tolist()
        arr = np.full((len(seq), max(len(h) for h in seq)), n_sent, np.int32)
        for i, h in enumerate(seq):
            arr[i, :len(h)] = list(h)
        return arr, arr.copy()
    rs = np.random.default_rng(cfg.seed + 3)
    idx, cnt, lens = build_user_cooccurrence(ds.train_edges, ds.num_user, ds.num_item,
                                             topk=cfg.uu_topk, device=device)
    uu, _ = topk_sample(idx, cnt, lens, min(cfg.uu_topk, ds.num_user - 1), rs)
    k = min(cfg.ii_topk, ds.num_item - 1)
    e = ds.train_edges

    def pack(ii):
        return np.concatenate([e[:, 0:1], uu[e[:, 0]], e[:, 1:2] + ds.num_user,
                               ii[e[:, 1]] + ds.num_user], axis=1).astype(np.int32)

    return pack(item_knn(v, k)), pack(item_knn(t, k))


class MHRec(RecModel):
    name = "MHRec"
    stateful = True
    emb_size = 10
    dnn_dropout = 0.5
    hyper_dropout = 0.5
    steps = 20  # Model/MHRec.py:395
    sampling_steps = 5  # train_and_evaluate.py:433

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph,
                 hyper_nodes_v: torch.Tensor, hyper_nodes_t: torch.Tensor, v_feat: torch.Tensor,
                 t_feat: torch.Tensor, dim_E: int, reg_weight: float, ii_topk: int, uu_topk: int,
                 num_hypernodes: int, n_layers: int, h_layers: int, ssl_temp: float,
                 ssl_alpha: float, beta1: float, beta2: float, hidden_dims=(1000,),
                 sample_compute_dtype: str = "bfloat16"):
        super().__init__(num_user, num_item)
        self.device = v_feat.device
        self.graph = graph
        self.num_nodes = num_user + num_item
        # (He, W) node lists, the sentinel num_nodes as padding
        self.hyper_nodes_v = hyper_nodes_v.to(self.device, torch.int64)
        self.hyper_nodes_t = hyper_nodes_t.to(self.device, torch.int64)
        self.v_feat0, self.t_feat0 = v_feat, t_feat
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.num_hypernodes = min(int(num_hypernodes), self.num_nodes)
        self.n_layers = n_layers
        self.h_layers = h_layers
        self.ssl_temp = ssl_temp
        self.ssl_alpha = ssl_alpha
        self.beta1 = beta1
        self.beta2 = beta2
        self.hidden_dims = tuple(hidden_dims)
        # phase B's reverse chain and the attention's slot rows at this
        # precision (bf16 operands, float32 sums); phase A stays float32
        self.sample_dtype = torch.bfloat16 if sample_compute_dtype == "bfloat16" else None
        self.sched = diff.make_schedule(0.1, 0.0001, 0.02, self.steps, beta_fixed_value=1e-4,
                                        device=self.device)

    def init_params(self, generator: torch.Generator) -> Params:
        e = self.dim_E
        p = {"v_feat": self.v_feat0.clone(), "t_feat": self.t_feat0.clone()}  # freeze=False
        for m, feats in (("img", self.v_feat0), ("txt", self.t_feat0)):
            p[f"{m}_b"] = torch_linear_init(generator, e, feats.shape[1])[1]
            p[f"{m}_w"] = xavier_uniform(generator, (e, feats.shape[1]))
        p["modal_weight"] = torch.tensor([0.5, 0.5], device=generator.device)
        for name, n in (("u_emb", self.num_user), ("u_v_emb", self.num_user),
                        ("u_t_emb", self.num_user), ("i_emb", self.num_item)):
            p[name] = xavier_normal(generator, (n, e))
        for prefix in DENOISERS:
            p.update(dnn_init(generator, prefix, self.num_nodes, self.hidden_dims,
                              self.emb_size))
        for layer in range(self.h_layers):
            p[f"hv_a{layer}"] = xavier_uniform(generator, (2 * e, 1))
            p[f"ht_a{layer}"] = xavier_uniform(generator, (2 * e, 1))
        return p

    def init_state(self, device: torch.device | str = "cpu",
                   generator: Optional[torch.Generator] = None) -> Dict:
        """Zero cached tables and placeholder layouts, those of an empty
        incidence (every slot the sentinel) at the rebuilt one's shape:
        phase B replaces them before any use, and the state keeps one
        structure, which a checkpoint restores into."""
        def empty(nodes):
            return torch.full((nodes.shape[0], self.num_hypernodes), self.num_nodes,
                              dtype=torch.int64, device=self.device)

        state = {"user": torch.zeros((self.num_user, self.dim_E), device=self.device),
                 "item": torch.zeros((self.num_item, self.dim_E), device=self.device)}
        return self.with_incidence(state, empty(self.hyper_nodes_v), empty(self.hyper_nodes_t))

    # ---------------- phases A and B: the denoisers ----------------
    def dense_rows(self, nodes: torch.Tensor) -> torch.Tensor:
        """(B, W) node lists -> (B, num_nodes) 0/1 incidence rows; the
        sentinel num_nodes falls outside and is dropped."""
        b, n = nodes.shape[0], self.num_nodes + 1
        flat = (torch.arange(b, device=nodes.device)[:, None] * n + nodes).reshape(-1)
        z = torch.zeros(b * n, device=nodes.device).index_add_(
            0, flat, torch.ones(flat.shape[0], device=nodes.device))
        return (z.view(b, n)[:, :self.num_nodes] > 0).to(torch.float32)

    def _dnn(self, params: Params, prefix: str, x, ts, keep=None, compute_dtype=None):
        return dnn_forward(params, prefix, x, ts, self.emb_size, len(self.hidden_dims), keep,
                           self.dnn_dropout, compute_dtype)

    def diffusion_draws(self, generator: torch.Generator, b: int) -> Draws:
        """A denoiser batch's timesteps, noise (b, num_nodes) and keep mask."""
        ts, noise, keep = denoise_draws(generator, b, self.num_nodes, self.steps,
                                        self.dnn_dropout)
        return {"ts": ts, "noise": noise, "keep": keep}

    def hyper_diff_loss_with_draws(self, params: Params, prefix: str, nodes: torch.Tensor,
                                   weights: torch.Tensor, draws: Draws) -> torch.Tensor:
        """Phase A's denoiser loss (Model/MHRec.py:325-361): uniform
        timesteps, the SNR-weighted x0 MSE only."""
        rows = self.dense_rows(nodes)
        ts = draws["ts"]
        x_t = diff.q_sample(self.sched, rows, ts, draws["noise"])
        out = self._dnn(params, prefix, x_t, ts, draws["keep"])
        mse = torch.mean((rows - out) ** 2, dim=1)
        return masked_mean(diff.snr_weight(self.sched, ts) * mse, weights)

    @torch.no_grad()
    def rebuild_rows_with_noise(self, params: Params, prefix: str, nodes: torch.Tensor,
                                noise: torch.Tensor) -> torch.Tensor:
        """Phase B for a chunk of node lists (B, W) and its start noise (B,
        num_nodes): the reverse process from q_sample at t = 4 through the
        whole schedule at ``sample_dtype``, then each row's top
        ``num_hypernodes`` nodes (B, num_hypernodes)."""
        rows = self.dense_rows(nodes)
        t0 = torch.full((rows.shape[0],), self.sampling_steps - 1, dtype=torch.long,
                        device=rows.device)
        x_t = diff.q_sample(self.sched, rows, t0, noise)
        scores = diff.p_sample(
            self.sched,
            lambda x, ts: self._dnn(params, prefix, x, ts, compute_dtype=self.sample_dtype), x_t)
        return topk_by_value_then_index(scores, self.num_hypernodes)

    def rebuild_incidence(self, params: Params, prefix: str, hyper_nodes: torch.Tensor,
                          generator: torch.Generator, noise: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """(He, num_hypernodes): every hyperedge rebuilt, in chunks of
        REBUILD_CHUNK rows padded with sentinel rows whose output is
        dropped; ``noise`` the start noise (n_chunks, REBUILD_CHUNK,
        num_nodes), drawn from ``generator`` a chunk at a time when None."""
        he = hyper_nodes.shape[0]
        out = []
        for c, start in enumerate(range(0, he, REBUILD_CHUNK)):
            chunk = hyper_nodes[start:start + REBUILD_CHUNK]
            pad = REBUILD_CHUNK - chunk.shape[0]
            if pad:
                chunk = torch.cat([chunk, torch.full((pad, chunk.shape[1]), self.num_nodes,
                                                     dtype=chunk.dtype, device=chunk.device)])
            z = (torch.randn((REBUILD_CHUNK, self.num_nodes), generator=generator,
                             device=self.device) if noise is None else noise[c])
            out.append(self.rebuild_rows_with_noise(params, prefix, chunk, z)[:REBUILD_CHUNK - pad])
        return torch.cat(out)

    # ---------------- phase C: the hypergraph towers ----------------
    def build_layout(self, h_nodes: torch.Tensor) -> Layout:
        """An incidence's segment layout for the epoch: the (He, k)
        incidence, whose slots row by row are the flat index list, ``(perm,
        ptr)`` over num_nodes + 1 segments (the last one the sentinel's)
        and each sorted slot's hyperedge."""
        perm, ptr = build_segment_transpose(h_nodes.reshape(-1), self.num_nodes + 1)
        return h_nodes, perm, ptr, perm // h_nodes.shape[1]

    def with_incidence(self, state: Dict, h_v: torch.Tensor, h_t: torch.Tensor) -> Dict:
        """``state`` with the layouts of the incidences ``h_v`` and ``h_t``."""
        return dict(state, lay_v=self.build_layout(h_v), lay_t=self.build_layout(h_t))

    def _hyper_attn(self, a: torch.Tensor, layout: Layout, x: torch.Tensor) -> torch.Tensor:
        """HypergraphAttentionLayer (Model/MHRec.py:37-89) on the incidence
        of ``layout``: the slot rows at ``sample_dtype``, fp32 scores and
        sums, the output in x's dtype."""
        h_nodes, perm, ptr, edge_perm = layout
        he, k = h_nodes.shape
        flat = h_nodes.reshape(-1)
        dt = self.sample_dtype or x.dtype
        d = x.shape[1]
        x_pad = torch.cat([x, x.new_zeros((1, d))]).to(dt)
        xi = seg_gather(x_pad, flat, perm, ptr)  # (He k, D): each hyperedge's slot rows
        slots = xi.view(he, k, d)
        edge_emb = slots[:, 0]
        for j in range(1, k):
            edge_emb = edge_emb + slots[:, j]  # E = H^T X, rounded as the JAX package adds
        # score = [x_node, edge] . a as two thin products (Model/MHRec.py:57-63)
        e_flat = (bdot(xi, a[:d].to(dt))[:, 0]
                  + bdot(edge_emb, a[d:].to(dt))[:, 0, None].expand(-1, k).reshape(-1))
        e_exp = torch.exp(e_flat)
        # non-negative scalar sums stay on index_add_ (ops/ell.seg_sum's CAVEAT)
        sums = torch.zeros(ptr.shape[0] - 1, device=x.device).index_add(0, flat, e_exp)
        # every slot of a node shares its denominator: sum the weighted
        # messages first, divide once a node
        agg = seg_edge_weighted_sum(edge_emb, e_exp, flat, perm, edge_perm, ptr)
        return (agg[:self.num_nodes] / (sums[:self.num_nodes, None] + 1e-16)).to(x.dtype)

    def _gcn_mean(self, xu: torch.Tensor, xi: torch.Tensor):
        us, its = [xu], [xi]
        for _ in range(self.n_layers):
            xu, xi = self.graph.propagate(xu, xi)
            us.append(xu)
            its.append(xi)
        return sum(us) / len(us), sum(its) / len(its)

    def draws(self, generator: torch.Generator, batch: Optional[Batch] = None) -> Draws:
        """A step's hypergraph dropout keep masks (num_nodes, dim_E), the
        visual tower's layers then the textual one's."""
        shape = (self.num_nodes, self.dim_E)
        return {f"keep_{m}{layer}": (torch.rand(shape, generator=generator, device=self.device)
                                     < 1.0 - self.hyper_dropout).float()
                for m in ("v", "t") for layer in range(self.h_layers)}

    def forward(self, params: Params, layouts: Tuple[Layout, Layout], draws: Draws):
        """Model/MHRec.py:708-779: (u_g, i_g, embeds_v, embeds_t, embeds_g)."""
        lay_v, lay_t = layouts
        v_emb = params["v_feat"] @ params["img_w"].t() + params["img_b"]
        t_emb = params["t_feat"] @ params["txt_w"].t() + params["txt_b"]
        w = torch.softmax(params["modal_weight"], 0)
        e = self.dim_E
        # the three GCN towers share the graph and are linear: one 3E-wide pass
        gu3, gi3 = self._gcn_mean(
            torch.cat([params["u_v_emb"], params["u_t_emb"], params["u_emb"]], 1),
            torch.cat([l2norm(v_emb), l2norm(t_emb), params["i_emb"]], 1))

        def modal_tower(m, u_modal, feats, lay, cols):
            stack = [torch.cat([u_modal, l2norm(feats)], 0)]
            for layer in range(self.h_layers):
                nxt = self._hyper_attn(params[f"h{m}_a{layer}"], lay, stack[-1]) + stack[-1]
                stack.append(nxt * draws[f"keep_{m}{layer}"] / (1.0 - self.hyper_dropout))
            hyper = sum(stack) / len(stack)
            return hyper + self.beta1 * torch.cat([gu3[:, cols], gi3[:, cols]], 0)

        embeds_v = modal_tower("v", params["u_v_emb"], v_emb, lay_v, slice(0, e))
        embeds_t = modal_tower("t", params["u_t_emb"], t_emb, lay_t, slice(e, 2 * e))
        modal = w[0] * embeds_v + w[1] * embeds_t
        embeds_g = torch.cat([gu3[:, 2 * e:], gi3[:, 2 * e:]], 0)
        all_embs = embeds_g + self.beta2 * l2norm(modal)
        return (all_embs[:self.num_user], all_embs[self.num_user:], embeds_v, embeds_t,
                embeds_g)

    def _contrast(self, e1, e2, nodes, weights):
        n1, n2 = l2norm(e1), l2norm(e2)
        p1, p2 = n1[nodes], n2[nodes]
        nume = torch.sum(p1 * p2, dim=-1) / self.ssl_temp
        return -masked_mean(nume - catalog_logsumexp(p1, n2, self.ssl_temp), weights)

    def loss_hyper_with_draws(self, params: Params, batch: Batch,
                              layouts: Tuple[Layout, Layout], draws: Draws):
        """Phase C's loss (Model/MHRec.py:842-864): (loss, (u_g, i_g)), the
        forward's output for the evaluation's cache."""
        u_g, i_g, e_v, e_t, e_g = self.forward(params, layouts, draws)
        u, pos, neg, w = batch.users, batch.pos_items, batch.neg_items, batch.weights
        ue, pe, ne = u_g[u], i_g[pos], i_g[neg]
        l_bpr = bpr_loss(torch.sum(ue * pe, 1), torch.sum(ue * ne, 1), w)
        v_emb = params["v_feat"] @ params["img_w"].t() + params["img_b"]
        t_emb = params["t_feat"] @ params["txt_w"].t() + params["txt_b"]
        u0 = torch.cat([params["u_emb"][u], params["u_v_emb"][u], params["u_t_emb"][u]], 1)
        p0 = torch.cat([params["i_emb"][pos], v_emb[pos], t_emb[pos]], 1)
        n0 = torch.cat([params["i_emb"][neg], v_emb[neg], t_emb[neg]], 1)
        reg = self.reg_weight * sum(masked_mean(torch.mean(x ** 2, -1), w)
                                    for x in (ue, pe, ne, u0, p0, n0))
        nu = self.num_user
        gu, gi = e_g[:nu], e_g[nu:]
        ssl = (self._contrast(gu, e_t[:nu], u, w) + self._contrast(gi, e_v[nu:], pos, w)
               + self._contrast(gu, e_v[:nu], u, w) + self._contrast(gi, e_t[nu:], pos, w)
               ) * self.ssl_alpha
        return l_bpr + reg + ssl, (u_g, i_g)

    def loss_stateful_with_draws(self, params: Params, state: Dict, batch: Batch, draws: Draws):
        loss, (u_g, i_g) = self.loss_hyper_with_draws(
            params, batch, (state["lay_v"], state["lay_t"]), draws)
        return loss, dict(state, user=u_g.detach(), item=i_g.detach())

    def loss_stateful(self, params: Params, state: Dict, batch: Batch,
                      generator: torch.Generator):
        return self.loss_stateful_with_draws(params, state, batch, self.draws(generator, batch))

    def embeddings_stateful(self, params: Params, state: Dict):
        """The output cached from the last training forward
        (Model/MHRec.py:866-871)."""
        return state["user"], state["item"]


class MHRecTrainer(DiffusionFamilyTrainer):
    """MHRec's epoch (train_and_evaluate.py:332-512): each modality's
    denoiser over the shuffled hyperedge rows with its own fresh Adam, both
    incidences rebuilt, then the BPR epoch on them."""

    def __init__(self, model: MHRec, dataset, cfg):
        super().__init__(model, dataset, cfg)
        self.phase_c_only = os.environ.get("CHAOREC_MHREC_PHASE_C_ONLY") == "1"

    def train_epoch(self, params: Params, optimizer: torch.optim.Optimizer) -> float:
        from chaorec_tpu_torch.train.loop import deterministic_mode

        base, model = self._base, self.model
        bs = int(self.cfg.batch_size)
        with deterministic_mode():
            if self.phase_c_only:
                logging.info("MHRec PHASE-C-ONLY measurement mode "
                             "(matching the reference log's workload)")
                nh = model.num_hypernodes
                base.model_state = model.with_incidence(
                    base.model_state, model.hyper_nodes_v[:, :nh], model.hyper_nodes_t[:, :nh])
                return self.bpr_epoch(params, optimizer)
            for label, prefix, nodes in (("visual", "img_dn", model.hyper_nodes_v),
                                         ("textual", "txt_dn", model.hyper_nodes_t)):
                logging.info(f"Start to {label} hyperedges diffusion")
                losses = self.denoise_epoch(
                    params, (prefix,), nodes.shape[0],
                    lambda b: model.hyper_diff_loss_with_draws(
                        params, prefix, nodes[b.users], b.weights,
                        model.diffusion_draws(base.generator, b.users.shape[0])))
                self.log_denoise_losses(losses, nodes.shape[0] // bs)
            logging.info("")
            logging.info("Start to re-build hypergraph matrix")
            h_v = model.rebuild_incidence(params, "img_dn", model.hyper_nodes_v, base.generator)
            h_t = model.rebuild_incidence(params, "txt_dn", model.hyper_nodes_t, base.generator)
            logging.info("hypergraph matrix built!")
            base.model_state = model.with_incidence(base.model_state, h_v, h_t)
            return self.bpr_epoch(params, optimizer)


MHRec.trainer_cls = MHRecTrainer
