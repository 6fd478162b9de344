"""LATTICE: learned latent item-item structure.

Counterpart of ``chaorec_tpu/models/lattice.py`` (reference: Model/LATTICE.py
and the first-batch flag loop, train_and_evaluate.py:98-106):

- frozen "original" modal graphs from the raw features at construction:
  the cosine kNN similarities, value-weighted D^-1/2 A D^-1/2
  (Model/LATTICE.py:44-61,100-106);
- the learned graph, rebuilt on the first batch of every epoch
  (``batch.index == 0``) from the projected features, with gradients into
  the projections, the feature tables and the softmax ``modal_weight``
  (``epoch0_params``); every later batch of the epoch reads the stored graph
  detached (``frozen_state_epoch``; Model/LATTICE.py:117-135);
- item_adj = (1 - lambda) * learned + lambda * the modal-weighted originals;
  h = item_adj^mm_layers @ item_emb; the LightGCN U-I mean of layers 0..n;
  the item output adds the L2-normalized h (Model/LATTICE.py:137-151);
- BPR (1e-5 inside the log) + the mean-style L2 of the final rows
  (Model/LATTICE.py:153-177).

Two forms of the item graph, chosen as the JAX package chooses them
(``dense_items``): at ``graph_compute_dtype`` bfloat16, while the (I, I) bf16
matrix fits ``DENSE_ITEM_BYTES``, a dense bf16 (I, I) graph (each similarity
row keeps every entry at least its k-th largest, so a tie keeps more than
k; the laplacian is 0 where a row sums to 0 or less); otherwise the kNN
rows in (vals, idx) form, (I, 4k): the learned block (both modal top-k
blocks, normalized with row sums clamped at 1e-7, ``graphs/knn.topk_sym_norm``)
then the original block.

A frozen batch on a dense U-I graph with ``n_layers`` 1 or 2 and one item
layer takes the JAX package's row path (``_rows``): R^T, R R^T and R^T R
(each a ``chunked_gram`` product, in R's dtype) are built once, and the batch
reads only its rows; at bf16 that rounding of R R^T differs from two
propagations, and it is the JAX package's own computation.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from chaorec_tpu_torch.graphs.knn import gather_weighted_sum, knn_topk, topk_sym_norm
from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_uniform
from chaorec_tpu_torch.ops.losses import bpr_loss, emb_l2_reg, l2norm
from chaorec_tpu_torch.ops.mxu import bdot

Ell = Tuple[torch.Tensor, torch.Tensor]  # (vals (N, k) float32, idx (N, k))
ItemGraph = Union[torch.Tensor, Ell]


def chunked_gram(a: torch.Tensor, chunk: int = 4096) -> torch.Tensor:
    """``a @ a.T`` in a's dtype from float32 sums, in row chunks, so at most
    a (chunk, N) float32 block exists at once."""
    full = a.t()
    return torch.cat([bdot(a[s:s + chunk], full).to(a.dtype)
                      for s in range(0, a.shape[0], chunk)])


def dense_knn_sim(feats: torch.Tensor, topk: int) -> torch.Tensor:
    """build_sim + build_knn_neighbourhood (Model/LATTICE.py:44-61): the
    cosine similarities, each row keeping the entries at least its k-th
    largest (ties included) and zero elsewhere."""
    f = l2norm(feats)
    sim = f @ f.t()
    kth = torch.topk(sim, topk, dim=1).values[:, -1:]
    return torch.where(sim >= kth, sim, torch.zeros_like(sim))


def dense_norm_laplacian(adj: torch.Tensor) -> torch.Tensor:
    """Value-weighted D^-1/2 A D^-1/2 (Model/LATTICE.py:50-56), 0 on a row
    whose sum is not positive."""
    rowsum = adj.sum(-1)
    d = torch.where(rowsum > 0, rowsum ** -0.5, torch.zeros_like(rowsum))
    return adj * d[:, None] * d[None, :]


def ell_knn_graph(feats: torch.Tensor, topk: int) -> Ell:
    """The kNN rows of ``feats`` as (vals, idx), D^-1/2 S D^-1/2 normalized
    (``knn_topk_ell`` then ``topk_sym_norm_ell``); differentiable in the
    features through the top-k gather."""
    g = topk_sym_norm(*knn_topk(feats, topk))
    return g.weights, g.indices


def detach_graph(g: ItemGraph) -> ItemGraph:
    return tuple(x.detach() for x in g) if isinstance(g, tuple) else g.detach()


class LATTICE(RecModel):
    name = "LATTICE"
    stateful = True
    epoch0_params = ("v_feat", "t_feat", "image_trs_w", "image_trs_b",
                     "text_trs_w", "text_trs_b", "modal_weight")
    frozen_state_epoch = True
    # the dense (I, I) bf16 item graph's budget; beyond it the graph stays
    # in (vals, idx) form
    DENSE_ITEM_BYTES = int(1.5e9)

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph,
                 v_feat: torch.Tensor, t_feat: torch.Tensor, dim_E: int, feat_embed_dim: int,
                 reg_weight: float, n_layers: int, mm_layers: int, ii_topk: int,
                 lambda_coeff: float, compute_dtype: str = "float32"):
        super().__init__(num_user, num_item)
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.feat_embed_dim = feat_embed_dim
        self.reg_weight = reg_weight
        self.n_layers = n_layers
        self.mm_layers = mm_layers
        self.topk = ii_topk
        self.lambda_coeff = lambda_coeff
        self._v_init, self._t_init = v_feat, t_feat
        self.dense_items = (compute_dtype == "bfloat16"
                            and num_item * num_item * 2 <= self.DENSE_ITEM_BYTES)
        if self.dense_items:
            self.image_original = dense_norm_laplacian(
                dense_knn_sim(v_feat, ii_topk)).to(torch.bfloat16)
            self.text_original = dense_norm_laplacian(
                dense_knn_sim(t_feat, ii_topk)).to(torch.bfloat16)
        else:
            self.image_original = ell_knn_graph(v_feat, ii_topk)
            self.text_original = ell_knn_graph(t_feat, ii_topk)
        # the frozen-batch row operators (FREEDOM's _rows pattern), built once
        self._rt = self._rrt = self._rtr = None
        r = graph.dense_r
        row_bytes = (num_user * num_user + num_item * num_item) * 2
        if (graph.use_dense and n_layers in (1, 2) and mm_layers == 1
                and row_bytes <= int(6e9)):
            self._rt = r.t().contiguous()
            if n_layers == 2:
                self._rrt = chunked_gram(r)  # R R^T (U, U)
                self._rtr = chunked_gram(self._rt)  # R^T R (I, I)

    def init_params(self, generator: torch.Generator) -> Params:
        fe = self.feat_embed_dim
        p = {"user_embedding": xavier_uniform(generator, (self.num_user, self.dim_E)),
             "item_embedding": xavier_uniform(generator, (self.num_item, self.dim_E)),
             "v_feat": self._v_init.clone(), "t_feat": self._t_init.clone()}
        p["image_trs_w"], p["image_trs_b"] = torch_linear_init(generator, fe,
                                                               self._v_init.shape[1])
        p["text_trs_w"], p["text_trs_b"] = torch_linear_init(generator, fe, self._t_init.shape[1])
        p["modal_weight"] = torch.full((2,), 0.5, device=generator.device)
        return p

    def _original_mix(self, w: torch.Tensor) -> Ell:
        """The modal-weighted originals as one (vals, idx) block: duplicate
        (row, col) slots sum in the gather, as adding the dense matrices."""
        (iv, ii), (tv, ti) = self.image_original, self.text_original
        return torch.cat([w[0] * iv, w[1] * tv], 1), torch.cat([ii, ti], 1)

    def init_state(self, device: torch.device | str = "cpu",
                   generator: Optional[torch.Generator] = None) -> ItemGraph:
        """The item graph's buffer: batch 0 of every epoch overwrites it, so
        only its shape and dtype matter (the learned block is zero-weighted
        padding in the (vals, idx) form)."""
        w = torch.softmax(torch.full((2,), 0.5, device=self.device), 0)
        if self.dense_items:
            wb = w.to(torch.bfloat16)
            return wb[0] * self.image_original + wb[1] * self.text_original
        ov, oi = self._original_mix(w)
        return torch.cat([torch.zeros_like(ov), ov], 1), torch.cat([oi, oi], 1)

    def _build_item_adj(self, params: Params) -> ItemGraph:
        """(1 - lambda) norm(w0 knn(image) + w1 knn(text)) + lambda (w0
        orig_i + w1 orig_t) (Model/LATTICE.py:117-135): dense and rounded to
        bf16, or as (vals, idx), where the learned sum's pattern is both
        modal top-k blocks side by side."""
        image_feats = params["v_feat"] @ params["image_trs_w"].t() + params["image_trs_b"]
        text_feats = params["t_feat"] @ params["text_trs_w"].t() + params["text_trs_b"]
        w = torch.softmax(params["modal_weight"], 0)
        lam = self.lambda_coeff
        if self.dense_items:
            learned = dense_norm_laplacian(w[0] * dense_knn_sim(image_feats, self.topk)
                                           + w[1] * dense_knn_sim(text_feats, self.topk))
            orig = w[0] * self.image_original.float() + w[1] * self.text_original.float()
            return ((1.0 - lam) * learned + lam * orig).to(torch.bfloat16)
        sv, si = knn_topk(image_feats, self.topk)
        tv, ti = knn_topk(text_feats, self.topk)
        lg = topk_sym_norm(torch.cat([w[0] * sv, w[1] * tv], 1), torch.cat([si, ti], 1))
        ov, oi = self._original_mix(w)
        return (torch.cat([(1.0 - lam) * lg.weights, lam * ov], 1),
                torch.cat([lg.indices, oi], 1))

    def _item_hop(self, item_adj: ItemGraph, x: torch.Tensor) -> torch.Tensor:
        if self.dense_items:
            return bdot(item_adj, x.to(torch.bfloat16))
        vals, idx = item_adj
        return gather_weighted_sum(x, vals, idx)

    def _forward(self, params: Params, item_adj: ItemGraph):
        h = params["item_embedding"]
        for _ in range(self.mm_layers):
            h = self._item_hop(item_adj, h)
        xu, xi = params["user_embedding"], params["item_embedding"]
        acc_u, acc_i = xu, xi
        for _ in range(self.n_layers):
            xu, xi = self.graph.propagate(xu, xi)
            acc_u, acc_i = acc_u + xu, acc_i + xi
        s = 1.0 / (self.n_layers + 1)
        return acc_u * s, acc_i * s + l2norm(h)

    def _rows(self, params: Params, item_adj: ItemGraph, users: torch.Tensor,
              items: torch.Tensor):
        """The batch rows of the final embeddings through the row operators:
        _forward's math and a gather (n_layers <= 2, mm_layers 1, a frozen
        item graph)."""
        xu, xi = params["user_embedding"], params["item_embedding"]
        r = self.graph.dense_r
        xu_c, xi_c = xu.to(r.dtype), xi.to(r.dtype)
        u = xu[users] + bdot(r[users], xi_c)
        i = xi[items] + bdot(self._rt[items], xu_c)
        if self.n_layers == 2:
            u = u + bdot(self._rrt[users], xu_c)
            i = i + bdot(self._rtr[items], xi_c)
        s = 1.0 / (self.n_layers + 1)
        if self.dense_items:
            h_rows = bdot(item_adj[items], xi.to(item_adj.dtype))
        else:
            vals, idx = item_adj
            h_rows = gather_weighted_sum(xi, vals[items], idx[items])
        return u * s, i * s + l2norm(h_rows)

    def _bpr(self, u, pos, neg, w):
        return (bpr_loss(torch.sum(u * pos, 1), torch.sum(u * neg, 1), w, eps=1e-5)
                + emb_l2_reg(self.reg_weight, (u, pos, neg), w))

    def loss_stateful(self, params: Params, state: ItemGraph, batch: Batch,
                      generator: Optional[torch.Generator] = None):
        """Batch 0 builds the item graph (the whole loss differentiates
        through it) and returns it, detached, as the new state; a later
        batch reads the state detached, through the row operators where
        they exist, and returns it."""
        if batch.index == 0:
            item_adj = self._build_item_adj(params)
            fu, fi = self._forward(params, item_adj)
            u, pos, neg = fu[batch.users], fi[batch.pos_items], fi[batch.neg_items]
            return self._bpr(u, pos, neg, batch.weights), detach_graph(item_adj)
        item_adj = detach_graph(state)
        if self._rt is not None:
            b = batch.pos_items.shape[0]
            u, both = self._rows(params, item_adj, batch.users,
                                 torch.cat([batch.pos_items, batch.neg_items]))
            pos, neg = both[:b], both[b:]
        else:
            fu, fi = self._forward(params, item_adj)
            u, pos, neg = fu[batch.users], fi[batch.pos_items], fi[batch.neg_items]
        return self._bpr(u, pos, neg, batch.weights), item_adj

    def embeddings_stateful(self, params: Params, state: ItemGraph):
        return self._forward(params, state)
