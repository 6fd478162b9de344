"""FREEDOM: a frozen multimodal item graph and degree-weighted edge pruning.

Counterpart of ``chaorec_tpu/models/freedom.py`` (reference:
Model/FREEDOM.py):

- the item-item graph is built once, from the raw feature tables at init:
  a kNN graph per modality (k = ``ii_topk``, every weight 1/k,
  Model/FREEDOM.py:111-140), mixed as ``mm_image_weight * image +
  (1 - mm_image_weight) * text`` (Model/FREEDOM.py:59-66); the builder
  passes ``lambda_coeff`` as ``mm_image_weight``, as the reference's
  main.py:287-289 does;
- each epoch keeps ``1 - dropout`` of the edges, drawn without replacement
  with probability proportional to the edge weight (a Gumbel top-k), and
  renormalizes R over the kept edges (Model/FREEDOM.py:143-162); training
  and the epoch's ranking both use the pruned R. With ``dropout <= 0`` the
  reference uses degrees counted over its doubled edge list: exactly half
  the symmetric R, kept here as ``0.5 * R`` (Model/FREEDOM.py:73-83);
- forward: h = mm_adj^mm_layers @ item_emb; the user-item propagation's
  mean over layers 0..n_layers; items add h (Model/FREEDOM.py:164-183);
- loss: BPR without epsilon, plus ``reg_weight`` times the BPR losses of
  the projected text and image features (Model/FREEDOM.py:185-215). The
  raw feature tables ``v_feat`` and ``t_feat`` are trainable
  (``nn.Embedding.from_pretrained(freeze=False)``) and are declared
  ``table_params``: the trainer gathers a batch's rows and steps them with
  the row-sparse Adam.

Per epoch, after pruning, the dense R's row operators R^T, R R^T and
R^T R are built (bf16 products summed in float32, stored in R's dtype), so
a training step gathers only its batch's rows of them instead of
propagating over the whole graph: for L = 2 layers, final_u = (E_u +
R E_i + R R^T E_u) / 3 and final_i likewise. FREEDOM runs on the dense R,
as the JAX package's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from chaorec_tpu_torch.graphs.dropout import masked_dense_r
from chaorec_tpu_torch.graphs.knn import gather_weighted_sum, mixed_knn_graph
from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_uniform
from chaorec_tpu_torch.ops.losses import masked_mean
from chaorec_tpu_torch.ops.mxu import bdot

PRUNE_SEED = 6151  # the JAX package's pruning key, PRNGKey(6151) folded with the epoch


class FREEDOM(RecModel):
    name = "FREEDOM"
    dp_split = True  # weighted means over rows (tests/test_torch_mesh.py)
    table_params = ("v_feat", "t_feat")

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph,
                 v_feat: torch.Tensor, t_feat: torch.Tensor, dim_E: int, dim_feat: int,
                 reg_weight: float, dropout: float, n_layers: int, mm_layers: int,
                 ii_topk: int, mm_image_weight: float):
        super().__init__(num_user, num_item)
        if not graph.use_dense:
            raise ValueError("FREEDOM runs on the dense R; this graph is above "
                             "dense_prop_threshold")
        self.graph = graph
        self.device = graph.dense_r.device
        self.dim_E = dim_E
        self.dim_feat = dim_feat
        self.reg_weight = reg_weight
        self.dropout = dropout
        self.n_layers = n_layers
        self.mm_layers = mm_layers
        self.ii_topk = ii_topk
        self.mm_image_weight = mm_image_weight
        self._v_feat_init = v_feat
        self._t_feat_init = t_feat
        self.mm_graph = mixed_knn_graph(v_feat, t_feat, ii_topk, mm_image_weight)
        self.masked_r = graph.dense_r if dropout > 0.0 else 0.5 * graph.dense_r
        self._edge_u = graph.u_by_u
        self._edge_i = graph.i_by_u
        self._log_edge_w = torch.log(graph.w_by_u)
        self._rt = self._rrt = self._rtr = None
        if n_layers in (1, 2):
            self._build_row_ops()

    def _build_row_ops(self) -> None:
        """R^T, and for two layers R R^T and R^T R, of this epoch's R."""
        self._rt = self._rrt = self._rtr = None  # free the last epoch's first
        r = self.masked_r
        self._rt = r.t().contiguous()
        if self.n_layers == 2:
            self._rrt = bdot(r, self._rt).to(r.dtype)
            self._rtr = bdot(self._rt, r).to(r.dtype)

    def init_params(self, generator: torch.Generator) -> Params:
        vw, vb = torch_linear_init(generator, self.dim_feat, self._v_feat_init.shape[1])
        tw, tb = torch_linear_init(generator, self.dim_feat, self._t_feat_init.shape[1])
        return {
            "user_embedding": xavier_uniform(generator, (self.num_user, self.dim_E)),
            "item_embedding": xavier_uniform(generator, (self.num_item, self.dim_E)),
            "v_feat": self._v_feat_init.clone(),
            "t_feat": self._t_feat_init.clone(),
            "image_trs_w": vw, "image_trs_b": vb,
            "text_trs_w": tw, "text_trs_b": tb,
        }

    # -- per-epoch edge pruning ---------------------------------------------
    def prune_mask(self, epoch: int) -> torch.Tensor:
        """(E,) float 0/1 keep mask over the by-user edge order: the top
        ``int(E * (1 - dropout))`` of log(w) + Gumbel noise, which is the
        reference's weighted draw without replacement
        (np.random.choice(p=w / sum(w), replace=False)). The noise comes
        from a generator seeded from PRUNE_SEED and the epoch."""
        e = self._edge_u.shape[0]
        gen = torch.Generator(self.device).manual_seed((PRUNE_SEED << 32) + epoch)
        gumbel = -torch.log(torch.empty(e, device=self.device).exponential_(generator=gen))
        keep_idx = torch.topk(self._log_edge_w + gumbel, int(e * (1.0 - self.dropout))).indices
        return torch.zeros(e, device=self.device).index_fill_(0, keep_idx, 1.0)

    def apply_keep_mask(self, keep: torch.Tensor) -> None:
        """R renormalized over the kept edges, in the graph's dtype, and
        its row operators."""
        r = masked_dense_r(self._edge_u, self._edge_i, keep, self.num_user, self.num_item)
        self.masked_r = r.to(self.graph.dense_r.dtype)
        del r
        if self._rt is not None:
            self._build_row_ops()

    def pre_epoch(self, params: Params, epoch: int) -> None:
        if self.dropout <= 0.0:
            return  # masked_r is the halved R from init, every epoch
        self.apply_keep_mask(self.prune_mask(epoch))

    # -- forward ----------------------------------------------------------
    def forward(self, params: Params):
        h = params["item_embedding"]
        for _ in range(self.mm_layers):
            h = self.mm_graph.propagate(h)
        r = self.masked_r
        xu, xi = params["user_embedding"], params["item_embedding"]
        acc_u, acc_i = xu, xi
        for _ in range(self.n_layers):
            xu, xi = bdot(r, xi.to(r.dtype)), bdot(r.t(), xu.to(r.dtype))
            acc_u = acc_u + xu
            acc_i = acc_i + xi
        s = 1.0 / (self.n_layers + 1)
        return acc_u * s, acc_i * s + h

    def embeddings(self, params: Params):
        return self.forward(params)

    def _rows(self, params: Params, users: torch.Tensor, items: torch.Tensor):
        """The batch's rows of ``forward``'s output, from the row operators
        (the same math, gathered)."""
        xu, xi = params["user_embedding"], params["item_embedding"]
        dt = self.masked_r.dtype
        xu_c, xi_c = xu.to(dt), xi.to(dt)
        scale = 1.0 / (self.n_layers + 1)
        u = xu[users] + bdot(self.masked_r[users], xi_c)
        i = xi[items] + bdot(self._rt[items], xu_c)
        if self.n_layers == 2:
            u = u + bdot(self._rrt[users], xu_c)
            i = i + bdot(self._rtr[items], xi_c)
        if self.mm_layers == 1:  # one hop: the batch items' neighbour rows only
            h_rows = gather_weighted_sum(xi, self.mm_graph.weights[items],
                                         self.mm_graph.indices[items])
        else:
            h = xi
            for _ in range(self.mm_layers):
                h = self.mm_graph.propagate(h)
            h_rows = h[items]
        return u * scale, i * scale + h_rows

    # -- loss -------------------------------------------------------------
    @staticmethod
    def _bpr(u, pos, neg, w):
        return -masked_mean(F.logsigmoid(torch.sum(u * pos, 1) - torch.sum(u * neg, 1)), w)

    def table_rows(self, batch: Batch):
        items = torch.cat([batch.pos_items, batch.neg_items])
        return {"v_feat": items, "t_feat": items}

    def loss_tables(self, dense_params: Params, table_rows_vals, batch: Batch,
                    generator: torch.Generator) -> torch.Tensor:
        params = dense_params
        b = batch.pos_items.shape[0]
        if self._rt is not None:
            u, both = self._rows(params, batch.users,
                                 torch.cat([batch.pos_items, batch.neg_items]))
            pos, neg = both[:b], both[b:]
        else:
            fu, fi = self.forward(params)
            u, pos, neg = fu[batch.users], fi[batch.pos_items], fi[batch.neg_items]
        w = batch.weights
        mf = self._bpr(u, pos, neg, w)

        def proj(feat_rows, w_key, b_key):
            # bf16 rows (relaxed precision) promote to float32, as in JAX
            return feat_rows.float() @ params[w_key].T + params[b_key]

        t_rows, v_rows = table_rows_vals["t_feat"], table_rows_vals["v_feat"]
        mf_t = self._bpr(u, proj(t_rows[:b], "text_trs_w", "text_trs_b"),
                         proj(t_rows[b:], "text_trs_w", "text_trs_b"), w)
        mf_v = self._bpr(u, proj(v_rows[:b], "image_trs_w", "image_trs_b"),
                         proj(v_rows[b:], "image_trs_w", "image_trs_b"), w)
        return mf + self.reg_weight * (mf_t + mf_v)

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        dense = {k: v for k, v in params.items() if k not in self.table_params}
        rows = self.table_rows(batch)
        gathered = {n: params[n][rows[n]] for n in self.table_params}
        return self.loss_tables(dense, gathered, batch, generator)
