"""GUME: graph augmentation and user-modality enhancement.

Counterpart of ``chaorec_tpu/models/gume.py`` (reference: Model/GUME.py):

- the U-I graph augmented with item-item edges: each item's neighbours in
  both its visual and its textual 10-NN lists (itself excluded), from a
  host kNN of its own (``knn_indices``: a full numpy similarity and
  argsort, as the JAX package's ``_knn_indices``; the conv graphs below
  come from ``graphs/knn.knn_topk`` and can pick other neighbours at near
  ties, by design), normalized by the joint degrees ``deg_i = (U-I edges)
  + (I-I edges)`` (Model/GUME.py:196-275);
- views: the extended id view (mean of layers 0..n_ui of R and R^T + II
  over [id, extended image users, extended text users] and [id, explicit
  image items, explicit text items], 192 wide), the explicit modal views
  (gated modal item tables over the sym-normalized kNN graphs, their users
  R @ them), coarse/fine fusion with one attention MLP over users and items
  stacked and the behavior gates (Model/GUME.py:300-377);
- loss = BPR + reg1 (1e-5, / 1024) + bm (0.01) InfoNCE(integration,
  extended id) + vt_loss * (|var - var| + |mean - mean| of the explicit
  image and text tables, population variance) + um_loss * (InfoNCE(extended
  modal users, integration users) + two noise-perturbed InfoNCE terms) +
  reg2 (0.1, / 1024) on the extended modal items (Model/GUME.py:380-460).

The graphs' numerics follow ``graph_compute_dtype`` as the JAX package's
do: at "bfloat16", while U * I is at most ``dense_entry_budget``, R, the
I-I graph and both kNN graphs are dense bf16 and every product is bf16 x
bf16 summed in float32 (``ops/mxu.bdot``); otherwise R and the I-I graph
are float32 ``ops/ell.EdgeMatrix`` sums and the kNN graphs gathers.

``signs`` (the noise's sign) and ``gap`` (an absolute difference) are
functions of their own, so that a test can hold two devices to the same
side of their kinks. ``draws`` makes a step's four (B, dim_E) uniforms and
``loss_with_draws`` takes them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from chaorec_tpu_torch.graphs.knn import knn_topk, topk_sym_norm
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.models.slmrec import in_batch_ce
from chaorec_tpu_torch.ops.ell import EdgeMatrix
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_uniform
from chaorec_tpu_torch.ops.losses import l2norm, masked_mean
from chaorec_tpu_torch.ops.mxu import bdot

Draws = Dict[str, torch.Tensor]
NOISES = ("integration_1", "integration_2", "ext_it_1", "ext_it_2")


def signs(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x)


def gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.abs(a - b)


def knn_indices(feats: np.ndarray, k: int) -> np.ndarray:
    """(N, k) each row's k most similar rows by cosine, itself included,
    on the host (the JAX package's ``_knn_indices``, the same numpy calls:
    equal numpy gives equal lists)."""
    f = feats / (np.linalg.norm(feats, axis=1, keepdims=True) + 1e-12)
    sim = f @ f.T
    return np.argsort(-sim, axis=1)[:, :k]


def intersection_edges(vi: np.ndarray, ti: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(rows, cols): item i to each item in both its lists vi[i] and ti[i]
    but i itself, row by row in vi's order."""
    both = (vi[:, :, None] == ti[:, None, :]).any(2) & (vi != np.arange(vi.shape[0])[:, None])
    rows = np.nonzero(both)[0]
    return rows.astype(np.int64), vi[both].astype(np.int64)


def augmented_weights(edges: np.ndarray, ii_rows: np.ndarray, ii_cols: np.ndarray,
                      num_user: int, num_item: int):
    """(uedges (E', 2), their weights du[u] di[i], the I-I weights di[r]
    di[c]) float32: the unique U-I edges and the I-I edges under the joint
    degrees deg_u = U-I edges, deg_i = U-I edges + I-I edges (d^-1/2, 0 at
    degree 0)."""
    uedges = np.unique(edges[:, :2], axis=0)
    deg_u = np.bincount(uedges[:, 0], minlength=num_user).astype(np.float32)
    deg_i = (np.bincount(uedges[:, 1], minlength=num_item).astype(np.float32)
             + np.bincount(ii_rows, minlength=num_item).astype(np.float32))
    with np.errstate(divide="ignore"):
        du = np.where(deg_u > 0, deg_u ** -0.5, 0.0).astype(np.float32)
        di = np.where(deg_i > 0, deg_i ** -0.5, 0.0).astype(np.float32)
    return uedges, du[uedges[:, 0]] * di[uedges[:, 1]], di[ii_rows] * di[ii_cols]


class GUME(RecModel):
    name = "GUME"
    bm_loss = 0.01
    reg_weight_1 = 1e-5
    reg_weight_2 = 0.1
    bm_temp = 0.2
    um_temp = 0.2
    knn_k = 10
    ref_batch = 1024.0
    # dense bf16 graphs only up to this many (U, I) entries
    dense_entry_budget = 8e8

    def __init__(self, num_user: int, num_item: int, edges: np.ndarray, v_feat: torch.Tensor,
                 t_feat: torch.Tensor, dim_E: int, n_layers: int, n_ui_layers: int,
                 um_loss: float, vt_loss: float, compute_dtype: str = "bfloat16",
                 device: torch.device | str = "cpu"):
        super().__init__(num_user, num_item)
        self.device = torch.device(device)
        self.graph_bf16 = (compute_dtype == "bfloat16"
                           and num_user * num_item <= self.dense_entry_budget)
        self.dim_E = dim_E
        self.n_layers = n_layers
        self.n_ui_layers = n_ui_layers
        self.um_loss_w = um_loss
        self.vt_loss_w = vt_loss
        self._v_init, self._t_init = v_feat, t_feat
        k = min(self.knn_k, num_item)
        image_adj = topk_sym_norm(*knn_topk(v_feat, k))
        text_adj = topk_sym_norm(*knn_topk(t_feat, k))

        self.ii_rows, self.ii_cols = intersection_edges(
            knn_indices(v_feat.cpu().numpy(), k), knn_indices(t_feat.cpu().numpy(), k))
        self.uedges, ew, iw = augmented_weights(np.asarray(edges), self.ii_rows, self.ii_cols,
                                                num_user, num_item)
        if self.graph_bf16:
            knn_rows = torch.arange(num_item).repeat_interleave(k)
            self.image_adj, self.text_adj = (
                self._dense(knn_rows, g.indices.reshape(-1), g.weights.reshape(-1), num_item)
                for g in (image_adj, text_adj))
            self.r_norm = self._dense(self.uedges[:, 0], self.uedges[:, 1], ew, num_user)
            self.ii_norm = self._dense(self.ii_rows, self.ii_cols, iw, num_item)
        else:
            self.image_adj, self.text_adj = image_adj, text_adj
            self.r_norm = EdgeMatrix.from_coo(self.uedges[:, 0], self.uedges[:, 1], ew,
                                              num_user, num_item, self.device)
            self.ii_norm = EdgeMatrix.from_coo(self.ii_rows, self.ii_cols, iw, num_item,
                                               num_item, self.device)

    def _dense(self, rows, cols, w, num_rows: int) -> torch.Tensor:
        """The (num_rows, I) bf16 matrix with the float32 weights w set at
        (rows, cols) (each pair once), rounded once."""
        def on(a, dtype=torch.int64):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        d = torch.zeros((num_rows, self.num_item), dtype=torch.float32, device=self.device)
        d[on(rows), on(cols)] = on(w, torch.float32)
        return d.to(torch.bfloat16)

    def init_params(self, generator: torch.Generator) -> Params:
        d = self.dim_E
        p = {"user_embedding": xavier_uniform(generator, (self.num_user, d)),
             "item_id_embedding": xavier_uniform(generator, (self.num_item, d)),
             "extended_image_user": xavier_uniform(generator, (self.num_user, d)),
             "extended_text_user": xavier_uniform(generator, (self.num_user, d)),
             "v_feat": self._v_init.clone(), "t_feat": self._t_init.clone()}
        p["image_reduce_w"], p["image_reduce_b"] = torch_linear_init(generator, d,
                                                                     self._v_init.shape[1])
        p["text_reduce_w"], p["text_reduce_b"] = torch_linear_init(generator, d,
                                                                   self._t_init.shape[1])
        for name in ("image_trans", "text_trans", "image_behavior", "text_behavior"):
            p[f"{name}_w"], p[f"{name}_b"] = torch_linear_init(generator, d, d)
        p["sep_w1"], p["sep_b1"] = torch_linear_init(generator, d, d)
        p["sep_w2"] = torch_linear_init(generator, 1, d)[0]
        return p

    def _R(self, x: torch.Tensor) -> torch.Tensor:
        """R @ x: (I, D) -> (U, D)."""
        if self.graph_bf16:
            return bdot(self.r_norm, x.to(torch.bfloat16))
        return self.r_norm.matvec(x)

    def _Rt(self, x: torch.Tensor) -> torch.Tensor:
        """R^T @ x: (U, D) -> (I, D)."""
        if self.graph_bf16:
            return bdot(self.r_norm.t(), x.to(torch.bfloat16))
        return self.r_norm.t.matvec(x)

    def _II(self, x: torch.Tensor) -> torch.Tensor:
        if self.graph_bf16:
            return bdot(self.ii_norm, x.to(torch.bfloat16))
        return self.ii_norm.matvec(x)

    def _conv_ii(self, adj, x: torch.Tensor) -> torch.Tensor:
        for _ in range(self.n_layers):
            x = bdot(adj, x.to(torch.bfloat16)) if self.graph_bf16 else adj.propagate(x)
        return x

    def _conv_ui(self, xu: torch.Tensor, xi: torch.Tensor):
        """The mean of layers 0..n_ui over the augmented blocks: the new
        items are R^T (users) + II (the old items)."""
        acc_u, acc_i = cu, ci = xu, xi
        for _ in range(self.n_ui_layers):
            cu, ci = self._R(ci), self._Rt(cu) + self._II(ci)
            acc_u, acc_i = acc_u + cu, acc_i + ci
        s = 1.0 / (self.n_ui_layers + 1)
        return acc_u * s, acc_i * s

    def forward(self, params: Params):
        """(all embeddings, integration, extended id, extended modal,
        explicit image, explicit text), each (U + I, dim_E), users first."""
        img_space = torch.sigmoid(
            (params["v_feat"] @ params["image_reduce_w"].T + params["image_reduce_b"])
            @ params["image_trans_w"].T + params["image_trans_b"])
        txt_space = torch.sigmoid(
            (params["t_feat"] @ params["text_reduce_w"].T + params["text_reduce_b"])
            @ params["text_trans_w"].T + params["text_trans_b"])
        items = params["item_id_embedding"]
        exp_img_i = self._conv_ii(self.image_adj, items * img_space)
        exp_txt_i = self._conv_ii(self.text_adj, items * txt_space)
        # one product of R serves both modal user views (R is columnwise)
        exp_img_u, exp_txt_u = torch.chunk(self._R(torch.cat([exp_img_i, exp_txt_i], 1)), 2,
                                           dim=1)

        cat_u = torch.cat([params["user_embedding"], params["extended_image_user"],
                           params["extended_text_user"]], 1)
        cat_i = torch.cat([items, exp_img_i, exp_txt_i], 1)
        au, ai = self._conv_ui(cat_u, cat_i)
        ext_id_u, ext_img_u2, ext_txt_u2 = torch.chunk(au, 3, dim=1)
        ext_id_i, ext_img_i2, ext_txt_i2 = torch.chunk(ai, 3, dim=1)
        ext_it_u = (ext_img_u2 + ext_txt_u2) / 2
        ext_it_i = (ext_img_i2 + ext_txt_i2) / 2

        def query(x):
            return torch.tanh(x @ params["sep_w1"].T + params["sep_b1"]) @ params["sep_w2"].T

        img = torch.cat([exp_img_u, exp_img_i], 0)
        txt = torch.cat([exp_txt_u, exp_txt_i], 0)
        att = torch.softmax(torch.cat([query(img), query(txt)], -1), dim=-1)
        coarse = att[:, :1] * img + att[:, 1:] * txt
        ext_id = torch.cat([ext_id_u, ext_id_i], 0)
        bi = torch.sigmoid(ext_id @ params["image_behavior_w"].T + params["image_behavior_b"])
        bt = torch.sigmoid(ext_id @ params["text_behavior_w"].T + params["text_behavior_b"])
        integration = (bi * (img - coarse) + bt * (txt - coarse) + coarse) / 3.0
        ext_it = torch.cat([ext_it_u, ext_it_i], 0)
        return ext_id + integration, integration, ext_id, ext_it, img, txt

    def draws(self, generator: torch.Generator, batch: Optional[Batch] = None) -> Draws:
        """Four (B, dim_E) uniforms in [0, 1): each noise-perturbed InfoNCE
        term's two perturbations of the batch's integration and extended
        modal user rows."""
        shape = (batch.users.shape[0], self.dim_E)
        return {n: torch.rand(shape, generator=generator, device=self.device) for n in NOISES}

    def loss_with_draws(self, params: Params, batch: Batch, draws: Draws) -> torch.Tensor:
        all_e, integration, ext_id, ext_it, exp_img, exp_txt = self.forward(params)
        U = self.num_user
        fu, fi = all_e[:U], all_e[U:]
        bu, bp, w = batch.users, batch.pos_items, batch.weights
        u, pos, neg = fu[bu], fi[bp], fi[batch.neg_items]
        mf = -masked_mean(F.logsigmoid(torch.sum(u * pos, 1) - torch.sum(u * neg, 1)), w)
        reg1 = self.reg_weight_1 * 0.5 * (
            torch.sum(u ** 2 * w[:, None]) + torch.sum(pos ** 2 * w[:, None])
            + torch.sum(neg ** 2 * w[:, None])) / self.ref_batch
        vt = self.vt_loss_w * (
            gap(torch.var(exp_img, correction=0), torch.var(exp_txt, correction=0))
            + gap(torch.mean(exp_img), torch.mean(exp_txt)))
        bm = self.bm_loss * (
            in_batch_ce(l2norm(integration[:U][bu]), l2norm(ext_id[:U][bu]), self.bm_temp, w)
            + in_batch_ce(l2norm(integration[U:][bp]), l2norm(ext_id[U:][bp]), self.bm_temp,
                          w))

        def noise_cl(name, rows):
            def perturb(noise):
                return rows + signs(rows) * l2norm(noise) * 0.1
            return in_batch_ce(l2norm(perturb(draws[f"{name}_1"])),
                               l2norm(perturb(draws[f"{name}_2"])), self.um_temp, w)

        int_u, it_u = integration[:U][bu], ext_it[:U][bu]
        c = in_batch_ce(l2norm(it_u), l2norm(int_u), self.um_temp, w)
        um = self.um_loss_w * (c + noise_cl("integration", int_u) + noise_cl("ext_it", it_u))
        reg2 = self.reg_weight_2 * 0.5 * torch.sum(ext_it[U:][bp] ** 2 * w[:, None]) \
            / self.ref_batch
        return mf + vt + bm + um + reg1 + reg2

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        return self.loss_with_draws(params, batch, self.draws(generator, batch))

    def embeddings(self, params: Params):
        all_e = self.forward(params)[0]
        return all_e[:self.num_user], all_e[self.num_user:]
