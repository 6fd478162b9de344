"""LightGT: a light graph transformer over each user's item history.

Counterpart of ``chaorec_tpu/models/lightgt.py`` (reference:
Model/LightGT.py with its datasets and loops, dataload.py:61-148,
train_and_evaluate.py:126-132, 573-577, main.py:197-199, 349-350):

- a LightGCN tower whose layer-prefix means feed the transformer: with
  L = ``n_layers`` transformer and propagation layers, the user and item
  embeddings are the mean of all L + 1 states and ``*_mean[i]`` the mean
  of the first i + 2 (Model/LightGT.py:156-209);
- each sample is a token sequence: slot 0 is the user (its prefix means in
  the src streams, the trainable ``user_exp`` row in the input stream),
  slots 1.. a random subset of the user's history (50 in training, 20 in
  evaluation), padded with item 0 under the key-padding mask
  (dataload.py:88-97, 137-145);
- the encoder: every layer starts from one init (the reference deep-copies
  one layer) and is its own param from then on. Single-head attention with
  separate q, k and v maps; the query and key read ``out + src[l]``, the
  value ``out``; scores scaled by d^-0.5 / 100 (a reference quirk), masked
  keys at the float32 minimum, softmax, dropout 0.1 of the attention
  weights in training, the output map, then LayerNorm (population
  variance, eps 1e-5); no residual and no FFN (the reference comments them
  out) (Model/LightGT.py:17-131);
- modal heads: the v and t features are row-normalized once, projected by
  ``*_lin``; the src streams are sigmoid(``*_mlp``(detached prefix means));
  slot 0's output goes through ``*_dense`` and LeakyReLU(0.01)
  (Model/LightGT.py:305-334);
- loss = -mean(log(sigmoid(pos - neg))) with no epsilon (the reference has
  none here) of the score 0.05 * id score + 0.95 * modal score, + reg_weight
  * the means of the full propagated tables (Model/LightGT.py:337-369);
- ranking: score-mode, the same 0.05/0.95 mix over every item, seen items
  set to 1e-5 (not 1e-6: a reference quirk) (Model/LightGT.py:371-410).

The evaluation subsets are drawn at construction, then again before every
ranking pass (``resample_eval``, which the trainer calls), as the
reference's EvalDataset reshuffles each pass; the export ranks with the
subsets of the last draw. Each draw comes from a generator seeded from the
run's seed and the draw's number. ``draws`` makes a step's training
sequences and attention keep masks and ``loss_with_draws`` takes them.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_normal
from chaorec_tpu_torch.ops.losses import l2norm, masked_mean

Draws = Dict[str, torch.Tensor]
MODALITIES = ("v", "t")


def pad_cols(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` (B, H) with ``n`` columns of zeros (False) on the right."""
    return torch.cat([x, x.new_zeros((x.shape[0], n))], 1)


def draw_eval_subsets(hist: torch.Tensor, generator: torch.Generator, num_item: int,
                      sl: int):
    """(items (U, sl + 1), mask (U, sl + 1)): a random ``min(sl, H)``-subset
    of each user's padded history ``hist`` (U, H), slot 0 for the user;
    padding is item 0 with the mask set (dataload.py:124-145)."""
    n_user, h = hist.shape
    valid = hist < num_item
    u = torch.rand((n_user, h), generator=generator, device=hist.device)
    pri = torch.where(valid, u, torch.inf)
    idx = torch.argsort(pri, dim=1, stable=True)[:, :min(sl, h)]
    items = torch.gather(hist, 1, idx)
    ok = torch.gather(valid, 1, idx)
    if h < sl:  # histories shorter than the window: pad out
        items, ok = pad_cols(items, sl - h), pad_cols(ok, sl - h)
    zeros = torch.zeros((n_user, 1), dtype=torch.int64, device=hist.device)
    ev_items = torch.cat([zeros, torch.where(ok, items, 0).to(torch.int64)], 1)
    ev_mask = torch.cat([zeros.bool(), ~ok], 1)
    return ev_items, ev_mask


class LightGT(RecModel):
    name = "LightGT"
    rank_mode = "scores"
    mask_value = 1e-5  # Model/LightGT.py:396 (a quirk: 1e-5, not 1e-6)
    score_weight1 = 0.05  # Model/LightGT.py:224
    train_src_len = 50
    eval_src_len = 20
    attn_dropout = 0.1

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph,
                 history_values: torch.Tensor, v_feat: torch.Tensor, t_feat: torch.Tensor,
                 dim_E: int, reg_weight: float, n_layers: int, seed: int = 0):
        super().__init__(num_user, num_item)
        self.graph = graph
        self.device = graph.u_by_u.device
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.n_layers = n_layers
        self.v_feat, self.t_feat = l2norm(v_feat), l2norm(t_feat)
        self.hist = history_values.to(self.device, torch.int64)  # (U, H), fill = num_item
        self._eval_seed = seed
        self._eval_draws = 0
        self.resample_eval()

    def resample_eval(self) -> None:
        """Draw each user's evaluation subset afresh, on the device."""
        gen = torch.Generator(self.device).manual_seed((self._eval_seed << 32)
                                                       + self._eval_draws)
        self._eval_draws += 1
        self.eval_items, self.eval_mask = draw_eval_subsets(self.hist, gen, self.num_item,
                                                            self.eval_src_len)

    def init_params(self, generator: torch.Generator) -> Params:
        e = self.dim_E
        p = {"u_emb": xavier_normal(generator, (self.num_user, e)),
             "i_emb": xavier_normal(generator, (self.num_item, e)),
             "user_exp": xavier_normal(generator, (self.num_user, e))}
        for pre, feat in (("v", self.v_feat), ("t", self.t_feat)):
            p[f"{pre}_mlp_w"], p[f"{pre}_mlp_b"] = torch_linear_init(generator, e, e)
            p[f"{pre}_lin_w"], p[f"{pre}_lin_b"] = torch_linear_init(generator, e, feat.shape[1])
            p[f"{pre}_dense_w"], p[f"{pre}_dense_b"] = torch_linear_init(generator, e, e)
            # one encoder-layer init, copied into every layer
            layer = {m: torch_linear_init(generator, e, e) for m in ("q", "k", "v", "o")}
            for l in range(self.n_layers):
                for m, (w, b) in layer.items():
                    p[f"{pre}_{m}_w{l}"], p[f"{pre}_{m}_b{l}"] = w.clone(), b.clone()
                p[f"{pre}_ln_w{l}"] = torch.ones(e, device=generator.device)
                p[f"{pre}_ln_b{l}"] = torch.zeros(e, device=generator.device)
        return p

    # -- draws ----------------------------------------------------------------
    def train_sequences(self, users: torch.Tensor, generator: torch.Generator):
        """(user_item (B, 51), mask (B, 51)): a random 50-subset of each
        user's history by uniform scores, slot 0 for the user
        (dataload.py:88-97)."""
        rows = self.hist[users]  # (B, H), fill = num_item
        b, h = rows.shape
        valid = rows < self.num_item
        u = torch.rand((b, h), generator=generator, device=rows.device)
        scores = torch.where(valid, u, -1.0)
        sl = self.train_src_len
        if h > sl:
            vals, idx = torch.topk(scores, sl, dim=1)
            items, sel = torch.gather(rows, 1, idx), vals >= 0.0
        else:
            items, sel = pad_cols(rows, sl - h), pad_cols(valid, sl - h)
        items = torch.where(sel, items, 0)
        zeros = torch.zeros((b, 1), dtype=torch.int64, device=rows.device)
        return torch.cat([zeros, items], 1), torch.cat([zeros.bool(), ~sel], 1)

    def draws(self, generator: torch.Generator, batch: Batch) -> Draws:
        """"user_item" and "mask" (B, 51) of ``train_sequences``, then
        "keep_{v,t}{l}" (B, 51, 51) 0/1 keep masks (keep 0.9) of each
        modality's layer-l attention weights."""
        user_item, mask = self.train_sequences(batch.users, generator)
        out = {"user_item": user_item, "mask": mask}
        shape = (user_item.shape[0], user_item.shape[1], user_item.shape[1])
        for pre in MODALITIES:
            for l in range(self.n_layers):
                out[f"keep_{pre}{l}"] = (torch.rand(shape, generator=generator,
                                                    device=user_item.device)
                                         < 1.0 - self.attn_dropout).float()
        return out

    # -- forward ----------------------------------------------------------
    def _lightgcn(self, params: Params):
        """(user_emb, item_emb, users_mean, items_mean): the mean of all
        L + 1 states and the prefix means of the first i + 2."""
        e_u, e_i = params["u_emb"], params["i_emb"]
        us, its = [e_u], [e_i]
        for _ in range(self.n_layers):
            e_u, e_i = self.graph.propagate(e_u, e_i)
            us.append(e_u)
            its.append(e_i)
        users_mean = [sum(us[:i + 2]) / (i + 2) for i in range(self.n_layers)]
        items_mean = [sum(its[:i + 2]) / (i + 2) for i in range(self.n_layers)]
        return sum(us) / len(us), sum(its) / len(its), users_mean, items_mean

    def _encoder(self, params: Params, pre: str, x_in: torch.Tensor, src: List[torch.Tensor],
                 mask: torch.Tensor, draws: Optional[Draws]) -> torch.Tensor:
        scale = float(self.dim_E) ** -0.5 / 100.0  # the /100 quirk
        out = x_in
        neg = torch.finfo(torch.float32).min
        keep = 1.0 - self.attn_dropout
        for l in range(self.n_layers):
            qk = out + src[l]
            q = qk @ params[f"{pre}_q_w{l}"].T + params[f"{pre}_q_b{l}"]
            k = qk @ params[f"{pre}_k_w{l}"].T + params[f"{pre}_k_b{l}"]
            v = out @ params[f"{pre}_v_w{l}"].T + params[f"{pre}_v_b{l}"]
            scores = torch.einsum("bqe,bke->bqk", q * scale, k)
            scores = torch.where(mask[:, None, :], neg, scores)
            attn = torch.softmax(scores, dim=-1)
            if draws is not None:
                attn = attn * draws[f"keep_{pre}{l}"] / keep
            a = torch.einsum("bqk,bke->bqe", attn, v)
            a = a @ params[f"{pre}_o_w{l}"].T + params[f"{pre}_o_b{l}"]
            mean = torch.mean(a, dim=-1, keepdim=True)
            var = torch.var(a, dim=-1, keepdim=True, unbiased=False)
            out = (a - mean) * torch.rsqrt(var + 1e-5)
            out = out * params[f"{pre}_ln_w{l}"] + params[f"{pre}_ln_b{l}"]
        return out

    def _forward(self, params: Params, users: torch.Tensor, user_item: torch.Tensor,
                 mask: torch.Tensor, draws: Optional[Draws] = None):
        """(user_emb, item_emb, v proj, t proj, v out, t out)
        (Model/LightGT.py:305-334)."""
        user_emb, item_emb, users_mean, items_mean = self._lightgcn(params)
        srcs = {pre: [] for pre in MODALITIES}
        for i in range(self.n_layers):
            temp = items_mean[i].detach()[user_item]
            temp = torch.cat([users_mean[i].detach()[users][:, None], temp[:, 1:]], 1)
            for pre in MODALITIES:
                srcs[pre].append(torch.sigmoid(temp @ params[f"{pre}_mlp_w"].T
                                               + params[f"{pre}_mlp_b"]))
        feats, outs = {}, {}
        for pre, feat in (("v", self.v_feat), ("t", self.t_feat)):
            proj = feat @ params[f"{pre}_lin_w"].T + params[f"{pre}_lin_b"]
            feats[pre] = proj
            x_in = torch.cat([params["user_exp"][users][:, None], proj[user_item][:, 1:]], 1)
            enc = self._encoder(params, pre, x_in, srcs[pre], mask, draws)[:, 0]
            outs[pre] = F.leaky_relu(enc @ params[f"{pre}_dense_w"].T
                                     + params[f"{pre}_dense_b"], 0.01)
        return user_emb, item_emb, feats["v"], feats["t"], outs["v"], outs["t"]

    # -- loss and scores ----------------------------------------------------
    def loss_with_draws(self, params: Params, batch: Batch, draws: Draws) -> torch.Tensor:
        bu, bp, bn = batch.users, batch.pos_items, batch.neg_items
        user_emb, item_emb, v, t, v_out, t_out = self._forward(
            params, bu, draws["user_item"], draws["mask"], draws)
        s1_pos = torch.sum(user_emb[bu] * item_emb[bp], 1)
        s1_neg = torch.sum(user_emb[bu] * item_emb[bn], 1)
        s2_pos = torch.sum(v_out * v[bp], 1) + torch.sum(t_out * t[bp], 1)
        s2_neg = torch.sum(v_out * v[bn], 1) + torch.sum(t_out * t[bn], 1)
        w1, w2 = self.score_weight1, 1.0 - self.score_weight1
        pos, neg = w1 * s1_pos + w2 * s2_pos, w1 * s1_neg + w2 * s2_neg
        # no epsilon inside the log here (Model/LightGT.py:357)
        loss = -masked_mean(torch.log(torch.sigmoid(pos - neg)), batch.weights)
        return loss + self.reg_weight * (torch.mean(user_emb ** 2) + torch.mean(item_emb ** 2))

    def loss(self, params: Params, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        return self.loss_with_draws(params, batch, self.draws(generator, batch))

    def score_users(self, params: Params, user_ids: torch.Tensor) -> torch.Tensor:
        """(n, I) scores of ``user_ids`` over the current evaluation subsets;
        the tower is computed afresh for each call, as in the JAX package."""
        user_emb, item_emb, v, t, v_out, t_out = self._forward(
            params, user_ids, self.eval_items[user_ids], self.eval_mask[user_ids])
        s1 = user_emb[user_ids] @ item_emb.T
        s2 = v_out @ v.T + t_out @ t.T
        return self.score_weight1 * s1 + (1.0 - self.score_weight1) * s2
