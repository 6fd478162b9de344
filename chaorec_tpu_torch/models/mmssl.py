"""MMSSL: adversarial multimodal self-supervised learning (WGAN-GP), and its
two-optimizer trainer.

Counterpart of ``chaorec_tpu/models/mmssl.py`` (reference: Model/MMSSL.py
and the alternating loop at train_and_evaluate.py:49-71):

- ``forward`` (Model/MMSSL.py:289-365): rows scaled by rowsum^-1/2
  (``row_half``: csr_norm(mean_flag=True) is D^-1/2 A, not a row mean) of
  the interactions propagate the projected modal features (dropout 0.2),
  and of the modal count matrices (the state) the id tables; the mm-layer
  loop is idempotent in the reference (it always reads the untouched
  features), so users take one ui hop and items iu after ui, whatever
  ``mm_layers`` is; the attention's value broadcast makes its softmax
  weights cancel, so it reduces to the 4-fold concat of each modal view
  through ``w_cat`` (``w_q``, ``w_k`` and ``w_v`` are never read); then the
  id tables + 0.36 * the normalized fusion, ``mm_layers`` propagations with
  a softmax on the last, the mean of the layer stack, + 0.55 * the
  normalized modal features of each side;
- the discriminator, Linear(I -> I/4 -> I/8 -> 1) with kaiming-normal
  weights and zero biases: its ``nn.LeakyReLU(True)`` has negative slope 1,
  the identity; batch statistics (biased variance, eps 1e-5) with a
  learnable affine; dropouts 0.31 and 0.5; 100 * sigmoid out
  (Model/MMSSL.py:21-45);
- ``loss_d`` (Model/MMSSL.py:490-527): fake rows are the masked,
  normalized modal user-item similarities of a forward without gradient,
  real rows the Gumbel-perturbed softmaxed interaction rows (the 1/tau binds
  to the noise term only, which enters as log(-log U)) plus 100 * the ui
  similarity, normalized; WGAN losses + 0.3 * a gradient penalty at
  interpolates, through a train-mode discriminator with its own dropout
  masks, differentiated twice (``torch.autograd.grad(create_graph=True)``);
- the generator loss (Model/MMSSL.py:529-624): BPR of log-sigmoid, a
  /1024 sum reg, the modal features' reg / num_item, ssl_alpha * the
  direct-form ``full_catalog_cl`` of the modal user ids against the fused
  users, G_rate * -mean(D(fake));
- the T=1 rebuild state machine (Model/MMSSL.py:552-585): batch 0 stores
  each user's int(num_item * 1e-4) top modal items, batch 1 rebuilds the
  count matrices from them, every later batch from an empty buffer. At
  ``k_top`` 0 (beauty, ``tiny_dataset``) every rebuild gives zero matrices.

Every random draw of a step is made by ``draws`` (dropout keep masks, the
Gumbel uniforms, the interpolation weights) and given to
``loss_d_with_draws`` and ``loss_stateful_with_draws``, so a test can give
the JAX package's.

``MMSSLTrainer``: each epoch makes a fresh Adam(3e-4, betas 0.5/0.9) over
the ``D_`` params and a fresh AdamW(lr, weight decay 0.01) over every param
(the reference re-creates its optimizers each epoch); each batch takes the
discriminator step on ``loss_d``, then the main step on the generator loss,
each after ``train/loop.grads_into`` (optax decays ``w_q``, ``w_k`` and
``w_v``, whose gradient is zero, where torch's AdamW would skip a param
without one), and logs the sum of the two losses. It keeps no weights of
its own, so the CLI exports nothing, as the JAX CLI does.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.adagcl import MultiOptimizerTrainer, prefixed
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.models.micro import full_catalog_cl
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_uniform
from chaorec_tpu_torch.ops.losses import l2norm, masked_mean

Draws = Dict[str, object]
State = Dict[str, torch.Tensor]
D_DROPOUT = (0.31, 0.5)  # the discriminator's two dropout rates


def row_half(m: torch.Tensor) -> torch.Tensor:
    """Rows scaled by (rowsum + 1e-8)^-1/2: csr_norm(mean_flag=True),
    Model/MMSSL.py:176-190."""
    return m * torch.rsqrt(m.sum(1, keepdim=True) + 1e-8)


def batchnorm(x: torch.Tensor) -> torch.Tensor:
    """Normalized by the batch's mean and biased variance, eps 1e-5."""
    mu = x.mean(0, keepdim=True)
    var = x.var(0, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5)


class MMSSL(RecModel):
    name = "MMSSL"
    stateful = True
    head_num = 4
    model_cat_rate = 0.55
    id_cat_rate = 0.36
    feat_reg_decay = 1e-5
    log_log_scale = 1e-5
    real_data_tau = 0.005
    ui_pre_scale = 100.0
    gp_rate = 1.0
    m_topk_rate = 1e-4
    drop_rate = 0.2

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph,
                 raw_ui: torch.Tensor, v_feat: torch.Tensor, t_feat: torch.Tensor, dim_E: int,
                 reg_weight: float, ssl_alpha: float, ssl_temp: float, g_rate: float,
                 mm_layers: int, batch_size: int = 1024):
        super().__init__(num_user, num_item)
        self.device = raw_ui.device
        self._batch_size = batch_size
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.cl_rate = ssl_alpha
        self.tau = ssl_temp
        self.G_rate = g_rate
        self.mm_layers = mm_layers
        self.n_ui_layers = mm_layers
        self.v_feat, self.t_feat = v_feat, t_feat  # frozen
        self.raw_ui = raw_ui  # (U, I) 0/1
        self.ui_graph = row_half(raw_ui)  # D_u^-1/2 A
        self.iu_graph = row_half(raw_ui.t())  # D_i^-1/2 A^T
        self.k_top = int(num_item * self.m_topk_rate)
        self.d_widths = (max(num_item // 4, 1), max(num_item // 8, 1))

    def init_params(self, generator: torch.Generator) -> Params:
        d = self.dim_E
        p = {"user_id_embedding": xavier_uniform(generator, (self.num_user, d)),
             "item_id_embedding": xavier_uniform(generator, (self.num_item, d)),
             "w_q": xavier_uniform(generator, (d, d)),
             "w_k": xavier_uniform(generator, (d, d)),
             "w_v": xavier_uniform(generator, (d, d)),
             "w_cat": xavier_uniform(generator, (self.head_num * d, d))}
        for m, feats in (("image", self.v_feat), ("text", self.t_feat)):
            p[f"{m}_trans_w"] = xavier_uniform(generator, (d, feats.shape[1]))
            p[f"{m}_trans_b"] = torch_linear_init(generator, d, feats.shape[1])[1]
        # the discriminator: kaiming-normal weights, zero biases
        # (weights_init, Model/MMSSL.py:171-175); the batch norms' affine
        # params start at 1 and 0 and train with both optimizers
        dev = generator.device
        widths = (self.num_item, *self.d_widths)
        for n, (fan_in, out) in enumerate(zip(widths, (*self.d_widths, 1)), start=1):
            p[f"D_w{n}"] = math.sqrt(2.0 / fan_in) * torch.randn(
                (out, fan_in), generator=generator, device=dev)
            p[f"D_b{n}"] = torch.zeros(out, device=dev)
            if n < 3:
                p[f"D_bn{n}_g"] = torch.ones(out, device=dev)
                p[f"D_bn{n}_b"] = torch.zeros(out, device=dev)
        return p

    def init_state(self, device: torch.device | str = "cpu",
                   generator: Optional[torch.Generator] = None) -> State:
        """The raw modal count matrices (the reference's image/text
        ui_graph_tmp before csr_norm; both views are taken from them in
        ``forward``) and the top-k buffer of the last accumulating batch."""
        k = max(self.k_top, 1)
        b = self._batch_size
        dev = self.device
        return {"image_cnt": self.raw_ui, "text_cnt": self.raw_ui,
                "buf_users": torch.zeros(b, dtype=torch.int64, device=dev),
                "buf_image": torch.zeros((b, k), dtype=torch.int64, device=dev),
                "buf_text": torch.zeros((b, k), dtype=torch.int64, device=dev),
                "buf_valid": torch.zeros((), device=dev)}

    def draws(self, generator: torch.Generator, batch: Batch) -> Draws:
        """A step's draws, ``loss_d``'s then the generator loss's: the
        forwards' feature keep masks (I, dim_E) at 0.8 ("d_keep_image",
        "d_keep_text", "g_keep_image", "g_keep_text"), the Gumbel uniforms
        (B, I), the interpolation weights (2B, 1), and a pair of keep masks
        (2B, I/4) at 0.69 and (2B, I/8) at 0.5 for each train-mode pass of the
        discriminator ("d_fake", "d_real", "d_gp", "g_d"), drawn in that
        order."""
        b = batch.users.shape[0]

        def uniform(*shape):
            return torch.rand(shape, generator=generator, device=self.device)

        def keep(p, *shape):
            return (uniform(*shape) < p).to(torch.float32)

        def feat_keep():
            return keep(1.0 - self.drop_rate, self.num_item, self.dim_E)

        def d_keep():
            return tuple(keep(1 - r, 2 * b, w) for r, w in zip(D_DROPOUT, self.d_widths))

        return {"d_keep_image": feat_keep(), "d_keep_text": feat_keep(),
                "gumbel_u": uniform(b, self.num_item), "alpha": uniform(2 * b, 1),
                "d_fake": d_keep(), "d_real": d_keep(), "d_gp": d_keep(),
                "g_keep_image": feat_keep(), "g_keep_text": feat_keep(), "g_d": d_keep()}

    # ---------------- the discriminator ----------------
    def discriminate(self, params: Params, x: torch.Tensor,
                     keep: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        """100 * D(x) (2B,); ``keep`` the two dropout keep masks (train
        mode) or None. Each block is Linear, batch norm with its affine,
        dropout: the LeakyReLU of slope 1 is the identity."""
        h = x
        for n in (1, 2):
            h = h @ params[f"D_w{n}"].t() + params[f"D_b{n}"]
            h = batchnorm(h) * params[f"D_bn{n}_g"] + params[f"D_bn{n}_b"]
            if keep is not None:
                h = h * keep[n - 1] / (1 - D_DROPOUT[n - 1])
        return 100.0 * torch.sigmoid(h @ params["D_w3"].t() + params["D_b3"])[:, 0]

    # ---------------- forward ----------------
    def forward(self, params: Params, state: State,
                keep: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """(u_g, i_g, img_item, txt_item, img_user, txt_user, img_uid,
        txt_uid); ``keep`` the feature dropout keep masks, or None."""
        image_feats = self.v_feat @ params["image_trans_w"].t() + params["image_trans_b"]
        text_feats = self.t_feat @ params["text_trans_w"].t() + params["text_trans_b"]
        if keep is not None:
            kp = 1.0 - self.drop_rate
            image_feats = image_feats * keep[0] / kp
            text_feats = text_feats * keep[1] / kp
        img_ui, txt_ui = row_half(state["image_cnt"]), row_half(state["text_cnt"])
        img_iu, txt_iu = row_half(state["image_cnt"].t()), row_half(state["text_cnt"].t())
        img_user = self.ui_graph @ image_feats
        img_item = self.iu_graph @ img_user
        img_uid = img_ui @ params["item_id_embedding"]
        txt_user = self.ui_graph @ text_feats
        txt_item = self.iu_graph @ txt_user
        txt_uid = txt_ui @ params["item_id_embedding"]
        img_iid = img_iu @ params["user_id_embedding"]
        txt_iid = txt_iu @ params["user_id_embedding"]

        def attention(e_img, e_txt):
            # Z = the head concat of each view through w_cat (the softmax
            # weights sum to 1 over the keys and cancel)
            z = torch.cat([torch.stack([e_img, e_txt], 0)] * self.head_num, -1)
            return z @ params["w_cat"]

        user_z = attention(img_uid, txt_uid).mean(0)
        item_z = attention(img_iid, txt_iid).mean(0)
        u_g = params["user_id_embedding"] + self.id_cat_rate * l2norm(user_z)
        i_g = params["item_id_embedding"] + self.id_cat_rate * l2norm(item_z)
        u_list, i_list = [u_g], [i_g]
        for layer in range(self.n_ui_layers):
            u_g = self.ui_graph @ i_g
            if layer == self.n_ui_layers - 1:
                u_g = torch.softmax(u_g, -1)
                i_g = torch.softmax(self.iu_graph @ u_g, -1)
            else:
                i_g = self.iu_graph @ u_g
            u_list.append(u_g)
            i_list.append(i_g)
        u_g = torch.stack(u_list).mean(0)
        i_g = torch.stack(i_list).mean(0)
        u_g = u_g + self.model_cat_rate * (l2norm(img_user) + l2norm(txt_user))
        i_g = i_g + self.model_cat_rate * (l2norm(img_item) + l2norm(txt_item))
        return u_g, i_g, img_item, txt_item, img_user, txt_user, img_uid, txt_uid

    def _u_sim(self, users: torch.Tensor, user_final: torch.Tensor,
               item_final: torch.Tensor) -> torch.Tensor:
        """The batch users' normalized scores over the unseen items."""
        sim = (user_final[users] @ item_final.t()) * (1.0 - self.raw_ui[users])
        return l2norm(sim)

    # ---------------- losses ----------------
    def loss_d_with_draws(self, params: Params, state: State, batch: Batch,
                          draws: Draws) -> torch.Tensor:
        """The discriminator's WGAN-GP loss under ``draws``; it reaches the
        ``D_`` params only."""
        users = batch.users
        with torch.no_grad():
            u_g, i_g, img_item, txt_item, img_user, txt_user, _, _ = self.forward(
                params, state, (draws["d_keep_image"], draws["d_keep_text"]))
            ui_sim = self._u_sim(users, u_g, i_g)
            inputf = torch.cat([self._u_sim(users, img_user, img_item),
                                self._u_sim(users, txt_user, txt_item)], 0)
            gum = torch.log(-torch.log(draws["gumbel_u"] + 1e-8) + 1e-8)
            u_real = torch.softmax(
                self.raw_ui[users] - self.log_log_scale * gum / self.real_data_tau, 1)
            u_real = l2norm(u_real + ui_sim * self.ui_pre_scale)
            inputr = torch.cat([u_real, u_real], 0)
            alpha = draws["alpha"]
            interp = alpha * inputr + (1 - alpha) * inputf
        lossf = torch.mean(self.discriminate(params, inputf, draws["d_fake"]))
        lossr = -torch.mean(self.discriminate(params, inputr, draws["d_real"]))
        # the penalty's D(interpolates) is a fresh train-mode pass
        # (Model/MMSSL.py:205-210), differentiated in its input and then again
        interp.requires_grad_()
        d_sum = torch.sum(self.discriminate(params, interp, draws["d_gp"]))
        (grads,) = torch.autograd.grad(d_sum, interp, create_graph=True)
        gp = 0.3 * torch.mean((torch.sqrt(torch.sum(grads ** 2, 1) + 1e-12) - 1) ** 2)
        return lossr + lossf + self.gp_rate * gp

    def loss_d(self, params: Params, state: State, batch: Batch,
               generator: torch.Generator) -> torch.Tensor:
        return self.loss_d_with_draws(params, state, batch, self.draws(generator, batch))

    def loss_stateful_with_draws(self, params: Params, state: State, batch: Batch,
                                 draws: Draws) -> Tuple[torch.Tensor, State]:
        """(the generator loss under ``draws``, the next state)."""
        u_g, i_g, img_item, txt_item, img_user, txt_user, img_uid, txt_uid = self.forward(
            params, state, (draws["g_keep_image"], draws["g_keep_text"]))
        bu, w = batch.users, batch.weights
        u, pos, neg = u_g[bu], i_g[batch.pos_items], i_g[batch.neg_items]
        mf = -masked_mean(torch.nn.functional.logsigmoid(
            torch.sum(u * pos, 1) - torch.sum(u * neg, 1)), w)
        wc = w[:, None]
        emb = self.reg_weight * 0.5 * (torch.sum(u ** 2 * wc) + torch.sum(pos ** 2 * wc)
                                       + torch.sum(neg ** 2 * wc)) / 1024.0
        feat_reg = self.feat_reg_decay * 0.5 * (
            torch.sum(img_item ** 2) + torch.sum(txt_item ** 2)
            + torch.sum(img_user ** 2) + torch.sum(txt_user ** 2)) / self.num_item
        img_sim = self._u_sim(bu, img_user, img_item)
        txt_sim = self._u_sim(bu, txt_user, txt_item)
        cl = (full_catalog_cl(img_uid[bu], u_g[bu], self.tau)
              + full_catalog_cl(txt_uid[bu], u_g[bu], self.tau))
        g_lossf = -torch.mean(self.discriminate(params, torch.cat([img_sim, txt_sim], 0),
                                                draws["g_d"]))
        loss = mf + emb + feat_reg + self.cl_rate * cl + self.G_rate * g_lossf
        return loss, self._next_state(state, batch, img_sim.detach(), txt_sim.detach())

    def _next_state(self, state: State, batch: Batch, img_sim: torch.Tensor,
                    txt_sim: torch.Tensor) -> State:
        """The T=1 state machine: batch 0 stores its users' top modal items;
        a later batch rebuilds the count matrices from the buffer (ones at
        each stored (user, item), duplicates adding; nothing where the
        buffer was used already or ``k_top`` is 0) and marks it used."""
        k = max(self.k_top, 1)
        if batch.index == 0:
            return {"image_cnt": state["image_cnt"], "text_cnt": state["text_cnt"],
                    "buf_users": batch.users, "buf_image": torch.topk(img_sim, k, 1).indices,
                    "buf_text": torch.topk(txt_sim, k, 1).indices,
                    "buf_valid": torch.ones((), device=self.device)}
        contrib = (state["buf_valid"] > 0).to(torch.float32) * float(self.k_top > 0)
        users = state["buf_users"][:, None].expand_as(state["buf_image"])

        def rebuilt(like: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
            return torch.zeros_like(like).index_put_(
                (users, items), contrib.expand(items.shape), accumulate=True)

        return {"image_cnt": rebuilt(state["image_cnt"], state["buf_image"]),
                "text_cnt": rebuilt(state["text_cnt"], state["buf_text"]),
                "buf_users": state["buf_users"], "buf_image": state["buf_image"],
                "buf_text": state["buf_text"],
                "buf_valid": torch.zeros((), device=self.device)}

    def loss_stateful(self, params: Params, state: State, batch: Batch,
                      generator: torch.Generator) -> Tuple[torch.Tensor, State]:
        d = self.draws(generator, batch)
        return self.loss_stateful_with_draws(params, state, batch, d)

    def embeddings_stateful(self, params: Params, state: State):
        u_g, i_g, *_ = self.forward(params, state)
        return u_g, i_g


def mmssl_step(model: MMSSL, opts: Tuple, params: Params, state: State, batch: Batch,
               draws: Draws, on_step: Optional[Callable[[str], None]] = None
               ) -> Tuple[torch.Tensor, State]:
    """One MMSSL batch (train_and_evaluate.py:49-71): the discriminator's
    Adam steps the ``D_`` params on ``loss_d``, then the main AdamW steps
    every param on the generator loss. ``opts`` is (the AdamW, the
    discriminator's Adam). Updates ``params`` in place; returns (loss_d +
    the generator loss, detached; the next state). ``on_step(label)`` is
    called after each optimizer step ("d", "main")."""
    from chaorec_tpu_torch.train.loop import grads_into, opt_params

    opt_main, opt_d = opts
    loss_d = model.loss_d_with_draws(params, state, batch, draws)
    grads_into(loss_d, opt_params(opt_d))
    opt_d.step()
    if on_step is not None:
        on_step("d")
    loss, new_state = model.loss_stateful_with_draws(params, state, batch, draws)
    grads_into(loss, opt_params(opt_main))
    opt_main.step()
    if on_step is not None:
        on_step("main")
    return (loss_d + loss).detach(), new_state


class MMSSLTrainer(MultiOptimizerTrainer):
    """The alternating discriminator / generator loop, its two optimizers
    made anew every epoch."""

    D_LR, D_BETAS = 3e-4, (0.5, 0.9)
    WEIGHT_DECAY = 0.01

    def generator_adams(self, params: Params, lr: float) -> Tuple:
        """The discriminator's Adam over the ``D_`` params."""
        return (torch.optim.Adam(prefixed(params, "D_"), lr=self.D_LR, betas=self.D_BETAS,
                                 eps=1e-8),)

    def make_optimizer(self, params: Params) -> torch.optim.AdamW:
        """The main AdamW over every param (optax.adamw's defaults); makes
        the discriminator's Adam anew."""
        from chaorec_tpu_torch.train.loop import ADAM_BETAS, ADAM_EPS

        lr = float(self.cfg.learning_rate)
        self.gen_opts = self.generator_adams(params, lr)
        return torch.optim.AdamW(list(params.values()), lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS,
                                 weight_decay=self.WEIGHT_DECAY)

    def train_step(self, params: Params, optimizer: torch.optim.Optimizer,
                   batch: Batch) -> torch.Tensor:
        """One batch (with its negatives): the model's draws, then
        ``mmssl_step``, carrying the model state."""
        from chaorec_tpu_torch.train.loop import deterministic_mode

        base = self._base
        with deterministic_mode():
            draws = self.model.draws(base.generator, batch)
            loss, base.model_state = mmssl_step(self.model, (optimizer, *self.gen_opts), params,
                                                base.model_state, batch, draws,
                                                on_step=lambda _: base.refresh())
            return loss

    def train_epoch(self, params: Params, optimizer: torch.optim.Optimizer) -> float:
        """An epoch with optimizers made anew at its start (the one passed
        in is the run's, made before the first epoch)."""
        return super().train_epoch(params, self.make_optimizer(self._base.trainable(params)))


MMSSL.trainer_cls = MMSSLTrainer
