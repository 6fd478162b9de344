"""DiffMM: multimodal diffusion-rebuilt graphs with a modal-fused GCN, and
the three-phase family trainer it shares with MHRec.

Counterpart of ``chaorec_tpu/models/diffmm.py`` (reference:
Model/DiffMM.py and train_and_evaluate.py:140-244):

- two DiffRec-style denoisers (image, text) over dense user rows, hidden
  "[1000]", time embedding 10, dropout 0.5 in training (``dnn_init``,
  ``dnn_forward``; MHRec's share them). Their loss is the SNR-weighted x0
  MSE with uniform timesteps plus ``e_loss`` times the MSE between
  ``x0_hat @ feats`` and ``x_start @ i_emb``, both of those detached;
- each epoch's rebuild: a deterministic reverse process (no start noise)
  per modality at ``sample_dtype`` (bf16 products summed in float32 by
  default), each user's top ``rebuild_k`` items ordered by (-score, item),
  then the binarized (U+I)^2 block with the identity, D^-1/2 A D^-1/2
  normalized (user degree k+1, item degree its pick count + 1), every
  entry kept with probability 0.5 and scaled by 2 (``build_modal_adj``):
  the u->i, i->u and both self-loop weights each with their own mask;
- the BPR loss (Model/DiffMM.py:203-353): per modality, the two-hop
  feature propagation over the U-I graph plus 0.2 times one hop over the
  rebuilt modal graph (``modal_prop``), a softmax-weighted modal mix,
  ``n_layers`` GCN layers summed with their input, + ``ris_lambda`` times
  the normalized mix; BPR (+1e-5) + the mean-of-squares reg + ``ssl_alpha``
  times two full-catalog contrasts between the image and the text views
  (``ops/losses.catalog_logsumexp``: the streaming logsumexp kernels on the
  card);
- the schedule: 5 steps, noise 0.1 x [1e-4, 0.02], beta[0] 1e-4.

The denoisers' params are named ``img_dn.<name>`` and ``txt_dn.<name>`` in
the flat params dict (the JAX package nests them). The rebuilt graph pair
is the model state; evaluation ranks ``_forward`` over it.

Every draw enters through a ``*_with_draws`` entry: phase A's timesteps,
noise and dropout keep masks (``diffusion_draws``), phase B's four edge keep
masks a modality (``rebuild_draws``).

``DiffusionFamilyTrainer`` runs the three-phase epoch on the standard
trainer underneath (its shuffles, negatives, evaluation, early stopping
and logs): (A) each denoiser epoch with a fresh Adam(lr) over its
denoisers only, (B) the rebuild without gradient, (C) the standard
trainer's BPR epoch with the persistent main Adam. The main Adam leaves
the denoisers out: the JAX trainer's steps them, but their phase-C
gradient is exactly zero, so are their moments and so is the update. The
trainer keeps no weights of its own, so the CLI exports nothing, as the
JAX CLI does.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from chaorec_tpu_torch.graphs.knn import gather_weighted_sum
from chaorec_tpu_torch.graphs.norm_adj import BipartiteGraph
from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops import diffusion as diff
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_uniform
from chaorec_tpu_torch.ops.losses import bpr_loss, catalog_logsumexp, emb_l2_reg, l2norm, \
    masked_mean
from chaorec_tpu_torch.ops.mxu import bdot

Draws = Dict[str, torch.Tensor]
DENOISERS = ("img_dn", "txt_dn")


class ModalAdj(NamedTuple):
    """A rebuilt modal graph in fixed shape: each user's top-k items
    ``topk`` (U, K), the u->i and i->u edge weights ``v_ui`` and ``v_iu``
    (U, K), the self-loop weights ``self_u`` (U,) and ``self_i`` (I,), each
    normalized and dropped with its own mask."""

    topk: torch.Tensor
    v_ui: torch.Tensor
    v_iu: torch.Tensor
    self_u: torch.Tensor
    self_i: torch.Tensor


def modal_prop(adj: ModalAdj, xu: torch.Tensor, xi: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One hop of the modal graph over [xu; xi], as its user and item parts."""
    new_u = gather_weighted_sum(xi, adj.v_ui, adj.topk) + adj.self_u[:, None] * xu
    contrib = (adj.v_iu[:, :, None] * xu[:, None, :]).reshape(-1, xu.shape[-1])
    new_i = torch.zeros_like(xi).index_add(0, adj.topk.reshape(-1), contrib)
    return new_u, new_i + adj.self_i[:, None] * xi


def build_modal_adj(topk: torch.Tensor, num_item: int, keep_rate: float,
                    keeps: Tuple[torch.Tensor, ...]) -> ModalAdj:
    """buildUIMatrix (Model/DiffMM.py:166-180) and SpAdjDropEdge (:26-40):
    ``keeps`` the 0/1 keep masks of v_ui, v_iu (U, K), self_u (U,) and
    self_i (I,)."""
    num_user, k = topk.shape
    cnt = torch.zeros(num_item, device=topk.device).index_add_(
        0, topk.reshape(-1), torch.ones(topk.numel(), device=topk.device))
    deg_u = float(k + 1)
    deg_i = cnt + 1.0
    val = (1.0 / math.sqrt(deg_u)) * torch.rsqrt(deg_i)[topk]
    scale = 1.0 / keep_rate
    k_ui, k_iu, k_su, k_si = keeps
    return ModalAdj(topk=topk, v_ui=val * k_ui * scale, v_iu=val * k_iu * scale,
                    self_u=torch.full((num_user,), 1.0 / deg_u, device=topk.device) * k_su * scale,
                    self_i=(1.0 / deg_i) * k_si * scale)


def topk_by_value_then_index(scores: torch.Tensor, k: int) -> torch.Tensor:
    """(N, k) column indices of each row's k largest scores, ties to the
    lower index, as ``jax.lax.top_k`` orders them (``torch.topk`` gives no
    such order). A copy: a view would keep the whole (N, M) sort alive."""
    return torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k].contiguous()


def dnn_init(generator: torch.Generator, prefix: str, num_out: int, hidden: Tuple[int, ...],
             emb_size: int) -> Params:
    """A denoiser's params as ``{prefix}.<name>`` (Model/DiffMM.py:377-435):
    weights N(0, xavier std), biases N(0, 0.001); DiffRec's structure."""
    out_dims = list(hidden) + [num_out]
    in_dims = out_dims[::-1]
    in_dims = [in_dims[0] + emb_size] + in_dims[1:]
    dev = generator.device

    def lin(d_out, d_in):
        std = math.sqrt(2.0 / (d_in + d_out))
        return (std * torch.randn((d_out, d_in), generator=generator, device=dev),
                0.001 * torch.randn((d_out,), generator=generator, device=dev))

    p = {}
    p[f"{prefix}.emb_w"], p[f"{prefix}.emb_b"] = lin(emb_size, emb_size)
    for i, (d_in, d_out) in enumerate(zip(in_dims[:-1], in_dims[1:])):
        p[f"{prefix}.in_w{i}"], p[f"{prefix}.in_b{i}"] = lin(d_out, d_in)
    for i, (d_in, d_out) in enumerate(zip(out_dims[:-1], out_dims[1:])):
        p[f"{prefix}.out_w{i}"], p[f"{prefix}.out_b{i}"] = lin(d_out, d_in)
    return p


def dnn_forward(params: Params, prefix: str, x: torch.Tensor, ts: torch.Tensor,
                emb_size: int, n_layers: int, keep: Optional[torch.Tensor] = None,
                dropout: float = 0.5, compute_dtype: Optional[torch.dtype] = None
                ) -> torch.Tensor:
    """The tanh MLP over [x, time embedding] (Model/DiffMM.py:437-473); x
    times ``keep`` / (1 - dropout) in training. ``compute_dtype``
    (bfloat16) runs the wide products on bf16 operands with float32 sums,
    for the sampling paths without gradient; None keeps float32."""
    def mm(h, w):
        if compute_dtype is None:
            return h @ w.t()
        return bdot(h.to(compute_dtype), w.to(compute_dtype).t())

    emb = diff.timestep_embedding(ts, emb_size)
    emb = emb @ params[f"{prefix}.emb_w"].t() + params[f"{prefix}.emb_b"]
    if keep is not None:
        x = x * keep / (1.0 - dropout)
    h = torch.cat([x, emb], dim=-1)
    for i in range(n_layers):
        h = torch.tanh(mm(h, params[f"{prefix}.in_w{i}"]) + params[f"{prefix}.in_b{i}"])
    for i in range(n_layers):
        h = mm(h, params[f"{prefix}.out_w{i}"]) + params[f"{prefix}.out_b{i}"]
        if i != n_layers - 1:
            h = torch.tanh(h)
    return h


def denoise_draws(generator: torch.Generator, b: int, width: int, steps: int,
                  dropout: float) -> Tuple[torch.Tensor, ...]:
    """(ts (b,) uniform over the steps, noise (b, width), keep mask (b,
    width)) of one denoiser's loss, drawn in that order."""
    dev = generator.device
    ts = torch.randint(0, steps, (b,), generator=generator, device=dev)
    noise = torch.randn((b, width), generator=generator, device=dev)
    keep = (torch.rand((b, width), generator=generator, device=dev) < 1.0 - dropout).float()
    return ts, noise, keep


class DiffMM(RecModel):
    name = "DiffMM"
    stateful = True
    ris_adj_lambda = 0.2  # Model/DiffMM.py:57
    keep_rate = 0.5  # Model/DiffMM.py:85
    emb_size = 10  # d_emb_size, Model/DiffMM.py:110
    dnn_dropout = 0.5

    def __init__(self, num_user: int, num_item: int, graph: BipartiteGraph,
                 dense_interactions: torch.Tensor, v_feat: torch.Tensor, t_feat: torch.Tensor,
                 dim_E: int, reg_weight: float, n_layers: int, ssl_alpha: float, ssl_temp: float,
                 ris_lambda: float, e_loss: float, rebuild_k: int, hidden_dims=(1000,),
                 sample_compute_dtype: str = "bfloat16"):
        super().__init__(num_user, num_item)
        self.device = dense_interactions.device
        # the rebuild's sampling precision (no gradient, only the top-k
        # order survives); training stays float32
        self.sample_dtype = torch.bfloat16 if sample_compute_dtype == "bfloat16" else None
        self.graph = graph
        self.x = dense_interactions
        self.v_feat, self.t_feat = v_feat, t_feat
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.n_layers = n_layers
        self.ssl_alpha = ssl_alpha
        self.ssl_temp = ssl_temp
        self.ris_lambda = ris_lambda
        self.e_loss = e_loss
        self.rebuild_k = min(int(rebuild_k), num_item)
        self.hidden_dims = tuple(hidden_dims)
        self.sched = diff.make_schedule(0.1, 0.0001, 0.02, 5, beta_fixed_value=1e-4,
                                        device=self.device)

    def init_params(self, generator: torch.Generator) -> Params:
        e = self.dim_E
        dev = generator.device
        p = {"u_emb": xavier_uniform(generator, (self.num_user, e)),
             "i_emb": xavier_uniform(generator, (self.num_item, e))}
        # the trans Linears: weights re-drawn xavier, biases torch's default
        # (Model/DiffMM.py:89-93)
        for m, feats in (("img", self.v_feat), ("txt", self.t_feat)):
            p[f"{m}_w"] = xavier_uniform(generator, (e, feats.shape[1]))
            p[f"{m}_b"] = torch_linear_init(generator, e, feats.shape[1])[1]
        p["modal_weight"] = torch.tensor([0.5, 0.5], device=dev)
        for prefix in DENOISERS:
            p.update(dnn_init(generator, prefix, self.num_item, self.hidden_dims, self.emb_size))
        return p

    def init_state(self, device: torch.device | str = "cpu",
                   generator: Optional[torch.Generator] = None) -> Tuple[ModalAdj, ModalAdj]:
        """Placeholder graphs: phases A and B rebuild them before any use."""
        dev = self.device
        z_top = torch.zeros((self.num_user, self.rebuild_k), dtype=torch.int64, device=dev)
        z_uk = torch.zeros((self.num_user, self.rebuild_k), device=dev)
        empty = ModalAdj(z_top, z_uk, z_uk, torch.zeros(self.num_user, device=dev),
                         torch.zeros(self.num_item, device=dev))
        return empty, empty

    # ---------------- the BPR phase ----------------
    def _feats(self, params: Params) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self.v_feat @ params["img_w"].t() + params["img_b"],
                self.t_feat @ params["txt_w"].t() + params["txt_b"])

    def _gcn_sum(self, eu: torch.Tensor, ei: torch.Tensor):
        su, si = eu, ei
        for _ in range(self.n_layers):
            eu, ei = self.graph.propagate(eu, ei)
            su, si = su + eu, si + ei
        return su, si

    def _forward(self, params: Params, state):
        """forward_MM (Model/DiffMM.py:205-262)."""
        adj_img, adj_txt = state
        xu, xi = params["u_emb"], params["i_emb"]
        img_f, txt_f = self._feats(params)
        w = torch.softmax(params["modal_weight"], 0)

        def modal_branch(adj, feats):
            a_u, a_i = modal_prop(adj, xu, xi)  # the modal graph's hop on the id tables
            b_u, b_i = self.graph.propagate(xu, l2norm(feats))  # eq20 hop 1
            c_u, c_i = self.graph.propagate(b_u, xi)  # eq20 hop 2
            return (b_u + c_u + self.ris_adj_lambda * a_u,
                    b_i + c_i + self.ris_adj_lambda * a_i)

        img_u, img_i = modal_branch(adj_img, img_f)
        txt_u, txt_i = modal_branch(adj_txt, txt_f)
        mod_u = w[0] * img_u + w[1] * txt_u
        mod_i = w[0] * img_i + w[1] * txt_i
        su, si = self._gcn_sum(mod_u, mod_i)
        return su + self.ris_lambda * l2norm(mod_u), si + self.ris_lambda * l2norm(mod_i)

    def _forward_cl(self, params: Params, state):
        """forward_cl_MM (Model/DiffMM.py:264-300): the modal graph's hop on
        [u_emb; normalize(feats)], then the shared GCN stack."""
        adj_img, adj_txt = state
        xu = params["u_emb"]
        img_f, txt_f = self._feats(params)
        i_u, i_i = modal_prop(adj_img, xu, l2norm(img_f))
        t_u, t_i = modal_prop(adj_txt, xu, l2norm(txt_f))
        u1, i1 = self._gcn_sum(i_u, i_i)
        u2, i2 = self._gcn_sum(t_u, t_i)
        return u1, i1, u2, i2

    @staticmethod
    def _contrast(e1: torch.Tensor, e2: torch.Tensor, nodes: torch.Tensor, temp: float,
                  weights: torch.Tensor) -> torch.Tensor:
        """contrastLoss (Model/DiffMM.py:354-362): the full-catalog
        denominator through ``catalog_logsumexp``."""
        n1, n2 = l2norm(e1), l2norm(e2)
        p1, p2 = n1[nodes], n2[nodes]
        nume = torch.sum(p1 * p2, dim=-1) / temp
        return -masked_mean(nume - catalog_logsumexp(p1, n2, temp), weights)

    def loss_bpr(self, params: Params, state, batch: Batch) -> torch.Tensor:
        """Phase C's loss (Model/DiffMM.py:329-353, cl_method 0)."""
        u_g, i_g = self._forward(params, state)
        ue, pe, ne = u_g[batch.users], i_g[batch.pos_items], i_g[batch.neg_items]
        w = batch.weights
        l_bpr = bpr_loss(torch.sum(ue * pe, 1), torch.sum(ue * ne, 1), w)
        reg = emb_l2_reg(self.reg_weight, [ue, pe, ne], w)
        u1, i1, u2, i2 = self._forward_cl(params, state)
        cl = (self._contrast(u1, u2, batch.users, self.ssl_temp, w)
              + self._contrast(i1, i2, batch.pos_items, self.ssl_temp, w)) * self.ssl_alpha
        return l_bpr + reg + cl

    def loss_stateful(self, params: Params, state, batch: Batch,
                      generator: Optional[torch.Generator] = None):
        return self.loss_bpr(params, state, batch), state

    def embeddings_stateful(self, params: Params, state):
        return self._forward(params, state)

    # ---------------- phase A: the denoisers ----------------
    def _dnn(self, params: Params, prefix: str, x: torch.Tensor, ts: torch.Tensor,
             keep: Optional[torch.Tensor] = None, compute_dtype=None) -> torch.Tensor:
        return dnn_forward(params, prefix, x, ts, self.emb_size, len(self.hidden_dims), keep,
                           self.dnn_dropout, compute_dtype)

    def diffusion_draws(self, generator: torch.Generator, b: int) -> Draws:
        """Phase A's draws for a batch of ``b`` users: each modality's
        timesteps, noise (b, I) and keep mask (b, I), the image's first."""
        out = {}
        for m in ("img", "txt"):
            out[f"{m}_ts"], out[f"{m}_noise"], out[f"{m}_keep"] = denoise_draws(
                generator, b, self.num_item, self.sched.steps, self.dnn_dropout)
        return out

    def diffusion_loss_with_draws(self, params: Params, users: torch.Tensor,
                                  weights: torch.Tensor, draws: Draws) -> torch.Tensor:
        """Phase A's joint image and text denoiser loss
        (train_and_evaluate.py:148-176); i_emb and the projected features
        are detached (Model/DiffMM.py:652-658): the loss reaches the
        denoisers only."""
        rows = self.x[users]
        with torch.no_grad():
            img_f, txt_f = self._feats(params)
            usr_id = rows @ params["i_emb"]
        total = 0.0
        for m, feats in (("img", img_f), ("txt", txt_f)):
            ts, noise = draws[f"{m}_ts"], draws[f"{m}_noise"]
            x_t = diff.q_sample(self.sched, rows, ts, noise)
            out = self._dnn(params, f"{m}_dn", x_t, ts, draws[f"{m}_keep"])
            mse = torch.mean((rows - out) ** 2, dim=1)
            diff_l = masked_mean(diff.snr_weight(self.sched, ts) * mse, weights)
            gc = masked_mean(torch.mean((out @ feats - usr_id) ** 2, dim=1), weights)
            total = total + (diff_l + gc * self.e_loss)
        return total

    # ---------------- phase B: the rebuild ----------------
    def rebuild_draws(self, generator: torch.Generator) -> Draws:
        """Phase B's keep masks: per modality (image first) v_ui, v_iu (U,
        K), self_u (U,) and self_i (I,), each entry kept with probability
        ``keep_rate``."""
        dev = generator.device
        shapes = ((self.num_user, self.rebuild_k), (self.num_user, self.rebuild_k),
                  (self.num_user,), (self.num_item,))
        return {f"{m}_keep{j}": (torch.rand(s, generator=generator, device=dev)
                                 < self.keep_rate).float()
                for m in ("img", "txt") for j, s in enumerate(shapes)}

    @torch.no_grad()
    def rebuild_topk(self, params: Params, prefix: str) -> torch.Tensor:
        """(U, rebuild_k): each user's top items of the deterministic reverse
        process over its row at ``sample_dtype``."""
        scores = diff.p_sample(
            self.sched,
            lambda x_t, ts: self._dnn(params, prefix, x_t, ts, compute_dtype=self.sample_dtype),
            self.x)
        return topk_by_value_then_index(scores, self.rebuild_k)

    @torch.no_grad()
    def rebuild_graphs_with_draws(self, params: Params, draws: Draws
                                  ) -> Tuple[ModalAdj, ModalAdj]:
        """Phase B (train_and_evaluate.py:183-240): the top-k picks of each
        modality, normalized and dropped."""
        return tuple(build_modal_adj(self.rebuild_topk(params, f"{m}_dn"), self.num_item,
                                     self.keep_rate, tuple(draws[f"{m}_keep{i}"] for i in range(4)))
                     for m in ("img", "txt"))

    def rebuild_graphs(self, params: Params, generator: torch.Generator):
        return self.rebuild_graphs_with_draws(params, self.rebuild_draws(generator))


def denoiser_names(params: Params, prefixes) -> List[str]:
    """The names of the params of the denoisers ``prefixes``, in the dict's order."""
    return [k for k in params if k.split(".")[0] in prefixes]


class DiffusionFamilyTrainer:
    """The three-phase epoch of DiffMM and MHRec on the standard ``Trainer``
    underneath, which draws the shuffles and negatives, runs phase C's BPR
    epoch (``Trainer.train_epoch``), evaluates, stops early and logs. The
    model's denoisers (``DENOISERS``) train in phase A only, each time with
    fresh Adams (``denoise_epoch``); the main Adam steps every other param.
    It keeps no weights of its own, so the CLI exports nothing."""

    def __init__(self, model: RecModel, dataset, cfg):
        from chaorec_tpu_torch.train.loop import Trainer

        self._base = base = Trainer(model, dataset, cfg)
        self.model = model
        self.cfg = cfg
        base.make_optimizer = self.make_optimizer
        base.train_epoch = self.train_epoch

    def make_optimizer(self, params: Params) -> torch.optim.Adam:
        """The main Adam over every param outside the denoisers."""
        from chaorec_tpu_torch.train.loop import ADAM_BETAS, ADAM_EPS

        dn = set(denoiser_names(params, DENOISERS))
        return torch.optim.Adam([v for k, v in params.items() if k not in dn],
                                lr=float(self.cfg.learning_rate), betas=ADAM_BETAS, eps=ADAM_EPS)

    def denoiser_adam(self, params: Params, prefixes) -> torch.optim.Adam:
        """A fresh Adam(lr) over the denoisers ``prefixes`` (the reference
        re-creates its denoise optimizers each epoch)."""
        from chaorec_tpu_torch.train.loop import ADAM_BETAS, ADAM_EPS

        return torch.optim.Adam([params[k] for k in denoiser_names(params, prefixes)],
                                lr=float(self.cfg.learning_rate), betas=ADAM_BETAS, eps=ADAM_EPS)

    @staticmethod
    def denoise_step(opt: torch.optim.Adam, loss: torch.Tensor) -> torch.Tensor:
        """One step of a denoiser Adam on ``loss``: every param of ``opt``
        gets its gradient (zeros where the loss does not reach it)."""
        from chaorec_tpu_torch.train.loop import grads_into, opt_params

        grads_into(loss, opt_params(opt))
        opt.step()
        return loss.detach()

    def denoise_epoch(self, params: Params, prefixes, n_rows: int, loss_fn) -> torch.Tensor:
        """Phase A over ``n_rows`` shuffled rows in batches (the last one
        padded with weight-0 rows) with a fresh Adam over ``prefixes``:
        ``loss_fn(batch)`` is a batch's loss. Returns the batches' losses."""
        from chaorec_tpu_torch.data.sampling import make_epoch_batches

        base = self._base
        opt = self.denoiser_adam(base.trainable(params), prefixes)
        losses = []
        for batch in make_epoch_batches(base.generator, n_rows, int(self.cfg.batch_size)):
            losses.append(self.denoise_step(opt, loss_fn(batch)))
            base.refresh()  # on a mesh, the view gathered anew
        return torch.stack(losses)

    @staticmethod
    def log_denoise_losses(losses: torch.Tensor, total: int) -> None:
        for i, dl in enumerate(losses.cpu().numpy()):
            logging.info("Diffusion Step %d/%d; Diffusion Loss %.6f" % (i, total, dl))

    def bpr_epoch(self, params: Params, optimizer: torch.optim.Optimizer) -> float:
        """Phase C: the standard trainer's epoch of BPR steps on the state."""
        from chaorec_tpu_torch.train.loop import Trainer

        return Trainer.train_epoch(self._base, params, optimizer)

    def train_epoch(self, params: Params, optimizer: torch.optim.Optimizer) -> float:
        raise NotImplementedError

    def run(self):
        return self._base.run()


class DiffMMTrainer(DiffusionFamilyTrainer):
    """DiffMM's epoch (train_and_evaluate.py:140-244): both denoisers over
    the shuffled user rows with one fresh Adam, the UI matrices rebuilt,
    then the BPR epoch on them."""

    def train_epoch(self, params: Params, optimizer: torch.optim.Optimizer) -> float:
        from chaorec_tpu_torch.train.loop import deterministic_mode

        base, model = self._base, self.model
        with deterministic_mode():
            losses = self.denoise_epoch(
                params, DENOISERS, model.num_user,
                lambda b: model.diffusion_loss_with_draws(
                    params, b.users, b.weights,
                    model.diffusion_draws(base.generator, b.users.shape[0])))
            self.log_denoise_losses(losses, model.num_user // int(self.cfg.batch_size))
            logging.info("")
            logging.info("Start to re-build UI matrix")
            base.model_state = model.rebuild_graphs(params, base.generator)
            logging.info("UI matrix built!")
            return self.bpr_epoch(params, optimizer)


DiffMM.trainer_cls = DiffMMTrainer
