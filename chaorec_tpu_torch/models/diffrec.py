"""DiffRec: a Gaussian diffusion recommender over dense interaction rows.

Counterpart of ``chaorec_tpu/models/diffrec.py`` (reference:
Model/DiffRec.py and train_and_evaluate.py:304-315, 578-613):

- the denoiser: a sinusoidal time embedding (size 10) through a Linear,
  concatenated with the row (dropout keep 0.5 in training), then an MLP
  [I + 10 -> 1000 -> I] with tanh between the layers (``dims`` "[1000]");
  weights N(0, xavier std), biases N(0, 0.001) (Model/DiffRec.py:16-115);
- the x0-predicting diffusion of ``ops/diffusion.py``: importance-sampled
  timesteps from the per-step loss history (the model's state), SNR
  weights, /pt;
- trained on shuffled user rows (the "user_rows" branch) by Adam: the
  reference's AdamW at weight decay 0;
- scores: the deterministic reverse process over the user's row, its
  products in ``sample_compute_dtype`` (bf16 products summed in float32
  by default, ``graph_compute_dtype``; the loss stays float32); seen items
  are masked with -inf (train_and_evaluate.py:598-608), in the trainer's
  ranking and in the export alike.

``draws`` makes the step's timesteps, their importance weights, the noise
and the dropout mask, and ``loss_stateful_with_draws`` computes the loss
from them.
"""

from __future__ import annotations

import ast
import math
from typing import Dict, Optional

import torch

from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops import diffusion as diff
from chaorec_tpu_torch.ops.mxu import bdot


class DiffRec(RecModel):
    name = "DiffRec"
    rank_mode = "scores"
    stateful = True
    trainer_mode = "user_rows"
    mask_value = float("-inf")
    emb_size = 10
    dnn_dropout = 0.5

    def __init__(self, num_user: int, num_item: int, dense_interactions: torch.Tensor,
                 noise_scale: float, noise_min: float, noise_max: float, steps: int, dims,
                 sample_compute_dtype: str = "bfloat16"):
        super().__init__(num_user, num_item)
        self.device = dense_interactions.device
        self.sample_dtype = torch.bfloat16 if sample_compute_dtype == "bfloat16" else None
        self.x = dense_interactions
        self.sched = diff.make_schedule(noise_scale, noise_min, noise_max, steps,
                                        device=self.device)
        hidden = ast.literal_eval(dims) if isinstance(dims, str) else list(dims)
        self.out_dims = list(hidden) + [num_item]  # [1000, I]
        self.in_dims = self.out_dims[::-1]  # [I, 1000]
        self.steps = steps

    def init_params(self, generator: torch.Generator) -> Params:
        def lin(d_out, d_in):
            std = math.sqrt(2.0 / (d_in + d_out))
            return (std * torch.randn((d_out, d_in), generator=generator, device=generator.device),
                    0.001 * torch.randn((d_out,), generator=generator, device=generator.device))

        p = {}
        p["emb_w"], p["emb_b"] = lin(self.emb_size, self.emb_size)
        in_dims = [self.in_dims[0] + self.emb_size] + self.in_dims[1:]
        for i, (d_in, d_out) in enumerate(zip(in_dims[:-1], in_dims[1:])):
            p[f"in_w{i}"], p[f"in_b{i}"] = lin(d_out, d_in)
        for i, (d_in, d_out) in enumerate(zip(self.out_dims[:-1], self.out_dims[1:])):
            p[f"out_w{i}"], p[f"out_b{i}"] = lin(d_out, d_in)
        return p

    def init_state(self, device: torch.device | str = "cpu", generator=None):
        return diff.init_lt_state(self.steps, device)

    def _dnn(self, params: Params, x: torch.Tensor, ts: torch.Tensor,
             keep: Optional[torch.Tensor] = None, compute_dtype=None) -> torch.Tensor:
        if compute_dtype is None:
            def mm(h, w):
                return h @ w.t()
        else:
            def mm(h, w):
                return bdot(h.to(compute_dtype), w.to(compute_dtype).t())
        emb = diff.timestep_embedding(ts, self.emb_size)
        emb = emb @ params["emb_w"].t() + params["emb_b"]
        if keep is not None:
            x = x * keep / (1.0 - self.dnn_dropout)
        h = torch.cat([x, emb], dim=-1)
        for i in range(len(self.in_dims) - 1):
            h = torch.tanh(mm(h, params[f"in_w{i}"]) + params[f"in_b{i}"])
        n_out = len(self.out_dims) - 1
        for i in range(n_out):
            h = mm(h, params[f"out_w{i}"]) + params[f"out_b{i}"]
            if i != n_out - 1:
                h = torch.tanh(h)
        return h

    def draws(self, generator: torch.Generator, batch: Batch, state) -> Dict[str, torch.Tensor]:
        """The step's timesteps and importance weights (from the loss
        history ``state``), noise (B, I) and dropout keep mask (B, I)."""
        b = batch.users.shape[0]
        ts, pt = diff.sample_timesteps(state, b, self.steps, generator)
        noise = torch.randn((b, self.num_item), generator=generator, device=self.device)
        keep = (torch.rand((b, self.num_item), generator=generator, device=self.device)
                < 1.0 - self.dnn_dropout).float()
        return {"ts": ts, "pt": pt, "noise": noise, "keep": keep}

    def loss_stateful_with_draws(self, params: Params, state, batch: Batch,
                                 draws: Dict[str, torch.Tensor]):
        loss, new_state, _ = diff.loss_from_draws(
            self.sched, lambda x_t, ts: self._dnn(params, x_t, ts, draws["keep"]),
            self.x[batch.users], state, batch.weights, draws["ts"], draws["pt"],
            draws["noise"])
        return loss, new_state

    def loss_stateful(self, params: Params, state, batch: Batch, generator: torch.Generator):
        return self.loss_stateful_with_draws(params, state, batch,
                                             self.draws(generator, batch, state))

    @torch.no_grad()
    def score_users(self, params: Params, user_ids: torch.Tensor) -> torch.Tensor:
        return diff.p_sample(
            self.sched,
            lambda x_t, ts: self._dnn(params, x_t, ts, compute_dtype=self.sample_dtype),
            self.x[user_ids.to(self.device)])
