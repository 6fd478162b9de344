"""MultVAE: variational autoencoder with a multinomial likelihood.

Counterpart of ``chaorec_tpu/models/multvae.py`` (reference:
Model/MultVAE.py):

- a one-layer encoder ``Linear(I -> 2 dim_E)`` (mu | logvar) over the
  L2-normalized user row with dropout keep 0.5, and a one-layer decoder
  ``Linear(dim_E -> I)``; weights and biases U[0, 1) (the reference's
  ``nn.init.uniform_``, Model/MultVAE.py:53-69);
- loss = -mean(sum(log_softmax(logits) x)) + anneal KL + 2 reg, with
  anneal = min(0.2, count / 200000) from a per-step counter (the model's
  state) and reg = reg_weight (reg_weight 0.5 sum ||p||^2): the
  reference's double ``reg_weight`` (Model/MultVAE.py:130-160);
- scores: the decoder's logits at the posterior mean z = mu over the
  user's dense row (the JAX package's deviation from the reference, which
  samples in eval too).

Trained on BPR edges, as in the JAX package: each edge row reads its
user's dense row. ``draws`` makes the step's dropout mask and eps, and
``loss_stateful_with_draws`` computes the loss from them.
"""

from __future__ import annotations

from typing import Dict

import torch

from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import uniform01_init
from chaorec_tpu_torch.ops.losses import l2norm, masked_mean


class MultVAE(RecModel):
    name = "MultVAE"
    rank_mode = "scores"
    stateful = True
    keep_prob = 0.5
    total_anneal_steps = 200000
    anneal_cap = 0.2

    def __init__(self, num_user: int, num_item: int, dense_interactions: torch.Tensor,
                 dim_E: int, reg_weight: float):
        super().__init__(num_user, num_item)
        self.device = dense_interactions.device
        self.dim_E = dim_E
        self.reg_weight = reg_weight
        self.x = dense_interactions  # (U, I) float32

    def init_params(self, generator: torch.Generator) -> Params:
        return {
            "q_w": uniform01_init(generator, (2 * self.dim_E, self.num_item)),
            "q_b": uniform01_init(generator, (2 * self.dim_E,)),
            "p_w": uniform01_init(generator, (self.num_item, self.dim_E)),
            "p_b": uniform01_init(generator, (self.num_item,)),
        }

    def init_state(self, device: torch.device | str = "cpu", generator=None) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=device)  # the step counter

    def _encode(self, params: Params, x: torch.Tensor, keep=None):
        h = l2norm(x)
        if keep is not None:
            h = h * keep / self.keep_prob
        h = h @ params["q_w"].t() + params["q_b"]
        return h[:, :self.dim_E], h[:, self.dim_E:]

    def _decode(self, params: Params, z: torch.Tensor) -> torch.Tensor:
        return z @ params["p_w"].t() + params["p_b"]

    def draws(self, generator: torch.Generator, batch: Batch,
              state=None) -> Dict[str, torch.Tensor]:
        """The step's dropout keep mask (B, I) and eps (B, dim_E)."""
        b = batch.users.shape[0]
        keep = (torch.rand((b, self.num_item), generator=generator, device=self.device)
                < self.keep_prob).float()
        eps = torch.randn((b, self.dim_E), generator=generator, device=self.device)
        return {"keep": keep, "eps": eps}

    def loss_stateful_with_draws(self, params: Params, state: torch.Tensor, batch: Batch,
                                 draws: Dict[str, torch.Tensor]):
        x = self.x[batch.users]
        w = batch.weights
        mu, logvar = self._encode(params, x, draws["keep"])
        std = torch.exp(0.5 * logvar)
        kl = masked_mean(torch.sum(0.5 * (-logvar + torch.exp(logvar) + mu ** 2 - 1.0), 1), w)
        logits = self._decode(params, mu + draws["eps"] * std)
        neg_ll = -masked_mean(torch.sum(torch.log_softmax(logits, -1) * x, -1), w)
        anneal = torch.clamp(state / self.total_anneal_steps, max=self.anneal_cap)
        # the double reg_weight (see the module docstring)
        reg = self.reg_weight * (self.reg_weight * 0.5 * sum(torch.sum(p ** 2)
                                                             for p in params.values()))
        return neg_ll + anneal * kl + 2.0 * reg, state.detach() + 1.0

    def loss_stateful(self, params: Params, state, batch: Batch, generator: torch.Generator):
        return self.loss_stateful_with_draws(params, state, batch,
                                             self.draws(generator, batch, state))

    @torch.no_grad()
    def score_users(self, params: Params, user_ids: torch.Tensor) -> torch.Tensor:
        mu, _ = self._encode(params, self.x[user_ids.to(self.device)])
        return self._decode(params, mu)
