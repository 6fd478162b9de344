"""MacridVAE: a macro-disentangled VAE over concept prototypes.

Counterpart of ``chaorec_tpu/models/macridvae.py`` (reference:
Model/MacridVAE.py):

- kfac = 10 concept prototypes; each item's concept weights are
  softmax((unit items @ unit prototypes^T) / tau) with Gumbel noise in
  training (temperature 1 over the logits / tau) and without it at eval
  (tau 0.1, std 0.01, one hidden layer of 600; Model/MacridVAE.py:77-95);
- per concept: an encoder MLP(I -> 600 tanh -> 2 dim_E) over the
  concept-gated, L2-normalized user row with dropout keep 0.5; mu
  L2-normalized; z = mu + 0.01 eps exp(0.5 logvar) in training, mu at
  eval; the concept's logits (unit z @ unit items^T) / tau; the output is
  log(sum_k exp(logits_k) cates_k) (Model/MacridVAE.py:96-129);
- loss = CE + anneal KL, the KL without the mu^2 term as the reference
  writes it (Model/MacridVAE.py:146-148), the anneal counter as state; no
  regularizer (its regs are [0, 0]);
- scores: the eval output over the user's dense row.

Trained on BPR edges, each reading its user's row. ``draws`` makes the
step's dropout mask, the Gumbel uniforms and the concepts' eps, and
``loss_stateful_with_draws`` computes the loss from them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_normal
from chaorec_tpu_torch.ops.losses import l2norm, masked_mean


class MacridVAE(RecModel):
    name = "MacridVAE"
    rank_mode = "scores"
    stateful = True
    drop_out = 0.5
    kfac = 10
    hidden = 600
    tau = 0.1
    std = 0.01
    total_anneal_steps = 200000
    anneal_cap = 0.2

    def __init__(self, num_user: int, num_item: int, dense_interactions: torch.Tensor,
                 dim_E: int, reg_weight: float):
        super().__init__(num_user, num_item)
        self.device = dense_interactions.device
        self.dim_E = dim_E
        self.x = dense_interactions

    def init_params(self, generator: torch.Generator) -> Params:
        w1, b1 = torch_linear_init(generator, self.hidden, self.num_item)
        w2, b2 = torch_linear_init(generator, 2 * self.dim_E, self.hidden)
        return {
            "enc_w1": w1, "enc_b1": b1, "enc_w2": w2, "enc_b2": b2,
            "item_embedding": xavier_normal(generator, (self.num_item, self.dim_E)),
            "k_embedding": xavier_normal(generator, (self.kfac, self.dim_E)),
        }

    def init_state(self, device: torch.device | str = "cpu", generator=None) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=device)

    def _encoder(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(x @ params["enc_w1"].t() + params["enc_b1"])
        return h @ params["enc_w2"].t() + params["enc_b2"]

    def forward(self, params: Params, rows: torch.Tensor,
                draws: Optional[Dict[str, torch.Tensor]] = None):
        """(log-probabilities, mus, logvars); without ``draws``, eval mode."""
        cores = l2norm(params["k_embedding"])
        items = l2norm(params["item_embedding"])
        x = l2norm(rows)
        cates_logits = (items @ cores.t()) / self.tau
        if draws is not None:
            keep = 1.0 - self.drop_out
            x = x * draws["keep"] / keep
            g = -torch.log(-torch.log(draws["gumbel_u"] + 1e-10) + 1e-10)
            cates = torch.softmax(cates_logits + g, dim=-1)
        else:
            cates = torch.softmax(cates_logits, dim=-1)
        probs = 0.0
        mus, logvars = [], []
        for k in range(self.kfac):
            cates_k = cates[:, k][None, :]  # (1, I)
            h = self._encoder(params, x * cates_k)
            mu = l2norm(h[:, :self.dim_E])
            logvar = h[:, self.dim_E:]
            mus.append(mu)
            logvars.append(logvar)
            z = mu
            if draws is not None:
                z = mu + self.std * draws["eps"][k] * torch.exp(0.5 * logvar)
            logits_k = (l2norm(z) @ items.t()) / self.tau
            probs = probs + torch.exp(logits_k) * cates_k
        return torch.log(probs + 1e-12), mus, logvars

    def draws(self, generator: torch.Generator, batch: Batch,
              state=None) -> Dict[str, torch.Tensor]:
        """The step's dropout keep mask (B, I), the Gumbel uniforms (I,
        kfac) and each concept's eps (kfac, B, dim_E)."""
        b = batch.users.shape[0]
        keep = (torch.rand((b, self.num_item), generator=generator, device=self.device)
                < 1.0 - self.drop_out).float()
        gumbel_u = torch.rand((self.num_item, self.kfac), generator=generator, device=self.device)
        eps = torch.randn((self.kfac, b, self.dim_E), generator=generator, device=self.device)
        return {"keep": keep, "gumbel_u": gumbel_u, "eps": eps}

    def loss_stateful_with_draws(self, params: Params, state: torch.Tensor, batch: Batch,
                                 draws: Dict[str, torch.Tensor]):
        rows = self.x[batch.users]
        w = batch.weights
        logits, _, logvars = self.forward(params, rows, draws)
        kl = 0.0
        for lv in logvars:
            # the reference's formula has no mu^2 term (Model/MacridVAE.py:147)
            kl = kl + masked_mean(-0.5 * torch.sum(1.0 + lv - torch.exp(lv), 1), w)
        ce = -masked_mean(torch.sum(torch.log_softmax(logits, 1) * rows, 1), w)
        anneal = torch.clamp(state / self.total_anneal_steps, max=self.anneal_cap)
        return ce + anneal * kl, state.detach() + 1.0

    def loss_stateful(self, params: Params, state, batch: Batch, generator: torch.Generator):
        return self.loss_stateful_with_draws(params, state, batch,
                                             self.draws(generator, batch, state))

    @torch.no_grad()
    def score_users(self, params: Params, user_ids: torch.Tensor) -> torch.Tensor:
        logits, _, _ = self.forward(params, self.x[user_ids.to(self.device)])
        return logits
