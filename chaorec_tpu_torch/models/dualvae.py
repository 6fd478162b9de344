"""DualVAE: dual user and item VAEs with cross-decoding and aspect contrast.

Counterpart of ``chaorec_tpu/models/dualvae.py`` (reference:
Model/DualVAE.py):

- a = 5 aspects, k = 25 latent dimensions, tanh encoders [I -> 20] and
  [U -> 20] with sigmoid std heads, tanh decoders [25 -> 20], a Poisson
  likelihood (Model/DualVAE.py:37-41, 50-111);
- aspect gates: the item side's rows are weighted by softmax(<theta,
  user_preferences>) of the cached user latents, the user side's by
  softmax(<beta, item_topics>) of the item latents
  (Model/DualVAE.py:179-258);
- cross-decoding sigmoid(theta beta^T + tanh(dec(theta) dec(beta)^T)),
  weighted by the aspect's gate and summed; the KL per aspect averaged;
  an aspect-wise contrastive loss between the latents and their decoded
  neighbourhoods, with aspect-level and batch-level negatives (pad rows
  included, as in the JAX package; Model/DualVAE.py:152-177);
- the state: the theta, beta, mu_theta and mu_beta caches (U or I, a, k),
  overwritten each step with the batch's latents (the item side first,
  then the user side, gated by the updated beta) and read by the other
  side's gates and by the ranking (Model/DualVAE.py:56-67, 288-301);
- scores: the aspect-weighted decode of the cached mu tables
  (``score_users_stateful``; Model/DualVAE.py:305-337).

The cache rule. A BPR batch repeats ids: a user's or an item's several
edges, and the pad rows of an epoch's last batch, which repeat the
epoch's first edge. The JAX package's ``.at[ids].set(z)`` leaves the last
occurrence's row on the CPU. ``write_rows`` gives that rule explicitly,
whatever the device: each position takes the row of its id's last
occurrence, so repeated ids write equal rows, in one ``index_copy``.

``draws`` makes the step's eps, and ``loss_stateful_with_draws`` computes
the loss from them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops.init import torch_linear_init
from chaorec_tpu_torch.ops.losses import l2norm, masked_mean

EPS = 1e-10


def write_rows(table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table`` with row ``ids[j]`` set to ``rows[j]``; where an id repeats,
    its last occurrence's row (B x B compares: no host sync, and the
    result does not depend on the order the device writes in)."""
    pos = torch.arange(ids.shape[0], device=ids.device)
    last = torch.where(ids[:, None] == ids[None, :], pos[None, :], -1).amax(dim=1)
    return table.index_copy(0, ids, rows[last])


class DualVAE(RecModel):
    name = "DualVAE"
    rank_mode = "scores"
    stateful = True
    k = 25
    a = 5
    hidden = 20

    def __init__(self, num_user: int, num_item: int, dense_interactions: torch.Tensor,
                 kl_weight: float, ssl_reg: float):
        super().__init__(num_user, num_item)
        self.device = dense_interactions.device
        self.kl_weight = kl_weight
        self.ssl_reg = ssl_reg
        self.x = dense_interactions  # (U, I)
        self.xt = dense_interactions.t().contiguous()  # (I, U)

    def init_params(self, generator: torch.Generator) -> Params:
        # kaiming_uniform(a=sqrt(5)) == U(-1/sqrt(fan_in), ..) with fan_in = k
        bound = 1.0 / math.sqrt(self.k)
        p = {name: torch.rand((self.a, self.k), generator=generator,
                              device=generator.device) * (2 * bound) - bound
             for name in ("user_preferences", "item_topics")}
        for name, (o, i) in [
            ("u_enc", (self.hidden, self.num_item)), ("i_enc", (self.hidden, self.num_user)),
            ("u_mu", (self.k, self.hidden)), ("u_std", (self.k, self.hidden)),
            ("i_mu", (self.k, self.hidden)), ("i_std", (self.k, self.hidden)),
            ("u_dec", (self.hidden, self.k)), ("i_dec", (self.hidden, self.k)),
        ]:
            p[f"{name}_w"], p[f"{name}_b"] = torch_linear_init(generator, o, i)
        return p

    def init_state(self, device: torch.device | str = "cpu",
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """theta and beta 0.01 N(0, 1) from ``generator`` (seeded 0 when
        None), mu_theta and mu_beta zero."""
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        shapes = {"theta": self.num_user, "beta": self.num_item}
        state = {n: 0.01 * torch.randn((rows, self.a, self.k), generator=generator,
                                       device=device) for n, rows in shapes.items()}
        for n, rows in shapes.items():
            state[f"mu_{n}"] = torch.zeros((rows, self.a, self.k), device=device)
        return state

    def _lin(self, params: Params, name: str, x: torch.Tensor) -> torch.Tensor:
        return x @ params[f"{name}_w"].t() + params[f"{name}_b"]

    def _decode(self, params: Params, theta: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
        th = torch.tanh(self._lin(params, "u_dec", theta))
        bh = torch.tanh(self._lin(params, "i_dec", beta))
        return torch.sigmoid(theta @ beta.t() + torch.tanh(th @ bh.t()))

    def _contrast(self, z: torch.Tensor, nei: torch.Tensor, weights: torch.Tensor):
        z, nei = l2norm(z), l2norm(nei)
        pos = torch.exp(torch.sum(nei * z, -1) / 0.2)  # (B, a)
        acl = torch.sum(torch.exp(torch.einsum("bak,bck->bac", nei, z) / 0.2), -1)
        ncl = torch.sum(torch.exp(torch.einsum("bak,cak->bac", nei, z) / 0.2), -1)
        return -masked_mean(torch.sum(torch.log(pos / (acl + ncl)), -1), weights)

    def _side(self, params: Params, rows, other, gate_proj, enc, mu_h, std_h,
              user_side: bool, eps: torch.Tensor, weights: torch.Tensor):
        """One VAE side: (z (B, a, k), mu (B, a, k), loss)."""
        gate = torch.softmax(torch.sum(other * gate_proj[None], -1), dim=1)  # (N_other, a)
        probs, kl = 0.0, 0.0
        zs, mus, neis = [], [], []
        for a in range(self.a):
            ga = gate[:, a][None, :]
            h = torch.tanh(self._lin(params, enc, rows * ga))
            mu = self._lin(params, mu_h, h)
            std = torch.sigmoid(self._lin(params, std_h, h))
            kl_a = -0.5 * (1 + 2 * torch.log(std + EPS) - mu ** 2 - std ** 2)
            kl = kl + masked_mean(torch.sum(kl_a, -1), weights)
            z = mu + eps[a] * std
            other_a = other[:, a, :]
            if user_side:
                probs_a = self._decode(params, z, other_a) * ga
            else:
                probs_a = self._decode(params, other_a, z).t() * ga
            probs = probs + probs_a
            zs.append(z)
            mus.append(mu)
            neis.append(probs_a @ other_a)
        z, mu, nei = torch.stack(zs, 1), torch.stack(mus, 1), torch.stack(neis, 1)
        cl = self._contrast(z, nei, weights)
        ll = masked_mean(torch.sum(rows * torch.log(probs + EPS) - probs, -1), weights)
        kl = kl / self.a
        return z, mu, self.kl_weight * kl - ll + self.ssl_reg * cl

    def draws(self, generator: torch.Generator, batch: Batch,
              state=None) -> Dict[str, torch.Tensor]:
        """The step's eps of the item side, then the user side, (a, B, k) each."""
        shape = (self.a, batch.users.shape[0], self.k)
        return {side: torch.randn(shape, generator=generator, device=self.device)
                for side in ("eps_i", "eps_u")}

    def loss_stateful_with_draws(self, params: Params, state, batch: Batch,
                                 draws: Dict[str, torch.Tensor]):
        w = batch.weights
        # the item side first (the reference's order), gated by the cached users
        z_i, mu_i, item_loss = self._side(
            params, self.xt[batch.pos_items], state["theta"], params["user_preferences"],
            "i_enc", "i_mu", "i_std", False, draws["eps_i"], w)
        beta = write_rows(state["beta"], batch.pos_items, z_i.detach())
        mu_beta = write_rows(state["mu_beta"], batch.pos_items, mu_i.detach())
        z_u, mu_u, user_loss = self._side(
            params, self.x[batch.users], beta, params["item_topics"],
            "u_enc", "u_mu", "u_std", True, draws["eps_u"], w)
        new_state = {"theta": write_rows(state["theta"], batch.users, z_u.detach()),
                     "beta": beta,
                     "mu_theta": write_rows(state["mu_theta"], batch.users, mu_u.detach()),
                     "mu_beta": mu_beta}
        return item_loss + user_loss, new_state

    def loss_stateful(self, params: Params, state, batch: Batch, generator: torch.Generator):
        return self.loss_stateful_with_draws(params, state, batch,
                                             self.draws(generator, batch, state))

    @torch.no_grad()
    def score_users_stateful(self, params: Params, state, user_ids: torch.Tensor):
        theta = state["mu_theta"][user_ids.to(self.device)]  # (C, a, k)
        beta = state["mu_beta"]  # (I, a, k)
        gate = torch.softmax(torch.sum(beta * params["item_topics"][None], -1), dim=1)
        scores = 0.0
        for a in range(self.a):
            scores = scores + self._decode(params, theta[:, a], beta[:, a]) * gate[:, a][None]
        return scores
