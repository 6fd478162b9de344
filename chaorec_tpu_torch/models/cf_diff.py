"""CF-Diff: collaborative diffusion with cross-attention hop fusion.

Counterpart of ``chaorec_tpu/models/cf_diff.py``, which documents the
reference in full:

- CAM_AE denoiser: the one-hop row and the two-hop conditioning row both
  pass through the *same* ``encoder`` Linear(I -> 1024) (a reference quirk:
  its ``encoder2`` is never used); each encoded row, concatenated with a
  10-dim time embedding, is a sequence of 1034 scalar tokens lifted to
  d_model 16; 2 rounds of 4-head cross attention (query = two-hop tokens,
  key/value = one-hop tokens, the query is not updated between rounds)
  with a residual into the one-hop stream and a Linear(16 -> 16) per round,
  tanh between rounds; tokens decoded back to scalars, tanh,
  Linear(1034 -> I);
- dropout in training, drawn from the caller's ``torch.Generator``: keep
  0.5 on the encoded row, 0.5 on the attention weights (inside the fused
  attention kernel, seeded by a draw from the generator), 0.2 on the
  attention output and 0.5 after the residual;
- two-hop rows: global item popularity ``colsum(X) / num_user`` masked to
  each user's interacted items;
- training (``loss_stateful``): the SNR-weighted diffusion loss with
  importance-sampled timesteps (``ops/diffusion.training_loss``) on
  aligned one-hop and two-hop rows of the batch's users;
- scores: the deterministic diffusion reverse process (``ops/diffusion``)
  from the user's interaction row; seen items are masked with -inf.

The attention goes through ``ops/fused_attn.fused_mha``: the CUDA kernels,
forward and backward, for CUDA tensors. On CUDA a whole batch goes through
at once, since the kernels store nothing of size 1034^2. On the CPU the
plain path runs in micro-batches of ``micro`` users, each under
``torch.utils.checkpoint`` when a gradient is needed, as the JAX package's
``jax.checkpoint`` scan does: each user's (4, 1034, 1034) fp32 scores take
17 MB, and 1024 users would hold ~50 GB per round. A micro-batch draws its
dropout from a generator seeded by one draw of the caller's, so that the
recomputation in the backward draws the same masks.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from chaorec_tpu_torch.models.base import Batch, Params, RecModel
from chaorec_tpu_torch.ops import diffusion as diff
from chaorec_tpu_torch.ops.fused_attn import fused_mha
from chaorec_tpu_torch.ops.init import torch_linear_init, xavier_uniform


class CF_Diff(RecModel):
    name = "CF_Diff"
    rank_mode = "scores"
    stateful = True
    trainer_mode = "user_rows"
    mask_value = float("-inf")
    emb_size = 10
    d_model = 16
    num_heads = 4
    cam_layers = 2
    dim_inters = 1024  # the reference's fixed encoder width
    micro = 64  # users per plain-path micro-batch on the CPU

    def __init__(self, num_user: int, num_item: int,
                 dense_interactions: torch.Tensor, noise_scale: float,
                 noise_min: float, noise_max: float, steps: int):
        super().__init__(num_user, num_item)
        self.device = dense_interactions.device
        self.x = dense_interactions
        pop = torch.sum(dense_interactions, dim=0) / num_user
        # rows are binary, so masking popularity to them is a product
        self.sec = dense_interactions * pop[None, :]
        self.sched = diff.make_schedule(noise_scale, noise_min, noise_max,
                                        steps, device=self.device)
        self.steps = steps
        self.seq_len = self.dim_inters + self.emb_size  # 1034 tokens

    # ------------------------------------------------------------------
    def init_params(self, generator: torch.Generator) -> Params:
        """torch-default Linear inits; attention in_proj xavier_uniform with
        zero bias, out_proj bias zero (nn.MultiheadAttention's own)."""
        p = {}
        p["emb_w"], p["emb_b"] = torch_linear_init(generator, self.emb_size,
                                                   self.emb_size)
        p["enc_w"], p["enc_b"] = torch_linear_init(generator, self.dim_inters,
                                                   self.num_item)
        p["fh_w"], p["fh_b"] = torch_linear_init(generator, self.d_model, 1)
        p["sh_w"], p["sh_b"] = torch_linear_init(generator, self.d_model, 1)
        p["fhd_w"], p["fhd_b"] = torch_linear_init(generator, 1, self.d_model)
        p["dec_w"], p["dec_b"] = torch_linear_init(generator, self.num_item,
                                                   self.seq_len)
        e = self.d_model
        for i in range(self.cam_layers):
            p[f"fwd_w{i}"], p[f"fwd_b{i}"] = torch_linear_init(generator, e, e)
            p[f"attn_in_w{i}"] = xavier_uniform(generator, (3 * e, e))
            p[f"attn_in_b{i}"] = torch.zeros(3 * e, device=generator.device)
            p[f"attn_out_w{i}"], _ = torch_linear_init(generator, e, e)
            p[f"attn_out_b{i}"] = torch.zeros(e, device=generator.device)
        return p

    def init_state(self, device: torch.device | str = "cpu", generator=None):
        return diff.init_lt_state(self.steps, device)

    # ------------------------------------------------------------------
    def _attention(self, p: Params, i: int, query: torch.Tensor, kv: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """torch MultiheadAttention(d=16, heads=4, dropout=0.5, batch_first)
        with packed in_proj; dropout on the attention weights only with a
        generator."""
        e, h = self.d_model, self.num_heads
        dh = e // h
        w = p[f"attn_in_w{i}"]
        b = p[f"attn_in_b{i}"]
        q = query @ w[:e].T + b[:e]
        k = kv @ w[e:2 * e].T + b[e:2 * e]
        v = kv @ w[2 * e:].T + b[2 * e:]

        def heads(t):  # (B, L, E) -> (B, h, L, dh), contiguous for the kernel
            bsz, ln, _ = t.shape
            return t.reshape(bsz, ln, h, dh).transpose(1, 2).contiguous()

        if generator is None:
            out = fused_mha(heads(q), heads(k), heads(v), seed=0)
        else:
            seed = torch.randint(2 ** 31, (1,), generator=generator, device=query.device)
            out = fused_mha(heads(q), heads(k), heads(v), seed, 0.5)
        out = out.transpose(1, 2).reshape(query.shape)
        return out @ p[f"attn_out_w{i}"].T + p[f"attn_out_b{i}"]

    def _cam_core(self, p: Params, x: torch.Tensor, sec: torch.Tensor,
                  ts: torch.Tensor, generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
        """CAM_AE forward on one batch; the dropout branches run only with a
        generator."""
        h1 = x @ p["enc_w"].T + p["enc_b"]
        h2 = sec @ p["enc_w"].T + p["enc_b"]  # the same encoder (quirk)
        emb = diff.timestep_embedding(ts, self.emb_size)
        emb = emb @ p["emb_w"].T + p["emb_b"]
        if generator is not None:
            h1 = _dropout(h1, 0.5, generator)
        # scalar tokens lifted to d_model
        h = torch.cat([h1, emb], dim=-1)[..., None] * p["fh_w"][:, 0] + p["fh_b"]
        hs = torch.cat([h2, emb], dim=-1)[..., None] * p["sh_w"][:, 0] + p["sh_b"]
        for i in range(self.cam_layers):
            attn = self._attention(p, i, hs, h, generator)
            if generator is not None:
                attn = _dropout(attn, 0.2, generator)  # the reference's p = 0.8
            h = h + attn
            if generator is not None:
                h = _dropout(h, 0.5, generator)
            h = h @ p[f"fwd_w{i}"].T + p[f"fwd_b{i}"]
            if i != self.cam_layers - 1:
                h = torch.tanh(h)
        h = (h @ p["fhd_w"].T + p["fhd_b"])[..., 0]  # (B, 1034)
        h = torch.tanh(h)
        return h @ p["dec_w"].T + p["dec_b"]

    def _cam_micro(self, p: Params, seed: Optional[int], x: torch.Tensor,
                   sec: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
        gen = None if seed is None else torch.Generator(x.device).manual_seed(seed)
        return self._cam_core(p, x, sec, ts, gen)

    def _cam(self, p: Params, x: torch.Tensor, sec: torch.Tensor, ts: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """CAM_AE over a batch: whole on CUDA, in micro-batches on the CPU."""
        if x.is_cuda:
            return self._cam_core(p, x, sec, ts, generator)
        b = x.shape[0]
        m = min(self.micro, b)
        outs = []
        for s in range(0, b, m):
            seed = (None if generator is None
                    else int(torch.randint(2 ** 62, (1,), generator=generator)))
            core = functools.partial(self._cam_micro, p, seed)
            args = (x[s:s + m], sec[s:s + m], ts[s:s + m])
            if torch.is_grad_enabled():
                # the generator is re-seeded inside, so no RNG state to keep
                outs.append(checkpoint(core, *args, use_reentrant=False,
                                       preserve_rng_state=False))
            else:
                outs.append(core(*args))
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    # ------------------------------------------------------------------
    def loss_stateful(self, params: Params, state, batch: Batch,
                      generator: torch.Generator):
        """(loss, new_state) on one batch of user rows, with every dropout
        on; the timesteps, the noise and the masks come from ``generator``."""
        rows = self.x[batch.users]
        sec = self.sec[batch.users]
        loss, new_state, _ = diff.training_loss(
            self.sched,
            lambda x_t, ts: self._cam(params, x_t, sec, ts, generator),
            rows, state, batch.weights, generator,
        )
        return loss, new_state

    @torch.no_grad()
    def score_users(self, params: Params, user_ids: torch.Tensor) -> torch.Tensor:
        user_ids = user_ids.to(self.device)
        rows = self.x[user_ids]
        sec = self.sec[user_ids]
        return diff.p_sample(
            self.sched, lambda x_t, ts: self._cam(params, x_t, sec, ts), rows
        )


def _dropout(t: torch.Tensor, keep: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout: each entry kept with probability ``keep``, then
    scaled by ``1 / keep``."""
    mask = torch.rand(t.shape, generator=generator, device=t.device) < keep
    return t * mask / keep
