"""Gaussian diffusion over interaction rows: the inference half.

Counterpart of ``chaorec_tpu/ops/diffusion.py``:

- linear beta schedule ``noise_scale * [noise_min..noise_max]`` with
  beta[0] fixed (1e-5 by default), computed in float64 numpy and only then
  cast to float32, so both packages hold bit-identical schedules;
- ``q_sample`` forward noising and the deterministic reverse process
  ``p_sample`` (posterior mean of an x0-predicting denoiser), as a Python
  loop over t = steps-1 ... 0;
- ``timestep_embedding``, the sinusoidal time embedding.

The training half (``training_loss``, ``sample_timesteps``,
``update_lt_history``) comes with the training port; ``init_lt_state``
is here because a stateful model's state is part of what it serves with.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

HISTORY_PER_TERM = 10  # loss-history length per diffusion step


@dataclass(frozen=True)
class DiffusionSchedule:
    steps: int
    noise_scale: float
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor


def make_schedule(noise_scale: float, noise_min: float, noise_max: float,
                  steps: int, beta_fixed: bool = True,
                  beta_fixed_value: float = 1e-5,
                  device: torch.device | str = "cpu") -> DiffusionSchedule:
    """``beta_fixed_value``: 1e-5 for DiffRec and CF_Diff, 1e-4 for DiffMM."""
    start = noise_scale * noise_min
    end = noise_scale * noise_max
    betas = np.linspace(start, end, steps, dtype=np.float64)
    if beta_fixed:
        betas[0] = beta_fixed_value
    alphas = 1.0 - betas
    acp = np.cumprod(alphas)
    acp_prev = np.concatenate([[1.0], acp[:-1]])
    posterior_variance = betas * (1.0 - acp_prev) / (1.0 - acp)
    plvc = np.log(np.concatenate([[posterior_variance[1]],
                                  posterior_variance[1:]]))

    def f32(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    return DiffusionSchedule(
        steps=steps,
        noise_scale=noise_scale,
        betas=f32(betas),
        alphas_cumprod=f32(acp),
        alphas_cumprod_prev=f32(acp_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(acp)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1 - acp)),
        posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
        posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
        posterior_log_variance_clipped=f32(plvc),
    )


def q_sample(sched: DiffusionSchedule, x_start: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    return (
        sched.sqrt_alphas_cumprod[t][:, None] * x_start
        + sched.sqrt_one_minus_alphas_cumprod[t][:, None] * noise
    )


def p_sample(sched: DiffusionSchedule,
             denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
             x_start: torch.Tensor, sampling_steps: int = 0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Deterministic reverse process (the reference's sampling_noise=False).

    ``denoise_fn(x_t, t) -> x0_hat``. With ``sampling_steps > 0`` the chain
    starts from ``q_sample`` at t = sampling_steps-1, with Gaussian noise
    from ``generator`` (noise-free without one). The reverse loop always
    runs the full schedule."""
    x_t = x_start
    n = x_start.shape[0]
    if sampling_steps > 0:
        t0 = torch.full((n,), sampling_steps - 1, dtype=torch.long,
                        device=x_start.device)
        noise = (torch.randn(x_start.shape, generator=generator,
                             device=x_start.device, dtype=x_start.dtype)
                 if generator is not None else torch.zeros_like(x_start))
        x_t = q_sample(sched, x_start, t0, noise)
    for i in range(sched.steps - 1, -1, -1):
        t = torch.full((n,), i, dtype=torch.long, device=x_start.device)
        x0_hat = denoise_fn(x_t, t)
        x_t = (sched.posterior_mean_coef1[t][:, None] * x0_hat
               + sched.posterior_mean_coef2[t][:, None] * x_t)
    return x_t


def init_lt_state(steps: int, device: torch.device | str = "cpu"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Empty per-step loss history and its fill counts."""
    return (torch.zeros((steps, HISTORY_PER_TERM), dtype=torch.float32,
                        device=device),
            torch.zeros((steps,), dtype=torch.int32, device=device))


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal time embedding, (len(timesteps), dim) float32."""
    half = dim // 2
    # log(max_period) rounded to float32 first, as jnp.log of a Python float
    log_period = torch.tensor(math.log(max_period), dtype=torch.float32)
    freqs = torch.exp(
        -log_period * torch.arange(half, dtype=torch.float32) / half
    ).to(timesteps.device)
    args = timesteps[:, None].to(torch.float32) * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb
