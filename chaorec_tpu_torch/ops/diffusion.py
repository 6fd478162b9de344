"""Gaussian diffusion over interaction rows.

Counterpart of ``chaorec_tpu/ops/diffusion.py``:

- linear beta schedule ``noise_scale * [noise_min..noise_max]`` with
  beta[0] fixed (1e-5 by default), computed in float64 numpy and only then
  cast to float32, so both packages hold bit-identical schedules;
- ``q_sample`` forward noising and the deterministic reverse process
  ``p_sample`` (posterior mean of an x0-predicting denoiser), as a Python
  loop over t = steps-1 ... 0;
- ``timestep_embedding``, the sinusoidal time embedding;
- training: the SNR-weighted x0 loss (weight SNR(t-1) - SNR(t), 1 at t=0)
  with importance-sampled timesteps driven by a circular per-step loss
  history (``sample_timesteps``, ``update_lt_history``, ``training_loss``).
  As in the JAX package, the history takes one aggregated loss per step
  per batch instead of one per sample (a documented deviation from the
  reference: it fills more slowly, with the same stationary distribution).

Random draws come from an explicit ``torch.Generator``:
``jax.random.choice(p=...)`` becomes ``torch.multinomial``. The two packages
draw different numbers; ``loss_from_draws`` takes the draws as arguments so
that a test can hand both packages the same ones.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

HISTORY_PER_TERM = 10  # loss-history length per diffusion step
UNIFORM_PROB = 0.001  # share of the uniform law in the importance weights


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


def snr(sched: DiffusionSchedule, t: torch.Tensor) -> torch.Tensor:
    acp = sched.alphas_cumprod[t]
    return acp / (1.0 - acp)


def snr_weight(sched: DiffusionSchedule, ts: torch.Tensor) -> torch.Tensor:
    """The x0 loss's weight SNR(t-1) - SNR(t), 1 at t = 0 (where snr(t-1)
    is not read; clamping keeps the index valid)."""
    w = snr(sched, torch.clamp(ts - 1, min=0)) - snr(sched, ts)
    return torch.where(ts == 0, torch.ones_like(w), w)


def timestep_probs(state: Tuple[torch.Tensor, torch.Tensor], steps: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(probs (steps,), ready): importance weights sqrt(E[loss^2]) per step,
    mixed with ``UNIFORM_PROB`` of the uniform law, once every step has a
    full loss history (``ready``, a bool tensor); uniform before that."""
    lt_hist, lt_count = state
    ready = torch.all(lt_count >= HISTORY_PER_TERM)
    lt_sqrt = torch.sqrt(torch.mean(lt_hist ** 2, dim=1))
    pt_all = lt_sqrt / torch.clamp(torch.sum(lt_sqrt), min=1e-12)
    pt_all = pt_all * (1.0 - UNIFORM_PROB) + UNIFORM_PROB / steps
    uniform = torch.full((steps,), 1.0 / steps, device=lt_hist.device)
    return torch.where(ready, pt_all, uniform), ready


def sample_timesteps(state: Tuple[torch.Tensor, torch.Tensor], batch_size: int,
                     steps: int, generator: torch.Generator
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ts, pt): ``batch_size`` steps drawn from ``timestep_probs`` and the
    importance correction pt = probs[ts] * steps (1 while not ready)."""
    probs, ready = timestep_probs(state, steps)
    ts = torch.multinomial(probs, batch_size, replacement=True, generator=generator)
    pt = torch.where(ready, probs[ts] * steps, torch.ones_like(probs[ts]))
    return ts, pt


def update_lt_history(state: Tuple[torch.Tensor, torch.Tensor], ts: torch.Tensor,
                      reloss: torch.Tensor, weights: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Push one weighted-mean loss per sampled step into its circular buffer."""
    lt_hist, lt_count = state
    steps = lt_hist.shape[0]
    sums = torch.zeros(steps, device=reloss.device).index_add_(0, ts, reloss * weights)
    cnts = torch.zeros(steps, device=reloss.device).index_add_(0, ts, weights)
    present = cnts > 0
    mean_loss = sums / torch.clamp(cnts, min=1.0)
    shifted = torch.cat([lt_hist[:, 1:], mean_loss[:, None]], dim=1)
    appended = lt_hist.clone()
    rows = torch.arange(steps, device=lt_hist.device)
    appended[rows, torch.clamp(lt_count, max=HISTORY_PER_TERM - 1).long()] = mean_loss
    full = lt_count >= HISTORY_PER_TERM
    new_hist = torch.where(present[:, None],
                           torch.where(full[:, None], shifted, appended), lt_hist)
    new_count = torch.where(present, torch.clamp(lt_count + 1, max=HISTORY_PER_TERM),
                            lt_count)
    return new_hist, new_count


def loss_from_draws(sched: DiffusionSchedule,
                    denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                    x_start: torch.Tensor, state: Tuple[torch.Tensor, torch.Tensor],
                    weights: torch.Tensor, ts: torch.Tensor, pt: torch.Tensor,
                    noise: torch.Tensor):
    """``training_loss`` with its random draws (ts, pt, noise) given.
    Returns (loss, new_state, (x_t, ts, out))."""
    x_t = q_sample(sched, x_start, ts, noise) if sched.noise_scale != 0.0 else x_start
    out = denoise_fn(x_t, ts)
    mse = torch.mean((x_start - out) ** 2, dim=1)
    weight = snr_weight(sched, ts) if sched.noise_scale != 0.0 else torch.ones_like(mse)
    reloss = weight * mse
    new_state = update_lt_history(state, ts, reloss.detach(), weights)
    loss = torch.sum((reloss / pt) * weights) / torch.clamp(torch.sum(weights), min=1.0)
    return loss, new_state, (x_t, ts, out)


def training_loss(sched: DiffusionSchedule,
                  denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                  x_start: torch.Tensor, state: Tuple[torch.Tensor, torch.Tensor],
                  weights: torch.Tensor, generator: torch.Generator):
    """SNR-weighted x0 loss: (weighted-mean loss, new_state, aux).

    ``denoise_fn(x_t, ts) -> x0_hat``; ``weights`` weigh the batch rows.
    Draws the timesteps, then the noise, from ``generator``."""
    ts, pt = sample_timesteps(state, x_start.shape[0], sched.steps, generator)
    noise = torch.randn(x_start.shape, generator=generator, device=x_start.device,
                        dtype=x_start.dtype)
    return loss_from_draws(sched, denoise_fn, x_start, state, weights, ts, pt, noise)


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
