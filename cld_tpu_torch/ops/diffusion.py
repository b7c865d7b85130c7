"""DDPM math: cosine schedule and the derived coefficient buffers (port of
`cld_tpu/ops/diffusion.py`). The schedule is computed in float64 on the
host and frozen into float32 tensors; the diffusion math stays float32."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


class DiffusionSchedule(NamedTuple):
    """The coefficient buffers the sampler reads; each is [n_timesteps] f32."""

    n_timesteps: int
    alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    # x0-parameterized posterior mean: mu = coef1 * x0 + coef2 * x_t
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    # epsilon-parameterized posterior mean: mu = x_t_cof * x_t - noise_cof * eps
    x_t_cof: torch.Tensor
    noise_cof: torch.Tensor
    # forward process: x_t = sqrt_alphas_cumprod * x0 + sqrt_one_minus_alphas_cumprod * eps
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor


def make_schedule(
    n_timesteps: int = 100, s: float = 0.008, device="cuda"
) -> DiffusionSchedule:
    betas = cosine_beta_schedule(n_timesteps, s=s)  # float64 host math
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    alphas_cumprod_prev = np.concatenate([np.ones(1), alphas_cumprod[:-1]])
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    return DiffusionSchedule(
        n_timesteps=int(n_timesteps),
        alphas_cumprod=f32(alphas_cumprod),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1.0)),
        posterior_log_variance_clipped=f32(
            np.log(np.clip(posterior_variance, 1e-20, None))
        ),
        posterior_mean_coef1=f32(betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
        posterior_mean_coef2=f32(
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
        ),
        x_t_cof=f32(np.sqrt(1.0 / alphas)),
        noise_cof=f32(betas / np.sqrt(alphas - alphas_cumprod * alphas)),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
    )


def extract(buf: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """buf[t] broadcast to an ndim-rank tensor: [B, 1, ..., 1]."""
    out = buf[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))


def q_sample(
    schedule: DiffusionSchedule, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor
) -> torch.Tensor:
    """Forward-noise x0 to step t."""
    return (
        extract(schedule.sqrt_alphas_cumprod, t, x0.ndim) * x0
        + extract(schedule.sqrt_one_minus_alphas_cumprod, t, x0.ndim) * noise
    )


def posterior_mean_logvar(
    schedule: DiffusionSchedule, x_t: torch.Tensor, eps_hat: torch.Tensor, t: torch.Tensor
):
    """Epsilon-parameterized reverse-step mean and log-variance."""
    mean = (
        extract(schedule.x_t_cof, t, x_t.ndim) * x_t
        - extract(schedule.noise_cof, t, eps_hat.ndim) * eps_hat
    )
    log_var = extract(schedule.posterior_log_variance_clipped, t, x_t.ndim)
    return mean, log_var


def predict_start_from_noise(
    schedule: DiffusionSchedule, x_t: torch.Tensor, eps: torch.Tensor, t: torch.Tensor
) -> torch.Tensor:
    """x0_hat from the epsilon prediction."""
    return (
        extract(schedule.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
        - extract(schedule.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * eps
    )


def q_posterior_mean(
    schedule: DiffusionSchedule, x0: torch.Tensor, x_t: torch.Tensor, t: torch.Tensor
) -> torch.Tensor:
    """Posterior mean q(x_{t-1} | x_t, x0) parameterized by the clean sample."""
    return (
        extract(schedule.posterior_mean_coef1, t, x0.ndim) * x0
        + extract(schedule.posterior_mean_coef2, t, x_t.ndim) * x_t
    )


def normal_log_prob(x: torch.Tensor, mean: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Elementwise Normal log-density."""
    var = sigma**2
    return -((x - mean) ** 2) / (2 * var) - torch.log(sigma) - 0.5 * np.log(2 * np.pi)
