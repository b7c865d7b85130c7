"""Latent diffusion: the training loss, DDPM ancestral sampling, DDIM and the
transition log-probability (port of `cld_tpu/algos/dm.py`).

Both samplers take their randomness explicitly: `x_init` [BN, T, D] and
`step_noises` [n_steps, BN, T, D], where step k of the loop adds noise index
k (for DDPM, timestep i = n - 1 - k). Whatever is not given is drawn from
`generator`. Tests hand both sides the same tensors, drawn with jax.random
under the JAX samplers' own key schedule. BN = B * num_samp, each
conditioning row repeated `num_samp` times in place (row b's samples are
rows b * num_samp ... b * num_samp + num_samp - 1).

Under bf16 network compute the denoiser's output is taken to float32 before
any diffusion math: latents, noise, the posterior mean and sigma and the
log-probabilities stay float32, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from cld_tpu_torch.ops.diffusion import (
    DiffusionSchedule,
    normal_log_prob,
    posterior_mean_logvar,
    predict_start_from_noise,
    q_posterior_mean,
    q_sample,
)

DenoiseFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
# (x [BN, T, D], cond_feat [BN, C], t [BN]) -> eps_hat [BN, T, D]


def dm_loss(
    denoise_fn: DenoiseFn,
    schedule: DiffusionSchedule,
    z0: torch.Tensor,
    cond_feat: torch.Tensor,
    t: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Epsilon-prediction MSE at the timesteps `t` [B] (int64) with the
    Gaussian `noise` (z0's shape); whatever is not given is drawn from
    `generator`: t uniformly below the schedule's length."""
    z0 = z0.to(torch.float32)
    if t is None:
        t = torch.randint(0, schedule.n_timesteps, (z0.shape[0],), generator=generator,
                          device=z0.device)
    if noise is None:
        noise = torch.randn(z0.shape, generator=generator, device=z0.device)
    z_noisy = q_sample(schedule, z0, t, noise)
    eps_hat = denoise_fn(z_noisy, cond_feat, t).to(torch.float32)
    return torch.mean((noise - eps_hat) ** 2)


def transition_log_prob(
    denoise_fn: DenoiseFn,
    schedule: DiffusionSchedule,
    x_t: torch.Tensor,
    x_t_minus_1: torch.Tensor,
    cond_feat: torch.Tensor,
    t: torch.Tensor,
) -> torch.Tensor:
    """log p(x_{t-1} | x_t) under the denoiser, mean over elements -> [B]:
    the PPO ratio's numerator."""
    eps_hat = denoise_fn(x_t, cond_feat, t).to(torch.float32)
    mean, log_var = posterior_mean_logvar(schedule, x_t, eps_hat, t)
    sigma = torch.exp(0.5 * log_var)
    return torch.mean(normal_log_prob(x_t_minus_1, mean, sigma), dim=(1, 2))


def guidance_applies(i: int, guidance_stride: int = 1, guidance_output: bool = False) -> bool:
    """Whether `sample_traj` calls its guidance hook at timestep i: with a
    stride k at every k-th timestep and at the last ones (i < k); at i = 0
    only with `guidance_output`."""
    apply = guidance_stride <= 1 or i % guidance_stride == 0 or i < guidance_stride
    return apply and (guidance_output or i != 0)


def _noise(shape, n_steps, x_init, step_noises, generator, dev):
    if x_init is None:
        x_init = torch.randn(shape, generator=generator, device=dev)
    if step_noises is None:
        step_noises = torch.randn((n_steps,) + shape, generator=generator, device=dev)
    if tuple(x_init.shape) != shape or tuple(step_noises.shape) != (n_steps,) + shape:
        raise ValueError(
            f"x_init {tuple(x_init.shape)} / step_noises {tuple(step_noises.shape)}: expected "
            f"{shape} and {(n_steps,) + shape}"
        )
    return x_init.to(torch.float32), step_noises


@torch.no_grad()
def sample_traj(
    denoise_fn: DenoiseFn,
    schedule: DiffusionSchedule,
    cond_feat: torch.Tensor,
    horizon: int,
    latent_size: int,
    num_samp: int = 1,
    guidance_fn: Optional[Callable[[torch.Tensor, int], torch.Tensor]] = None,
    guidance_stride: int = 1,
    guidance_clean: bool = False,
    guidance_output: bool = False,
    x_init: Optional[torch.Tensor] = None,
    step_noises: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """Full ancestral sampling.

    cond_feat [B, C] is repeated to [B * num_samp, C]. guidance_fn(mean, t)
    perturbs the posterior mean at the timesteps `guidance_applies` names:
    every step but the last by default; with `guidance_stride` k only every
    k-th step and the final ones (t < k); with `guidance_output` the last
    step (t = 0) too. With `guidance_clean` the hook perturbs the clean x0
    reconstruction instead, and the posterior mean is rebuilt from the
    guided x0.

    Returns pred_traj [BN, T, D] (x_0), x1 [BN, T, D] (state after the t = 1
    transition), log_prob_final [BN] and cond_feat [BN, C]."""
    dev = cond_feat.device
    cond = cond_feat.repeat_interleave(num_samp, dim=0) if num_samp > 1 else cond_feat
    BN = cond.shape[0]
    n = schedule.n_timesteps
    x, step_noises = _noise((BN, horizon, latent_size), n, x_init, step_noises, generator, dev)

    x1 = torch.zeros_like(x)
    logp = torch.zeros((BN,), dtype=torch.float32, device=dev)
    for k in range(n):
        i = n - 1 - k
        t = torch.full((BN,), i, dtype=torch.long, device=dev)
        eps_hat = denoise_fn(x, cond, t).to(torch.float32)
        mean, log_var = posterior_mean_logvar(schedule, x, eps_hat, t)
        if guidance_fn is not None and guidance_applies(i, guidance_stride, guidance_output):
            if guidance_clean:
                x0_g = guidance_fn(predict_start_from_noise(schedule, x, eps_hat, t), i)
                mean = q_posterior_mean(schedule, x0_g, x, t)
            else:
                mean = guidance_fn(mean, i)
        sigma = torch.exp(0.5 * log_var)
        nonzero = float(i != 0)
        x_next = mean + nonzero * sigma * step_noises[k]
        if i == 1:
            x1 = x_next
        if i == 0:
            logp = torch.mean(normal_log_prob(x_next, mean, sigma), dim=(1, 2))
        x = x_next
    return {"pred_traj": x, "x1": x1, "log_prob_final": logp, "cond_feat": cond}


def ddim_timesteps(n_timesteps: int, num_steps: int) -> np.ndarray:
    """The strided timestep subsequence n - 1 ... 0 with `num_steps`
    entries: linspace rounded half to even, computed on the host."""
    return np.linspace(n_timesteps - 1, 0, num_steps, dtype=np.float32).round().astype(np.int64)


@torch.no_grad()
def sample_traj_ddim(
    denoise_fn: DenoiseFn,
    schedule: DiffusionSchedule,
    cond_feat: torch.Tensor,
    horizon: int,
    latent_size: int,
    num_samp: int = 1,
    num_steps: int = 50,
    eta: float = 0.0,
    guidance_fn: Optional[Callable[[torch.Tensor, int], torch.Tensor]] = None,
    x_init: Optional[torch.Tensor] = None,
    step_noises: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """DDIM sampling (Song et al.) over `ddim_timesteps`; deterministic at
    eta = 0. The guidance hook runs at every step, the last included.
    `step_noises` is [num_steps, BN, T, D]. Returns pred_traj [BN, T, D] and
    cond_feat [BN, C]."""
    dev = cond_feat.device
    cond = cond_feat.repeat_interleave(num_samp, dim=0) if num_samp > 1 else cond_feat
    BN = cond.shape[0]
    x, step_noises = _noise((BN, horizon, latent_size), num_steps, x_init, step_noises,
                            generator, dev)
    ts = ddim_timesteps(schedule.n_timesteps, num_steps)
    ts_prev = np.concatenate([ts[1:], [-1]])
    abar = schedule.alphas_cumprod
    one = torch.ones((), dtype=abar.dtype, device=abar.device)
    for k, (t_i, t_prev) in enumerate(zip(ts.tolist(), ts_prev.tolist())):
        t = torch.full((BN,), t_i, dtype=torch.long, device=dev)
        eps_hat = denoise_fn(x, cond, t).to(torch.float32)
        a_t = abar[t_i]
        a_prev = abar[t_prev] if t_prev >= 0 else one
        x0_hat = (x - torch.sqrt(1 - a_t) * eps_hat) / torch.sqrt(a_t)
        sigma = eta * torch.sqrt((1 - a_prev) / (1 - a_t)) * torch.sqrt(1 - a_t / a_prev)
        dir_xt = torch.sqrt(torch.clamp(1 - a_prev - sigma**2, min=0.0)) * eps_hat
        mean = torch.sqrt(a_prev) * x0_hat + dir_xt
        if guidance_fn is not None:
            mean = guidance_fn(mean, t_i)
        nonzero = float(t_prev >= 0)
        x = mean + nonzero * sigma * step_noises[k]
    return {"pred_traj": x, "cond_feat": cond}
