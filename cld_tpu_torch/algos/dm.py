"""Latent DDPM ancestral sampling (port of `cld_tpu/algos/dm.py:54-160`).

`sample_traj` takes its randomness explicitly: `x_init` [BN, T, D] and
`step_noises` [n_steps, BN, T, D], where step k of the loop (timestep
i = n - 1 - k) adds noise index k. Whatever is not given is drawn from
`generator`. Tests hand both sides the same tensors, drawn with jax.random
under the JAX sampler's own key schedule.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from cld_tpu_torch.ops.diffusion import (
    DiffusionSchedule,
    normal_log_prob,
    posterior_mean_logvar,
)

DenoiseFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
# (x [BN, T, D], cond_feat [BN, C], t [BN]) -> eps_hat [BN, T, D]


@torch.no_grad()
def sample_traj(
    denoise_fn: DenoiseFn,
    schedule: DiffusionSchedule,
    cond_feat: torch.Tensor,
    horizon: int,
    latent_size: int,
    guidance_fn: Optional[Callable[[torch.Tensor, int], torch.Tensor]] = None,
    x_init: Optional[torch.Tensor] = None,
    step_noises: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """Full ancestral sampling. guidance_fn(mean, t) perturbs the posterior
    mean at every step except the last (t = 0), the config of record.

    One sample per conditioning row (`num_samp` 1, the config of record).
    Returns pred_traj [B, T, D] (x_0), x1 [B, T, D] (state after the t = 1
    transition), log_prob_final [B] and cond_feat [B, C]."""
    dev = cond_feat.device
    cond = cond_feat
    BN = cond.shape[0]
    n = schedule.n_timesteps
    shape = (BN, horizon, latent_size)
    if x_init is None:
        x_init = torch.randn(shape, generator=generator, device=dev)
    if step_noises is None:
        step_noises = torch.randn((n,) + shape, generator=generator, device=dev)

    x = x_init.to(torch.float32)
    x1 = torch.zeros_like(x)
    logp = torch.zeros((BN,), dtype=torch.float32, device=dev)
    for k in range(n):
        i = n - 1 - k
        t = torch.full((BN,), i, dtype=torch.long, device=dev)
        eps_hat = denoise_fn(x, cond, t)
        mean, log_var = posterior_mean_logvar(schedule, x, eps_hat, t)
        if guidance_fn is not None and i != 0:
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
