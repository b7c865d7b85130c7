"""Scene-centric diffusion: joint denoising of every agent of a scene (port
of `cld_tpu/algos/scene_dm.py`). Diffusion over [B, A, T, D] scene tensors
with a transformer denoiser (`models.scene_transformer`), padding agents
masked throughout. The draws are explicit: the loss's timesteps and noise,
the sampler's initial x and per-step noise are arguments (`draw_scene_loss_noise`,
`draw_scene_sample_noise` make them from a `torch.Generator`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from cld_tpu_torch.ops.diffusion import DiffusionSchedule, posterior_mean_logvar, q_sample

# (x [B, A, T, D], cond [B, A, C], t [B], agent_mask [B, A]) -> eps_hat
SceneDenoiseFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def draw_scene_loss_noise(n_timesteps: int, shape, generator: Optional[torch.Generator] = None,
                          device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """(t [B] uniform in [0, n_timesteps), noise of `shape` = [B, A, T, D])."""
    t = torch.randint(0, n_timesteps, (shape[0],), generator=generator, device=device)
    return t, torch.randn(shape, generator=generator, device=device)


def draw_scene_sample_noise(n_timesteps: int, shape, generator: Optional[torch.Generator] = None,
                            device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_init of `shape` = [B, A, T, D], step_noises [n_timesteps, *shape]),
    standard normal; step_noises[k] is the noise of the k-th step taken."""
    x = torch.randn(shape, generator=generator, device=device)
    return x, torch.randn((n_timesteps, *shape), generator=generator, device=device)


def scene_dm_loss(denoise_fn: SceneDenoiseFn, schedule: DiffusionSchedule, x0: torch.Tensor,
                  cond_feat: torch.Tensor, agent_mask: torch.Tensor, t: torch.Tensor,
                  noise: torch.Tensor) -> torch.Tensor:
    """The masked epsilon MSE over the scene tensor x0 [B, A, T, D] at
    timesteps t [B] with `noise` of x0's shape."""
    x_noisy = q_sample(schedule, x0, t, noise)
    eps_hat = denoise_fn(x_noisy, cond_feat, t, agent_mask)
    w = agent_mask[..., None, None].to(x0.dtype)
    return torch.sum(w * (noise - eps_hat) ** 2) / torch.clamp(
        torch.sum(w) * x0.shape[-2] * x0.shape[-1], min=1.0)


def scene_sample(denoise_fn: SceneDenoiseFn, schedule: DiffusionSchedule, cond_feat: torch.Tensor,
                 agent_mask: torch.Tensor, x_init: torch.Tensor, step_noises: torch.Tensor,
                 guidance_fn: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """Ancestral sampling of scene tensors from x_init [B, A, T, D], steps
    n-1 .. 0, step k adding step_noises[k] scaled by the posterior sigma
    (the last adds none); `guidance_fn(mean, t)` may move each step's mean.
    Padding agents are zeroed after every step."""
    B = cond_feat.shape[0]
    x = x_init
    n = schedule.n_timesteps
    keep = agent_mask[..., None, None]
    for k, i in enumerate(range(n - 1, -1, -1)):
        t = torch.full((B,), i, dtype=torch.long, device=x.device)
        eps_hat = denoise_fn(x, cond_feat, t, agent_mask)
        mean, log_var = posterior_mean_logvar(schedule, x, eps_hat, t)
        if guidance_fn is not None:
            mean = guidance_fn(mean, t)
        if i != 0:
            mean = mean + torch.exp(0.5 * log_var) * step_noises[k]
        x = mean.to(torch.float32) * keep
    return {"pred_traj": x}
