"""Raw-trajectory action diffuser, the CTG model family (port of
`cld_tpu/algos/diffuser.py`).

The diffusion variable is the scaled action sequence [B, T, 2]; the network
sees the whole scaled [B, T, 6] state + action trajectory, its states
re-integrated from the actions through the unicycle at every call, and
predicts the clean actions x0. Classifier-free guidance mixes conditional
and unconditional predictions in noise space; stationary agents' actions are
zeroed in descaled space; ancestral sampling may perturb the clean
prediction or the posterior mean with a guidance function.

Randomness is explicit, as in the port's other samplers: the loss takes its
timesteps, noise and conditioning-dropout draws, the sampler its initial
noise and per-step noises; what is not given is drawn from a
`torch.Generator`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from cld_tpu_torch.models.roi_encoder import query_feature_grid
from cld_tpu_torch.ops.diffusion import (
    DiffusionSchedule,
    extract,
    predict_start_from_noise,
    q_posterior_mean,
    q_sample,
)
from cld_tpu_torch.ops.dynamics import UnicycleParams, unicycle_forward_dynamics
from cld_tpu_torch.ops.geometry import transform_points
from cld_tpu_torch.ops.normalization import TrajNormalizer

DenoiseNet = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
# (traj_in [B, T, 6], cond_feat [B, C], t [B]) -> x0_hat actions [B, T, 2]


def predict_noise_from_start(schedule: DiffusionSchedule, x_t, t, x0):
    """The epsilon implied by (x_t, x0)."""
    return (extract(schedule.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t - x0) / extract(
        schedule.sqrt_recipm1_alphas_cumprod, t, x_t.ndim)


def q_posterior(schedule: DiffusionSchedule, x0, x_t, t):
    """(mean, log_var) of q(x_{t-1} | x_t, x0)."""
    mean = q_posterior_mean(schedule, x0, x_t, t)
    return mean, extract(schedule.posterior_log_variance_clipped, t, x_t.ndim)


def stationary_mask_from_speed(curr_speed: torch.Tensor, th: float = 0.5) -> torch.Tensor:
    """Agents whose |speed| is under `th` (the 'any_speed' criterion)."""
    return torch.abs(curr_speed) < th


def draw_loss_noise(n_timesteps: int, batch_size: int, horizon: int,
                    cond_drop_prob: float = 0.1, generator: Optional[torch.Generator] = None,
                    device="cuda"):
    """The loss's draws: timesteps t [B] in [0, n_timesteps), noise
    [B, T, 2], and which rows drop their conditioning, drop [B] bool."""
    t = torch.randint(0, n_timesteps, (batch_size,), generator=generator, device=device)
    noise = torch.randn((batch_size, horizon, 2), generator=generator, device=device)
    drop = torch.rand((batch_size,), generator=generator, device=device) < cond_drop_prob
    return t, noise, drop


class RawActionDiffuser:
    """Functional CTG-style diffuser over action sequences."""

    def __init__(self, net: DenoiseNet, schedule: DiffusionSchedule,
                 dyn_params: UnicycleParams, normalizer: Optional[TrajNormalizer] = None,
                 dt: float = 0.1):
        self.net = net
        self.schedule = schedule
        self.dyn = dyn_params
        self.normalizer = normalizer or TrajNormalizer()
        self.dt = dt

    def actions_to_traj(self, actions_scaled: torch.Tensor, curr_states: torch.Tensor):
        """Scaled actions -> the scaled [B, T, 6] network input."""
        actions = self.normalizer.descale(actions_scaled, [4, 5])
        states = unicycle_forward_dynamics(self.dyn, curr_states, actions, self.dt)
        return self.normalizer.scale(torch.cat([states, actions], dim=-1))

    def query_map_feats(self, traj_scaled, map_grid, grid_from_agent):
        """Per-step map features under the detached trajectory positions."""
        pos = self.normalizer.descale(traj_scaled[..., :2], [0, 1]).detach()
        return query_feature_grid(transform_points(pos, grid_from_agent), map_grid)

    def _x0_hat(self, x_actions, curr_states, cond_feat, t, class_free_guide_w=0.0,
                stationary_mask=None, map_grid=None, grid_from_agent=None):
        traj_in = self.actions_to_traj(x_actions, curr_states)
        if map_grid is not None:
            feats = self.query_map_feats(traj_in, map_grid, grid_from_agent)
            traj_in = torch.cat([traj_in, feats], dim=-1)
        x0 = self.net(traj_in, cond_feat, t)
        if class_free_guide_w != 0.0:
            x0_uncond = self.net(traj_in, torch.zeros_like(cond_feat), t)
            eps_c = predict_noise_from_start(self.schedule, x_actions, t, x0)
            eps_u = predict_noise_from_start(self.schedule, x_actions, t, x0_uncond)
            eps = (1 + class_free_guide_w) * eps_c - class_free_guide_w * eps_u
            x0 = predict_start_from_noise(self.schedule, x_actions, eps, t)
        if stationary_mask is not None:
            zero_scaled = self.normalizer.scale(torch.zeros_like(x0), [4, 5])
            x0 = torch.where(stationary_mask[:, None, None], zero_scaled, x0)
        return x0

    def loss(self, gt_traj_scaled: torch.Tensor, curr_states, cond_feat,
             t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
             drop: Optional[torch.Tensor] = None, cond_drop_prob: float = 0.1,
             map_grid=None, grid_from_agent=None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x0-prediction MSE on noised actions; the conditioning of the rows
        in `drop` is zeroed (classifier-free training). `t`, `noise` and
        `drop` are drawn (`draw_loss_noise`) when not all given."""
        actions0 = gt_traj_scaled[..., 4:6]
        if t is None or noise is None or drop is None:
            t, noise, drop = draw_loss_noise(self.schedule.n_timesteps, actions0.shape[0],
                                             actions0.shape[1], cond_drop_prob, generator,
                                             actions0.device)
        x_noisy = q_sample(self.schedule, actions0, t, noise)
        cond = torch.where(drop[:, None], torch.zeros_like(cond_feat), cond_feat)
        x0_hat = self._x0_hat(x_noisy, curr_states, cond, t, map_grid=map_grid,
                              grid_from_agent=grid_from_agent)
        return torch.mean((x0_hat - actions0) ** 2)

    def sample(self, curr_states: torch.Tensor, cond_feat: torch.Tensor, horizon: int,
               num_samp: int = 1, class_free_guide_w: float = 0.0,
               guidance_fn: Optional[Callable] = None, guide_clean: bool = True,
               stationary_mask: Optional[torch.Tensor] = None,
               map_grid: Optional[torch.Tensor] = None,
               grid_from_agent: Optional[torch.Tensor] = None,
               x_init: Optional[torch.Tensor] = None,
               step_noises: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Ancestral sampling over every step, n - 1 down to 0.
        `guidance_fn(x, t)` perturbs the clean prediction (`guide_clean`, the
        reference's default) or the posterior mean. `x_init` [B * N, T, 2]
        and `step_noises` [n, B * N, T, 2] (indexed by step, n - 1 first) are
        drawn from `generator` when not given. Returns descaled [B * N, T, 6]
        trajectories, the scaled actions and the repeated conditioning."""
        cond = torch.repeat_interleave(cond_feat, num_samp, dim=0)
        curr = torch.repeat_interleave(curr_states, num_samp, dim=0)
        stat = (None if stationary_mask is None
                else torch.repeat_interleave(stationary_mask, num_samp, dim=0))
        if map_grid is not None:
            map_grid = torch.repeat_interleave(map_grid, num_samp, dim=0)
            grid_from_agent = torch.repeat_interleave(grid_from_agent, num_samp, dim=0)
        BN, n = cond.shape[0], self.schedule.n_timesteps
        dev = cond.device
        x = (torch.randn((BN, horizon, 2), generator=generator, device=dev)
             if x_init is None else x_init)
        if step_noises is None:
            step_noises = torch.randn((n, BN, horizon, 2), generator=generator, device=dev)
        for k, i in enumerate(range(n - 1, -1, -1)):
            t = torch.full((BN,), i, dtype=torch.int64, device=dev)
            x0 = self._x0_hat(x, curr, cond, t, class_free_guide_w, stat, map_grid=map_grid,
                              grid_from_agent=grid_from_agent)
            if guidance_fn is not None and guide_clean:
                x0 = guidance_fn(x0, t)
            mean, log_var = q_posterior(self.schedule, x0, x, t)
            if guidance_fn is not None and not guide_clean:
                mean = guidance_fn(mean, t)
            x = mean + float(i != 0) * torch.exp(0.5 * log_var) * step_noises[k]
        actions = self.normalizer.descale(x, [4, 5])
        states = unicycle_forward_dynamics(self.dyn, curr, actions, self.dt)
        return {"trajectories": torch.cat([states, actions], dim=-1), "actions_scaled": x,
                "cond_feat": cond}
