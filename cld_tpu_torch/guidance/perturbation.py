"""Perturbation guidance: gradient steering of the sampler, and sample
selection (port of `cld_tpu/guidance/perturbation.py`).

`perturb` runs `grad_steps` hand-rolled Adam (or SGD) updates on the
sampler's posterior mean, with the gradient of the guidance cost of its
decoded trajectory taken by `torch.autograd.grad`; the cumulative change is
clipped to `perturb_th`. `make_perturbation_guidance` builds the hook that
`algos.dm.sample_traj` calls at each guided denoise step.
`per_sample_guidance_loss`, `choose_best_sample` and `choose_closest_to_gt`
pick one of `num_samp` > 1 samples per agent.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from cld_tpu_torch.guidance.losses import (
    AgentCollisionLoss,
    CollisionAttackLoss,
    GuidanceContext,
    KeepDistanceLoss,
    MapCollisionLoss,
    masked_mean,
    prepack_drivable,
    prepack_map_bbox,
    SocialGroupLoss,
)


# Adam moments and epsilon (torch.optim.Adam's defaults, as the reference's)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class GuidanceSpec:
    """One guidance rule: a loss callable + weight + optional static agent
    mask ([B] bools, None = every agent)."""

    loss: Callable
    weight: float = 1.0
    agent_mask: Optional[Tuple[bool, ...]] = None


def compute_guidance_loss(
    x_traj: torch.Tensor, ctx: GuidanceContext, specs: Sequence[GuidanceSpec]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted sum of per-rule masked means over [B, N, T, 6] trajectories.
    An agent-indexed rule (one with `affected_agents`: keep distance,
    collision attack, social group) is meant over its own agents only, as
    the reference means each rule over the agents it writes: a mean over all
    B would dilute its gradient by B / n_affected against the other rules."""
    B = x_traj.shape[0]
    total = torch.zeros((), dtype=x_traj.dtype, device=x_traj.device)
    per_losses: Dict[str, torch.Tensor] = {}
    for i, spec in enumerate(specs):
        mask = np.ones(B, bool) if spec.agent_mask is None else np.asarray(spec.agent_mask, bool)
        affected = getattr(spec.loss, "affected_agents", None)
        if callable(affected):
            aff = np.zeros(B, bool)
            aff[np.asarray(affected(), int)] = True
            mask = mask & aff
        mask = torch.as_tensor(mask, device=x_traj.device)
        cur = spec.loss(x_traj, ctx, agt_mask=mask)  # [B, N]
        per_losses[f"{type(spec.loss).__name__}_{i}"] = cur
        total = total + masked_mean(cur, mask) * spec.weight
    return total, per_losses


def guidance_gradient(
    x: torch.Tensor,
    ctx: GuidanceContext,
    specs: Sequence[GuidanceSpec],
    decode_fn: Callable[[torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """d cost / d x of the guidance cost of decode_fn(x)."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        total, _ = compute_guidance_loss(decode_fn(xg), ctx, specs)
        (g,) = torch.autograd.grad(total, xg)
    return g


def perturb(
    x_initial: torch.Tensor,
    ctx: GuidanceContext,
    specs: Sequence[GuidanceSpec],
    decode_fn: Callable[[torch.Tensor], torch.Tensor],
    lr: float = 0.3,
    grad_steps: int = 1,
    perturb_th=None,
    optimizer: str = "adam",
) -> torch.Tensor:
    """Adam (or plain SGD, `optimizer="sgd"`) descent on x of the guidance
    cost of its decoded trajectory; the cumulative change from x_initial is
    clipped to +-perturb_th (a float or a 0-dim tensor)."""
    if optimizer not in ("adam", "sgd"):
        raise NotImplementedError(optimizer)
    b1, b2, eps = ADAM_B1, ADAM_B2, ADAM_EPS
    x_initial = x_initial.detach()
    x = x_initial
    m = torch.zeros_like(x_initial)
    v = torch.zeros_like(x_initial)
    for step in range(grad_steps):
        g = guidance_gradient(x, ctx, specs, decode_fn)
        if optimizer == "adam":
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g**2
            m_hat = m / (1 - b1 ** (step + 1))
            v_hat = v / (1 - b2 ** (step + 1))
            x = x - lr * m_hat / (torch.sqrt(v_hat) + eps)
        else:
            x = x - lr * g
        if perturb_th is not None:
            th = torch.as_tensor(perturb_th, dtype=x.dtype, device=x.device)
            delta = torch.minimum(torch.maximum(x - x_initial, -th), th)
            x = x_initial + delta
    return x


def guidance_opt_schedule(
    t: int,
    *,
    lr: Optional[float],
    perturb_th: Optional[float],
    sigma_schedule: Optional[torch.Tensor],
    n_timesteps: Optional[int],
):
    """Per-step (step_lr, perturb_th): perturb_th None -> the posterior sigma
    at t; an explicit perturb_th with n_timesteps -> sigmoid decay from ~4 to
    perturb_th; lr None -> lr = sigma."""
    if perturb_th is None:
        th = None if sigma_schedule is None else sigma_schedule[t]
    elif n_timesteps is not None:
        tf = torch.tensor(float(t), dtype=torch.float32)
        sig_scale = (torch.sigmoid(10.0 * tf / n_timesteps) - 0.5) * 2.0
        th = sig_scale * (4.0 - perturb_th) + perturb_th
    else:
        th = perturb_th
    step_lr = lr
    if step_lr is None:
        if sigma_schedule is None:
            raise ValueError("lr=None needs a sigma_schedule (lr = sigma)")
        step_lr = sigma_schedule[t]
    return step_lr, th


def make_perturbation_guidance(
    ctx: GuidanceContext,
    specs: Sequence[GuidanceSpec],
    decode_fn: Callable[[torch.Tensor], torch.Tensor],
    lr: Optional[float] = 0.3,
    grad_steps: int = 1,
    perturb_th: Optional[float] = None,
    sigma_schedule: Optional[torch.Tensor] = None,
    n_timesteps: Optional[int] = None,
) -> Callable[[torch.Tensor, int], torch.Tensor]:
    """The guidance hook of `sample_traj`: (posterior_mean, t) -> perturbed
    mean, t the python int timestep. The packed drivable map, the bbox grid
    and (when a rigid or pairwise `min_dist_impl` will read it) the [B, P, P]
    distance cache are prepared here, once, out of the sampling loop."""
    ctx = prepack_drivable(ctx)
    map_specs = [s for s in specs if isinstance(s.loss, MapCollisionLoss)]
    if map_specs:
        grids = {s.loss.num_points_lw for s in map_specs}
        if len(grids) > 1:
            raise ValueError(
                "multiple MapCollisionLoss specs with different num_points_lw "
                f"{sorted(grids)}: prepacking supports one grid per context - unify the "
                "specs' num_points_lw"
            )
        need_d2 = any(
            s.loss.min_dist_impl not in ("separable", "separable_xy", "separable_xy_bf16")
            for s in map_specs
        )
        ctx = prepack_map_bbox(ctx, map_specs[0].loss.num_points_lw, with_d2=need_d2)

    def guidance_fn(mean: torch.Tensor, t: int) -> torch.Tensor:
        step_lr, th = guidance_opt_schedule(
            t, lr=lr, perturb_th=perturb_th,
            sigma_schedule=sigma_schedule, n_timesteps=n_timesteps,
        )
        return perturb(mean, ctx, specs, decode_fn, lr=step_lr,
                       grad_steps=grad_steps, perturb_th=th)

    return guidance_fn


def per_sample_guidance_loss(
    x_traj: torch.Tensor, ctx: GuidanceContext, specs: Sequence[GuidanceSpec]
) -> torch.Tensor:
    """Total weighted guidance loss per (agent, sample): [B, N, T, 6] ->
    [B, N], the filtration score. Agents outside a rule's mask contribute 0
    for that rule."""
    B, N = x_traj.shape[:2]
    total = torch.zeros((B, N), dtype=x_traj.dtype, device=x_traj.device)
    for spec in specs:
        cur = spec.loss(x_traj, ctx, agt_mask=None)  # [B, N]
        if spec.agent_mask is not None:
            keep = torch.as_tensor(spec.agent_mask, dtype=torch.bool, device=cur.device)
            cur = torch.where(keep[:, None], cur, torch.zeros_like(cur))
        total = total + spec.weight * cur
    return total


def _take_sample(samples: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """samples [B, N, ...], idx [B] -> samples[b, idx[b]] as [B, ...]."""
    return samples[torch.arange(samples.shape[0], device=samples.device), idx]


def choose_closest_to_gt(
    samples: torch.Tensor,
    positions: torch.Tensor,
    gt_positions: torch.Tensor,
    gt_avail: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pick the sample whose positions are closest to the ground-truth
    future: availability-masked mean Euclidean error; agents with no valid
    ground truth keep sample 0.

    samples [B, N, ...], positions [B, N, T, 2], gt_positions [B, T, 2],
    gt_avail [B, T] -> ([B, ...], [B] indices)."""
    av = gt_avail.to(positions.dtype)
    err = torch.linalg.norm(positions - gt_positions[:, None], dim=-1)  # [B, N, T]
    n_av = torch.sum(av, dim=-1)
    ade = torch.sum(err * av[:, None], dim=-1) / torch.clamp(n_av, min=1.0)[:, None]  # [B, N]
    idx = torch.where(n_av > 0, torch.argmin(ade, dim=-1), torch.zeros_like(n_av, dtype=torch.long))
    return _take_sample(samples, idx), idx


def choose_best_sample(
    samples: torch.Tensor,
    guide_losses: torch.Tensor,
    scene_index: Optional[torch.Tensor] = None,
    scene_level: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Filtration: pick the sample with the lowest total guidance loss, per
    agent. With `scene_level` (a scene-coupled rule is active) each scene
    picks one shared sample index by the argmin of the agent-summed loss:
    pair losses score sample n as if every agent of the scene played sample
    n, so independent picks would execute combinations that were never
    scored.

    samples [B, N, ...], guide_losses [B, N], scene_index [B] int ->
    ([B, ...], [B] indices)."""
    if scene_level and scene_index is not None:
        per_scene = torch.zeros_like(guide_losses).index_add_(0, scene_index.long(), guide_losses)
        idx = torch.argmin(per_scene, dim=-1)[scene_index.long()]  # [B]
    else:
        idx = torch.argmin(guide_losses, dim=-1)  # [B]
    return _take_sample(samples, idx), idx


def is_scene_level_spec(spec: GuidanceSpec) -> bool:
    """Whether the rule's per-sample loss couples the agents of a scene, so
    that filtration must share one sample index per scene: agent collision,
    social group, collision attack and keep distance."""
    return isinstance(spec.loss, (AgentCollisionLoss, CollisionAttackLoss, KeepDistanceLoss,
                                  SocialGroupLoss))
