"""Perturbation guidance: gradient steering of the sampler (port of
`cld_tpu/guidance/perturbation.py:79-205`).

`perturb` runs `grad_steps` hand-rolled Adam updates on the
sampler's posterior mean, with the gradient of the guidance cost of its
decoded trajectory taken by `torch.autograd.grad`; the cumulative change is
clipped to `perturb_th`. `make_perturbation_guidance` builds the hook that
`algos.dm.sample_traj` calls at each guided denoise step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from cld_tpu_torch.guidance.losses import (
    GuidanceContext,
    MapCollisionLoss,
    masked_mean,
    prepack_drivable,
    prepack_map_bbox,
)


# Adam moments and epsilon (torch.optim.Adam's defaults, as the reference's)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class GuidanceSpec:
    """One guidance rule, applied to every agent: a loss callable + weight."""

    loss: Callable
    weight: float = 1.0


def compute_guidance_loss(
    x_traj: torch.Tensor, ctx: GuidanceContext, specs: Sequence[GuidanceSpec]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted sum of per-rule means over [B, N, T, 6] trajectories."""
    mask = torch.ones((x_traj.shape[0],), dtype=torch.bool, device=x_traj.device)
    total = torch.zeros((), dtype=x_traj.dtype, device=x_traj.device)
    per_losses: Dict[str, torch.Tensor] = {}
    for i, spec in enumerate(specs):
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
) -> torch.Tensor:
    """Adam descent on x of the guidance cost of its decoded trajectory;
    the cumulative change from x_initial is clipped to +-perturb_th (a float
    or a 0-dim tensor)."""
    b1, b2, eps = ADAM_B1, ADAM_B2, ADAM_EPS
    x_initial = x_initial.detach()
    x = x_initial
    m = torch.zeros_like(x_initial)
    v = torch.zeros_like(x_initial)
    for step in range(grad_steps):
        g = guidance_gradient(x, ctx, specs, decode_fn)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g**2
        m_hat = m / (1 - b1 ** (step + 1))
        v_hat = v / (1 - b2 ** (step + 1))
        x = x - lr * m_hat / (torch.sqrt(v_hat) + eps)
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
    mean, t the python int timestep. The packed drivable map and the bbox
    grid are prepared here, once, out of the sampling loop."""
    ctx = prepack_drivable(ctx)
    grids = {s.loss.num_points_lw for s in specs if isinstance(s.loss, MapCollisionLoss)}
    if len(grids) > 1:
        raise ValueError(
            "multiple MapCollisionLoss specs with different num_points_lw "
            f"{sorted(grids)}: the context carries one prepacked grid"
        )
    if grids:
        ctx = prepack_map_bbox(ctx, grids.pop())

    def guidance_fn(mean: torch.Tensor, t: int) -> torch.Tensor:
        step_lr, th = guidance_opt_schedule(
            t, lr=lr, perturb_th=perturb_th,
            sigma_schedule=sigma_schedule, n_timesteps=n_timesteps,
        )
        return perturb(mean, ctx, specs, decode_fn, lr=step_lr,
                       grad_steps=grad_steps, perturb_th=th)

    return guidance_fn
