"""Vehicle dynamics beyond the unicycle (port of `cld_tpu/ops/dynamics_extra.py`):
the no-reverse bicycle and the single and double integrators, shape
polymorphic over leading batch dims. Clips are `torch.minimum` /
`torch.maximum`, which split an exact tie's gradient as `jnp.clip` does.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from cld_tpu_torch.ops.dynamics import _clip


class BicycleParams(NamedTuple):
    """Bicycle bounds. State [..., 6] = (x, y, h, speed, hdot, veh_length);
    action (acc, ddh)."""

    acc_lo: float = -10.0
    acc_hi: float = 8.0
    ddh_lo: float = -2 * math.pi
    ddh_hi: float = 2 * math.pi
    max_speed: float = 50.0
    max_hdot: float = 2 * math.pi


def bicycle_step(
    params: BicycleParams, x: torch.Tensor, u: torch.Tensor, dt: float, normalize: bool = True
) -> torch.Tensor:
    """One no-reverse bicycle step. `normalize` maps raw network outputs
    through a sigmoid onto the control bounds; otherwise they are clipped."""
    if normalize:
        s = torch.sigmoid(u)
        acc = params.acc_lo + (params.acc_hi - params.acc_lo) * s[..., 0]
        ddh = params.ddh_lo + (params.ddh_hi - params.ddh_lo) * s[..., 1]
    else:
        acc = _clip(u[..., 0], params.acc_lo, params.acc_hi)
        ddh = _clip(u[..., 1], params.ddh_lo, params.ddh_hi)

    veh_len = x[..., 5]
    new_hdot = _clip(x[..., 4] + ddh * dt, -params.max_hdot, params.max_hdot)
    new_h = x[..., 2] + dt * torch.abs(x[..., 3]) / veh_len * new_hdot
    new_s = _clip(x[..., 3] + acc * dt, 0.0, params.max_speed)  # no reverse
    new_x = x[..., 0] + new_s * torch.cos(new_h) * dt
    new_y = x[..., 1] + new_s * torch.sin(new_h) * dt
    return torch.stack([new_x, new_y, new_h, new_s, new_hdot, veh_len], dim=-1)


def bicycle_state2pos(x: torch.Tensor) -> torch.Tensor:
    return x[..., :2]


def bicycle_state2yaw(x: torch.Tensor) -> torch.Tensor:
    return x[..., 2:3]


class SingleIntegratorParams(NamedTuple):
    """Velocity bounds per dim: [D, 2]."""

    vbound: Tuple[Tuple[float, float], ...] = ((-30.0, 30.0), (-30.0, 30.0))


def single_integrator_step(
    params: SingleIntegratorParams, x: torch.Tensor, u: torch.Tensor, dt: float,
    bound: bool = True,
) -> torch.Tensor:
    """x' = x + u dt with per-dim velocity clipping."""
    if bound:
        vb = torch.as_tensor(params.vbound, dtype=u.dtype, device=u.device)
        u = torch.minimum(torch.maximum(u, vb[:, 0]), vb[:, 1])
    return x + u * dt


class DoubleIntegratorParams(NamedTuple):
    """Acceleration (and optional velocity) bounds per dim."""

    abound: Tuple[Tuple[float, float], ...] = ((-8.0, 8.0), (-8.0, 8.0))
    vbound: Optional[Tuple[Tuple[float, float], ...]] = None


def double_integrator_step(
    params: DoubleIntegratorParams, x: torch.Tensor, u: torch.Tensor, dt: float,
    bound: bool = True,
) -> torch.Tensor:
    """State [..., 4] = (px, py, vx, vy); midpoint position update. With
    `vbound` set, an acceleration that would push the velocity past its
    bound is zeroed (the reference's gated bounds)."""
    if bound:
        ab = torch.as_tensor(params.abound, dtype=u.dtype, device=u.device)
        if params.vbound is None:
            lb, ub = ab[:, 0], ab[:, 1]
        else:
            vb = torch.as_tensor(params.vbound, dtype=u.dtype, device=u.device)
            lb = (x[..., 2:] > vb[:, 0]) * ab[:, 0]
            ub = (x[..., 2:] < vb[:, 1]) * ab[:, 1]
        u = torch.minimum(torch.maximum(u, lb), ub)
    pos = x[..., 0:2] + (x[..., 2:4] + 0.5 * u * dt) * dt
    vel = x[..., 2:4] + u * dt
    return torch.cat([pos, vel], dim=-1)
