"""Unicycle dynamics, cumsum form (port of `cld_tpu/ops/dynamics.py`).

State x = (pos_x, pos_y, vel, yaw); action u = (acc, yawvel). The
load-bearing quirks of the reference are kept: velocity is clipped AFTER
the cumulative sum, including v0; vbound stays at (-10, 30); the yaw-rate
bound is computed from the clipped earlier velocity and detached (the
reference computes it under `torch.no_grad()`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class UnicycleParams(NamedTuple):
    """Unicycle bounds; the defaults are the reference constructor's."""

    max_steer: float = 0.5
    max_yawvel: float = 8.0
    acce_lo: float = -6.0
    acce_hi: float = 4.0
    v_lo: float = -10.0
    v_hi: float = 30.0


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """jnp.clip(x, lo, hi) == minimum(maximum(x, lo), hi), with the same
    gradient at the bounds: maximum/minimum split an exact tie evenly, as
    JAX's do (torch.clamp would pass the whole gradient)."""
    lo_t = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi_t = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def unicycle_forward_dynamics(
    params: UnicycleParams,
    initial_states: torch.Tensor,
    actions: torch.Tensor,
    dt: float,
) -> torch.Tensor:
    """Integrate actions [..., T, 2] from initial_states [..., 4] into states
    [..., T, 4] (the reference's 'parallel' mode as cumulative sums)."""
    acc = actions[..., 0]
    yawvel = actions[..., 1]

    acc_clipped = _clip(acc, params.acce_lo, params.acce_hi)
    v0 = initial_states[..., 2:3]
    v_cum = v0 + torch.cumsum(acc_clipped * dt, dim=-1)
    v_full = torch.cat([v0, v_cum], dim=-1)  # [..., T+1]
    v_clipped = _clip(v_full, params.v_lo, params.v_hi)
    v_avg = 0.5 * (v_clipped[..., :-1] + v_clipped[..., 1:])
    v = v_clipped[..., 1:]
    v_earlier = v_clipped[..., :-1]

    av = torch.abs(v_earlier)
    yawbound = torch.minimum(
        params.max_steer * av, params.max_yawvel / torch.clamp(av, min=0.1)
    )
    yawbound = torch.clamp(yawbound, min=0.1).detach()
    yawvel_clipped = torch.minimum(torch.maximum(yawvel, -yawbound), yawbound)

    yaw0 = initial_states[..., 3:4]
    yaw_cum = yaw0 + torch.cumsum(yawvel_clipped * dt, dim=-1)
    yaw_full = torch.cat([yaw0, yaw_cum], dim=-1)
    yaw = yaw_full[..., 1:]
    yaw_earlier = yaw_full[..., :-1]

    vx = v_avg * torch.cos(yaw_earlier)
    vy = v_avg * torch.sin(yaw_earlier)
    x = initial_states[..., 0:1] + torch.cumsum(vx * dt, dim=-1)
    y = initial_states[..., 1:2] + torch.cumsum(vy * dt, dim=-1)
    return torch.stack([x, y, v, yaw], dim=-1)
