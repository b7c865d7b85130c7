"""Unicycle dynamics, cumsum form (port of `cld_tpu/ops/dynamics.py`).

State x = (pos_x, pos_y, vel, yaw); action u = (acc, yawvel). The
load-bearing quirks of the reference are kept: velocity is clipped AFTER
the cumulative sum, including v0; vbound stays at (-10, 30); the yaw-rate
bound is computed from the clipped earlier velocity and detached (the
reference computes it under `torch.no_grad()`).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch


class UnicycleParams(NamedTuple):
    """Unicycle bounds; the defaults are the reference constructor's."""

    max_steer: float = 0.5
    max_yawvel: float = 8.0
    acce_lo: float = -6.0
    acce_hi: float = 4.0
    v_lo: float = -10.0
    v_hi: float = 30.0

    @classmethod
    def from_config(cls, dyn_cfg) -> "UnicycleParams":
        """From a config's `algo.dynamics` mapping."""
        return cls(
            max_steer=float(dyn_cfg["max_steer"]),
            max_yawvel=float(dyn_cfg["max_yawvel"]),
            acce_lo=float(dyn_cfg["acce_bound"][0]),
            acce_hi=float(dyn_cfg["acce_bound"][1]),
        )


# bounds of the config of record (`cld_tpu/utils/config.py` algo.dynamics), which
# are also the simulator's defaults (`cld_tpu/sim/env.py` SimConfig.dyn)
RECORD_DYNAMICS = UnicycleParams(
    max_steer=0.5, max_yawvel=2 * math.pi, acce_lo=-10.0, acce_hi=8.0
)


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """jnp.clip(x, lo, hi) == minimum(maximum(x, lo), hi), with the same
    gradient at the bounds: maximum/minimum split an exact tie evenly, as
    JAX's do (torch.clamp would pass the whole gradient)."""
    lo_t = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi_t = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def unicycle_ubound(params: UnicycleParams, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Speed-dependent action bounds (lb, ub) [..., 2] for states x [..., 4]:
    the yaw-rate bound is min(max_steer |v|, max_yawvel / max(|v|, 0.1))
    floored at 0.1; the acceleration bound keeps the velocity inside
    (v_lo, v_hi) while staying inside (acce_lo, acce_hi)."""
    v = x[..., 2:3]
    av = torch.abs(v)
    yawbound = torch.minimum(params.max_steer * av, params.max_yawvel / torch.clamp(av, min=0.1))
    yawbound = torch.clamp(yawbound, min=0.1)
    acce_lb = torch.clamp(torch.clamp(params.v_lo - v, max=params.acce_hi), min=params.acce_lo)
    acce_ub = torch.clamp(torch.clamp(params.v_hi - v, min=params.acce_lo), max=params.acce_hi)
    return torch.cat([acce_lb, -yawbound], dim=-1), torch.cat([acce_ub, yawbound], dim=-1)


def unicycle_step(
    params: UnicycleParams, x: torch.Tensor, u: torch.Tensor, dt: float, bound: bool = True
) -> torch.Tensor:
    """One midpoint-integration step of states x [..., 4] under actions
    u [..., 2]; `bound` clips u to the (detached) `unicycle_ubound`."""
    if bound:
        lb, ub = unicycle_ubound(params, x)
        u = torch.minimum(torch.maximum(u, lb.detach()), ub.detach())
    theta = x[..., 3:4]
    v_mid = x[..., 2:3] + u[..., 0:1] * dt * 0.5
    dxdt = torch.cat([torch.cos(theta) * v_mid, torch.sin(theta) * v_mid, u], dim=-1)
    return x + dxdt * dt


def angle_diff(theta1: torch.Tensor, theta2: torch.Tensor) -> torch.Tensor:
    """Smallest signed angle difference (floor-mod wrap, as jnp.mod)."""
    period = 2 * math.pi
    diff = torch.remainder(theta1 - theta2 + period / 2, period) - period / 2
    return torch.where(diff > math.pi, diff - 2 * math.pi, diff)


def convert_state_to_state_and_action(
    traj_state: torch.Tensor, vel_init: torch.Tensor, dt: float
) -> torch.Tensor:
    """Infer (vel, acc, yawvel) from an (x, y, yaw) trajectory by inverse
    unicycle dynamics. The current pose is the agent-frame origin, so the
    trajectory is pre-padded with zero pos/yaw before differencing.

    traj_state [..., T, 3], vel_init [...] -> [..., T, 6]
    (x, y, vel, yaw, acc, yawvel)."""
    bm = traj_state.shape[:-2]
    pos_init = traj_state.new_zeros((*bm, 1, 2))
    yaw_init = traj_state.new_zeros((*bm, 1, 1))
    pos = torch.cat([pos_init, traj_state[..., :2]], dim=-2)  # [..., T+1, 2]
    yaw = torch.cat([yaw_init, traj_state[..., 2:]], dim=-2)
    vel = (pos[..., 1:, 0:1] - pos[..., :-1, 0:1]) / dt * torch.cos(yaw[..., 1:, :]) + (
        pos[..., 1:, 1:2] - pos[..., :-1, 1:2]
    ) / dt * torch.sin(yaw[..., 1:, :])
    vel = torch.cat([vel_init[..., None, None].to(vel.dtype), vel], dim=-2)
    acc = (vel[..., 1:, :] - vel[..., :-1, :]) / dt
    yawvel = angle_diff(yaw[..., 1:, :], yaw[..., :-1, :]) / dt
    return torch.cat([pos[..., 1:, :], vel[..., 1:, :], yaw[..., 1:, :], acc, yawvel], dim=-1)


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
