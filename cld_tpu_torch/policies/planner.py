"""Kinematic lattice planner (port of `cld_tpu/policies/planner.py`).

A static lattice of unicycle candidates, the cross product of target
speeds (a P-controller toward each, rolled over the horizon) and yaw-rate
nudges (applied for the first quarter of the horizon, counter-steered over
the second), is rolled out in one batched `unicycle_forward_dynamics`,
scored by off-road, collision, progress and comfort costs, and the argmin
kept. Points outside the raster count as off-road.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from cld_tpu_torch.algos.reward import drivable_values_at
from cld_tpu_torch.data.batch import TrafficBatch, get_current_states
from cld_tpu_torch.ops.dynamics import (
    RECORD_DYNAMICS,
    UnicycleParams,
    _clip,
    unicycle_forward_dynamics,
)
from cld_tpu_torch.ops.geometry import transform_points
from cld_tpu_torch.policies.common import Action


@dataclasses.dataclass(frozen=True)
class LatticePlannerConfig:
    horizon: int = 52
    dt: float = 0.1
    target_speeds: Tuple[float, ...] = (0.0, 2.0, 5.0, 8.0, 12.0)
    yawvels: Tuple[float, ...] = (-0.3, -0.15, 0.0, 0.15, 0.3)
    speed_gain: float = 1.0  # P-controller toward the target speed
    w_offroad: float = 10.0
    w_collision: float = 100.0  # dominates: collision is a hard constraint
    w_progress: float = 1.0
    w_comfort: float = 0.1
    collision_thresh: float = 2.5
    dyn: UnicycleParams = RECORD_DYNAMICS


def lattice_planner_policy(cfg: LatticePlannerConfig = LatticePlannerConfig()):
    """The policy `(obs, rng) -> Action` that evaluates the whole lattice."""
    pairs = [(s, w) for s in cfg.target_speeds for w in cfg.yawvels]
    K = len(pairs)

    def policy(obs: TrafficBatch, rng=None) -> Action:
        dev = obs.curr_speed.device
        tgt_speeds = torch.tensor([p[0] for p in pairs], device=dev)
        yawvels = torch.tensor([p[1] for p in pairs], device=dev)
        B = obs.curr_speed.shape[0]
        T = cfg.horizon
        curr = get_current_states(obs)  # [B, 4]

        # candidate accelerations [B, K, T]: the P-controller rolled forward
        # over the horizon, so a 'stop' candidate stops instead of reversing
        v = curr[:, 2][:, None].expand(B, K)
        acc_steps = []
        for _ in range(T):
            a = _clip(cfg.speed_gain * (tgt_speeds[None] - v), cfg.dyn.acce_lo, cfg.dyn.acce_hi)
            v = _clip(v + a * cfg.dt, cfg.dyn.v_lo, cfg.dyn.v_hi)
            acc_steps.append(a)
        acc = torch.stack(acc_steps, dim=-1)  # [B, K, T]
        q = T // 4
        yaw_profile = torch.cat([torch.ones(q, device=dev), -torch.ones(q, device=dev),
                                 torch.zeros(T - 2 * q, device=dev)])  # net heading change ~0
        actions = torch.stack(
            [acc, (yawvels[None, :, None] * yaw_profile[None, None, :]).expand(B, K, T)], dim=-1)

        curr_rep = curr.repeat_interleave(K, dim=0)
        states = unicycle_forward_dynamics(
            cfg.dyn, curr_rep, actions.reshape(B * K, T, 2), cfg.dt).reshape(B, K, T, 4)

        pos = states[..., :2]
        offroad = 1.0 - drivable_values_at(pos, obs.drivable_map, obs.raster_from_agent)
        # points beyond the raster would clamp to the border pixel; for
        # planning they count as off-road
        pr = transform_points(pos, obs.raster_from_agent)
        H, W = obs.drivable_map.shape[-2:]
        inside = ((pr[..., 0] >= 0) & (pr[..., 0] <= W - 1)
                  & (pr[..., 1] >= 0) & (pr[..., 1] <= H - 1))
        offroad = torch.where(inside, offroad, torch.ones_like(offroad))
        c_offroad = offroad.mean(dim=-1)  # [B, K]

        other = obs.all_other_agents_future_positions  # [B, S, T', 2]
        avail = obs.all_other_agents_future_availability > 0
        Tm = min(T, other.shape[2])
        d = torch.linalg.norm(pos[:, :, None, :Tm] - other[:, None, :, :Tm], dim=-1)
        hits = (d < cfg.collision_thresh) & avail[:, None, :, :Tm]
        c_coll = hits.flatten(2).any(dim=-1).to(torch.float32)  # [B, K]

        # progress as average speed, so it cannot outvote the collision cost
        progress = (states[..., -1, 0] - states[..., 0, 0]) / (T * cfg.dt)
        c_comfort = actions[..., 0].abs().mean(dim=-1) + actions[..., 1].abs().mean(dim=-1)

        cost = (cfg.w_offroad * c_offroad + cfg.w_collision * c_coll
                - cfg.w_progress * progress + cfg.w_comfort * c_comfort)  # [B, K]
        best = torch.argmin(cost, dim=-1)  # [B]
        rows = torch.arange(B, device=dev)
        return Action(positions=pos[rows, best], yaws=states[rows, best, :, 3:4],
                      controls=actions[rows, best])

    return policy
