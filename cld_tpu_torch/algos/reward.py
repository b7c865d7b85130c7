"""PPO reward (port of `cld_tpu/algos/reward.py:29-92`): offroad -1 per
off-map step, collision -1 per (neighbor, step) within 0.8 m, comfort
-0.1 * mean |jerk| of the scaled longitudinal acceleration."""

from __future__ import annotations

import torch

from cld_tpu_torch.data.batch import TrafficBatch
from cld_tpu_torch.ops.geometry import transform_points


def drivable_values_at(traj_xy, drivable_map, raster_from_agent):
    """Drivable-map values under agent-frame points traj_xy [B, ..., 2]."""
    traj_raster = transform_points(traj_xy, raster_from_agent)
    W, H = drivable_map.shape[-1], drivable_map.shape[-2]
    cols = torch.clamp(torch.round(traj_raster[..., 0]), 0, W - 1).long()
    rows = torch.clamp(torch.round(traj_raster[..., 1]), 0, H - 1).long()
    b_idx = torch.arange(drivable_map.shape[0], device=traj_xy.device).reshape(
        (-1,) + (1,) * (traj_xy.ndim - 2)
    )
    return drivable_map[b_idx, rows, cols]


def offroad_reward(traj_xy, batch: TrafficBatch):
    vals = drivable_values_at(traj_xy, batch.drivable_map, batch.raster_from_agent)
    return -torch.sum(vals <= 0, dim=-1).to(torch.float32)


def collision_reward(traj_xy, batch: TrafficBatch, collision_thresh: float = 0.8):
    other = batch.all_other_agents_future_positions  # [B, S, T', 2]
    avail = batch.all_other_agents_future_availability > 0
    T = min(traj_xy.shape[-2], other.shape[-2])
    diff = traj_xy[..., :T, :][:, :, None] - other[..., :T, :][:, None]
    dist = torch.linalg.norm(diff, dim=-1)  # [B, N, S, T]
    hits = (dist < collision_thresh) & avail[..., :T][:, None]
    return -torch.sum(hits, dim=(2, 3)).to(torch.float32)


def jerk_penalty(acc_scaled, dt: float = 0.1):
    jerk = (acc_scaled[..., 1:] - acc_scaled[..., :-1]) / dt
    return torch.mean(torch.abs(jerk), dim=-1)


def compute_reward(state_act, batch: TrafficBatch, state_act_scaled,
                   collision_thresh: float = 0.8, dt: float = 0.1):
    """[B, N, T, 6] descaled + scaled trajectories -> flat reward [B*N]."""
    traj = state_act[..., :2]
    r_off = offroad_reward(traj, batch)
    r_col = collision_reward(traj, batch, collision_thresh)
    r_jerk = jerk_penalty(state_act_scaled[..., 4], dt)
    return (r_off + r_col - 0.1 * r_jerk).reshape(-1)
