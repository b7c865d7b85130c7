"""PPO reward and failure rates (port of `cld_tpu/algos/reward.py`): offroad
-1 per off-map step, collision -1 per (neighbor, step) within 0.8 m, comfort
-0.1 * mean |jerk| of the scaled longitudinal acceleration. The off-road
count runs through `ops.reward_kernels.offroad_count` (a CUDA kernel on the
card, its plain version on the CPU)."""

from __future__ import annotations

from typing import Dict

import torch

from cld_tpu_torch.data.batch import TrafficBatch
from cld_tpu_torch.ops.geometry import transform_points
from cld_tpu_torch.ops.reward_kernels import offroad_count


def _raster_pixels(traj_xy, drivable_map, raster_from_agent):
    """(cols, rows) of agent-frame points traj_xy [B, ..., 2]: rounded and
    clamped to the map, as float tensors."""
    traj_raster = transform_points(traj_xy, raster_from_agent)
    W, H = drivable_map.shape[-1], drivable_map.shape[-2]
    cols = torch.clamp(torch.round(traj_raster[..., 0]), 0, W - 1)
    rows = torch.clamp(torch.round(traj_raster[..., 1]), 0, H - 1)
    return cols, rows


def drivable_values_at(traj_xy, drivable_map, raster_from_agent):
    """Drivable-map values under agent-frame points traj_xy [B, ..., 2]."""
    cols, rows = _raster_pixels(traj_xy, drivable_map, raster_from_agent)
    cols, rows = cols.long(), rows.long()
    b_idx = torch.arange(drivable_map.shape[0], device=traj_xy.device).reshape(
        (-1,) + (1,) * (traj_xy.ndim - 2)
    )
    return drivable_map[b_idx, rows, cols]


def offroad_reward(traj_xy, batch: TrafficBatch):
    """[B, N, T, 2] -> [B, N]: -1 per step whose pixel is off the drivable
    map. Rounding, the clamp and the cast to int32 stay here; the gather and
    the count are `offroad_count` over N groups of T points per map."""
    drivable = batch.drivable_map
    cols, rows = _raster_pixels(traj_xy, drivable, batch.raster_from_agent)
    pix = torch.stack([cols, rows], dim=-1).to(torch.int32)
    return -offroad_count(pix.contiguous(), drivable.to(torch.float32).contiguous())


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


def failure_rate(state_action, batch: TrafficBatch,
                 collision_thresh: float = 0.8) -> Dict[str, torch.Tensor]:
    """[B, T, 6] descaled trajectories -> offroad / collision / overall
    failure rates: the share of trajectories with any off-map step, with any
    neighbor within `collision_thresh`, and the mean of the two."""
    traj = state_action[..., :2]
    vals = drivable_values_at(traj, batch.drivable_map, batch.raster_from_agent)
    no_offroad = torch.all(vals > 0, dim=-1).to(torch.float32).mean()
    r_col = collision_reward(traj[:, None], batch, collision_thresh)[:, 0]
    no_collision = (r_col >= 0).to(torch.float32).mean()
    off_rate = 1.0 - no_offroad
    col_rate = 1.0 - no_collision
    return {
        "offroad_failure_rate": off_rate,
        "collision_failure_rate": col_rate,
        "overall_failure_rate": (off_rate + col_rate) / 2.0,
    }
