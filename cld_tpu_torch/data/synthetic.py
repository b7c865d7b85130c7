"""Synthetic mini-scenes (port of `cld_tpu/data/synthetic.py:56-180`).

A procedurally generated, self-consistent batch: a straight-road drivable
band, unicycle-consistent ego kinematics and a few neighbor vehicles. The
numpy generator draws in the same order as the JAX package's, so the same
seed gives the same arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from cld_tpu_torch.data.batch import TrafficBatch
from cld_tpu_torch.ops.geometry import raster_from_agent_matrix
from cld_tpu_torch.ops.lanes import straight_lane_polylines


def _unicycle_rollout(x0, actions, dt):
    """Numpy midpoint unicycle rollout (no bounds). x0 [B,4], actions [B,T,2]."""
    B, T, _ = actions.shape
    out = np.zeros((B, T, 4), dtype=np.float32)
    x = x0.copy()
    for t in range(T):
        u = actions[:, t]
        theta = x[:, 3]
        v_mid = x[:, 2] + u[:, 0] * dt * 0.5
        x = x + dt * np.stack(
            [np.cos(theta) * v_mid, np.sin(theta) * v_mid, u[:, 0], u[:, 1]], axis=-1
        )
        out[:, t] = x
    return out


def _paint_history(image, positions, avail, raster_from_agent, value, hw):
    """Paint agent positions into per-timestep history channels.

    positions [B, A, Th, 2] agent-frame; image [B, Th, H, W] painted in
    place with `value` (all writes of one call carry the same value, so the
    vectorized scatter equals the per-point loop)."""
    B, A, Th, _ = positions.shape
    h, w = hw
    scale = raster_from_agent[0, 0, 0]
    cx, cy = raster_from_agent[0, 0, 2], raster_from_agent[0, 1, 2]
    px = np.clip(np.round(positions[..., 0] * scale + cx), 0, w - 1).astype(np.int64)
    py = np.clip(np.round(positions[..., 1] * scale + cy), 0, h - 1).astype(np.int64)
    b, a, t = np.nonzero(avail)
    image[b, t, py[b, a, t], px[b, a, t]] = value
    return image


def synthetic_batch(
    seed: int = 0,
    batch_size: int = 4,
    raster_size: int = 224,
    pixel_size: float = 0.5,
    hist_frames: int = 30,
    horizon: int = 52,
    num_neighbors: int = 5,
    num_sem_layers: int = 3,
    dt: float = 0.1,
    road_half_width: float = 7.0,
    device="cuda",
    rank: int = 0,
    world_size: int = 1,
) -> TrafficBatch:
    """Generate a consistent agent-centric batch on a straight road along +x.
    With `world_size` above 1, rank `rank`'s rows of it (rows [rank * b,
    (rank + 1) * b), b = batch_size / world_size): the draws are the whole
    batch's, and only these rows are painted and made."""
    rng = np.random.default_rng(seed)
    B, S, Th, T = batch_size, num_neighbors, hist_frames + 1, horizon
    H = W = raster_size

    speeds = rng.uniform(3.0, 12.0, B).astype(np.float32)

    # ego future: gentle acceleration + sinusoidal yaw-rate (the trainers' target)
    acc = rng.normal(0, 0.5, (B, T)).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, (B, 1))
    yawvel = 0.05 * np.sin(np.linspace(0, 2 * np.pi, T)[None, :] + phase).astype(np.float32)
    x0 = np.zeros((B, 4), dtype=np.float32)
    x0[:, 2] = speeds
    fut_states = _unicycle_rollout(x0, np.stack([acc, yawvel], axis=-1), dt)

    # ego history: integrate backwards at roughly constant speed
    hist_positions = np.zeros((B, Th, 2), dtype=np.float32)
    steps_back = np.arange(Th - 1, -1, -1, dtype=np.float32)  # Th-1 ... 0
    hist_positions[..., 0] = -steps_back[None, :] * speeds[:, None] * dt
    hist_yaws = np.zeros((B, Th, 1), dtype=np.float32)
    hist_avail = np.ones((B, Th), dtype=np.float32)

    # neighbors: offset lanes, constant speed, some invalid
    n_off_x = rng.uniform(-25, 25, (B, S)).astype(np.float32)
    n_off_y = rng.uniform(-road_half_width + 1, road_half_width - 1, (B, S)).astype(np.float32)
    n_speed = rng.uniform(2.0, 12.0, (B, S)).astype(np.float32)
    t_axis = np.arange(1, T + 1, dtype=np.float32) * dt
    n_fut = np.zeros((B, S, T, 2), dtype=np.float32)
    n_fut[..., 0] = n_off_x[..., None] + n_speed[..., None] * t_axis[None, None, :]
    n_fut[..., 1] = n_off_y[..., None]
    n_fut_avail = np.ones((B, S, T), dtype=np.float32)
    n_fut_avail[rng.random((B, S)) < 0.2] = 0.0  # some missing neighbors

    th_axis = -steps_back * dt
    n_hist = np.zeros((B, S, Th, 2), dtype=np.float32)
    n_hist[..., 0] = n_off_x[..., None] + n_speed[..., None] * th_axis[None, None, :]
    n_hist[..., 1] = n_off_y[..., None]
    n_hist_yaws = np.zeros((B, S, Th, 1), dtype=np.float32)
    n_hist_avail = np.broadcast_to(n_fut_avail[..., :1], (B, S, Th))

    if world_size > 1:
        if B % world_size:
            raise ValueError(f"a batch of {B} rows does not divide over {world_size} ranks")
        B //= world_size
        mine = slice(rank * B, (rank + 1) * B)
        (speeds, fut_states, hist_positions, hist_yaws, hist_avail, n_fut, n_fut_avail, n_hist,
         n_hist_yaws, n_hist_avail) = (a[mine] for a in (
            speeds, fut_states, hist_positions, hist_yaws, hist_avail, n_fut, n_fut_avail,
            n_hist, n_hist_yaws, n_hist_avail))

    rfa = raster_from_agent_matrix(raster_size, pixel_size, (-0.5, 0.0))
    raster_from_agent = np.broadcast_to(rfa, (B, 3, 3)).copy()

    # semantic layers: layer 0 = drivable band |y| < road_half_width
    ys = (np.arange(H, dtype=np.float32) - rfa[1, 2]) * pixel_size
    drivable_row = (np.abs(ys) < road_half_width).astype(np.float32)  # [H]
    sem = np.zeros((B, num_sem_layers, H, W), dtype=np.float32)
    sem[:, 0] = drivable_row[None, :, None]
    if num_sem_layers > 1:
        sem[:, 1] = 0.5 * sem[:, 0]
    if num_sem_layers > 2:
        lane_rows = (np.abs(np.abs(ys) - road_half_width / 2) < pixel_size).astype(np.float32)
        sem[:, 2] = lane_rows[None, :, None]

    # history channels: ego +1 then neighbors -1 per frame (ego painted last)
    hist_img = np.zeros((B, Th, H, W), dtype=np.float32)
    _paint_history(hist_img, n_hist, n_hist_avail > 0, raster_from_agent, -1.0, (H, W))
    _paint_history(
        hist_img, hist_positions[:, None], (hist_avail > 0)[:, None],
        raster_from_agent, 1.0, (H, W),
    )

    image = np.concatenate([hist_img, sem], axis=1)  # [B, C, H, W]
    del hist_img
    image = np.ascontiguousarray(np.moveaxis(image, 1, -1))  # NHWC
    extent = np.broadcast_to(np.array([4.5, 2.0, 1.7], dtype=np.float32), (B, 3)).copy()
    # agent-frame lane centerlines matching the painted lane raster layer
    lane_pts, lane_avail = straight_lane_polylines(
        (-road_half_width / 2, road_half_width / 2), x_min=-40.0, x_max=88.0, spacing=2.0,
        max_points=128,
    )

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device)

    return TrafficBatch(
        image=t(image),
        drivable_map=t(sem[:, 0]),
        raster_from_agent=t(raster_from_agent),
        history_positions=t(hist_positions),
        history_yaws=t(hist_yaws),
        curr_speed=t(speeds),
        extent=t(extent),
        all_other_agents_future_positions=t(n_fut),
        all_other_agents_future_availability=t(n_fut_avail),
        history_availabilities=t(hist_avail),
        target_positions=t(fut_states[..., :2]),
        target_yaws=t(fut_states[..., 3:4]),
        target_availabilities=t(np.ones((B, T), dtype=np.float32)),
        all_other_agents_history_positions=t(n_hist),
        all_other_agents_history_yaws=t(n_hist_yaws),
        all_other_agents_history_availability=t(n_hist_avail),
        lane_points=t(np.broadcast_to(lane_pts, (B,) + lane_pts.shape)),
        lane_avail=t(np.broadcast_to(lane_avail, (B,) + lane_avail.shape)),
    )
