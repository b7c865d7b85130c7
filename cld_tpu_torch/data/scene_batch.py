"""SceneBatch: scene-centric batches for joint multi-agent models (port of
`cld_tpu/data/scene_batch.py`).

One batch element is a whole scene of up to A agents (padded and masked),
each with its own history and future in its OWN current frame, while
`agent_pos_scene` / `agent_yaw_scene` carry the scene-frame poses that
relate the agents to each other. `synthetic_scene_batch` draws from numpy's
generator in the JAX package's order, so the same seed gives the same
arrays. The input of scene diffusion (`--mode scene_dm`, ROADMAP Queue A 12).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SceneBatch(NamedTuple):
    # per-agent histories in each agent's local frame
    hist_positions: torch.Tensor  # [B, A, Th, 2]
    hist_yaws: torch.Tensor  # [B, A, Th, 1]
    hist_speeds: torch.Tensor  # [B, A, Th]
    hist_avail: torch.Tensor  # [B, A, Th]
    # ground-truth futures in each agent's local frame
    fut_positions: torch.Tensor  # [B, A, T, 2]
    fut_yaws: torch.Tensor  # [B, A, T, 1]
    fut_avail: torch.Tensor  # [B, A, T]
    curr_speed: torch.Tensor  # [B, A]
    extent: torch.Tensor  # [B, A, 3]
    # scene-frame poses of each agent (for relative conditioning)
    agent_pos_scene: torch.Tensor  # [B, A, 2]
    agent_yaw_scene: torch.Tensor  # [B, A]
    agent_mask: torch.Tensor  # [B, A] bool (False = padding)


def synthetic_scene_batch(
    seed: int = 0,
    batch_size: int = 2,
    num_agents: int = 6,
    hist_frames: int = 10,
    horizon: int = 52,
    dt: float = 0.1,
    road_half_width: float = 7.0,
    device="cuda",
) -> SceneBatch:
    """Scenes of straight-road agents with unicycle-consistent futures; the
    last agent of each scene is padding."""
    rng = np.random.default_rng(seed)
    B, A, Th, T = batch_size, num_agents, hist_frames + 1, horizon

    speeds = rng.uniform(3.0, 12.0, (B, A)).astype(np.float32)
    pos_scene = np.stack(
        [
            rng.uniform(-50, 50, (B, A)),
            rng.uniform(-road_half_width + 1, road_half_width - 1, (B, A)),
        ],
        axis=-1,
    ).astype(np.float32)
    yaw_scene = np.zeros((B, A), np.float32)

    steps_back = np.arange(Th - 1, -1, -1, dtype=np.float32)
    hist_pos = np.zeros((B, A, Th, 2), np.float32)
    hist_pos[..., 0] = -steps_back[None, None] * speeds[..., None] * dt
    hist_yaws = np.zeros((B, A, Th, 1), np.float32)
    hist_speeds = np.broadcast_to(speeds[..., None], (B, A, Th)).copy()
    hist_avail = np.ones((B, A, Th), np.float32)

    # futures: gentle accelerations and small yaw rates, exact midpoint rollout
    acc = rng.normal(0, 0.5, (B, A, T)).astype(np.float32)
    yawvel = rng.normal(0, 0.03, (B, A, T)).astype(np.float32)
    fut_pos = np.zeros((B, A, T, 2), np.float32)
    fut_yaw = np.zeros((B, A, T, 1), np.float32)
    x = np.zeros((B, A, 4), np.float32)
    x[..., 2] = speeds
    for t in range(T):
        v_mid = x[..., 2] + acc[..., t] * dt * 0.5
        x[..., 0] += np.cos(x[..., 3]) * v_mid * dt
        x[..., 1] += np.sin(x[..., 3]) * v_mid * dt
        x[..., 2] += acc[..., t] * dt
        x[..., 3] += yawvel[..., t] * dt
        fut_pos[..., t, :] = x[..., :2]
        fut_yaw[..., t, 0] = x[..., 3]
    fut_avail = np.ones((B, A, T), np.float32)

    mask = np.ones((B, A), bool)
    mask[:, -1] = False  # padding agent

    def t_(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return SceneBatch(
        hist_positions=t_(hist_pos),
        hist_yaws=t_(hist_yaws),
        hist_speeds=t_(hist_speeds),
        hist_avail=t_(hist_avail),
        fut_positions=t_(fut_pos),
        fut_yaws=t_(fut_yaw),
        fut_avail=t_(fut_avail),
        curr_speed=t_(speeds),
        extent=t_(np.broadcast_to(np.array([4.5, 2.0, 1.7], np.float32), (B, A, 3))),
        agent_pos_scene=t_(pos_scene),
        agent_yaw_scene=t_(yaw_scene),
        agent_mask=t_(mask),
    )
