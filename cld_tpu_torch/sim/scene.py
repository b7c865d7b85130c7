"""ScenePack: the device-resident world of the closed-loop simulator (port of
`cld_tpu/sim/scene.py:19-148`).

The whole world (semantic rasters, agent states, replay actions, lane
centerlines, the dataset future) lives in dense tensors with static shapes;
observation rendering is a gather (`ops.raster`). `synthetic_scene_pack`
draws from numpy's generator in the same order as the JAX package's, so the
same seed gives the same arrays.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from cld_tpu_torch.ops.dynamics import RECORD_DYNAMICS, unicycle_step
from cld_tpu_torch.ops.lanes import straight_lane_polylines

class ScenePack(NamedTuple):
    """Static world description for a batch of scenes: Na agents across Ns
    scenes, every tensor dense."""

    world_map: torch.Tensor  # [Ns, Hw, Ww, C_sem] world-frame semantic raster
    map_origin: torch.Tensor  # [Ns, 2] world coords of map pixel (0, 0)
    map_resolution: float  # meters / world-map pixel
    init_states: torch.Tensor  # [Na, 4] world (x, y, v, yaw)
    scene_index: torch.Tensor  # [Na] int
    controlled_mask: torch.Tensor  # [Na] bool: policy-controlled vs replay
    replay_actions: torch.Tensor  # [Na, T_sim, 2] (acc, yawvel) for replay agents
    extent: torch.Tensor  # [Na, 3]
    # lane centerlines: world-frame (x, y, yaw) points per scene, masked
    lane_points: Optional[torch.Tensor] = None  # [Ns, L, 3]
    lane_avail: Optional[torch.Tensor] = None  # [Ns, L] bool
    # dataset world states under the replay actions, frame 0 = init:
    # [Na, T_sim + 1, 4]; feeds the observation's target_* fields
    gt_states: Optional[torch.Tensor] = None
    gt_avail: Optional[torch.Tensor] = None  # [Na, T_sim + 1] bool

    @property
    def num_agents(self) -> int:
        return self.init_states.shape[0]


def _roll_gt_states(
    init_states: np.ndarray, replay_actions: np.ndarray, dt: float = 0.1, dyn=None
) -> np.ndarray:
    """Integrate the replay actions through the bounded unicycle: the
    dataset future in the world frame, [Na, T_sim + 1, 4], frame 0 = init.
    `dyn` must carry the bounds the simulator steps with."""
    dyn = RECORD_DYNAMICS if dyn is None else dyn
    x = torch.from_numpy(np.asarray(init_states, np.float32))
    u = torch.from_numpy(np.asarray(replay_actions, np.float32))
    frames = [x]
    for t in range(u.shape[1]):
        x = unicycle_step(dyn, x, u[:, t], dt, bound=True)
        frames.append(x)
    return torch.stack(frames, dim=1).numpy()


def synthetic_scene_pack(
    seed: int = 0,
    num_scenes: int = 1,
    agents_per_scene: int = 4,
    world_map_size: int = 512,
    map_resolution: float = 0.5,
    num_sem_layers: int = 3,
    sim_steps: int = 100,
    road_half_width: float = 7.0,
    dyn=None,
    device="cuda",
) -> ScenePack:
    """Straight-road world: a drivable band along x centered at y = 0,
    agents spawned in two lanes driving +x, every second one controlled."""
    rng = np.random.default_rng(seed)
    Ns, A = num_scenes, agents_per_scene
    Na = Ns * A
    Hw = Ww = world_map_size

    origin = np.array([-Ww * map_resolution / 2, -Hw * map_resolution / 2], np.float32)
    ys = origin[1] + np.arange(Hw, dtype=np.float32) * map_resolution
    drivable_row = (np.abs(ys) < road_half_width).astype(np.float32)
    world_map = np.zeros((Ns, Hw, Ww, num_sem_layers), np.float32)
    world_map[..., 0] = drivable_row[None, :, None]
    if num_sem_layers > 1:
        world_map[..., 1] = 0.5 * world_map[..., 0]
    if num_sem_layers > 2:
        lane_rows = (np.abs(np.abs(ys) - road_half_width / 2) < map_resolution).astype(np.float32)
        world_map[..., 2] = lane_rows[None, :, None]

    lanes = np.array([-road_half_width / 2, road_half_width / 2], np.float32)
    init_states = np.zeros((Na, 4), np.float32)
    init_states[:, 0] = rng.uniform(-80, -20, Na)  # stagger along the road
    init_states[:, 1] = lanes[rng.integers(0, 2, Na)] + rng.uniform(-0.5, 0.5, Na)
    init_states[:, 2] = rng.uniform(3.0, 10.0, Na)
    init_states[:, 3] = 0.0

    scene_index = np.repeat(np.arange(Ns, dtype=np.int32), A)
    controlled = np.zeros(Na, bool)
    controlled[::2] = True  # half controlled, half replay

    # replay agents: mild speed tracking, zero yaw rate
    replay_actions = np.zeros((Na, sim_steps, 2), np.float32)
    replay_actions[:, :, 0] = rng.normal(0, 0.2, (Na, sim_steps))

    extent = np.broadcast_to(np.array([4.5, 2.0, 1.7], np.float32), (Na, 3)).copy()
    lane_pts, lane_avail = straight_lane_polylines(
        lanes, x_min=origin[0], x_max=origin[0] + Ww * map_resolution
    )

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)  # a writable copy

    return ScenePack(
        world_map=t(world_map),
        map_origin=t(np.broadcast_to(origin, (Ns, 2))),
        map_resolution=float(map_resolution),
        init_states=t(init_states),
        scene_index=t(scene_index),
        controlled_mask=t(controlled),
        replay_actions=t(replay_actions),
        extent=t(extent),
        lane_points=t(np.broadcast_to(lane_pts, (Ns,) + lane_pts.shape)),
        lane_avail=t(np.broadcast_to(lane_avail, (Ns,) + lane_avail.shape)),
        gt_states=t(_roll_gt_states(init_states, replay_actions, dyn=dyn)),
        gt_avail=torch.ones((Na, sim_steps + 1), dtype=torch.bool, device=device),
    )
