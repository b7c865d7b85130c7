"""ScenePack: the device-resident world of the closed-loop simulator (port of
`cld_tpu/sim/scene.py`).

The whole world (semantic rasters, agent states, replay actions, lane
centerlines, the dataset future) lives in dense tensors with static shapes;
observation rendering is a gather (`ops.raster`). `synthetic_scene_pack`
draws from numpy's generator in the same order as the JAX package's, so the
same seed gives the same arrays. `scene_pack_from_batches` /
`scene_pack_from_shards` build the world from converted scenes (the
rollout CLI's `--scene-data`), on the host in numpy, as the JAX package
does, then move it to the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from cld_tpu_torch.ops.dynamics import (
    RECORD_DYNAMICS,
    convert_state_to_state_and_action,
    unicycle_step,
)
from cld_tpu_torch.ops.lanes import merge_scene_lanes, straight_lane_polylines

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


def _default_world_placement(B, scene_index, road_half_width=7.0, seed=0):
    """World poses [B, 3, 3] for agent-centric samples that carry none:
    adjacent lanes with longitudinal stagger per scene."""
    rng = np.random.default_rng(seed)
    w = np.zeros((B, 3, 3), np.float32)
    lanes = np.array([-road_half_width / 2, road_half_width / 2], np.float32)
    for s in np.unique(scene_index):
        members = np.nonzero(scene_index == s)[0]
        for k, b in enumerate(members):
            x = -80.0 + 15.0 * k + rng.uniform(-2, 2)
            y = lanes[k % 2] + rng.uniform(-0.5, 0.5)
            w[b] = np.array([[1, 0, x], [0, 1, y], [0, 0, 1]], np.float32)
    return w


def _stitch_world_map(
    sem_rasters: np.ndarray,  # [B, H, W, C] agent-frame semantic layers
    raster_from_agent: np.ndarray,  # [B, 3, 3]
    world_from_agent: np.ndarray,  # [B, 3, 3]
    scene_index: np.ndarray,  # [B]
    world_map_size: int,
    map_resolution: float,
) -> tuple:
    """Inverse-warp each agent's egocentric semantic raster into one world
    grid per scene, centered on the scene's agent centroid, max-combining
    overlaps. For converted real data the agent rasters are crops of one
    map, so the union is exact wherever an agent saw the map. Returns
    (world_map [Ns, Hw, Ww, C], origins [Ns, 2], the sorted scene ids)."""
    B, H, W, C = sem_rasters.shape
    scenes = np.unique(scene_index)
    Ns = len(scenes)
    Hw = Ww = world_map_size
    world_map = np.zeros((Ns, Hw, Ww, C), np.float32)
    origins = np.zeros((Ns, 2), np.float32)
    for si, s in enumerate(scenes):
        members = np.nonzero(scene_index == s)[0]
        centroid = world_from_agent[members, :2, 2].mean(axis=0)
        origin = centroid - np.array([Ww, Hw], np.float32) * map_resolution / 2
        origins[si] = origin
        xs = origin[0] + (np.arange(Ww, dtype=np.float32) + 0.5) * map_resolution
        ys = origin[1] + (np.arange(Hw, dtype=np.float32) + 0.5) * map_resolution
        gx, gy = np.meshgrid(xs, ys)  # [Hw, Ww]
        pw = np.stack([gx, gy, np.ones_like(gx)], axis=-1).reshape(-1, 3)  # [P, 3]
        for b in members:
            r_from_w = raster_from_agent[b] @ np.linalg.inv(world_from_agent[b])
            pr = pw @ r_from_w.T  # [P, 3] raster coords
            col = np.round(pr[:, 0]).astype(np.int64)
            row = np.round(pr[:, 1]).astype(np.int64)
            valid = (col >= 0) & (col < W) & (row >= 0) & (row < H)
            vals = np.zeros((pw.shape[0], C), np.float32)
            vals[valid] = sem_rasters[b, row[valid], col[valid]]
            world_map[si] = np.maximum(world_map[si], vals.reshape(Hw, Ww, C))
    return world_map, origins, scenes


def _np(v):
    return None if v is None else (v.detach().cpu().numpy() if torch.is_tensor(v)
                                   else np.asarray(v))


def scene_pack_from_batches(
    batch,
    scene_index: Optional[np.ndarray] = None,
    world_from_agent: Optional[np.ndarray] = None,
    sim_steps: int = 100,
    world_map_size: int = 512,
    map_resolution: float = 0.5,
    controlled_mask: Optional[np.ndarray] = None,
    num_hist_channels: Optional[int] = None,
    dt: float = 0.1,
    seed: int = 0,
    dyn=None,
    device="cuda",
) -> ScenePack:
    """A simulatable world from a TrafficBatch of converted scenes (the
    reference's reset-from-dataset, `env_trajdata.py:154-231`):

    * world map: per scene, the stitch of the agents' egocentric semantic
      rasters (`_stitch_world_map`);
    * init states: each agent's world pose and current speed;
    * replay actions: inverse unicycle dynamics of the ground-truth future
      (`convert_state_to_state_and_action`), zero past its horizon, so
      uncontrolled agents replay the dataset;
    * lanes: the samples' agent-frame lane points lifted to the world frame
      and merged per scene (`merge_scene_lanes`).

    Samples without world poses (synthetic shards) get a synthesized lane
    placement (`_default_world_placement`). Every agent is controlled unless
    `controlled_mask` says otherwise. The tensors land on `device`."""
    B = int(batch.image.shape[0])
    if scene_index is not None:
        scene_index = np.asarray(scene_index)
    elif batch.scene_index is not None:
        scene_index = _np(batch.scene_index)
    else:
        scene_index = np.zeros(B, np.int64)
    if world_from_agent is None:
        if batch.world_from_agent is not None:
            world_from_agent = _np(batch.world_from_agent)
        else:
            world_from_agent = _default_world_placement(B, scene_index, seed=seed)

    # semantic layers are the channels after the history layers
    img = _np(batch.image)
    Th = batch.history_positions.shape[1] if num_hist_channels is None else num_hist_channels
    world_map, origins, scenes = _stitch_world_map(
        img[..., Th:], _np(batch.raster_from_agent), world_from_agent, scene_index,
        world_map_size, map_resolution,
    )
    dense_scene = np.searchsorted(scenes, scene_index)

    pos_w = world_from_agent[:, :2, 2]
    yaw_w = np.arctan2(world_from_agent[:, 1, 0], world_from_agent[:, 0, 0])
    curr_speed = _np(batch.curr_speed)
    init_states = np.stack([pos_w[:, 0], pos_w[:, 1], curr_speed, yaw_w],
                           axis=-1).astype(np.float32)

    # replay actions from the agent-frame future by inverse dynamics
    gt = torch.cat([torch.as_tensor(_np(batch.target_positions)),
                    torch.as_tensor(_np(batch.target_yaws))], dim=-1)
    sa = convert_state_to_state_and_action(gt, torch.as_tensor(curr_speed), dt)
    actions = sa[..., 4:6].numpy()  # [B, T_fut, 2]
    avail = _np(batch.target_availabilities) > 0
    actions = np.where(avail[..., None], actions, 0.0)
    T_fut = actions.shape[1]
    replay = np.zeros((B, sim_steps, 2), np.float32)
    replay[:, : min(T_fut, sim_steps)] = actions[:, :sim_steps]

    if controlled_mask is None:
        controlled_mask = np.ones(B, bool)

    Ns = len(scenes)
    if batch.lane_points is not None:
        lp = _np(batch.lane_points)  # [B, L0, 3] agent frame
        la = _np(batch.lane_avail) > 0 if batch.lane_avail is not None else np.isfinite(lp).all(-1)
        cos = world_from_agent[:, 0, 0][:, None]
        sin = world_from_agent[:, 1, 0][:, None]
        lp_w = np.stack(
            [
                cos * lp[..., 0] - sin * lp[..., 1] + world_from_agent[:, 0, 2][:, None],
                sin * lp[..., 0] + cos * lp[..., 1] + world_from_agent[:, 1, 2][:, None],
                lp[..., 2] + yaw_w[:, None],
            ],
            axis=-1,
        )
        lane_pts, lane_avail = merge_scene_lanes(lp_w, la, dense_scene, Ns)
    else:
        lane_pts = np.zeros((Ns, 256, 3), np.float32)
        lane_avail = np.zeros((Ns, 256), bool)

    # the ground truth holds while dataset future actions exist; past the
    # horizon the zero replay coasts and is marked unavailable
    gt_avail = np.concatenate(
        [np.ones((B, 1), bool), np.arange(sim_steps)[None, :] < avail.sum(-1, keepdims=True)],
        axis=1,
    )

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    return ScenePack(
        world_map=t(world_map),
        map_origin=t(origins),
        map_resolution=float(map_resolution),
        init_states=t(init_states),
        scene_index=t(dense_scene.astype(np.int32)),
        controlled_mask=t(np.asarray(controlled_mask, bool)),
        replay_actions=t(replay),
        extent=t(_np(batch.extent)),
        lane_points=t(lane_pts),
        lane_avail=t(lane_avail),
        gt_states=t(_roll_gt_states(init_states, replay, dt=dt, dyn=dyn)),
        gt_avail=t(gt_avail),
    )


def scene_pack_from_shards(
    path: str,
    num_scenes: int = 1,
    agents_per_scene: int = 4,
    sim_steps: int = 100,
    start_index: int = 0,
    controlled_mask: Optional[np.ndarray] = None,
    device="cuda",
    **kwargs,
) -> ScenePack:
    """Converted scenes from a packed-shard directory as a ScenePack (the
    rollout CLI's `--scene-data`): samples `start_index ...` (wrapping), with
    the shards' own `scene_index` / `world_from_agent` where the converter
    recorded them, else consecutive samples grouped into scenes of
    `agents_per_scene`. `kwargs` go to `scene_pack_from_batches`."""
    from cld_tpu_torch.data.packed import PackedShardDataset, to_traffic_batch

    ds = PackedShardDataset(path)
    try:
        Na = num_scenes * agents_per_scene
        raw = ds.gather(np.arange(start_index, start_index + Na) % ds.num_samples)
    finally:
        ds.close()
    scene_index = raw.get("scene_index",
                          np.repeat(np.arange(num_scenes, dtype=np.int64), agents_per_scene))
    return scene_pack_from_batches(
        to_traffic_batch(raw, "cpu"),
        scene_index=np.asarray(scene_index).astype(np.int64).reshape(-1),
        world_from_agent=raw.get("world_from_agent"),
        sim_steps=sim_steps,
        controlled_mask=controlled_mask,
        device=device,
        **kwargs,
    )
