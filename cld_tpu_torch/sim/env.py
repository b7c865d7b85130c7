"""Closed-loop simulator (port of `cld_tpu/sim/env.py`).

The receding-horizon rollout: every `n_step_action` frames render an
agent-centric observation (semantic-map warp + history rasterization), ask
the policy for a plan, then step the unicycle frame by frame while
accumulating off-road, collision and comfort metrics. Everything lives on
the scene pack's device. The loops over replans and frames are Python
loops and the frame counter is a Python int, so nothing in them reads a
device value back to the host.

Replan cadence of the config of record: the policy plans 52 steps and the
simulator consumes 5 per replan over 100 frames.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from cld_tpu_torch.data.batch import TrafficBatch
from cld_tpu_torch.ops.dynamics import (
    RECORD_DYNAMICS,
    UnicycleParams,
    unicycle_step,
    unicycle_ubound,
)
from cld_tpu_torch.ops.geometry import (
    agent_from_world_matrix,
    obb_collision_matrix,
    raster_from_agent_matrix,
    transform_points,
    world_from_agent_matrix,
)
from cld_tpu_torch.ops.lanes import closest_lane_points
from cld_tpu_torch.ops.raster import quantize_world_maps_q8, rasterize_history, warp_scene_maps
from cld_tpu_torch.sim.scene import ScenePack


@dataclasses.dataclass(frozen=True)
class SimConfig:
    num_simulation_steps: int = 100
    n_step_action: int = 5
    hist_frames: int = 30
    raster_size: int = 224
    pixel_size: float = 0.5
    ego_center: Tuple[float, float] = (-0.5, 0.0)
    dt: float = 0.1
    # planning horizon the observation's target_* fields cover; must match
    # the policy's horizon (config of record: 52)
    plan_horizon: int = 52
    # extent scale on the exact oriented-box overlap test (1.0 = geometric
    # intersection; > 1 adds a safety margin)
    collision_thresh: float = 1.0
    dyn: UnicycleParams = RECORD_DYNAMICS

    @property
    def num_replans(self) -> int:
        if self.num_simulation_steps % self.n_step_action:
            raise ValueError(
                f"num_simulation_steps={self.num_simulation_steps} must be a "
                f"multiple of n_step_action={self.n_step_action}: a floor "
                "division would simulate fewer frames than asked"
            )
        return self.num_simulation_steps // self.n_step_action


class SimState(NamedTuple):
    states: torch.Tensor  # [Na, 4] world (x, y, v, yaw)
    history: torch.Tensor  # [Na, Th, 4] world-frame state history (newest last)
    step: int  # global frame index (host side)
    offroad_steps: torch.Tensor  # [Na] accumulated offroad frames
    collision_steps: torch.Tensor  # [Na] accumulated in-collision frames
    # [Na, 3] in-collision frames by type (front, rear, side), classified by
    # the nearest colliding partner's bearing in the agent frame
    collision_type_steps: torch.Tensor
    max_abs_acc: torch.Tensor  # [Na] comfort accumulators
    max_abs_yawvel: torch.Tensor  # [Na]


def init_sim_state(pack: ScenePack, cfg: SimConfig) -> SimState:
    Na = pack.num_agents
    Th = cfg.hist_frames + 1
    dev = pack.init_states.device
    s0 = pack.init_states
    # pre-roll history: constant-velocity extrapolation backwards
    steps_back = torch.arange(Th - 1, -1, -1, dtype=torch.float32, device=dev)
    dx = s0[:, 2:3] * cfg.dt * steps_back[None]  # [Na, Th]
    hx = s0[:, 0:1] - dx * torch.cos(s0[:, 3:4])
    hy = s0[:, 1:2] - dx * torch.sin(s0[:, 3:4])
    hist = torch.stack([hx, hy, s0[:, 2:3].expand_as(hx), s0[:, 3:4].expand_as(hx)], dim=-1)
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    return SimState(
        states=s0,
        history=hist,
        step=0,
        offroad_steps=zeros(Na),
        collision_steps=zeros(Na),
        collision_type_steps=zeros(Na, 3),
        max_abs_acc=zeros(Na),
        max_abs_yawvel=zeros(Na),
    )


def drivable_at_world(pack: ScenePack, pos: torch.Tensor) -> torch.Tensor:
    """pos [..., Na, 2] world -> channel 0 of each agent's scene map at the
    rounded, clipped world pixel (leading dims broadcast)."""
    si = pack.scene_index.long()
    wp = (pos - pack.map_origin[si]) / pack.map_resolution
    Hw, Ww = pack.world_map.shape[1:3]
    ix = torch.clamp(torch.round(wp[..., 0]).long(), 0, Ww - 1)
    iy = torch.clamp(torch.round(wp[..., 1]).long(), 0, Hw - 1)
    return pack.world_map[si, iy, ix, 0]


def render_observation(
    pack: ScenePack, state: SimState, cfg: SimConfig, world_q8: Optional[torch.Tensor] = None
) -> TrafficBatch:
    """World state -> agent-centric TrafficBatch. `world_q8` is the pack's
    `quantize_world_maps_q8`, made once outside the replan loop."""
    Na = pack.num_agents
    dev = state.states.device
    pos = state.states[:, :2]
    yaw = state.states[:, 3]
    w_from_a = world_from_agent_matrix(pos, yaw)
    a_from_w = agent_from_world_matrix(pos, yaw)

    # semantic layers: per-agent egocentric warp of that agent's scene map
    sem = warp_scene_maps(
        pack.world_map, pack.map_origin, pack.map_resolution, w_from_a, pack.scene_index,
        cfg.raster_size, cfg.pixel_size, cfg.ego_center,
        impl="auto", world_maps_q8=world_q8,
    )  # [Na, H, W, C_sem]

    # histories into each agent's frame; neighbors: all agents of the same
    # scene (self included then masked)
    hist_world = state.history[:, :, :2]  # [Na, Th, 2]
    Th = hist_world.shape[1]
    ego_hist = transform_points(hist_world, a_from_w)
    neigh_hist = transform_points(
        hist_world[None].expand(Na, Na, Th, 2).reshape(Na, -1, 2), a_from_w
    ).reshape(Na, Na, Th, 2)
    same_scene = pack.scene_index[:, None] == pack.scene_index[None, :]
    neigh_mask = same_scene & ~torch.eye(Na, dtype=torch.bool, device=dev)
    neigh_avail = neigh_mask[:, :, None].expand(Na, Na, Th).to(torch.float32)
    ego_avail = torch.ones((Na, Th), dtype=torch.float32, device=dev)

    rfa = torch.as_tensor(
        raster_from_agent_matrix(cfg.raster_size, cfg.pixel_size, cfg.ego_center), device=dev
    ).expand(Na, 3, 3)
    hist_img = rasterize_history(ego_hist, ego_avail, neigh_hist, neigh_avail, rfa,
                                 cfg.raster_size)
    image = torch.cat([hist_img.permute(0, 2, 3, 1), sem], dim=-1)  # NHWC

    hist_yaw_agent = state.history[:, :, 3:4] - yaw[:, None, None]

    # dataset future in the agent frame, zero-padded past the episode's end
    T_plan = cfg.plan_horizon
    if pack.gt_states is not None:
        lo = state.step + 1
        fut = pack.gt_states[:, lo : lo + T_plan]
        fut_av = pack.gt_avail[:, lo : lo + T_plan].to(torch.float32)
        short = T_plan - fut.shape[1]
        if short:
            fut = torch.nn.functional.pad(fut, (0, 0, 0, short))
            fut_av = torch.nn.functional.pad(fut_av, (0, short))
        # the padded frames are world zeros, transformed like the real ones
        tgt_pos = transform_points(fut[..., :2], a_from_w)
        tgt_yaw = fut[..., 3:4] - yaw[:, None, None]
        tgt_av = fut_av
    else:
        tgt_pos = torch.zeros((Na, T_plan, 2), device=dev)
        tgt_yaw = torch.zeros((Na, T_plan, 1), device=dev)
        tgt_av = torch.zeros((Na, T_plan), device=dev)

    neigh_yaw = state.history[:, :, 3][None].expand(Na, Na, Th) - yaw[:, None, None]

    lane_pts = lane_av = None
    if pack.lane_points is not None:
        si = pack.scene_index.long()
        lane_pts, lane_av = closest_lane_points(
            pack.lane_points[si], pack.lane_avail[si], pos, yaw, a_from_w
        )

    return TrafficBatch(
        image=image,
        drivable_map=sem[..., 0],
        raster_from_agent=rfa,
        history_positions=ego_hist,
        history_yaws=hist_yaw_agent,
        history_availabilities=ego_avail,
        curr_speed=state.states[:, 2],
        target_positions=tgt_pos,
        target_yaws=tgt_yaw,
        target_availabilities=tgt_av,
        extent=pack.extent,
        all_other_agents_future_positions=torch.zeros((Na, 1, T_plan, 2), device=dev),
        all_other_agents_future_availability=torch.zeros((Na, 1, T_plan), device=dev),
        all_other_agents_history_positions=neigh_hist,
        all_other_agents_history_yaws=neigh_yaw[..., None],
        all_other_agents_history_availability=neigh_avail,
        world_from_agent=w_from_a,
        agent_from_world=a_from_w,
        scene_index=pack.scene_index,
        history_speeds=state.history[:, :, 2],
        sim_step=state.step,
        lane_points=lane_pts,
        lane_avail=lane_av,
    )


# (obs, rng) -> actions [Na, T_plan, 2] (acc, yawvel) descaled, or an Action.
# `rng` is what `simulate` hands the replan: its entry of `replan_noises`
# (explicit noise, in the structure the policy documents) or the generator.
PolicyFn = Callable[[TrafficBatch, object], object]


def _consume_actions(
    pack: ScenePack, state: SimState, actions: torch.Tensor, cfg: SimConfig
) -> Tuple[SimState, torch.Tensor]:
    """Advance n_step_action frames with per-frame metric accumulation.
    Returns the advanced state and the world-state log
    [n_step_action, Na, 4]."""
    Na = pack.num_agents
    dev = state.states.device
    same_scene = pack.scene_index[:, None] == pack.scene_index[None, :]
    valid_pair = same_scene & ~torch.eye(Na, dtype=torch.bool, device=dev)
    ar = torch.arange(Na, device=dev)
    inf = torch.full((), float("inf"), device=dev)
    st = state
    frames = []
    for k in range(cfg.n_step_action):
        u_policy = actions[:, k]
        u_replay = pack.replay_actions[:, st.step]
        u = torch.where(pack.controlled_mask[:, None], u_policy, u_replay)
        # invalid-action guard: NaN controls freeze the agent instead of
        # corrupting the world state
        u = torch.where(torch.isfinite(u), u, torch.zeros_like(u))
        # clip to the dynamics bounds here so the comfort accumulators see
        # the control the simulator executes, not the raw command
        lb, ub = unicycle_ubound(cfg.dyn, st.states)
        u = torch.minimum(torch.maximum(u, lb), ub)
        new_states = unicycle_step(cfg.dyn, st.states, u, cfg.dt, bound=False)

        pos = new_states[:, :2]
        offroad = (drivable_at_world(pack, pos) <= 0).to(torch.float32)
        rel = pos[None, :, :] - pos[:, None, :]  # [i, j, 2]
        dist = torch.linalg.norm(rel, dim=-1)
        coll_pair = obb_collision_matrix(
            pos, new_states[:, 3], pack.extent[:, :2], extent_scale=cfg.collision_thresh
        ) & valid_pair
        colliding = torch.any(coll_pair, dim=-1)

        # collision type: the nearest colliding partner's offset in the
        # agent frame, extent-normalized: longitudinal-dominant ahead =
        # front, behind = rear, lateral-dominant = side
        yaw_i = new_states[:, 3]
        c_i, s_i = torch.cos(yaw_i)[:, None], torch.sin(yaw_i)[:, None]
        dx = c_i * rel[..., 0] + s_i * rel[..., 1]  # [i, j] longitudinal
        dy = -s_i * rel[..., 0] + c_i * rel[..., 1]  # lateral
        nearest = torch.argmin(torch.where(coll_pair, dist, inf), dim=-1)  # [Na]
        lon_n = dx[ar, nearest] / torch.clamp(pack.extent[:, 0], min=1e-3)
        lat_n = dy[ar, nearest] / torch.clamp(pack.extent[:, 1], min=1e-3)
        longitudinal = torch.abs(lon_n) >= torch.abs(lat_n)
        ctype = torch.stack(
            [
                colliding & longitudinal & (lon_n >= 0),
                colliding & longitudinal & (lon_n < 0),
                colliding & ~longitudinal,
            ],
            dim=-1,
        ).to(torch.float32)

        st = SimState(
            states=new_states,
            history=torch.cat([st.history[:, 1:], new_states[:, None]], dim=1),
            step=st.step + 1,
            offroad_steps=st.offroad_steps + offroad,
            collision_steps=st.collision_steps + colliding.to(torch.float32),
            collision_type_steps=st.collision_type_steps + ctype,
            max_abs_acc=torch.maximum(st.max_abs_acc, torch.abs(u[:, 0])),
            max_abs_yawvel=torch.maximum(st.max_abs_yawvel, torch.abs(u[:, 1])),
        )
        frames.append(new_states)
    return st, torch.stack(frames, dim=0)


@torch.no_grad()
def simulate(
    pack: ScenePack,
    policy_fn: PolicyFn,
    cfg: SimConfig = SimConfig(),
    generator: Optional[torch.Generator] = None,
    replan_noises: Optional[Sequence] = None,
) -> Tuple[SimState, torch.Tensor]:
    """Full receding-horizon rollout on the pack's device (make the pack
    with `synthetic_scene_pack`, whose device defaults to "cuda").

    Replan r calls `policy_fn(obs, replan_noises[r])` when `replan_noises`
    is given (one entry per replan), else `policy_fn(obs, generator)`.
    Returns (final SimState, trajectory log [T_sim, Na, 4] world frame)."""
    n_replans = cfg.num_replans
    T_sim = cfg.num_simulation_steps
    if pack.replay_actions.shape[1] < T_sim:
        raise ValueError(
            f"the pack holds {pack.replay_actions.shape[1]} replay frames, fewer than "
            f"num_simulation_steps={T_sim}"
        )
    if pack.gt_states is not None and pack.gt_states.shape[1] < T_sim + 1 - cfg.n_step_action:
        raise ValueError("the pack's gt_states are shorter than the episode")
    if replan_noises is not None and len(replan_noises) != n_replans:
        raise ValueError(f"replan_noises has {len(replan_noises)} entries for {n_replans} replans")

    state = init_sim_state(pack, cfg)
    world_q8 = quantize_world_maps_q8(pack.world_map)  # once, outside the loop
    frames = []
    for r in range(n_replans):
        obs = render_observation(pack, state, cfg, world_q8=world_q8)
        actions = policy_fn(obs, generator if replan_noises is None else replan_noises[r])
        # policies may return an Action container or a raw [Na, T, 2] tensor
        if hasattr(actions, "controls"):
            actions = actions.controls
        if actions is None:  # as the JAX simulator, which fails to index None
            raise TypeError("the policy's Action has no controls; the simulator steps with "
                            "controls (wrap a planner in policies.wrappers.hierarchical_policy)")
        state, f = _consume_actions(pack, state, actions, cfg)
        frames.append(f)
    return state, torch.cat(frames, dim=0)
