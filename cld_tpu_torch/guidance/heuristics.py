"""Guidance rules built from the scene's state (port of
`cld_tpu/guidance/heuristics.py`): a target speed from the current or the
dataset future's speed, goals from the dataset future, a stop box ahead of
each agent, social groups, an adversarial pair, and so on, as GuidanceSpec
lists from a `sim.scene.ScenePack` and a `sim.env.SimState`, so that the
rollout CLI's `--editing-source heuristic` needs no hand-written config.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from cld_tpu_torch.guidance.losses import (
    AgentCollisionLoss,
    CollisionAttackLoss,
    GlobalStopSignLoss,
    GlobalTargetPosAtTimeLoss,
    GlobalTargetPosLoss,
    KeepDistanceLoss,
    LaneFollowingLoss,
    MapCollisionLoss,
    SocialGroupLoss,
    SpeedLimitLoss,
    StopSignLoss,
    TargetPosAtTimeLoss,
    TargetPosLoss,
    TargetSpeedLoss,
)
from cld_tpu_torch.guidance.perturbation import GuidanceSpec
from cld_tpu_torch.ops.dynamics import UnicycleParams, unicycle_step


def _states(state) -> np.ndarray:
    return state.states.detach().cpu().numpy()


def _replay_future_states(pack, state, num_frames: int, dt: float = 0.1) -> np.ndarray:
    """The dataset future in the world frame: the replay actions from the
    current frame on, rolled through the unicycle (default bounds) from the
    current states, [Na, num_frames, 4]; frame k is the state after k + 1
    steps. `dt` is the sim step the replay actions were recorded at. One
    transfer to the host at the end."""
    dyn = UnicycleParams()
    T_rep = pack.replay_actions.shape[1]
    s = state.states
    frames = []
    for k in range(num_frames):
        s = unicycle_step(dyn, s, pack.replay_actions[:, min(int(state.step) + k, T_rep - 1)],
                          dt, bound=True)
        frames.append(s)
    return torch.stack(frames, dim=1).detach().cpu().numpy()


def heuristic_target_speed(pack, state, speed_scale: float = 1.0, weight: float = 1.0,
                           target_speed_multiplier: float | None = None,
                           fut_sec: float | None = None, dt: float = 0.1):
    """Hold each agent near a target speed: with `target_speed_multiplier`,
    the dataset future's per-frame speed profile times it over `fut_sec`
    seconds ([B, T] targets); else the current speed times `speed_scale`."""
    if target_speed_multiplier is not None:
        frames = max(1, int(round((fut_sec or 5.0) / dt)))
        fut = _replay_future_states(pack, state, frames, dt=dt)
        target = np.abs(fut[:, :, 2]) * target_speed_multiplier  # [Na, frames]
    else:
        target = _states(state)[:, 2] * speed_scale
    return GuidanceSpec(TargetSpeedLoss(target_speed=target, dt=dt), weight)


def _uniform_scene_block(pack):
    """Agents per scene when the pack lays agents out as contiguous
    equal-size scene blocks (every ScenePack constructor does), else None:
    lets AgentCollisionLoss take its block-diagonal path."""
    if pack is None or getattr(pack, "scene_index", None) is None:
        return None
    si = pack.scene_index.cpu().numpy()
    _, counts = np.unique(si, return_counts=True)
    if len(np.unique(counts)) != 1:
        return None
    a = int(counts[0])
    if a <= 1 or len(si) % a:
        return None
    return a if np.array_equal(si, np.repeat(si[::a], a)) else None


def heuristic_agent_collision(weight: float = 10.0, num_disks: int = 5, buffer_dist: float = 0.2,
                              decay_rate: float = 0.9, pack=None, excluded_agents=None,
                              dt: float = 0.1):
    """Agent collision; collisions among `excluded_agents` go unpenalized
    (pairs with one excluded end still count). `dt` is accepted for the
    heuristics' common signature."""
    excluded = tuple(int(i) for i in excluded_agents) if excluded_agents else None
    return GuidanceSpec(
        AgentCollisionLoss(num_disks=num_disks, buffer_dist=buffer_dist, decay_rate=decay_rate,
                           scene_block=_uniform_scene_block(pack), excluded_agents=excluded),
        weight,
    )


def heuristic_map_collision(weight: float = 10.0, num_points_lw=(10, 10),
                            decay_rate: float = 0.9, dt: float = 0.1):
    return GuidanceSpec(
        MapCollisionLoss(num_points_lw=tuple(num_points_lw), decay_rate=decay_rate), weight)


def heuristic_speed_limit(pack=None, state=None, speed_limit: float = 15.0, weight: float = 1.0,
                          speed_limit_quantile: float | None = None, low_speed_th: float = 0.5,
                          fut_sec: float | None = None, dt: float = 0.1):
    """A speed limit, given, or with `speed_limit_quantile` that quantile of
    the dataset future's speeds above `low_speed_th` (`low_speed_th` itself
    when every agent stands)."""
    if speed_limit_quantile is not None and pack is not None:
        frames = max(1, int(round((fut_sec or 5.0) / dt)))
        speeds = np.abs(_replay_future_states(pack, state, frames, dt=dt)[:, :, 2])
        moving = speeds[speeds > low_speed_th]
        speed_limit = (float(np.nanquantile(moving, speed_limit_quantile)) if moving.size
                       else float(low_speed_th))
        if np.isnan(speed_limit):
            speed_limit = float(low_speed_th)
    return GuidanceSpec(SpeedLimitLoss(speed_limit=speed_limit), weight)


def heuristic_lane_following(pack, state, weight: float = 1.0, dt: float = 0.1, **kw):
    """Keep agents near lane centres (the closest-lane context comes from
    the observation, per replan); None for a pack without lanes."""
    if getattr(pack, "lane_points", None) is None:
        return None
    return GuidanceSpec(LaneFollowingLoss(**kw), weight)


def heuristic_global_target_pos(pack, state, horizon_s: float = 10.0, weight: float = 1.0,
                                target_time: int | None = None, urgency: float = 0.7,
                                pref_speed: float | None = None,
                                min_progress_dist: float = 0.5, perturb_std: float = 0.0,
                                seed: int = 0, dt: float = 0.1, **_host_only):
    """A world-frame goal: with `target_time` frames, the dataset future's
    position then (`pref_speed` by default each agent's mean future speed);
    else constant velocity over `horizon_s`. The reference's host-side knobs
    (`action_num`, `target_tolerance`) are accepted and ignored."""
    if target_time is not None:
        fut = _replay_future_states(pack, state, int(target_time), dt=dt)
        goal = fut[:, -1, :2].astype(np.float64)
        if pref_speed is None:
            pref_speed = np.mean(np.abs(fut[:, :, 2]), axis=1)
    else:
        s = _states(state)
        goal = s[:, :2] + horizon_s * s[:, 2:3] * np.stack([np.cos(s[:, 3]), np.sin(s[:, 3])],
                                                            axis=-1)
    if perturb_std > 0:
        goal = goal + np.random.default_rng(seed).normal(0, perturb_std, goal.shape)
    kw = {} if pref_speed is None else {"pref_speed": np.asarray(pref_speed, np.float32)}
    return GuidanceSpec(
        GlobalTargetPosLoss(target_pos_world=goal.astype(np.float32), urgency=urgency,
                            min_progress_dist=min_progress_dist, dt=dt, **kw),
        weight,
    )


def _to_agent_frame(s: np.ndarray, world_xy: np.ndarray) -> np.ndarray:
    """World points [Na, 2] -> each agent's current frame."""
    c, si = np.cos(s[:, 3]), np.sin(s[:, 3])
    rel = world_xy - s[:, :2]
    return np.stack([c * rel[:, 0] + si * rel[:, 1], -si * rel[:, 0] + c * rel[:, 1]], axis=-1)


def heuristic_stop_sign(pack, state, ahead_m: float = 15.0, box_half=(5.0, 3.0),
                        weight: float = 5.0, target_time: int | None = None, stop_box_dim=None,
                        scale: float = 20.0, dt: float = 0.1, num_time_steps_to_stop: int = 3,
                        low_speed_th: float = 0.5, horizon_length: int | None = None,
                        **_host_only):
    """A stop box ahead of each agent, in its frame: with `target_time`, at
    the dataset future's position then with full dims `stop_box_dim`; else
    `ahead_m` ahead with half extents `box_half`."""
    B = pack.num_agents
    if target_time is not None:
        fut = _replay_future_states(pack, state, int(target_time), dt=dt)
        center = _to_agent_frame(_states(state), fut[:, -1, :2])
    else:
        center = np.tile([ahead_m, 0.0], (B, 1))
    if stop_box_dim is not None:
        dim = np.tile(np.asarray(stop_box_dim, np.float32), (B, 1))
    else:
        dim = np.tile(np.asarray(box_half, np.float32) * 2.0, (B, 1))
    kw = {} if horizon_length is None else {"horizon_length": int(horizon_length)}
    return GuidanceSpec(
        StopSignLoss(stop_sign_pos=center.astype(np.float32), stop_box_dim=dim.astype(np.float32),
                     scale=scale, num_time_steps_to_stop=num_time_steps_to_stop,
                     low_speed_th=low_speed_th, **kw),
        weight,
    )


def heuristic_collision_attack(attacker: int, victim: int, weight: float = 5.0,
                               time_lo: int = 20, time_hi: int = 52):
    """Steer `attacker` into `victim`."""
    return GuidanceSpec(CollisionAttackLoss(attacker_ind=attacker, victim_ind=victim,
                                            time_lo=time_lo, time_hi=time_hi), weight)


def heuristic_keep_distance(target: int, ref: int, min_dist=5.0, max_dist=15.0, weight=2.0):
    return GuidanceSpec(KeepDistanceLoss(target_ind=target, ref_ind=ref, min_dist=min_dist,
                                         max_dist=max_dist), weight)


def heuristic_social_group(pack, state, group_dist_thresh: float = 10.0,
                           social_dist: float = 2.0, cohesion: float = 0.8, weight: float = 2.0,
                           seed: int = 0, dt: float = 0.1) -> List[GuidanceSpec]:
    """Social groups: the connected components (of more than one agent) of
    the graph of same-scene agents within `group_dist_thresh` of each other
    whose headings agree (agents under 0.9 m/s agree with all)."""
    s = _states(state)
    pos, vel_mag, yaw = s[:, :2], s[:, 2], s[:, 3]
    vel = vel_mag[:, None] * np.stack([np.cos(yaw), np.sin(yaw)], axis=-1)
    not_moving = np.abs(vel_mag) < 0.9
    d = vel / (np.linalg.norm(vel, axis=-1, keepdims=True) + 1e-6)
    move_sim = d @ d.T >= 0
    move_sim[not_moving, :] = True
    move_sim[:, not_moving] = True
    dist = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    scene = pack.scene_index.cpu().numpy()
    adj = (dist <= group_dist_thresh) & move_sim & (scene[:, None] == scene[None])
    np.fill_diagonal(adj, False)
    parent = np.arange(len(pos))  # union-find over the adjacency

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i, j in zip(*np.nonzero(adj)):
        parent[find(i)] = find(j)
    roots = np.array([find(i) for i in range(len(pos))])
    specs = []
    for r in np.unique(roots):
        members = tuple(int(i) for i in np.nonzero(roots == r)[0])
        if len(members) > 1:
            specs.append(GuidanceSpec(SocialGroupLoss(group=members, social_dist=social_dist,
                                                      cohesion=cohesion), weight))
    return specs


def heuristic_target_pos_at_time(pack, state, target_time: int = 40, weight: float = 1.0,
                                 perturb_std: float = 0.0, seed: int = 0,
                                 dt: float = 0.1) -> GuidanceSpec:
    """A waypoint: the dataset future's position `target_time` frames ahead,
    in each agent's current frame, to be reached at plan step
    target_time - 1."""
    tgt_world = _replay_future_states(pack, state, target_time, dt=dt)[:, -1, :2]
    if perturb_std > 0:
        tgt_world = tgt_world + np.random.default_rng(seed).normal(0, perturb_std,
                                                                   tgt_world.shape)
    local = _to_agent_frame(_states(state), tgt_world)
    tt = np.full(len(local), target_time - 1, np.int64)
    return GuidanceSpec(TargetPosAtTimeLoss(target_pos=local.astype(np.float32), target_time=tt),
                        weight)


def heuristic_global_target_pos_at_time(pack, state, target_time: int = 60, urgency: float = 0.5,
                                        pref_speed: float | None = None,
                                        target_tolerance: float = 2.0, weight: float = 1.0,
                                        perturb_std: float = 0.0, seed: int = 0,
                                        dt: float = 0.1, **_host_only) -> GuidanceSpec:
    """A world-frame waypoint and global frame from the dataset future;
    `pref_speed` by default each agent's mean future speed."""
    fut = _replay_future_states(pack, state, target_time, dt=dt)
    tgt = fut[:, -1, :2].astype(np.float32)
    if perturb_std > 0:
        tgt = (tgt + np.random.default_rng(seed).normal(0, perturb_std, tgt.shape)).astype(
            np.float32)
    if pref_speed is None:
        pref_speed = np.mean(np.abs(fut[:, :, 2]), axis=1)
    # fut[:, -1] is the state at global frame step + target_time, reached by
    # plan index target_time - 1
    tt = np.full(len(tgt), int(state.step) + target_time - 1, np.int64)
    return GuidanceSpec(
        GlobalTargetPosAtTimeLoss(target_pos_world=tgt, target_time=tt,
                                  urgency=np.full(len(tgt), urgency, np.float32),
                                  pref_speed=np.asarray(pref_speed, np.float32),
                                  target_tolerance=target_tolerance, dt=dt),
        weight,
    )


def heuristic_global_stop_sign(pack, state, ahead_m: float = 15.0, box_dim=(10.0, 6.0),
                               weight: float = 5.0, num_time_steps_to_stop: int = 3,
                               low_speed_th: float = 0.5, target_time: int | None = None,
                               stop_box_dim=None, scale: float = 20.0,
                               horizon_length: int | None = None, action_num: int | None = None,
                               dt: float = 0.1) -> GuidanceSpec:
    """A world-frame stop box ahead of each agent: with `target_time`, at the
    dataset future's position then, with full dims `stop_box_dim`; else
    `ahead_m` ahead."""
    s = _states(state)
    if target_time is not None:
        center = _replay_future_states(pack, state, int(target_time), dt=dt)[:, -1, :2]
    else:
        center = s[:, :2] + ahead_m * np.stack([np.cos(s[:, 3]), np.sin(s[:, 3])], -1)
    dim = np.tile(stop_box_dim if stop_box_dim is not None else box_dim,
                  (len(center), 1)).astype(np.float32)
    kw = {}
    if horizon_length is not None:
        kw["horizon_length"] = int(horizon_length)
    if action_num is not None:
        kw["action_num"] = int(action_num)
    return GuidanceSpec(
        GlobalStopSignLoss(stop_sign_pos=center.astype(np.float32), stop_box_dim=dim,
                           num_time_steps_to_stop=num_time_steps_to_stop,
                           low_speed_th=low_speed_th, scale=scale, **kw),
        weight,
    )


def heuristic_target_pos(pack, state, target_time: int = 40, weight: float = 1.0,
                         perturb_std: float = 0.0, seed: int = 0,
                         dt: float = 0.1) -> GuidanceSpec:
    """The waypoint of `heuristic_target_pos_at_time`, to be passed near at
    any step (TargetPosLoss)."""
    timed = heuristic_target_pos_at_time(pack, state, target_time=target_time, weight=weight,
                                         perturb_std=perturb_std, seed=seed, dt=dt)
    return GuidanceSpec(TargetPosLoss(target_pos=timed.loss.target_pos), weight)


def _select_interacting_pair(pack, state, angle_diff_max_th: float, dist_min: float = 10.0,
                             dist_max: float = 30.0, min_current_speed: float = 2.0,
                             sort_by_distance: bool = True, dt: float = 0.1):
    """The adversarial pair: among moving same-scene agents, pairs whose
    headings differ by less than `angle_diff_max_th` and whose separation
    lies in (dist_min, dist_max) now and 2 s into the dataset future;
    (behind, ahead) of the closest (or first) such pair, or None."""
    frames = min(int(round(2.0 / dt)), pack.replay_actions.shape[1])
    fut = _replay_future_states(pack, state, max(frames, 1), dt=dt)
    s = _states(state)
    pos0, yaw0, speed0 = s[:, :2], s[:, 3], np.abs(s[:, 2])
    posk, yawk = fut[:, frames - 1, :2], fut[:, frames - 1, 3]
    scene = pack.scene_index.cpu().numpy()

    def pair_ok(p, y):
        yd = np.abs(y[:, None] - y[None])
        pd = np.linalg.norm(p[:, None] - p[None], axis=-1)
        return (yd < angle_diff_max_th) & (pd > dist_min) & (pd < dist_max), pd

    ok0, _ = pair_ok(pos0, yaw0)
    okk, pdk = pair_ok(posk, yawk)
    moving = speed0 > min_current_speed
    valid = ok0 & okk & moving[:, None] & moving[None] & (scene[:, None] == scene[None])
    np.fill_diagonal(valid, False)
    if not valid.any():
        return None
    idx = np.argwhere(valid)
    if sort_by_distance:
        idx = idx[np.argsort(pdk[valid])]
    i, j = int(idx[0, 0]), int(idx[0, 1])
    rel = pos0[j] - pos0[i]
    ahead = rel[0] * np.cos(yaw0[i]) + rel[1] * np.sin(yaw0[i]) > 0  # is j ahead of i?
    return (i, j) if ahead else (j, i)


def heuristic_gptcollision(pack, state, collision_radius: float = 1.0, weight: float = 5.0,
                           dt: float = 0.1, **_host_only):
    """The behind agent of an auto-selected pair attacks the one ahead.
    `collision_radius` (the reference's success radius) is accepted and
    unused: the rule minimizes the pair's distance."""
    pair = _select_interacting_pair(pack, state, angle_diff_max_th=0.4 * np.pi,
                                    sort_by_distance=True, dt=dt)
    if pair is None:
        return None
    return heuristic_collision_attack(pair[0], pair[1], weight=weight)


def heuristic_gptkeepdistance(pack, state, min_distance: float = 5.0, max_distance: float = 15.0,
                              weight: float = 2.0, dt: float = 0.1, **_host_only):
    """Keep distance within an auto-selected pair."""
    pair = _select_interacting_pair(pack, state, angle_diff_max_th=0.2 * np.pi,
                                    sort_by_distance=False, dt=dt)
    if pair is None:
        return None
    return heuristic_keep_distance(pair[0], pair[1], min_dist=min_distance,
                                   max_dist=max_distance, weight=weight)


HEURISTIC_MAP = {
    "target_speed": heuristic_target_speed,
    "agent_collision": lambda pack, state, **kw: heuristic_agent_collision(pack=pack, **kw),
    "map_collision": lambda pack, state, **kw: heuristic_map_collision(**kw),
    "speed_limit": heuristic_speed_limit,
    "lane_following": heuristic_lane_following,
    "global_target_pos": heuristic_global_target_pos,
    "stop_sign": heuristic_stop_sign,
    "social_group": heuristic_social_group,
    "target_pos": heuristic_target_pos,
    "target_pos_at_time": heuristic_target_pos_at_time,
    "global_target_pos_at_time": heuristic_global_target_pos_at_time,
    "global_stop_sign": heuristic_global_stop_sign,
    "gptcollision": heuristic_gptcollision,
    "gptkeepdistance": heuristic_gptkeepdistance,
}


def compute_heuristic_guidance(names: Sequence[str], pack, state,
                               dt: float = 0.1) -> List[GuidanceSpec]:
    """Specs of the named heuristics; a heuristic may give one spec, a list
    (social groups) or none. `dt` is the sim step time."""
    specs: List[GuidanceSpec] = []
    for n in names:
        built = HEURISTIC_MAP[n](pack, state, dt=dt)
        if built is not None:
            specs.extend(built if isinstance(built, list) else [built])
    return specs


# the reference's host-side knobs, accepted and dropped, per heuristic
_REF_DROP_PARAMS = {
    "global_target_pos": ("action_num", "target_tolerance"),
    "global_target_pos_at_time": ("action_num",),
    "stop_sign": ("action_num",),
}


def heuristics_from_configs(configs: Sequence[dict], pack, state,
                            dt: float = 0.1) -> List[GuidanceSpec]:
    """Specs from heuristic configs in the reference's format, a list of
    {"name", "weight", "params"} dicts with its parameter names. A config's
    `dt` overrides the sim's; `excluded_agents` is agent_collision's only."""
    specs: List[GuidanceSpec] = []
    for cfg in configs:
        missing = {"name", "weight", "params"} - set(cfg)
        if missing:
            raise ValueError(f"heuristic config missing fields {sorted(missing)}: {cfg}")
        name = cfg["name"]
        if name not in HEURISTIC_MAP:
            raise KeyError(f"unknown heuristic {name!r}; known: {sorted(HEURISTIC_MAP)}")
        params = dict(cfg["params"])
        cfg_dt = params.pop("dt", None)
        excluded = params.pop("excluded_agents", None)
        if excluded is not None:
            if name != "agent_collision":
                raise ValueError(f"excluded_agents is only meaningful for agent_collision; got "
                                 f"it on {name!r}")
            params["excluded_agents"] = tuple(int(i) for i in excluded)
        for k in _REF_DROP_PARAMS.get(name, ()):
            params.pop(k, None)
        built = HEURISTIC_MAP[name](pack, state, weight=cfg["weight"],
                                    dt=float(cfg_dt) if cfg_dt is not None else dt, **params)
        if built is not None:
            specs.extend(built if isinstance(built, list) else [built])
    return specs
