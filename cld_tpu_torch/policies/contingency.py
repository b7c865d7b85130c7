"""Sampling-based contingency planning over trajectory trees (port of
`cld_tpu/policies/contingency.py`).

Trees stay in tiled dense form, `[K^S, T, ...]` for an S-stage,
K-branching ego tree and `[M^S, ...]` for the scenario tree, and the stage
dynamic program is a static loop over stages of dense `[K^t, M^t]` value
tables: reshapes and min / expectation reductions. Where the JAX package
vmaps one agent's plan over the agents, here every function carries the
agents as a leading batch dimension.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from cld_tpu_torch.algos.reward import drivable_values_at
from cld_tpu_torch.data.batch import TrafficBatch, get_current_states
from cld_tpu_torch.ops.dynamics import (
    RECORD_DYNAMICS,
    UnicycleParams,
    _clip,
    angle_diff,
    unicycle_forward_dynamics,
)
from cld_tpu_torch.policies.common import Action
from cld_tpu_torch.policies.mpc import _cv_predict_neighbors


def collision_cost(
    ego_pos: torch.Tensor,  # [..., T, 2]
    ego_extent: torch.Tensor,  # [..., 2]
    agent_pos: torch.Tensor,  # [..., Nobs, T, 2]
    agent_extent: torch.Tensor,  # [..., Nobs, 2]
    agent_mask: torch.Tensor,  # [..., Nobs]
) -> torch.Tensor:
    """Soft collision cost max over neighbors and time of
    sigmoid(-4 clearance) (the disk form of the reference's
    `get_collision_loss`); leading dims broadcast."""
    d = torch.linalg.norm(ego_pos[..., None, :, :] - agent_pos, dim=-1)  # [..., Nobs, T]
    rad = (ego_extent[..., None, 0] + agent_extent[..., 0]) / 2.0  # [..., Nobs]
    per = torch.sigmoid(-(d - rad[..., None]) * 4.0) * agent_mask[..., None]
    return per.amax(dim=(-1, -2))


def drivable_cost(
    ego_pos: torch.Tensor,  # [B, K, T, 2] each agent's candidates
    drivable_map: torch.Tensor,  # [B, H, W]
    raster_from_agent: torch.Tensor,  # [B, 3, 3]
) -> torch.Tensor:
    """Off-road fraction of each candidate [B, K] (the reference's
    `get_drivable_area_loss` with the indicator as the penalty)."""
    return (1.0 - drivable_values_at(ego_pos, drivable_map, raster_from_agent)).mean(dim=-1)


def progress_reward(ego_pos: torch.Tensor, d_sat: torch.Tensor) -> torch.Tensor:
    """Saturated total travelled distance of ego_pos [..., T, 2] against
    d_sat (broadcast over the leading dims)."""
    seg = torch.linalg.norm(torch.diff(ego_pos, dim=-2), dim=-1).sum(-1)
    return torch.minimum(seg, d_sat) / torch.clamp(d_sat, min=1e-3)


def ego_sample_planning(
    ego_trajs: torch.Tensor,  # [B, K, T, 3] candidate (x, y, yaw)
    agent_traj: torch.Tensor,  # [B, Nobs, T, 2]
    ego_extent: torch.Tensor,  # [B, 2]
    agent_extent: torch.Tensor,  # [B, Nobs, 2]
    agent_mask: torch.Tensor,  # [B, Nobs]
    drivable_map: torch.Tensor,  # [B, H, W]
    raster_from_agent: torch.Tensor,  # [B, 3, 3]
    weights: Dict[str, float],
    log_likelihood: Optional[torch.Tensor] = None,  # [B, K]
) -> torch.Tensor:
    """The best candidate per agent [B]: argmax of likelihood + progress -
    collision - lane costs (the reference's `ego_sample_planning`)."""
    col = collision_cost(ego_trajs[..., :2], ego_extent[:, None], agent_traj[:, None],
                         agent_extent[:, None], agent_mask[:, None])  # [B, K]
    lane = drivable_cost(ego_trajs[..., :2], drivable_map, raster_from_agent)
    prog = torch.linalg.norm(torch.diff(ego_trajs[..., :2], dim=-2), dim=-1).sum(-1)
    ll = torch.zeros_like(col) if log_likelihood is None else log_likelihood
    score = (weights.get("likelihood_weight", 0.0) * ll
             + weights.get("progress_weight", 0.0) * prog
             - weights.get("collision_weight", 1.0) * col
             - weights.get("lane_weight", 1.0) * lane)
    return torch.argmax(score, dim=-1)


@dataclasses.dataclass(frozen=True)
class ContingencyConfig:
    stages: int = 2  # S tree layers
    frames_per_stage: int = 10  # F
    target_speeds: Tuple[float, ...] = (0.0, 5.0, 10.0)
    yawvels: Tuple[float, ...] = (-0.2, 0.0, 0.2)
    num_modes: int = 2  # Ma: scenario branching per stage
    dt: float = 0.1
    w_collision: float = 10.0
    w_lane: float = 1.0
    w_progress: float = 1.0
    speed_gain: float = 1.0
    dyn: UnicycleParams = RECORD_DYNAMICS

    @property
    def K(self) -> int:
        return len(self.target_speeds) * len(self.yawvels)

    @property
    def horizon(self) -> int:
        return self.stages * self.frames_per_stage


def build_ego_tree(cfg: ContingencyConfig, curr: torch.Tensor) -> torch.Tensor:
    """Tiled S-stage ego trajectory trees [B, K^S, S*F, 4] from current
    states curr [B, 4]: every stage re-branches each node over the
    (target speed x yaw rate) lattice, a P-controller toward the target
    speed and a constant yaw rate."""
    K, S, F, dt = cfg.K, cfg.stages, cfg.frames_per_stage, cfg.dt
    dev = curr.device
    speeds = torch.tensor([s for s in cfg.target_speeds for _ in cfg.yawvels], device=dev)
    yaws = torch.tensor([w for _ in cfg.target_speeds for w in cfg.yawvels], device=dev)
    B = curr.shape[0]

    states = curr[:, None]  # [B, 1, 4]
    segs = []
    for _ in range(S):
        n = states.shape[1]
        v = states[..., 2][..., None].expand(B, n, K)
        acc = []
        for _ in range(F):
            a = _clip(cfg.speed_gain * (speeds - v), cfg.dyn.acce_lo, cfg.dyn.acce_hi)
            v = _clip(v + a * dt, cfg.dyn.v_lo, cfg.dyn.v_hi)
            acc.append(a)
        yawvel = yaws[:, None].expand(K, F).expand(B, n, K, F)
        acts = torch.stack([torch.stack(acc, dim=-1), yawvel], dim=-1).reshape(B, n * K, F, 2)
        x0 = states.repeat_interleave(K, dim=1)  # [B, n*K, 4]
        xs = unicycle_forward_dynamics(cfg.dyn, x0, acts, dt)  # [B, n*K, F, 4]
        segs.append(xs)
        states = xs[..., -1, :]
    Ne = K ** S
    return torch.cat([xs.repeat_interleave(Ne // xs.shape[1], dim=1) for xs in segs], dim=-2)


def contingency_plan(
    cfg: ContingencyConfig,
    ego_tiled: torch.Tensor,  # [B, K^S, T, 4]
    agent_modes: torch.Tensor,  # [B, Ma^S, Nobs, T, 2] tiled scenario trees
    mode_prob: torch.Tensor,  # [Ma^S] leaf probabilities (sum 1)
    agent_mask: torch.Tensor,  # [B, Nobs]
    ego_extent: torch.Tensor,  # [B, 2]
    agent_extent: torch.Tensor,  # [B, Nobs, 2]
    drivable_map: torch.Tensor,  # [B, H, W]
    raster_from_agent: torch.Tensor,  # [B, 3, 3]
    curr_speed: Optional[torch.Tensor] = None,  # [B] v0 (progress reference)
) -> Dict[str, torch.Tensor]:
    """Stage-wise dynamic program over the ego x scenario trees (the
    reference's `contingency_planning`): V at the leaves is the stage loss;
    an interior V adds the min over ego children of the scenario-expected
    cost-to-go; the chosen branch is the argmin root child under the stage-1
    mode distribution, continued greedily to the cheapest leaf of its
    subtree. Returns branch [B], leaf [B], plan [B, T, 4], root_cost [B, K]
    and value (the root stage's V)."""
    K, S, F = cfg.K, cfg.stages, cfg.frames_per_stage
    Ma = cfg.num_modes
    B = ego_tiled.shape[0]
    dev = ego_tiled.device
    # progress saturates at the CURRENT speed's distance; ego_tiled[:, 0, 0]
    # is already one step in
    v0 = ego_tiled[:, 0, 0, 2] if curr_speed is None else curr_speed
    d_sat = torch.clamp(v0, min=2.0) * F * cfg.dt  # [B]
    mask = agent_mask.to(ego_tiled.dtype)

    def stage_loss(t):
        """L_t [B, K^(t+1), Ma^(t+1)] on representative tiled rows."""
        ne, na = K ** (t + 1), Ma ** (t + 1)
        ego_rows = torch.arange(ne, device=dev) * (K ** (S - t - 1))
        agt_rows = torch.arange(na, device=dev) * (Ma ** (S - t - 1))
        seg = slice(t * F, (t + 1) * F)
        ego_seg = ego_tiled[:, ego_rows, seg]  # [B, ne, F, 4]
        agt_seg = agent_modes[:, agt_rows][:, :, :, seg]  # [B, na, Nobs, F, 2]
        col = collision_cost(ego_seg[:, :, None, :, :2], ego_extent[:, None, None],
                             agt_seg[:, None], agent_extent[:, None, None],
                             mask[:, None, None])  # [B, ne, na]
        lane = drivable_cost(ego_seg[..., :2], drivable_map, raster_from_agent)  # [B, ne]
        prog = progress_reward(ego_seg[..., :2], d_sat[:, None])
        return cfg.w_collision * col + (cfg.w_lane * lane - cfg.w_progress * prog)[..., None]

    def node_prob(t):
        """[Ma^(t+1)] subtree probability of each scenario node at stage t."""
        return mode_prob.reshape(Ma ** (t + 1), -1).sum(-1)

    V = stage_loss(S - 1)  # [B, K^S, Ma^S]
    for t in range(S - 2, -1, -1):
        pc = node_prob(t + 1).reshape(Ma ** (t + 1), Ma)
        w = pc / torch.clamp(pc.sum(-1, keepdim=True), min=1e-9)
        Q = torch.einsum("bijm,jm->bij", V.reshape(B, V.shape[1], Ma ** (t + 1), Ma), w)
        V = stage_loss(t) + Q.reshape(B, -1, K, Ma ** (t + 1)).amin(dim=2)

    root_cost = (V * node_prob(0)).sum(-1)  # [B, K]
    best = torch.argmin(root_cost, dim=-1)  # [B]
    leaf_stride = K ** (S - 1)
    leaf = best * leaf_stride
    if S > 1:
        leaf_rows = best[:, None] * leaf_stride + torch.arange(leaf_stride, device=dev)
        leaf_cost = (stage_loss(S - 1) * node_prob(S - 1)).sum(-1)  # [B, K^S]
        pick = torch.argmin(torch.gather(leaf_cost, 1, leaf_rows), dim=-1)
        leaf = leaf_rows[torch.arange(B, device=dev), pick]
    return {"branch": best, "leaf": leaf,
            "plan": ego_tiled[torch.arange(B, device=dev), leaf],
            "root_cost": root_cost, "value": V}


def plan_from_observation(cfg: ContingencyConfig, obs: TrafficBatch) -> Dict[str, torch.Tensor]:
    """`contingency_plan` on an observation: the ego trees from the current
    states; constant-velocity neighbor predictions give two base scenario
    modes per stage (keep going, and brake: time reparameterized to 60% of
    the progress), tiled into Ma^S leaves of equal probability."""
    Ma, S, T = cfg.num_modes, cfg.stages, cfg.horizon
    curr = get_current_states(obs)
    dev = curr.device
    pred, mask = _cv_predict_neighbors(obs, T, cfg.dt)  # [B, Nobs, T, 2], [B, Nobs]
    slow_idx = (torch.arange(T, dtype=torch.float32, device=dev) * 0.6).to(torch.int64)
    base = torch.stack([pred, pred[:, :, slow_idx]], dim=1)[:, :Ma]  # [B, Ma, Nobs, T, 2]
    Mtot = Ma ** S
    div = Ma ** (S - 1 - torch.arange(S, device=dev))
    leaf_mode = (torch.arange(Mtot, device=dev)[:, None] // div[None]) % Ma  # [Mtot, S]
    F = cfg.frames_per_stage
    agent_modes = torch.cat([base[:, leaf_mode[:, t]][..., t * F:(t + 1) * F, :]
                             for t in range(S)], dim=3)  # [B, Mtot, Nobs, T, 2]
    prob = torch.full((Mtot,), 1.0 / Mtot, device=dev)
    agent_ext = torch.tensor([4.5, 2.0], device=dev).expand(*mask.shape, 2)
    return contingency_plan(cfg, build_ego_tree(cfg, curr), agent_modes, prob, mask,
                            obs.extent[:, :2], agent_ext, obs.drivable_map,
                            obs.raster_from_agent, curr_speed=curr[:, 2])


def contingency_policy(cfg: ContingencyConfig = ContingencyConfig()):
    """The contingency-planner policy `(obs, rng) -> Action`: the plan of
    `plan_from_observation`, with its controls by inverse dynamics."""
    if cfg.num_modes > 2:
        raise ValueError(f"num_modes={cfg.num_modes}: only 2 base scenario modes exist "
                         "(keep-CV and brake)")

    def policy(obs: TrafficBatch, rng=None) -> Action:
        curr = get_current_states(obs)
        plan = plan_from_observation(cfg, obs)["plan"]  # [B, T, 4]
        acc = torch.diff(plan[..., 2], dim=-1, prepend=curr[:, 2:3]) / cfg.dt
        prev_yaw = torch.cat([curr[:, 3:4], plan[..., 3][:, :-1]], dim=-1)
        yawvel = angle_diff(plan[..., 3], prev_yaw) / cfg.dt
        return Action(positions=plan[..., :2], yaws=plan[..., 3:4],
                      controls=torch.stack([acc, yawvel], dim=-1))

    return policy
