"""The learned (EBM) closed-loop realism metric (port of
`cld_tpu/sim/learned_metrics.py`): after a rollout, for each anchor frame
re-render the observation from the world-frame trajectory log, put the
executed future into the anchor agent's frame and score it with
`PermuteEBM.get_scores`. A Python loop over the anchors; each render is one
semantic-map warp (one `value_gather` launch on the card).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from cld_tpu_torch.data.batch import TrafficBatch
from cld_tpu_torch.ops.geometry import transform_points
from cld_tpu_torch.ops.raster import quantize_world_maps_q8
from cld_tpu_torch.sim.env import SimConfig, SimState, render_observation
from cld_tpu_torch.sim.scene import ScenePack

Scorer = Callable[[TrafficBatch], torch.Tensor]  # (obs) -> [Na] matched-pair scores


def _sim_state_at(traj: torch.Tensor, t: int, Th: int) -> SimState:
    """The SimState at frame t rebuilt from the log [T, Na, 4]; history
    indices clamp at 0 (the reference buffer's warm-up)."""
    T, Na = traj.shape[:2]
    idx_h = torch.clamp(t - torch.arange(Th - 1, -1, -1, device=traj.device), 0, T - 1)
    zeros = traj.new_zeros((Na,))
    return SimState(
        states=traj[t],
        history=traj[idx_h].transpose(0, 1),  # [Na, Th, 4]
        step=int(t),
        offroad_steps=zeros,
        collision_steps=zeros,
        collision_type_steps=traj.new_zeros((Na, 3)),
        max_abs_acc=zeros,
        max_abs_yawvel=zeros,
    )


def ebm_rollout_scores(pack: ScenePack, traj: torch.Tensor, ebm_apply: Scorer, cfg: SimConfig,
                       horizon: int = 52, stride: int = 10) -> torch.Tensor:
    """Scores [num_anchors, Na] of the executed rollout `traj` [T, Na, 4]
    (world frame) at anchor frames 0, stride, 2 * stride, ... below T - 1
    (at least frame 0), higher = more like the EBM's training data. Future
    frames past the log's end clamp to its last frame with availability 0."""
    T = traj.shape[0]
    Th = cfg.hist_frames + 1
    world_q8 = quantize_world_maps_q8(pack.world_map)
    fut_steps = torch.arange(horizon, device=traj.device)
    scores = []
    for t in range(0, max(T - 1, 1), stride):
        state = _sim_state_at(traj, t, Th)
        obs = render_observation(pack, state, cfg, world_q8=world_q8)
        fut_t = t + 1 + fut_steps  # [H]
        avail = (fut_t < T).to(torch.float32)
        fut = traj[torch.clamp(fut_t, 0, T - 1)]  # [H, Na, 4]
        pos_a = transform_points(fut[..., :2].transpose(0, 1), obs.agent_from_world)
        yaw_a = fut[..., 3].transpose(0, 1)[..., None] - state.states[:, 3][:, None, None]
        obs = obs._replace(target_positions=pos_a, target_yaws=yaw_a,
                           target_availabilities=avail[None].expand(pos_a.shape[:2]))
        scores.append(ebm_apply(obs))
    return torch.stack(scores)


def ebm_rollout_metric(pack: ScenePack, traj: torch.Tensor, ebm_apply: Scorer, cfg: SimConfig,
                       horizon: int = 52, stride: int = 10) -> Dict[str, torch.Tensor]:
    """Mean and min score over anchors and agents, and each agent's mean."""
    scores = ebm_rollout_scores(pack, traj, ebm_apply, cfg, horizon, stride)
    return {
        "ebm_score_mean": scores.mean(),
        "ebm_score_min": scores.min(),
        "ebm_score_per_agent": scores.mean(dim=0),
    }
