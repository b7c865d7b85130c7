"""Guidance-satisfaction metrics (port of `cld_tpu/guidance/metrics.py`):
each rule scores the executed closed-loop trajectory, as its loss at N = 1
on the executed [B, T, 6] world history (0: fully satisfied)."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from cld_tpu_torch.guidance.losses import GuidanceContext
from cld_tpu_torch.guidance.perturbation import GuidanceSpec
from cld_tpu_torch.ops.dynamics import angle_diff


def executed_traj_from_states(states: torch.Tensor, dt: float = 0.1) -> torch.Tensor:
    """[T, B, 4] simulator log (x, y, v, yaw world) -> [B, 1, T, 6]
    state-and-action trajectories. Speed and yaw are the simulator's; acc
    and yaw rate are their finite differences (0 at the first frame).
    Positions stay in the world frame: rules evaluated on these use an
    identity world_from_agent."""
    s = states.permute(1, 0, 2)  # [B, T, 4]
    v, yaw = s[..., 2:3], s[..., 3:4]
    acc = torch.diff(v, dim=-2, prepend=v[..., :1, :]) / dt
    yawvel = angle_diff(yaw[..., 1:, :], yaw[..., :-1, :]) / dt
    yawvel = torch.cat([yawvel[..., :1, :] * 0, yawvel], dim=-2)
    return torch.cat([s[..., :2], v, yaw, acc, yawvel], dim=-1)[:, None]


def guidance_metrics(specs: Sequence[GuidanceSpec], executed: torch.Tensor,
                     ctx: GuidanceContext) -> Dict[str, np.ndarray]:
    """{rule_name_i: [B] loss on the executed trajectory}, NaN for agents
    outside the rule's mask."""
    out: Dict[str, np.ndarray] = {}
    B = executed.shape[0]
    with torch.no_grad():
        for i, spec in enumerate(specs):
            mask = (torch.as_tensor(spec.agent_mask, device=executed.device)
                    if spec.agent_mask is not None
                    else torch.ones((B,), dtype=torch.bool, device=executed.device))
            val = spec.loss(executed, ctx, agt_mask=mask)[:, 0]  # [B]
            val = torch.where(mask, val, torch.full_like(val, float("nan")))
            out[f"{type(spec.loss).__name__}_{i}"] = val.cpu().numpy()
    return out
