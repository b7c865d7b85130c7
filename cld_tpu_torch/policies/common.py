"""Action / Plan containers (port of `cld_tpu/policies/common.py`). A policy
is a function `(obs: TrafficBatch, rng) -> Action` usable by
`sim.env.simulate`; `rng` is a `torch.Generator` (or None) the policy draws
from, or explicit noise in the structure the policy documents."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Action(NamedTuple):
    positions: torch.Tensor  # [B, T, 2] agent frame
    yaws: torch.Tensor  # [B, T, 1]
    # optional unicycle controls; when present the simulator steps with these
    controls: Optional[torch.Tensor] = None  # [B, T, 2] (acc, yawvel)


class Plan(NamedTuple):
    positions: torch.Tensor
    yaws: torch.Tensor
    availabilities: torch.Tensor


def action_from_trajectory(traj: torch.Tensor) -> Action:
    """[B, T, 6] (x, y, v, yaw, acc, yawvel) -> Action."""
    return Action(positions=traj[..., :2], yaws=traj[..., 3:4], controls=traj[..., 4:6])
