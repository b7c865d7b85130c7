"""Hardcoded policies for testing and replay (port of
`cld_tpu/policies/hardcoded.py`): echo the ground-truth future, replay a
logged action sequence, constant controls.

`replay_policy` reproduces the JAX package exactly, including its defect:
it returns the whole log [B, T_total, 2] as `controls`, and the simulator
reads `controls[:, k]` for k < n_step_action at every replan
(`sim.env._consume_actions`), so a *controlled* agent applies frames
0 .. n_step_action - 1 of its log at every replan. Only uncontrolled agents
index the log by the sim step and so follow the dataset (ROADMAP Queue C).
"""

from __future__ import annotations

import torch

from cld_tpu_torch.policies.common import Action


def gt_policy(obs, rng=None) -> Action:
    """Echo the observation's ground-truth future."""
    return Action(positions=obs.target_positions, yaws=obs.target_yaws)


def replay_policy(action_log: torch.Tensor):
    """Serve the logged controls [B, T_total, 2] as a fixed plan (see the
    module's docstring for what the simulator makes of it)."""

    def policy(obs, rng=None) -> Action:
        B = obs.curr_speed.shape[0]
        T = action_log.shape[1]
        dev = obs.curr_speed.device
        return Action(
            positions=torch.zeros((B, T, 2), device=dev),
            yaws=torch.zeros((B, T, 1), device=dev),
            controls=action_log,
        )

    return policy


def constant_policy(acc: float = 0.0, yawvel: float = 0.0, horizon: int = 52):
    """Constant-control mock policy."""

    def policy(obs, rng=None) -> Action:
        B = obs.curr_speed.shape[0]
        dev = obs.curr_speed.device
        u = torch.empty((B, horizon, 2), device=dev)
        u[..., 0] = acc
        u[..., 1] = yawvel
        return Action(
            positions=torch.zeros((B, horizon, 2), device=dev),
            yaws=torch.zeros((B, horizon, 1), device=dev),
            controls=u,
        )

    return policy
