"""Scene-centric closed-loop policy (port of `cld_tpu/policies/scene_policy.py`):
the simulator's flat agent observations are regrouped into a `SceneBatch`
(scenes x agents), the scene diffusion model samples every agent's
trajectory of a scene jointly, and the actions go back to the flat agent
axis. Needs equal agents per scene (the `ScenePack` layout), so the regroup
is a reshape.
"""

from __future__ import annotations

import torch

from cld_tpu_torch.data.scene_batch import SceneBatch
from cld_tpu_torch.policies.common import Action


def scene_batch_from_obs(obs, num_scenes: int, agents_per_scene: int,
                         horizon: int = 52) -> SceneBatch:
    """Flat TrafficBatch (Na agents) -> SceneBatch [Ns, A, ...]. The
    histories are already in each agent's frame (the renderer's); the scene
    poses come from the renderer's world transforms; the futures are zeros
    of the model's plan horizon."""
    Ns, A = num_scenes, agents_per_scene
    group = lambda x: x.reshape(Ns, A, *x.shape[1:])
    hp = obs.history_positions
    step = hp - torch.cat([hp[..., :1, :], hp[..., :-1, :]], dim=-2)
    # the norm's value only (its gradient at the first, zero step is not used)
    hist_speed = torch.sqrt(torch.sum(step * step, dim=-1)) / 0.1
    hist_speed = torch.cat([hist_speed[..., :-1], obs.curr_speed[:, None]], dim=-1)
    w = obs.world_from_agent
    dev = hp.device
    return SceneBatch(
        hist_positions=group(hp),
        hist_yaws=group(obs.history_yaws),
        hist_speeds=group(hist_speed),
        hist_avail=group(obs.history_availabilities),
        fut_positions=torch.zeros((Ns, A, horizon, 2), device=dev),
        fut_yaws=torch.zeros((Ns, A, horizon, 1), device=dev),
        fut_avail=torch.ones((Ns, A, horizon), device=dev),
        curr_speed=group(obs.curr_speed),
        extent=group(obs.extent),
        agent_pos_scene=group(w[:, :2, 2]),
        agent_yaw_scene=group(torch.atan2(w[:, 1, 0], w[:, 0, 0])),
        agent_mask=torch.ones((Ns, A), dtype=torch.bool, device=dev),
    )


def scene_dm_policy(trainer, state, num_scenes: int, agents_per_scene: int, horizon: int = 52):
    """(obs, rng) -> Action by joint scene sampling (`SceneDMTrainer.sample`
    with `state`). `rng` is a `torch.Generator` (or None) to draw the
    sampler's noise from, or the noise itself: (x_init [Ns, A, T, 6],
    step_noises [n, Ns, A, T, 6])."""

    def policy(obs, rng):
        sb = scene_batch_from_obs(obs, num_scenes, agents_per_scene, horizon)
        if rng is None or isinstance(rng, torch.Generator):
            traj = trainer.sample(state, sb, generator=rng)
        else:
            traj = trainer.sample(state, sb, noise=rng)
        flat = traj.reshape(num_scenes * agents_per_scene, *traj.shape[2:])
        return Action(positions=flat[..., :2], yaws=flat[..., 3:4], controls=flat[..., 4:6])

    return policy
