"""TrafficBatch — the scene batch read by the guided pipeline and filled by
the closed-loop simulator's renderer.

Port of `cld_tpu/data/batch.py:26-88`. Conventions are unchanged: the
predicted agent sits at the origin with yaw 0 at the current step, the
raster stack is channels-last [B, H, W, C], drivable_map [B, H, W] is the
first semantic layer, raster_from_agent [B, 3, 3] maps agent-frame meters to
pixels. The first nine fields are what the open-loop pipeline reads and are
required; the rest are filled by `sim.env.render_observation` and default to
None, in the order of the JAX package's batch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class TrafficBatch(NamedTuple):
    # map raster: [B, H, W, C_hist + C_sem]
    image: torch.Tensor
    # drivable region: [B, H, W] float {0, 1}
    drivable_map: torch.Tensor
    # agent-frame -> raster-pixel transform: [B, 3, 3]
    raster_from_agent: torch.Tensor
    # ego history (agent frame): [B, Th, 2], [B, Th, 1]
    history_positions: torch.Tensor
    history_yaws: torch.Tensor
    # current speed: [B]
    curr_speed: torch.Tensor
    # vehicle extent (length, width, height): [B, 3]
    extent: torch.Tensor
    # neighbors' future (agent frame): [B, S, T, 2], [B, S, T]
    all_other_agents_future_positions: torch.Tensor
    all_other_agents_future_availability: torch.Tensor
    # ego history validity: [B, Th]
    history_availabilities: Optional[torch.Tensor] = None
    # dataset future (agent frame): [B, T, 2], [B, T, 1], [B, T]
    target_positions: Optional[torch.Tensor] = None
    target_yaws: Optional[torch.Tensor] = None
    target_availabilities: Optional[torch.Tensor] = None
    # neighbors' history: [B, S, Th, 2], [B, S, Th, 1], [B, S, Th]
    all_other_agents_history_positions: Optional[torch.Tensor] = None
    all_other_agents_history_yaws: Optional[torch.Tensor] = None
    all_other_agents_history_availability: Optional[torch.Tensor] = None
    # world pose, filled by the simulator's renderer: [B, 3, 3], [B, 3, 3], [B]
    world_from_agent: Optional[torch.Tensor] = None
    agent_from_world: Optional[torch.Tensor] = None
    scene_index: Optional[torch.Tensor] = None
    # ego speed history [B, Th] and the global sim frame index (python int)
    history_speeds: Optional[torch.Tensor] = None
    sim_step: Optional[int] = None
    # closest lane-center points in the agent frame, masked: [B, L, 3], [B, L]
    lane_points: Optional[torch.Tensor] = None
    lane_avail: Optional[torch.Tensor] = None

    @property
    def batch_size(self) -> int:
        return self.image.shape[0]


def get_current_states(batch: TrafficBatch) -> torch.Tensor:
    """Current unicycle state [B, 4] = (x, y, v, yaw): last history pose +
    curr_speed."""
    return torch.cat(
        [
            batch.history_positions[:, -1, :],
            batch.curr_speed[:, None],
            batch.history_yaws[:, -1, :],
        ],
        dim=-1,
    )
