"""TrafficBatch — the fields of the scene batch the guided pipeline reads.

Port of `cld_tpu/data/batch.py:26-88`. Conventions are unchanged: the
predicted agent sits at the origin with yaw 0 at the current step, the
raster stack is channels-last [B, H, W, C], drivable_map [B, H, W] is the
first semantic layer, raster_from_agent [B, 3, 3] maps agent-frame meters to
pixels.
"""

from __future__ import annotations

from typing import NamedTuple

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
