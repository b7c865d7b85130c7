"""Trajectory normalization with the nuScenes coefficients of record
(port of `cld_tpu/ops/normalization.py`)."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

# (x, y, vel, yaw, acc, yawvel) — mean ("add") and std ("div") coefficients.
NUSC_NORM_ADD = np.array(
    [13.162, -0.13891, 5.0223, -0.0046415, -0.0080072, -0.0013546], dtype=np.float32
)
NUSC_NORM_DIV = np.array(
    [13.0717, 2.2462, 3.6187, 0.2210, 2.5770, 0.0840], dtype=np.float32
)


class TrajNormalizer:
    """Scale/descale trajectories channel-wise: scaled = (x - add) / div."""

    def __init__(self, add_coeffs=NUSC_NORM_ADD, div_coeffs=NUSC_NORM_DIV):
        self.add_coeffs = np.asarray(add_coeffs, dtype=np.float32)
        self.div_coeffs = np.asarray(div_coeffs, dtype=np.float32)

    def _coeffs(self, traj: torch.Tensor, chosen_inds: Sequence[int]):
        inds = list(chosen_inds) if len(chosen_inds) else list(range(len(self.add_coeffs)))
        add = torch.as_tensor(self.add_coeffs[inds], device=traj.device)
        div = torch.as_tensor(self.div_coeffs[inds], device=traj.device)
        return add, div

    def scale(self, traj: torch.Tensor, chosen_inds: Sequence[int] = ()) -> torch.Tensor:
        add, div = self._coeffs(traj, chosen_inds)
        return (traj - add) / div

    def descale(self, traj: torch.Tensor, chosen_inds: Sequence[int] = ()) -> torch.Tensor:
        add, div = self._coeffs(traj, chosen_inds)
        return traj * div + add
