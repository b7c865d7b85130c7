"""Batched 2-D geometry (port of `cld_tpu/ops/geometry.py`)."""

from __future__ import annotations

import numpy as np
import torch


def transform_points(points: torch.Tensor, tf: torch.Tensor) -> torch.Tensor:
    """Apply batched 3x3 homogeneous transforms to 2-D points.

    points [B, ..., 2], tf [B, 3, 3] broadcast over the middle dims
    (points @ linear^T + translation)."""
    batch = points.shape[0]
    flat = points.reshape(batch, -1, 2)
    linear = tf[:, :2, :2]
    translation = tf[:, :2, 2]
    out = torch.einsum("bnd,bed->bne", flat, linear) + translation[:, None, :]
    return out.reshape(points.shape)


def raster_from_agent_matrix(
    raster_size: int = 224, pixel_size: float = 0.5, ego_center=(-0.5, 0.0)
) -> np.ndarray:
    """Agent frame -> raster pixel frame: scale by 1/pixel_size and place the
    agent at pixel ((1 + ego_center) / 2) * raster_size."""
    scale = 1.0 / pixel_size
    cx = (1.0 + ego_center[0]) / 2.0 * raster_size
    cy = (1.0 + ego_center[1]) / 2.0 * raster_size
    return np.array(
        [[scale, 0.0, cx], [0.0, scale, cy], [0.0, 0.0, 1.0]], dtype=np.float32
    )


def world_from_agent_matrix(pos: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] transform taking agent-frame points into the world frame."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    zeros = torch.zeros_like(c)
    ones = torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, -s, pos[..., 0]], dim=-1),
            torch.stack([s, c, pos[..., 1]], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1),
        ],
        dim=-2,
    )
