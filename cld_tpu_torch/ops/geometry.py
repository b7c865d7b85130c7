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


def agent_from_world_matrix(pos: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] transform taking world points into the frame of an agent
    at (pos, yaw). Inverse of `world_from_agent_matrix`."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    tx = -(c * pos[..., 0] + s * pos[..., 1])
    ty = -(-s * pos[..., 0] + c * pos[..., 1])
    zeros = torch.zeros_like(c)
    ones = torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, s, tx], dim=-1),
            torch.stack([-s, c, ty], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1),
        ],
        dim=-2,
    )


def rotation_matrix_2d(yaw: torch.Tensor) -> torch.Tensor:
    """[..., 2, 2] rotation matrices from yaw angles [...]."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)


def obb_collision_matrix(
    pos: torch.Tensor, yaw: torch.Tensor, extent_lw: torch.Tensor, extent_scale: float = 1.0
) -> torch.Tensor:
    """Exact oriented-bounding-box overlap for every agent pair, by the
    separating-axis theorem over the 4 face normals of two rectangles.

    pos [..., Na, 2], yaw [..., Na], extent_lw [..., Na, 2] (length, width).
    Returns [..., Na, Na] bool; the diagonal is True (a box overlaps
    itself), so callers mask with a pair-validity matrix."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    hl = extent_lw[..., 0] * (0.5 * extent_scale)
    hw = extent_lw[..., 1] * (0.5 * extent_scale)
    rel = pos[..., None, :, :] - pos[..., :, None, :]  # [..., i, j, 2] p_j - p_i
    rx, ry = rel[..., 0], rel[..., 1]
    ci, si = c[..., :, None], s[..., :, None]
    cj, sj = c[..., None, :], s[..., None, :]
    cosd = torch.abs(ci * cj + si * sj)
    sind = torch.abs(si * cj - ci * sj)
    hli, hwi = hl[..., :, None], hw[..., :, None]
    hlj, hwj = hl[..., None, :], hw[..., None, :]
    sep = (
        (torch.abs(rx * ci + ry * si) > hli + hlj * cosd + hwj * sind)
        | (torch.abs(-rx * si + ry * ci) > hwi + hlj * sind + hwj * cosd)
        | (torch.abs(rx * cj + ry * sj) > hlj + hli * cosd + hwi * sind)
        | (torch.abs(-rx * sj + ry * cj) > hwj + hli * sind + hwi * cosd)
    )
    return ~sep
