"""Map feature grids: per-agent rotated-ROI features and per-point bilinear
queries (port of `cld_tpu/models/roi_encoder.py`).

A light conv pyramid encodes the raster once into a feature grid; a rotated
ROI crop is an affine bilinear sampling of that grid, and a trajectory
point's feature a bilinear lookup. Both are direct gathers by index, as the
JAX package's are (torchvision's `roi_align` averages over bins, another
function, and is not on every host). The grid is channels-last [B, H, W, C]
at the boundary, as in the JAX module.

At `compute_dtype` bf16 (`ops.precision`) the conv pyramid and the ROI head
run under bf16 autocast over float32 parameters. The sampling positions are
float32 whatever the grid's dtype, and a bf16 grid's bilinear mix comes out
float32, as in the JAX module.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from cld_tpu_torch.models.nets import mish
from cld_tpu_torch.ops.precision import autocast


def query_feature_grid(points: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear feature lookup: points [B, N, 2] (x, y) in grid pixels, grid
    [B, H, W, C] -> [B, N, C]. Points outside clamp to [0, W - 1.001] x
    [0, H - 1.001] with `torch.maximum` / `torch.minimum`, whose gradient at
    an exact tie is split as `jnp.clip`'s."""
    H, W = grid.shape[1:3]
    zero = points.new_tensor(0.0)
    x = torch.minimum(torch.maximum(points[..., 0], zero), points.new_tensor(W - 1.001))
    y = torch.minimum(torch.maximum(points[..., 1], zero), points.new_tensor(H - 1.001))
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1, y1 = x0 + 1, y0 + 1
    wx = (x - x0.to(x.dtype))[..., None]
    wy = (y - y0.to(y.dtype))[..., None]
    b = torch.arange(grid.shape[0], device=grid.device)[:, None]
    return (grid[b, y0, x0] * (1 - wx) * (1 - wy) + grid[b, y0, x1] * wx * (1 - wy)
            + grid[b, y1, x0] * (1 - wx) * wy + grid[b, y1, x1] * wx * wy)


def rotated_roi_crop(grid: torch.Tensor, center: torch.Tensor, yaw: torch.Tensor,
                     roi_size: Tuple[int, int] = (7, 7), roi_extent: float = 14.0) -> torch.Tensor:
    """Rotated ROI crop by affine bilinear sampling: grid [B, H, W, C],
    center [B, A, 2] grid pixels, yaw [B, A] -> [B, A, roi_h, roi_w, C];
    `roi_extent` is the crop's side in grid pixels."""
    B, _, _, C = grid.shape
    A = center.shape[1]
    rh, rw = roi_size
    dt = torch.promote_types(center.dtype, torch.float32)
    ys = torch.linspace(-0.5, 0.5, rh, device=grid.device, dtype=dt) * roi_extent
    xs = torch.linspace(-0.5, 0.5, rw, device=grid.device, dtype=dt) * roi_extent
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    lx, ly = gx.reshape(-1), gy.reshape(-1)  # [rh*rw]
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]  # [B, A, 1]
    rx = lx * c - ly * s
    ry = lx * s + ly * c
    pts = torch.stack([rx, ry], dim=-1) + center[:, :, None, :]  # [B, A, rh*rw, 2]
    return query_feature_grid(pts.reshape(B, -1, 2), grid).reshape(B, A, rh, rw, C)


class MapGridEncoder(nn.Module):
    """Raster [B, H, W, C] -> feature grid [B, H / 2^k, W / 2^k, feature_dim]:
    per width a 3x3 stride-2 conv, GroupNorm(8) (flax's epsilon, 1e-6) and
    Mish, then a 1x1 projection. Names follow flax (`conv0`, `gn0`, ...,
    `proj`)."""

    compute_dtype = torch.float32

    def __init__(self, in_channels: int, feature_dim: int = 32,
                 widths: Sequence[int] = (32, 64)):
        super().__init__()
        self.num_levels = len(widths)
        d = in_channels
        for i, w in enumerate(widths):
            setattr(self, f"conv{i}", nn.Conv2d(d, w, 3, stride=2, padding=1))
            setattr(self, f"gn{i}", nn.GroupNorm(8, w, eps=1e-6))
            d = w
        self.proj = nn.Conv2d(d, feature_dim, 1)

    @property
    def down_factor(self) -> int:
        return 2 ** self.num_levels

    def forward(self, image: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = image.permute(0, 3, 1, 2)
        with autocast(self.compute_dtype, x.device.type):
            for i in range(self.num_levels):
                x = mish(getattr(self, f"gn{i}")(getattr(self, f"conv{i}")(x)))
            return self.proj(x).permute(0, 2, 3, 1)


class ROIMapEncoder(nn.Module):
    """Per-agent ROI feature vectors from a shared scene feature grid:
    image [B, H, W, C], centers_px [B, A, 2] raster pixels, yaws [B, A] ->
    [B, A, agent_feature_dim] (the crop's mean through a dense `head`)."""

    compute_dtype = torch.float32

    def __init__(self, in_channels: int, feature_dim: int = 32, agent_feature_dim: int = 64,
                 roi_size: Tuple[int, int] = (7, 7), roi_extent_m: float = 20.0,
                 pixel_size: float = 0.5):
        super().__init__()
        self.roi_size, self.roi_extent_m, self.pixel_size = roi_size, roi_extent_m, pixel_size
        self.grid = MapGridEncoder(in_channels, feature_dim)
        self.head = nn.Linear(feature_dim, agent_feature_dim)

    def forward(self, image, centers_px, yaws, train: bool = False):
        grid = self.grid(image, train)
        down = self.grid.down_factor
        roi = rotated_roi_crop(grid, centers_px / down, yaws, self.roi_size,
                               roi_extent=self.roi_extent_m / self.pixel_size / down)
        with autocast(self.compute_dtype, image.device.type):
            return self.head(torch.mean(roi, dim=(2, 3)))
