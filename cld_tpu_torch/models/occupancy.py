"""Occupancy prediction network: per-future-frame spatial likelihood maps
(the `occupancy` algo; port of `cld_tpu/models/occupancy.py`). A
`RasterizedMapUNet` with one output channel per subsampled future frame,
supervised by the agent's rasterized future positions (masked pixel BCE +
pixel CE per frame), scoring trajectories by joint (softmax) and independent
(sigmoid) pixel likelihoods.

Not `sim/occupancy.py`: that module splats a rollout's log into grids for
the closed-loop occupancy metrics; this one is a learned network.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from cld_tpu_torch.data.batch import TrafficBatch
from cld_tpu_torch.models.map_unet import RasterizedMapUNet
from cld_tpu_torch.models.spatial_planner import clip_to_raster, pixel_bce
from cld_tpu_torch.ops.geometry import transform_points


def _pixel_index(pos: torch.Tensor, raster_from_agent: torch.Tensor, H: int, W: int):
    pix = torch.floor(clip_to_raster(transform_points(pos, raster_from_agent), H, W))
    return (pix[..., 1] * W + pix[..., 0]).to(torch.int64)


def get_spatial_trajectory_supervision(batch: TrafficBatch, every_n_frame: int = 1
                                       ) -> Dict[str, torch.Tensor]:
    """Per-frame goal-pixel supervision of the ego future, every
    `every_n_frame`-th frame: the one-hot maps [B, Tf, H, W], their flat
    indices and the availability mask."""
    B, H, W = batch.image.shape[:3]
    flat = _pixel_index(batch.target_positions[:, ::every_n_frame], batch.raster_from_agent, H, W)
    mask = batch.target_availabilities[:, ::every_n_frame]
    Tf = flat.shape[1]
    spatial = torch.zeros(B, Tf, H * W, device=flat.device).scatter_(
        2, flat[..., None], 1.0).reshape(B, Tf, H, W)
    return {"traj_spatial_map": spatial, "traj_position_pixel_flat": flat,
            "mask": (mask > 0).to(torch.float32)}


def occupancy_losses(pred_map: torch.Tensor, sup: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Masked pixel BCE + CE; pred_map [B, Tf, H, W] logits."""
    B, Tf, H, W = pred_map.shape
    flat = pred_map.reshape(B, Tf, H * W)
    mask = sup["mask"]
    bce = torch.mean(torch.mean(pixel_bce(flat, sup["traj_spatial_map"].reshape(B, Tf, H * W)),
                                dim=-1) * mask)
    picked = torch.gather(torch.log_softmax(flat, dim=-1), -1,
                          sup["traj_position_pixel_flat"][..., None])[..., 0]
    return {"pixel_bce_loss": bce, "pixel_ce_loss": torch.mean(-picked * mask)}


def occupancy_likelihood(pred_map: torch.Tensor, traj_pos: torch.Tensor,
                         raster_from_agent: torch.Tensor, every_n_frame: int = 1
                         ) -> Dict[str, torch.Tensor]:
    """Joint (softmax) and independent (sigmoid) likelihood of a trajectory
    [B, T, 2] under the predicted maps, per frame."""
    B, Tf, H, W = pred_map.shape
    idx = _pixel_index(traj_pos[:, ::every_n_frame][:, :Tf], raster_from_agent, H, W)[..., None]
    flat = pred_map.reshape(B, Tf, H * W)
    return {"joint_likelihood": torch.gather(torch.softmax(flat, dim=-1), -1, idx)[..., 0],
            "indep_likelihood": torch.gather(torch.sigmoid(flat), -1, idx)[..., 0]}


class OccupancyPredictor(nn.Module):
    """UNet over the raster -> [B, Tf, H, W] occupancy logits + losses, Tf =
    ceil(future_num_frames / every_n_frame). The UNet computes at its
    `compute_dtype` (`ops.precision`); its logits, and so the losses, are
    float32 under bf16 too."""

    def __init__(self, raster_channels: int = 34, arch: str = "resnet18",
                 future_num_frames: int = 52, every_n_frame: int = 4):
        super().__init__()
        self.every_n_frame = every_n_frame
        self.num_out_frames = -(-future_num_frames // every_n_frame)
        self.unet = RasterizedMapUNet(arch, raster_channels, self.num_out_frames)

    def forward(self, batch: TrafficBatch, train: bool = False) -> Dict[str, torch.Tensor]:
        pred_map = self.unet(batch.image, train).permute(0, 3, 1, 2)  # [B, Tf, H, W]
        sup = get_spatial_trajectory_supervision(batch, self.every_n_frame)
        losses = occupancy_losses(pred_map, sup)
        lik = occupancy_likelihood(pred_map, batch.target_positions, batch.raster_from_agent,
                                   self.every_n_frame)
        return {"loss": losses["pixel_bce_loss"] + losses["pixel_ce_loss"], **losses,
                "joint_likelihood": torch.mean(lik["joint_likelihood"]),
                "indep_likelihood": torch.mean(lik["indep_likelihood"]),
                "occupancy_map": pred_map}
