"""Spatial goal planner (the `spatial_planner` algo; port of
`cld_tpu/models/spatial_planner.py`): a `RasterizedMapUNet` predicts a
4-channel map, [goal-pixel logit, x residual, y residual, yaw], supervised
by the last available future frame. Losses: pixel CE over the flattened
logit map, pixel BCE against the one-hot goal map (weight 0 by default) and
residual / yaw MSE at the ground-truth pixel. Decoding takes the argmax
pixel of the (optionally drivable-masked) softmax and its sigmoid residual.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from cld_tpu_torch.data.batch import TrafficBatch
from cld_tpu_torch.models.map_unet import RasterizedMapUNet
from cld_tpu_torch.ops.geometry import transform_points

# the reference's algo_config.loss_weights defaults
DEFAULT_LOSS_WEIGHTS = {"pixel_bce_loss": 0.0, "pixel_ce_loss": 1.0, "pixel_res_loss": 1.0,
                        "pixel_yaw_loss": 1.0}


def last_available_index(avail: torch.Tensor) -> torch.Tensor:
    """[B, T] availability -> [B] index of the last valid frame (0 if none),
    an argmax over the reversed mask as in the JAX package."""
    T = avail.shape[1]
    rev = torch.flip(avail > 0, dims=(1,))
    idx = T - 1 - torch.argmax(rev.to(torch.int32), dim=1)
    return torch.where(torch.any(rev, dim=1), idx, torch.zeros_like(idx))


def clip_to_raster(raster_xy: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Raster coordinates [..., 2] clamped into [0, W - 1e-5] x [0, H - 1e-5]."""
    zero = raster_xy.new_tensor(0.0)
    x = torch.minimum(torch.maximum(raster_xy[..., 0], zero), raster_xy.new_tensor(W - 1e-5))
    y = torch.minimum(torch.maximum(raster_xy[..., 1], zero), raster_xy.new_tensor(H - 1e-5))
    return torch.stack([x, y], dim=-1)


def get_spatial_goal_supervision(batch: TrafficBatch) -> Dict[str, torch.Tensor]:
    """Goal pixel, its residual in [0, 1), the one-hot goal map and the goal
    pose from the last available future frame."""
    B, H, W = batch.image.shape[:3]
    g_idx = last_available_index(batch.target_availabilities)
    b = torch.arange(B, device=g_idx.device)
    goal_pos = batch.target_positions[b, g_idx]  # [B, 2]
    goal_yaw = batch.target_yaws[b, g_idx]  # [B, 1]
    goal_raster = clip_to_raster(transform_points(goal_pos[:, None], batch.raster_from_agent)[:, 0],
                                 H, W)
    goal_pixel = torch.floor(goal_raster)
    flat = (goal_pixel[:, 1] * W + goal_pixel[:, 0]).to(torch.int64)
    spatial_map = torch.zeros(B, H * W, device=flat.device).scatter_(
        1, flat[:, None], 1.0).reshape(B, H, W)
    return {
        "goal_position_residual": goal_raster - goal_pixel,
        "goal_spatial_map": spatial_map,
        "goal_position_pixel": goal_pixel,
        "goal_position_pixel_flat": flat,
        "goal_position": goal_pos,
        "goal_yaw": goal_yaw,
    }


def pixel_bce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE with logits: max(l, 0) - l t + log1p(exp(-|l|))."""
    return torch.relu(logits) - logits * target + torch.log1p(torch.exp(-torch.abs(logits)))


def spatial_planner_losses(pred_map: torch.Tensor,
                           goal_sup: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    B, H, W, _ = pred_map.shape
    flat_logits = pred_map[..., 0].reshape(B, H * W)
    tgt = goal_sup["goal_position_pixel_flat"]
    b = torch.arange(B, device=tgt.device)
    bce = torch.mean(pixel_bce(flat_logits, goal_sup["goal_spatial_map"].reshape(B, H * W)))
    ce = -torch.mean(torch.log_softmax(flat_logits, dim=-1)[b, tgt])
    local = pred_map.reshape(B, H * W, -1)[b, tgt]  # [B, 4]
    res_loss = torch.mean((torch.sigmoid(local[:, 1:3]) - goal_sup["goal_position_residual"]) ** 2)
    yaw_loss = torch.mean((local[:, 3:4] - goal_sup["goal_yaw"]) ** 2)
    return {"pixel_bce_loss": bce, "pixel_ce_loss": ce, "pixel_res_loss": res_loss,
            "pixel_yaw_loss": yaw_loss}


def decode_spatial_prediction(pred_map: torch.Tensor, raster_from_agent: torch.Tensor,
                              drivable_map: Optional[torch.Tensor] = None
                              ) -> Dict[str, torch.Tensor]:
    """Argmax decode of the goal map: the most likely pixel (among drivable
    ones when `drivable_map` has any), plus its sigmoid residual, mapped back
    to the agent frame."""
    B, H, W, _ = pred_map.shape
    prob = torch.softmax(pred_map[..., 0].reshape(B, H * W), dim=-1)
    if drivable_map is not None:
        mask = (drivable_map > 0).reshape(B, H * W)
        usable = torch.any(mask, dim=-1, keepdim=True)  # nowhere drivable: unmasked
        prob = torch.where(usable, prob * mask, prob)
    flat_idx = torch.argmax(prob, dim=-1)
    b = torch.arange(B, device=flat_idx.device)
    pix = torch.stack([(flat_idx % W).to(prob.dtype), (flat_idx // W).to(prob.dtype)], dim=-1)
    local = pred_map.reshape(B, H * W, -1)[b, flat_idx]
    pos_raster = pix + torch.sigmoid(local[:, 1:3])
    pos_agent = transform_points(pos_raster[:, None], torch.linalg.inv(raster_from_agent))[:, 0]
    return {"positions": pos_agent, "yaws": local[:, 3:4],
            "log_likelihood": torch.log(prob[b, flat_idx] + 1e-12), "pixel": pix}


class SpatialPlannerNet(nn.Module):
    """The planner's UNet and its loss head. The UNet computes at its
    `compute_dtype` (`ops.precision`); its logits, and so the losses and the
    decoding, are float32 under bf16 too."""

    def __init__(self, raster_channels: int = 34, arch: str = "resnet18",
                 loss_weights: Optional[Dict[str, float]] = None):
        super().__init__()
        self.loss_weights = loss_weights or DEFAULT_LOSS_WEIGHTS
        self.unet = RasterizedMapUNet(arch, raster_channels, output_channels=4)

    def forward(self, batch: TrafficBatch, train: bool = False) -> Dict[str, torch.Tensor]:
        pred_map = self.unet(batch.image, train)
        goal_sup = get_spatial_goal_supervision(batch)
        losses = spatial_planner_losses(pred_map, goal_sup)
        total = sum(losses[k] * self.loss_weights[k] for k in losses)
        dec = decode_spatial_prediction(pred_map, batch.raster_from_agent)
        pos_err = torch.mean(torch.linalg.vector_norm(dec["positions"] - goal_sup["goal_position"],
                                                      dim=-1))
        return {"loss": total, **losses, "goal_pos_err": pos_err, "pred_map": pred_map}
