"""Batched open-loop metrics (port of `cld_tpu/ops/metrics.py`, after
`tbsim/utils/metrics.py:24-650`): oracle / mean ADE and FDE over sample
sets, the pairwise collision rate, off-road detection (points and disks),
the multi-modal NLL, Gaussian and mixture log-likelihoods, and trajectory
diversity. Plain tensor code on any device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from cld_tpu_torch.ops.geometry import transform_points


def batch_average_displacement_error(gt: torch.Tensor, pred: torch.Tensor,
                                     avail: Optional[torch.Tensor] = None,
                                     mode: str = "mean") -> torch.Tensor:
    """ADE over N samples (`metrics.py:201-240`): pred [B, N, T, 2], gt
    [B, T, 2] -> [B]. `mode` "mean" averages over the samples, "oracle"
    takes the best one."""
    err = torch.linalg.vector_norm(pred - gt[:, None], dim=-1)  # [B, N, T]
    if avail is not None:
        denom = torch.clamp(avail.sum(-1), min=1)[:, None]
        per_sample = (err * avail[:, None]).sum(-1) / denom
    else:
        per_sample = err.mean(-1)
    if mode == "oracle":
        return per_sample.amin(-1)
    return per_sample.mean(-1)


def batch_final_displacement_error(gt: torch.Tensor, pred: torch.Tensor,
                                   mode: str = "mean") -> torch.Tensor:
    """FDE over N samples (`metrics.py:242-287`): [B, N, T, 2] -> [B]."""
    err = torch.linalg.vector_norm(pred[..., -1, :] - gt[:, None, -1, :], dim=-1)  # [B, N]
    return err.amin(-1) if mode == "oracle" else err.mean(-1)


def batch_pairwise_collision_rate(pos: torch.Tensor, extent: torch.Tensor,
                                  scene_index: torch.Tensor,
                                  thresh_scale: float = 1.0) -> torch.Tensor:
    """Share of agents whose trajectory comes within the sum of half-lengths
    of another agent of its scene (`metrics.py:382-449`, disks). pos
    [B, T, 2], extent [B, 3], scene_index [B] -> a scalar."""
    B = pos.shape[0]
    dist = torch.linalg.vector_norm(pos[:, None] - pos[None], dim=-1)  # [B, B, T]
    rad = (extent[:, None, 0] + extent[None, :, 0]) / 2.0 * thresh_scale
    eye = torch.eye(B, dtype=torch.bool, device=pos.device)
    valid = (scene_index[:, None] == scene_index[None]) & ~eye
    hit = torch.any(((dist < rad[..., None]) & valid[..., None]).flatten(1), dim=1)
    return hit.to(torch.float32).mean()


def batch_detect_off_road(pos: torch.Tensor, drivable_map: torch.Tensor,
                          raster_from_agent: torch.Tensor) -> torch.Tensor:
    """Per-point off-road flags (`metrics.py:451-478`): pos [B, ..., 2] ->
    {0., 1.} of the same leading shape."""
    pix = transform_points(pos, raster_from_agent)
    H, W = drivable_map.shape[-2:]
    col = torch.clamp(torch.round(pix[..., 0]).to(torch.int32), 0, W - 1).long()
    row = torch.clamp(torch.round(pix[..., 1]).to(torch.int32), 0, H - 1).long()
    b = torch.arange(pos.shape[0], device=pos.device).reshape((-1,) + (1,) * (pos.ndim - 2))
    return (drivable_map[b, row, col] <= 0).to(torch.float32)


def batch_detect_off_road_disk(pos: torch.Tensor, yaw: torch.Tensor, extent: torch.Tensor,
                               drivable_map: torch.Tensor, raster_from_agent: torch.Tensor,
                               num_disks: int = 3) -> torch.Tensor:
    """Disk-sampled off-road detection (`metrics.py:521-548`): off-road when
    any of `num_disks` points along the vehicle's length is. pos [B, T, 2],
    yaw [B, T] -> [B, T] flags."""
    agt_rad = extent[:, 1] / 2.0
    lo = -(extent[:, 0] / 2.0) + agt_rad
    hi = (extent[:, 0] / 2.0) - agt_rad
    lin = torch.linspace(0.0, 1.0, num_disks, device=pos.device)
    cx = lo[:, None] + (hi - lo)[:, None] * lin[None]  # [B, D]
    c, s = torch.cos(yaw), torch.sin(yaw)
    px = pos[..., 0][..., None] + cx[:, None, :] * c[..., None]
    py = pos[..., 1][..., None] + cx[:, None, :] * s[..., None]
    off = batch_detect_off_road(torch.stack([px, py], dim=-1), drivable_map, raster_from_agent)
    return torch.any(off > 0, dim=-1).to(torch.float32)


def batch_neg_multi_log_likelihood(gt: torch.Tensor, pred: torch.Tensor,
                                   confidences: torch.Tensor,
                                   avails: torch.Tensor) -> torch.Tensor:
    """Multi-modal NLL with the log-sum-exp trick (`metrics.py:66-110`, the
    l5kit competition loss): gt [B, T, 2], pred [B, M, T, 2], confidences
    [B, M], avails [B, T] -> [B]."""
    err = torch.sum(((gt[:, None] - pred) * avails[:, None, :, None]) ** 2, dim=-1)
    log_conf = torch.log(torch.clamp(confidences, min=1e-12))
    e = log_conf - 0.5 * torch.sum(err, dim=-1)  # [B, M]
    return -torch.logsumexp(e, dim=-1)


def log_normal(x: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
               avails: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Diagonal-Gaussian log density summed over D (`metrics.py:505-525`):
    x [B, M, D], m / v [B|1, M, D] -> [B, M]."""
    lp = -0.5 * (torch.log(2 * math.pi * v) + (x - m) ** 2 / v)
    if avails is not None:
        lp = lp * avails
    return torch.sum(lp, dim=-1)


def gmm_loglikelihood(x: torch.Tensor, m: torch.Tensor, v: Optional[torch.Tensor],
                      pi: torch.Tensor, avails: Optional[torch.Tensor] = None,
                      mode: str = "mean") -> torch.Tensor:
    """Log probability of x under a mixture of diagonal Gaussians
    (`metrics.py:549-582`): x [B, D], m / v [B|1, M, D], pi [B, M] -> [B];
    the pi-weighted per-mode log probabilities summed, averaged or maxed
    over the modes (`mode`), as the reference does."""
    if v is None:
        v = torch.ones_like(m)
    av = avails[:, None] if avails is not None else None
    weighted = pi * log_normal(x[:, None], m, v, avails=av)  # [B, M]
    if mode == "sum":
        return weighted.sum(1)
    if mode == "mean":
        return weighted.mean(1)
    if mode == "max":
        return weighted.amax(1)
    raise ValueError(f"unknown mode {mode!r}")


def trajectory_diversity(pred: torch.Tensor) -> torch.Tensor:
    """Mean pairwise spread of the samples' final positions: pred
    [B, N, T, 2] -> [B]."""
    fin = pred[..., -1, :]  # [B, N, 2]
    d = torch.sqrt(torch.sum((fin[:, :, None] - fin[:, None]) ** 2, dim=-1))
    N = pred.shape[1]
    return d.sum((-1, -2)) / max(N * (N - 1), 1)
