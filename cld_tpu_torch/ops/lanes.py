"""Lane-point machinery: closest-lane queries with static shapes (port of
`cld_tpu/ops/lanes.py`).

Lane centerlines live as one dense [L, 3] (x, y, yaw) array per scene with
a boolean avail mask; the closest-K query is a masked `torch.topk`. The
score is dist_weight * ||xy - p|| + heading_weight * |dh| with the ahead
filter (agent-frame x > ahead_threshold).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from cld_tpu_torch.ops.dynamics import angle_diff
from cld_tpu_torch.ops.geometry import transform_points


def transform_lanes_to_agent(
    lanes_world: torch.Tensor, agent_from_world: torch.Tensor
) -> torch.Tensor:
    """World-frame lane points [B, L, 3] -> agent frame (positions rotated
    and translated, yaws offset by the frame rotation)."""
    pos = transform_points(lanes_world[..., :2], agent_from_world)
    dyaw = torch.atan2(agent_from_world[..., 1, 0], agent_from_world[..., 0, 0])
    yaw = lanes_world[..., 2] + dyaw[..., None]
    return torch.cat([pos, yaw[..., None]], dim=-1)


def closest_lane_points(
    lanes_world: torch.Tensor,  # [B, L, 3] world (x, y, yaw) per agent's scene
    lanes_avail: torch.Tensor,  # [B, L] bool
    pos_world: torch.Tensor,  # [B, 2]
    yaw_world: torch.Tensor,  # [B]
    agent_from_world: torch.Tensor,  # [B, 3, 3]
    k: int = 32,
    dist_weight: float = 1.0,
    heading_weight: float = 0.1,
    max_dist: float = 80.0,
    ahead_threshold: float = -40.0,
    max_heading_error: float = 0.25 * math.pi,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closest-K lane points for each agent, in the agent's frame: (points
    [B, K, 3], avail [B, K] bool). Unavailable, too-far, behind-threshold
    and heading-mismatched (wrapped |dh| > max_heading_error) points get
    avail False and are zero-filled. The ranking score uses the raw,
    unwrapped |h_lane - h_agent|, as the JAX package's does. Equal scores
    keep the lower index first, as `jax.lax.top_k` does (a stable sort;
    `torch.topk` leaves their order to the device): lane points spaced
    evenly about an agent tie, and the MPC's lane reference starts from the
    first of them."""
    d = torch.linalg.norm(lanes_world[..., :2] - pos_world[:, None], dim=-1)  # [B, L]
    dh_wrapped = torch.abs(angle_diff(lanes_world[..., 2], yaw_world[:, None]))
    dh_raw = torch.abs(lanes_world[..., 2] - yaw_world[:, None])
    score = dist_weight * d + heading_weight * dh_raw

    lanes_agent = transform_lanes_to_agent(lanes_world, agent_from_world)
    ok = (
        lanes_avail
        & (d <= max_dist)
        & (dh_wrapped <= max_heading_error)
        & (lanes_agent[..., 0] > ahead_threshold)
    )
    score = torch.where(ok, score, torch.full_like(score, float("inf")))

    best, idx = torch.sort(score, dim=-1, stable=True)  # smallest score first
    best, idx = best[:, :k], idx[:, :k]
    pts = torch.gather(lanes_agent, 1, idx[..., None].expand(-1, -1, 3))  # [B, K, 3]
    avail = torch.isfinite(best)
    pts = torch.where(avail[..., None], pts, torch.zeros_like(pts))
    return pts, avail


def merge_scene_lanes(
    lane_points_world: np.ndarray,  # [B, L0, 3] world frame per sample
    lane_avail: np.ndarray,  # [B, L0] bool
    scene_index: np.ndarray,  # [B] int, dense 0..Ns-1
    num_scenes: int,
    max_points: int = 256,
    dedupe_resolution: float = 1.0,
):
    """Union each scene's per-sample lane observations into one dense
    per-scene point set (numpy, once per scene pack): points snapped to a
    `dedupe_resolution` grid drop the duplicates where several agents saw
    the same lane (the first occurrence stays), then at most `max_points`
    per scene, subsampled at an even stride (a prefix would keep only the
    earliest agents' lanes). Returns (points [Ns, max_points, 3], avail
    [Ns, max_points] bool)."""
    out = np.zeros((num_scenes, max_points, 3), np.float32)
    out_avail = np.zeros((num_scenes, max_points), bool)
    for s in range(num_scenes):
        members = np.nonzero(scene_index == s)[0]
        if len(members) == 0:
            continue
        pts = lane_points_world[members].reshape(-1, 3)
        av = lane_avail[members].reshape(-1)
        pts = pts[av & np.isfinite(pts).all(-1)]
        if len(pts) == 0:
            continue
        keys = np.round(pts[:, :2] / dedupe_resolution).astype(np.int64)
        _, first = np.unique(keys, axis=0, return_index=True)
        pts = pts[np.sort(first)]
        if len(pts) > max_points:
            sel = np.unique(np.linspace(0, len(pts) - 1, max_points).round().astype(int))
            print(f"[lanes] scene {s}: {len(pts)} deduped lane points subsampled to {len(sel)} "
                  f"(max_points={max_points}; raise it or coarsen dedupe_resolution for denser "
                  "coverage)")
            pts = pts[sel]
        out[s, : len(pts)] = pts
        out_avail[s, : len(pts)] = True
    return out, out_avail


def straight_lane_polylines(
    lane_ys, x_min: float, x_max: float, spacing: float = 2.0, max_points: int = 256
):
    """Dense centerline points for straight +x lanes (numpy): the synthetic
    world's lane geometry. Returns (points [max_points, 3], avail
    [max_points] bool)."""
    xs = np.arange(x_min, x_max, spacing, dtype=np.float32)
    pts = []
    for y in lane_ys:
        p = np.zeros((len(xs), 3), np.float32)
        p[:, 0] = xs
        p[:, 1] = y
        pts.append(p)
    pts = np.concatenate(pts, axis=0)
    avail = np.ones(len(pts), bool)
    if len(pts) > max_points:
        sel = np.linspace(0, len(pts) - 1, max_points).astype(np.int64)
        pts, avail = pts[sel], avail[sel]
    elif len(pts) < max_points:
        pad = max_points - len(pts)
        pts = np.concatenate([pts, np.zeros((pad, 3), np.float32)], axis=0)
        avail = np.concatenate([avail, np.zeros(pad, bool)])
    return pts, avail
