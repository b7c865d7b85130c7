"""Guidance losses of the flagship scene-editing config (port of the parts of
`cld_tpu/guidance/losses.py` the guided pipeline runs).

Every loss maps (x [B, N, T, 6] descaled (x, y, vel, yaw, acc, yawvel),
ctx, agt_mask [B]) -> [B, N]. Ported here: `AgentCollisionLoss` on the
scene-block "diff" path and `MapCollisionLoss` with the separable
exact-EDT min distance (`min_dist_impl="separable"`), whose custom backward
is the autograd Function `MinDistSeparable`. On a CUDA map the drivable
lookup runs a gather kernel of `ops.gather_kernels`: the bit gather from the
packed map (`gather_impl="bits"`) or the unpacked value gather (`"px"`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from cld_tpu_torch.ops.gather_kernels import (
    drivable_bit_gather,
    drivable_gather,
    pack_drivable_bits,
)
from cld_tpu_torch.ops.geometry import transform_points


class GuidanceContext(NamedTuple):
    """Static-shape scene context read by the guidance losses."""

    drivable_map: torch.Tensor  # [B, H, W]
    raster_from_agent: torch.Tensor  # [B, 3, 3]
    extent: torch.Tensor  # [B, 3]
    curr_speed: torch.Tensor  # [B]
    world_from_agent: torch.Tensor  # [B, 3, 3]
    scene_index: torch.Tensor  # [B] int: which scene each agent belongs to
    # bit-packed drivable map [B, H, ceil(W/8)] int8 (`prepack_drivable`)
    drivable_packed: Optional[torch.Tensor] = None
    # MapCollisionLoss bbox grid points [B, R, C, 2] (`prepack_map_bbox`)
    bbox_pts: Optional[torch.Tensor] = None


def prepack_drivable(ctx: GuidanceContext) -> GuidanceContext:
    """Return ctx with `drivable_packed` filled (done once per context, out
    of the sampling loop)."""
    if ctx.drivable_packed is not None:
        return ctx
    return ctx._replace(drivable_packed=pack_drivable_bits(ctx.drivable_map))


def bbox_local_grid(num_points_lw: Tuple[int, int], device="cuda") -> torch.Tensor:
    """[P, 2] unit bbox sample grid of MapCollisionLoss (row-major r*C+c)."""
    lwise = np.linspace(-0.5, 0.5, num_points_lw[0])
    wwise = np.linspace(-0.5, 0.5, num_points_lw[1])
    grid = np.stack(np.meshgrid(lwise, wwise, indexing="ij"), -1).reshape(-1, 2)
    return torch.as_tensor(grid.astype(np.float32), device=device)


def prepack_map_bbox(
    ctx: GuidanceContext, num_points_lw: Tuple[int, int] = (10, 10)
) -> GuidanceContext:
    """Fill the extent-scaled bbox grid points [B, R, C, 2]."""
    R, C = num_points_lw
    if ctx.bbox_pts is not None and tuple(ctx.bbox_pts.shape[1:3]) == (R, C):
        return ctx
    local = bbox_local_grid(num_points_lw, ctx.extent.device)  # [P, 2]
    pts = local[None] * ctx.extent[:, None, :2]  # [B, P, 2]
    return ctx._replace(bbox_pts=pts.reshape(-1, R, C, 2))


def masked_mean(per_agent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of [B, N] entries over agents where mask[B] is True."""
    m = mask[:, None].to(per_agent.dtype)
    return torch.sum(per_agent * m) / torch.clamp(torch.sum(m) * per_agent.shape[1], min=1e-6)


def _decay_weights(T: int, decay_rate: float, device) -> torch.Tensor:
    w = decay_rate ** np.arange(T)
    return torch.as_tensor((w / w.sum()).astype(np.float32), device=device)


def _mask_gradient(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Detach x for agents where keep[B] is False."""
    keep = keep.reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.where(keep, x, x.detach())


def _to_world(x: torch.Tensor, world_from_agent: torch.Tensor):
    """Agent-frame (pos, yaw) -> world frame. x [B, N, T, 6]."""
    pos = transform_points(x[..., :2], world_from_agent)
    dyaw = torch.atan2(world_from_agent[:, 1, 0], world_from_agent[:, 0, 0])
    yaw = x[..., 3:4] + dyaw[:, None, None, None]
    return pos, yaw


_BIG_D2 = 1e12  # finite "masked" squared distance (inf would NaN the grad)


@dataclasses.dataclass(frozen=True)
class AgentCollisionLoss:
    """Scene-level pairwise disk-collision penalty: each agent is num_disks
    circles along its length; penalty 1 - d/penalty_dist for colliding
    pairs, decayed over time, summed over the other agents of the scene and
    divided by B.

    Only the scene-block path is ported: the batch must be contiguous
    equal-size scenes of `scene_block` agents, and distances are computed
    block-diagonally ([S, A, A]) with the JAX package's "diff" pairwise
    form (the full disk-difference tensor, which its "auto" picks at these
    block sizes)."""

    num_disks: int = 5
    buffer_dist: float = 0.2
    decay_rate: float = 0.9
    guide_moving_speed_th: float = 0.5
    scene_block: Optional[int] = None

    def __call__(self, x, ctx: GuidanceContext, agt_mask=None) -> torch.Tensor:
        B, N, T, _ = x.shape
        A = self.scene_block
        if A is None or not (1 < A <= B and B % A == 0):
            raise NotImplementedError(
                "AgentCollisionLoss: only the scene-block path is ported "
                f"(scene_block={A}, B={B})"
            )
        dev = x.device
        moving = torch.abs(ctx.curr_speed) > self.guide_moving_speed_th
        x = _mask_gradient(x, moving)
        if agt_mask is not None:
            x = _mask_gradient(x, agt_mask)
        pos_w, yaw_w = _to_world(x, ctx.world_from_agent)

        agt_rad = ctx.extent[:, 1] / 2.0  # [B]
        cent_min = -(ctx.extent[:, 0] / 2.0) + agt_rad
        cent_max = (ctx.extent[:, 0] / 2.0) - agt_rad
        lin = torch.linspace(0.0, 1.0, self.num_disks, device=dev)
        cent_x = cent_min[:, None] + (cent_max - cent_min)[:, None] * lin[None]  # [B, D]
        centroids = torch.stack([cent_x, torch.zeros_like(cent_x)], dim=-1)  # [B, D, 2]

        c = torch.cos(yaw_w)  # [B, N, T, 1]
        s = torch.sin(yaw_w)
        cent = centroids[:, None, None]  # [B, 1, 1, D, 2]
        rx = cent[..., 0] * c + cent[..., 1] * (-s)
        ry = cent[..., 0] * s + cent[..., 1] * c
        cent_w = torch.stack([rx, ry], dim=-1) + pos_w[..., None, :]  # [B, N, T, D, 2]

        D = self.num_disks
        w = _decay_weights(T, self.decay_rate, dev)
        S = B // A
        si = ctx.scene_index.reshape(S, A)
        rad = agt_rad.reshape(S, A)
        pen_d = rad[:, :, None] + rad[:, None, :] + self.buffer_dist  # [S, A, A]
        eye = torch.eye(A, dtype=torch.bool, device=dev)
        pair_valid = (si[:, :, None] == si[:, None, :]) & ~eye[None]

        cent_t = cent_w.reshape(S, A, N, T, D, 2).permute(3, 0, 1, 2, 4, 5)  # [T,S,A,N,D,2]
        diff = (
            cent_t[:, :, :, None, :, :, None, :] - cent_t[:, :, None, :, :, None, :, :]
        )  # [T, S, A, A, N, D, D, 2]
        dist = torch.sqrt(torch.sum(diff**2, dim=-1) + 1e-12)
        pair = torch.amin(dist.reshape(T, S, A, A, N, -1), dim=-1)  # [T, S, A, A, N]
        pd = pen_d[None, ..., None]
        colliding = (pair <= pd) & pair_valid[None, ..., None]
        pen = torch.where(colliding, 1.0 - pair / pd, torch.zeros_like(pair))
        acc = torch.einsum("k,ksabn->sabn", w, pen)
        per_agent = (torch.sum(acc, dim=2) / B).reshape(B, N)
        return torch.where(moving[:, None], per_agent, torch.zeros_like(per_agent))


def _sep_stage_minima(onroad, rd2, cd2):
    """Two-stage masked minima of the separable EDT: E [B, Q, R, C] (per
    source row r', nearest on-road column distance to target column c) and
    D [B, Q, R, C] (min squared distance per target (r, c))."""
    B, Q, P = onroad.shape
    R = rd2.shape[-1]
    C = cd2.shape[-1]
    on = onroad.reshape(B, Q, R, C)
    big = torch.full((), _BIG_D2, dtype=rd2.dtype, device=rd2.device)
    E = torch.full((B, Q, R, C), _BIG_D2, dtype=rd2.dtype, device=rd2.device)
    for cp in range(C):  # source column c'
        cand = torch.where(on[..., cp : cp + 1], cd2[:, None, None, cp, :], big)
        E = torch.minimum(E, cand)
    D = torch.full_like(E, _BIG_D2)
    for rp in range(R):  # source row r'
        D = torch.minimum(D, rd2[:, None, rp, :, None] + E[:, :, rp : rp + 1, :])
    return torch.sqrt(D.reshape(B, Q, P) + 1e-12), E, D


class MinDistSeparable(torch.autograd.Function):
    """Distance from every bbox point to the nearest on-road bbox point of
    the same (agent, step), by the exact two-pass separable EDT over the
    regular R x C grid.

    pts [B, Q, P, 2] current pose points (backward only), onroad [B, Q, P]
    bool (P row-major r * C + c), rd2 [B, R, R] / cd2 [B, C, C] squared
    row / column offset distances -> [B, Q, P].

    Backward (`cld_tpu/guidance/losses.py:416-482`): column j's cotangent
    flows to its nearest on-road point i* as g_j (p_i* - p_j) / d_j, the
    argmin recovered by exact float equality against the staged minima and
    split evenly among ties per stage. Only pts gets a gradient."""

    @staticmethod
    def forward(ctx, pts, onroad, rd2, cd2):
        d, E, D = _sep_stage_minima(onroad, rd2, cd2)
        ctx.save_for_backward(pts, onroad, rd2, cd2, E, D)
        return d

    @staticmethod
    def backward(ctx, g):
        pts, onroad, rd2, cd2, E, D = ctx.saved_tensors
        B, Q, P = onroad.shape
        R = rd2.shape[-1]
        C = cd2.shape[-1]
        on = onroad.reshape(B, Q, R, C)
        Df = D.reshape(B, Q, P)
        a = g / torch.sqrt(Df + 1e-12)  # [B, Q, P]
        px = pts[..., 0]
        py = pts[..., 1]
        zero = torch.zeros((), dtype=a.dtype, device=a.device)

        # stage-2 routing: target j = (r, c) -> source row rp; the candidate
        # sums repeat the forward's adds bitwise
        rd2_t = rd2[:, :, :, None].expand(B, R, R, C).reshape(B, R, P)
        E_t = E[:, :, :, None, :].expand(B, Q, R, R, C).reshape(B, Q, R, P)
        eqR = (rd2_t[:, None] + E_t) == Df[:, :, None, :]  # [B, Q, R(rp), P(j)]
        cntR = eqR.sum(dim=2)
        w = a / torch.clamp(cntR, min=1)

        def row_route(v):  # [B, Q, P] -> [B, Q, R(rp), C] (sum over target r)
            t = torch.where(eqR, v[:, :, None, :], zero)
            return t.reshape(B, Q, R, R, C).sum(dim=3)

        b1, b1x, b1y = row_route(w), row_route(w * px), row_route(w * py)

        # stage-1 routing: per source row rp, target c -> source column cp
        on_f = on.transpose(2, 3)[..., None].expand(B, Q, C, R, C).reshape(B, Q, C, R * C)
        cd2_f = cd2[:, :, None, :].expand(B, C, R, C).reshape(B, C, R * C)
        E_f = E.reshape(B, Q, 1, R * C)
        eqC = on_f & (cd2_f[:, None] == E_f)  # [B, Q, C'(cp), RC]
        inv = 1.0 / torch.clamp(eqC.sum(dim=2), min=1).to(a.dtype)

        def col_route(bv):  # [B, Q, R, C] -> [B, Q, C'(cp), R] (sum over c)
            t = torch.where(eqC, bv.reshape(B, Q, 1, R * C) * inv[:, :, None, :], zero)
            return t.reshape(B, Q, C, R, C).sum(dim=-1)

        tr = lambda s: s.transpose(2, 3).reshape(B, Q, P)  # -> i = (rp, cp)
        s_a, s_ax, s_ay = tr(col_route(b1)), tr(col_route(b1x)), tr(col_route(b1y))
        grad = torch.stack([px * s_a - s_ax, py * s_a - s_ay], dim=-1)
        return grad, None, None, None


@dataclasses.dataclass(frozen=True)
class MapCollisionLoss:
    """Offroad penalty with an on-road-pull gradient: sample a grid of points
    in each agent bbox; for off-road points, loss 1 - min_dist/diag where
    min_dist runs to the nearest (detached) on-road point, by the JAX
    package's default min_dist_impl="separable" (`MinDistSeparable`).

    `gather_impl` picks the drivable lookup: "bits" gathers the on-road bit
    from the bit-packed map (the JAX package's "pallas"); "px" gathers the
    value of the map binarized to int8, unpacked (its "pallas_px"). Both
    give the same off-road mask."""

    num_points_lw: Tuple[int, int] = (10, 10)
    decay_rate: float = 0.9
    guide_moving_speed_th: float = 0.5
    gather_impl: str = "bits"

    def __call__(self, x, ctx: GuidanceContext, agt_mask=None) -> torch.Tensor:
        B, N, T, _ = x.shape
        dev = x.device
        R, C = self.num_points_lw
        P = R * C
        pos = x[..., :2]  # [B, N, T, 2]
        yaw = x[..., 3]
        lw = ctx.extent[:, :2]
        diag_len = torch.sqrt(torch.sum(lw * lw, dim=-1))  # [B]

        if ctx.bbox_pts is not None and tuple(ctx.bbox_pts.shape[1:3]) == (R, C):
            pts = ctx.bbox_pts.reshape(B, P, 2)
        else:
            pts = bbox_local_grid(self.num_points_lw, dev)[None] * lw[:, None, :]
        c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]  # [B, N, T, 1]
        px = pts[:, None, None, :, 0]
        py = pts[:, None, None, :, 1]
        # row-vector rotation p @ [[c, s], [-s, c]]
        rx = px * c + py * (-s)
        ry = px * s + py * c
        agt_pts = torch.stack([rx, ry], dim=-1) + pos[..., None, :]  # [B, N, T, P, 2]

        # raster query (detached ints)
        pix = transform_points(agt_pts.detach().reshape(B, -1, 2), ctx.raster_from_agent)
        Hm, W = ctx.drivable_map.shape[-2:]
        col = torch.clamp(pix[..., 0].to(torch.int32), 0, W - 1)
        row = torch.clamp(pix[..., 1].to(torch.int32), 0, Hm - 1)
        pixq = torch.stack([col, row], dim=-1).contiguous()
        if self.gather_impl == "bits":
            packed = ctx.drivable_packed
            if packed is None:
                packed = pack_drivable_bits(ctx.drivable_map)
            vals = drivable_bit_gather(pixq, packed)
        elif self.gather_impl == "px":
            vals = drivable_gather(pixq, (ctx.drivable_map > 0).to(torch.int8))
        else:
            raise ValueError(f"unknown gather_impl {self.gather_impl!r} (expected bits|px)")
        offroad = vals.reshape(B, N, T, P) <= 0

        per_step_coll = offroad.sum(dim=-1)
        overlap = (per_step_coll > 0) & (per_step_coll < P)  # [B, N, T]

        li = torch.as_tensor(np.linspace(-0.5, 0.5, R).astype(np.float32), device=dev)
        wi = torch.as_tensor(np.linspace(-0.5, 0.5, C).astype(np.float32), device=dev)
        rd2 = ((li[:, None] - li[None]) ** 2)[None] * (lw[:, 0] ** 2)[:, None, None]
        cd2 = ((wi[:, None] - wi[None]) ** 2)[None] * (lw[:, 1] ** 2)[:, None, None]
        min_dist = MinDistSeparable.apply(
            agt_pts.reshape(B, N * T, P, 2), (~offroad).reshape(B, N * T, P),
            rd2.contiguous(), cd2.contiguous(),
        ).reshape(B, N, T, P)
        pt_loss = 1.0 - min_dist / diag_len[:, None, None, None]
        has_onroad = torch.any(~offroad, dim=-1, keepdim=True)
        zero = torch.zeros((), dtype=pt_loss.dtype, device=dev)
        pt_loss = torch.where(offroad & has_onroad, pt_loss, zero)
        step_loss = torch.where(overlap, pt_loss.sum(dim=-1), zero)
        w = _decay_weights(T, self.decay_rate, dev)
        loss = torch.einsum("t,bnt->bn", w, step_loss)
        moving = torch.abs(ctx.curr_speed) > self.guide_moving_speed_th
        return torch.where(moving[:, None], loss, zero)
