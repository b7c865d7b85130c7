"""Guidance losses of the guided sampler (port of the map- and
agent-collision parts of `cld_tpu/guidance/losses.py`).

Every loss maps (x [B, N, T, 6] descaled (x, y, vel, yaw, acc, yawvel),
ctx, agt_mask [B]) -> [B, N].

`AgentCollisionLoss`: the scene-block path ([S, A, A] blocks) and the flat
[B, B] path, `excluded_agents`, and the "diff" / "dot" / "auto" pairwise
forms, chunked over the horizon under an element budget.

`MapCollisionLoss`: every `min_dist_impl` of the JAX package. "separable"
(`MinDistSeparable`), "separable_xy" and "separable_xy_bf16"
(`MinDistSeparableXY`, `MinDistSeparableXYBf16`) are the exact two-pass EDT
over the bbox grid; "rigid" reads the pose-invariant [B, P, P] distance
cache, with `min_fwd_impl` "auto" / "jnp" / "eqmin" (`MinDistRigid`), "bf16"
(`MinDistRigidBf16`) or "fused" (`MinDistRigidFused`, the CUDA kernel
`rigid_min_fused` forward); "rigid_kernel" (the JAX package's
"rigid_pallas") runs the CUDA kernels `rigid_min` and `rigid_bwd`
(`MinDistRigidKernel`); "pairwise" differentiates the direct P x P
distances. On a CUDA map the drivable lookup runs a gather kernel of
`ops.gather_kernels`: the bit gather from the packed map
(`gather_impl="bits"`, the JAX package's "pallas") or the unpacked value
gather ("px", its "pallas_px"); "index" is plain indexing (its "jnp").

Two tie rules: "rigid", "pairwise" and the separable forms split a tied
column's cotangent evenly among the tied rows (per stage, for the separable
forms); "rigid_kernel" and "fused" give it all to the lowest on-road row.
Values agree across all of them; gradients agree within a family.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from cld_tpu_torch.ops.gather_kernels import (
    drivable_bit_gather,
    drivable_gather,
    pack_drivable_bits,
)
from cld_tpu_torch.ops.geometry import transform_points
from cld_tpu_torch.ops.rigid_kernels import rigid_bwd, rigid_min, rigid_min_fused


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
    # MapCollisionLoss bbox invariants (`prepack_map_bbox`): the extent-scaled
    # grid points [B, R, C, 2], kept grid-shaped so the loss can check the
    # exact (R, C) before reuse, and their pairwise squared distances
    # [B, P, P] (P = R * C, row-major), read by the rigid and pairwise paths
    bbox_pts: Optional[torch.Tensor] = None
    bbox_d2: Optional[torch.Tensor] = None


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


def _pairwise_d2(pts: torch.Tensor) -> torch.Tensor:
    """[B, P, 2] -> [B, P, P] squared distances (exactly symmetric)."""
    return torch.sum((pts[:, :, None, :] - pts[:, None, :, :]) ** 2, dim=-1)


def prepack_map_bbox(
    ctx: GuidanceContext, num_points_lw: Tuple[int, int] = (10, 10), with_d2: bool = True
) -> GuidanceContext:
    """Fill the MapCollisionLoss bbox invariants: the extent-scaled grid
    points [B, R, C, 2] and, with `with_d2`, their pairwise squared distances
    [B, P, P]. Both depend only on the extents and the grid, so they are
    computed once per context, out of the sampling loop. A ctx packed for
    another grid is packed again. Only the rigid and pairwise
    `min_dist_impl`s read the distance cache."""
    R, C = num_points_lw
    if ctx.bbox_pts is not None and tuple(ctx.bbox_pts.shape[1:3]) == (R, C):
        if not with_d2 or ctx.bbox_d2 is not None:
            return ctx
    local = bbox_local_grid(num_points_lw, ctx.extent.device)  # [P, 2]
    pts = local[None] * ctx.extent[:, None, :2]  # [B, P, 2]
    d2 = _pairwise_d2(pts).contiguous() if with_d2 else None
    return ctx._replace(bbox_pts=pts.reshape(-1, R, C, 2), bbox_d2=d2)


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


# elements (f32) per horizon-chunk tile of the chunked paths, and the largest
# [B, N*T, P, P] masked-min tensor the "rigid" path takes in one piece
_CHUNK_BUDGET = int(os.environ.get("CLD_GUIDE_CHUNK_ELEMS", 1 << 25))
_FULL_HORIZON_BUDGET = int(os.environ.get("CLD_GUIDE_FULL_ELEMS", 1 << 27))


def _time_chunk(T: int, elems_per_step: int, budget: int = 0) -> int:
    """Steps per horizon chunk: as many as fit the element budget, so small
    problems run in one chunk and scene-scale ones stay memory-bounded;
    nudged down towards a divisor of T."""
    budget = budget or _CHUNK_BUDGET
    k = max(1, min(T, budget // max(elems_per_step, 1)))
    while T % k > 0 and (T % k) < k // 2 and k > 1:
        k -= 1
    return k


def _chunked_sum(step, T: int, K: int, init: torch.Tensor) -> torch.Tensor:
    """init + sum over horizon chunks [t0, t1) of step(t0, t1). One chunk is
    computed directly; several are each recomputed in the backward pass
    (where the JAX package scans checkpointed chunks), so only one chunk's
    pairwise tile is alive at a time."""
    if K >= T:
        return init + step(0, T)
    acc = init
    for t0 in range(0, T, K):
        acc = acc + checkpoint(step, t0, min(t0 + K, T), use_reentrant=False)
    return acc


def disk_centres_world(x: torch.Tensor, ctx: GuidanceContext, num_disks: int) -> torch.Tensor:
    """World-frame centres of the `num_disks` circles that cover each agent
    along its length (radius = half its width): trajectories x [B, N, T, 6]
    -> [B, N, T, D, 2]."""
    pos_w, yaw_w = _to_world(x, ctx.world_from_agent)
    agt_rad = ctx.extent[:, 1] / 2.0  # [B]
    cent_min = -(ctx.extent[:, 0] / 2.0) + agt_rad
    cent_max = (ctx.extent[:, 0] / 2.0) - agt_rad
    lin = torch.linspace(0.0, 1.0, num_disks, device=x.device)
    cent_x = cent_min[:, None] + (cent_max - cent_min)[:, None] * lin[None]  # [B, D]
    centroids = torch.stack([cent_x, torch.zeros_like(cent_x)], dim=-1)  # [B, D, 2]

    c = torch.cos(yaw_w)  # [B, N, T, 1]
    s = torch.sin(yaw_w)
    cent = centroids[:, None, None]  # [B, 1, 1, D, 2]
    rx = cent[..., 0] * c + cent[..., 1] * (-s)
    ry = cent[..., 0] * s + cent[..., 1] * c
    return torch.stack([rx, ry], dim=-1) + pos_w[..., None, :]


@dataclasses.dataclass(frozen=True)
class AgentCollisionLoss:
    """Scene-level pairwise disk-collision penalty: each agent is num_disks
    circles along its length; penalty 1 - d/penalty_dist for colliding
    pairs, decayed over time, averaged over the other agents.

    `excluded_agents`: collisions among these agents go unpenalized (pairs
    with both ends excluded); excluded-vs-included pairs still count.

    `scene_block`: when the batch is contiguous equal-size scenes of
    `scene_block` agents, distances are computed block-diagonally
    ([S, A, A] instead of [B, B]) with the same numbers as the flat path
    (cross-scene pairs are zero there). The layout is not checked: scenes
    that straddle block boundaries lose their cross-block pairs. None (or a
    block that does not divide B) takes the flat path.

    `pairwise_impl`, on the scene-block path: "diff" materializes the disk
    differences and reduces; "dot" expands the norm with one batched Gram
    product on points centred per (step, scene, sample), accurate to about
    1e-4 relative; "auto" is "dot" for blocks of A >= 16 on a CUDA device
    (where the JAX package takes it on the TPU) and "diff" otherwise."""

    num_disks: int = 5
    buffer_dist: float = 0.2
    decay_rate: float = 0.9
    guide_moving_speed_th: float = 0.5
    excluded_agents: Optional[Tuple[int, ...]] = None
    scene_block: Optional[int] = None
    pairwise_impl: str = "auto"

    def __call__(self, x, ctx: GuidanceContext, agt_mask=None) -> torch.Tensor:
        B, N, T, _ = x.shape
        dev = x.device
        moving = torch.abs(ctx.curr_speed) > self.guide_moving_speed_th
        x = _mask_gradient(x, moving)
        if agt_mask is not None:
            x = _mask_gradient(x, agt_mask)
        agt_rad = ctx.extent[:, 1] / 2.0  # [B]
        cent_w = disk_centres_world(x, ctx, self.num_disks)  # [B, N, T, D, 2]

        D = self.num_disks
        w = _decay_weights(T, self.decay_rate, dev)
        zero = torch.zeros((), dtype=x.dtype, device=dev)
        exc = None
        if self.excluded_agents:
            exc = torch.zeros((B,), dtype=torch.bool, device=dev)
            exc[torch.as_tensor(self.excluded_agents, dtype=torch.long, device=dev)] = True
        A = self.scene_block
        if A is not None and 1 < A <= B and B % A == 0:
            S = B // A
            si = ctx.scene_index.reshape(S, A)
            rad = agt_rad.reshape(S, A)
            pd = (rad[:, :, None] + rad[:, None, :] + self.buffer_dist)[None, ..., None]
            eye = torch.eye(A, dtype=torch.bool, device=dev)
            pair_valid = (si[:, :, None] == si[:, None, :]) & ~eye[None]
            if exc is not None:
                exc_b = exc.reshape(S, A)
                pair_valid = pair_valid & ~(exc_b[:, :, None] & exc_b[:, None, :])
            impl = self.pairwise_impl
            if impl == "auto":
                impl = "dot" if A >= 16 and dev.type == "cuda" else "diff"
            if impl not in ("diff", "dot"):
                raise ValueError(
                    f"unknown pairwise_impl {self.pairwise_impl!r} (expected auto|diff|dot)"
                )
            cent_t = cent_w.reshape(S, A, N, T, D, 2).permute(3, 0, 1, 2, 4, 5)  # [T,S,A,N,D,2]

            def step(t0, t1):
                cent_k = cent_t[t0:t1]  # [K, S, A, N, D, 2]
                K = t1 - t0
                if impl == "dot":
                    pts = cent_k.permute(0, 1, 3, 2, 4, 5).reshape(K * S * N, A * D, 2)
                    pts = pts - torch.mean(pts, dim=1, keepdim=True)
                    sq = torch.sum(pts * pts, dim=-1)  # [KSN, AD]
                    gram = torch.matmul(pts, pts.transpose(1, 2))
                    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * gram
                    dist = torch.sqrt(torch.maximum(d2, zero) + 1e-12)
                    pair = torch.amin(dist.reshape(K * S * N, A, D, A, D), dim=(2, 4))
                    pair = pair.reshape(K, S, N, A, A).permute(0, 1, 3, 4, 2)
                else:
                    diff = (
                        cent_k[:, :, :, None, :, :, None, :] - cent_k[:, :, None, :, :, None, :, :]
                    )  # [K, S, A, A, N, D, D, 2]
                    dist = torch.sqrt(torch.sum(diff**2, dim=-1) + 1e-12)
                    pair = torch.amin(dist.reshape(K, S, A, A, N, -1), dim=-1)  # [K,S,A,A,N]
                colliding = (pair <= pd) & pair_valid[None, ..., None]
                pen = torch.where(colliding, 1.0 - pair / pd, zero)
                return torch.einsum("k,ksabn->sabn", w[t0:t1], pen)

            acc = _chunked_sum(step, T, _time_chunk(T, S * A * A * N * D * D),
                               torch.zeros((S, A, A, N), dtype=x.dtype, device=dev))
            # sum over in-block others / B == the flat path's mean over B
            per_agent = (torch.sum(acc, dim=2) / B).reshape(B, N)
            return torch.where(moving[:, None], per_agent, zero)

        pd = (agt_rad[:, None] + agt_rad[None, :] + self.buffer_dist)[None, ..., None]  # [1,B,B,1]
        same_scene = ctx.scene_index[:, None] == ctx.scene_index[None, :]
        pair_valid = same_scene & ~torch.eye(B, dtype=torch.bool, device=dev)
        if exc is not None:
            pair_valid = pair_valid & ~(exc[:, None] & exc[None, :])
        cent_t = cent_w.permute(2, 0, 1, 3, 4)  # [T, B, N, D, 2]

        def step(t0, t1):
            cent_k = cent_t[t0:t1]
            diff = cent_k[:, :, None, :, :, None, :] - cent_k[:, None, :, :, None, :, :]
            dist = torch.sqrt(torch.sum(diff**2, dim=-1) + 1e-12)  # [K, B, B, N, D, D]
            pair = torch.amin(dist.reshape(t1 - t0, B, B, N, -1), dim=-1)  # [K, B, B, N]
            colliding = (pair <= pd) & pair_valid[None, ..., None]
            pen = torch.where(colliding, 1.0 - pair / pd, zero)
            return torch.einsum("k,kijn->ijn", w[t0:t1], pen)

        acc = _chunked_sum(step, T, _time_chunk(T, B * B * N * D * D),
                           torch.zeros((B, B, N), dtype=x.dtype, device=dev))
        per_agent = torch.mean(acc, dim=1)  # mean over other agents -> [B, N]
        return torch.where(moving[:, None], per_agent, zero)


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


def _rigid_masked_d2(d2_local, onroad, big):
    return torch.where(onroad[..., :, None], d2_local, big)  # [..., P(row), P(col)]


def _route_columns(eq, a, pts):
    """grad_i = p_i * sum_j eq_ij a_j - sum_j eq_ij a_j p_j for a routing
    matrix eq [..., P(i), P(j)] and column weights a [..., P]."""
    s = torch.matmul(eq, torch.stack([a, a * pts[..., 0], a * pts[..., 1]], dim=-1))
    return pts * s[..., :1] - s[..., 1:]


class MinDistRigid(torch.autograd.Function):
    """Rigid-cache form of the map-collision min distance: the P bbox points
    of one agent are a rigid transform of a fixed local grid, so `d2_local`
    [..., P, P] is pose-invariant and the forward is one masked min over it.

    pts [..., P, 2] current pose points (backward only), d2_local
    broadcastable to [..., P, P], onroad [..., P] bool -> [..., P].

    Backward (`cld_tpu/guidance/losses.py:193-213`): column j's cotangent
    flows to its min row(s) as g_j (p_i - p_j) / d_j, split evenly among
    exact ties (torch.amin's rule). The rows are recovered by exact float
    equality against the stored min. Only pts gets a gradient."""

    @staticmethod
    def forward(ctx, pts, d2_local, onroad):
        big = torch.full((), _BIG_D2, dtype=d2_local.dtype, device=d2_local.device)
        m2 = torch.amin(_rigid_masked_d2(d2_local, onroad, big), dim=-2)
        ctx.save_for_backward(pts, d2_local, onroad, m2)
        return torch.sqrt(m2 + 1e-12)

    @staticmethod
    def backward(ctx, g):
        pts, d2_local, onroad, m2 = ctx.saved_tensors
        big = torch.full((), _BIG_D2, dtype=d2_local.dtype, device=d2_local.device)
        eq = (_rigid_masked_d2(d2_local, onroad, big) == m2[..., None, :]).to(pts.dtype)
        cnt = torch.sum(eq, dim=-2)  # ties per column; >= 1
        a = g / torch.sqrt(m2 + 1e-12) / torch.clamp(cnt, min=1.0)
        return _route_columns(eq, a, pts), None, None


class MinDistRigidBf16(torch.autograd.Function):
    """bfloat16 twin of `MinDistRigid` (`min_fwd_impl="bf16"`): the masked
    min and the equality recovery run on the cache rounded to bf16 (the
    masked value 1e12 rounded too), the routing weights and their products
    with the points are rounded to bf16 before an f32 sum, and the gradient
    is assembled in f32. Distances carry ~2^-8 relative error; bf16 turns
    near-ties into exact ties, which split."""

    @staticmethod
    def _masked(d2_local, onroad):
        big = torch.full((), _BIG_D2, dtype=torch.bfloat16, device=d2_local.device)
        return _rigid_masked_d2(d2_local.to(torch.bfloat16), onroad, big)

    @staticmethod
    def forward(ctx, pts, d2_local, onroad):
        m2 = torch.amin(MinDistRigidBf16._masked(d2_local, onroad), dim=-2)
        ctx.save_for_backward(pts, d2_local, onroad, m2)
        return torch.sqrt(m2.to(torch.float32) + 1e-12)

    @staticmethod
    def backward(ctx, g):
        pts, d2_local, onroad, m2 = ctx.saved_tensors
        eq = (MinDistRigidBf16._masked(d2_local, onroad) == m2[..., None, :]).to(torch.float32)
        cnt = torch.sum(eq, dim=-2)
        m = torch.sqrt(m2.to(torch.float32) + 1e-12)
        a = (g / m / torch.clamp(cnt, min=1.0)).to(torch.bfloat16)
        px = pts[..., 0].to(torch.bfloat16)
        py = pts[..., 1].to(torch.bfloat16)
        # the products round to bf16, the sums accumulate in f32
        cols = torch.stack([a, a * px, a * py], dim=-1).to(torch.float32)
        s = torch.matmul(eq, cols)
        return pts * s[..., :1] - s[..., 1:], None, None


def _route_by_idx(pts, idx, dist, g):
    """Winner-take-all routing to the argmin row, in plain torch: the
    backward of the forwards that return an index. On an exact tie the whole
    cotangent goes to the one row `idx` names."""
    P = pts.shape[-2]
    rows = torch.arange(P, device=pts.device)[:, None]
    onehot = (idx[..., None, :] == rows).to(pts.dtype)
    return _route_columns(onehot, g / dist, pts)


class MinDistRigidFused(torch.autograd.Function):
    """`min_fwd_impl="fused"`: the forward is `rigid_min_fused` (on CUDA the
    kernel that sweeps the horizon with the cache loaded once), the backward
    the plain winner-take-all routing, as the JAX package keeps it.

    pts [B, Q, P, 2] (backward only), d2_local [B, P, P], onroad [B, Q, P]."""

    @staticmethod
    def forward(ctx, pts, d2_local, onroad):
        dist, idx = rigid_min_fused(d2_local.contiguous(), onroad.contiguous())
        ctx.save_for_backward(pts, idx, dist)
        return dist

    @staticmethod
    def backward(ctx, g):
        return _route_by_idx(*ctx.saved_tensors, g), None, None


class MinDistRigidKernel(torch.autograd.Function):
    """`min_dist_impl="rigid_kernel"`: forward `rigid_min`, backward
    `rigid_bwd` over the full horizon at once (on CUDA both are kernels;
    nothing pairwise reaches device memory). Winner-take-all on ties.

    pts [B, Q, P, 2], d2_local [B, P, P], onroad [B, Q, P] bool."""

    @staticmethod
    def forward(ctx, pts, d2_local, onroad):
        dist, idx = rigid_min(d2_local.contiguous(), onroad.contiguous())
        ctx.save_for_backward(pts, idx, dist)
        return dist

    @staticmethod
    def backward(ctx, g):
        pts, idx, dist = ctx.saved_tensors
        return rigid_bwd(pts.contiguous(), idx, dist, g.contiguous()), None, None


def _sep_stage_minima_bf16(onroad, rd2, cd2):
    """bf16 twin of `_sep_stage_minima`: E and D stay bf16, so the backward's
    equality recovery runs against bitwise-identical recomputes."""
    B, Q, P = onroad.shape
    R = rd2.shape[-1]
    C = cd2.shape[-1]
    on = onroad.reshape(B, Q, R, C)
    cd2b = cd2.to(torch.bfloat16)
    rd2b = rd2.to(torch.bfloat16)
    big = torch.full((), _BIG_D2, dtype=torch.bfloat16, device=rd2.device)
    E = big.expand(B, Q, R, C)
    for cp in range(C):
        E = torch.minimum(E, torch.where(on[..., cp : cp + 1], cd2b[:, None, None, cp, :], big))
    D = big.expand(B, Q, R, C)
    for rp in range(R):
        D = torch.minimum(D, rd2b[:, None, rp, :, None] + E[:, :, rp : rp + 1, :])
    return torch.sqrt(D.to(torch.float32).reshape(B, Q, P) + 1e-12), E, D


def _xy_moments_backward(g, yaw, onroad, rd2, cd2, li, wi, lw, E, D, work):
    """The pose gradient of the separable EDT from offset moments
    (`cld_tpu/guidance/losses.py:536-586`, and `:636-685` with `work` =
    bfloat16). For a rigid grid p_i - p_j = Rot(yaw) delta_local, so
        grad_pos[q] = Rot(yaw_q) sum_j w_j delta_j              (w = g / d)
        grad_yaw[q] = sum_j w_j (delta_jy loc_jx - delta_jx loc_jy)
    with delta the tie-averaged argmin grid offset, accumulated by the same
    equalities against the staged minima as `MinDistSeparable`'s routing
    (per-stage even split). The sweeps run in `work` (the dtype of E and D);
    the assembly is f32."""
    B, Q, P = onroad.shape
    R = rd2.shape[-1]
    C = cd2.shape[-1]
    on = onroad.reshape(B, Q, R, C)
    w = g.reshape(B, Q, R, C) / torch.sqrt(D.to(torch.float32) + 1e-12)
    cd2w, rd2w, wiw, liw = (t.to(work) for t in (cd2, rd2, wi, li))
    one = torch.ones((), dtype=work, device=g.device)
    zero = torch.zeros((), dtype=work, device=g.device)

    cnt1 = torch.zeros((B, Q, R, C), dtype=work, device=g.device)
    dwsum = torch.zeros_like(cnt1)
    for cp in range(C):
        f = torch.where(on[:, :, :, cp : cp + 1] & (cd2w[:, None, None, cp, :] == E), one, zero)
        cnt1 = cnt1 + f
        dwsum = dwsum + f * (wiw[cp] - wiw)
    dwbar1 = dwsum / torch.maximum(cnt1, one)  # [B, Q, R(rp), C]

    cnt2 = torch.zeros_like(cnt1)
    dlsum = torch.zeros_like(cnt1)
    dwbar = torch.zeros_like(cnt1)
    for rp in range(R):
        f = torch.where((rd2w[:, None, rp, :, None] + E[:, :, rp : rp + 1, :]) == D, one, zero)
        cnt2 = cnt2 + f
        dlsum = dlsum + f * (liw[rp] - liw)[None, None, :, None]
        dwbar = dwbar + f * dwbar1[:, :, rp : rp + 1, :]
    inv2 = 1.0 / torch.clamp(cnt2.to(torch.float32), min=1.0)
    lw0 = lw[:, 0][:, None, None, None]
    lw1 = lw[:, 1][:, None, None, None]
    dx_loc = dlsum.to(torch.float32) * inv2 * lw0  # tie-averaged delta, extent-scaled
    dy_loc = dwbar.to(torch.float32) * inv2 * lw1

    mx = torch.sum(w * dx_loc, dim=(2, 3))  # [B, Q]
    my = torch.sum(w * dy_loc, dim=(2, 3))
    ljx = li[None, None, :, None] * lw0  # target point local coords
    ljy = wi[None, None, None, :] * lw1
    gyaw = torch.sum(w * (dy_loc * ljx - dx_loc * ljy), dim=(2, 3))
    c, s = torch.cos(yaw), torch.sin(yaw)
    gpos = torch.stack([c * mx - s * my, s * mx + c * my], dim=-1)
    return gpos, gyaw


class MinDistSeparableXY(torch.autograd.Function):
    """`min_dist_impl="separable_xy"`: `MinDistSeparable`'s values (bitwise)
    with the gradient taken at the (pos, yaw) boundary from offset moments,
    without routing (`_xy_moments_backward`).

    pos [B, Q, 2], yaw [B, Q] (backward only), onroad [B, Q, P] bool, rd2
    [B, R, R], cd2 [B, C, C], li [R] / wi [C] unit grid coordinates, lw
    [B, 2] extents -> [B, Q, P]."""

    @staticmethod
    def forward(ctx, pos, yaw, onroad, rd2, cd2, li, wi, lw):
        d, E, D = _sep_stage_minima(onroad, rd2, cd2)
        ctx.save_for_backward(yaw, onroad, rd2, cd2, li, wi, lw, E, D)
        return d

    @staticmethod
    def backward(ctx, g):
        gpos, gyaw = _xy_moments_backward(g, *ctx.saved_tensors, torch.float32)
        return gpos, gyaw, None, None, None, None, None, None


class MinDistSeparableXYBf16(torch.autograd.Function):
    """`min_dist_impl="separable_xy_bf16"`: the xy moment path with the EDT
    sweeps and the moment sums in bfloat16 (~2^-8 relative distance error,
    f32 assembly). Arguments as `MinDistSeparableXY`."""

    @staticmethod
    def forward(ctx, pos, yaw, onroad, rd2, cd2, li, wi, lw):
        d, E, D = _sep_stage_minima_bf16(onroad, rd2, cd2)
        ctx.save_for_backward(yaw, onroad, rd2, cd2, li, wi, lw, E, D)
        return d

    @staticmethod
    def backward(ctx, g):
        gpos, gyaw = _xy_moments_backward(g, *ctx.saved_tensors, torch.bfloat16)
        return gpos, gyaw, None, None, None, None, None, None


def _min_dist_to_onroad(pts: torch.Tensor, onroad: torch.Tensor) -> torch.Tensor:
    """`min_dist_impl="pairwise"`: for every bbox point the distance to the
    nearest on-road bbox point of the same (agent, step), differentiated by
    autograd through the live rows (the columns are detached). pts
    [..., P, 2], onroad [..., P] bool -> [..., P]."""
    det = pts.detach()
    d2 = torch.sum((pts[..., :, None, :] - det[..., None, :, :]) ** 2, dim=-1)
    big = torch.full((), _BIG_D2, dtype=d2.dtype, device=d2.device)
    d2 = torch.where(onroad[..., :, None], d2, big)
    return torch.sqrt(torch.amin(d2, dim=-2) + 1e-12)


_MIN_DIST_IMPLS = ("separable", "separable_xy", "separable_xy_bf16", "rigid", "rigid_kernel",
                   "pairwise")
_MIN_FWD_IMPLS = ("auto", "jnp", "fused", "eqmin", "bf16")


@dataclasses.dataclass(frozen=True)
class MapCollisionLoss:
    """Offroad penalty with an on-road-pull gradient: sample a grid of points
    in each agent bbox; for off-road points, loss 1 - min_dist/diag where
    min_dist runs to the nearest (detached) on-road point.

    `gather_impl` picks the drivable lookup: "bits" gathers the on-road bit
    from the bit-packed map (the JAX package's "pallas"); "px" gathers the
    value of the map binarized to int8, unpacked (its "pallas_px"); "index"
    indexes the map plainly (its "jnp"). All give the same off-road mask.

    `min_dist_impl` picks the min-distance form (values agree across all):
    "separable" (default), "separable_xy", "separable_xy_bf16", "rigid",
    "rigid_kernel" (the JAX package's "rigid_pallas") or "pairwise"; see the
    module's docstring. `min_fwd_impl` picks the forward of the full-horizon
    "rigid" path and acts under no other `min_dist_impl`: "auto" = "jnp" =
    "eqmin" (plain masked min), "fused" (the `rigid_min_fused` kernel) or
    "bf16". "rigid" beyond `_FULL_HORIZON_BUDGET` elements, and "pairwise"
    always, run in horizon chunks of `_time_chunk` steps."""

    num_points_lw: Tuple[int, int] = (10, 10)
    decay_rate: float = 0.9
    guide_moving_speed_th: float = 0.5
    gather_impl: str = "bits"
    min_dist_impl: str = "separable"
    min_fwd_impl: str = "auto"

    def __call__(self, x, ctx: GuidanceContext, agt_mask=None) -> torch.Tensor:
        if self.min_fwd_impl not in _MIN_FWD_IMPLS:
            raise ValueError(
                f"unknown min_fwd_impl {self.min_fwd_impl!r} (expected {'|'.join(_MIN_FWD_IMPLS)})"
            )
        if self.min_dist_impl not in _MIN_DIST_IMPLS:
            raise ValueError(
                f"unknown min_dist_impl {self.min_dist_impl!r} "
                f"(expected {'|'.join(_MIN_DIST_IMPLS)})"
            )
        B, N, T, _ = x.shape
        dev = x.device
        R, C = self.num_points_lw
        P = R * C
        pos = x[..., :2]  # [B, N, T, 2]
        yaw = x[..., 3]
        lw = ctx.extent[:, :2]
        diag_len = torch.sqrt(torch.sum(lw * lw, dim=-1))  # [B]

        # the prepacked grid is reused only on an exact (R, C) match: another
        # factorization of the same point count is another grid
        grid_match = ctx.bbox_pts is not None and tuple(ctx.bbox_pts.shape[1:3]) == (R, C)
        if grid_match:
            pts = ctx.bbox_pts.reshape(B, P, 2)
        else:
            pts = bbox_local_grid(self.num_points_lw, dev)[None] * lw[:, None, :]

        def pairwise_d2():
            if grid_match and ctx.bbox_d2 is not None:
                return ctx.bbox_d2  # [B, P, P]
            return _pairwise_d2(pts)

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
        if self.gather_impl == "bits":
            packed = ctx.drivable_packed
            if packed is None:
                packed = pack_drivable_bits(ctx.drivable_map)
            vals = drivable_bit_gather(torch.stack([col, row], dim=-1).contiguous(), packed)
        elif self.gather_impl == "px":
            vals = drivable_gather(torch.stack([col, row], dim=-1).contiguous(),
                                   (ctx.drivable_map > 0).to(torch.int8))
        elif self.gather_impl == "index":
            b_idx = torch.arange(B, device=dev)[:, None]
            vals = ctx.drivable_map[b_idx, row.long(), col.long()]
        else:
            raise ValueError(
                f"unknown gather_impl {self.gather_impl!r} (expected bits|px|index)"
            )
        offroad = vals.reshape(B, N, T, P) <= 0

        per_step_coll = offroad.sum(dim=-1)
        overlap = (per_step_coll > 0) & (per_step_coll < P)  # [B, N, T]
        w = _decay_weights(T, self.decay_rate, dev)
        zero = torch.zeros((), dtype=x.dtype, device=dev)
        moving = torch.abs(ctx.curr_speed) > self.guide_moving_speed_th

        def step_losses(min_dist, off, ov, diag):
            """Per-step loss from per-point distances: only off-road points
            with an on-road partner count, and only steps that straddle the
            road edge (fully on or off gives no direction)."""
            pt_loss = 1.0 - min_dist / diag
            has_onroad = torch.any(~off, dim=-1, keepdim=True)
            pt_loss = torch.where(off & has_onroad, pt_loss, zero)
            return torch.where(ov, pt_loss.sum(dim=-1), zero)

        def full_horizon(min_dist):  # [B, N*T, P] -> [B, N]
            step_loss = step_losses(min_dist.reshape(B, N, T, P), offroad, overlap,
                                    diag_len[:, None, None, None])
            loss = torch.einsum("t,bnt->bn", w, step_loss)
            return torch.where(moving[:, None], loss, zero)

        Q = N * T
        onroad_q = (~offroad).reshape(B, Q, P)
        if self.min_dist_impl in ("separable", "separable_xy", "separable_xy_bf16"):
            li = torch.as_tensor(np.linspace(-0.5, 0.5, R).astype(np.float32), device=dev)
            wi = torch.as_tensor(np.linspace(-0.5, 0.5, C).astype(np.float32), device=dev)
            rd2 = (((li[:, None] - li[None]) ** 2)[None]
                   * (lw[:, 0] ** 2)[:, None, None]).contiguous()
            cd2 = (((wi[:, None] - wi[None]) ** 2)[None]
                   * (lw[:, 1] ** 2)[:, None, None]).contiguous()
            if self.min_dist_impl == "separable":
                return full_horizon(MinDistSeparable.apply(
                    agt_pts.reshape(B, Q, P, 2), onroad_q, rd2, cd2))
            fn = (MinDistSeparableXYBf16 if self.min_dist_impl == "separable_xy_bf16"
                  else MinDistSeparableXY)
            return full_horizon(fn.apply(pos.reshape(B, Q, 2), yaw.reshape(B, Q), onroad_q,
                                         rd2, cd2, li, wi, lw))

        if self.min_dist_impl == "rigid_kernel":
            return full_horizon(MinDistRigidKernel.apply(
                agt_pts.reshape(B, Q, P, 2), pairwise_d2(), onroad_q))

        if self.min_dist_impl == "rigid":
            if T * B * N * P * P <= _FULL_HORIZON_BUDGET:
                pts_q = agt_pts.reshape(B, Q, P, 2)
                if self.min_fwd_impl == "fused":
                    return full_horizon(MinDistRigidFused.apply(pts_q, pairwise_d2(), onroad_q))
                fn = MinDistRigidBf16 if self.min_fwd_impl == "bf16" else MinDistRigid
                return full_horizon(fn.apply(pts_q, pairwise_d2()[:, None], onroad_q))
            if self.min_fwd_impl not in ("auto", "jnp"):
                # the other forwards exist on the full-horizon path only; a
                # quiet fallback would corrupt a measurement
                raise ValueError(
                    f"min_fwd_impl={self.min_fwd_impl!r} requires the full-horizon path "
                    f"(T*B*N*P*P={T * B * N * P * P} > CLD_GUIDE_FULL_ELEMS="
                    f"{_FULL_HORIZON_BUDGET}); raise the budget or use the default forward"
                )
            d2_local = pairwise_d2().reshape(1, B, 1, P, P)

            def min_dist_fn(pts_k, off_k):
                return MinDistRigid.apply(pts_k, d2_local, ~off_k)
        else:  # "pairwise"
            def min_dist_fn(pts_k, off_k):
                return _min_dist_to_onroad(pts_k, ~off_k)

        pts_t = agt_pts.permute(2, 0, 1, 3, 4)  # [T, B, N, P, 2]
        off_t = offroad.permute(2, 0, 1, 3)  # [T, B, N, P]
        ov_t = overlap.permute(2, 0, 1)  # [T, B, N]

        def step(t0, t1):
            step_loss = step_losses(min_dist_fn(pts_t[t0:t1], off_t[t0:t1]), off_t[t0:t1],
                                    ov_t[t0:t1], diag_len[None, :, None, None])
            return torch.einsum("k,kbn->bn", w[t0:t1], step_loss)

        loss = _chunked_sum(step, T, _time_chunk(T, B * N * P * P),
                            torch.zeros((B, N), dtype=x.dtype, device=dev))
        return torch.where(moving[:, None], loss, zero)
