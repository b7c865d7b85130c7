"""The guidance rule library (port of `cld_tpu/guidance/losses.py`).

Every loss maps (x [B, N, T, 6] descaled (x, y, vel, yaw, acc, yawvel),
ctx, agt_mask [B]) -> [B, N]. `GUIDANCE_LOSS_MAP` names the 15 rule classes
(and the reference's two aliases); `make_guidance_losses` builds them from
config dicts. The world-frame rules read the context's optional fields
(`agent_from_world`, `global_t`, `agent_hist_world`), `LaneFollowingLoss` its
lane points. Where a rule takes a norm, a hard min or an index, it computes
them as the JAX package does (`_norm`, `torch.amin` / `torch.amax`,
`_jnp_take`), so that values and gradients agree, ties and NaNs included.

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
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from cld_tpu_torch.ops.gather_kernels import (
    drivable_bit_gather,
    drivable_gather,
    pack_drivable_bits,
)
from cld_tpu_torch.ops.dynamics import angle_diff
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
    # lane_following's closest lane points [B, L, 3] (x, y, yaw) in the agent
    # frame, masked by lane_avail [B, L]
    lane_points: Optional[torch.Tensor] = None
    lane_avail: Optional[torch.Tensor] = None
    # the world-frame rules' fields; None falls back to the inverse of
    # world_from_agent / frame 0 / no stop latch
    agent_from_world: Optional[torch.Tensor] = None  # [B, 3, 3]
    global_t: Optional[object] = None  # current sim frame: a Python int or a 0-d int tensor
    agent_hist_world: Optional[torch.Tensor] = None  # [B, Th, 4] world (x, y, v, yaw)
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


# --- the rest of the rule library ---------------------------------------------------------


def _as_tensor(v, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """A rule's static parameter (number, sequence, numpy array or tensor) as
    a tensor on x's device."""
    if isinstance(v, torch.Tensor):
        return v.to(device=x.device, dtype=dtype)
    return torch.as_tensor(np.asarray(v), dtype=dtype, device=x.device)


def _per_agent(v, B: int, x: torch.Tensor) -> torch.Tensor:
    """A scalar or [B] parameter broadcast to [B] f32."""
    return torch.broadcast_to(_as_tensor(v, x), (B,))


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, computed as `jnp.linalg.norm`
    computes it: its gradient at 0 is NaN there and here, where
    `torch.linalg.vector_norm`'s is 0."""
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _jnp_take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, :, idx[b]] for x [B, N, T, ...] and idx [B], as jnp indexing
    takes it: a negative index counts from the end, an index still outside
    [0, T) reads the clamped step and passes it no gradient (XLA's gather
    clamps, its transposed scatter drops)."""
    T = x.shape[2]
    idx = torch.where(idx < 0, idx + T, idx)
    out = x[torch.arange(x.shape[0], device=x.device), :, torch.clamp(idx, 0, T - 1)]
    outside = ((idx < 0) | (idx >= T)).reshape((-1,) + (1,) * (out.ndim - 1))
    return torch.where(outside, out.detach(), out)


def _global_t(ctx: GuidanceContext, device):
    """The current sim frame: ctx.global_t (a Python int or a 0-d tensor),
    0 when unset."""
    if ctx.global_t is None:
        return 0
    if isinstance(ctx.global_t, torch.Tensor):
        return ctx.global_t.to(device=device, dtype=torch.long)
    return int(ctx.global_t)


def _set_rows(x: torch.Tensor, rows, values: torch.Tensor) -> torch.Tensor:
    """[B, N] zeros with rows[k] set to values[k] (differentiable in values)."""
    B = x.shape[0]
    idx = torch.as_tensor(np.asarray(rows, np.int64) % B, device=x.device)
    zeros = torch.zeros(x.shape[:2], dtype=x.dtype, device=x.device)
    return zeros.index_put((idx,), values.to(x.dtype))


@dataclasses.dataclass(frozen=True)
class TargetSpeedLoss:
    """Follow a per-agent target speed. `target_speed` [B] is one target per
    agent over the whole plan; [B, T_fut] is a profile over global frames,
    cut at ctx.global_t: frames beyond the profile are masked and the mean
    runs over the frames left (none left: loss 0)."""

    target_speed: object  # [B] or [B, T_fut]
    dt: float = 0.1

    def __call__(self, x, ctx: GuidanceContext, agt_mask=None) -> torch.Tensor:
        tgt = _as_tensor(self.target_speed, x)
        T = x.shape[2]
        if tgt.ndim == 1:
            dev = torch.abs(x[..., 2] - tgt[:, None, None])  # [B, N, T]
            return torch.mean(torch.nan_to_num(dev), dim=-1)
        T_fut = tgt.shape[1]
        idx = _global_t(ctx, x.device) + torch.arange(T, device=x.device)  # the plan's frames
        valid = idx < T_fut
        prof = tgt[:, torch.clamp(idx, 0, T_fut - 1)]  # [B, T]
        dev = torch.nan_to_num(torch.abs(x[..., 2] - prof[:, None, :]))
        dev = dev * valid.to(dev.dtype)[None, None, :]
        cnt = torch.clamp(torch.sum(valid.to(torch.float32)), min=1.0)
        return torch.sum(dev, dim=-1) / cnt


@dataclasses.dataclass(frozen=True)
class TargetPosAtTimeLoss:
    """Reach `target_pos` [B, 2] (agent frame) at plan step `target_time` [B]
    (read as jnp reads it, `_jnp_take`)."""

    target_pos: object
    target_time: object

    def __call__(self, x, ctx: GuidanceContext, agt_mask=None) -> torch.Tensor:
        tgt = _as_tensor(self.target_pos, x)
        x_at = _jnp_take(x[..., :2], _as_tensor(self.target_time, x, torch.long))  # [B, N, 2]
        return _norm(x_at - tgt[:, None])


@dataclasses.dataclass(frozen=True)
class TargetPosLoss:
    """Pass near `target_pos` [B, 2] (agent frame) at any step from
    `min_target_time` (a fraction of the plan) on, softmin-weighted."""

    target_pos: object
    min_target_time: float = 0.0

    def __call__(self, x, ctx: GuidanceContext, agt_mask=None) -> torch.Tensor:
        min_t = int(self.min_target_time * x.shape[2])
        pos = x[:, :, min_t:, :2]
        tgt = _as_tensor(self.target_pos, x)[:, None, None]
        weight = torch.softmax(-_norm(pos - tgt), dim=-1)
        return torch.mean(weight * torch.sum((pos - tgt) ** 2, dim=-1), dim=-1)


@dataclasses.dataclass(frozen=True)
class GlobalTargetPosLoss:
    """Progress toward a world-frame goal beyond the horizon: cover at least
    max(urgency * T * dt * pref_speed, min_progress_dist) of the distance."""

    target_pos_world: object  # [B, 2]
    urgency: object = 0.5  # scalar or [B]
    pref_speed: object = 1.42  # scalar or [B]
    dt: float = 0.1
    min_progress_dist: float = 0.5

    def __call__(self, x, ctx: GuidanceContext, agt_mask=None) -> torch.Tensor:
        B = x.shape[0]
        pos_w, _ = _to_world(x, ctx.world_from_agent)
        tgt = _as_tensor(self.target_pos_world, x)
        urgency, pref = _per_agent(self.urgency, B, x), _per_agent(self.pref_speed, B, x)
        final_dist = _norm(pos_w[:, :, -1] - tgt[:, None])
        init_dist = _norm(pos_w[:, :, 0] - tgt[:, None])
        max_horizon_dist = x.shape[2] * self.dt * pref
        goal_dist = torch.clamp(urgency * max_horizon_dist, min=self.min_progress_dist)
        return torch.relu(goal_dist[:, None] - (init_dist - final_dist))


def _agent_from_world(ctx: GuidanceContext) -> torch.Tensor:
    if ctx.agent_from_world is not None:
        return ctx.agent_from_world
    return torch.linalg.inv(ctx.world_from_agent)


@dataclasses.dataclass(frozen=True)
class GlobalTargetPosAtTimeLoss:
    """Reach a world-frame waypoint at global frame `target_time` [B]. While
    that frame lies beyond the plan, a progress loss (cover the straight
    distance left, shortened by urgency); once inside, the distance at the
    plan step target_time - global_t. With `target_tolerance`, an agent
    already within that distance of the waypoint has loss 0 (re-evaluated
    each call from its current world position)."""

    target_pos_world: object  # [B, 2]
    target_time: object  # [B] int global frames
    urgency: object = 0.5
    pref_speed: object = 1.42
    dt: float = 0.1
    target_tolerance: Optional[float] = 2.0

    def __call__(self, x, ctx: GuidanceContext, agt_mask=None) -> torch.Tensor:
        B, N, T, _ = x.shape
        tgt_w = _as_tensor(self.target_pos_world, x)
        tt = _as_tensor(self.target_time, x, torch.long)
        urgency = _per_agent(self.urgency, B, x)
        local_tgt = transform_points(tgt_w[:, None], _agent_from_world(ctx))[:, 0]
        local_tt = tt - _global_t(ctx, x.device)  # [B]
        exact = (local_tt >= 0) & (local_tt < T)
        prog = (local_tt >= 0) & ~exact
        idx = torch.clamp(local_tt, 0, T - 1)
        x_at = x[torch.arange(B, device=x.device), :, idx, :2]  # [B, N, 2]
        exact_loss = _norm(x_at - local_tgt[:, None])
        final_dist = _norm(x[:, :, -1, :2] - local_tgt[:, None])
        goal_dist = local_tt.to(torch.float32) * self.dt * _per_agent(self.pref_speed, B, x)
        goal_dist = goal_dist * (1.0 - urgency)
        prog_loss = torch.relu(final_dist - goal_dist[:, None])
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        loss = torch.where(exact[:, None], exact_loss,
                           torch.where(prog[:, None], prog_loss, zero))
        if self.target_tolerance is not None:
            reached = _norm(ctx.world_from_agent[:, :2, 2] - tgt_w) < self.target_tolerance
            loss = torch.where(reached[:, None], zero, loss)
        return loss


_STL_BIG = 1e6


def _stl_minish(r, dim, scale):
    """Soft min at temperature `scale` (-logsumexp(-scale r) / scale), the
    hard min at scale <= 0 (`torch.amin`, which splits a tie's gradient
    evenly, as `jnp.min` does)."""
    if scale > 0:
        return -torch.logsumexp(-scale * r, dim=dim) / scale
    return torch.amin(r, dim=dim)


def _stl_maxish(r, dim, scale):
    if scale > 0:
        return torch.logsumexp(scale * r, dim=dim) / scale
    return torch.amax(r, dim=dim)


def _stop_sign_robustness(pos, speed, center, half, *, scale, horizon_length,
                          time_step_to_start, num_time_steps_to_stop, low_speed_th):
    """Robustness at the trace's start of the stop-sign formula
        Always(Implies(in_box, Eventually_[t0, H](Always_[0, k](in_box & slow))))
        Or (out_box And not slow)
    with And / Or / Always / Eventually as soft min / max at `scale` (hard at
    <= 0); bounded windows truncate at the trace's end; Always_[0, k] spans
    k + 1 frames. pos [B, N, T, 2] in the frame of center / half [B, 2];
    speed [B, N, T]."""
    T = pos.shape[-2]
    lo_m = pos - (center - half)[:, None, None]  # [B, N, T, 2]
    hi_m = (center + half)[:, None, None] - pos
    inside_r = _stl_minish(torch.cat([lo_m, hi_m], dim=-1), -1, scale)  # [B, N, T]
    low_r = _stl_minish(torch.stack([speed + low_speed_th, low_speed_th - speed], -1), -1, scale)
    both = _stl_minish(torch.stack([inside_r, low_r], -1), -1, scale)
    kk = min(num_time_steps_to_stop + 1, T)
    pad = torch.full(both.shape[:-1] + (kk - 1,), _STL_BIG, dtype=both.dtype,
                     device=both.device)
    both_p = torch.cat([both, pad], dim=-1)
    win_r = _stl_minish(torch.stack([both_p[..., i:T + i] for i in range(kk)], -1), -1, scale)
    t_idx = torch.arange(T, device=pos.device)[:, None]  # anchor t
    s_idx = torch.arange(T, device=pos.device)[None, :]  # window start s
    valid = (s_idx >= t_idx + time_step_to_start) & (s_idx <= t_idx + horizon_length)
    masked = torch.where(valid, win_r[..., None, :], both.new_tensor(-_STL_BIG))
    ev_r = _stl_maxish(masked, -1, scale)  # [B, N, T] per anchor t
    imp = _stl_maxish(torch.stack([-inside_r, ev_r], -1), -1, scale)
    a_term = _stl_minish(imp, -1, scale)  # [B, N]
    b_term = _stl_minish(torch.stack([-inside_r[..., 0], -low_r[..., 0]], -1), -1, scale)
    return _stl_maxish(torch.stack([a_term, b_term], -1), -1, scale)


@dataclasses.dataclass(frozen=True)
class GlobalStopSignLoss:
    """World-frame stop-sign rule: loss relu(-robustness) of
    `_stop_sign_robustness`, zero for an agent whose stop is latched. The
    latch is re-derived each call from ctx.agent_hist_world: latched when
    some `action_num`-frame window of the history counts at least
    `num_time_steps_to_stop` slow in-box frames and the agent has stayed in
    the box from that window's end to the present."""

    stop_sign_pos: object  # [B, 2] world-frame box centres
    stop_box_dim: object  # [B, 2] full box dims
    scale: float = 20.0
    horizon_length: int = 52
    time_step_to_start: int = 0
    num_time_steps_to_stop: int = 3
    action_num: int = 5
    low_speed_th: float = 0.5

    def __call__(self, x, ctx: GuidanceContext, agt_mask=None) -> torch.Tensor:
        center = _as_tensor(self.stop_sign_pos, x)
        half = _as_tensor(self.stop_box_dim, x) / 2.0
        pos_w, _ = _to_world(x, ctx.world_from_agent)
        robustness = _stop_sign_robustness(
            pos_w, x[..., 2], center, half, scale=self.scale,
            horizon_length=self.horizon_length, time_step_to_start=self.time_step_to_start,
            num_time_steps_to_stop=self.num_time_steps_to_stop, low_speed_th=self.low_speed_th)
        loss = torch.relu(-robustness)
        if ctx.agent_hist_world is None:
            return loss
        hist = ctx.agent_hist_world  # [B, Th, 4]
        Th = hist.shape[1]
        in_box = torch.all(torch.abs(hist[..., :2] - center[:, None]) <= half[:, None], dim=-1)
        low = torch.abs(hist[..., 2]) < self.low_speed_th
        # in the box from each frame to the present
        since_exit = torch.flip(torch.cumprod(torch.flip(in_box, [-1]).to(torch.int32), -1),
                                [-1]).bool()
        ok = (low & in_box).to(torch.int32)
        a = max(1, min(self.action_num, Th))
        csum0 = torch.cat([torch.zeros_like(ok[:, :1]), torch.cumsum(ok, -1)], dim=-1)
        start = torch.as_tensor(np.maximum(np.arange(Th) - a + 1, 0), device=x.device)
        cnt = csum0[..., 1:] - csum0[..., start]  # slow in-box frames of the window ending at j
        already = torch.any((cnt >= self.num_time_steps_to_stop) & since_exit, dim=-1)
        return torch.where(already[:, None], torch.zeros((), dtype=x.dtype, device=x.device),
                           loss)


@dataclasses.dataclass(frozen=True)
class AccLimitLoss:
    """Penalize |acc| above a limit."""

    acc_limit: float = 2.0

    def __call__(self, x, ctx: GuidanceContext, agt_mask=None) -> torch.Tensor:
        return torch.mean(torch.relu(torch.abs(x[..., 4]) - self.acc_limit), dim=-1)


@dataclasses.dataclass(frozen=True)
class SpeedLimitLoss:
    """Penalize |v| above a limit."""

    speed_limit: float = 15.0

    def __call__(self, x, ctx: GuidanceContext, agt_mask=None) -> torch.Tensor:
        return torch.mean(torch.relu(torch.abs(x[..., 2]) - self.speed_limit), dim=-1)


@dataclasses.dataclass(frozen=True)
class StopSignLoss:
    """Agent-frame stop-sign rule: relu(-robustness) of
    `_stop_sign_robustness` on the plan's own positions, no latch.
    `stop_box_dim` holds full box dims, as `GlobalStopSignLoss`'s."""

    stop_sign_pos: object  # [B, 2] agent-frame box centres
    stop_box_dim: object  # [B, 2]
    scale: float = 20.0
    horizon_length: int = 52
    time_step_to_start: int = 0
    num_time_steps_to_stop: int = 3
    action_num: int = 5  # accepted for config compatibility; unused
    low_speed_th: float = 0.5

    def __call__(self, x, ctx: GuidanceContext, agt_mask=None) -> torch.Tensor:
        robustness = _stop_sign_robustness(
            x[..., :2], x[..., 2], _as_tensor(self.stop_sign_pos, x),
            _as_tensor(self.stop_box_dim, x) / 2.0, scale=self.scale,
            horizon_length=self.horizon_length, time_step_to_start=self.time_step_to_start,
            num_time_steps_to_stop=self.num_time_steps_to_stop, low_speed_th=self.low_speed_th)
        return torch.relu(-robustness)


@dataclasses.dataclass(frozen=True)
class KeepDistanceLoss:
    """Keep agent `target_ind` within [min_dist, max_dist] of `ref_ind`."""

    target_ind: int
    ref_ind: int
    min_dist: float = 5.0
    max_dist: float = 15.0

    def __call__(self, x, ctx: GuidanceContext, agt_mask=None) -> torch.Tensor:
        pos_w, _ = _to_world(x, ctx.world_from_agent)
        d = _norm(pos_w[self.target_ind] - pos_w[self.ref_ind])  # [N, T]
        over = torch.relu(d - self.max_dist) + torch.relu(self.min_dist - d)
        return _set_rows(x, (self.target_ind,), torch.mean(over, dim=-1)[None])

    def affected_agents(self):
        return (self.target_ind,)


@dataclasses.dataclass(frozen=True)
class CollisionAttackLoss:
    """Adversarial: the attacker's closest approach to the (fixed) victim
    over steps [time_lo, time_hi), clamped to the trajectory's length."""

    attacker_ind: int
    victim_ind: int
    time_lo: int = 0
    time_hi: int = 52
    decay_rate: float = 0.9

    def __call__(self, x, ctx: GuidanceContext, agt_mask=None) -> torch.Tensor:
        pos_w, _ = _to_world(x, ctx.world_from_agent)
        victim = pos_w[self.victim_ind].detach()
        T = x.shape[-2]
        lo = min(self.time_lo, T - 1)
        hi = max(min(self.time_hi, T), lo + 1)
        d = _norm(pos_w[self.attacker_ind, :, lo:hi] - victim[:, lo:hi])  # [N, Tw]
        return _set_rows(x, (self.attacker_ind,), torch.amin(d, dim=-1)[None])

    def affected_agents(self):
        return (self.attacker_ind,)


@dataclasses.dataclass(frozen=True)
class SocialGroupLoss:
    """Members of `group` keep `social_dist` from the group's centroid:
    cohesion * |distance to centroid - social_dist|, averaged over steps."""

    group: Tuple[int, ...]
    social_dist: float = 2.0
    cohesion: float = 0.8

    def __call__(self, x, ctx: GuidanceContext, agt_mask=None) -> torch.Tensor:
        pos_w, _ = _to_world(x, ctx.world_from_agent)
        group_pos = pos_w[torch.as_tensor(self.group, device=x.device)]  # [G, N, T, 2]
        centroid = torch.mean(group_pos, dim=0, keepdim=True)
        dev = torch.abs(_norm(group_pos - centroid) - self.social_dist) * self.cohesion
        return _set_rows(x, self.group, torch.mean(dev, dim=-1))

    def affected_agents(self):
        return self.group


@dataclasses.dataclass(frozen=True)
class LaneFollowingLoss:
    """Stay near and aligned with the closest lane points of ctx.lane_points:
    per step, the softmin-weighted distance to the lane points and the
    heading deviation from their softmin-weighted yaw."""

    pos_weight: float = 1.0
    yaw_weight: float = 0.5
    softmin_temp: float = 2.0

    def __call__(self, x, ctx: GuidanceContext, agt_mask=None) -> torch.Tensor:
        if ctx.lane_points is None:
            raise ValueError("lane_following needs ctx.lane_points")
        lanes = ctx.lane_points  # [B, L, 3]
        avail = (ctx.lane_avail if ctx.lane_avail is not None
                 else torch.ones(lanes.shape[:2], dtype=torch.bool, device=x.device))
        pos, yaw = x[..., :2], x[..., 3]
        d2 = torch.sum((pos[:, :, :, None, :] - lanes[:, None, None, :, :2]) ** 2, dim=-1)
        d = torch.sqrt(d2 + 1e-9)  # [B, N, T, L]
        am = avail[:, None, None, :]
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        # masked points get a large finite logit (an infinite one would make
        # the 0-weight x inf-distance product NaN in the backward pass)
        w = torch.softmax(-self.softmin_temp * torch.where(am, d, zero + 1e9), dim=-1)
        pos_dev = torch.sum(w * torch.where(am, d, zero), dim=-1)  # [B, N, T]
        lane_yaw = torch.sum(w * torch.where(am, lanes[:, None, None, :, 2], zero), dim=-1)
        yaw_dev = torch.abs(angle_diff(yaw, lane_yaw))
        per_step = self.pos_weight * pos_dev + self.yaw_weight * yaw_dev
        has_lane = torch.any(avail, dim=-1)[:, None, None]  # scenes without lanes: 0
        return torch.mean(per_step * has_lane, dim=-1)


GUIDANCE_LOSS_MAP = {
    "target_speed": TargetSpeedLoss,
    "agent_collision": AgentCollisionLoss,
    "map_collision": MapCollisionLoss,
    "target_pos_at_time": TargetPosAtTimeLoss,
    "target_pos": TargetPosLoss,
    "global_target_pos_at_time": GlobalTargetPosAtTimeLoss,
    "global_target_pos": GlobalTargetPosLoss,
    "acc_limit": AccLimitLoss,
    "speed_limit": SpeedLimitLoss,
    "stop_sign": StopSignLoss,
    "global_stop_sign": GlobalStopSignLoss,
    "keep_distance": KeepDistanceLoss,
    "collision_attack": CollisionAttackLoss,
    "social_group": SocialGroupLoss,
    "lane_following": LaneFollowingLoss,
    # the reference's names of two of them ("gpt", LLM-written losses, is
    # `guidance.codegen`)
    "gptcollision": CollisionAttackLoss,
    "gptkeepdistance": KeepDistanceLoss,
}


def make_guidance_losses(configs: Sequence[Dict]) -> list:
    """(loss, weight, agents) per config dict {'name', 'weight', 'params',
    'agents'}."""
    out = []
    for cfg in configs:
        cls = GUIDANCE_LOSS_MAP[cfg["name"]]
        out.append((cls(**cfg.get("params", {})), cfg.get("weight", 1.0), cfg.get("agents")))
    return out
