"""Rigid map-distance kernels: masked min / argmin over a pose-invariant
distance cache, and the argmin-routed backward. CUDA kernels, plain versions.

Counterpart of the rigid section of `cld_tpu/ops/pallas_kernels.py`
(`rigid_min_ref`, `rigid_min_pallas`, `rigid_min_fused_pallas`,
`rigid_bwd_ref`, `rigid_bwd_pallas`).

The P bbox points of one agent are a rigid transform of a fixed local grid,
so their pairwise squared distances `d2_local` [B, P, P] do not depend on the
pose. Per (agent b, step q, point j) the forward takes the minimum over the
on-road rows i of `d2_local[b, i, j]`, returns `dist = sqrt(min + 1e-12)` and
`idx`, the lowest row that attains the minimum; off-road rows count as 1e12,
so a step with no on-road point gives dist 1e6 and idx 0. `rigid_min` and
`rigid_min_fused` compute the same function under two schedules
(`csrc/rigid_min.cu`): blocks over (agent, chunk of steps), or one block
per agent that sweeps the horizon with the cache loaded once. In both, a
thread walks 4 columns for a tile of 2 steps, reading each cache row's 16
bytes once for the whole tile, then finds each minimum's lowest row in the
block of 4 rows where it last went down. Where the whole cache does not
fit one block's shared memory beside the mask (P > 232: 4 P^2 bytes against
227 KB), a block owns a chunk of the cache's columns instead
(`rigid_min_tiling`: P = 256 two chunks of 128, a 32 x 32 grid's P = 1,024
26 of 40). The backward (`csrc/rigid_bwd.cu`, one warp per agent and step)
routes column j's `a_j = g_j / dist_j` to row `idx_j`:

    grad_i = p_i * sum_{j: idx_j = i} a_j - sum_{j: idx_j = i} a_j p_j

holding a (b, q)'s columns in registers up to P = 224 and walking them 32
at a time above. The JAX kernels take any bbox grid (`num_points_lw`: 10 x
10 of record, P = 100; 16 x 16 is P = 256); these take every P up to
`RIGID_MAX_P`, where even 4 columns of the cache beside 2 steps of the mask
fill a block's shared memory (`check_points`).

Every wrapper dispatches by device: CUDA tensors launch the kernel, CPU
tensors take the `_ref` plain version beside it (no limit on P).
"""

from __future__ import annotations

from typing import Tuple

import torch

from cld_tpu_torch.ops import native

BIG_D2 = 1e12  # squared distance of a masked (off-road) row
SMEM_BYTES = 232_448  # dynamic shared memory one block may use on an H100 (227 KB)
# the largest P at which a forward block holds 4 columns of the cache (16 P
# bytes) beside 2 steps of the mask (`_step_bytes`), and the backward's
# block its running sums (24 P bytes): `check_points` raises above it
RIGID_MAX_P = 9_584


def rigid_min_ref(d2_local: torch.Tensor, onroad: torch.Tensor):
    """Plain version: d2_local [B, P, P] f32 (rows = live points, columns =
    detached points), onroad [B, Q, P] bool mask of live rows -> (dist
    [B, Q, P] f32, idx [B, Q, P] int32, the lowest argmin row per column)."""
    P = d2_local.shape[-1]
    big = torch.full((), BIG_D2, dtype=d2_local.dtype, device=d2_local.device)
    d2 = torch.where((onroad != 0)[..., :, None], d2_local[:, None], big)  # [B, Q, P, P]
    m = torch.amin(d2, dim=-2)
    rows = torch.arange(P, dtype=torch.int32, device=d2.device)[:, None]
    idx = torch.amin(torch.where(d2 == m[..., None, :], rows, P), dim=-2)
    return torch.sqrt(m + 1e-12), idx.to(torch.int32)


RIGID_MIN_TILE = 2  # steps a thread of the forward kernels walks together
TILED_STEPS = 16  # the most steps a block stages at once where P > 160


def _step_bytes(P: int) -> int:
    """Shared memory a forward block spends on one step of the mask: its
    penalties (P rounded up to 4 floats), its bit-packed words and its
    first off-road row."""
    return 4 * (-(-P // 4) * 4) + 4 * -(-P // 32) + 4


def check_points(P: int) -> None:
    """Raise ValueError unless the CUDA kernels take P bbox points."""
    if not 1 <= P <= RIGID_MAX_P:
        raise ValueError(f"rigid kernels: P = {P} bbox points; they take 1 to RIGID_MAX_P = "
                         f"{RIGID_MAX_P} (beyond it 4 columns of the cache and 2 steps of the "
                         f"mask exceed a block's {SMEM_BYTES} bytes of shared memory)")


def rigid_min_tiling(P: int) -> Tuple[int, int]:
    """(qb, pc) of both forward kernels at P bbox points: the most steps
    a block stages at once (64 up to P = 160, else 16) and the cache columns
    a block owns. pc = P while the whole [P, P] cache fits a block beside qb
    steps of the mask (P <= 232: the untiled kernels, unchanged up to P =
    224); beyond, the fewest chunks of at most the widest pc (a multiple of
    4) that fits beside 16 steps (fewer where 16 do not fit), balanced.
    `check_points` first."""
    check_points(P)
    qb = 64 if P <= 160 else TILED_STEPS
    S = -(-P // 4) * 4
    if 4 * P * S + qb * _step_bytes(P) <= SMEM_BYTES:
        return qb, P
    qb = min(TILED_STEPS, (SMEM_BYTES - 16 * P) // _step_bytes(P)
             // RIGID_MIN_TILE * RIGID_MIN_TILE)
    widest = (SMEM_BYTES - qb * _step_bytes(P)) // (4 * P) // 4 * 4
    chunks = -(-P // widest)
    return qb, -(-(-(-P // chunks)) // 4) * 4


def rigid_min_steps_per_block(B: int, Q: int, sms: int) -> int:
    """Steps per block of the `rigid_min` kernel: enough blocks over (agent,
    chunk of steps) for about two per SM of the card's `sms`, each staging
    the cache once, as few as that allows; a multiple of the step tile, at
    most 64 (the kernel stages at most that many steps' mask at once, and
    cuts the count to 16 where P > 160)."""
    chunks = max(1, round(2 * sms / max(B, 1)))
    steps = -(-Q // chunks)
    steps = -(-steps // RIGID_MIN_TILE) * RIGID_MIN_TILE
    return max(RIGID_MIN_TILE, min(64, steps))


def _rigid_min_launch(name: str, d2_local: torch.Tensor, onroad: torch.Tensor):
    dev = d2_local.device
    if dev.type == "cpu":
        return rigid_min_ref(d2_local, onroad)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    B, P, _ = d2_local.shape
    Q = onroad.shape[1]
    qb, pc = rigid_min_tiling(P)
    native.require(d2_local, "d2_local", torch.float32, (B, P, P), dev)
    if onroad.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"onroad: dtype {onroad.dtype}, expected bool or uint8")
    native.require(onroad, "onroad", onroad.dtype, (B, Q, P), dev)
    dist = torch.empty((B, Q, P), dtype=torch.float32, device=dev)
    idx = torch.empty((B, Q, P), dtype=torch.int32, device=dev)
    lib = native.library()
    args = (d2_local.data_ptr(), onroad.data_ptr(), dist.data_ptr(), idx.data_ptr(), B, Q, P)
    if name == "rigid_min":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        err = lib.cld_rigid_min(*args, min(qb, rigid_min_steps_per_block(B, Q, sms)), pc,
                                native.stream_ptr(dev))
    else:
        err = lib.cld_rigid_min_fused(*args, qb, pc, native.stream_ptr(dev))
    native.check(err, name)
    native.count_launch(name)
    return dist, idx


def rigid_min(d2_local: torch.Tensor, onroad: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked min and argmin: d2_local [B, P, P] f32, onroad [B, Q, P] bool
    (or uint8, 0 = off-road) -> (dist [B, Q, P] f32, idx [B, Q, P] int32).
    Any B and Q; on CUDA P up to `RIGID_MAX_P`. There blocks run over
    (agent, chunk of steps, chunk of columns), the steps from
    `rigid_min_steps_per_block` cut to `rigid_min_tiling`'s qb, the columns
    its pc, and a thread walks 4 columns for a tile of 2 steps."""
    return _rigid_min_launch("rigid_min", d2_local, onroad)


def rigid_min_fused(d2_local: torch.Tensor, onroad: torch.Tensor):
    """The same function as `rigid_min`, bit for bit. On CUDA, one block per
    (agent, chunk of columns) loads its columns of the cache once and sweeps
    the whole horizon, a thread walking 4 columns for a tile of 2 steps."""
    return _rigid_min_launch("rigid_min_fused", d2_local, onroad)


def rigid_min_attributes(name: str, tiled: bool = False) -> dict:
    """The compiler's verdict on the forward kernel of `name` ("rigid_min" or
    "rigid_min_fused"), untiled or `tiled` (over chunks of columns):
    registers and local memory bytes (spills) per thread, max threads per
    block."""
    if name not in ("rigid_min", "rigid_min_fused"):
        raise ValueError(f"rigid_min_attributes: unknown kernel {name!r}")
    regs, local, threads = native.attributes(native.library().cld_rigid_min_attributes,
                                             int(name == "rigid_min_fused"), int(tiled))
    return dict(registers=regs, local_bytes=local, max_threads=threads)


def rigid_bwd_ref(pts, idx, dist, g) -> torch.Tensor:
    """Plain version: pts [B, Q, P, 2], idx [B, Q, P] int, dist / g
    [B, Q, P] -> grad [B, Q, P, 2]."""
    P = pts.shape[-2]
    a = g / dist
    rows = torch.arange(P, device=pts.device)[:, None]
    onehot = (idx[..., None, :] == rows).to(pts.dtype)  # [B, Q, P(i), P(j)]
    s_a = torch.einsum("...ij,...j->...i", onehot, a)
    s_ap = torch.einsum("...ij,...jc->...ic", onehot, a[..., None] * pts)
    return pts * s_a[..., None] - s_ap


def rigid_bwd_attributes(P: int) -> dict:
    """The compiler's verdict on the backward kernel for P columns (the
    instantiation that holds them in registers up to P = 224, the loop
    kernel above): registers and local memory bytes (spills) per thread, max
    threads per block."""
    regs, local, threads = native.attributes(native.library().cld_rigid_bwd_attributes, P)
    return dict(registers=regs, local_bytes=local, max_threads=threads)


def rigid_bwd(pts, idx, dist, g) -> torch.Tensor:
    """Argmin-routed backward of the rigid min distance: pts [B, Q, P, 2]
    f32, idx [B, Q, P] int32 and dist [B, Q, P] f32 (the forward's outputs),
    g [B, Q, P] f32 (the cotangent of dist; zero wherever dist is the
    self-match of an on-road column) -> grad [B, Q, P, 2] f32. On CUDA (P up
    to `RIGID_MAX_P`) one warp per (b, q) groups its columns by row and sums
    each row's in ascending column order: repeated launches agree bit for
    bit."""
    dev = pts.device
    if dev.type == "cpu":
        return rigid_bwd_ref(pts, idx, dist, g)
    if dev.type != "cuda":
        raise ValueError(f"rigid_bwd: unsupported device {dev}")
    B, Q, P, _ = pts.shape
    check_points(P)
    native.require(pts, "pts", torch.float32, (B, Q, P, 2), dev)
    if pts.data_ptr() % 8:
        raise ValueError("pts: the kernel reads (x, y) as 8-byte pairs; the storage must be "
                         "8-byte aligned")
    native.require(idx, "idx", torch.int32, (B, Q, P), dev)
    native.require(dist, "dist", torch.float32, (B, Q, P), dev)
    native.require(g, "g", torch.float32, (B, Q, P), dev)
    grad = torch.empty((B, Q, P, 2), dtype=torch.float32, device=dev)
    native.check(native.library().cld_rigid_bwd(
        pts.data_ptr(), idx.data_ptr(), dist.data_ptr(), g.data_ptr(), grad.data_ptr(),
        B * Q, P, native.stream_ptr(dev),
    ), "rigid_bwd")
    native.count_launch("rigid_bwd")
    return grad
