"""Reward reductions: the off-road count and the disk-collision penalty as
CUDA kernels, with their plain versions.

Counterpart of `offroad_count_pallas` and `disk_collision_penalty_pallas` in
`cld_tpu/ops/pallas_kernels.py` (and of their `*_ref` oracles there).

Off-road count (`offroad_count`): per group of trajectory points, how many
land on a map value <= 0. `algos.reward.offroad_reward` is its negative, so
every PPO collection step and every `compute_reward` goes through it.

Disk-collision penalty (`disk_collision_penalty`): the inner pipeline of the
agent-collision rule on fixed trajectories, per agent the decayed penalty
1 - d / penalty_dist over the steps where its closest pair of disks comes
within penalty_dist of another agent's, averaged over all agents. It has no
gradient, here as in the JAX package, so it scores trajectories (the PPO
collection's, for example) and does not sit inside a differentiated loss.

Both wrappers dispatch by device: CUDA tensors launch the kernel
(`csrc/offroad_count.cu`, `csrc/disk_collision.cu`) or raise, CPU tensors
take the `_ref` plain version beside it.
"""

from __future__ import annotations

import torch

from cld_tpu_torch.ops import native

_MAX_SMEM = 48 * 1024  # static limit of a block's dynamic shared memory


def offroad_count_ref(pix: torch.Tensor, drivable: torch.Tensor) -> torch.Tensor:
    """Plain version: pix [B, P, 2] or [B, G, P, 2] int32 (col, row),
    drivable [B, H, W] -> [B] or [B, G] f32 counts of points whose map value
    is <= 0. Coordinates clamp to the map, as in the kernel."""
    Hm, W = drivable.shape[1:]
    col = pix[..., 0].long().clamp(0, W - 1)
    row = pix[..., 1].long().clamp(0, Hm - 1)
    b = torch.arange(pix.shape[0], device=pix.device).reshape((-1,) + (1,) * (pix.ndim - 2))
    return torch.sum(drivable[b, row, col] <= 0, dim=-1).to(torch.float32)


def offroad_count_attributes() -> dict:
    """The compiler's verdict on the off-road kernel: registers and local
    memory bytes (spills) per thread, max threads per block."""
    regs, local, threads = native.attributes(native.library().cld_offroad_count_attributes)
    return dict(registers=regs, local_bytes=local, max_threads=threads)


def offroad_count(pix: torch.Tensor, drivable: torch.Tensor) -> torch.Tensor:
    """Off-road points per group: pix [B, P, 2] int32 (col, row) with a
    float32 map drivable [B, H, W] -> [B] f32; or pix [B, G, P, 2], G groups
    of points per map -> [B, G]. The counts are integers stored as f32."""
    if pix.device.type == "cpu":
        return offroad_count_ref(pix, drivable)
    if pix.device.type != "cuda":
        raise ValueError(f"offroad_count: unsupported device {pix.device}")
    if pix.ndim not in (3, 4):
        raise ValueError(f"pix: shape {tuple(pix.shape)}, expected [B, P, 2] or [B, G, P, 2]")
    B, P = pix.shape[0], pix.shape[-2]
    G = pix.shape[1] if pix.ndim == 4 else 1
    Hm, W = drivable.shape[1:]
    native.require(pix, "pix", torch.int32, (*pix.shape[:-1], 2), pix.device)
    if pix.data_ptr() % 8:
        raise ValueError("pix: the kernel reads (col, row) as 8-byte pairs; "
                         "the storage must be 8-byte aligned")
    native.require(drivable, "drivable", torch.float32, (B, Hm, W), pix.device)
    out = torch.empty(pix.shape[:-2], dtype=torch.float32, device=pix.device)
    lib = native.library()
    native.check(lib.cld_offroad_count(
        pix.data_ptr(), drivable.data_ptr(), out.data_ptr(), B, G, P, Hm, W,
        native.stream_ptr(pix.device),
    ), "offroad_count")
    native.count_launch("offroad_count")
    return out


def disk_collision_penalty_ref(centroids, penalty_dists, pair_mask, decay) -> torch.Tensor:
    """Plain version: centroids [T, B, D, 2] world disk centres,
    penalty_dists [B, B], pair_mask [B, B] bool, decay [T] -> per-agent
    penalty [B]: summed over the decayed steps, averaged over all B
    columns."""
    T, B = centroids.shape[:2]
    diff = centroids[:, :, None, :, None, :] - centroids[:, None, :, None, :, :]
    dist = torch.sqrt(torch.sum(diff**2, dim=-1) + 1e-12)  # [T, B, B, D, D]
    pair = torch.amin(dist.reshape(T, B, B, -1), dim=-1)
    colliding = (pair <= penalty_dists[None]) & pair_mask[None]
    pen = torch.where(colliding, 1.0 - pair / penalty_dists[None], torch.zeros_like(pair))
    return torch.mean(torch.sum(pen * decay[:, None, None], dim=0), dim=-1)


def disk_collision_penalty(centroids, penalty_dists, pair_mask, decay, *,
                           unrolled: bool = True) -> torch.Tensor:
    """Per-agent decayed disk-collision penalty: centroids [T, B, D, 2] f32,
    penalty_dists [B, B] f32, pair_mask [B, B] bool, decay [T] f32 -> [B]
    f32. No gradient. The kernel sums in another order than the plain
    version: they agree to ~1e-6 relative, and two launches bit for bit.
    `unrolled=False` makes the kernel take its runtime-D loop, which D > 8
    always takes, at any D (to time and check that loop)."""
    if centroids.device.type == "cpu":
        return disk_collision_penalty_ref(centroids, penalty_dists, pair_mask, decay)
    if centroids.device.type != "cuda":
        raise ValueError(f"disk_collision_penalty: unsupported device {centroids.device}")
    T, B, D, _ = centroids.shape
    dev, f32 = centroids.device, torch.float32
    native.require(centroids, "centroids", f32, (T, B, D, 2), dev)
    native.require(penalty_dists, "penalty_dists", f32, (B, B), dev)
    native.require(pair_mask, "pair_mask", torch.bool, (B, B), dev)
    native.require(decay, "decay", f32, (T,), dev)
    if T * D * 8 + B * 9 > _MAX_SMEM:  # an agent's disk centres, penalty row, partner list, mask
        raise ValueError(f"disk_collision_penalty: T * D = {T * D} disk centres per agent and "
                         f"B = {B} agents exceed the kernel's {_MAX_SMEM} bytes of shared memory")
    out = torch.empty((B,), dtype=f32, device=dev)
    lib = native.library()
    native.check(lib.cld_disk_collision(
        centroids.data_ptr(), penalty_dists.data_ptr(), pair_mask.data_ptr(), decay.data_ptr(),
        out.data_ptr(), T, B, D, int(unrolled), native.stream_ptr(dev),
    ), "disk_collision")
    native.count_launch("disk_collision")
    return out
