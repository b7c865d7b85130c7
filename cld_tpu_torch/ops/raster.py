"""Rasterization for the closed loop: agent-view map warping and history
painting (port of `cld_tpu/ops/raster.py`).

* `warp_to_agent_frame`: nearest-neighbor affine resampling of a world-frame
  semantic raster into each agent's egocentric viewport;
* `warp_scene_maps`: the same for a batch of agents across scenes, either
  exactly (`impl="exact"`) or banded (`impl="banded"`): the viewport is cut
  into horizontal bands, each band's world footprint is copied into a
  [WIN, WIN] int8 window of the 8-bit quantized map, and the window bytes are
  fetched by `ops.gather_kernels.value_gather` (a CUDA kernel on the card);
* `rasterize_history`: paint (ego +1 / others -1) agent-history channels,
  with the index-0 / index-max invalid-pixel correction.

All index math (rounding included) stays in torch, in helpers both warps
read, so the kernel only ever sees pre-clamped integers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cld_tpu_torch.ops.gather_kernels import value_gather
from cld_tpu_torch.ops.geometry import transform_points


def quantize_world_maps_q8(world_maps: torch.Tensor) -> torch.Tensor:
    """World maps in [0, 1] -> int8 bytes for the banded warp's window
    gather (exact for {0, k/255} mask layers, <= 1/510 off otherwise). Bytes
    >= 128 wrap to negative explicitly, through int32: a float -> int8
    conversion out of range is not defined alike on every device."""
    qw = torch.round(torch.clamp(world_maps, 0.0, 1.0) * 255.0).to(torch.int32)
    return torch.where(qw >= 128, qw - 256, qw).to(torch.int8)


def _ego_center_px(raster_size: int, ego_center: Tuple[float, float]):
    """Ego pixel position ((1 + e) / 2) * size: the one place the convention
    of `raster_from_agent_matrix` is written for the viewport query math and
    the banded warp's window centroids."""
    return (
        (1.0 + ego_center[0]) / 2.0 * raster_size,
        (1.0 + ego_center[1]) / 2.0 * raster_size,
    )


def _viewport_world_pixels(
    world_from_agent: torch.Tensor,
    origins: torch.Tensor,
    world_map_resolution: float,
    map_hw: Tuple[int, int],
    raster_size: int,
    pixel_size: float,
    ego_center: Tuple[float, float],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """World-map pixel queries for every viewport pixel of every agent: the
    single source of the viewport index math for both warps.

    world_from_agent [B, 3, 3], origins [B, 2] (world coords of each agent's
    map pixel (0, 0)) -> (ix, iy, valid), each [B, H*W] in raster row-major
    order; ix / iy are unclamped int32, consumers must clip."""
    H = W = raster_size
    dev = world_from_agent.device
    cx, cy = _ego_center_px(raster_size, ego_center)
    xs = (torch.arange(W, dtype=torch.float32, device=dev) - cx) * pixel_size
    ys = (torch.arange(H, dtype=torch.float32, device=dev) - cy) * pixel_size
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")  # [H, W] agent-frame meters
    pts = torch.stack([gx, gy], dim=-1).reshape(1, -1, 2)

    B = world_from_agent.shape[0]
    world_pts = transform_points(pts.expand(B, H * W, 2), world_from_agent)
    wp = (world_pts - origins[:, None]) / world_map_resolution  # world pixels
    ix = torch.round(wp[..., 0]).to(torch.int32)
    iy = torch.round(wp[..., 1]).to(torch.int32)
    Hw, Ww = map_hw
    valid = (ix >= 0) & (ix < Ww) & (iy >= 0) & (iy < Hw)
    return ix, iy, valid


def warp_to_agent_frame(
    world_map: torch.Tensor,
    world_from_agent: torch.Tensor,
    world_map_resolution: float,
    world_map_origin: torch.Tensor,
    raster_size: int = 224,
    pixel_size: float = 0.5,
    ego_center: Tuple[float, float] = (-0.5, 0.0),
    fill_value: float = 0.0,
) -> torch.Tensor:
    """Sample each agent's egocentric raster from one world-frame map.

    world_map [Hw, Ww, C], world_from_agent [B, 3, 3], world_map_origin [2]
    (world coords of map pixel (0, 0)) -> [B, raster_size, raster_size, C]."""
    B = world_from_agent.shape[0]
    origins = torch.as_tensor(world_map_origin, device=world_map.device).expand(B, 2)
    return _warp_exact(
        world_map[None], torch.zeros((B,), dtype=torch.long, device=world_map.device),
        world_from_agent, origins, world_map_resolution, raster_size, pixel_size,
        ego_center, fill_value,
    )


def _warp_exact(world_maps, scene_index, world_from_agent, origins, res, raster_size,
                pixel_size, ego_center, fill_value):
    """Exact warp: one indexed read of world_maps [Ns, Hw, Ww, C] per
    viewport pixel of every agent."""
    H = W = raster_size
    B = world_from_agent.shape[0]
    Hw, Ww = world_maps.shape[1:3]
    ix, iy, valid = _viewport_world_pixels(
        world_from_agent, origins, res, (Hw, Ww), raster_size, pixel_size, ego_center
    )
    vals = world_maps[
        scene_index.long()[:, None], iy.clamp(0, Hw - 1).long(), ix.clamp(0, Ww - 1).long()
    ]  # [B, H*W, C]
    vals = torch.where(valid[..., None], vals, torch.full_like(vals, fill_value))
    return vals.reshape(B, H, W, -1)


def _pick_band(raster_size: int, scale_px: float) -> Tuple[int, int]:
    """Band height and window size of the banded warp. The viewport is cut
    into NB horizontal bands; each band's rotated world footprint fits a
    [WIN, WIN] window for any yaw (worst case: the band rectangle's
    diagonal). WIN is a multiple of 128, as in the JAX package, so both
    packages cut the same windows; the band height minimizing WIN wins
    (ties -> fewer, taller bands)."""
    H = raster_size
    best = None
    for nb in (1, 2, 4, 7, 8, 14, 16):
        if H % nb:
            continue
        bh = H // nb
        span = (H * H + bh * bh) ** 0.5 * scale_px + 4.0
        win = int(-(-span // 128) * 128)
        if best is None or win < best[1]:
            best = (bh, win)
    return best


def warp_scene_maps(
    world_maps: torch.Tensor,
    map_origin: torch.Tensor,
    world_map_resolution: float,
    world_from_agent: torch.Tensor,
    scene_index: torch.Tensor,
    raster_size: int = 224,
    pixel_size: float = 0.5,
    ego_center: Tuple[float, float] = (-0.5, 0.0),
    fill_value: float = 0.0,
    impl: str = "auto",
    world_maps_q8: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Egocentric semantic rasters for a batch of agents across scenes.

    world_maps [Ns, Hw, Ww, C] (values in [0, 1]), map_origin [Ns, 2],
    world_from_agent [Na, 3, 3], scene_index [Na] -> [Na, H, W, C].

    `impl="exact"` reads the float maps directly (the JAX package's "jnp").
    `"banded"` (its "pallas") quantizes the maps to 8 bits (exact for
    {0, k/255} mask layers, <= 1/510 off otherwise; pass `world_maps_q8`
    from `quantize_world_maps_q8` to do it once outside a loop), copies one
    [WIN, WIN] window per (agent, band) and fetches the bytes with
    `value_gather`. `"auto"` is banded on a CUDA tensor when the window
    fits the map, exact otherwise; an explicit `"banded"` raises when the
    window does not fit."""
    if impl not in ("auto", "exact", "banded"):
        raise ValueError(f"unknown warp impl {impl!r} (expected auto|exact|banded)")
    Ns, Hw, Ww, C = world_maps.shape
    Na = world_from_agent.shape[0]
    H = W = raster_size
    res = world_map_resolution
    dev = world_from_agent.device
    origins = map_origin[scene_index.long()]  # [Na, 2]

    bh_win = _pick_band(raster_size, pixel_size / res)
    fits = min(Hw, Ww) >= bh_win[1]
    if impl == "banded" and not fits:
        raise ValueError(
            f"impl='banded' needs a world map of at least {bh_win[1]} px a "
            f"side for raster {raster_size} at {pixel_size / res:g} map px per raster px; got "
            f"{Hw}x{Ww}. Use impl='auto' to take the exact warp on small maps."
        )
    banded = fits and (impl == "banded" or (impl == "auto" and dev.type == "cuda"))
    if not banded:
        return _warp_exact(world_maps, scene_index, world_from_agent, origins, res,
                           raster_size, pixel_size, ego_center, fill_value)

    BH, WIN = bh_win
    NB = H // BH
    M = Na * NB
    ix, iy, valid = _viewport_world_pixels(
        world_from_agent, origins, res, (Hw, Ww), raster_size, pixel_size, ego_center
    )  # [Na, H*W] each
    cx, cy = _ego_center_px(raster_size, ego_center)

    # per-(agent, band) windows around the band's world centroid
    band_cy = (torch.arange(NB, dtype=torch.float32, device=dev) + 0.5) * BH
    ctr_a = torch.stack(
        [torch.full((NB,), (W / 2.0 - cx) * pixel_size, device=dev),
         (band_cy - cy) * pixel_size], dim=-1,
    )  # [NB, 2] agent frame
    ctr_w = transform_points(ctr_a[None].expand(Na, NB, 2), world_from_agent)
    ctr_px = torch.round((ctr_w - origins[:, None]) / res).to(torch.int32)
    ox = torch.clamp(ctr_px[..., 0] - WIN // 2, 0, Ww - WIN).reshape(M)
    oy = torch.clamp(ctr_px[..., 1] - WIN // 2, 0, Hw - WIN).reshape(M)

    q8 = world_maps_q8 if world_maps_q8 is not None else quantize_world_maps_q8(world_maps)
    # window copies by index arithmetic on the device: no offset reaches the host
    scene_m = scene_index.long().repeat_interleave(NB)
    span = torch.arange(WIN, device=dev)
    rows = oy.long()[:, None] + span  # [M, WIN]
    cols = ox.long()[:, None] + span
    wins = q8[scene_m[:, None, None], rows[:, :, None], cols[:, None, :]].contiguous()

    # window-local queries (bands are contiguous row blocks of the raster)
    Qb = BH * W
    lx = torch.clamp(ix.reshape(M, Qb) - ox[:, None], 0, WIN - 1)
    ly = torch.clamp(iy.reshape(M, Qb) - oy[:, None], 0, WIN - 1)
    raw = value_gather(torch.stack([lx, ly], dim=-1).contiguous(), wins)  # [M, Qb, C]
    vals = torch.where(raw < 0, raw + 256.0, raw) * (1.0 / 255.0)
    ok = valid.reshape(M, Qb)[..., None]
    if fill_value != 0.0:
        vals = torch.where(ok, vals, torch.full_like(vals, fill_value))
    else:
        vals = vals * ok
    return vals.reshape(Na, H, W, C)


def rasterize_history(
    ego_hist: torch.Tensor,
    ego_avail: torch.Tensor,
    neighbor_hist: torch.Tensor,
    neighbor_avail: torch.Tensor,
    raster_from_agent: torch.Tensor,
    raster_size: int = 224,
) -> torch.Tensor:
    """Paint agent-history channels.

    ego_hist [B, Th, 2] agent-frame positions, ego_avail [B, Th],
    neighbor_hist [B, S, Th, 2], neighbor_avail [B, S, Th],
    raster_from_agent [B, 3, 3] -> [B, Th, H, W]: ego +1, others -1 (ego
    painted last, wins). Invalid positions scatter to flat pixel 0, which
    is zeroed afterwards together with the last pixel (out-of-view clamps).
    Within one paint every write carries the same value, so duplicate
    targets are deterministic."""
    B, Th, _ = ego_hist.shape
    S = neighbor_hist.shape[1]
    H = W = raster_size
    dev = ego_hist.device

    all_pos = torch.cat([neighbor_hist, ego_hist[:, None]], dim=1)  # [B, S+1, Th, 2]
    all_avail = torch.cat([neighbor_avail, ego_avail[:, None]], dim=1) > 0

    pix = transform_points(all_pos.reshape(B, -1, 2), raster_from_agent).reshape(B, S + 1, Th, 2)
    px = torch.clamp(torch.round(pix[..., 0]), 0, W - 1).long()
    py = torch.clamp(torch.round(pix[..., 1]), 0, H - 1).long()
    flat_idx = torch.where(all_avail, py * W + px, torch.zeros_like(px))  # [B, S+1, Th]

    img = torch.zeros((B, Th, H * W), dtype=torch.float32, device=dev)
    b = torch.arange(B, device=dev)[:, None, None]
    t = torch.arange(Th, device=dev)[None, None, :]
    # neighbors first (-1), then ego (+1) so ego overwrites
    img[b, t, flat_idx[:, :S]] = -1.0
    img[b, t, flat_idx[:, S:]] = 1.0
    img[:, :, 0] = 0.0
    img[:, :, -1] = 0.0
    return img.reshape(B, Th, H, W)
