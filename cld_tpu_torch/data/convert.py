"""Offline dataset converter (port of `cld_tpu/data/convert.py`):
trajdata / nuScenes -> packed shards.

The parse of trajdata batches runs once, offline, and freezes the canonical
TrafficBatch fields into packed shards (`cld_tpu_torch.data.packed`), so no
trajdata and no worker processes sit in the training loop. The shards are
byte-compatible with the JAX package's.

`--nuscenes` needs `trajdata` and the nuScenes dataset; the import is
lazy, so the rest of the package works without them. `--synthetic` packs
procedurally generated scenes (`data.synthetic.synthetic_batch`) and runs
anywhere:

    python -m cld_tpu_torch.data.convert --synthetic --out data/synthetic_shards \
        --num-batches 64 --batch-size 32
    python -m cld_tpu_torch.data.convert --nusc-data-dir /path/nuscenes \
        --source nusc_trainval-train --out data/nusc_shards [--device cpu]

The history channels of converted nuScenes batches are painted on
`--device` (the card by default); the synthetic scenes are made on the host.
"""

from __future__ import annotations

import argparse
import zlib

import numpy as np
import torch

from cld_tpu_torch.data.packed import write_batches
from cld_tpu_torch.data.synthetic import synthetic_batch
from cld_tpu_torch.ops.geometry import raster_from_agent_matrix
from cld_tpu_torch.ops.raster import rasterize_history


def convert_synthetic(out: str, num_batches: int, batch_size: int, raster_size: int,
                      seed: int) -> None:
    """Pack `num_batches` synthetic batches (seeds `seed`, `seed + 1`, ...)
    of `batch_size` samples at `raster_size` into `out`: the same files as
    the JAX package's `convert_synthetic`."""
    batches = [
        synthetic_batch(seed=seed + i, batch_size=batch_size, raster_size=raster_size,
                        device="cpu")
        for i in range(num_batches)
    ]
    write_batches(out, batches)
    print(f"packed {num_batches * batch_size} synthetic samples -> {out}")


def _state_to_pos_yaw_speed(state):
    """trajdata StateTensor -> (pos, yaw, speed, mask) numpy arrays with
    NaN->0 and validity masks (`trajdata_utils.py` trajdata2posyawspeed)."""
    pos = state.position.numpy() if hasattr(state, "position") else np.asarray(state[..., :2])
    heading = state.heading.numpy() if hasattr(state, "heading") else np.asarray(state[..., -1:])
    if hasattr(state, "velocity"):
        vel = state.velocity.numpy()
        speed = np.linalg.norm(vel, axis=-1)
    else:
        speed = np.zeros(pos.shape[:-1], np.float32)
    mask = np.isfinite(pos).all(-1).astype(np.float32)
    return (
        np.nan_to_num(pos).astype(np.float32),
        np.nan_to_num(heading).astype(np.float32),
        np.nan_to_num(speed).astype(np.float32),
        mask,
    )


def _closest_lane_point_extra(
    S_seg: int = 15,
    S_point: int = 80,
    map_max_dist: float = 80.0,
    max_heading_error: float = 0.25 * np.pi,
    ahead_threshold: float = -40.0,
    dist_weight: float = 1.0,
    heading_weight: float = 0.1,
):
    """trajdata `extras` hook producing [S_seg, S_point, 3] (x, y, yaw)
    agent-frame closest-lane points, NaN-padded, as the reference's
    `get_closest_lane_point_wrapper` (`src/tbsim/utils/trajdata_utils.py:
    882-1019`) with its default parameters. Runs only where trajdata is."""

    def fn(element):
        vec_map = element.vec_map
        a_from_w = np.asarray(element.agent_from_world_tf)
        w_from_a = np.linalg.inv(a_from_w)
        yaw_w = np.arctan2(w_from_a[1, 0], w_from_a[0, 0])
        pos_w = w_from_a[:2, 2]
        point_xyzh = np.array([pos_w[0], pos_w[1], 0.0, yaw_w])
        lanes = vec_map.get_current_lane(
            point_xyzh, max_dist=map_max_dist, max_heading_error=max_heading_error
        )[:S_seg]
        out = np.full((S_seg, S_point, 3), np.nan, np.float32)
        for i, lane in enumerate(lanes):
            pts = np.asarray(lane.center.points)  # [P, 4+] (x, y, z, h)
            xyh_w = pts[:, [0, 1, 3]]
            dh = xyh_w[:, 2] - yaw_w
            dh = np.abs(np.arctan2(np.sin(dh), np.cos(dh)))  # wrap across +-pi
            score = dist_weight * np.linalg.norm(
                xyh_w[:, :2] - pos_w, axis=-1
            ) + heading_weight * dh
            order = np.argsort(score)
            xy_a = xyh_w[order, :2] @ a_from_w[:2, :2].T + a_from_w[:2, 2]
            h_a = xyh_w[order, 2] + np.arctan2(a_from_w[1, 0], a_from_w[0, 0])
            keep = xy_a[:, 0] > ahead_threshold
            xy_a, h_a = xy_a[keep][:S_point], h_a[keep][:S_point]
            out[i, : len(xy_a), :2] = xy_a
            out[i, : len(xy_a), 2] = h_a
        return torch.as_tensor(out)

    return fn


def parse_raw_batch(
    raw: dict,
    raster_size: int = 224,
    pixel_size: float = 0.5,
    future_frames: int = 52,
    no_map_fill_value: float = -1.0,
    device="cuda",
) -> dict:
    """One collated trajdata batch dict -> canonical per-field numpy dict.

    Field by field the JAX package's `parse_raw_batch`: history / future
    pos-yaw-speed-mask extraction with NaN -> 0, extent NaN masking and max
    over history, the raster_from_agent matrix of record, painted history
    channels before the semantic map stack, and the layer-0 drivable map
    where a sample whose map is entirely `no_map_fill_value` counts as fully
    drivable (the reference's invalid-map convention). The history channels
    are painted on `device`; the fields come back as host numpy arrays.
    """
    hist_pos, hist_yaw, hist_speed, hist_mask = _state_to_pos_yaw_speed(raw["agent_hist"])
    fut_pos, fut_yaw, _, fut_mask = _state_to_pos_yaw_speed(raw["agent_fut"])
    n_hist_pos, n_hist_yaw, _, n_hist_mask = _state_to_pos_yaw_speed(raw["neigh_hist"])
    n_fut_pos, n_fut_yaw, _, n_fut_mask = _state_to_pos_yaw_speed(raw["neigh_fut"])
    B = hist_pos.shape[0]

    maps_raw = np.asarray(raw["maps"].numpy())  # [B, C, H, W]
    # the reference treats a sample whose map is entirely the no-map fill
    # value as FULLY drivable (metrics should not fire off-map)
    invalid_map = np.isclose(maps_raw, no_map_fill_value).reshape(B, -1).all(axis=1)
    maps = np.nan_to_num(maps_raw).astype(np.float32)
    rfa = raster_from_agent_matrix(raster_size, pixel_size, (-0.5, 0.0))
    on = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    hist_img = rasterize_history(
        on(hist_pos), on(hist_mask), on(n_hist_pos), on(n_hist_mask),
        on(np.broadcast_to(rfa, (B, 3, 3))), raster_size,
    ).cpu().numpy()  # [B, Th, H, W]
    image = np.concatenate([hist_img, maps], axis=1).transpose(0, 2, 3, 1)  # NHWC
    drivable = (maps[:, 0] > 0).astype(np.float32)  # nusc drivable layer 0
    drivable[invalid_map] = 1.0

    extent = np.nan_to_num(raw["agent_hist_extent"].numpy()).max(axis=-2)
    a_from_w = np.nan_to_num(raw["agents_from_world_tf"].numpy()).astype(np.float32)

    fields = {
        "image": image,
        "drivable_map": drivable,
        "raster_from_agent": np.broadcast_to(rfa, (B, 3, 3)),
        "history_positions": hist_pos,
        "history_yaws": hist_yaw,
        "history_availabilities": hist_mask,
        "curr_speed": hist_speed[:, -1],
        "target_positions": fut_pos[:, :future_frames],
        "target_yaws": fut_yaw[:, :future_frames],
        "target_availabilities": fut_mask[:, :future_frames],
        "extent": extent,
        "all_other_agents_future_positions": n_fut_pos[:, :, :future_frames],
        "all_other_agents_future_availability": n_fut_mask[:, :, :future_frames],
        "all_other_agents_history_positions": n_hist_pos,
        "all_other_agents_history_yaws": n_hist_yaw,
        "all_other_agents_history_availability": n_hist_mask,
        "world_from_agent": np.linalg.inv(a_from_w),
    }

    # lane extras: [B, S_seg, S_point, 3] NaN-padded -> dense + mask
    extras = raw.get("extras", {})
    if "closest_lane_point" in extras:
        clp = np.asarray(extras["closest_lane_point"].numpy(), np.float32)
        clp = clp.reshape(B, -1, 3)
        fields["lane_avail"] = np.isfinite(clp).all(-1)
        fields["lane_points"] = np.nan_to_num(clp)
    return fields


def convert_nuscenes(
    out: str,
    data_dir: str,
    source: str = "nusc_trainval-train",
    batch_size: int = 32,
    raster_size: int = 224,
    pixel_size: float = 0.5,
    history_frames: int = 30,
    future_frames: int = 52,
    max_neighbor_num: int = 5,
    max_samples: int = 100_000,
    cache_location: str = "~/.unified_data_cache",
    device="cuda",
):
    """Offline trajdata pass producing packed shards of the canonical batch
    fields, as the JAX package's `convert_nuscenes` builds them (the
    reference's dataset construction, `configs/datamodules.py:24-66`, and
    batch parse, `src/tbsim/utils/trajdata_utils.py:346-475`): agent-centric,
    standardized frames, raster maps with painted history channels, neighbor
    futures, vehicle-only, ego_only, 5 neighbors. `parse_raw_batch` paints
    the history channels on `device`.

    Needs trajdata and the nuScenes dataset, and raises SystemExit without
    trajdata (`--synthetic` is the tested path). Check the first converted
    shard with `cld_tpu_torch.data.validation.check_batch_consistency`.
    """
    try:
        from collections import defaultdict

        from torch.utils.data import DataLoader
        from trajdata import AgentType, UnifiedDataset
    except ImportError as e:
        raise SystemExit(
            "trajdata is not installed in this environment; run the converter "
            "where trajdata + nuScenes are available, or use --synthetic."
        ) from e

    from cld_tpu_torch.data.packed import write_packed

    dt = 0.1
    dataset = UnifiedDataset(
        cache_location=cache_location,
        desired_data=[source],
        desired_dt=dt,
        future_sec=(future_frames * dt, future_frames * dt),
        history_sec=(history_frames * dt, history_frames * dt),
        data_dirs={source.split("-")[0]: data_dir},
        only_types=[AgentType.VEHICLE],
        only_predict=[AgentType.VEHICLE],
        agent_interaction_distances=defaultdict(lambda: 50),
        incl_raster_map=True,
        raster_map_params={
            "px_per_m": int(1 / pixel_size),
            "map_size_px": raster_size,
            "return_rgb": False,
            "offset_frac_xy": (-0.5, 0.0),
            "no_map_fill_value": -1.0,
        },
        incl_vector_map=True,
        centric="agent",
        standardize_data=True,
        ego_only=True,
        max_neighbor_num=max_neighbor_num,
        verbose=True,
        num_workers=0,
        # lane extras consumed by the lane_following guidance + the
        # closed-loop lane context (datamodules.py:53-56)
        extras={"closest_lane_point": _closest_lane_point_extra()},
    )
    loader = DataLoader(
        dataset, batch_size=batch_size, shuffle=False,
        collate_fn=dataset.get_collate_fn(return_dict=True),
    )

    fields: dict = {}
    n = 0
    for raw in loader:
        parsed = parse_raw_batch(
            raw, raster_size=raster_size, pixel_size=pixel_size,
            future_frames=future_frames, device=device,
        )
        B = parsed["history_positions"].shape[0]
        for name, arr in parsed.items():
            dtype = np.bool_ if name == "lane_avail" else np.float32
            fields.setdefault(name, []).append(np.asarray(arr, dtype))

        # scene metadata so converted samples can seed the closed-loop
        # simulator (sim.scene.scene_pack_from_batches mirrors
        # env_trajdata.py:154-231 reset-from-dataset). trajdata's AgentBatch
        # carries per-sample scene ids + timestamps.
        scene_ids = raw["scene_ids"]
        # stable digest, NOT Python's salted str hash: shards must assign
        # the same scene_index to the same scene across runs/processes so
        # converted splits can be grouped/joined reproducibly
        fields.setdefault("scene_index", []).append(
            np.asarray(
                [zlib.crc32(str(s).encode()) % (2**31) for s in scene_ids],
                np.int64,
            )
        )
        fields.setdefault("scene_ts", []).append(
            np.asarray(raw["scene_ts"].numpy(), np.int64)
        )

        n += B
        if n >= max_samples:
            break

    write_packed(out, {k: np.concatenate(v, axis=0) for k, v in fields.items()})
    print(f"packed {n} nuScenes samples -> {out}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="cld_tpu_torch offline dataset converter")
    p.add_argument("--out", required=True)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--num-batches", type=int, default=16)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--raster-size", type=int, default=224)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--nusc-data-dir", type=str, default=None)
    p.add_argument("--source", type=str, default="nusc_trainval-train")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the history channels of nuScenes batches are painted")
    args = p.parse_args(argv)

    if args.synthetic:
        convert_synthetic(args.out, args.num_batches, args.batch_size, args.raster_size, args.seed)
    else:
        convert_nuscenes(args.out, args.nusc_data_dir, args.source, args.batch_size,
                         raster_size=args.raster_size, device=args.device)


if __name__ == "__main__":
    main()
