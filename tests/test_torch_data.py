"""The port's data stack against the JAX package, on the CPU: packed shards
(`cld_tpu_torch.data.packed`, its native reader), the loaders
(`data.loader.make_loader`'s packed branch, `data.multihost`), batch
validation, scene batches, the converter (`data.convert`),
`ops.lanes.merge_scene_lanes`, the scene packs built from converted scenes
(`sim.scene.scene_pack_from_batches` / `scene_pack_from_shards`) and the
rollout CLI's `--scene-data` / `--guide-with-gt`.

Shards are written with the JAX package's own writer
(`cld_tpu/data/packed.py:write_batches`), as `tests/test_packed_data.py`
does, at raster 32-64 with a few samples. Tolerances: shards, loaders,
samplers and the converter's files are held bit for bit; float fields
computed on both sides (the parse, the scene pack's replay actions and
ground-truth states) within 1e-5 absolute (f32 arithmetic in two libraries;
states of magnitude < 100 m), integer and boolean fields exactly.
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cld_tpu.data import convert as jconvert
from cld_tpu.data import packed as jpacked
from cld_tpu.data.batch import TrafficBatch as JaxBatch
from cld_tpu.data.loader import make_loader as jax_make_loader
from cld_tpu.data.multihost import HostShardSampler as JaxSampler
from cld_tpu.data.scene_batch import synthetic_scene_batch as jax_scene_batch
from cld_tpu.data.synthetic import synthetic_batch as jax_synthetic
from cld_tpu.data.validation import check_batch_consistency as jax_check
from cld_tpu.guidance.perturbation import choose_closest_to_gt as jax_closest
from cld_tpu.ops.lanes import merge_scene_lanes as jax_merge
from cld_tpu.sim import scene as jscene
from cld_tpu.utils.registry import get_registered_experiment_config as jax_config
from cld_tpu_torch import pipeline, train
from cld_tpu_torch.data import convert, multihost, packed
from cld_tpu_torch.data.batch import TrafficBatch
from cld_tpu_torch.data.loader import make_loader
from cld_tpu_torch.data.scene_batch import synthetic_scene_batch
from cld_tpu_torch.data.synthetic import synthetic_batch
from cld_tpu_torch.data.validation import check_batch_consistency
from cld_tpu_torch.ops.lanes import merge_scene_lanes
from cld_tpu_torch.sim import scene as tscene
from cld_tpu_torch.utils.registry import get_registered_experiment_config

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-5


def _equal_fields(got, want, atol=0.0):
    """Every non-None field of two batches or dicts, exactly (atol 0) or
    within atol; returns how many fields were compared."""
    want = want._asdict() if hasattr(want, "_asdict") else want
    got = got._asdict() if hasattr(got, "_asdict") else got
    n = 0
    for k, w in want.items():
        if w is None or got.get(k) is None:
            continue
        g = got[k]
        g = g.cpu().numpy() if torch.is_tensor(g) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if atol == 0 or w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=k)
        n += 1
    return n


def _jax_batches(n, bs=4, raster=32, **kw):
    return [jax_synthetic(seed=i, batch_size=bs, raster_size=raster, **kw) for i in range(n)]


def _tree_bytes(path):
    return {p.name: p.read_bytes() for p in sorted(Path(path).iterdir())}


def test_shards_load_across_packages_and_the_writers_agree(tmp_path):
    """JAX-written shards read by the port (native reader and memmaps) and
    port-written shards read by the JAX package give the written arrays;
    both writers write the same bytes, meta.json included, for the same
    batches."""
    jb = _jax_batches(2)
    tb = [synthetic_batch(seed=i, batch_size=4, raster_size=32, device="cpu") for i in range(2)]
    jpacked.write_batches(str(tmp_path / "jax"), jb)
    packed.write_batches(str(tmp_path / "port"), tb)
    assert _tree_bytes(tmp_path / "jax") == _tree_bytes(tmp_path / "port")
    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    assert meta["num_samples"] == 8 and "lane_points" in meta["fields"]

    idx = np.array([7, 0, 3, 3, 5])
    want = {k: np.concatenate([np.asarray(getattr(b, k)) for b in jb])[idx]
            for k in meta["fields"]}
    for use_native in (True, False):
        ds = packed.PackedShardDataset(str(tmp_path / "jax"), use_native=use_native)
        assert ds.uses_native == use_native
        got = ds.gather(idx)
        assert _equal_fields(got, want) == len(meta["fields"])
        ds.close()
    jds = jpacked.PackedShardDataset(str(tmp_path / "port"), use_native=False)
    assert _equal_fields(jds.gather(idx), want) == len(meta["fields"])

    fields = {"a": np.arange(24, dtype=np.float64).reshape(6, 4), "b": np.arange(6, dtype=np.int32)}
    jpacked.write_packed(str(tmp_path / "jf"), fields)
    packed.write_packed(str(tmp_path / "pf"), fields)
    assert _tree_bytes(tmp_path / "jf") == _tree_bytes(tmp_path / "pf")


def test_native_reader_and_numpy_reader_agree(tmp_path):
    rng = np.random.default_rng(0)
    fields = {"a": rng.normal(size=(20, 4, 3)).astype(np.float32),
              "b": rng.integers(0, 100, (20, 7)).astype(np.int32),
              "c": rng.normal(size=(20,)).astype(np.float64),
              "d": rng.random((20, 5)) > 0.5}
    jpacked.write_packed(str(tmp_path), fields)
    nat = packed.PackedShardDataset(str(tmp_path), num_threads=3)
    mm = packed.PackedShardDataset(str(tmp_path), use_native=False)
    idx = np.array([3, 3, 19, 0, 7, 11, 2], np.int64)
    out_n, out_m = nat.gather(idx), mm.gather(idx)
    for k in fields:
        assert out_n[k].dtype == fields[k].dtype
        np.testing.assert_array_equal(out_n[k], out_m[k])
        np.testing.assert_array_equal(out_n[k], fields[k][idx])
    with pytest.raises(IndexError):
        nat.gather(np.array([25]))
    nat.close()


def test_use_native_raises_when_the_build_fails(tmp_path, monkeypatch):
    """No silent fallback: a missing compiler or a failed compile raises
    and names the compiler; an unreadable field raises OSError."""
    jpacked.write_packed(str(tmp_path / "ds"), {"a": np.zeros((3, 2), np.float32)})
    monkeypatch.setattr(packed, "_NATIVE_LIB", None)
    monkeypatch.setattr(packed, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(packed, "CXX", "no-such-cxx-compiler")
    with pytest.raises(RuntimeError, match="no-such-cxx-compiler"):
        packed.PackedShardDataset(str(tmp_path / "ds"))
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(packed, "CXX", "g++")
    monkeypatch.setattr(packed, "NATIVE_SRC", broken)
    with pytest.raises(RuntimeError, match="'g\\+\\+' failed"):
        packed.PackedShardDataset(str(tmp_path / "ds"))
    assert not list((tmp_path / "build").glob("*.so"))
    mm = packed.PackedShardDataset(str(tmp_path / "ds"), use_native=False)
    assert mm.gather(np.array([1]))["a"].shape == (1, 2)
    monkeypatch.undo()
    (tmp_path / "ds" / "a.bin").unlink()
    with pytest.raises(OSError, match="could not open"):
        packed.PackedShardDataset(str(tmp_path / "ds"))


def test_native_source_is_the_jax_readers_and_its_build_stays_in_the_port(tmp_path):
    """The port's reader is the JAX package's below its header comment; it
    builds into the build directory it is given (by default
    `cld_tpu_torch/_build/`), and the JAX package's tracked library keeps
    its bytes and its mtime."""
    ours = packed.NATIVE_SRC.read_text()
    theirs = (REPO / "cld_tpu" / "native" / "shard_reader.cpp").read_text()
    cut = "#include <atomic>"
    assert ours[ours.index(cut):] == theirs[theirs.index(cut):]
    assert packed.native_library_path().parent == REPO / "cld_tpu_torch" / "_build"
    jax_so = REPO / "cld_tpu" / "native" / "libshard_reader.so"
    before = (jax_so.read_bytes(), jax_so.stat().st_mtime_ns)
    so = packed.build_native(tmp_path)
    assert so.parent == tmp_path and so.exists()
    assert (jax_so.read_bytes(), jax_so.stat().st_mtime_ns) == before


@pytest.mark.parametrize("layout", ["splits", "flat"])
def test_make_loader_yields_the_jax_loaders_batches(tmp_path, layout):
    """The first 3 batches of the train and the validation split, bit for
    bit (seeds 0 and 10,000), from `<path>/<split>` directories or a flat
    dataset; an unknown split of a split dataset lists the splits."""
    batches = _jax_batches(3, bs=4, raster=32)
    if layout == "splits":
        jpacked.write_batches(str(tmp_path / "train"), batches[:2])
        jpacked.write_batches(str(tmp_path / "val"), batches[2:])
    else:
        jpacked.write_batches(str(tmp_path), batches)
    jcfg = jax_config("cld_smoke").unlock()
    cfg = get_registered_experiment_config("cld_smoke").unlock()
    for c in (jcfg, cfg):
        c.train.data_path = str(tmp_path)
        c.train.validation.batch_size = 3
    for split in ("train", "val"):
        want_it = iter(jax_make_loader(jcfg, split))
        got_it = iter(make_loader(cfg, split, device="cpu"))
        for _ in range(3):
            want, got = next(want_it), next(got_it)
            assert isinstance(got, TrafficBatch) and got.image.device.type == "cpu"
            assert _equal_fields(got, want) == 18
    if layout == "splits":
        with pytest.raises(FileNotFoundError, match=r"\['train', 'val'\]"):
            make_loader(cfg, "test", device="cpu")


def test_train_cli_trains_on_the_jax_clis_batches_from_shards(tmp_path):
    """The train CLI's stream on packed shards is the JAX CLI's (one batch
    drawn for init, then step 0's batch), and `--mode vae` / `--mode dm`
    train from the shards through `train.data_path`."""
    jpacked.write_batches(str(tmp_path / "shards" / "train"),
                          _jax_batches(2, bs=4, raster=64, hist_frames=8))
    jcfg = jax_config("cld_smoke").unlock()
    jcfg.train.data_path = str(tmp_path / "shards")
    it = iter(jax_make_loader(jcfg, "train"))
    next(it)
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(json.dumps({"train": {"data_path": str(tmp_path / "shards")}}))
    from cld_tpu_torch.utils.registry import config_from_flags

    cfg = config_from_flags("cld_smoke", str(cfg_file))
    ours = train._batches(cfg, "cpu", 0)
    for _ in range(2):
        assert _equal_fields(next(ours), next(it)) == 18
    base = ["--registered-name", "cld_smoke", "--config", str(cfg_file), "--device", "cpu",
            "--output", str(tmp_path / "runs"), "--steps", "1"]
    vae = train.main(base + ["--mode", "vae"])
    dm = train.main(base + ["--mode", "dm", "--vae-ckpt",
                            str(tmp_path / "runs" / "vae" / "ckpt_final")])
    assert vae.step == 1 and dm.step == 1
    for stage in ("vae", "dm"):
        rec = json.loads((tmp_path / "runs" / stage / "metrics.jsonl").read_text().splitlines()[0])
        assert all(np.isfinite(v) for v in rec.values())


def test_host_shard_sampler_and_the_ranks_local_batches(tmp_path):
    """The same index stream as the JAX sampler, and each rank's local
    batch is its lane of the JAX global batch: together, in rank order, they
    are the global batch."""
    for n, gb, hosts, seed in ((40, 8, 2, 0), (37, 12, 4, 5), (9, 3, 1, 2)):
        for h in range(hosts):
            for epoch in (0, 1):
                np.testing.assert_array_equal(
                    multihost.HostShardSampler(n, gb, h, hosts, seed).epoch_indices(epoch),
                    JaxSampler(n, gb, h, hosts, seed).epoch_indices(epoch))
    with pytest.raises(ValueError):
        multihost.HostShardSampler(10, 6, 0, 4)
    batches = _jax_batches(3, bs=4, raster=32)
    jpacked.write_batches(str(tmp_path / "train"), batches)
    ds = jpacked.PackedShardDataset(str(tmp_path / "train"), use_native=False)
    W, GB = 4, 8
    loaders = [iter(multihost.DistributedPackedLoader(str(tmp_path), global_batch_size=GB,
                                                      seed=3, rank=r, world_size=W,
                                                      device="cpu")) for r in range(W)]
    steps = JaxSampler(12, GB, 0, W, 3).steps_per_epoch
    for step in range(steps + 1):  # into the second epoch
        epoch, s = divmod(step, steps)
        lanes = [JaxSampler(12, GB, r, W, 3).epoch_indices(epoch)[s] for r in range(W)]
        want = ds.gather(np.concatenate(lanes))
        local = [next(it) for it in loaders]
        got = {k: torch.cat([getattr(b, k) for b in local]) for k in want}
        assert _equal_fields(got, want) == 18
    solo = multihost.DistributedPackedLoader(str(tmp_path), global_batch_size=4, device="cpu")
    assert (solo.rank, solo.world_size) == (0, 1)
    # rank and world size default to the process group's
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                                         rank=0, world_size=1)
    try:
        pg = multihost.DistributedPackedLoader(str(tmp_path), global_batch_size=4, device="cpu")
        assert (pg.rank, pg.world_size) == (0, 1)
        assert _equal_fields(next(iter(pg)), ds.gather(JaxSampler(12, 4, 0, 1, 0)
                                                          .epoch_indices(0)[0])) == 18
    finally:
        torch.distributed.destroy_process_group()


def test_check_batch_consistency_gives_the_jax_strings():
    """On the faults of `tests/test_validation_faults.py`: a clean batch, a
    NaN speed, an unstandardized history, a warped future, non-binary
    availabilities."""
    j = jax_synthetic(seed=0, batch_size=2, raster_size=32)
    t = synthetic_batch(seed=0, batch_size=2, raster_size=32, device="cpu")
    cases = [
        (lambda b: b, lambda b: b),
        (lambda b: b._replace(curr_speed=b.curr_speed.at[0].set(jnp.nan)),
         lambda b: b._replace(curr_speed=torch.where(torch.arange(2) == 0, float("nan"),
                                                     b.curr_speed))),
        (lambda b: b._replace(history_positions=b.history_positions + 5.0),
         lambda b: b._replace(history_positions=b.history_positions + 5.0)),
        (lambda b: b._replace(target_positions=b.target_positions * 3.0),
         lambda b: b._replace(target_positions=b.target_positions * 3.0)),
        (lambda b: b._replace(target_availabilities=b.target_availabilities * 0.5),
         lambda b: b._replace(target_availabilities=b.target_availabilities * 0.5)),
    ]
    seen = set()
    for fj, ft in cases:
        want = jax_check(fj(j))
        assert check_batch_consistency(ft(t)) == want
        seen.update(p.split(":")[0] for p in want)
    assert len(seen) >= 4


def _lane_extras():
    """[B, S_seg, S_point, 3] NaN-padded closest-lane points."""
    clp = np.random.default_rng(3).normal(size=(4, 2, 3, 3)).astype(np.float32) * 10
    clp[0, 1] = np.nan
    clp[2, :, 2] = np.nan
    return clp


def _golden_raw():
    """`tests/test_convert_golden.py`'s fixture: trajdata-shaped state rows
    with NaN patterns, extents, a map with a no-map sample, world poses."""
    from test_convert_golden import _DuckState, _fixture_arrays

    f = _fixture_arrays()
    t = lambda a: torch.as_tensor(np.array(a, copy=True))
    return dict(
        agent_hist=_DuckState(f["agent_hist"]), agent_fut=_DuckState(f["agent_fut"]),
        neigh_hist=_DuckState(f["neigh_hist"]), neigh_fut=_DuckState(f["neigh_fut"]),
        agent_hist_extent=t(f["hist_extent"]), agents_from_world_tf=t(f["a_from_w"]),
        maps=t(f["maps"]),
        extras={"closest_lane_point": t(_lane_extras())},
    )


def test_parse_raw_batch_matches_the_jax_parse():
    from test_convert_golden import PX, RASTER, TF

    raw = _golden_raw()
    want = jconvert.parse_raw_batch(raw, raster_size=RASTER, pixel_size=PX, future_frames=TF)
    got = convert.parse_raw_batch(raw, raster_size=RASTER, pixel_size=PX, future_frames=TF,
                                  device="cpu")
    assert sorted(got) == sorted(want) and "lane_points" in got
    assert _equal_fields({k: got[k] for k in ("image", "drivable_map", "lane_avail")},
                         {k: want[k] for k in ("image", "drivable_map", "lane_avail")}) == 3
    assert _equal_fields(got, want, atol=1e-6) == len(want)


def test_convert_cli_writes_the_jax_converters_files(tmp_path, capsys, monkeypatch):
    jconvert.convert_synthetic(str(tmp_path / "jax"), 2, 3, 32, 4)
    convert.main(["--synthetic", "--out", str(tmp_path / "port"), "--num-batches", "2",
                  "--batch-size", "3", "--raster-size", "32", "--seed", "4"])
    assert "packed 6 synthetic samples" in capsys.readouterr().out
    assert _tree_bytes(tmp_path / "jax") == _tree_bytes(tmp_path / "port")
    for conv in (jconvert, convert):
        with pytest.raises(SystemExit, match="trajdata is not installed"):
            conv.convert_nuscenes(str(tmp_path / "n"), str(tmp_path))
    with pytest.raises(SystemExit, match="trajdata is not installed"):
        convert.main(["--out", str(tmp_path / "n"), "--nusc-data-dir", str(tmp_path),
                      "--device", "cpu"])
    devices = []
    monkeypatch.setattr(convert, "convert_nuscenes",
                        lambda *a, device, **kw: devices.append(device))
    convert.main(["--out", str(tmp_path / "n"), "--nusc-data-dir", str(tmp_path)])
    convert.main(["--out", str(tmp_path / "n"), "--nusc-data-dir", str(tmp_path),
                  "--device", "cpu"])
    assert devices == ["cuda", "cpu"]


def test_synthetic_scene_batch_matches_jax():
    want = jax_scene_batch(seed=3, batch_size=2, num_agents=4, hist_frames=5, horizon=12)
    got = synthetic_scene_batch(seed=3, batch_size=2, num_agents=4, hist_frames=5, horizon=12,
                                device="cpu")
    assert _equal_fields(got, want) == len(want._fields)


def test_merge_scene_lanes_matches_jax(capsys):
    """Duplicates dropped on the grid, NaN and unavailable rows skipped, an
    empty scene, and a scene subsampled past max_points."""
    rng = np.random.default_rng(7)
    pts = rng.uniform(-30, 30, (6, 50, 3)).astype(np.float32)
    pts[1, :10] = pts[0, :10] + 0.1  # seen twice: deduped
    pts[2, 5] = np.nan
    avail = rng.random((6, 50)) > 0.2
    scene = np.array([0, 0, 1, 1, 3, 3])
    for mp in (256, 40):
        want = jax_merge(pts, avail, scene, 4, max_points=mp)
        got = merge_scene_lanes(pts, avail, scene, 4, max_points=mp)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert "subsampled" in capsys.readouterr().out


def _rigid(theta, x, y):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, x], [s, c, y], [0, 0, 1]], np.float32)


@pytest.mark.parametrize("poses", ["world_poses_and_lanes", "no_poses_no_lanes"])
def test_scene_pack_from_batches_matches_jax(poses):
    """Field by field: the stitched world maps, origins, init states, replay
    actions, lane points, ground-truth states and masks, with the batch's
    own world poses, scene ids and lanes, and without (synthesized
    placement, no lanes)."""
    jb = jax_synthetic(seed=2, batch_size=6, raster_size=32, hist_frames=4, horizon=12)
    tb = synthetic_batch(seed=2, batch_size=6, raster_size=32, hist_frames=4, horizon=12,
                         device="cpu")
    kw = dict(sim_steps=20, world_map_size=96, controlled_mask=np.arange(6) % 2 == 0)
    if poses == "world_poses_and_lanes":
        rng = np.random.default_rng(1)
        wfa = np.stack([_rigid(rng.uniform(-0.3, 0.3), 10 * i + rng.uniform(-1, 1),
                               rng.uniform(-3, 3)) for i in range(6)])
        kw.update(world_from_agent=wfa, scene_index=np.array([5, 5, 5, 9, 9, 9]))
    else:
        jb = jb._replace(lane_points=None, lane_avail=None)
        tb = tb._replace(lane_points=None, lane_avail=None)
    want = jscene.scene_pack_from_batches(jb, **kw)
    got = tscene.scene_pack_from_batches(tb, device="cpu", **kw)
    assert got.map_resolution == want.map_resolution
    fields = [f for f in want._fields if f != "map_resolution"]
    assert _equal_fields({f: getattr(got, f) for f in fields},
                         {f: getattr(want, f) for f in fields}, atol=ATOL) == len(fields)
    assert float(np.asarray(want.world_map).max()) > 0
    if poses == "world_poses_and_lanes":
        assert bool(np.asarray(want.lane_avail).any())
        assert not np.allclose(np.asarray(want.map_origin)[0], np.asarray(want.map_origin)[1])


def test_scene_pack_from_shards_matches_jax(tmp_path):
    jpacked.write_batches(str(tmp_path), _jax_batches(2, bs=4, raster=32, hist_frames=4))
    kw = dict(num_scenes=2, agents_per_scene=3, sim_steps=20, start_index=6,
              world_map_size=128)
    want = jscene.scene_pack_from_shards(str(tmp_path), **kw)
    got = tscene.scene_pack_from_shards(str(tmp_path), device="cpu", **kw)
    fields = [f for f in want._fields if f != "map_resolution"]
    assert _equal_fields({f: getattr(got, f) for f in fields},
                         {f: getattr(want, f) for f in fields}, atol=ATOL) == len(fields)
    assert got.scene_index.tolist() == [0, 0, 0, 1, 1, 1] and bool(got.controlled_mask.all())


def test_guide_with_gt_picks_the_jax_sample():
    """With several samples, `guide_with_gt` keeps the sample the JAX
    package's `choose_closest_to_gt` picks on the same decoded samples (in
    place of the guidance-loss filtration); one agent has no valid ground
    truth and keeps sample 0."""
    batch = synthetic_batch(seed=4, batch_size=4, raster_size=64, hist_frames=10,
                            device="cpu")
    batch = batch._replace(target_availabilities=torch.where(
        torch.arange(4)[:, None] == 3, 0.0, batch.target_availabilities))
    models = pipeline.build_models(seed=2, device="cpu", n_diffusion_steps=4,
                                   raster_channels=batch.image.shape[-1], cond_feat_dim=32,
                                   map_feature_dim=32, curr_state_feat_dim=16, hidden_size=16,
                                   base_dim=8)
    opts = pipeline.SamplingOptions(num_samp=4, guide_with_gt=True)
    specs = pipeline.flagship_guidance_specs(2)
    wfa, si = pipeline.scene_world_poses(4, 2, "cpu")
    out = pipeline.sample_plans(models, batch, specs, wfa, si, options=opts,
                                generator=torch.Generator().manual_seed(0))
    traj = out["traj"].numpy()
    _, idx = jax_closest(jnp.asarray(traj), jnp.asarray(traj[..., :2]),
                         jnp.asarray(batch.target_positions.numpy()),
                         jnp.asarray(batch.target_availabilities.numpy()))
    assert out["best_index"].tolist() == np.asarray(idx).tolist()
    assert out["best_index"][3] == 0
    np.testing.assert_array_equal(out["best"].numpy(), traj[np.arange(4), np.asarray(idx)])
