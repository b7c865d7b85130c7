"""The port's evaluation modules against the JAX package on the same arrays:
`eval/metrics.py`, `eval/cle.py`, `sim/occupancy.py`, `rules/stl.py`,
`ops/metrics.py` and `sim/logger.py`; and the rollout CLI's report on
trained checkpoints.

Tolerances: where both sides compute in numpy (ADE / FDE, Wasserstein, the
realism deviation, the validators, the composites over equal series) the
results are equal. STL robustness and its gradient (autograd against
`jax.grad`) within 1e-5; the batched metrics within rtol 1e-5 (f32 norms,
log-sum-exp and means on two libraries), their 0 / 1 flags equal.
Occupancy grids within rtol 1e-5 (+ 1e-7 absolute for cells that hold
almost no mass: another summation order of the same f32 terms); the
metrics over them equal on fixtures whose cells are held clear of the 0.1
occupancy threshold. The CLE series: displacement within rtol 1e-6, the
off-road and collision flags and the speeds equal, on trajectories clear of
the drivable edge and of touching boxes.
"""

import json
import runpy
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rollout as jax_rollout_cli
from cld_tpu.eval import cle as jcle
from cld_tpu.eval import metrics as jem
from cld_tpu.ops import metrics as jom
from cld_tpu.rules import stl as jstl
from cld_tpu.sim import env as jenv
from cld_tpu.sim import logger as jlogger
from cld_tpu.sim import occupancy as jocc
from cld_tpu.sim import scene as jscene
from cld_tpu.sim.metrics import summarize_metrics as jax_summarize
from cld_tpu_torch import rollout, train
from cld_tpu_torch.eval import cle, metrics as em
from cld_tpu_torch.ops import metrics as om
from cld_tpu_torch.rules import stl
from cld_tpu_torch.sim import env, logger, occupancy as occ, scene
from cld_tpu_torch.training.checkpoints import restore_pytree

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ eval/metrics.py

def test_ade_fde_wasserstein_and_realism_equal_the_jax_package():
    rng = np.random.default_rng(0)
    pred = rng.normal(size=(5, 12, 2)).astype(np.float32)
    gt = rng.normal(size=(5, 12, 2)).astype(np.float32)
    avail = (rng.uniform(size=(5, 12)) > 0.3).astype(np.float32)
    avail[2] = 0.0  # a sample with no available frame
    for args in ((pred, gt), (pred, gt, avail)):
        assert em.ade(*map(_t, args)) == jem.ade(*args)
        assert em.fde(*map(_t, args)) == jem.fde(*args)
    a, b = rng.normal(size=300), rng.normal(0.5, 2.0, size=170)
    assert em.wasserstein_1d(_t(a), _t(b)) == jem.wasserstein_1d(a, b)
    stats = {k: rng.normal(size=(6, 52)).astype(np.float32) for k in
             ("long_acc_gt", "long_acc_pred", "lat_acc_gt", "lat_acc_pred")}
    assert em.realism_deviation({k: _t(v) for k, v in stats.items()}) == \
        jem.realism_deviation(stats)
    stats.update(jerk_gt=np.diff(stats["long_acc_gt"], axis=-1) * 7.0,
                 jerk_pred=np.diff(stats["long_acc_pred"], axis=-1) * 3.0)
    assert em.realism_deviation(stats, dt=0.2) == jem.realism_deviation(stats, dt=0.2)
    flat = {k: v.ravel() for k, v in stats.items() if not k.startswith("jerk")}
    with pytest.raises(ValueError, match="per-agent jerk"):
        em.realism_deviation(flat)


# ---------------------------------------------------------------- rules/stl.py

def _stl_cases():
    return {
        "always": (lambda m, r: m.always(r[..., 2]), None),
        "always_interval": (lambda m, r: m.always(r[..., 2], interval=(0, 3)), None),
        "eventually_interval": (lambda m, r: m.eventually(r[..., 1], temp=5.0,
                                                          interval=(2, 5)), None),
        "eventually": (lambda m, r: m.eventually(r[..., 0]), None),
        "and_or": (lambda m, r: m.stl_or(m.stl_and(r[..., 0], r[..., 1]), r[..., 2], temp=3.0),
                   None),
        "speed_limit": (lambda m, r: m.SpeedLimitRule(speed_limit=2.0).robustness(r), "loss"),
        "stop_sign": (lambda m, r: m.StopSignRule(box_center=(1.0, 0.5), box_half=(2.0, 1.5),
                                                  stop_speed=1.0).robustness(r), "loss"),
        "stop_sign_held": (lambda m, r: m.StopSignRule(
            box_center=(1.0, 0.5), box_half=(2.0, 1.5), stop_speed=1.0,
            num_steps_to_stop=3).robustness(r), "loss"),
    }


@pytest.mark.parametrize("case", sorted(_stl_cases()))
def test_stl_values_and_gradients_match_jax(case):
    fn, _ = _stl_cases()[case]
    rng = np.random.default_rng(sorted(_stl_cases()).index(case))
    traj = rng.normal(0.0, 1.5, size=(3, 20, 6)).astype(np.float32)
    want, want_g = map(np.asarray, jax.jit(lambda x: (  # one jitted compile
        fn(jstl, x), jax.grad(lambda x: jnp.sum(jnp.sin(fn(jstl, x))))(x)))(jnp.asarray(traj)))
    x = torch.from_numpy(traj).requires_grad_(True)
    got = fn(stl, x)
    (g,) = torch.autograd.grad(torch.sin(got).sum(), x)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rule", ["speed_limit", "stop_sign"])
def test_stl_rule_losses_match_jax(rule):
    rng = np.random.default_rng(5)
    traj = rng.normal(0.0, 2.0, size=(4, 15, 6)).astype(np.float32)
    kw = dict(speed_limit=4.0) if rule == "speed_limit" else dict(box_center=(4.0, 0.0),
                                                                     stop_speed=0.8)
    cls = {"speed_limit": "SpeedLimitRule", "stop_sign": "StopSignRule"}[rule]
    want = np.asarray(getattr(jstl, cls)(**kw).loss(jnp.asarray(traj)))
    got = getattr(stl, cls)(**kw).loss(torch.from_numpy(traj)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (want > 0).any() and (want == 0).any()


# ---------------------------------------------------------------- ops/metrics.py

def _metric_inputs():
    rng = np.random.default_rng(7)
    B, N, T, M = 6, 4, 10, 3
    f = lambda *s, lo=None: rng.normal(size=s).astype(np.float32)
    return dict(
        rng=rng, gt=f(B, T, 2), pred=f(B, N, T, 2),
        avail=(rng.uniform(size=(B, T)) > 0.2).astype(np.float32),
        pos=rng.uniform(-8, 8, size=(B, T, 2)).astype(np.float32),
        yaw=rng.uniform(-3, 3, size=(B, T)).astype(np.float32),
        extent=np.stack([rng.uniform(3, 5, B), rng.uniform(1.5, 2.2, B), np.ones(B)],
                        axis=-1).astype(np.float32),
        scene=np.array([0, 0, 0, 1, 1, 2]),
        dmap=(rng.uniform(size=(B, 32, 32)) > 0.4).astype(np.float32),
        rfa=np.tile(np.array([[2.0, 0, 16], [0, 2.0, 16], [0, 0, 1]], np.float32), (B, 1, 1)),
        mpred=f(B, M, T, 2), conf=rng.dirichlet(np.ones(M), B).astype(np.float32),
        x=f(B, 5), m=f(B, M, 5), v=rng.uniform(0.5, 2.0, size=(B, M, 5)).astype(np.float32),
        pi=rng.dirichlet(np.ones(M), B).astype(np.float32),
    )


def test_batch_metrics_match_jax():
    d = _metric_inputs()
    close = lambda g, w: np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-5,
                                                   atol=1e-6)
    for mode in ("mean", "oracle"):
        for av in (None, d["avail"]):
            close(om.batch_average_displacement_error(
                _t(d["gt"]), _t(d["pred"]), None if av is None else _t(av), mode),
                jom.batch_average_displacement_error(d["gt"], d["pred"], av, mode))
        close(om.batch_final_displacement_error(_t(d["gt"]), _t(d["pred"]), mode),
              jom.batch_final_displacement_error(d["gt"], d["pred"], mode))
    for scale in (1.0, 3.0):
        got = om.batch_pairwise_collision_rate(_t(d["pos"]), _t(d["extent"]), _t(d["scene"]),
                                               scale)
        close(got, jom.batch_pairwise_collision_rate(d["pos"], d["extent"], d["scene"], scale))
    assert 0.0 < float(got) < 1.0
    off = om.batch_detect_off_road(_t(d["pos"]), _t(d["dmap"]), _t(d["rfa"]))
    np.testing.assert_array_equal(off.numpy(), np.asarray(
        jom.batch_detect_off_road(d["pos"], d["dmap"], d["rfa"])))
    assert 0.0 < float(off.mean()) < 1.0
    disk = om.batch_detect_off_road_disk(_t(d["pos"]), _t(d["yaw"]), _t(d["extent"]),
                                         _t(d["dmap"]), _t(d["rfa"]), num_disks=4)
    np.testing.assert_array_equal(disk.numpy(), np.asarray(jom.batch_detect_off_road_disk(
        d["pos"], d["yaw"], d["extent"], d["dmap"], d["rfa"], num_disks=4)))
    close(om.batch_neg_multi_log_likelihood(_t(d["gt"]), _t(d["mpred"]), _t(d["conf"]),
                                            _t(d["avail"])),
          jom.batch_neg_multi_log_likelihood(d["gt"], d["mpred"], d["conf"], d["avail"]))
    close(om.log_normal(_t(d["m"]), _t(d["m"][:1]), _t(d["v"][:1])),
          jom.log_normal(d["m"], d["m"][:1], d["v"][:1]))
    av = (d["rng"].uniform(size=(6, 5)) > 0.3).astype(np.float32)
    for mode in ("sum", "mean", "max"):
        for v, a in ((d["v"], None), (None, av)):
            close(om.gmm_loglikelihood(_t(d["x"]), _t(d["m"]), None if v is None else _t(v),
                                       _t(d["pi"]), None if a is None else _t(a), mode),
                  jom.gmm_loglikelihood(d["x"], d["m"], v, d["pi"], a, mode))
    with pytest.raises(ValueError, match="unknown mode"):
        om.gmm_loglikelihood(_t(d["x"]), _t(d["m"]), None, _t(d["pi"]), mode="median")
    close(om.trajectory_diversity(_t(d["pred"])), jom.trajectory_diversity(d["pred"]))
    close(om.trajectory_diversity(_t(d["pred"][:, :1])), jom.trajectory_diversity(
        d["pred"][:, :1]))


# ---------------------------------------------------------------- sim/occupancy.py

def _clear_of_threshold(grid, thresh=0.1, margin=1e-4):
    return float(np.min(np.abs(np.asarray(grid) - thresh))) > margin


@pytest.mark.parametrize("step,sigma,window", [(1.0, 1.0, 7), (0.5, 0.25, 5), (2.0, 3.0, 9)])
def test_occupancy_grid_and_metrics_match_jax(step, sigma, window):
    rng = np.random.default_rng(int(step * 10 + window))
    origin = (-12.5, -7.25)
    coords = rng.uniform(-20, 20, size=(60, 2)).astype(np.float32)
    coords[5] = [np.nan, 1.0]  # a non-finite position splats nothing
    jst = jocc.occupancy_init(origin, (40, 48), step, sigma)
    jst = jax.jit(lambda s, c: jocc.occupancy_update(s, c, weight=0.7, window=window))(
        jst, jnp.asarray(coords))
    st = occ.occupancy_init(origin, (40, 48), step, sigma, device="cpu")
    st = occ.occupancy_update(st, torch.from_numpy(coords), weight=0.7, window=window)
    np.testing.assert_allclose(st.grid.numpy(), np.asarray(jst.grid), rtol=1e-5, atol=1e-7)
    assert _clear_of_threshold(jst.grid)
    dmap = (rng.uniform(size=(50, 60)) > 0.5).astype(np.float32)
    morg = np.array([-15.0, -10.0], np.float32)
    want = jocc.occupancy_metrics(jst, jnp.asarray(dmap), jnp.asarray(morg), 0.75)
    got = occ.occupancy_metrics(st, torch.from_numpy(dmap), torch.from_numpy(morg), 0.75)
    assert got["occupied_cells"] == want["occupied_cells"] > 0
    assert got["occupancy_coverage"] == want["occupancy_coverage"]
    assert got["offroad_occupancy_fraction"] == pytest.approx(
        want["offroad_occupancy_fraction"], rel=1e-5)


# ---------------------------------------------------------------- eval/cle.py

def _packs_and_log():
    """The same two-scene pack in both packages and a rollout log made from
    its dataset future, edited so that validators fail: agent 1 drives onto
    agent 0 (frames 3-6), agent 2 leaves the road (frames 5-12) and agent 4
    speeds (frame 9)."""
    kw = dict(seed=2, num_scenes=2, agents_per_scene=3, world_map_size=256, sim_steps=20)
    jpack = jscene.synthetic_scene_pack(**kw)
    pack = scene.synthetic_scene_pack(**kw, device="cpu")
    np.testing.assert_array_equal(pack.world_map.numpy(), np.asarray(jpack.world_map))
    log = np.asarray(jpack.gt_states).transpose(1, 0, 2)[1:].copy()  # [T, Na, 4]
    log[3:7, 1, :2] = log[3:7, 0, :2]
    log[3:7, 1, 3] = log[3:7, 0, 3]
    log[5:13, 2, 1] = 25.0
    log[9, 4, 2] = 40.0
    return jpack, pack, log


def test_cle_series_validators_and_report_match_jax():
    jpack, pack, log = _packs_and_log()
    jcfg = jenv.SimConfig(num_simulation_steps=20, n_step_action=5, raster_size=64)
    cfg = env.SimConfig(num_simulation_steps=20, n_step_action=5, raster_size=64)
    for name in ("displacement", "offroad", "collision", "speed"):
        want = np.asarray(getattr(jcle, f"{name}_series")(jpack, jnp.asarray(log), jcfg))
        got = getattr(cle, f"{name}_series")(pack, torch.from_numpy(log), cfg).numpy()
        if name == "displacement":
            np.testing.assert_allclose(got, want, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    want = jcle.cle_report(jpack, jnp.asarray(log), jcfg)
    got = cle.cle_report(pack, torch.from_numpy(log), cfg)
    assert got["num_scenes"] == want["num_scenes"] == 3
    assert got["failed_scenes"] == want["failed_scenes"]
    assert got["failed_frames"] == want["failed_frames"]
    assert min(want["failed_scenes"].values()) == 1
    assert got["composite"].keys() == want["composite"].keys()
    for k in want["composite"]:
        assert got["composite"][k] == pytest.approx(want["composite"][k], rel=1e-6)
    assert got["composite"]["passed_driven_miles"] < got["composite"]["driven_miles"]
    plan = cle.default_plan(max_speed=20.0, offroad_duration_s=0.3)
    jplan = jcle.default_plan(max_speed=20.0, offroad_duration_s=0.3)
    got = cle.cle_report(pack, torch.from_numpy(log), cfg, plan)
    want = jcle.cle_report(jpack, jnp.asarray(log), jcfg, jplan)
    assert got["failed_scenes"] == want["failed_scenes"]
    assert got["failed_frames"] == want["failed_frames"]
    assert got["composite"] == pytest.approx(want["composite"], rel=1e-6)


def test_validators_reset_cumsum_and_plans_equal_the_jax_package():
    rng = np.random.default_rng(11)
    x = rng.uniform(size=(4, 30))
    mask = rng.uniform(size=(4, 30)) > 0.4
    np.testing.assert_array_equal(cle.reset_cumsum(x, mask), jcle.reset_cumsum(x, mask))
    series = rng.normal(size=40)
    for kw in (dict(max_value=0.8), dict(min_value=-0.5, max_value=1.0),
               dict(max_value=0.2, violation_duration_s=0.25),
               dict(min_value=-0.3, violation_duration_s=0.35, duration_mode="continuous")):
        got = cle.RangeValidator("v", "m", **kw).validate(series, 0.1)
        want = jcle.RangeValidator("v", "m", **kw).validate(series, 0.1)
        assert tuple(got) == tuple(want)
    disp = rng.uniform(0, 2, size=40)
    vres = {"a": cle.ValidatorOutput(False, [7, 9]), "b": cle.ValidatorOutput(True, [])}
    jres = {"a": jcle.ValidatorOutput(False, [7, 9]), "b": jcle.ValidatorOutput(True, [])}
    for ours, theirs in ((cle.DrivenMilesCompositeMetric(), jcle.DrivenMilesCompositeMetric()),
                         (cle.PassedDrivenMilesCompositeMetric(validators=("a", "b")),
                          jcle.PassedDrivenMilesCompositeMetric(validators=("a", "b")))):
        assert ours.compute({"displacement": disp}, vres) == theirs.compute(
            {"displacement": disp}, jres)
    for bad in (dict(), dict(min_value=1.0, max_value=0.0), dict(max_value=1.0,
                                                                  duration_mode="peak")):
        with pytest.raises(ValueError):
            cle.RangeValidator("v", "m", **bad)
    with pytest.raises(ValueError, match="not in the plan"):
        cle.EvaluationPlan(metrics={}, validators=(cle.RangeValidator("v", "m", max_value=1.0),))
    val = {0: vres, 1: {"a": cle.ValidatorOutput(True, []), "b": cle.ValidatorOutput(False, [3])}}
    assert cle.ValidationCountingAggregator().aggregate(val) == {"a": 1, "b": 1}
    assert cle.ValidationCountingAggregator(True).aggregate(val) == {"a": 2, "b": 1}


def test_occupancy_report_matches_the_jax_cli():
    jpack, pack, log = _packs_and_log()
    want = jax_rollout_cli.occupancy_report(jpack, jnp.asarray(log))
    got = rollout.occupancy_report(pack, torch.from_numpy(log))
    assert got.keys() == want.keys()
    assert got["occupied_cells"] == want["occupied_cells"] > 0
    assert got["occupancy_coverage"] == want["occupancy_coverage"]
    assert got["offroad_occupancy_fraction"] == pytest.approx(
        want["offroad_occupancy_fraction"], rel=1e-5)
    assert got["offroad_occupancy_fraction"] > 0


# ---------------------------------------------------------------- sim/logger.py

def _episodes():
    rng = np.random.default_rng(13)
    return [dict(trajectories=rng.normal(size=(8, 5, 4)).astype(np.float32),
                 scene_index=np.array([0, 0, 1, 1, 1]),
                 controlled_mask=np.array([True, False, True, False, False]),
                 metrics={"offroad_rate": np.float32(0.25), "n": 3, "rules": ["a"],
                          "device": "cpu"},
                 actions=None if i else rng.normal(size=(8, 5, 2)).astype(np.float32))
            for i in range(2)]


def _h5_tree(path):
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = obj[()]
            else:
                out[name] = dict(obj.attrs)
        f.visititems(visit)
    return out


def test_rollout_logger_round_trips_as_the_jax_logger(tmp_path, monkeypatch):
    ours, theirs = logger.RolloutLogger(), jlogger.RolloutLogger()
    for ep in _episodes():
        ours.log_episode(**{k: _t(v) if isinstance(v, np.ndarray) else v for k, v in ep.items()})
        theirs.log_episode(**ep)
    assert len(ours) == 2
    got = _h5_tree(ours.save_hdf5(str(tmp_path / "a" / "log.h5")))
    want = _h5_tree(theirs.save_hdf5(str(tmp_path / "b" / "log.h5")))
    assert got.keys() == want.keys() and "episode_0000/scene_000001/actions" in got
    for k in want:
        if isinstance(want[k], dict):
            assert got[k] == want[k], k
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert json.loads(got["episode_0000"]["metrics"]) == {"offroad_rate": 0.25, "n": 3.0}
    path = ours.save_npz(str(tmp_path / "a" / "log"))
    assert path.endswith("log.npz")
    with np.load(path) as f, np.load(theirs.save_npz(str(tmp_path / "b" / "log"))) as g:
        assert sorted(f.files) == sorted(g.files) == ["episode_0_traj", "episode_1_traj"]
        for k in f.files:
            np.testing.assert_array_equal(f[k], g[k])
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="save_npz"):
        ours.save_hdf5(str(tmp_path / "c.h5"))


# ---------------------------------------------------------------- the CLIs

def _jax_report_keys(num_scenes, agents, frames):
    """The keys of the JAX rollout CLI's report for `--cle-report` and
    guidance rules, less its compile time, its EBM keys and its renders."""
    jpack = jscene.synthetic_scene_pack(seed=0, num_scenes=num_scenes, agents_per_scene=agents,
                                        sim_steps=frames)
    jcfg = jenv.SimConfig(num_simulation_steps=frames, raster_size=64, hist_frames=8)
    log = jnp.asarray(np.asarray(jpack.gt_states).transpose(1, 0, 2)[1:])
    keys = set(jax_summarize(jpack, jenv.init_sim_state(jpack, jcfg), jcfg))
    keys |= set(jax_rollout_cli.occupancy_report(jpack, log))
    cle_keys = {k: set(v) if isinstance(v, dict) else None
                for k, v in jcle.cle_report(jpack, log, jcfg).items()}
    return keys | {"cle", "wall_clock_s", "agent_steps_per_sec", "compile_and_first_run_s",
                   "guidance_satisfaction"}, \
        cle_keys


def test_train_then_roll_out_and_evaluate_the_checkpoints(tmp_path, monkeypatch, capsys):
    """Train 1 step per stage at `cld_smoke`, roll the checkpoints out
    through the CLI (the report carries every key of the JAX CLI's for
    these flags, finite), the same trajectories as the same weights loaded
    directly (`--weights`), then `--mode test` and the `test` alias on them."""
    out = tmp_path / "runs"
    base = ["--registered-name", "cld_smoke", "--device", "cpu", "--output", str(out)]
    train.main(base + ["--mode", "vae", "--steps", "1"])
    vae, dm = str(out / "vae" / "ckpt_final"), str(out / "dm" / "ckpt_final")
    train.main(base + ["--mode", "dm", "--steps", "1", "--vae-ckpt", vae])
    roll = ["--registered-name", "cld_smoke", "--device", "cpu", "--num-scenes", "2",
            "--agents-per-scene", "2", "--num-sim-steps", "10", "--guidance", "flagship"]
    rep = rollout.main(roll + ["--vae-ckpt", vae, "--dm-ckpt", dm, "--cle-report",
                               "--output", str(tmp_path / "a")])
    keys, cle_keys = _jax_report_keys(2, 2, 10)
    assert keys <= set(rep), keys - set(rep)
    assert {k: set(v) if isinstance(v, dict) else None for k, v in rep["cle"].items()} == cle_keys
    numbers = [v for k, v in rep.items() if isinstance(v, (int, float))]
    numbers += [v for d in ("cle",) for sub in rep[d].values() if isinstance(sub, dict)
                for v in sub.values()]
    assert len(numbers) > 20 and all(np.isfinite(numbers))

    flat = {f"vae.{k}": v.numpy() for k, v in restore_pytree(vae)["params"].items()}
    flat.update({f"dm.model.{k}": v.numpy() for k, v in restore_pytree(dm)["params"].items()})
    np.savez(tmp_path / "w.npz", **flat)
    rollout.main(roll + ["--weights", str(tmp_path / "w.npz"), "--output", str(tmp_path / "b")])
    with np.load(tmp_path / "a" / "trajectories.npz") as a, \
            np.load(tmp_path / "b" / "trajectories.npz") as b:
        assert a["trajectories"].shape == (10, 4, 4)
        np.testing.assert_array_equal(a["trajectories"], b["trajectories"])

    res = train.main(base + ["--mode", "test", "--steps", "1", "--vae-ckpt", vae,
                             "--dm-ckpt", dm])
    assert sorted(res) == ["collision_failure_rate", "offroad_failure_rate",
                           "overall_failure_rate", "realism_deviation", "wd_jerk", "wd_lat",
                           "wd_long"]
    assert all(np.isfinite(list(res.values())))
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["test.py", *base, "--steps", "1", "--vae-ckpt", vae,
                                      "--dm-ckpt", dm])
    runpy.run_module("cld_tpu_torch.test", run_name="__main__")
    printed = capsys.readouterr().out
    assert "mode=test" in printed and json.loads(printed[printed.index("{"):]) == res
