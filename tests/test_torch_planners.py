"""The port's model-free policies and their dynamics against the JAX
package, on the CPU: `ops.dynamics` (chain rollout, inverse dynamics,
masked velocity), `ops.dynamics_extra`, `policies.hardcoded`,
`policies.planner`, `policies.mpc`, `policies.contingency`, and the rollout
CLI's `--policy` / `--agents-policy` in closed loop on converted scenes
(`--scene-data`, 2 scenes x 3 agents, raster 64, 10 frames).

Observations are the synthetic batch at raster 64 with its road shifted by
3 pixel rows (1.5 m), so that the ego is off the road's center line and
mirror-image candidates do not tie, and lane points offset to match.
Tolerances (measured max |diff| in brackets): dynamics values within
rtol 1e-5 / atol 1e-5 and gradients within 1e-5 relative of their largest
entry; the lattice plan's positions within 1e-4 m [1.1e-5 at magnitude 60,
f32 cumulative sums], its controls within 1e-5; the MPC's 100 Adam
iterations within 2e-4 on controls and positions [3.2e-5 and 1.8e-5];
the contingency plan within 1e-4 [9.5e-6]; closed-loop logs of the lattice
and the replay within 1e-4 m (states up to ~100 m, f32). The MPC and the
contingency planner are held against the JAX CLI's construction over one
replan, where each is continuous
(`test_rollout_cli_solver_policies_first_replan_matches_jax`), and over a
whole episode against the port's own `simulate`
(`test_rollout_cli_runs_the_solver_policies_on_scene_data`).
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cld_tpu.data import packed as jpacked
from cld_tpu.data.synthetic import synthetic_batch as jax_synthetic
from cld_tpu.ops import dynamics as jdyn
from cld_tpu.ops import dynamics_extra as jdx
from cld_tpu.policies import contingency as jcont
from cld_tpu.policies import hardcoded as jhard
from cld_tpu.policies import mpc as jmpc
from cld_tpu.policies import planner as jplan
from cld_tpu.sim import env as jenv
from cld_tpu.sim import scene as jscene
from cld_tpu_torch import rollout
from cld_tpu_torch.data.batch import TrafficBatch
from cld_tpu_torch.ops import dynamics as tdyn
from cld_tpu_torch.ops import dynamics_extra as tdx
from cld_tpu_torch.policies import contingency as tcont
from cld_tpu_torch.policies import hardcoded as thard
from cld_tpu_torch.policies import mpc as tmpc
from cld_tpu_torch.policies import planner as tplan
from cld_tpu_torch.sim import env as tenv
from cld_tpu_torch.sim import scene as tscene

torch.set_num_threads(2)
Tn = torch.from_numpy


def _obs(seed=5, B=4):
    """The two packages' observations of the same arrays: the synthetic
    batch with its road and lanes shifted 1.5 m to +y."""
    jb = jax_synthetic(seed=seed, batch_size=B, raster_size=64, hist_frames=10)
    arrays = {k: np.array(v) for k, v in jb._asdict().items() if v is not None}
    arrays["drivable_map"] = np.roll(arrays["drivable_map"], 3, axis=1)
    arrays["image"][..., 11:] = np.roll(arrays["image"][..., 11:], 3, axis=1)
    arrays["lane_points"][..., 1] += 1.5
    jb = jb._replace(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return jb, TrafficBatch(**{k: Tn(v) for k, v in arrays.items()})


def _close_action(got, want, atol, fields=("positions", "yaws", "controls")):
    for f in fields:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert tuple(g.shape) == w.shape, f
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol, err_msg=f)


def test_unicycle_chain_inverse_and_velocity_match_jax():
    rng = np.random.default_rng(0)
    x0 = np.stack([rng.normal(size=5), rng.normal(size=5), rng.uniform(1, 9, 5),
                   rng.uniform(-1, 1, 5)], -1).astype(np.float32)
    u = np.stack([rng.normal(0, 3, (5, 12)), rng.normal(0, 0.5, (5, 12))], -1).astype(np.float32)
    dyn = jdyn.UnicycleParams(max_steer=0.5, max_yawvel=6.28, acce_lo=-10.0, acce_hi=8.0)
    tdyn_p = tdyn.UnicycleParams(*dyn)
    want = jdyn.unicycle_forward_dynamics_chain(dyn, jnp.asarray(x0), jnp.asarray(u), 0.1)
    ut = Tn(u).requires_grad_(True)
    got = tdyn.unicycle_forward_dynamics_chain(tdyn_p, Tn(x0), ut, 0.1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    g_want = np.asarray(jax.grad(lambda a: jnp.sum(jnp.sin(
        jdyn.unicycle_forward_dynamics_chain(dyn, jnp.asarray(x0), a, 0.1))))(jnp.asarray(u)))
    (g,) = torch.autograd.grad(torch.sin(got).sum(), ut)
    np.testing.assert_allclose(g.numpy(), g_want, rtol=0, atol=1e-5 * np.abs(g_want).max())

    xs = np.asarray(want)
    np.testing.assert_allclose(
        tdyn.unicycle_inverse_dyn(Tn(xs[:, :-1]), Tn(xs[:, 1:]), 0.1).numpy(),
        np.asarray(jdyn.unicycle_inverse_dyn(xs[:, :-1], xs[:, 1:], 0.1)), rtol=1e-6, atol=1e-6)
    mask = rng.random((5, 12)) > 0.3
    vel_w = jdyn.unicycle_calculate_vel(jnp.asarray(xs[..., :2]), jnp.asarray(xs[..., 3:4]), 0.1,
                                        jnp.asarray(mask))
    vel_g = tdyn.unicycle_calculate_vel(Tn(xs[..., :2]), Tn(xs[..., 3:4]), 0.1, Tn(mask))
    np.testing.assert_allclose(vel_g.numpy(), np.asarray(vel_w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model", ["bicycle_normalized", "bicycle_clipped", "single",
                                   "double", "double_vbound"])
def test_dynamics_extra_match_jax_in_value_and_gradient(model):
    rng = np.random.default_rng(1)
    if model.startswith("bicycle"):
        x = np.stack([rng.normal(size=6), rng.normal(size=6), rng.uniform(-1, 1, 6),
                      rng.uniform(1, 20, 6), rng.uniform(-1, 1, 6), rng.uniform(3, 5, 6)], -1)
        u = rng.normal(0, 3, (6, 2))
        norm = model.endswith("normalized")
        jf = lambda x, u: jdx.bicycle_step(jdx.BicycleParams(), x, u, 0.1, normalize=norm)
        tf = lambda x, u: tdx.bicycle_step(tdx.BicycleParams(), x, u, 0.1, normalize=norm)
    elif model == "single":
        x, u = rng.normal(size=(6, 2)), rng.normal(0, 40, (6, 2))
        jf = lambda x, u: jdx.single_integrator_step(jdx.SingleIntegratorParams(), x, u, 0.1)
        tf = lambda x, u: tdx.single_integrator_step(tdx.SingleIntegratorParams(), x, u, 0.1)
    else:
        x = np.concatenate([rng.normal(size=(6, 2)), rng.uniform(-12, 12, (6, 2))], -1)
        u = rng.normal(0, 10, (6, 2))
        vb = ((-10.0, 10.0), (-10.0, 10.0)) if model == "double_vbound" else None
        jf = lambda x, u: jdx.double_integrator_step(jdx.DoubleIntegratorParams(vbound=vb),
                                                     x, u, 0.1)
        tf = lambda x, u: tdx.double_integrator_step(tdx.DoubleIntegratorParams(vbound=vb),
                                                     x, u, 0.1)
    x, u = x.astype(np.float32), u.astype(np.float32)
    want = np.asarray(jf(jnp.asarray(x), jnp.asarray(u)))
    xt, ut = Tn(x).requires_grad_(True), Tn(u).requires_grad_(True)
    got = tf(xt, ut)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    gw = jax.grad(lambda x, u: jnp.sum(jnp.cos(jf(x, u))), argnums=(0, 1))(jnp.asarray(x),
                                                                          jnp.asarray(u))
    gt = torch.autograd.grad(torch.cos(got).sum(), (xt, ut))
    for a, b in zip(gt, gw):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * max(np.abs(b).max(), 1.0))


def test_hardcoded_policies_match_jax():
    jb, tb = _obs()
    _close_action(thard.gt_policy(tb), jhard.gt_policy(jb, None), 0.0, ("positions", "yaws"))
    log = np.random.default_rng(2).normal(size=(4, 30, 2)).astype(np.float32)
    _close_action(thard.replay_policy(Tn(log))(tb), jhard.replay_policy(jnp.asarray(log))(jb, None),
                  0.0)
    _close_action(thard.constant_policy(1.5, -0.2, 7)(tb),
                  jhard.constant_policy(1.5, -0.2, 7)(jb, None), 0.0)


def test_lattice_planner_matches_jax():
    jb, tb = _obs()
    want = jax.jit(jplan.lattice_planner_policy())(jb, jax.random.key(0))
    got = tplan.lattice_planner_policy()(tb)
    _close_action(got, want, 1e-4, ("positions",))
    _close_action(got, want, 1e-5, ("yaws", "controls"))
    # the plans differ between agents: the neighbors and the road matter
    assert len({tuple(np.round(c, 4)) for c in got.controls[:, 20].numpy()}) > 1


def test_mpc_solver_lane_reference_and_policy_match_jax():
    """`ftocp_solve` with two branches, an obstacle on the path and a warm
    start, against the JAX solver vmapped over agents; `lane_ref`; the MPC
    policy on the observation (lane reference, CV obstacles)."""
    rng = np.random.default_rng(3)
    B, Nobs, M, N = 3, 2, 2, 8
    cfg_j, cfg_t = jmpc.MPCConfig(N=N, M=M, iters=40), tmpc.MPCConfig(N=N, M=M, iters=40)
    x0 = np.stack([np.zeros(B), np.zeros(B), rng.uniform(3, 8, B), rng.uniform(-0.1, 0.1, B)],
                  -1).astype(np.float32)
    ypred = np.stack([np.linspace(2, 6, N)[None, None, None].repeat(B, 0).repeat(Nobs, 1)
                      .repeat(M, 2) + rng.normal(0, 1, (B, Nobs, M, 1)),
                      rng.normal(0, 1.5, (B, Nobs, M, N))], -1).astype(np.float32)
    mask = np.array([[True, False], [True, True], [False, True]])
    a_ext = rng.uniform(3.5, 5, (B, Nobs, 2)).astype(np.float32)
    e_ext = np.tile(np.array([4.5, 2.0], np.float32), (B, 1))
    xdes = np.stack([np.cumsum(np.full((B, N), 0.6), 1), rng.normal(0, 0.3, (B, N)),
                     np.full((B, N), 6.0)], -1).astype(np.float32)
    w = np.array([0.7, 0.3], np.float32)
    u_init = rng.normal(0, 0.3, (B, M, N, 2)).astype(np.float32)
    solve = jax.jit(jax.vmap(lambda a, b, c, d, e, f, g: jmpc.ftocp_solve(
        cfg_j, a, b, c, d, e, f, jnp.asarray(w), g)))
    want = solve(*map(jnp.asarray, (x0, ypred, mask, a_ext, e_ext, xdes, u_init)))
    got = tmpc.ftocp_solve(cfg_t, *map(Tn, (x0, ypred, mask, a_ext, e_ext, xdes, w)),
                           u_init=Tn(u_init))
    for k in ("xbr", "u0", "ubr"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=2e-4,
                                   err_msg=k)
    np.testing.assert_allclose(got["cost"].numpy(), np.asarray(want["cost"]), rtol=1e-4)
    np.testing.assert_allclose(got["max_violation"].numpy(), np.asarray(want["max_violation"]),
                               rtol=0, atol=1e-4)

    jb, tb = _obs()
    vdes = np.array([3.0, 5.0, 9.0, 12.0], np.float32)
    pos = np.zeros((4, 2), np.float32)
    ref_w, ok_w = jax.vmap(lambda lp, av, p, v: jmpc.lane_ref(lp, av, p, v, 20, 0.1))(
        jb.lane_points, jb.lane_avail, jnp.asarray(pos), jnp.asarray(vdes))
    ref_g, ok_g = tmpc.lane_ref(tb.lane_points, tb.lane_avail, Tn(pos), Tn(vdes), 20, 0.1)
    np.testing.assert_allclose(ref_g.numpy(), np.asarray(ref_w), rtol=0, atol=1e-5)
    assert ok_g.tolist() == np.asarray(ok_w).tolist() == [True] * 4

    want = jax.jit(jmpc.mpc_policy(jmpc.MPCConfig()))(jb, jax.random.key(0))
    _close_action(tmpc.mpc_policy(tmpc.MPCConfig())(tb), want, 2e-4)


def test_contingency_tree_plan_and_policy_match_jax():
    jb, tb = _obs()
    cfg_j, cfg_t = jcont.ContingencyConfig(), tcont.ContingencyConfig()
    curr = np.stack([np.zeros(4), np.zeros(4), tb.curr_speed.numpy(), np.zeros(4)], -1)
    curr = curr.astype(np.float32)
    tree_w = jax.jit(jax.vmap(lambda c: jcont.build_ego_tree(cfg_j, c)))(jnp.asarray(curr))
    tree_g = tcont.build_ego_tree(cfg_t, Tn(curr))
    assert tuple(tree_g.shape) == (4, 81, 20, 4)
    np.testing.assert_allclose(tree_g.numpy(), np.asarray(tree_w), rtol=0, atol=1e-4)

    rng = np.random.default_rng(4)
    modes = (rng.normal(0, 4, (4, 4, 3, 20, 2)) + np.array([8.0, 0.0])).astype(np.float32)
    amask = np.array([[1, 1, 0], [1, 0, 1], [0, 0, 0], [1, 1, 1]], bool)
    prob = np.array([0.4, 0.1, 0.3, 0.2], np.float32)
    a_ext = np.tile(np.array([4.5, 2.0], np.float32), (4, 3, 1))
    args = (modes, amask, tb.extent[:, :2].numpy(), a_ext, tb.drivable_map.numpy(),
            tb.raster_from_agent.numpy())
    want = jax.jit(jax.vmap(lambda e, am, m, ee, ae, dm, r, v: jcont.contingency_plan(
        cfg_j, e, am, jnp.asarray(prob), m, ee, ae, dm, r, curr_speed=v)))(
        tree_w, *map(jnp.asarray, args), jnp.asarray(curr[:, 2]))
    got = tcont.contingency_plan(cfg_t, tree_g, Tn(modes), Tn(prob), *map(Tn, args[1:]),
                                 curr_speed=Tn(curr[:, 2]))
    for k in ("branch", "leaf"):
        assert got[k].tolist() == np.asarray(want[k]).tolist(), k
    for k in ("plan", "root_cost", "value"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-4,
                                   err_msg=k)

    weights = {"collision_weight": 2.0, "lane_weight": 1.0, "progress_weight": 0.1}
    sel_w = jax.jit(lambda *a: jcont.ego_sample_planning(*a, weights))(
        tree_w[..., [0, 1, 3]], jnp.asarray(modes[:, 0]),
        *map(jnp.asarray, (tb.extent[:, :2].numpy(), a_ext, amask, args[4], args[5])))
    sel_g = tcont.ego_sample_planning(tree_g[..., [0, 1, 3]], Tn(modes[:, 0]), tb.extent[:, :2],
                                      Tn(a_ext), Tn(amask), *map(Tn, args[4:]), weights)
    assert sel_g.tolist() == np.asarray(sel_w).tolist()

    want = jax.jit(jcont.contingency_policy(cfg_j))(jb, jax.random.key(0))
    _close_action(tcont.contingency_policy(cfg_t)(tb), want, 1e-4)


def _scene_shards(path, seed=0, bs=6, raster=64, hist_frames=30, all_drivable=False):
    b = jax_synthetic(seed=seed, batch_size=bs, raster_size=raster, hist_frames=hist_frames)
    if all_drivable:  # the drivable layer (the first after the history channels) set everywhere
        image = np.array(b.image)
        image[..., hist_frames] = 1.0
        b = b._replace(image=jnp.asarray(image), drivable_map=jnp.ones_like(b.drivable_map))
    jpacked.write_batches(str(path), [b])
    return str(path)


JAX_POLICIES = {
    "lattice": lambda pack, sim: jplan.lattice_planner_policy(
        jplan.LatticePlannerConfig(horizon=52, dt=sim.dt, dyn=sim.dyn)),
    "gt_replay": lambda pack, sim: jhard.replay_policy(pack.replay_actions),
}
CLI_SCENE = ["--device", "cpu", "--num-scenes", "2", "--agents-per-scene", "3",
             "--num-sim-steps", "10", "--raster-size", "64", "--hist-frames", "10"]


@pytest.mark.parametrize("policy", sorted(JAX_POLICIES))
def test_rollout_cli_model_free_policy_on_scene_data_matches_jax(policy, tmp_path):
    """`--scene-data --policy <policy>`: the CLI's trajectory log and
    metrics against the JAX `simulate` of the same policy on the JAX
    package's scene pack of the same shards. The two scenes have different
    map origins, so render and step each take their own scene's."""
    shards = _scene_shards(tmp_path / "shards", hist_frames=10)
    rep = rollout.main(CLI_SCENE + ["--scene-data", shards, "--policy", policy,
                                    "--output", str(tmp_path)])
    assert rep["policy"] == policy and rep["launches"]["lstm2_fwd"] == 0
    assert rep["num_controlled_agents"] == 6 and "compile_and_first_run_s" in rep
    pack = jscene.scene_pack_from_shards(shards, num_scenes=2, agents_per_scene=3, sim_steps=10)
    assert not np.allclose(np.asarray(pack.map_origin[0]), np.asarray(pack.map_origin[1]))
    sim = jenv.SimConfig(num_simulation_steps=10, n_step_action=5, hist_frames=10, raster_size=64)
    state, want = jax.jit(lambda k: jenv.simulate(pack, JAX_POLICIES[policy](pack, sim), k, sim))(
        jax.random.key(1))
    with np.load(tmp_path / "trajectories.npz") as f:
        got = f["trajectories"]
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
    assert rep["offroad_step_fraction"] == pytest.approx(
        float(np.asarray(state.offroad_steps).sum()) / 60)
    assert rep["collision_step_fraction"] == pytest.approx(
        float(np.asarray(state.collision_steps).sum()) / 60)


@pytest.mark.parametrize("policy", ["mpc", "contingency"])
def test_rollout_cli_runs_the_solver_policies_on_scene_data(policy, tmp_path):
    """`--scene-data --policy mpc|contingency`: the CLI's log is the port's
    `simulate` of the policy configured as the JAX CLI configures it. In
    closed loop the two packages part ways on this fixture (a measured
    0.13-0.62 m over seeds 1-8): the MPC's 100 Adam iterations at a fixed
    rate amplify f32 differences (1e-5 after 20 iterations, 1e-2 after 100,
    on seed 0's first replan), and the contingency planner's off-road cost
    is a pixel indicator, so a 1-ulp difference in a candidate point can
    flip a branch. The policies are held against the JAX package on one
    observation above, and the CLI's first replan against the JAX CLI's
    below."""
    shards = _scene_shards(tmp_path / "shards", hist_frames=10)
    rep = rollout.main(CLI_SCENE + ["--scene-data", shards, "--policy", policy,
                                    "--output", str(tmp_path)])
    assert rep["launches"]["lstm2_fwd"] == 0 and "guidance_satisfaction" not in rep
    args = rollout.parse_args(CLI_SCENE + ["--scene-data", shards, "--policy", policy])
    run = rollout.build(args)
    assert run.models is None
    _, want = tenv.simulate(run.pack, run.policy, run.sim_cfg)
    with np.load(tmp_path / "trajectories.npz") as f:
        got = f["trajectories"]
    assert np.isfinite(got).all() and got.shape == (10, 6, 4)
    np.testing.assert_array_equal(got, want.numpy())
    assert np.abs(np.diff(got[..., 0], axis=0)).max() > 0.1  # the agents move


# the JAX CLI's construction of the two solver policies (`rollout.py:503-515`)
JAX_SOLVERS = {
    "mpc": lambda sim, **kw: jmpc.mpc_policy(jmpc.MPCConfig(N=max(20, sim.n_step_action),
                                                            dt=sim.dt, **kw)),
    "contingency": lambda sim, **kw: jcont.contingency_policy(
        jcont.ContingencyConfig(dt=sim.dt, dyn=sim.dyn)),
}


@pytest.mark.parametrize("policy", ["mpc", "contingency"])
def test_rollout_cli_solver_policies_first_replan_matches_jax(policy, tmp_path, monkeypatch):
    """`--scene-data --policy mpc|contingency`, one replan (5 frames): the
    CLI's log against the JAX `simulate` of the policy built as the JAX CLI
    builds it, on the JAX package's scene pack of the same shards. Both
    policies see the same rendered observation bit for bit; what this holds
    is the CLI's wiring (the configs' horizon, rate and dynamics, the
    observation, the control interface). The fixture keeps each policy where
    it is continuous: the MPC runs 20 Adam iterations in both packages (the
    CLI's `MPCConfig` otherwise unchanged; at the record's 100 the plans
    part by 0.38 on this observation, as float32 and float64 do in one
    package) and its log is held within 2e-4 m [measured 1.7e-6]; the
    contingency planner runs on seed 1 with every pixel drivable, where each
    agent's two best root costs are either equal in both packages (argmin
    takes the first in both) or at least 4.05e-6 apart, 17 times the
    packages' largest root-cost difference, and its log is held within
    1e-4 m [measured 0]."""
    seed, atol, kw = (0, 2e-4, dict(iters=20)) if policy == "mpc" else (1, 1e-4, {})
    if kw:
        monkeypatch.setattr(tmpc, "MPCConfig", functools.partial(tmpc.MPCConfig, **kw))
    shards = _scene_shards(tmp_path / "shards", seed=seed, hist_frames=10, all_drivable=True)
    rollout.main(CLI_SCENE + ["--num-sim-steps", "5", "--scene-data", shards, "--policy", policy,
                              "--output", str(tmp_path)])
    pack = jscene.scene_pack_from_shards(shards, num_scenes=2, agents_per_scene=3, sim_steps=5)
    sim = jenv.SimConfig(num_simulation_steps=5, n_step_action=5, hist_frames=10, raster_size=64)
    _, want = jax.jit(lambda k: jenv.simulate(pack, JAX_SOLVERS[policy](sim, **kw), k, sim))(
        jax.random.key(1))
    with np.load(tmp_path / "trajectories.npz") as f:
        got = f["trajectories"]
    assert got.shape == (5, 6, 4) and np.abs(np.diff(got[..., 0], axis=0)).max() > 0.1
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


def test_rollout_cli_agents_policy_splits_ego_and_agents(tmp_path):
    """`--policy lattice --agents-policy gt_replay`: each scene's first
    agent plans with the lattice, the others replay exactly as under
    `--policy gt_replay`."""
    shards = _scene_shards(tmp_path / "shards", hist_frames=10)
    base = CLI_SCENE + ["--scene-data", shards]
    logs = {}
    runs = (("split", ["--policy", "lattice", "--agents-policy", "gt_replay"]),
            ("replay", ["--policy", "gt_replay"]), ("lattice", ["--policy", "lattice"]))
    for name, extra in runs:
        rollout.main(base + extra + ["--output", str(tmp_path / name)])
        with np.load(tmp_path / name / "trajectories.npz") as f:
            logs[name] = f["trajectories"]
    ego = np.arange(6) % 3 == 0
    np.testing.assert_array_equal(logs["split"][:, ~ego], logs["replay"][:, ~ego])
    np.testing.assert_array_equal(logs["split"][:, ego], logs["lattice"][:, ego])
    assert not np.allclose(logs["split"][:, ego], logs["replay"][:, ego])


def test_gt_replay_reproduces_the_reference_defect(tmp_path):
    """The reference's `replay_policy` serves the whole log as the plan, and
    the simulator reads frames 0-4 of it at every replan: uncontrolled agents
    follow the dataset (`gt_states`) exactly, controlled ones do not. Both
    packages, on `synthetic_batch(seed=1, batch_size=2, raster_size=64)`
    packed and loaded as one scene, 20 frames."""
    shards = _scene_shards(tmp_path / "shards", seed=1, bs=2)
    sim_j = jenv.SimConfig(num_simulation_steps=20, n_step_action=5, hist_frames=30,
                           raster_size=64)
    sim_t = tenv.SimConfig(num_simulation_steps=20, n_step_action=5, hist_frames=30,
                           raster_size=64)
    err = {}
    for controlled in (True, False):
        mask = np.full(2, controlled)
        jp = jscene.scene_pack_from_shards(shards, 1, 2, sim_steps=20, controlled_mask=mask)
        tp = tscene.scene_pack_from_shards(shards, 1, 2, sim_steps=20, controlled_mask=mask,
                                           device="cpu")
        _, want = jenv.simulate(jp, jhard.replay_policy(jp.replay_actions), jax.random.key(0),
                                sim_j)
        _, got = tenv.simulate(tp, thard.replay_policy(tp.replay_actions), sim_t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
        gt = tp.gt_states[:, 1:21].transpose(0, 1).numpy()
        err[controlled] = float(np.abs(got.numpy()[..., :2] - gt[..., :2]).max())
        err_jax = float(np.abs(np.asarray(want)[..., :2] - gt[..., :2]).max())
        assert err[controlled] == pytest.approx(err_jax, abs=1e-4)
    assert err[False] <= 1e-5
    assert err[True] > 0.1
