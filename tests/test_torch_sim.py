"""The port's closed-loop simulator (`cld_tpu_torch.sim`, with the geometry,
dynamics and lane helpers it needs) against the JAX package's
(`cld_tpu.sim`), at 2 scenes x 3 agents, raster 64, world map 256,
hist_frames 10, on the same numpy inputs.

Tolerances: elementwise f32 math on two libraries' CPU kernels, rtol 1e-6
(atol 1e-6 where values pass through zero); `render_observation` and the
trajectory logs of `simulate` compound a few transforms and up to 20
integration steps, rtol 1e-5. Booleans, integer indices and the metric
accumulators (counts of frames, maxima of clipped controls) are held
exactly; the fixtures keep agents clearly apart or clearly overlapping and
clearly on or off the road, so no threshold sits within rounding of a flip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cld_tpu.ops import dynamics as jd
from cld_tpu.ops import geometry as jg
from cld_tpu.ops import lanes as jl
from cld_tpu.policies import wrappers as jw
from cld_tpu.policies.common import Action as JaxAction
from cld_tpu.sim import env as jenv
from cld_tpu.sim import scene as jscene
from cld_tpu.sim.metrics import summarize_metrics as jax_summarize
from cld_tpu_torch.ops import dynamics as td
from cld_tpu_torch.ops import geometry as tg
from cld_tpu_torch.ops import lanes as tl
from cld_tpu_torch.policies import wrappers as tw
from cld_tpu_torch.policies.common import Action
from cld_tpu_torch.sim import env as tenv
from cld_tpu_torch.sim import scene as tscene
from cld_tpu_torch.sim.metrics import summarize_metrics

torch.set_num_threads(2)
T = torch.from_numpy
ELEM = dict(rtol=1e-6, atol=1e-6)
SIM = dict(rtol=1e-5, atol=1e-5)
PACK_KW = dict(seed=0, num_scenes=2, agents_per_scene=3, world_map_size=256, sim_steps=20)
CFG_KW = dict(num_simulation_steps=20, n_step_action=5, raster_size=64, hist_frames=10)
DYN = dict(max_steer=0.5, max_yawvel=2 * np.pi, acce_lo=-10.0, acce_hi=8.0)


@pytest.fixture(scope="module")
def packs():
    return jscene.synthetic_scene_pack(**PACK_KW), tscene.synthetic_scene_pack(**PACK_KW,
                                                                               device="cpu")


# ---------------------------------------------------------------- helpers

def test_frame_matrices_match_jax():
    rng = np.random.default_rng(0)
    pos = rng.uniform(-50, 50, (7, 2)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, 7).astype(np.float32)
    np.testing.assert_allclose(tg.agent_from_world_matrix(T(pos), T(yaw)).numpy(),
                               np.asarray(jg.agent_from_world_matrix(pos, yaw)), **ELEM)
    np.testing.assert_allclose(tg.rotation_matrix_2d(T(yaw)).numpy(),
                               np.asarray(jg.rotation_matrix_2d(yaw)), **ELEM)
    ident = tg.agent_from_world_matrix(T(pos), T(yaw)) @ tg.world_from_agent_matrix(T(pos), T(yaw))
    np.testing.assert_allclose(ident.numpy(), np.broadcast_to(np.eye(3), (7, 3, 3)), atol=1e-4)


@pytest.mark.parametrize("scale", [1.0, 1.3])
def test_obb_collision_matrix_matches_jax(scale):
    # boxes 4.5 x 2: pairs clearly overlapping (0-1 nose to tail, 2-3 crossed)
    # and clearly apart (4 alone; 5-6 side by side 2.6 m apart, which the
    # 1.3 scale closes)
    pos = np.array([[0, 0], [3.5, 0.3], [20, 20], [20.5, 21], [-30, 5], [40, 0], [40, 2.3]],
                   np.float32)
    yaw = np.array([0.0, 0.1, 0.3, 1.8, -2.0, 0.0, 0.0], np.float32)
    ext = np.broadcast_to(np.array([4.5, 2.0], np.float32), (7, 2)).copy()
    want = np.asarray(jg.obb_collision_matrix(pos, yaw, ext, extent_scale=scale))
    got = tg.obb_collision_matrix(T(pos), T(yaw), T(ext), extent_scale=scale).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 1] and got[2, 3] and not got[0, 4] and got.diagonal().all()
    assert got[5, 6] == (scale > 1.0)


def test_unicycle_step_and_ubound_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(9, 4)).astype(np.float32) * np.array([20, 20, 12, 2], np.float32)
    x[0, 2], x[1, 2], x[2, 2] = 0.0, 29.95, -9.9  # bounds bind: |v| floor and v limits
    u = rng.normal(size=(9, 2)).astype(np.float32) * np.array([9, 3], np.float32)
    jp, tp = jd.UnicycleParams(**DYN), td.UnicycleParams(**DYN)
    for a, b in zip(td.unicycle_ubound(tp, T(x)), jd.unicycle_ubound(jp, x)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    for bound in (True, False):
        np.testing.assert_allclose(
            td.unicycle_step(tp, T(x), T(u), 0.1, bound=bound).numpy(),
            np.asarray(jd.unicycle_step(jp, x, u, 0.1, bound=bound)), rtol=1e-6, atol=1e-6)


def test_angle_diff_and_inverse_dynamics_match_jax():
    rng = np.random.default_rng(2)
    a = rng.uniform(-7, 7, 50).astype(np.float32)
    b = rng.uniform(-7, 7, 50).astype(np.float32)
    np.testing.assert_allclose(td.angle_diff(T(a), T(b)).numpy(), np.asarray(jd.angle_diff(a, b)),
                               rtol=1e-5, atol=1e-6)
    traj = rng.normal(size=(4, 12, 3)).astype(np.float32)
    traj[..., :2] = np.cumsum(np.abs(traj[..., :2]), axis=1)
    v0 = rng.uniform(0, 10, 4).astype(np.float32)
    np.testing.assert_allclose(
        td.convert_state_to_state_and_action(T(traj), T(v0), 0.1).numpy(),
        np.asarray(jd.convert_state_to_state_and_action(traj, v0, 0.1)), rtol=1e-5, atol=1e-4)


def test_closest_lane_points_match_jax(packs):
    jp, tp = packs
    rng = np.random.default_rng(3)
    Na = 6
    pos = np.stack([rng.uniform(-60, 40, Na), rng.uniform(-5, 5, Na)], -1).astype(np.float32)
    yaw = rng.uniform(-0.6, 0.6, Na).astype(np.float32)
    yaw[0] = 2.5  # heading against every lane: no candidate survives
    pos[1, 0] = 90.0  # near the map's end: fewer than K candidates ahead
    si = np.array(jp.scene_index)
    want_p, want_a = jl.closest_lane_points(jp.lane_points[si], jp.lane_avail[si], pos, yaw,
                                            jg.agent_from_world_matrix(pos, yaw), k=16)
    got_p, got_a = tl.closest_lane_points(tp.lane_points[si], tp.lane_avail[si], T(pos), T(yaw),
                                          tg.agent_from_world_matrix(T(pos), T(yaw)), k=16)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-5, atol=1e-4)
    assert not got_a[0].any() and got_a[2].all() and 0 < got_a[1].sum() < 16
    pts, av = tl.straight_lane_polylines([-3.5, 3.5], -64.0, 64.0, max_points=40)
    pts_j, av_j = jl.straight_lane_polylines([-3.5, 3.5], -64.0, 64.0, max_points=40)
    np.testing.assert_array_equal(pts, pts_j)
    np.testing.assert_array_equal(av, av_j)


# ------------------------------------------------------------ scene + render

def test_synthetic_scene_pack_matches_jax_field_by_field(packs):
    jp, tp = packs
    assert jp._fields == tp._fields
    for name in jp._fields:
        a, b = getattr(tp, name), getattr(jp, name)
        if name == "map_resolution":
            assert a == b
            continue
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name == "gt_states":  # 20 bounded unicycle steps
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert tp.num_agents == 6 and tp.controlled_mask.tolist() == [True, False] * 3


def _jax_state(st):
    n = lambda t: jnp.asarray(t.numpy())
    return jenv.SimState(n(st.states), n(st.history), jnp.asarray(st.step, jnp.int32),
                         n(st.offroad_steps), n(st.collision_steps), n(st.collision_type_steps),
                         n(st.max_abs_acc), n(st.max_abs_yawvel))


def _turning(obs, rng):
    u = torch.zeros((obs.curr_speed.shape[0], 52, 2))
    u[..., 0], u[..., 1] = 1.0, 0.4
    return u


@pytest.mark.parametrize("frames", [0, 10, 15])
def test_render_observation_matches_jax_field_by_field(packs, frames):
    """Rendered from the same world state: the initial one, and states after
    10 and 15 frames of turning (yaws up to 0.6 rad; at 15 the dataset
    future runs past the episode's end and is zero-padded)."""
    jp, tp = packs
    cfg_j, cfg_t = jenv.SimConfig(**CFG_KW), tenv.SimConfig(**CFG_KW)
    state = tenv.init_sim_state(tp, cfg_t)
    if frames:
        run_cfg = tenv.SimConfig(**{**CFG_KW, "num_simulation_steps": frames})
        state, _ = tenv.simulate(tp, _turning, run_cfg)
    assert state.step == frames
    got = tenv.render_observation(tp, state, cfg_t)
    want = jenv.render_observation(jp, _jax_state(state), cfg_j)
    assert got._fields[:9] == ("image", "drivable_map", "raster_from_agent", "history_positions",
                               "history_yaws", "curr_speed", "extent",
                               "all_other_agents_future_positions",
                               "all_other_agents_future_availability")
    assert set(got._fields) == set(want._fields)
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        if name == "sim_step":
            assert a == int(b) == frames
            continue
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        if a.dtype == np.bool_ or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, err_msg=name, **SIM)
    assert got.image.shape == (6, 64, 64, 11 + 3)
    assert got.target_availabilities.sum() == 6 * min(52, 20 - frames)


def test_init_state_and_drivable_lookup_match_jax(packs):
    jp, tp = packs
    sj = jenv.init_sim_state(jp, jenv.SimConfig(**CFG_KW))
    st = tenv.init_sim_state(tp, tenv.SimConfig(**CFG_KW))
    np.testing.assert_allclose(st.history.numpy(), np.asarray(sj.history), **ELEM)
    rng = np.random.default_rng(4)
    pos = np.stack([rng.uniform(-70, 70, (5, 6)), rng.uniform(-20, 20, (5, 6))], -1)
    pos = pos.astype(np.float32)
    got = tenv.drivable_at_world(tp, T(pos)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jenv.drivable_at_world(jp, jnp.asarray(pos))))
    assert 0 < got.sum() < got.size


# ---------------------------------------------------------------- simulate

def _constant(lib, acc, yawvel):
    def policy(obs, rng):
        u = np.zeros((obs.curr_speed.shape[0], 52, 2), np.float32)
        u[..., 0], u[..., 1] = acc, yawvel
        return jnp.asarray(u) if lib == "jax" else T(u)
    return policy


def _nan(lib):
    """NaN controls for agent 0 from frame 2 of each plan: the guard
    freezes its controls to zero there."""
    def policy(obs, rng):
        u = np.full((obs.curr_speed.shape[0], 52, 2), 0.5, np.float32)
        u[0, 2:] = np.nan
        return jnp.asarray(u) if lib == "jax" else T(u)
    return policy


def _compare_runs(jp, tp, cfg_kw, pol_j, pol_t, key=None, noises=None):
    cfg_j, cfg_t = jenv.SimConfig(**cfg_kw), tenv.SimConfig(**cfg_kw)
    key = jax.random.key(0) if key is None else key
    sj, traj_j = jax.jit(lambda k: jenv.simulate(jp, pol_j, k, cfg_j))(key)
    st, traj_t = tenv.simulate(tp, pol_t, cfg_t, replan_noises=noises)
    assert traj_t.shape == (cfg_t.num_simulation_steps, tp.num_agents, 4)
    np.testing.assert_allclose(traj_t.numpy(), np.asarray(traj_j), **SIM)
    assert st.step == int(sj.step) == cfg_t.num_simulation_steps
    for name in ("offroad_steps", "collision_steps", "collision_type_steps"):
        np.testing.assert_array_equal(getattr(st, name).numpy(), np.asarray(getattr(sj, name)),
                                      err_msg=name)
    for name in ("max_abs_acc", "max_abs_yawvel", "states", "history"):
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(sj, name)),
                                   err_msg=name, **SIM)
    mj, mt = jax_summarize(jp, sj, cfg_j), summarize_metrics(tp, st, cfg_t)
    assert mj.keys() == mt.keys()
    for k in mj:
        assert mt[k] == pytest.approx(mj[k], rel=1e-6), k
    return st, mt


@pytest.mark.parametrize("acc,yawvel,steps", [(0.0, 0.0, 20), (2.0, 1.0, 40), (-12.0, -0.3, 20)])
def test_simulate_constant_policy_matches_jax(acc, yawvel, steps):
    kw = {**PACK_KW, "sim_steps": steps}
    jp, tp = jscene.synthetic_scene_pack(**kw), tscene.synthetic_scene_pack(**kw, device="cpu")
    cfg_kw = {**CFG_KW, "num_simulation_steps": steps}
    st, m = _compare_runs(jp, tp, cfg_kw, _constant("jax", acc, yawvel),
                          _constant("torch", acc, yawvel))
    if yawvel == 1.0:  # the hard turn leaves the road and breaks comfort
        assert m["offroad_rate"] > 0 and m["comfort_violation_rate"] > 0
    if acc == 0.0:
        assert m["offroad_rate"] == 0.0
    if acc == -12.0:  # the executed control is clipped to the bound, not -12
        assert float(st.max_abs_acc.max()) == pytest.approx(10.0)


def test_simulate_nan_policy_matches_jax(packs):
    jp, tp = packs
    st, _ = _compare_runs(jp, tp, CFG_KW, _nan("jax"), _nan("torch"))
    assert torch.isfinite(st.states).all()


def test_simulate_collision_metrics_match_jax():
    """Two controlled agents in one lane, the rear one much faster: front and
    rear collision frames are counted alike."""
    kw = dict(seed=1, num_scenes=1, agents_per_scene=2, world_map_size=256, sim_steps=40)
    jp, tp = jscene.synthetic_scene_pack(**kw), tscene.synthetic_scene_pack(**kw, device="cpu")
    init = np.array([[0.0, 0.0, 12.0, 0.0], [8.0, 0.0, 0.0, 0.0]], np.float32)
    jp = jp._replace(init_states=jnp.asarray(init), controlled_mask=jnp.ones(2, bool))
    tp = tp._replace(init_states=T(init), controlled_mask=torch.ones(2, dtype=torch.bool))
    st, m = _compare_runs(jp, tp, {**CFG_KW, "num_simulation_steps": 40},
                          _constant("jax", 0.0, 0.0), _constant("torch", 0.0, 0.0))
    ctype = st.collision_type_steps.numpy()
    assert ctype[0, 0] > 0 and ctype[1, 1] > 0 and (ctype[:, 2] == 0).all()
    assert m["collision_rate"] == 1.0 and m["collision_rate_side"] == 0.0


def _cruise(lib):
    """A plan without controls: straight ahead at the current speed."""
    xp = jnp if lib == "jax" else torch
    Act = JaxAction if lib == "jax" else Action

    def policy(obs, rng):
        t = xp.arange(1, 53) * 0.1
        x = obs.curr_speed[:, None] * t[None]
        pos = xp.stack([x, xp.zeros_like(x)], -1)
        return Act(positions=pos, yaws=xp.zeros_like(x)[..., None], controls=None)
    return policy


def test_simulate_ou_perturbed_hierarchical_policy_matches_jax(packs):
    """hierarchical(ou_perturbation(cruise)): OU noise on the plan, controls
    by inverse dynamics. The port gets the standard-normal draws the JAX
    wrappers make under `simulate`'s key schedule (one key per replan, split
    into the inner policy's key and the noise key)."""
    jp, tp = packs
    key = jax.random.key(5)
    pol_j = jw.hierarchical_policy(jw.ou_perturbation_policy(_cruise("jax")))
    pol_t = tw.hierarchical_policy(tw.ou_perturbation_policy(_cruise("torch")))
    noises = []
    for k in jax.random.split(key, 4):
        _, n_rng = jax.random.split(k)
        noises.append((None, T(np.array(jax.random.normal(n_rng, (6, 52, 3))))))
    st, _ = _compare_runs(jp, tp, CFG_KW, pol_j, pol_t, key=key, noises=noises)
    assert float(st.max_abs_yawvel.max()) > 0.01  # the noise reached the controls


def test_simulate_rejects_short_packs_and_ragged_cadence(packs):
    _, tp = packs
    with pytest.raises(ValueError, match="replay frames"):
        tenv.simulate(tp, _turning, tenv.SimConfig(**{**CFG_KW, "num_simulation_steps": 25}))
    with pytest.raises(ValueError, match="multiple"):
        tenv.simulate(tp, _turning, tenv.SimConfig(**{**CFG_KW, "num_simulation_steps": 18}))
    with pytest.raises(ValueError, match="replan_noises"):
        tenv.simulate(tp, _turning, tenv.SimConfig(**CFG_KW), replan_noises=[None])


def test_replay_agents_ignore_the_policy(packs):
    _, tp = packs
    cfg = tenv.SimConfig(**CFG_KW)
    _, a = tenv.simulate(tp, _constant("torch", 5.0, 0.0), cfg)
    _, b = tenv.simulate(tp, _constant("torch", -5.0, 0.0), cfg)
    replay = ~tp.controlled_mask
    assert torch.equal(a[:, replay], b[:, replay])
    assert (a[-1, tp.controlled_mask, 2] - b[-1, tp.controlled_mask, 2]).abs().min() > 1.0
