"""The port's guidance rule library against the JAX package: the 15 rule
classes (values and gradients with respect to the trajectory, the STL rules
at soft and hard temperatures and on a fixture of exact ties, the target
speed's per-global-frame profile cut at a later frame), `affected_agents`
masking in `compute_guidance_loss`, the CLI grammar of `parsing`, the
scene heuristics, the satisfaction metrics, `codegen`, and the rollout CLI
with its editing sources in a process that imports no JAX.

Tolerances: losses rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-6
(f32, sums in other orders); heuristics' targets, which roll the dataset
future through the unicycle in both packages, rtol 1e-5 / atol 1e-4.
Fixtures keep every norm that a rule differentiates away from zero (there
both packages give a NaN gradient) and every threshold away from a flip.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cld_tpu.guidance import codegen as jcg
from cld_tpu.guidance import heuristics as jhe
from cld_tpu.guidance import losses as jlo
from cld_tpu.guidance import metrics as jme
from cld_tpu.guidance import parsing as jpa
from cld_tpu.guidance import perturbation as jpt
from cld_tpu.ops.geometry import world_from_agent_matrix as jax_wfa
from cld_tpu.sim import env as jenv
from cld_tpu.sim.scene import synthetic_scene_pack as jax_pack
from cld_tpu_torch.guidance import codegen as tcg
from cld_tpu_torch.guidance import heuristics as the
from cld_tpu_torch.guidance import losses as tlo
from cld_tpu_torch.guidance import metrics as tme
from cld_tpu_torch.guidance import parsing as tpa
from cld_tpu_torch.guidance import perturbation as tpt
from cld_tpu_torch.ops.geometry import raster_from_agent_matrix
from cld_tpu_torch.sim import env as tenv
from cld_tpu_torch.sim.scene import synthetic_scene_pack as torch_pack

torch.set_num_threads(2)
LOSS = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
B, N, T, TH, L = 8, 2, 12, 6, 5


def _ctx(seed=0, global_t=3):
    """(x [B, N, T, 6], JAX context, port context) with every optional field:
    curved trajectories, world poses, lane points (agent 7 without any),
    a world history in which agent 0 stopped in its box and stayed and
    agent 1 stopped and left."""
    rng = np.random.default_rng(seed)
    H = W = 64
    rfa = np.broadcast_to(raster_from_agent_matrix(H, 0.5, (-0.5, 0.0)), (B, 3, 3)).copy()
    drv = (rng.random((B, H, W)) < 0.8).astype(np.float32)
    t = np.arange(1, T + 1, dtype=np.float32)[None, None] * 0.1
    speed = rng.uniform(3, 9, (B, N, 1)).astype(np.float32)
    curv = rng.uniform(-0.4, 0.4, (B, N, 1)).astype(np.float32)
    x = np.zeros((B, N, T, 6), np.float32)
    x[..., 0] = speed * t + rng.normal(0, 0.05, (B, N, T))
    x[..., 1] = 3 * curv * t**2 + rng.uniform(-1, 1, (B, N, 1))
    x[..., 2] = speed + rng.normal(0, 0.5, (B, N, T))
    x[..., 3] = curv * t * 3 + 0.05
    x[..., 4] = rng.normal(0, 2.5, (B, N, T))
    x[..., 5] = rng.normal(0, 0.1, (B, N, T))
    pos_w = np.stack([np.arange(B) * 2.5, (np.arange(B) % 3) * 1.5], -1).astype(np.float32)
    yaw_w = (np.arange(B) * 0.15 - 0.3).astype(np.float32)
    extent = np.stack([rng.uniform(4, 5, B), rng.uniform(1.8, 2.2, B), np.full(B, 1.7)],
                      -1).astype(np.float32)
    lanes = np.zeros((B, L, 3), np.float32)
    lanes[..., 0] = np.linspace(-5, 15, L)[None]
    lanes[..., 1] = rng.uniform(-2, 2, (B, 1))
    lanes[..., 2] = rng.uniform(-0.2, 0.2, (B, L))
    avail = rng.random((B, L)) < 0.8
    avail[:, 0] = True
    avail[7] = False
    hist = np.zeros((B, TH, 4), np.float32)
    hist[..., :2] = pos_w[:, None] + rng.normal(0, 3.0, (B, TH, 2))
    hist[..., 2] = rng.uniform(2, 6, (B, TH))
    hist[0, 2:, :2], hist[0, 2:, 2] = pos_w[0] + 0.1, 0.1  # stopped in its box, still there
    hist[1, 1:4, :2], hist[1, 1:4, 2] = pos_w[1] + 0.1, 0.1  # stopped, then left
    hist[1, 4:, :2] = pos_w[1] + 20.0
    common = dict(drivable_map=drv, raster_from_agent=rfa, extent=extent,
                  curr_speed=np.full(B, 5.0, np.float32), lane_points=lanes, lane_avail=avail,
                  agent_hist_world=hist)
    wfa = np.array(jax_wfa(jnp.asarray(pos_w), jnp.asarray(yaw_w)))
    afw = np.linalg.inv(wfa).astype(np.float32)
    jctx = jlo.GuidanceContext(**{k: jnp.asarray(v) for k, v in common.items()},
                               world_from_agent=jnp.asarray(wfa), agent_from_world=jnp.asarray(afw),
                               scene_index=jnp.arange(B) // 4, global_t=jnp.int32(global_t))
    tctx = tlo.GuidanceContext(**{k: torch.from_numpy(v) for k, v in common.items()},
                               world_from_agent=torch.from_numpy(wfa),
                               agent_from_world=torch.from_numpy(afw),
                               scene_index=torch.arange(B) // 4, global_t=global_t)
    return x, jctx, tctx, pos_w


def _rules():
    """name -> (params) of one instance per rule class, the same numpy
    parameters for both packages."""
    rng = np.random.default_rng(7)
    _, _, _, pos_w = _ctx()
    tgt_w = pos_w + rng.uniform(5, 12, (B, 2)).astype(np.float32)
    tgt_w[2] = pos_w[2] + np.float32(0.5)  # reached: within the tolerance of 2
    box = dict(stop_sign_pos=np.tile(np.float32([0.8, 0.1]), (B, 1)),
               stop_box_dim=np.tile(np.float32([1.6, 3.0]), (B, 1)))
    gbox = dict(stop_sign_pos=pos_w + np.float32([0.8, 0.0]),
                stop_box_dim=np.tile(np.float32([4.0, 4.0]), (B, 1)))
    return {
        "target_speed": dict(target_speed=rng.uniform(3, 8, B).astype(np.float32)),
        "target_speed_profile": dict(target_speed=rng.uniform(3, 8, (B, 14)).astype(np.float32)),
        "agent_collision": dict(num_disks=5, buffer_dist=0.2),
        "map_collision": dict(num_points_lw=(6, 4)),
        "target_pos_at_time": dict(target_pos=rng.uniform(2, 6, (B, 2)).astype(np.float32),
                                   target_time=np.array([3, 11, 20, -2, 0, 5, 7, 9], np.int64)),
        "target_pos": dict(target_pos=rng.uniform(2, 6, (B, 2)).astype(np.float32),
                           min_target_time=0.3),
        "global_target_pos_at_time": dict(
            target_pos_world=tgt_w, target_time=np.array([5, 9, 40, 1, 14, 3, 20, 8], np.int64),
            urgency=rng.uniform(0.2, 0.8, B).astype(np.float32), pref_speed=1.5),
        "global_target_pos": dict(target_pos_world=tgt_w,
                                  urgency=rng.uniform(0.2, 0.8, B).astype(np.float32)),
        "acc_limit": dict(acc_limit=2.0),
        "speed_limit": dict(speed_limit=6.0),
        "stop_sign": dict(**box, num_time_steps_to_stop=2),
        "global_stop_sign": dict(**gbox, num_time_steps_to_stop=2, action_num=3),
        "keep_distance": dict(target_ind=0, ref_ind=5, min_dist=5.0, max_dist=8.0),
        "collision_attack": dict(attacker_ind=2, victim_ind=6, time_lo=2, time_hi=10),
        "social_group": dict(group=(3, 4, 6)),
        "lane_following": dict(pos_weight=1.0, yaw_weight=0.5),
    }


def _pair(name, **overrides):
    params = {**_rules()[name], **overrides}
    key = "target_speed" if name == "target_speed_profile" else name
    return jlo.GUIDANCE_LOSS_MAP[key](**params), tlo.GUIDANCE_LOSS_MAP[key](**params)


def _hold(jloss, tloss, x, jctx, tctx):
    """Loss values and the gradient of a weighted sum, both packages (the
    JAX side as one jitted compile, the trajectories and context passed as
    arguments)."""
    wts = np.random.default_rng(1).uniform(0.5, 1.5, (B, N)).astype(np.float32)

    def jax_side(v, c):
        return jloss(v, c), jax.grad(lambda u: jnp.sum(jloss(u, c) * wts))(v)

    want, gj = map(np.asarray, jax.jit(jax_side)(jnp.asarray(x), jctx))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tloss(xt, tctx)
    (got * torch.from_numpy(wts)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **LOSS)
    np.testing.assert_allclose(xt.grad.numpy(), gj, **GRAD)
    assert np.isfinite(gj).all()
    return want, gj


@pytest.mark.parametrize("name", sorted(_rules()))
def test_rule_values_and_gradients_match(name):
    x, jctx, tctx, _ = _ctx()
    want, gj = _hold(*_pair(name), x, jctx, tctx)
    assert float(np.abs(want).max()) > 0  # the fixture engages the rule
    assert float(np.abs(gj).max()) > 1e-4


@pytest.mark.parametrize("scale", [20.0, 8.0, 0.0, -1.0])
@pytest.mark.parametrize("name", ["stop_sign", "global_stop_sign"])
def test_stl_rules_at_soft_and_hard_temperatures(name, scale):
    x, jctx, tctx, _ = _ctx(seed=4)
    want, gj = _hold(*_pair(name, scale=scale), x, jctx, tctx)
    assert float(want.max()) > 0 and float(np.abs(gj).max()) > 1e-4


@pytest.mark.parametrize("name", ["stop_sign", "global_stop_sign"])
def test_stl_hard_min_splits_exact_ties_as_jax(name):
    """Hard min / max (scale 0) where the robustness is decided by exact
    ties: every agent sits at its box's centre, deep inside a 20 m box, at
    the same speed 6 at every step, so the windowed min and max and the
    min over the trace all tie across steps (and the margins to opposite
    edges tie). `torch.amin` / `amax` split a tie's gradient as `jnp.min` /
    `max` do; `torch.min(dim=)` would route all of it to one step."""
    x, jctx, tctx, _ = _ctx(seed=5)
    jl, tl = _pair(name, scale=0.0, stop_box_dim=np.full((B, 2), 20.0, np.float32))
    centre = np.asarray(jl.stop_sign_pos)  # the box centre in the trajectory's frame
    if name == "global_stop_sign":
        afw = tctx.agent_from_world.numpy()
        centre = np.einsum("bij,bj->bi", afw[:, :2, :2], centre) + afw[:, :2, 2]
    x[..., :2] = centre[:, None, None]
    x[..., 2] = 6.0
    want, gj = _hold(jl, tl, x, jctx, tctx)
    assert float(want.max()) > 0
    speed_grad = gj[..., 2][want > 0]  # [agents with a loss, T]: spread over the tied steps
    assert (np.abs(speed_grad) > 0).sum(axis=-1).min() > 1


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("global_t", [0, 5])
def test_target_speed_profile_cut_at_global_t(global_t, as_tensor):
    """A [B, T_fut] profile: the plan covers global frames global_t ..
    global_t + T - 1; frames past T_fut = 14 are masked. `global_t` is a
    Python int or a 0-d tensor in the port, a traced int32 in JAX."""
    x, jctx, tctx, _ = _ctx(global_t=global_t)
    if as_tensor:
        tctx = tctx._replace(global_t=torch.tensor(global_t))
    _hold(*_pair("target_speed_profile"), x, jctx, tctx)


def test_world_rules_without_optional_fields_match():
    """No agent_from_world (the inverse of world_from_agent), no global_t
    (frame 0) and no history (no stop latch)."""
    x, jctx, tctx, _ = _ctx()
    bare = dict(agent_from_world=None, global_t=None, agent_hist_world=None)
    for name in ("global_target_pos_at_time", "global_stop_sign", "target_speed_profile"):
        _hold(*_pair(name), x, jctx._replace(**bare), tctx._replace(**bare))


def test_compute_guidance_loss_means_agent_indexed_rules_over_their_agents():
    x, jctx, tctx, _ = _ctx(seed=2)
    names = ("keep_distance", "collision_attack", "social_group", "acc_limit")
    mask = tuple(bool(b) for b in np.arange(B) % 2 == 0)
    jspecs = [jpt.GuidanceSpec(_pair(n)[0], 2.0, mask if n == "acc_limit" else None)
              for n in names]
    tspecs = [tpt.GuidanceSpec(_pair(n)[1], 2.0, mask if n == "acc_limit" else None)
              for n in names]
    (want, jper), gj = jax.jit(lambda v, c: (
        jpt.compute_guidance_loss(v, c, jspecs),
        jax.grad(lambda u: jpt.compute_guidance_loss(u, c, jspecs)[0])(v)))(jnp.asarray(x), jctx)
    xt = torch.from_numpy(x).requires_grad_(True)
    got, tper = tpt.compute_guidance_loss(xt, tctx, tspecs)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **LOSS)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), **GRAD)
    assert sorted(tper) == sorted(jper)
    # the keep-distance rule alone: its one agent's mean, not a B-agent mean
    kd = tpt.compute_guidance_loss(torch.from_numpy(x), tctx, tspecs[:1])[0]
    np.testing.assert_allclose(float(kd), 2.0 * float(tper["KeepDistanceLoss_0"][0].mean()),
                               **LOSS)
    assert all(tpt.is_scene_level_spec(s) for s in tspecs[:3])
    assert not tpt.is_scene_level_spec(tspecs[3])


def _fields(loss):
    return {f.name: getattr(loss, f.name) for f in dataclasses.fields(loss)}


def _same_spec(js, ts):
    assert type(js.loss).__name__ == type(ts.loss).__name__
    assert js.weight == ts.weight and js.agent_mask == ts.agent_mask
    jf, tf = _fields(js.loss), _fields(ts.loss)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        if k == "gather_impl":  # the port's names of the drivable lookups
            assert tf[k] == {"auto": "bits", "pallas": "bits", "pallas_px": "px",
                             "jnp": "index"}[jf[k]]
        elif isinstance(jf[k], np.ndarray) or isinstance(tf[k], np.ndarray):
            np.testing.assert_allclose(np.asarray(tf[k]), np.asarray(jf[k]), rtol=1e-5,
                                       atol=1e-4, err_msg=k)
            assert np.asarray(tf[k]).dtype == np.asarray(jf[k]).dtype, k
        else:
            assert tf[k] == jf[k], k


# parameters for every name of the rule map, aliases included, in the
# reference's spellings where they differ
_CONFIG_PARAMS = {
    "target_speed": {"target_speed": 5.0},
    "agent_collision": {"buffer_dist": 0.3},
    "map_collision": {"num_points_lw": [4, 4]},
    "target_pos_at_time": {"target_pos": [1.0, 2.0], "target_time": 7},
    "target_pos": {"target_pos": [[1.0, 2.0]], "min_target_time": 0.2},
    "global_target_pos_at_time": {"target_pos": [3.0, 4.0], "target_time": 30, "urgency": 0.4},
    "global_target_pos": {"target_pos": [3.0, 4.0], "urgency": 0.4, "not_a_param": 1},
    "acc_limit": {"acc_limit": 1.5},
    "speed_limit": {"speed_limit": 12.0},
    "stop_sign": {"stop_box_center": [8.0, 0.0], "stop_box_dim": [4.0, 3.0]},
    "global_stop_sign": {"stop_sign_pos": [8.0, 0.0], "stop_box_dim": [4.0, 3.0]},
    "keep_distance": {"target_ind": 1, "ref_ind": 2, "min_distance": 3.0, "max_distance": 9.0},
    "collision_attack": {"target_ind": 0, "ref_ind": 3},
    "social_group": {"group": [0, 1, 2]},
    "lane_following": {"yaw_weight": 0.25},
    "gptcollision": {"target_ind": 2, "ref_ind": 1, "time_hi": 30},
    "gptkeepdistance": {"target_ind": 3, "ref_ind": 0, "max_distance": 20.0},
}


def test_every_rule_name_and_alias_parses_as_jax():
    assert sorted(tlo.GUIDANCE_LOSS_MAP) == sorted(jlo.GUIDANCE_LOSS_MAP) == sorted(
        _CONFIG_PARAMS)
    assert {v.__name__ for v in tlo.GUIDANCE_LOSS_MAP.values()} == {
        v.__name__ for v in jlo.GUIDANCE_LOSS_MAP.values()}
    configs = [{"name": k, "params": v, "weight": 1.5, "agents": [0, 3]}
               for k, v in _CONFIG_PARAMS.items()]
    arg = json.dumps(configs)
    assert tpa.parse_guidance_arg(arg) == jpa.parse_guidance_arg(arg)
    for js, ts in zip(jpa.specs_from_configs(configs, 4), tpa.specs_from_configs(configs, 4)):
        _same_spec(js, ts)
    made = tlo.make_guidance_losses([{"name": "speed_limit", "params": {"speed_limit": 3.0}}])
    assert made[0][0] == tlo.SpeedLimitLoss(3.0) and made[0][1:] == (1.0, None)


@pytest.mark.parametrize("arg", ["speed_limit:15,agent_collision", "acc_limit:2.5",
                                 "target_speed:4,lane_following:0.5,map_collision", "",
                                 '{"name": "speed_limit", "params": {"speed_limit": 9}}'])
def test_shorthand_and_json_grammar_match_jax(arg):
    assert tpa.parse_guidance_arg(arg) == jpa.parse_guidance_arg(arg)
    for js, ts in zip(jpa.specs_from_configs(jpa.parse_guidance_arg(arg), 3),
                      tpa.specs_from_configs(tpa.parse_guidance_arg(arg), 3)):
        _same_spec(js, ts)


def test_grammar_errors_and_files(tmp_path, monkeypatch):
    for bad in ("no_such_rule", "agent_collision:0.5"):
        with pytest.raises(ValueError):
            tpa.parse_guidance_arg(bad)
        with pytest.raises(ValueError):
            jpa.parse_guidance_arg(bad)
    with pytest.raises(ValueError, match="missing required params"):
        tpa.specs_from_configs([{"name": "target_pos"}], 2)
    path = tmp_path / "edits.json"
    path.write_text(json.dumps({"name": "speed_limit", "params": {"speed_limit": 7}}))
    assert tpa.parse_guidance_arg(f"@{path}") == jpa.parse_guidance_arg(f"@{path}")
    ypath = tmp_path / "edits.yaml"
    ypath.write_text("- name: acc_limit\n  params: {acc_limit: 1.0}\n")
    monkeypatch.setitem(sys.modules, "yaml", None)  # a machine without PyYAML
    with pytest.raises(RuntimeError, match="PyYAML"):
        tpa.parse_guidance_arg(f"@{ypath}")


@pytest.fixture(scope="module")
def packs():
    """The synthetic pack of both packages (the same numpy draws), its
    initial sim state, and the state 7 frames on."""
    kw = dict(seed=2, num_scenes=2, agents_per_scene=4, sim_steps=30)
    jp, tp = jax_pack(**kw), torch_pack(**kw, device="cpu")
    js = jenv.init_sim_state(jp, jenv.SimConfig())
    ts = tenv.init_sim_state(tp, tenv.SimConfig())
    return jp, tp, js, ts


@pytest.mark.parametrize("step", [0, 7])
@pytest.mark.parametrize("name", sorted(jhe.HEURISTIC_MAP))
def test_heuristics_match_jax_on_the_synthetic_pack(packs, name, step):
    jp, tp, js, ts = packs
    js, ts = js._replace(step=jnp.int32(step)), ts._replace(step=step)
    want = jhe.compute_heuristic_guidance([name], jp, js, dt=0.1)
    got = the.compute_heuristic_guidance([name], tp, ts, dt=0.1)
    assert len(got) == len(want)
    for j, t in zip(want, got):
        _same_spec(j, t)


def test_heuristic_pair_picker_and_reference_configs_match(packs):
    jp, tp, js, ts = packs
    for th, by_dist in ((0.4 * np.pi, True), (0.2 * np.pi, False), (0.01, True)):
        assert (the._select_interacting_pair(tp, ts, th, sort_by_distance=by_dist)
                == jhe._select_interacting_pair(jp, js, th, sort_by_distance=by_dist))
    configs = [
        {"name": "target_speed", "weight": 2.0,
         "params": {"target_speed_multiplier": 1.2, "fut_sec": 2.0}},
        {"name": "speed_limit", "weight": 1.0, "params": {"speed_limit_quantile": 0.9}},
        {"name": "agent_collision", "weight": 10.0, "params": {"excluded_agents": [0, 1]}},
        {"name": "global_target_pos", "weight": 1.0,
         "params": {"target_time": 20, "action_num": 4, "target_tolerance": 1.0}},
        {"name": "global_target_pos_at_time", "weight": 1.0,
         "params": {"target_time": 25, "perturb_std": 0.5, "seed": 3}},
        {"name": "stop_sign", "weight": 5.0,
         "params": {"target_time": 15, "stop_box_dim": [3.0, 2.0], "action_num": 5}},
        {"name": "global_stop_sign", "weight": 5.0,
         "params": {"target_time": 15, "stop_box_dim": [3.0, 2.0], "horizon_length": 30,
                    "dt": 0.2}},
        {"name": "social_group", "weight": 2.0, "params": {"group_dist_thresh": 40.0}},
    ]
    want = jhe.heuristics_from_configs(configs, jp, js)
    got = the.heuristics_from_configs(configs, tp, ts)
    assert len(got) == len(want) >= len(configs)
    for j, t in zip(want, got):
        _same_spec(j, t)
    with pytest.raises(ValueError):
        the.heuristics_from_configs([{"name": "stop_sign", "weight": 1.0,
                                      "params": {"excluded_agents": [0]}}], tp, ts)
    with pytest.raises(KeyError):
        the.heuristics_from_configs([{"name": "nope", "weight": 1.0, "params": {}}], tp, ts)


def test_guidance_metrics_match_jax():
    rng = np.random.default_rng(3)
    states = np.zeros((T, B, 4), np.float32)
    states[..., 0] = np.cumsum(rng.uniform(0.3, 0.9, (T, B)), 0)
    states[..., 1] = rng.normal(0, 0.2, (T, B))
    states[..., 2] = rng.uniform(2, 9, (T, B))
    states[..., 3] = rng.normal(0, 3.0, (T, B))  # yaws that wrap
    got_x = tme.executed_traj_from_states(torch.from_numpy(states))
    want_x = np.asarray(jme.executed_traj_from_states(jnp.asarray(states)))
    np.testing.assert_allclose(got_x.numpy(), want_x, rtol=1e-5, atol=1e-4)
    _, jctx, tctx, _ = _ctx()
    names = ("speed_limit", "acc_limit", "keep_distance", "lane_following", "target_speed")
    mask = tuple(bool(b) for b in np.arange(B) != 3)
    jspecs = [jpt.GuidanceSpec(_pair(n)[0], 1.0, mask) for n in names]
    tspecs = [tpt.GuidanceSpec(_pair(n)[1], 1.0, mask) for n in names]
    want = jme.guidance_metrics(jspecs, jnp.asarray(want_x), jctx)
    got = tme.guidance_metrics(tspecs, torch.from_numpy(np.array(want_x)), tctx)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
        assert np.isnan(got[k][3])


def test_loss_from_source_and_gated_query():
    src = ("def guidance_loss(x, ctx, agt_mask=None):\n"
           "    return torch.mean(torch.relu(torch.abs(x[..., 2]) - 4.0), dim=-1)\n")
    spec = tcg.loss_from_source(src, weight=3.0)
    x, _, tctx, _ = _ctx()
    got = spec.loss(torch.from_numpy(x), tctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(tlo.SpeedLimitLoss(4.0)(
        torch.from_numpy(x), tctx)), **LOSS)
    assert spec.weight == 3.0
    with pytest.raises(ValueError):
        tcg.loss_from_source("x = 1")
    for mod in (tcg, jcg):
        with pytest.raises(RuntimeError):
            mod.query_llm_for_loss("stop at the line")
    prompts = []
    spec = tcg.query_llm_for_loss("slow down", query_fn=lambda p: prompts.append(p) or src)
    assert "PyTorch" in prompts[0] and "JAX" not in prompts[0] and callable(spec.loss)


def test_rollout_cli_editing_sources_without_jax(tmp_path):
    """`python -m cld_tpu_torch.rollout` on the CPU at a tiny size with
    `--editing-source config,heuristic` (every rule class), `--attack-pair`,
    then `ui` edits with `--guide-as-filter-only`, in one process that fails
    if any JAX-side module got imported."""
    rules = [{"name": "acc_limit", "params": {"acc_limit": 2.0}},
             {"name": "keep_distance", "params": {"target_ind": 0, "ref_ind": 1}},
             {"name": "collision_attack", "params": {"attacker_ind": 2, "victim_ind": 3}},
             {"name": "social_group", "params": {"group": [0, 2]}}]
    ui = tmp_path / "ui.json"
    ui.write_text(json.dumps([{"name": "speed_limit", "params": {"speed_limit": 4.0}}]))
    heur = ",".join(sorted(jhe.HEURISTIC_MAP))
    code = f"""
import json, sys
from cld_tpu_torch import rollout
base = ["--device", "cpu", "--num-scenes", "1", "--agents-per-scene", "4", "--num-sim-steps",
        "5", "--raster-size", "64", "--hist-frames", "10", "--diffusion-steps", "3"]
a = rollout.main(base + ["--output", {str(tmp_path / 'a')!r}, "--editing-source",
                         "config,heuristic", "--guidance", {json.dumps(rules)!r},
                         "--heuristics", {heur!r}, "--attack-pair", "1,0"])
b = rollout.main(base + ["--output", {str(tmp_path / 'b')!r}, "--editing-source", "ui",
                         "--guidance", "none", "--ui-edits-file", {str(ui)!r},
                         "--guide-as-filter-only", "--num-action-samples", "2"])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "cld_tpu"))
print("RESULT=" + json.dumps(dict(a_rules=a["rules"], a_sat=a["guidance_satisfaction"],
                                  b_rules=b["rules"], b_sat=b["guidance_satisfaction"],
                                  bad=bad)))
"""
    env = dict(os.environ, PYTHONPATH=str(Path(tlo.__file__).parents[2]),
               OMP_NUM_THREADS="2")  # torch's threads, as this process's
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.split("RESULT=")[1].splitlines()[0])
    assert out["bad"] == []
    assert len(set(out["a_rules"])) == 15 and out["a_rules"][-1] == "CollisionAttackLoss"
    assert out["b_rules"] == ["SpeedLimitLoss"]
    for sat in (out["a_sat"], out["b_sat"]):
        assert all(np.isfinite(v) for v in sat.values())
    with np.load(tmp_path / "a" / "trajectories.npz") as f:
        assert f["trajectories"].shape == (5, 4, 4) and np.isfinite(f["trajectories"]).all()
    with pytest.raises(SystemExit):
        from cld_tpu_torch import rollout
        rollout.main(["--device", "cpu", "--editing-source", "bogus"])


def test_observation_context_fields_match_the_jax_policy(packs):
    """The world history that `make_dm_policy` hands the rules: the JAX
    rollout CLI's formula on the JAX observation, and the simulator's own
    world history, after 10 frames of turning."""
    from cld_tpu.ops.geometry import transform_points as jtp
    from cld_tpu_torch import pipeline

    jp, tp, _, _ = packs
    cfg_kw = dict(num_simulation_steps=10, n_step_action=5, hist_frames=8, raster_size=64)
    turning = lambda obs, rng: torch.tensor([1.0, 0.3]).expand(obs.curr_speed.shape[0], 52, 2)
    state, _ = tenv.simulate(tp, turning, tenv.SimConfig(**cfg_kw))
    obs = tenv.render_observation(tp, state, tenv.SimConfig(**cfg_kw))
    n = lambda t: jnp.asarray(t.numpy())
    jstate = jenv.SimState(n(state.states), n(state.history), jnp.int32(state.step),
                           n(state.offroad_steps), n(state.collision_steps),
                           n(state.collision_type_steps), n(state.max_abs_acc),
                           n(state.max_abs_yawvel))

    def jax_side(jstate):  # one jitted compile (the pack closed over, as `simulate` has it)
        jobs = jenv.render_observation(jp, jstate, jenv.SimConfig(**cfg_kw))
        wfa = jobs.world_from_agent
        dyaw = jnp.arctan2(wfa[:, 1, 0], wfa[:, 0, 0])
        return jnp.concatenate([jtp(jobs.history_positions, wfa), jobs.history_speeds[..., None],
                                jobs.history_yaws + dyaw[:, None, None]], axis=-1)

    want = jax.jit(jax_side)(jstate)
    got = pipeline.observation_context_fields(obs)
    np.testing.assert_allclose(got["agent_hist_world"].numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(got["agent_hist_world"].numpy(), state.history.numpy(),
                               rtol=1e-5, atol=1e-4)
    assert got["global_t"] == 10 and got["lane_points"] is obs.lane_points
    assert got["agent_from_world"] is obs.agent_from_world
