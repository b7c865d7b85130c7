"""The port's policies against the JAX package: the wrappers of
`cld_tpu_torch.policies.wrappers`, and the diffusion policy
`pipeline.make_dm_policy` alone (one replan) and inside `sim.env.simulate`
(two replans), against the policy of `bench.py:bench_closed_loop` at
2 scenes x 3 agents, raster 64, world map 256, hist_frames 10, 10 DDPM
steps, small widths. Both sides get the same weights (through
`cld_tpu_torch.utils.weights`) and the same noise, drawn with jax.random
under the key schedule of `simulate` (one key per replan), the policy (the
key splits into encode and sample keys) and `sample_traj`.

Tolerances:
* wrappers: elementwise f32, rtol 1e-6 / atol 1e-6;
* one replan, planned controls and positions: rtol 1e-4 with an absolute
  floor of 1e-5 of the array's largest magnitude, unguided and guided (the
  observation agrees to 1e-5, the networks to 1e-4; guided latents carry
  Adam's sign amplification, which the decoder and the action bounds
  squash, as in `tests/test_torch_pipeline.py`);
* two replans, the trajectory log: unguided rtol 1e-5 / atol 1e-5 as in
  `tests/test_torch_sim.py`. Guided: atol 2e-5 on states of magnitude up
  to 78, five times the measured floor. After the first replan the two
  packages' world states differ at the 1e-6 level, and a guidance gradient
  component near zero may take the other sign in the second. Measured on
  this fixture: max |diff| 3.8e-6 guided, 9.5e-7 unguided;
* planned yaws (cumulative sums of small yaw rates, magnitude 0.02): rtol
  1e-4 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cld_tpu.algos.dm import sample_traj as jax_sample
from cld_tpu.data.batch import get_current_states as jax_current
from cld_tpu.guidance import losses as jlo
from cld_tpu.guidance import perturbation as jpt
from cld_tpu.models.temporal_unet import TemporalMapUnet as JaxUnet
from cld_tpu.models.vae import VaeModel, convert_action_to_state_and_action, decode_actions
from cld_tpu.ops.diffusion import make_schedule as jax_schedule
from cld_tpu.ops.dynamics import UnicycleParams as JaxDyn
from cld_tpu.ops.normalization import TrajNormalizer as JaxNormalizer
from cld_tpu.policies import common as jc
from cld_tpu.policies import wrappers as jw
from cld_tpu.sim import env as jenv
from cld_tpu.sim import scene as jscene
from cld_tpu_torch import pipeline
from cld_tpu_torch.ops import native
from cld_tpu_torch.policies import common as tc
from cld_tpu_torch.policies import wrappers as tw
from cld_tpu_torch.sim import env as tenv
from cld_tpu_torch.sim import scene as tscene
from cld_tpu_torch.utils import weights as twt

torch.set_num_threads(2)
Tn = torch.from_numpy
ELEM = dict(rtol=1e-6, atol=1e-6)
Na, A, N_STEPS, T, L, COND = 6, 3, 10, 52, 4, 32
PACK_KW = dict(seed=0, num_scenes=2, agents_per_scene=A, world_map_size=256, sim_steps=20)
CFG_KW = dict(num_simulation_steps=10, n_step_action=5, raster_size=64, hist_frames=10)


# ---------------------------------------------------------------- wrappers

def _plan(seed, B=5, Tp=9, controls=True):
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.uniform(-0.05, 0.6, (B, Tp, 2)), axis=1).astype(np.float32)
    pos[0] = 0.001 * np.arange(Tp)[:, None]  # too slow for a heading: yaw held at 0
    pos[1, 4:] = pos[1, 3]  # stops after step 3: the last heading is held
    yaws = rng.uniform(-1, 1, (B, Tp, 1)).astype(np.float32)
    ctr = rng.normal(size=(B, Tp, 2)).astype(np.float32) if controls else None
    return pos, yaws, ctr


def _pair(seed, **kw):
    pos, yaws, ctr = _plan(seed, **kw)
    ja = jc.Action(jnp.asarray(pos), jnp.asarray(yaws), None if ctr is None else jnp.asarray(ctr))
    ta = tc.Action(Tn(pos), Tn(yaws), None if ctr is None else Tn(ctr))
    return (lambda obs, rng: ja), (lambda obs, rng: ta)


def _same_action(got, want, **tol):
    for name in ("positions", "yaws", "controls"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **(tol or ELEM))


def test_action_from_trajectory_matches_jax():
    traj = np.random.default_rng(0).normal(size=(3, 7, 6)).astype(np.float32)
    _same_action(tc.action_from_trajectory(Tn(traj)), jc.action_from_trajectory(jnp.asarray(traj)))


def test_pos2yaw_policy_matches_jax():
    pj, pt = _pair(1)
    got = tw.pos2yaw_policy(pt)(None, None)
    _same_action(got, jw.pos2yaw_policy(pj)(None, jax.random.key(0)), rtol=1e-5, atol=1e-6)
    assert (got.yaws[0] == 0).all() and (got.yaws[1, 4:] == got.yaws[1, 3]).all()


@pytest.mark.parametrize("controls", [True, False])
def test_masked_policy_matches_jax(controls):
    (pj_a, pt_a), (pj_b, pt_b) = _pair(2, Tp=9), _pair(3, Tp=7, controls=controls)
    mask = np.array([True, False, True, True, False])
    got = tw.masked_policy(Tn(mask), pt_a, pt_b)(None, None)
    _same_action(got, jw.masked_policy(jnp.asarray(mask), pj_a, pj_b)(None, jax.random.key(0)))
    assert got.positions.shape == (5, 7, 2) and (got.controls is None) == (not controls)


def test_masked_policy_hands_each_side_its_rng():
    seen = []
    pol = lambda tag: lambda obs, rng: (seen.append((tag, rng)), _pair(4)[1](obs, rng))[1]
    tw.masked_policy(torch.ones(5, dtype=torch.bool), pol("a"), pol("b"))(None, ("ra", "rb"))
    g = torch.Generator()
    tw.masked_policy(torch.ones(5, dtype=torch.bool), pol("a"), pol("b"))(None, g)
    assert seen == [("a", "ra"), ("b", "rb"), ("a", g), ("b", g)]
    with pytest.raises(ValueError):
        tw.masked_policy(torch.ones(5, dtype=torch.bool), pol("a"), pol("b"))(None, (1, 2, 3))


def test_ou_noise_and_perturbation_match_jax():
    key = jax.random.key(3)
    shape = (5, 9, 3)
    eps = Tn(np.array(jax.random.normal(key, shape)))
    np.testing.assert_allclose(tw.ou_noise(eps, shape).numpy(), np.asarray(jw.ou_noise(key, shape)),
                               **ELEM)
    with pytest.raises(ValueError):
        tw.ou_noise(eps, (5, 9, 2))
    drawn = tw.ou_noise(torch.Generator().manual_seed(0), (4, 6, 3), device="cpu")
    assert drawn.shape == (4, 6, 3) and (drawn[..., 0] == 0).all() and drawn[..., 2].std() > 0.05
    pj, pt = _pair(5)
    a_key, n_key = jax.random.split(key)
    noise = Tn(np.array(jax.random.normal(n_key, shape)))
    got = tw.ou_perturbation_policy(pt)(None, (None, noise))
    _same_action(got, jw.ou_perturbation_policy(pj)(None, key), rtol=1e-5, atol=1e-6)
    assert got.controls is None


def test_hierarchical_policy_and_with_kwargs_match_jax():
    class Obs:
        curr_speed = None

    v0 = np.random.default_rng(6).uniform(0, 8, 5).astype(np.float32)
    pj, pt = _pair(6, controls=False)
    oj, ot = Obs(), Obs()
    oj.curr_speed, ot.curr_speed = jnp.asarray(v0), Tn(v0)
    got = tw.hierarchical_policy(pt)(ot, None)
    _same_action(got, jw.hierarchical_policy(pj)(oj, jax.random.key(0)), rtol=1e-5, atol=1e-4)
    assert got.controls.shape == (5, 9, 2)
    pj2, pt2 = _pair(7)  # a plan that carries controls passes through
    assert tw.hierarchical_policy(pt2)(ot, None) is pt2(None, None)
    assert tw.with_kwargs(lambda obs, rng, scale: scale * 2, scale=3)(None, None) == 6


# ------------------------------------------------------- the diffusion policy

@pytest.fixture(scope="module")
def loop_pair():
    jp = jscene.synthetic_scene_pack(**PACK_KW)
    tp = tscene.synthetic_scene_pack(**PACK_KW, device="cpu")
    jcfg, tcfg = jenv.SimConfig(**CFG_KW), tenv.SimConfig(**CFG_KW)
    obs0 = jenv.render_observation(jp, jenv.init_sim_state(jp, jcfg), jcfg)
    vae = VaeModel(curr_state_feat_dim=16, map_feature_dim=32, cond_feat_dim=COND,
                   vae_hidden_size=16, vae_latent_size=L)
    vv = jax.jit(lambda r, b: vae.init(r, b, 0.05))(
        {"params": jax.random.key(0), "sample": jax.random.key(1)}, obs0)
    vv = jax.tree.map(np.asarray, vv)
    unet = JaxUnet(transition_dim=L, output_dim=L, dim=8)
    uv = jax.jit(unet.init)(jax.random.key(2), jnp.zeros((Na, T, L)), jnp.zeros((Na, COND)),
                            jnp.zeros((Na,), jnp.int32))
    uv = jax.tree.map(np.asarray, uv)
    models = pipeline.build_models(seed=0, device="cpu", raster_channels=14, cond_feat_dim=COND,
                                   map_feature_dim=32, curr_state_feat_dim=16, hidden_size=16,
                                   latent_size=L, base_dim=8, n_diffusion_steps=N_STEPS)
    twt.load_context_encoder(models.context, vv)
    twt.load_lstm_decoder(models.decoder, vv)
    twt.load_temporal_unet(models.unet, uv)
    return jp, tp, jcfg, tcfg, vae, vv, unet, uv, models


def _jax_policy(vae, vv, unet, uv, guided):
    """`bench.py:551-598` at the fixture's widths, `num_samp` 1, returning
    the whole decoded plan [Na, T, 6]."""
    schedule = jax_schedule(N_STEPS)
    dyn = JaxDyn(0.5, 2 * np.pi, -10.0, 8.0)
    normalizer = JaxNormalizer()
    specs = [jpt.GuidanceSpec(jlo.AgentCollisionLoss(num_disks=5, buffer_dist=0.2,
                                                     scene_block=A), 10.0),
             jpt.GuidanceSpec(jlo.MapCollisionLoss(num_points_lw=(10, 10)), 10.0)]

    def policy(obs, rng):
        _, samp_rng = jax.random.split(rng)
        cond = vae.apply(vv, obs, method=lambda m, b: m.context_encoder(b))["cond_feat"]
        curr = jax_current(obs)

        def decode_fn(z):
            acts = decode_actions(vae, vv, z, cond, impl="ref")
            return convert_action_to_state_and_action(
                acts, curr, dyn, normalizer, descaled_output=True)[:, None]

        gfn = None
        if guided:
            ctx = jlo.prepack_drivable(jlo.GuidanceContext(
                drivable_map=obs.drivable_map, raster_from_agent=obs.raster_from_agent,
                extent=obs.extent, curr_speed=obs.curr_speed,
                world_from_agent=obs.world_from_agent, scene_index=obs.scene_index))
            gfn = jpt.make_perturbation_guidance(
                ctx, specs, decode_fn, lr=0.3, grad_steps=1, perturb_th=None,
                sigma_schedule=jnp.exp(0.5 * schedule.posterior_log_variance_clipped))
        out = jax_sample(lambda x, c, t: unet.apply(uv, x, c, t), schedule, samp_rng, cond, T, L,
                         guidance_fn=gfn)
        return decode_fn(out["pred_traj"])[:, 0]

    return policy


def _replan_noise(replan_key):
    """x_init and step_noises as the JAX policy and `sample_traj` draw them
    from one replan's key."""
    _, samp_rng = jax.random.split(replan_key)
    rng, init_rng = jax.random.split(samp_rng)
    x_init = jax.random.normal(init_rng, (Na, T, L), jnp.float32)
    noises = jax.vmap(lambda k: jax.random.normal(k, (Na, T, L), jnp.float32))(
        jax.random.split(rng, N_STEPS))
    return {"x_init": Tn(np.array(x_init)), "step_noises": Tn(np.array(noises))}


def _close(got, want, rtol, floor):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor * np.abs(want).max())


@pytest.mark.parametrize("guided", [False, True])
def test_one_replan_matches_jax(loop_pair, guided):
    jp, tp, jcfg, tcfg, vae, vv, unet, uv, models = loop_pair
    key = jax.random.key(11)
    obs_j = jenv.render_observation(jp, jenv.init_sim_state(jp, jcfg), jcfg)
    want = np.asarray(jax.jit(_jax_policy(vae, vv, unet, uv, guided))(obs_j, key))
    obs_t = tenv.render_observation(tp, tenv.init_sim_state(tp, tcfg), tcfg)
    native.reset_launch_counts()
    got = pipeline.make_dm_policy(models, A, guided=guided)(obs_t, _replan_noise(key))
    assert got.controls.shape == (Na, T, 2) and torch.isfinite(got.controls).all()
    _close(got.controls.numpy(), want[..., 4:6], 1e-4, 1e-5)
    _close(got.positions.numpy(), want[..., :2], 1e-4, 1e-5)
    np.testing.assert_allclose(got.yaws.numpy(), want[..., 3:4], rtol=1e-4, atol=1e-6)
    assert native.launch_counts() == {k: 0 for k in native.KERNELS}  # CPU: plain versions


@pytest.mark.parametrize("guided", [False, True])
def test_two_replan_loop_matches_jax(loop_pair, guided):
    jp, tp, jcfg, tcfg, vae, vv, unet, uv, models = loop_pair
    key = jax.random.key(12)
    pol_j = _jax_policy(vae, vv, unet, uv, guided)
    run = jax.jit(lambda k: jenv.simulate(jp, lambda o, r: pol_j(o, r)[:, :, 4:6], k, jcfg))
    sj, traj_j = run(key)
    noises = [_replan_noise(k) for k in jax.random.split(key, jcfg.num_replans)]
    st, traj_t = tenv.simulate(tp, pipeline.make_dm_policy(models, A, guided=guided), tcfg,
                               replan_noises=noises)
    assert traj_t.shape == (10, Na, 4) and torch.isfinite(traj_t).all()
    tol = dict(rtol=1e-5, atol=2e-5) if guided else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(traj_t.numpy(), np.asarray(traj_j), **tol)
    for name in ("offroad_steps", "collision_steps", "collision_type_steps"):
        np.testing.assert_array_equal(getattr(st, name).numpy(), np.asarray(getattr(sj, name)))
    np.testing.assert_allclose(st.max_abs_acc.numpy(), np.asarray(sj.max_abs_acc), rtol=1e-4,
                               atol=1e-4)


def test_dm_policy_draws_from_a_generator_and_guidance_changes_the_plan(loop_pair):
    _, tp, _, tcfg, *_, models = loop_pair
    obs = tenv.render_observation(tp, tenv.init_sim_state(tp, tcfg), tcfg)
    g = torch.Generator()
    plans = {}
    for guided in (False, True):
        pol = pipeline.make_dm_policy(models, A, guided=guided)
        a = pol(obs, g.manual_seed(1))
        b = pol(obs, g.manual_seed(1))
        assert torch.equal(a.controls, b.controls)  # same seed, same plan
        assert not torch.equal(a.controls, pol(obs, g.manual_seed(2)).controls)
        plans[guided] = a
    assert not torch.equal(plans[True].controls, plans[False].controls)
    px = pipeline.make_dm_policy(models, A, specs=pipeline.flagship_guidance_specs(A, "px"))
    assert torch.equal(px(obs, g.manual_seed(1)).controls, plans[True].controls)


def test_flat_state_dict_round_trip_loads_strict(loop_pair, tmp_path):
    """Converted weights saved as one .npz (what `rollout --weights` reads)
    load into fresh modules and give the fixture's own weights."""
    *_, vv, _, uv, models = loop_pair
    sd = {**twt.export_vae_checkpoint(vv), **twt.export_dm_checkpoint(uv)}
    np.savez(tmp_path / "w.npz", **sd)
    fresh = pipeline.build_models(seed=9, device="cpu", raster_channels=14, cond_feat_dim=COND,
                                  map_feature_dim=32, curr_state_feat_dim=16, hidden_size=16,
                                  latent_size=L, base_dim=8, n_diffusion_steps=N_STEPS)
    with np.load(tmp_path / "w.npz") as f:
        twt.load_state_dicts(fresh.context, fresh.decoder, fresh.unet, dict(f))
    for name in ("context", "decoder", "unet"):
        a, b = getattr(fresh, name).state_dict(), getattr(models, name).state_dict()
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a), name
