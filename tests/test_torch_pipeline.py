"""The whole slice against the JAX package: encode, 10-step DDPM sampling
(unguided, and guided by agent_collision + map_collision with one Adam step
per denoise step clipped to the posterior sigma), decode, reward — the
composition of `bench.py:bench_open_loop` — at B = 8 (2 scenes x 4
agents), raster 64, small widths. Both sides get the same weights (through
`cld_tpu_torch.utils.weights`) and the same noise: x_init and step_noises
are drawn with jax.random under the key schedule of `cld_tpu/algos/dm.py:
101-118` and handed to the port.

Tolerances (f32 networks on two libraries' CPU kernels):
* cond_feat and the rewards: rtol/atol 1e-4;
* latents and decoded trajectories: rtol 1e-4 with an absolute floor of
  1e-6 of the array's largest magnitude (random weights drive the latents
  to O(1000));
* guided latents: the floor is 1e-5 of the largest magnitude. One Adam step
  from m = v = 0 moves a component by ~lr * sign(g), clipped to sigma, so a
  gradient component near zero can take the other sign on the other side
  and move that component by up to 2 sigma. Measured on this fixture: max
  |diff| 6.5e-3 at a largest magnitude of 1009 (6.4e-6 of it); the decoded
  trajectories still agree to 1.4e-5 at a largest magnitude of 62;
* the guidance gradient at a fixed latent (before Adam): rtol 1e-4, atol
  1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cld_tpu.algos.dm import sample_traj as jax_sample
from cld_tpu.algos.reward import compute_reward as jax_reward
from cld_tpu.data.batch import get_current_states as jax_current
from cld_tpu.data.synthetic import synthetic_batch as jax_synthetic
from cld_tpu.guidance import losses as jlo
from cld_tpu.guidance import perturbation as jpt
from cld_tpu.models.temporal_unet import TemporalMapUnet as JaxUnet
from cld_tpu.models.vae import VaeModel, convert_action_to_state_and_action, decode_actions
from cld_tpu.ops.diffusion import make_schedule as jax_schedule
from cld_tpu.ops.dynamics import UnicycleParams as JaxDyn
from cld_tpu.ops.geometry import world_from_agent_matrix as jax_wfa
from cld_tpu.ops.normalization import TrajNormalizer as JaxNormalizer
from cld_tpu_torch import pipeline
from cld_tpu_torch.data.synthetic import synthetic_batch
from cld_tpu_torch.guidance import losses as tlo
from cld_tpu_torch.guidance import perturbation as tpt
from cld_tpu_torch.utils import weights as tw

torch.set_num_threads(2)
B, A, N_STEPS, T, L, COND = 8, 4, 10, 52, 4, 32
NET = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def slice_pair():
    jb = jax_synthetic(seed=0, batch_size=B, raster_size=64)
    vae = VaeModel(curr_state_feat_dim=16, map_feature_dim=32, cond_feat_dim=COND,
                   vae_hidden_size=16, vae_latent_size=L)
    vv = jax.jit(lambda r, b: vae.init(r, b, 0.05))(
        {"params": jax.random.key(0), "sample": jax.random.key(1)}, jb)
    vv = jax.tree.map(np.asarray, vv)
    unet = JaxUnet(transition_dim=L, output_dim=L, dim=8)
    uv = jax.jit(unet.init)(jax.random.key(2), jnp.zeros((B, T, L)), jnp.zeros((B, COND)),
                            jnp.zeros((B,), jnp.int32))
    uv = jax.tree.map(np.asarray, uv)
    models = pipeline.build_models(seed=0, device="cpu", cond_feat_dim=COND,
                                   map_feature_dim=32, curr_state_feat_dim=16,
                                   hidden_size=16, latent_size=L, base_dim=8,
                                   n_diffusion_steps=N_STEPS)
    tw.load_context_encoder(models.context, vv)
    tw.load_lstm_decoder(models.decoder, vv)
    tw.load_temporal_unet(models.unet, uv)
    return jb, vae, vv, unet, uv, models


def _jax_pipeline(jb, vae, vv, unet, uv, key, guided):
    """bench.py:335-376 at the fixture's widths (decoder impl "ref")."""
    schedule = jax_schedule(N_STEPS)
    dyn = JaxDyn(0.5, 2 * np.pi, -10.0, 8.0)
    normalizer = JaxNormalizer()
    cond = vae.apply(vv, jb, method=lambda m, b: m.context_encoder(b))["cond_feat"]
    curr = jax_current(jb)

    def decode_fn(z):
        acts = decode_actions(vae, vv, z, cond, impl="ref")
        return convert_action_to_state_and_action(
            acts, curr, dyn, normalizer, descaled_output=True)[:, None]

    gfn = None
    if guided:
        lane = (np.arange(B) % A).astype(np.float32)
        pos_w = jnp.asarray(np.stack([lane * 8.0, (lane % 2) * 3.5 - 1.75], -1))
        ctx = jlo.prepack_drivable(jlo.GuidanceContext(
            drivable_map=jb.drivable_map, raster_from_agent=jb.raster_from_agent,
            extent=jb.extent, curr_speed=jb.curr_speed,
            world_from_agent=jax_wfa(pos_w, jnp.zeros((B,))),
            scene_index=jnp.arange(B) // A))
        specs = [jpt.GuidanceSpec(jlo.AgentCollisionLoss(num_disks=5, buffer_dist=0.2,
                                                         scene_block=A), 10.0),
                 jpt.GuidanceSpec(jlo.MapCollisionLoss(num_points_lw=(10, 10)), 10.0)]
        gfn = jpt.make_perturbation_guidance(
            ctx, specs, decode_fn, lr=0.3, grad_steps=1, perturb_th=None,
            sigma_schedule=jnp.exp(0.5 * schedule.posterior_log_variance_clipped))
    out = jax_sample(lambda x, c, t: unet.apply(uv, x, c, t), schedule, key, cond, T, L,
                     guidance_fn=gfn)
    traj = decode_fn(out["pred_traj"])
    return (cond, out["pred_traj"], out["x1"], out["log_prob_final"], traj,
            jax_reward(traj, jb, normalizer.scale(traj)))


def _close(got, want, rtol, floor):
    """allclose with an absolute floor of `floor` times the array's largest
    magnitude: the random-weight sampler drives latents to O(1000), where a
    component near zero carries the rounding of its large neighbours."""
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor * np.abs(want).max())


def _jax_noise(key):
    """x_init and step_noises exactly as `cld_tpu.algos.dm.sample_traj` draws them."""
    rng, init_rng = jax.random.split(key)
    x_init = jax.random.normal(init_rng, (B, T, L), jnp.float32)
    noises = jax.vmap(lambda k: jax.random.normal(k, (B, T, L), jnp.float32))(
        jax.random.split(rng, N_STEPS))
    return torch.from_numpy(np.array(x_init)), torch.from_numpy(np.array(noises))


@pytest.mark.parametrize("guided", [False, True])
def test_slice_matches_jax(slice_pair, guided):
    jb, vae, vv, unet, uv, models = slice_pair
    key = jax.random.key(7)
    run = jax.jit(_jax_pipeline, static_argnums=(1, 3, 6))
    cond_j, pred_j, x1_j, logp_j, traj_j, rew_j = run(jb, vae, vv, unet, uv, key, guided)
    x_init, noises = _jax_noise(key)
    tb = synthetic_batch(seed=0, batch_size=B, raster_size=64, device="cpu")
    out = pipeline.guided_collect(models, tb, guided=guided, agents_per_scene=A,
                                  x_init=x_init, step_noises=noises)
    np.testing.assert_allclose(out["cond_feat"].numpy(), np.asarray(cond_j), **NET)
    assert torch.isfinite(out["traj"]).all() and out["traj"].shape == (B, 1, T, 6)
    pred_j, traj_j = np.asarray(pred_j), np.asarray(traj_j)
    _close(out["pred_traj"].numpy(), pred_j, 1e-4, 1e-5 if guided else 1e-6)
    _close(out["x1"].numpy(), np.asarray(x1_j), 1e-4, 1e-5 if guided else 1e-6)
    if not guided:  # the t=0 log-prob divides by sigma = 1e-10: held unguided only
        _close(out["log_prob_final"].numpy(), np.asarray(logp_j), 1e-4, 1e-6)
    _close(out["traj"].numpy(), traj_j, 1e-4, 1e-6)
    np.testing.assert_allclose(out["reward_per_agent"].numpy(), np.asarray(rew_j), **NET)
    assert out["launches"] == {"lstm2_fwd": 0, "lstm2_bwd": 0, "bit_gather": 0,
                               "value_gather": 0, "drivable_gather": 0}


def test_first_guidance_gradient_matches_jax(slice_pair):
    """The guidance gradient, before Adam, at the first guided step's
    posterior mean of the same latents."""
    jb, vae, vv, unet, uv, models = slice_pair
    tb = synthetic_batch(seed=0, batch_size=B, raster_size=64, device="cpu")
    z = np.random.default_rng(3).normal(size=(B, T, L)).astype(np.float32)
    dyn = JaxDyn(0.5, 2 * np.pi, -10.0, 8.0)
    cond = vae.apply(vv, jb, method=lambda m, b: m.context_encoder(b))["cond_feat"]
    curr = jax_current(jb)
    lane = (np.arange(B) % A).astype(np.float32)
    pos_w = jnp.asarray(np.stack([lane * 8.0, (lane % 2) * 3.5 - 1.75], -1))
    jctx = jlo.GuidanceContext(
        drivable_map=jb.drivable_map, raster_from_agent=jb.raster_from_agent,
        extent=jb.extent, curr_speed=jb.curr_speed,
        world_from_agent=jax_wfa(pos_w, jnp.zeros((B,))), scene_index=jnp.arange(B) // A)
    jspecs = [jpt.GuidanceSpec(jlo.AgentCollisionLoss(scene_block=A), 10.0),
              jpt.GuidanceSpec(jlo.MapCollisionLoss(), 10.0)]

    def cost(z):
        acts = decode_actions(vae, vv, z, cond, impl="interpret")
        traj = convert_action_to_state_and_action(acts, curr, dyn, JaxNormalizer(),
                                                  descaled_output=True)[:, None]
        return jpt.compute_guidance_loss(traj, jctx, jspecs)[0]

    gj = np.asarray(jax.jit(jax.grad(cost))(jnp.asarray(z)))

    with torch.no_grad():
        aux = models.context(tb)
    wfa, si = pipeline.scene_world_poses(B, A, "cpu")
    tctx = tlo.prepack_map_bbox(tlo.prepack_drivable(tlo.GuidanceContext(
        tb.drivable_map, tb.raster_from_agent, tb.extent, tb.curr_speed, wfa, si)))

    def decode_fn(v):
        acts = pipeline.decode_actions(models.decoder, v, aux["cond_feat"])
        return pipeline.convert_action_to_state_and_action(
            acts, aux["curr_states"], models.dyn, pipeline.TrajNormalizer(),
            descaled_output=True)[:, None]

    gt = tpt.guidance_gradient(torch.from_numpy(z), tctx,
                               pipeline.flagship_guidance_specs(A), decode_fn).numpy()
    assert np.abs(gj).max() > 1e-4
    np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-6)
