"""The whole slice against the JAX package: encode, 10-step DDPM sampling
(unguided, and guided by agent_collision + map_collision with one Adam step
per denoise step clipped to the posterior sigma), decode, reward — the
composition of `bench.py:bench_open_loop` — at B = 8 (2 scenes x 4
agents), raster 64, small widths. The guided call also runs with the map
loss under `min_dist_impl="rigid_kernel"` against the JAX package's
"rigid_pallas" (its Pallas kernels in interpret mode), and once as
`rollout.py:make_dm_policy` composes it: DDIM, two samples per agent, the
best kept. Both sides get the same weights (through
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
from cld_tpu_torch.ops import native
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


def _jax_pipeline(jb, vae, vv, unet, uv, key, guided, min_dist_impl="separable"):
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
                 jpt.GuidanceSpec(jlo.MapCollisionLoss(num_points_lw=(10, 10),
                                                       min_dist_impl=min_dist_impl), 10.0)]
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


@pytest.mark.parametrize("guided,min_dist", [(False, "separable"), (True, "separable"),
                                             (True, "rigid_pallas")])
def test_slice_matches_jax(slice_pair, guided, min_dist):
    jb, vae, vv, unet, uv, models = slice_pair
    key = jax.random.key(7)
    run = jax.jit(_jax_pipeline, static_argnums=(1, 3, 6, 7))
    cond_j, pred_j, x1_j, logp_j, traj_j, rew_j = run(jb, vae, vv, unet, uv, key, guided,
                                                      min_dist)
    x_init, noises = _jax_noise(key)
    tb = synthetic_batch(seed=0, batch_size=B, raster_size=64, device="cpu")
    specs = None
    if min_dist == "rigid_pallas":
        specs = pipeline.flagship_guidance_specs(A, min_dist_impl="rigid_kernel")
    out = pipeline.guided_collect(models, tb, guided=guided, agents_per_scene=A,
                                  x_init=x_init, step_noises=noises, specs=specs)
    np.testing.assert_allclose(out["cond_feat"].numpy(), np.asarray(cond_j), **NET)
    assert torch.isfinite(out["traj"]).all() and out["traj"].shape == (B, 1, T, 6)
    pred_j, traj_j = np.asarray(pred_j), np.asarray(traj_j)
    _close(out["pred_traj"].numpy(), pred_j, 1e-4, 1e-5 if guided else 1e-6)
    _close(out["x1"].numpy(), np.asarray(x1_j), 1e-4, 1e-5 if guided else 1e-6)
    if not guided:  # the t=0 log-prob divides by sigma = 1e-10: held unguided only
        _close(out["log_prob_final"].numpy(), np.asarray(logp_j), 1e-4, 1e-6)
    _close(out["traj"].numpy(), traj_j, 1e-4, 1e-6)
    np.testing.assert_allclose(out["reward_per_agent"].numpy(), np.asarray(rew_j), **NET)
    assert out["launches"] == {k: 0 for k in native.KERNELS}  # CPU: plain versions


@pytest.mark.parametrize("min_dist", ["separable", "rigid_pallas"])
def test_first_guidance_gradient_matches_jax(slice_pair, min_dist):
    """The guidance gradient, before Adam, at the first guided step's
    posterior mean of the same latents ("rigid_pallas": the port's
    "rigid_kernel", both winner-take-all on ties)."""
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
              jpt.GuidanceSpec(jlo.MapCollisionLoss(min_dist_impl=min_dist), 10.0)]

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

    tspecs = pipeline.flagship_guidance_specs(
        A, min_dist_impl={"rigid_pallas": "rigid_kernel"}.get(min_dist, min_dist))
    gt = tpt.guidance_gradient(torch.from_numpy(z), tctx, tspecs, decode_fn).numpy()
    assert np.abs(gj).max() > 1e-4
    np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-6)


def test_ddim_two_samples_best_kept_matches_jax(slice_pair):
    """`sample_plans` as `rollout.py:make_dm_policy` composes it: DDIM (5
    steps, eta 0.5), two samples per agent, stride-free guidance with an
    explicit `perturb_th`, then the sample with the lowest total guidance
    loss (one index per scene: agent_collision couples the agents). Latents
    rtol 1e-4 with a floor of 1e-4 of the largest magnitude: two Adam steps
    per denoise step move a component by up to 2 * lr whatever the size of
    its gradient (measured: 0.039 at a largest magnitude of 1200, 3.3e-5 of
    it). Trajectories rtol 1e-4 with a floor of 5e-5: DDIM guides its last
    step too, so a flipped component reaches the output undamped (measured:
    9.3e-4 at a largest magnitude of 63, 1.5e-5 of it). The kept index exactly,
    in the scenes whose two samples' losses are clear of a tie."""
    jb, vae, vv, unet, uv, models = slice_pair
    N, steps, eta = 2, 5, 0.5
    key = jax.random.key(11)
    opts = pipeline.SamplingOptions(num_samp=N, sampler="ddim", ddim_steps=steps, ddim_eta=eta,
                                    guidance_lr=0.1, guidance_steps=2, perturb_th=0.5)

    def jax_run(jb, key):
        schedule = jax_schedule(N_STEPS)
        dyn = JaxDyn(0.5, 2 * np.pi, -10.0, 8.0)
        cond = vae.apply(vv, jb, method=lambda m, b: m.context_encoder(b))["cond_feat"]
        cond_rep = jnp.repeat(cond, N, axis=0)
        curr_rep = jnp.repeat(jax_current(jb), N, axis=0)

        def decode_fn(z):
            acts = decode_actions(vae, vv, z, cond_rep, impl="ref")
            traj = convert_action_to_state_and_action(acts, curr_rep, dyn, JaxNormalizer(),
                                                      descaled_output=True)
            return traj.reshape(B, N, *traj.shape[1:])

        lane = (np.arange(B) % A).astype(np.float32)
        pos_w = jnp.asarray(np.stack([lane * 8.0, (lane % 2) * 3.5 - 1.75], -1))
        ctx = jlo.GuidanceContext(
            drivable_map=jb.drivable_map, raster_from_agent=jb.raster_from_agent,
            extent=jb.extent, curr_speed=jb.curr_speed,
            world_from_agent=jax_wfa(pos_w, jnp.zeros((B,))), scene_index=jnp.arange(B) // A)
        specs = [jpt.GuidanceSpec(jlo.AgentCollisionLoss(num_disks=5, buffer_dist=0.2,
                                                         scene_block=A), 10.0),
                 jpt.GuidanceSpec(jlo.MapCollisionLoss(num_points_lw=(10, 10)), 10.0)]
        gfn = jpt.make_perturbation_guidance(
            ctx, specs, decode_fn, lr=0.1, grad_steps=2, perturb_th=0.5,
            sigma_schedule=jnp.exp(0.5 * schedule.posterior_log_variance_clipped),
            n_timesteps=N_STEPS)
        from cld_tpu.algos.dm import sample_traj_ddim
        out = sample_traj_ddim(lambda x, c, t: unet.apply(uv, x, c, t), schedule, key, cond, T, L,
                               num_samp=N, num_steps=steps, eta=eta, guidance_fn=gfn)
        traj = decode_fn(out["pred_traj"])
        losses = jpt.per_sample_guidance_loss(traj, ctx, specs)
        best, idx = jpt.choose_best_sample(traj, losses, scene_index=ctx.scene_index,
                                           scene_level=True)
        return out["pred_traj"], traj, losses, best, idx

    pred_j, traj_j, loss_j, best_j, idx_j = jax.jit(jax_run)(jb, key)
    rng, init_rng = jax.random.split(key)
    x_init = torch.from_numpy(np.array(jax.random.normal(init_rng, (B * N, T, L), jnp.float32)))
    noises = torch.from_numpy(np.array(jnp.stack(
        [jax.random.normal(k, (B * N, T, L), jnp.float32) for k in jax.random.split(rng, steps)])))
    tb = synthetic_batch(seed=0, batch_size=B, raster_size=64, device="cpu")
    out = pipeline.guided_collect(models, tb, guided=True, agents_per_scene=A, x_init=x_init,
                                  step_noises=noises, options=opts)
    assert out["traj"].shape == (B, N, T, 6) and out["best"].shape == (B, T, 6)
    assert "x1" not in out and out["reward_per_agent"].shape == (B * N,)
    _close(out["pred_traj"].numpy(), np.asarray(pred_j), 1e-4, 1e-4)
    _close(out["traj"].numpy(), np.asarray(traj_j), 1e-4, 5e-5)
    # the pick is well defined where a scene's two samples are clear of a tie
    gap = np.abs(np.diff(np.asarray(loss_j).reshape(B // A, A, N).sum(1), axis=-1))[:, 0]
    clear = np.repeat(gap > 1e-3, A)
    assert clear.any()
    np.testing.assert_array_equal(out["best_index"].numpy()[clear], np.asarray(idx_j)[clear])
    idx = out["best_index"]
    assert torch.equal(out["best"], out["traj"][torch.arange(B), idx])
    assert all(len(set(idx[s * A:(s + 1) * A].tolist())) == 1 for s in range(B // A))
    _close(out["best"].numpy()[clear], np.asarray(best_j)[clear], 1e-4, 5e-5)
    # the closed loop's policy executes the same sample
    obs = tb._replace(world_from_agent=pipeline.scene_world_poses(B, A, "cpu")[0],
                      scene_index=pipeline.scene_world_poses(B, A, "cpu")[1])
    act = pipeline.make_dm_policy(models, A, options=opts)(
        obs, {"x_init": x_init, "step_noises": noises})
    assert torch.equal(act.controls, out["best"][..., 4:6])
