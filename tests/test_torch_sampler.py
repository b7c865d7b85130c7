"""The port's samplers and sample selection against the JAX package:
`sample_traj` with `num_samp`, `guidance_stride`, `guidance_clean` and
`guidance_output`; `sample_traj_ddim`; `choose_best_sample`,
`choose_closest_to_gt`, `per_sample_guidance_loss`, `perturb`'s SGD branch
and `guided_sampling_policy`.

Both sides run the same small analytic denoiser (weights from a numpy seed)
and the same guidance hook, and get the same noise: x_init and step_noises
are drawn with jax.random under the key schedules of
`cld_tpu/algos/dm.py:101-118` (DDPM) and `:183-189, 209` (DDIM) and handed
to the port. Tolerance: rtol 1e-5 / atol 1e-5 on latents after 12 chained
f32 steps (5e-5 for DDIM, whose first steps divide by sqrt(abar) ~ 0.03);
selection indices exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cld_tpu.algos import dm as jdm
from cld_tpu.guidance import losses as jlo
from cld_tpu.guidance import perturbation as jpt
from cld_tpu.ops.diffusion import make_schedule as jax_schedule
from cld_tpu.policies import wrappers as jwr
from cld_tpu_torch.algos import dm as tdm
from cld_tpu_torch.guidance import losses as tlo
from cld_tpu_torch.guidance import perturbation as tpt
from cld_tpu_torch.ops.diffusion import make_schedule
from cld_tpu_torch.policies import wrappers as twr
from test_torch_guidance import A, B, T, _scene

torch.set_num_threads(2)
N_STEPS, HZ, D, C = 12, 7, 3, 5
CHAIN = dict(rtol=1e-5, atol=1e-5)

_rng = np.random.default_rng(11)
W = (_rng.normal(size=(D, D)) * 0.5).astype(np.float32)
WC = (_rng.normal(size=(C, D)) * 0.5).astype(np.float32)
COND = _rng.normal(size=(4, C)).astype(np.float32)


def _jax_denoise(x, cond, t):
    return jnp.tanh(x @ W + (cond @ WC)[:, None, :] + jnp.sin(0.3 * t)[:, None, None])


def _torch_denoise(x, cond, t):
    return torch.tanh(x @ torch.from_numpy(W) + (cond @ torch.from_numpy(WC))[:, None, :]
                      + torch.sin(0.3 * t)[:, None, None])


def _hooks():
    """The same smooth perturbation on both sides, and a log of the port's
    calls. The JAX hook gets t as a [BN] array, the port's as an int."""
    calls = []

    def jhook(m, t):
        return m - 0.05 * (1.0 + t[0] / N_STEPS) * jnp.tanh(m)

    def thook(m, t):
        calls.append(t)
        return m - 0.05 * (1.0 + t / N_STEPS) * torch.tanh(m)

    return jhook, thook, calls


def _ddpm_noise(key, bn):
    rng, init_rng = jax.random.split(key)
    x_init = jax.random.normal(init_rng, (bn, HZ, D), jnp.float32)
    noises = jax.vmap(lambda k: jax.random.normal(k, (bn, HZ, D), jnp.float32))(
        jax.random.split(rng, N_STEPS))
    return torch.from_numpy(np.array(x_init)), torch.from_numpy(np.array(noises))


def _ddim_noise(key, bn, num_steps):
    rng, init_rng = jax.random.split(key)
    x_init = jax.random.normal(init_rng, (bn, HZ, D), jnp.float32)
    noises = jnp.stack([jax.random.normal(k, (bn, HZ, D), jnp.float32)
                        for k in jax.random.split(rng, num_steps)])
    return torch.from_numpy(np.array(x_init)), torch.from_numpy(np.array(noises))


def _expected_hook_steps(stride, output):
    """`cld_tpu/algos/dm.py:134-142`, written out."""
    return [i for i in range(N_STEPS - 1, -1, -1)
            if (stride <= 1 or i % stride == 0 or i < stride) and (output or i != 0)]


@pytest.mark.parametrize("stride,clean,output,num_samp", [
    (1, False, False, 1), (3, False, False, 1), (3, False, True, 1), (1, True, False, 1),
    (1, False, True, 2), (4, True, True, 2), (5, False, False, 1), (12, False, False, 1),
])
def test_sample_traj_options_match_jax(stride, clean, output, num_samp):
    jhook, thook, calls = _hooks()
    key = jax.random.key(3)
    want = jdm.sample_traj(_jax_denoise, jax_schedule(N_STEPS), key, jnp.asarray(COND), HZ, D,
                           num_samp=num_samp, guidance_fn=jhook, guidance_stride=stride,
                           guidance_clean=clean, guidance_output=output)
    x_init, noises = _ddpm_noise(key, 4 * num_samp)
    got = tdm.sample_traj(_torch_denoise, make_schedule(N_STEPS, device="cpu"),
                          torch.from_numpy(COND), HZ, D, num_samp=num_samp, guidance_fn=thook,
                          guidance_stride=stride, guidance_clean=clean, guidance_output=output,
                          x_init=x_init, step_noises=noises)
    assert calls == _expected_hook_steps(stride, output)
    assert calls == [i for i in range(N_STEPS - 1, -1, -1)
                     if tdm.guidance_applies(i, stride, output)]
    for k in ("pred_traj", "x1", "cond_feat"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **CHAIN)
    assert got["pred_traj"].shape == (4 * num_samp, HZ, D)
    if not output:  # at t = 0 sigma is 1e-10: the log-prob is held where no hook moves the mean
        np.testing.assert_allclose(got["log_prob_final"].numpy(),
                                   np.asarray(want["log_prob_final"]), rtol=1e-5)


def test_sample_traj_unguided_ignores_the_switches_and_checks_noise_shapes():
    x_init, noises = _ddpm_noise(jax.random.key(5), 4)
    sched = make_schedule(N_STEPS, device="cpu")
    run = lambda **kw: tdm.sample_traj(_torch_denoise, sched, torch.from_numpy(COND), HZ, D,
                                       x_init=x_init, step_noises=noises, **kw)["pred_traj"]
    assert torch.equal(run(), run(guidance_stride=3, guidance_clean=True, guidance_output=True))
    with pytest.raises(ValueError, match="expected"):
        tdm.sample_traj(_torch_denoise, sched, torch.from_numpy(COND), HZ, D, num_samp=2,
                        x_init=x_init, step_noises=noises)


@pytest.mark.parametrize("num_steps,eta,num_samp", [(5, 0.0, 1), (6, 0.7, 2), (12, 1.0, 1),
                                                    (4, 0.3, 3)])
def test_sample_traj_ddim_matches_jax(num_steps, eta, num_samp):
    jhook, thook, calls = _hooks()
    key = jax.random.key(9)
    want = jdm.sample_traj_ddim(_jax_denoise, jax_schedule(N_STEPS), key, jnp.asarray(COND), HZ,
                                D, num_samp=num_samp, num_steps=num_steps, eta=eta,
                                guidance_fn=jhook)
    x_init, noises = _ddim_noise(key, 4 * num_samp, num_steps)
    got = tdm.sample_traj_ddim(_torch_denoise, make_schedule(N_STEPS, device="cpu"),
                               torch.from_numpy(COND), HZ, D, num_samp=num_samp,
                               num_steps=num_steps, eta=eta, guidance_fn=thook,
                               x_init=x_init, step_noises=noises)
    ts = np.asarray(jnp.linspace(N_STEPS - 1, 0, num_steps).round().astype(jnp.int32))
    assert calls == ts.tolist()  # the hook runs at every DDIM step, the last included
    np.testing.assert_array_equal(tdm.ddim_timesteps(N_STEPS, num_steps), ts)
    np.testing.assert_allclose(got["pred_traj"].numpy(), np.asarray(want["pred_traj"]),
                               rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(got["cond_feat"].numpy(), np.asarray(want["cond_feat"]))
    if eta == 0.0:  # deterministic: the step noises do not enter
        again = tdm.sample_traj_ddim(_torch_denoise, make_schedule(N_STEPS, device="cpu"),
                                     torch.from_numpy(COND), HZ, D, num_samp=num_samp,
                                     num_steps=num_steps, guidance_fn=thook, x_init=x_init,
                                     step_noises=noises * 3.0)
        assert torch.equal(again["pred_traj"], got["pred_traj"])


@pytest.mark.parametrize("n,steps", [(100, 50), (100, 10), (6, 3), (10, 4), (12, 5), (100, 7),
                                     (11, 5), (4, 4)])
def test_ddim_timesteps_round_half_to_even_as_jax(n, steps):
    want = np.asarray(jnp.linspace(n - 1, 0, steps).round().astype(jnp.int32))
    np.testing.assert_array_equal(tdm.ddim_timesteps(n, steps), want)


def test_guided_sampler_with_real_hook_and_two_samples_matches_jax():
    """`make_perturbation_guidance` inside `sample_traj` at `num_samp` 2, a
    stride of 2 and an explicit `perturb_th` with its sigmoid decay: the
    latents are trajectories ([BN, T, 6] -> [B, N, T, 6]). Held at atol 1e-4:
    Adam moves a component by ~lr * sign(g), and the fixture's gradient
    components are zero exactly or clear of zero."""
    x, jctx, tctx = _scene(2)
    jspecs = [jpt.GuidanceSpec(jlo.AgentCollisionLoss(scene_block=A), 10.0),
              jpt.GuidanceSpec(jlo.MapCollisionLoss(min_dist_impl="rigid_pallas"), 10.0)]
    tspecs = [tpt.GuidanceSpec(tlo.AgentCollisionLoss(scene_block=A), 10.0),
              tpt.GuidanceSpec(tlo.MapCollisionLoss(min_dist_impl="rigid_kernel",
                                                    gather_impl="index"), 10.0)]
    n, N = 6, 2
    base = np.repeat(x[:, 0], N, axis=0)  # [BN, T, 6]
    jsch, tsch = jax_schedule(n), make_schedule(n, device="cpu")
    abar = np.asarray(jsch.alphas_cumprod)
    sa, sb = np.sqrt(abar).astype(np.float32), np.sqrt(1 - abar).astype(np.float32)
    # the ideal denoiser of x0 = base: the chain stays near the fixture's trajectories
    jden = lambda z, c, t: (z - jnp.asarray(sa)[t[0]] * jnp.asarray(base)) / jnp.asarray(sb)[t[0]]
    tden = lambda z, c, t: (z - float(sa[int(t[0])]) * torch.from_numpy(base)) / float(sb[int(t[0])])
    kw = dict(lr=0.05, grad_steps=2, perturb_th=0.02, n_timesteps=n)
    jg = jpt.make_perturbation_guidance(
        jctx, jspecs, lambda z: z.reshape(B, N, T, 6),
        sigma_schedule=jnp.exp(0.5 * jsch.posterior_log_variance_clipped), **kw)
    tg = tpt.make_perturbation_guidance(
        tctx, tspecs, lambda z: z.reshape(B, N, T, 6),
        sigma_schedule=torch.exp(0.5 * tsch.posterior_log_variance_clipped), **kw)
    key = jax.random.key(1)
    cond = np.zeros((B, 2), np.float32)
    want = jdm.sample_traj(jden, jsch, key, jnp.asarray(cond), T, 6, num_samp=N,
                           guidance_fn=jg, guidance_stride=2)
    rng, init_rng = jax.random.split(key)
    x_init = np.array(jax.random.normal(init_rng, (B * N, T, 6), jnp.float32))
    noises = np.array(jax.vmap(lambda k: jax.random.normal(k, (B * N, T, 6), jnp.float32))(
        jax.random.split(rng, n)))
    got = tdm.sample_traj(tden, tsch, torch.from_numpy(cond), T, 6, num_samp=N, guidance_fn=tg,
                          guidance_stride=2, x_init=torch.from_numpy(x_init),
                          step_noises=torch.from_numpy(noises))
    # the ideal denoiser's last step returns x0 whatever came before: x1 carries the guidance
    for k in ("x1", "pred_traj"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    unguided = tdm.sample_traj(tden, tsch, torch.from_numpy(cond), T, 6, num_samp=N,
                               x_init=torch.from_numpy(x_init),
                               step_noises=torch.from_numpy(noises))
    assert float((got["x1"] - unguided["x1"]).abs().max()) > 1e-2


def test_perturb_sgd_matches_jax_and_unknown_optimizer_raises():
    x, jctx, tctx = _scene(2)
    jspecs = [jpt.GuidanceSpec(jlo.MapCollisionLoss(), 10.0)]
    tspecs = [tpt.GuidanceSpec(tlo.MapCollisionLoss(), 10.0)]
    lat = x[:, 0]
    want = jax.jit(lambda v, c: jpt.perturb(v, c, jspecs, lambda v: v[:, None], lr=5.0,
                                            grad_steps=3, perturb_th=jnp.float32(0.3),
                                            optimizer="sgd"))(jnp.asarray(lat), jctx)
    got = tpt.perturb(torch.from_numpy(lat), tctx, tspecs, lambda v: v[:, None], lr=5.0,
                      grad_steps=3, perturb_th=0.3, optimizer="sgd")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    assert 0.1 < float(np.abs(got.numpy() - lat).max()) <= 0.3 + 1e-6  # moved, and clipped
    with pytest.raises(NotImplementedError):
        tpt.perturb(torch.from_numpy(lat), tctx, tspecs, lambda v: v[:, None], optimizer="lbfgs")


def test_make_perturbation_guidance_prepack_rules():
    _, _, tctx = _scene()
    seen = {}

    class Probe(tlo.MapCollisionLoss):
        def __call__(self, x, ctx, agt_mask=None):
            seen["ctx"] = ctx
            return super().__call__(x, ctx, agt_mask)

    x = torch.from_numpy(_scene()[0])[:, 0]
    for impl, has_d2 in (("separable", False), ("separable_xy", False), ("rigid", True),
                         ("rigid_kernel", True), ("pairwise", True)):
        hook = tpt.make_perturbation_guidance(
            tctx, [tpt.GuidanceSpec(Probe(min_dist_impl=impl))], lambda v: v[:, None],
            perturb_th=0.1)
        hook(x, 3)
        ctx = seen["ctx"]
        assert ctx.drivable_packed is not None and ctx.bbox_pts.shape == (B, 10, 10, 2)
        assert (ctx.bbox_d2 is not None) == has_d2, impl
    two = [tpt.GuidanceSpec(tlo.MapCollisionLoss(num_points_lw=(10, 10))),
           tpt.GuidanceSpec(tlo.MapCollisionLoss(num_points_lw=(20, 5)))]
    with pytest.raises(ValueError, match="one grid per context"):
        tpt.make_perturbation_guidance(tctx, two, lambda v: v[:, None])


def _selection_fixture(seed=0, Bn=6, N=4):
    rng = np.random.default_rng(seed)
    samples = rng.normal(size=(Bn, N, 5, 6)).astype(np.float32)
    losses = rng.normal(size=(Bn, N)).astype(np.float32)
    losses[2] = losses[2, 0]  # a row of ties: the first index wins
    scene = np.array([0, 0, 0, 1, 1, 2])
    return samples, losses, scene


@pytest.mark.parametrize("scene_level", [False, True])
def test_choose_best_sample_matches_jax(scene_level):
    samples, losses, scene = _selection_fixture()
    bj, ij = jpt.choose_best_sample(jnp.asarray(samples), jnp.asarray(losses),
                                    jnp.asarray(scene), scene_level)
    bt, it = tpt.choose_best_sample(torch.from_numpy(samples), torch.from_numpy(losses),
                                    torch.from_numpy(scene), scene_level)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    if scene_level:
        assert len(set(it[:3].tolist())) == 1 and len(set(it[3:5].tolist())) == 1


def test_choose_closest_to_gt_matches_jax():
    samples, _, _ = _selection_fixture(1)
    rng = np.random.default_rng(2)
    gt = rng.normal(size=(6, 5, 2)).astype(np.float32)
    avail = rng.random((6, 5)) > 0.3
    avail[4] = False  # no valid ground truth: sample 0
    bj, ij = jpt.choose_closest_to_gt(jnp.asarray(samples), jnp.asarray(samples[..., :2]),
                                      jnp.asarray(gt), jnp.asarray(avail))
    bt, it = tpt.choose_closest_to_gt(torch.from_numpy(samples),
                                      torch.from_numpy(samples[..., :2]),
                                      torch.from_numpy(gt), torch.from_numpy(avail))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    assert int(it[4]) == 0


def _two_sample_trajs():
    x, jctx, tctx = _scene(5)
    return np.concatenate([x, x + np.float32(0.8), x - np.float32(0.5)], axis=1), jctx, tctx


def test_per_sample_guidance_loss_and_scene_level_rule_match_jax():
    trajs, jctx, tctx = _two_sample_trajs()
    mask = tuple(bool(b % 2) for b in range(B))
    jspecs = [jpt.GuidanceSpec(jlo.AgentCollisionLoss(scene_block=A), 10.0),
              jpt.GuidanceSpec(jlo.MapCollisionLoss(), 3.0, agent_mask=mask)]
    tspecs = [tpt.GuidanceSpec(tlo.AgentCollisionLoss(scene_block=A), 10.0),
              tpt.GuidanceSpec(tlo.MapCollisionLoss(), 3.0, agent_mask=mask)]
    want, jt = jax.jit(lambda x, c: (jpt.per_sample_guidance_loss(x, c, jspecs),
                                     jpt.compute_guidance_loss(x, c, jspecs)[0]))(
        jnp.asarray(trajs), jctx)
    got = tpt.per_sample_guidance_loss(torch.from_numpy(trajs), tctx, tspecs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert [tpt.is_scene_level_spec(s) for s in tspecs] == [True, False]
    assert [jpt.is_scene_level_spec(s) for s in jspecs] == [True, False]
    tt, _ = tpt.compute_guidance_loss(torch.from_numpy(trajs), tctx, tspecs)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5)


@pytest.mark.parametrize("scene_coupled", [False, True])
def test_guided_sampling_policy_matches_jax(scene_coupled):
    trajs, jctx, tctx = _two_sample_trajs()
    jspecs = [jpt.GuidanceSpec(jlo.MapCollisionLoss(), 1.0)]
    tspecs = [tpt.GuidanceSpec(tlo.MapCollisionLoss(), 1.0)]
    if scene_coupled:
        jspecs.append(jpt.GuidanceSpec(jlo.AgentCollisionLoss(scene_block=A), 10.0))
        tspecs.append(tpt.GuidanceSpec(tlo.AgentCollisionLoss(scene_block=A), 10.0))
    ja = jax.jit(lambda x, c: jwr.guided_sampling_policy(lambda o, r: x, jspecs, lambda o: c)(
        None, None))(jnp.asarray(trajs), jctx)
    ta = twr.guided_sampling_policy(lambda o, r: torch.from_numpy(trajs), tspecs,
                                    lambda o: tctx)(None, None)
    for name in ("positions", "yaws", "controls"):
        np.testing.assert_array_equal(getattr(ta, name).numpy(), np.asarray(getattr(ja, name)),
                                      err_msg=name)
    assert ta.positions.shape == (B, T, 2) and ta.controls.shape == (B, T, 2)
