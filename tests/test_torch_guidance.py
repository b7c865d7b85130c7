"""The port's flagship guidance losses and perturbation step against the
JAX package: `AgentCollisionLoss` (scene blocks of 4, "diff" pairwise form)
and `MapCollisionLoss` (separable EDT), values and gradients with respect to
the trajectory, and one Adam `perturb` step.

Fixtures use curved, drifting trajectories that straddle the road edge and
overlap their scene neighbours, so both losses are active and their
gradients are clear of zero. Tolerances: losses rtol 1e-5 / atol 1e-6,
gradients rtol 1e-4 / atol 1e-6 (f32 with another summation order). The
perturbed latent is held at atol 1e-6: one Adam step from m = v = 0 moves
each component by lr * g / (|g| + eps), which only agrees when the
gradients' signs agree; the fixture's gradients are large enough for that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cld_tpu.guidance import losses as jlo
from cld_tpu.guidance import perturbation as jpt
from cld_tpu.ops.geometry import world_from_agent_matrix as jax_wfa
from cld_tpu_torch.guidance import losses as tlo
from cld_tpu_torch.guidance import perturbation as tpt
from cld_tpu_torch.ops.gather_kernels import pack_drivable_bits
from cld_tpu_torch.ops.geometry import raster_from_agent_matrix

torch.set_num_threads(2)
LOSS = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)

B, A, T = 8, 4, 12


def _scene(seed=0):
    rng = np.random.default_rng(seed)
    H = W = 64
    rfa = np.broadcast_to(raster_from_agent_matrix(H, 0.5, (-0.5, 0.0)), (B, 3, 3)).copy()
    ys = (np.arange(H, dtype=np.float32) - rfa[0, 1, 2]) * 0.5
    drv = np.broadcast_to((np.abs(ys) < 7.0).astype(np.float32)[None, :, None], (B, H, W)).copy()
    drv[:, :, 40:] *= (rng.random((B, H, W - 40)) < 0.8)  # ragged patches ahead
    t = np.arange(1, T + 1, dtype=np.float32)[None] * 0.1
    speed = rng.uniform(4, 9, (B, 1)).astype(np.float32)
    curv = rng.uniform(-0.4, 0.4, (B, 1)).astype(np.float32)
    y0 = rng.uniform(-7.5, 7.5, (B, 1)).astype(np.float32)
    yaw = curv * t * 3 + 0.05
    x = np.zeros((B, 1, T, 6), np.float32)
    x[:, 0, :, 0] = speed * t
    x[:, 0, :, 1] = y0 + 3 * curv * t**2
    x[:, 0, :, 2] = speed
    x[:, 0, :, 3] = yaw
    x[:, 0, :, 4] = rng.normal(size=(B, T))
    x[:, 0, :, 5] = rng.normal(size=(B, T)) * 0.1
    lane = (np.arange(B) % A).astype(np.float32)
    pos_w = np.stack([lane * 1.5, (lane % 2) * 1.2], -1).astype(np.float32)
    yaw_w = (lane * 0.2).astype(np.float32)
    extent = np.stack([rng.uniform(4, 5, B), rng.uniform(1.8, 2.2, B), np.full(B, 1.7)],
                      -1).astype(np.float32)
    cs = np.full(B, 5.0, np.float32)
    cs[3] = 0.1  # a stationary agent: masked out of both losses
    common = dict(drivable_map=drv, raster_from_agent=rfa, extent=extent, curr_speed=cs)
    jctx = jlo.GuidanceContext(**{k: jnp.asarray(v) for k, v in common.items()},
                               world_from_agent=jax_wfa(jnp.asarray(pos_w), jnp.asarray(yaw_w)),
                               scene_index=jnp.arange(B) // A)
    tctx = tlo.GuidanceContext(**{k: torch.from_numpy(v) for k, v in common.items()},
                               world_from_agent=torch.from_numpy(np.array(jctx.world_from_agent)),
                               scene_index=torch.arange(B) // A)
    return x, jctx, tctx


LOSSES = {
    "agent_collision": (jlo.AgentCollisionLoss(num_disks=5, buffer_dist=0.2, scene_block=A,
                                               pairwise_impl="diff"),
                        tlo.AgentCollisionLoss(num_disks=5, buffer_dist=0.2, scene_block=A)),
    "map_collision": (jlo.MapCollisionLoss(num_points_lw=(10, 10), min_dist_impl="separable"),
                      tlo.MapCollisionLoss(num_points_lw=(10, 10))),
    # the unpacked int8 drivable gather (Pallas kernel in interpret mode)
    "map_collision_px": (jlo.MapCollisionLoss(num_points_lw=(10, 10), gather_impl="pallas_px"),
                         tlo.MapCollisionLoss(num_points_lw=(10, 10), gather_impl="px")),
}
FLAGSHIP = ("agent_collision", "map_collision")


@pytest.mark.parametrize("name", sorted(LOSSES))
@pytest.mark.parametrize("packed", [False, True])
def test_loss_values_and_grads_match(name, packed):
    x, jctx, tctx = _scene()
    if packed:
        tctx = tlo.prepack_map_bbox(tctx._replace(
            drivable_packed=pack_drivable_bits(tctx.drivable_map)))
    jloss, tloss = LOSSES[name]
    want = jloss(jnp.asarray(x), jctx)
    wts = np.random.default_rng(1).uniform(0.5, 1.5, (B, 1)).astype(np.float32)
    gj = jax.grad(lambda v: jnp.sum(jloss(v, jctx) * wts))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tloss(xt, tctx)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **LOSS)
    assert float(np.abs(np.asarray(want)).sum()) > 0  # the fixture engages the loss
    (got * torch.from_numpy(wts)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), **GRAD)
    assert float(np.abs(np.asarray(gj)).max()) > 1e-3


def test_map_collision_gather_impls_agree_and_unknown_raises():
    x, _, tctx = _scene(3)
    xt = torch.from_numpy(x)
    bits, px = LOSSES["map_collision"][1], LOSSES["map_collision_px"][1]
    assert torch.equal(bits(xt, tctx), px(xt, tctx))
    with pytest.raises(ValueError, match="gather_impl"):
        tlo.MapCollisionLoss(gather_impl="pallas")(xt, tctx)


def test_perturb_step_matches():
    x, jctx, tctx = _scene(2)
    jspecs = [jpt.GuidanceSpec(LOSSES[k][0], 10.0) for k in FLAGSHIP]
    tspecs = [tpt.GuidanceSpec(LOSSES[k][1], 10.0) for k in FLAGSHIP]
    lat = x[:, 0]  # perturb the trajectory itself: decode = add the sample axis
    want = jpt.perturb(jnp.asarray(lat), jctx, jspecs, lambda v: v[:, None],
                       lr=0.3, grad_steps=1, perturb_th=jnp.float32(0.05))
    jtotal, _ = jpt.compute_guidance_loss(jnp.asarray(x), jctx, jspecs)
    ttotal, _ = tpt.compute_guidance_loss(torch.from_numpy(x), tctx, tspecs)
    np.testing.assert_allclose(float(ttotal), float(jtotal), **LOSS)
    g = tpt.guidance_gradient(torch.from_numpy(lat), tctx, tspecs, lambda v: v[:, None])
    gj = jax.grad(lambda v: jpt.compute_guidance_loss(v[:, None], jctx, jspecs)[0])(
        jnp.asarray(lat))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), **GRAD)
    got = tpt.perturb(torch.from_numpy(lat), tctx, tspecs, lambda v: v[:, None],
                      lr=0.3, grad_steps=1, perturb_th=torch.tensor(0.05))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert float(np.abs(got.numpy() - lat).max()) > 0.04  # the step moved x


def test_guidance_opt_schedule_matches():
    sig = np.exp(0.5 * np.linspace(-10, -1, 20)).astype(np.float32)
    for kw in (dict(lr=0.3, perturb_th=None), dict(lr=None, perturb_th=None),
               dict(lr=0.3, perturb_th=0.5), dict(lr=0.3, perturb_th=0.5, n_timesteps=20)):
        n = kw.pop("n_timesteps", None)
        for t in (0, 7, 19):
            lj, thj = jpt.guidance_opt_schedule(t, sigma_schedule=jnp.asarray(sig),
                                                n_timesteps=n, **kw)
            lt, tht = tpt.guidance_opt_schedule(t, sigma_schedule=torch.from_numpy(sig),
                                                n_timesteps=n, **kw)
            np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
            np.testing.assert_allclose(float(tht), float(thj), rtol=1e-6)
