"""The port's numeric core against the JAX package: geometry,
normalization, unicycle dynamics (values and gradients), the diffusion
schedule and posterior, and the synthetic batch.

Tolerances: elementwise f32 math at rtol 1e-6 / atol 1e-6 (same ops, the
two libraries' transcendentals may differ by an ulp); the cumsum dynamics
at rtol 1e-5 / atol 1e-5 (52-step float32 prefix sums, ~1e-6 relative per
add); the synthetic batch exactly (the same numpy draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cld_tpu.data.batch import get_current_states as jax_current
from cld_tpu.data.synthetic import synthetic_batch as jax_synthetic
from cld_tpu.ops import diffusion as jd
from cld_tpu.ops import dynamics as jdyn
from cld_tpu.ops import geometry as jg
from cld_tpu.ops.normalization import TrajNormalizer as JaxNormalizer
from cld_tpu_torch.data.batch import get_current_states
from cld_tpu_torch.data.synthetic import synthetic_batch
from cld_tpu_torch.ops import diffusion as td
from cld_tpu_torch.ops import dynamics as tdyn
from cld_tpu_torch.ops import geometry as tg
from cld_tpu_torch.ops.normalization import TrajNormalizer

torch.set_num_threads(2)
ELT = dict(rtol=1e-6, atol=1e-6)
DYN = dict(rtol=1e-5, atol=1e-5)


def test_transform_points_and_world_from_agent():
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(4, 2)).astype(np.float32) * 10
    yaw = rng.normal(size=(4,)).astype(np.float32)
    pts = rng.normal(size=(4, 3, 5, 2)).astype(np.float32)
    tf_j = jg.world_from_agent_matrix(jnp.asarray(pos), jnp.asarray(yaw))
    tf_t = tg.world_from_agent_matrix(torch.from_numpy(pos), torch.from_numpy(yaw))
    np.testing.assert_allclose(tf_t.numpy(), np.asarray(tf_j), **ELT)
    np.testing.assert_allclose(
        tg.transform_points(torch.from_numpy(pts), tf_t).numpy(),
        np.asarray(jg.transform_points(jnp.asarray(pts), tf_j)), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tg.raster_from_agent_matrix(64), jg.raster_from_agent_matrix(64))


def test_normalizer_scale_descale():
    x = np.random.default_rng(1).normal(size=(3, 7, 6)).astype(np.float32)
    jn, tn = JaxNormalizer(), TrajNormalizer()
    np.testing.assert_allclose(tn.scale(torch.from_numpy(x)).numpy(),
                               np.asarray(jn.scale(jnp.asarray(x))), **ELT)
    np.testing.assert_allclose(tn.descale(torch.from_numpy(x[..., 4:]), [4, 5]).numpy(),
                               np.asarray(jn.descale(jnp.asarray(x[..., 4:]), [4, 5])), **ELT)


def _dyn_case(seed):
    rng = np.random.default_rng(seed)
    B, T = 5, 52
    x0 = np.zeros((B, 4), np.float32)
    x0[:, 2] = [0.05, 3.0, 12.0, 29.5, -9.8]  # near the yaw floor and both vbounds
    x0[:, 3] = rng.normal(size=B) * 0.3
    act = np.stack([rng.normal(size=(B, T)) * 5, rng.normal(size=(B, T)) * 2], -1)
    return x0, act.astype(np.float32)


@pytest.mark.parametrize("params", [jdyn.UnicycleParams(),
                                    jdyn.UnicycleParams(0.5, 2 * np.pi, -10.0, 8.0)])
def test_unicycle_values_and_grads(params):
    x0, act = _dyn_case(2)
    tparams = tdyn.UnicycleParams(*params)
    ct = np.random.default_rng(3).normal(size=act.shape[:2] + (4,)).astype(np.float32)
    def loss(x0, a):
        return jnp.sum(jdyn.unicycle_forward_dynamics(params, x0, a, 0.1) * ct)

    want, (gx, ga) = jax.jit(lambda x0, a: (  # one jitted compile
        jdyn.unicycle_forward_dynamics(params, x0, a, 0.1),
        jax.grad(loss, argnums=(0, 1))(x0, a)))(jnp.asarray(x0), jnp.asarray(act))
    x0t = torch.from_numpy(x0).requires_grad_(True)
    at = torch.from_numpy(act).requires_grad_(True)
    got = tdyn.unicycle_forward_dynamics(tparams, x0t, at, 0.1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **DYN)
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(ga), **DYN)
    np.testing.assert_allclose(x0t.grad.numpy(), np.asarray(gx), **DYN)


def test_unicycle_clip_tie_gradient_matches_jax():
    """An action exactly on the acceleration bound: JAX's clip splits the
    gradient at the tie; the port must too (torch.clamp would not)."""
    params = jdyn.UnicycleParams()
    x0 = np.array([[0.0, 0.0, 5.0, 0.0]], np.float32)
    act = np.zeros((1, 4, 2), np.float32)
    act[0, :, 0] = [params.acce_hi, params.acce_lo, 1.0, params.acce_hi]
    g_j = jax.grad(lambda a: jnp.sum(jdyn.unicycle_forward_dynamics(
        params, jnp.asarray(x0), a, 0.1)))(jnp.asarray(act))
    at = torch.from_numpy(act).requires_grad_(True)
    tdyn.unicycle_forward_dynamics(tdyn.UnicycleParams(), torch.from_numpy(x0), at, 0.1).sum().backward()
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(g_j), **DYN)


def test_schedule_and_posterior_match():
    js = jd.make_schedule(100)
    ts = td.make_schedule(100, device="cpu")
    assert set(ts._fields) <= set(js._fields)
    for name in ts._fields[1:]:
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, 52, 4)).astype(np.float32)
    eps = rng.normal(size=(6, 52, 4)).astype(np.float32)
    t = np.array([0, 1, 5, 50, 98, 99])
    mj, lj = jd.posterior_mean_logvar(js, jnp.asarray(x), jnp.asarray(eps), jnp.asarray(t))
    mt, lt = td.posterior_mean_logvar(ts, torch.from_numpy(x), torch.from_numpy(eps),
                                      torch.from_numpy(t))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), **ELT)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    x0j = jd.predict_start_from_noise(js, jnp.asarray(x), jnp.asarray(eps), jnp.asarray(t))
    x0t = td.predict_start_from_noise(ts, torch.from_numpy(x), torch.from_numpy(eps),
                                      torch.from_numpy(t))
    np.testing.assert_allclose(x0t.numpy(), np.asarray(x0j), **ELT)
    np.testing.assert_allclose(
        td.q_posterior_mean(ts, x0t, torch.from_numpy(x), torch.from_numpy(t)).numpy(),
        np.asarray(jd.q_posterior_mean(js, x0j, jnp.asarray(x), jnp.asarray(t))), **ELT)
    sigma = np.exp(0.5 * np.asarray(lj))
    np.testing.assert_allclose(
        td.normal_log_prob(torch.from_numpy(x), mt, torch.from_numpy(sigma)).numpy(),
        np.asarray(jd.normal_log_prob(jnp.asarray(x), mj, jnp.asarray(sigma))), rtol=1e-5)


def test_synthetic_batch_same_arrays():
    jb = jax_synthetic(seed=3, batch_size=3, raster_size=64)
    tb = synthetic_batch(seed=3, batch_size=3, raster_size=64, device="cpu")
    filled = [name for name in tb._fields if getattr(tb, name) is not None]
    # the fields the JAX batch fills: the pipeline's nine, the history mask, the
    # ground-truth future that the trainers read, the neighbors' histories and the lane
    # points that the packed shards carry; the rest is the closed-loop renderer's to fill
    assert set(filled) == {n for n in jb._fields if getattr(jb, n) is not None}
    assert filled[:13] == list(tb._fields[:13]) and filled[10:13] == [
        "target_positions", "target_yaws", "target_availabilities"]
    for name in filled:
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(get_current_states(tb).numpy(), np.asarray(jax_current(jb)))
