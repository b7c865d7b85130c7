"""The port's guidance losses and perturbation step against the JAX
package: `AgentCollisionLoss` (scene blocks and the flat path, "diff" and
"dot" pairwise forms, excluded agents, horizon chunks) and `MapCollisionLoss`
(every `min_dist_impl` / `min_fwd_impl` / `gather_impl`, the chunked paths
forced by small budgets), values and gradients with respect to the
trajectory, one Adam or SGD `perturb` step, and sample selection.

The JAX side reaches its Pallas kernels in interpret mode by itself off the
TPU (`cld_tpu/guidance/losses.py:1155`). Option names: the port's
"rigid_kernel" is the JAX package's "rigid_pallas"; its gathers "bits",
"px", "index" are "pallas", "pallas_px", "jnp".

Fixtures use curved, drifting trajectories that straddle the road edge and
overlap their scene neighbours, so both losses are active and their
gradients are clear of zero. Tolerances: losses rtol 1e-5 / atol 1e-6,
gradients rtol 1e-4 / atol 1e-6 (f32 with another summation order). The
perturbed latent is held at atol 1e-6: one Adam step from m = v = 0 moves
each component by lr * g / (|g| + eps), which only agrees when the
gradients' signs agree; the fixture's gradients are large enough for that.
The bfloat16 forms are held as the JAX package's own tests hold them against
f32 (`tests/test_pallas.py:286-320`): loss rtol 2e-3 / atol 1e-2, gradient
cosine > 0.999; XLA and torch round bf16 intermediates at different places.
The "dot" pairwise form cancels |a|^2 + |b|^2 - 2ab: rtol 1e-4 / atol 1e-5.
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


def _jax_value_and_grad(jloss, x, jctx, wts):
    """The JAX loss and the gradient of its weighted sum as numpy, from one
    jitted compile (the trajectories and the context passed as arguments)."""

    def jax_side(v, c):
        return jloss(v, c), jax.grad(lambda u: jnp.sum(jloss(u, c) * wts))(v)

    return tuple(map(np.asarray, jax.jit(jax_side)(jnp.asarray(x), jctx)))


@pytest.mark.parametrize("name", sorted(LOSSES))
@pytest.mark.parametrize("packed", [False, True])
def test_loss_values_and_grads_match(name, packed):
    x, jctx, tctx = _scene()
    if packed:
        tctx = tlo.prepack_map_bbox(tctx._replace(
            drivable_packed=pack_drivable_bits(tctx.drivable_map)))
    jloss, tloss = LOSSES[name]
    wts = np.random.default_rng(1).uniform(0.5, 1.5, (B, 1)).astype(np.float32)
    want, gj = _jax_value_and_grad(jloss, x, jctx, wts)
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

    def jax_side(lat, x, c):  # one jitted compile
        return (jpt.perturb(lat, c, jspecs, lambda v: v[:, None], lr=0.3, grad_steps=1,
                            perturb_th=jnp.float32(0.05)),
                jpt.compute_guidance_loss(x, c, jspecs)[0],
                jax.grad(lambda v: jpt.compute_guidance_loss(v[:, None], c, jspecs)[0])(lat))

    want, jtotal, gj = jax.jit(jax_side)(jnp.asarray(lat), jnp.asarray(x), jctx)
    ttotal, _ = tpt.compute_guidance_loss(torch.from_numpy(x), tctx, tspecs)
    np.testing.assert_allclose(float(ttotal), float(jtotal), **LOSS)
    g = tpt.guidance_gradient(torch.from_numpy(lat), tctx, tspecs, lambda v: v[:, None])
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


# (JAX min_dist_impl, min_fwd_impl, gather_impl) -> the port's names
_MIN_DIST = {"rigid_pallas": "rigid_kernel"}
_GATHER = {"jnp": "index", "auto": "index", "pallas": "bits", "pallas_px": "px"}
MAP_CASES = [
    ("separable", "auto", "jnp"), ("separable", "auto", "auto"),
    ("separable", "fused", "pallas"),  # min_fwd_impl acts under "rigid" only
    ("separable_xy", "auto", "pallas"), ("separable_xy", "auto", "jnp"),
    ("separable_xy_bf16", "auto", "jnp"),
    ("rigid", "auto", "jnp"), ("rigid", "jnp", "pallas"), ("rigid", "eqmin", "jnp"),
    ("rigid", "fused", "jnp"), ("rigid", "fused", "pallas_px"), ("rigid", "bf16", "jnp"),
    ("rigid_pallas", "auto", "jnp"), ("rigid_pallas", "auto", "pallas"),
    ("pairwise", "auto", "jnp"), ("pairwise", "auto", "pallas_px"),
]


def _map_pair(dist, fwd, gather):
    return (jlo.MapCollisionLoss(min_dist_impl=dist, min_fwd_impl=fwd, gather_impl=gather),
            tlo.MapCollisionLoss(min_dist_impl=_MIN_DIST.get(dist, dist), min_fwd_impl=fwd,
                                 gather_impl=_GATHER[gather]))


def _values_and_grads(jloss, tloss, x, jctx, tctx, jit=False):
    """Both sides' loss values and gradients. The JAX side runs op by op
    unless `jit`: the map loss's "rigid" and "pairwise" forms route a
    gradient by an argmin whose near-ties XLA's fusions can tip."""
    wts = np.random.default_rng(1).uniform(0.5, 1.5, (x.shape[0], 1)).astype(np.float32)
    if jit:
        want, gj = _jax_value_and_grad(jloss, x, jctx, wts)
    else:
        want = np.asarray(jloss(jnp.asarray(x), jctx))
        gj = np.asarray(jax.grad(lambda v: jnp.sum(jloss(v, jctx) * wts))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tloss(xt, tctx)
    (got * torch.from_numpy(wts)).sum().backward()
    assert float(np.abs(want).sum()) > 0 and float(np.abs(gj).max()) > 1e-3
    return got.detach().numpy(), want, xt.grad.numpy(), gj


def _hold(got, want, gt, gj, bf16=False, loss=LOSS, grad=GRAD):
    if bf16:
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-2)
        cos = float(np.dot(gt.ravel(), gj.ravel())
                    / (np.linalg.norm(gt) * np.linalg.norm(gj) + 1e-12))
        assert cos > 0.999 and np.isfinite(gt).all(), cos
    else:
        np.testing.assert_allclose(got, want, **loss)
        np.testing.assert_allclose(gt, gj, **grad)


@pytest.mark.parametrize("dist,fwd,gather", MAP_CASES)
@pytest.mark.parametrize("packed", [False, True])
def test_map_collision_every_impl_matches_jax(dist, fwd, gather, packed):
    x, jctx, tctx = _scene()
    if packed:
        jctx = jlo.prepack_map_bbox(jctx)
        tctx = tlo.prepack_map_bbox(tlo.prepack_drivable(tctx))
        np.testing.assert_array_equal(tctx.bbox_d2.numpy(), np.asarray(jctx.bbox_d2))
    jloss, tloss = _map_pair(dist, fwd, gather)
    _hold(*_values_and_grads(jloss, tloss, x, jctx, tctx, jit=dist.startswith("separable")),
          bf16="bf16" in dist + fwd)


@pytest.mark.parametrize("dist", ["rigid", "pairwise"])
def test_map_collision_chunked_horizon_matches_jax(dist, monkeypatch):
    """Budgets shrunk on both sides so that T = 12 runs as chunks of 5, 5
    and 2 steps ("rigid" leaves its full-horizon path too)."""
    x, jctx, tctx = _scene()
    per_step = B * 1 * 100 * 100
    for mod in (jlo, tlo):
        monkeypatch.setattr(mod, "_CHUNK_BUDGET", 5 * per_step)
        monkeypatch.setattr(mod, "_FULL_HORIZON_BUDGET", 3 * per_step)
    assert tlo._time_chunk(T, per_step) == jlo._time_chunk(T, per_step) == 5
    jloss, tloss = _map_pair(dist, "auto", "jnp")
    got, want, gt, gj = _values_and_grads(jloss, tloss, x, jctx, tctx)
    _hold(got, want, gt, gj)
    full = tlo.MapCollisionLoss(min_dist_impl="separable", gather_impl="index")
    np.testing.assert_allclose(got, full(torch.from_numpy(x), tctx).numpy(), **LOSS)
    with pytest.raises(ValueError, match="requires the full-horizon path"):
        tlo.MapCollisionLoss(min_dist_impl="rigid", min_fwd_impl="fused")(
            torch.from_numpy(x), tctx)
    with pytest.raises(ValueError, match="requires the full-horizon path"):
        jlo.MapCollisionLoss(min_dist_impl="rigid", min_fwd_impl="fused")(jnp.asarray(x), jctx)


@pytest.mark.parametrize("T_, per, budget", [(52, 1000, 0), (52, 80000, 400000), (12, 7, 50),
                                             (100, 3, 100), (5, 10**9, 0)])
def test_time_chunk_matches_jax(T_, per, budget):
    assert tlo._time_chunk(T_, per, budget) == jlo._time_chunk(T_, per, budget)


def test_map_collision_tie_rules_agree_in_value_and_differ_only_at_ties():
    """The two families ("rigid" splits a tie, "rigid_kernel" and "fused"
    give it to the lowest row) agree in values, and in gradients wherever
    the winner-take-all and the split backward see the same rows."""
    x, _, tctx = _scene(4)
    xt = torch.from_numpy(x)
    vals, grads = {}, {}
    for name, kw in (("rigid", dict(min_dist_impl="rigid")),
                     ("kernel", dict(min_dist_impl="rigid_kernel")),
                     ("fused", dict(min_dist_impl="rigid", min_fwd_impl="fused"))):
        v = xt.clone().requires_grad_(True)
        out = tlo.MapCollisionLoss(gather_impl="index", **kw)(v, tctx)
        out.sum().backward()
        vals[name], grads[name] = out.detach(), v.grad
    assert torch.equal(vals["rigid"], vals["kernel"]) and torch.equal(vals["kernel"], vals["fused"])
    np.testing.assert_allclose(grads["kernel"].numpy(), grads["fused"].numpy(), **GRAD)


def test_map_collision_invalid_options_raise_as_in_jax():
    x, jctx, tctx = _scene()
    with pytest.raises(ValueError, match="unknown min_fwd_impl"):
        tlo.MapCollisionLoss(min_fwd_impl="pallas")(torch.from_numpy(x), tctx)
    with pytest.raises(ValueError, match="unknown min_fwd_impl"):
        jlo.MapCollisionLoss(min_fwd_impl="pallas")(jnp.asarray(x), jctx)
    with pytest.raises(ValueError, match="unknown min_dist_impl"):
        tlo.MapCollisionLoss(min_dist_impl="rigid_pallas")(torch.from_numpy(x), tctx)


def test_prepack_map_bbox_grid_and_d2_rules():
    _, jctx, tctx = _scene()
    no_d2 = tlo.prepack_map_bbox(tctx, (10, 10), with_d2=False)
    assert no_d2.bbox_d2 is None and no_d2.bbox_pts.shape == (B, 10, 10, 2)
    assert tlo.prepack_map_bbox(no_d2, (10, 10), with_d2=False) is no_d2
    full = tlo.prepack_map_bbox(no_d2, (10, 10))
    assert full.bbox_d2.shape == (B, 100, 100) and tlo.prepack_map_bbox(full) is full
    np.testing.assert_array_equal(full.bbox_d2.numpy(),
                                  np.asarray(jlo.prepack_map_bbox(jctx).bbox_d2))
    other = tlo.prepack_map_bbox(full, (20, 5))  # same point count, another grid: repacked
    assert other.bbox_pts.shape == (B, 20, 5, 2) and other is not full
    # a loss whose grid does not match the context's recomputes its own
    x = torch.from_numpy(_scene()[0])
    loss = tlo.MapCollisionLoss(min_dist_impl="rigid", gather_impl="index")
    assert torch.equal(loss(x, other), loss(x, tctx))


AGENT_CASES = {
    "block_dot": dict(scene_block=A, pairwise_impl="dot"),
    "block_auto": dict(scene_block=A),  # "auto" is "diff" on the CPU on both sides
    "flat": dict(),
    "flat_block_not_dividing": dict(scene_block=3),
    "block_excluded": dict(scene_block=A, pairwise_impl="diff", excluded_agents=(0, 1, 6)),
    "flat_excluded": dict(excluded_agents=(0, 1, 6)),
    "block_dot_excluded": dict(scene_block=A, pairwise_impl="dot", excluded_agents=(4, 5)),
}


@pytest.mark.parametrize("name", sorted(AGENT_CASES))
@pytest.mark.parametrize("chunked", [False, True])
def test_agent_collision_every_path_matches_jax(name, chunked, monkeypatch):
    x, jctx, tctx = _scene()
    x = np.concatenate([x, x + np.float32(0.3)], axis=1)  # N = 2 samples
    kw = AGENT_CASES[name]
    if chunked:  # T = 12 in chunks of 5, 5 and 2 steps
        per_step = (B // A * A * A if kw.get("scene_block") == A else B * B) * 2 * 25
        for mod in (jlo, tlo):
            monkeypatch.setattr(mod, "_CHUNK_BUDGET", 5 * per_step)
    jloss = jlo.AgentCollisionLoss(num_disks=5, buffer_dist=0.2, **kw)
    tloss = tlo.AgentCollisionLoss(num_disks=5, buffer_dist=0.2, **kw)
    dot = kw.get("pairwise_impl") == "dot"
    _hold(*_values_and_grads(jloss, tloss, x, jctx, tctx, jit=True),
          loss=dict(rtol=1e-4, atol=1e-5) if dot else LOSS,
          grad=dict(rtol=1e-4, atol=1e-5) if dot else GRAD)


def test_agent_collision_paths_agree_and_unknown_impl_raises():
    x, jctx, tctx = _scene()
    xt = torch.from_numpy(x)
    block = tlo.AgentCollisionLoss(scene_block=A, pairwise_impl="diff")(xt, tctx)
    flat = tlo.AgentCollisionLoss()(xt, tctx)
    dot = tlo.AgentCollisionLoss(scene_block=A, pairwise_impl="dot")(xt, tctx)
    np.testing.assert_allclose(block.numpy(), flat.numpy(), **LOSS)
    np.testing.assert_allclose(dot.numpy(), block.numpy(), rtol=1e-4, atol=1e-5)
    exc = tlo.AgentCollisionLoss(scene_block=A, excluded_agents=(0, 1, 2, 3))(xt, tctx)
    assert float(exc[:A].abs().sum()) == 0.0 and torch.equal(exc[A:], block[A:])
    with pytest.raises(ValueError, match="unknown pairwise_impl"):
        tlo.AgentCollisionLoss(scene_block=A, pairwise_impl="gram")(xt, tctx)
    with pytest.raises(ValueError, match="unknown pairwise_impl"):
        jlo.AgentCollisionLoss(scene_block=A, pairwise_impl="gram")(jnp.asarray(x), jctx)
