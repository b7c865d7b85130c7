"""The reward reductions of the port against the JAX package: the plain
versions of the two reward kernels (`cld_tpu_torch.ops.reward_kernels`)
against the JAX `*_ref` oracles and against the Pallas kernels in interpret
mode (as `tests/test_pallas.py` runs them), and `algos.reward` against
`cld_tpu.algos.reward` on the same synthetic batch.

Tolerances: the off-road count, the rewards and the failure rates are counts
and must be equal (the jerk term of the reward and the rates' final means
within rtol 1e-6: means of f32 values). The disk penalty is held at rtol 1e-5 / atol 1e-6, as the
JAX package holds its kernel against its oracle: the sums over pairs and
steps are taken in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cld_tpu.algos import reward as jax_reward
from cld_tpu.data.synthetic import synthetic_batch as jax_synthetic
from cld_tpu.ops import pallas_kernels as pk
from cld_tpu_torch.algos import reward
from cld_tpu_torch.data.synthetic import synthetic_batch
from cld_tpu_torch.ops import native
from cld_tpu_torch.ops import reward_kernels as rk

torch.set_num_threads(2)


@pytest.mark.parametrize("B,P,H,W", [(4, 52, 64, 64), (5, 7, 64, 64), (3, 9, 33, 47)])
def test_offroad_count_ref_matches_jax_ref_and_pallas(B, P, H, W):
    rng = np.random.default_rng(0)
    drivable = (rng.random((B, H, W)) - 0.4).astype(np.float32)
    drivable[drivable > 0.3] = 0.0  # exact zeros count as off-road
    pix = np.stack([rng.integers(0, W, (B, P)), rng.integers(0, H, (B, P))], -1).astype(np.int32)
    got = rk.offroad_count(torch.from_numpy(pix), torch.from_numpy(drivable)).numpy()
    want = np.asarray(pk.offroad_count_ref(jnp.asarray(pix), jnp.asarray(drivable)))
    kernel = np.asarray(pk.offroad_count_pallas(jnp.asarray(pix), jnp.asarray(drivable),
                                                interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, kernel)
    assert got.dtype == np.float32 and 0 < got.sum() < B * P


# the CUDA kernel's edges: one point; 33, one past a warp's 32 lanes; 65,
# one past 2 points a lane; 129, one past a pass of 4 points a lane (so a
# second pass); one group per map (the Pallas kernel's form) and three, held
# against the JAX oracle on the groups laid out as maps
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("P", [1, 33, 65, 129])
def test_offroad_count_edges_match_jax(P, G):
    rng = np.random.default_rng(P * 10 + G)
    B, H, W = 2, 13, 17
    drivable = (rng.random((B, H, W)) - 0.4).astype(np.float32)
    drivable[drivable > 0.3] = 0.0  # exact zeros count as off-road
    pix = np.stack([rng.integers(0, W, (B, G, P)), rng.integers(0, H, (B, G, P))],
                   -1).astype(np.int32)
    pix[0, 0, 0] = [W - 1, H - 1]  # the last pixel
    flat_pix = jnp.asarray(pix.reshape(B * G, P, 2))
    flat_maps = jnp.asarray(np.repeat(drivable, G, axis=0))
    want = np.asarray(pk.offroad_count_ref(flat_pix, flat_maps)).reshape(B, G)
    native.reset_launch_counts()
    got = rk.offroad_count(torch.from_numpy(pix if G > 1 else pix[:, 0]),
                           torch.from_numpy(drivable)).numpy()
    assert got.dtype == np.float32 and got.shape == ((B, G) if G > 1 else (B,))
    np.testing.assert_array_equal(got.reshape(B, G), want)
    if G == 1:
        kernel = np.asarray(pk.offroad_count_pallas(flat_pix, flat_maps, interpret=True))
        np.testing.assert_array_equal(got, kernel)
    assert native.launch_counts()["offroad_count"] == 0  # CPU tensors: the plain version


def test_offroad_count_groups_are_per_group_counts():
    rng = np.random.default_rng(1)
    B, G, P, H, W = 3, 4, 9, 20, 31
    drivable = torch.from_numpy((rng.random((B, H, W)) > 0.5).astype(np.float32))
    pix = torch.from_numpy(np.stack([rng.integers(-3, W + 3, (B, G, P)),
                                     rng.integers(-3, H + 3, (B, G, P))], -1).astype(np.int32))
    got = rk.offroad_count(pix, drivable)
    assert got.shape == (B, G)
    for g in range(G):  # out-of-range coordinates clamp to the map
        np.testing.assert_array_equal(got[:, g].numpy(),
                                      rk.offroad_count(pix[:, g].contiguous(), drivable).numpy())


@pytest.mark.parametrize("T,B,D,spread", [(8, 6, 4, 5.0), (3, 5, 1, 2.0), (4, 3, 2, 100.0)])
def test_disk_collision_ref_matches_jax_ref_and_pallas(T, B, D, spread):
    rng = np.random.default_rng(1)
    cent = rng.normal(0, spread, (T, B, D, 2)).astype(np.float32)
    rad = rng.uniform(0.8, 1.2, B).astype(np.float32)
    pen = rad[:, None] + rad[None, :] + 0.2
    mask = ~np.eye(B, dtype=bool)
    mask[0, 1] = False  # an excluded pair
    decay = (0.9 ** np.arange(T)).astype(np.float32)
    decay /= decay.sum()
    got = rk.disk_collision_penalty(*(torch.from_numpy(a) for a in (cent, pen, mask, decay)))
    args = tuple(jnp.asarray(a) for a in (cent, pen, mask, decay))
    want = np.asarray(pk.disk_collision_penalty_ref(*args))
    kernel = np.asarray(pk.disk_collision_penalty_pallas(*args, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), kernel, rtol=1e-5, atol=1e-6)
    assert (want.max() > 0) == (spread < 50.0)  # far-apart agents: exactly zero
    if spread >= 50.0:
        assert float(got.abs().max()) == 0.0


@pytest.fixture(scope="module")
def batches():
    return (synthetic_batch(seed=3, batch_size=6, raster_size=64, device="cpu"),
            jax_synthetic(seed=3, batch_size=6, raster_size=64))


def _trajectories(N, seed=5):
    """[6, N, 52, 6] descaled trajectories that wander off a 14 m wide road
    and through the neighbours; pixel coordinates stay clear of .5 and
    distances of the 0.8 m threshold by construction of the seed."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, 52, dtype=np.float32)
    x = rng.uniform(5, 40, (6, N, 1)).astype(np.float32) * t
    y = rng.uniform(-12, 12, (6, N, 1)).astype(np.float32) * t
    rest = rng.normal(size=(6, N, 52, 4)).astype(np.float32)
    return np.concatenate([x[..., None], y[..., None], rest], -1)


@pytest.mark.parametrize("N", [1, 3])
def test_offroad_reward_is_minus_offroad_count_and_matches_jax(batches, N):
    tb, jb = batches
    traj = _trajectories(N)
    native.reset_launch_counts()
    got = reward.offroad_reward(torch.from_numpy(traj[..., :2]), tb)
    want = np.asarray(jax_reward.offroad_reward(jnp.asarray(traj[..., :2]), jb))
    vals = reward.drivable_values_at(torch.from_numpy(traj[..., :2]), tb.drivable_map,
                                     tb.raster_from_agent)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), -(vals <= 0).sum(-1).float().numpy())
    assert got.shape == (6, N) and 0 < -got.sum() < 6 * N * 52
    assert native.launch_counts()["offroad_count"] == 0  # CPU tensors: the plain version


def test_compute_reward_and_failure_rate_match_jax(batches):
    tb, jb = batches
    traj = _trajectories(2)
    scaled = traj * 0.5 + 0.1
    got = reward.compute_reward(torch.from_numpy(traj), tb, torch.from_numpy(scaled))
    want = np.asarray(jax_reward.compute_reward(jnp.asarray(traj), jb, jnp.asarray(scaled)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    col = reward.collision_reward(torch.from_numpy(traj[..., :2]), tb)
    np.testing.assert_array_equal(
        col.numpy(), np.asarray(jax_reward.collision_reward(jnp.asarray(traj[..., :2]), jb)))
    rates = reward.failure_rate(torch.from_numpy(traj[:, 0]), tb)
    want = jax_reward.failure_rate(jnp.asarray(traj[:, 0]), jb)
    assert sorted(rates) == sorted(want)
    for k in want:  # the same count of failed trajectories; the mean's last bit may differ
        np.testing.assert_allclose(float(rates[k]), float(want[k]), rtol=1e-6, err_msg=k)
    for k in ("offroad_failure_rate", "collision_failure_rate"):
        assert round(float(rates[k]) * 6) == round(float(want[k]) * 6), k
    assert 0.0 < float(rates["offroad_failure_rate"]) < 1.0


def test_wrappers_dispatch_by_device_and_validate():
    m = lambda *s, dtype=torch.float32: torch.empty(*s, dtype=dtype, device="meta")
    with pytest.raises(ValueError):
        rk.offroad_count(m(2, 5, 2, dtype=torch.int32), m(2, 4, 4))
    with pytest.raises(ValueError):
        rk.disk_collision_penalty(m(3, 2, 4, 2), m(2, 2), m(2, 2, dtype=torch.bool), m(3))
    native.reset_launch_counts()
    assert rk.offroad_count(torch.zeros((1, 3, 2), dtype=torch.int32),
                            torch.zeros((1, 4, 4))).tolist() == [3.0]
    assert native.launch_counts() == {k: 0 for k in native.KERNELS}
    assert {"offroad_count", "disk_collision"} <= set(native.KERNELS)
