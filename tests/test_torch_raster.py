"""The port's map gathers and rasterization (`cld_tpu_torch.ops.raster`, the
unpacked gathers of `cld_tpu_torch.ops.gather_kernels`) against the JAX
package's (`cld_tpu.ops.raster`, `cld_tpu.ops.pallas_kernels` in interpret
mode), on the same numpy inputs.

Tolerances: the gathers move integers and are held exactly. The warps share
their index math (f32 transforms, round half to even) and read the same map
values: banded vs JAX "pallas" and exact vs JAX "jnp" at atol 1e-6, on maps
made of multiples of 1/255 where the 8-bit quantization is exact.
`rasterize_history` paints the same pixels: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cld_tpu.ops import raster as jr
from cld_tpu.ops.geometry import raster_from_agent_matrix
from cld_tpu.ops.geometry import world_from_agent_matrix as jax_wfa
from cld_tpu.ops.pallas_kernels import drivable_gather_pallas, value_gather_pallas
from cld_tpu_torch.ops import gather_kernels as gk
from cld_tpu_torch.ops import native
from cld_tpu_torch.ops import raster as tr
from cld_tpu_torch.ops.geometry import world_from_agent_matrix

torch.set_num_threads(2)
T = torch.from_numpy


def _pix(rng, M, Q, W, H):
    pix = np.stack([rng.integers(0, W, (M, Q)), rng.integers(0, H, (M, Q))], -1)
    pix[:, :4] = np.array([[0, 0], [W - 1, 0], [0, H - 1], [W - 1, H - 1]])  # corners
    return pix.astype(np.int32)


# Q not a multiple of the CUDA kernel's group of 4 (its scalar path), C = 1,
# 3 and 4, one window
@pytest.mark.parametrize("M,H,W,C,Q", [(3, 16, 24, 3, 70), (9, 32, 32, 1, 40),
                                       (2, 8, 12, 1, 37), (1, 10, 9, 4, 45),
                                       (4, 16, 16, 4, 64), (1, 12, 20, 3, 1027)])
def test_value_gather_matches_pallas_exactly(M, H, W, C, Q):
    rng = np.random.default_rng(0)
    wins = rng.integers(-128, 128, (M, H, W, C)).astype(np.int8)
    wins[:, 0, 0] = -128
    wins[:, -1, -1] = 127
    pix = _pix(rng, M, Q, W, H)
    want = np.asarray(value_gather_pallas(jnp.asarray(pix), jnp.asarray(wins), interpret=True))
    native.reset_launch_counts()
    got = gk.value_gather(T(pix), T(wins)).numpy()
    assert got.dtype == np.float32 and got.shape == (M, Q, C)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gk.value_gather_ref(T(pix), T(wins)).numpy(), want)
    assert native.launch_counts()["value_gather"] == 0  # CPU tensors: plain version
    assert got.min() == -128.0 and got.max() == 127.0


@pytest.mark.parametrize("kind", ["int8", "float01"])
@pytest.mark.parametrize("B,H,W,Q", [(3, 17, 21, 300), (9, 32, 40, 64)])
def test_drivable_gather_matches_pallas_exactly(kind, B, H, W, Q):
    rng = np.random.default_rng(1)
    if kind == "int8":
        drv = rng.integers(-3, 4, (B, H, W)).astype(np.int8)
    else:
        drv = (rng.random((B, H, W)) < 0.5).astype(np.float32)
    pix = _pix(rng, B, Q, W, H)
    want = np.asarray(drivable_gather_pallas(jnp.asarray(pix), jnp.asarray(drv), interpret=True))
    got = gk.drivable_gather(T(pix), T(drv)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gk.drivable_gather_ref(T(pix), T(drv)).numpy(), want)
    b = np.arange(B)[:, None]
    np.testing.assert_array_equal(got, drv[b, pix[..., 1], pix[..., 0]].astype(np.float32))


# the CUDA kernel's edges: one query, ragged groups of 3 and 5 (its scalar
# path), one agent and three
@pytest.mark.parametrize("kind", ["int8", "float01"])
@pytest.mark.parametrize("B,Q", [(1, 1), (1, 3), (1, 5), (3, 1), (3, 3), (3, 5)])
def test_drivable_gather_edges_match_pallas_exactly(kind, B, Q):
    rng = np.random.default_rng(B * 10 + Q)
    H, W = 13, 17
    if kind == "int8":
        drv = rng.integers(-3, 4, (B, H, W)).astype(np.int8)
    else:
        drv = (rng.random((B, H, W)) < 0.5).astype(np.float32)
    pix = np.stack([rng.integers(0, W, (B, Q)), rng.integers(0, H, (B, Q))], -1).astype(np.int32)
    pix[:, 0] = [W - 1, H - 1]  # the last pixel
    want = np.asarray(drivable_gather_pallas(jnp.asarray(pix), jnp.asarray(drv), interpret=True))
    native.reset_launch_counts()
    got = gk.drivable_gather(T(pix), T(drv)).numpy()
    assert got.dtype == np.float32 and got.shape == (B, Q)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gk.drivable_gather_ref(T(pix), T(drv)).numpy(), want)
    assert native.launch_counts()["drivable_gather"] == 0  # CPU tensors: plain version


@pytest.mark.parametrize("Q,offset,vector", [(5200, 0, True), (5201, 0, False), (5200, 2, False)])
def test_drivable_gather_path_chooser(Q, offset, vector):
    """The kernel's 16-byte path needs Q % 4 == 0 and pix and out 16-byte
    aligned; a pix view 8 bytes off a 16-byte boundary takes the scalar
    path."""
    B = 2
    store = torch.zeros(B * Q * 2 + 2, dtype=torch.int32)
    pix = store[offset:offset + B * Q * 2].view(B, Q, 2)
    out = torch.empty((B, Q), dtype=torch.float32)
    assert store.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    assert pix.data_ptr() % 16 == (8 if offset else 0)
    assert gk.drivable_gather_vector(pix, out) is vector
    assert not gk.drivable_gather_vector(pix, out[:, 1:])  # out 4 bytes off


def test_gathers_clamp_out_of_range_queries_like_their_plain_versions():
    wins = T(np.arange(2 * 4 * 5 * 2, dtype=np.int8).reshape(2, 4, 5, 2))
    pix = T(np.array([[[-3, 0], [9, 9], [2, -1]]] * 2, np.int32))
    got = gk.value_gather(pix, wins)
    np.testing.assert_array_equal(got[0].numpy(), wins[0, [0, 3, 0], [0, 4, 2]].float().numpy())
    drv = wins[..., 0].contiguous()
    np.testing.assert_array_equal(gk.drivable_gather(pix, drv)[1].numpy(),
                                  drv[1, [0, 3, 0], [0, 4, 2]].float().numpy())


def test_quantize_q8_matches_jax_and_wraps():
    rng = np.random.default_rng(2)
    maps = rng.uniform(-0.2, 1.2, (2, 9, 11, 3)).astype(np.float32)
    maps[0, 0, 0] = [1.0, 128 / 255.0, 127 / 255.0]
    want = np.asarray(jr.quantize_world_maps_q8(jnp.asarray(maps)))
    got = tr.quantize_world_maps_q8(T(maps)).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 0].tolist() == [-1, -128, 127]


def test_pick_band_matches_jax():
    for size, scale in [(224, 1.0), (64, 1.0), (112, 0.5), (224, 2.0)]:
        assert tr._pick_band(size, scale) == jr._pick_band(size, scale)
    assert tr._pick_band(224, 1.0) == (112, 256)


def _warp_inputs(seed, Ns=2, Hw=256, C=3, Na=5, quantized=True):
    rng = np.random.default_rng(seed)
    if quantized:  # multiples of 1/255: the 8-bit windows are exact
        world = rng.integers(0, 256, (Ns, Hw, Hw, C)).astype(np.float32) / 255.0
    else:
        world = rng.random((Ns, Hw, Hw, C)).astype(np.float32)
    origin = np.full((Ns, 2), -Hw * 0.5 / 2, np.float32)
    origin[1] += 3.0  # scenes with different origins
    scene = rng.integers(0, Ns, Na).astype(np.int32)
    pos = rng.uniform(-25, 25, (Na, 2)).astype(np.float32)
    pos[0] = [-60.0, 58.0]  # viewport partly off the map: fill + clipped windows
    yaw = rng.uniform(-np.pi, np.pi, Na).astype(np.float32)
    return world, origin, scene, pos, yaw


KW = dict(raster_size=64, pixel_size=0.5, ego_center=(-0.5, 0.0))


@pytest.mark.parametrize("fill", [0.0, 0.25])
@pytest.mark.parametrize("impl,jax_impl", [("banded", "pallas"), ("exact", "jnp")])
def test_warp_scene_maps_matches_jax(impl, jax_impl, fill):
    world, origin, scene, pos, yaw = _warp_inputs(3)
    want = jr.warp_scene_maps(
        jnp.asarray(world), jnp.asarray(origin), 0.5,
        jax_wfa(jnp.asarray(pos), jnp.asarray(yaw)), jnp.asarray(scene),
        impl=jax_impl, fill_value=fill, **KW)
    wfa = world_from_agent_matrix(T(pos), T(yaw))
    got = tr.warp_scene_maps(T(world), T(origin), 0.5, wfa, T(scene), impl=impl,
                             fill_value=fill, **KW)
    assert got.shape == (5, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert (got[0] == fill).any() and (got != fill).any()


def test_warp_banded_equals_exact_on_quantized_maps_and_is_close_otherwise():
    for quantized, atol in [(True, 1e-6), (False, 1.0 / 510 + 1e-6)]:
        world, origin, scene, pos, yaw = _warp_inputs(4, quantized=quantized)
        wfa = world_from_agent_matrix(T(pos), T(yaw))
        args = (T(world), T(origin), 0.5, wfa, T(scene))
        exact = tr.warp_scene_maps(*args, impl="exact", **KW)
        q8 = tr.quantize_world_maps_q8(T(world))
        banded = tr.warp_scene_maps(*args, impl="banded", world_maps_q8=q8, **KW)
        np.testing.assert_allclose(banded.numpy(), exact.numpy(), atol=atol)
        # on the CPU "auto" is the exact warp
        assert torch.equal(tr.warp_scene_maps(*args, impl="auto", **KW), exact)


def test_warp_falls_back_to_exact_when_the_window_exceeds_the_map():
    world, origin, scene, pos, yaw = _warp_inputs(5, Hw=96)
    wfa = world_from_agent_matrix(T(pos), T(yaw))
    args = (T(world), T(origin), 0.5, wfa, T(scene))
    assert torch.equal(tr.warp_scene_maps(*args, impl="auto", **KW),
                       tr.warp_scene_maps(*args, impl="exact", **KW))
    # an explicit "banded" never takes the exact warp silently
    with pytest.raises(ValueError, match="at least 128 px"):
        tr.warp_scene_maps(*args, impl="banded", **KW)
    with pytest.raises(ValueError, match="unknown warp impl"):
        tr.warp_scene_maps(*args, impl="pallas", **KW)


def test_warp_to_agent_frame_matches_jax():
    world, origin, _, pos, yaw = _warp_inputs(6)
    want = jr.warp_to_agent_frame(jnp.asarray(world[0]), jax_wfa(jnp.asarray(pos), jnp.asarray(yaw)),
                                  0.5, jnp.asarray(origin[0]), **KW)
    got = tr.warp_to_agent_frame(T(world[0]), world_from_agent_matrix(T(pos), T(yaw)), 0.5,
                                 T(origin[0]), **KW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_rasterize_history_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, S, Th, R = 3, 4, 6, 64
    rfa = np.broadcast_to(raster_from_agent_matrix(R, 0.5, (-0.5, 0.0)), (B, 3, 3)).copy()
    ego = rng.uniform(-6, 20, (B, Th, 2)).astype(np.float32)
    neigh = rng.uniform(-12, 30, (B, S, Th, 2)).astype(np.float32)
    neigh[:, 0] = ego  # a neighbor under the ego: the ego's +1 wins
    neigh[0, 1, 0] = [500.0, 500.0]  # out of view: clamps to the last pixel, zeroed
    ego_avail = (rng.random((B, Th)) < 0.8).astype(np.float32)
    neigh_avail = (rng.random((B, S, Th)) < 0.7).astype(np.float32)
    want = np.asarray(jr.rasterize_history(*map(jnp.asarray, (ego, ego_avail, neigh, neigh_avail,
                                                              rfa)), R))
    got = tr.rasterize_history(T(ego), T(ego_avail), T(neigh), T(neigh_avail), T(rfa), R).numpy()
    assert got.shape == (B, Th, R, R)
    np.testing.assert_array_equal(got, want)
    assert (got == 1.0).any() and (got == -1.0).any()
    assert (got[:, :, 0, 0] == 0).all() and (got[:, :, -1, -1] == 0).all()
