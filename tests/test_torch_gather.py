"""The port's bit-packed drivable-map gather (`cld_tpu_torch.ops.
gather_kernels`) against the JAX package's (`cld_tpu.ops.pallas_kernels`,
Pallas in interpret mode). Both are integer bit manipulation: held exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cld_tpu.ops.pallas_kernels import drivable_bit_gather_pallas
from cld_tpu.ops.pallas_kernels import pack_drivable_bits as jax_pack
from cld_tpu_torch.ops.gather_kernels import (
    drivable_bit_gather,
    drivable_bit_gather_ref,
    pack_drivable_bits,
)

torch.set_num_threads(2)


def _map(seed, B, H, W):
    rng = np.random.default_rng(seed)
    drv = (rng.random((B, H, W)) < 0.5).astype(np.float32)
    drv[:, 0, :8] = 1.0  # a full byte: 255, stored as -1
    drv[:, 1, :8] = np.array([0, 0, 0, 0, 0, 0, 0, 1], np.float32)  # 128 -> -128
    return drv


@pytest.mark.parametrize("W", [16, 21, 35])  # W divisible by 8 and not
def test_pack_matches_jax(W):
    drv = _map(0, 2, 5, W)
    want = np.asarray(jax_pack(jnp.asarray(drv)))
    got = pack_drivable_bits(torch.from_numpy(drv)).numpy()
    assert got.dtype == np.int8 and want.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    assert (got < 0).any()  # bytes >= 128 present and wrapped


@pytest.mark.parametrize("B,H,W,Q", [(3, 17, 21, 300), (9, 32, 40, 64)])
def test_bit_gather_matches_pallas_exactly(B, H, W, Q):
    drv = _map(1, B, H, W)
    rng = np.random.default_rng(2)
    pix = np.stack([rng.integers(0, W, (B, Q)), rng.integers(0, H, (B, Q))], -1)
    # clamped edge pixels: the corners and borders of the map
    pix[:, :4] = np.array([[0, 0], [W - 1, 0], [0, H - 1], [W - 1, H - 1]])
    pix = pix.astype(np.int32)
    want = np.asarray(drivable_bit_gather_pallas(jnp.asarray(pix), jnp.asarray(drv),
                                                 interpret=True))
    packed = pack_drivable_bits(torch.from_numpy(drv))
    got = drivable_bit_gather(torch.from_numpy(pix), packed).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(drivable_bit_gather_ref(torch.from_numpy(pix), packed).numpy(),
                                  want)
    # and it is the on-road value of the unpacked map
    b = np.arange(B)[:, None]
    np.testing.assert_array_equal(got, (drv[b, pix[..., 1], pix[..., 0]] > 0).astype(np.float32))
