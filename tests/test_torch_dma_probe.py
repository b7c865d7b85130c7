"""The bulk-copy probe (`cld_tpu_torch/dma_probe.py`, the counterpart of
`scripts/micro_dma_probe.py`) on the CPU: its four cases through the entry
point (the plain `2 * x`, bit for bit, no launch), and the copy shape the
kernel (`csrc/dma_probe.cu`) launches: the array in equal flat tiles of
whole 16-byte vectors, 2 KB in the probe's cases, 1 or 2 tiles a CTA, at
least as many CTAs as an H100 has SMs (132) at the TPU probe's [52, 128,
128].
"""

import math

import pytest
import torch

from cld_tpu_torch import dma_probe as dp
from cld_tpu_torch.ops import native


def test_probe_cases_run_the_plain_version_on_the_cpu(capsys):
    native.reset_launch_counts()
    assert dp.main(["--device", "cpu"]) == 0
    assert native.launch_counts() == {k: 0 for k in native.KERNELS}
    assert "exact=True" in capsys.readouterr().out
    for name, minor, sl in dp.CASES:
        x = dp.probe_input(minor, sl, torch.device("cpu"))
        assert x.shape == (dp.T, dp.B if sl else dp.BB, minor) and x.dtype == torch.bfloat16
        assert torch.equal(dp.bulk_double(x), 2 * x), name


@pytest.mark.parametrize("shape", [(52, 128, 128), (52, 64, 64), (52, 64, 8), (52, 24, 128),
                                   (52, 64, 1024), (1, 3, 8)])
def test_tiles_cut_the_array_into_equal_whole_vectors(shape):
    """A tile is a power of two of 16-byte vectors, at most `TILE_BYTES`,
    the largest that cuts the array's bytes into equal tiles: 2 KB where
    they allow."""
    nbytes = math.prod(shape) * 2
    tile = dp.tile_bytes(nbytes)
    vecs = tile // 16
    assert tile % 16 == 0 and vecs & (vecs - 1) == 0 and tile <= dp.TILE_BYTES
    assert nbytes % tile == 0 and (2 * tile > dp.TILE_BYTES or nbytes % (2 * tile))
    if nbytes % dp.TILE_BYTES == 0:
        assert tile == dp.TILE_BYTES


@pytest.mark.parametrize("minor,sl", [(128, True), (64, True), (128, False), (64, False)])
def test_copy_shape_spreads_the_array_over_the_card(minor, sl):
    shape = dp.copy_shape(minor, sl, sms=132)
    Bp = dp.B if sl else dp.BB
    ntiles = dp.T * Bp * minor * 2 // shape["bytes_per_copy"]
    assert shape["bytes_per_copy"] == dp.TILE_BYTES
    assert 1 <= shape["copies_per_cta"] <= dp.TILES_PER_CTA
    assert shape["ctas"] == -(-ntiles // shape["copies_per_cta"])
    assert shape["ctas"] >= min(132, ntiles)
    if (minor, sl) == (128, True):  # the timed case: 832 tiles, more CTAs than SMs
        assert shape["ctas"] == 416 and shape["copies_per_cta"] == 2
