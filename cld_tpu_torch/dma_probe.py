"""Probe of Hopper's bulk asynchronous copy (`csrc/dma_probe.cu`).

    python -m cld_tpu_torch.dma_probe [--device cpu]

Counterpart of the TPU probe `scripts/micro_dma_probe.py:38`, which asks
which ANY -> VMEM scratch copies Mosaic accepts: a [T, bb, minor] bf16 block
(T = 52, bb = 64, minor 128 or 64) of x, the whole array ([T, bb, minor])
or a batch slice x[:, b bb : (b + 1) bb, :] of a [T, B, minor] array,
copied into scratch, doubled and written out. Here `bulk_double` brings the
whole contiguous array into shared memory by `cp.async.bulk` in flat tiles
of `tile_bytes` (2 KB in all four cases), each completing on its own
mbarrier, two tiles a CTA (`tiles_per_cta`: one where that keeps at least
as many CTAs as the card has SMs). A tile is a span of bytes, not a block
of the array, so the TPU probe's choice between copying the whole array and
copying it in batch slices has no counterpart here: its four cases differ
only in the array's shape. The plain version is `2 * x`, which the kernel
must give bit for bit (doubling a bf16 is exact). The probe runs the four
cases and prints, for each, the copy shape that launched and whether the
result is exact. CUDA tensors launch the kernel (counted as `dma_probe`) or
raise; CPU tensors take `2 * x`.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import List, Optional

import torch

from cld_tpu_torch.ops import native

T, B, BB = 52, 128, 64  # the TPU probe's time steps, batch and block rows
TILE_BYTES = 2048  # a bulk copy's bytes, at most
TILES_PER_CTA = 2  # bulk copies in flight a CTA (the kernel takes up to 4, `kMaxStages`)
H100_SMS = 132  # the SM count `copy_shape` assumes off the card
# (name, minor, batch slice): the TPU probe's four cases
CASES = (("minor=128, full-copy", 128, False), ("minor=64, full-copy", 64, False),
         ("minor=128, batch-slice", 128, True), ("minor=64, batch-slice", 64, True))


def tile_bytes(nbytes: int) -> int:
    """Bytes a bulk copy brings in, for an array of nbytes (a multiple of
    16): the largest power of two of 16-byte vectors, up to `TILE_BYTES`,
    that cuts the array into equal tiles."""
    return 16 * math.gcd(nbytes // 16, TILE_BYTES // 16)


def tiles_per_cta(ntiles: int, sms: int) -> int:
    """Tiles (bulk copies in flight, each on its own mbarrier) a CTA owns:
    `TILES_PER_CTA`, fewer where that would leave fewer than `sms` CTAs."""
    return max(1, min(TILES_PER_CTA, ntiles // sms))


def bulk_double(x: torch.Tensor) -> torch.Tensor:
    """2 x for a contiguous bf16 x of a multiple of 16 bytes, brought into
    shared memory in tiles of `tile_bytes` by bulk copies. CPU tensors take
    the plain `2 * x`."""
    if x.device.type == "cpu":
        return 2 * x
    native.require(x, "x", torch.bfloat16, tuple(x.shape), x.device)
    nbytes = x.numel() * x.element_size()
    if nbytes % 16 or x.data_ptr() % 16:
        raise ValueError(f"bulk_double: x must hold a multiple of 16 bytes ({nbytes}) and be "
                         f"16-byte aligned")
    out = torch.empty_like(x)
    tile = tile_bytes(nbytes)
    ntiles = nbytes // tile
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    native.check(native.library().cld_dma_probe(
        x.data_ptr(), out.data_ptr(), ntiles, tile, tiles_per_cta(ntiles, sms),
        native.stream_ptr(x.device)), "dma_probe")
    native.count_launch("dma_probe")
    return out


def probe_input(minor: int, slice_batch: bool, device) -> torch.Tensor:
    """The TPU probe's input: arange(T Bp minor) in bf16, times 1e-3."""
    Bp = B if slice_batch else BB
    x = torch.arange(T * Bp * minor, dtype=torch.float32).to(torch.bfloat16) * 1e-3
    return x.reshape(T, Bp, minor).to(device)


def copy_shape(minor: int, slice_batch: bool, sms: int = H100_SMS) -> dict:
    """What one case launches on a card of `sms` SMs: CTAs, bulk copies per
    CTA (the last CTA may have fewer), bytes each, shared memory a CTA."""
    nbytes = T * (B if slice_batch else BB) * minor * 2
    tile = tile_bytes(nbytes)
    ntiles = nbytes // tile
    per = tiles_per_cta(ntiles, sms)
    return dict(ctas=-(-ntiles // per), copies_per_cta=per, bytes_per_copy=tile,
                shared_bytes=per * tile)


def run_cases(device) -> List[dict]:
    """Each case once: the copy shape and whether `bulk_double` equals 2 x
    bit for bit."""
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else H100_SMS)
    results = []
    for name, minor, sl in CASES:
        x = probe_input(minor, sl, device)
        out = bulk_double(x)
        results.append(dict(case=name, minor=minor, batch_slice=sl,
                            exact=bool(torch.equal(out, 2 * x)), **copy_shape(minor, sl, sms)))
    return results


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("dma_probe: no CUDA device", file=sys.stderr)
        return 2
    results = run_cases(device)
    for r in results:
        print(f"{r['case']}: {r['ctas']} CTAs x {r['copies_per_cta']} bulk copies of "
              f"{r['bytes_per_copy']} B, exact={r['exact']}", flush=True)
    print(json.dumps(results), flush=True)
    return 0 if all(r["exact"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
