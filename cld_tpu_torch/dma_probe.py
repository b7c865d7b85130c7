"""Probe of Hopper's bulk asynchronous copy (`csrc/dma_probe.cu`).

    python -m cld_tpu_torch.dma_probe [--device cpu]

Counterpart of the TPU probe `scripts/micro_dma_probe.py:38`, which asks
which ANY -> VMEM scratch copies Mosaic accepts: a [T, bb, minor] bf16 block
(T = 52, bb = 64, minor 128 or 64) of x, the whole array or a batch slice
x[:, b bb : (b + 1) bb, :], copied into scratch, doubled and written out.
Here `bulk_double` brings each block into shared memory by `cp.async.bulk`
completing on an mbarrier, kSteps time steps a CTA (a CTA holds 227 KB, not
the TPU's 16 MiB of VMEM). Its plain version is `2 * x`, which the kernel
must give bit for bit (doubling a bf16 is exact). The probe runs the TPU
probe's four cases and prints, for each, the copy shape that launched and
whether the result is exact. CUDA tensors launch the kernel (counted as
`dma_probe`) or raise; CPU tensors take `2 * x`.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import torch

from cld_tpu_torch.ops import native

T, B, BB = 52, 128, 64  # the TPU probe's time steps, batch and block rows
STEPS_PER_CTA = 4  # `kSteps` in csrc/dma_probe.cu
# (name, minor, batch slice): the TPU probe's four cases
CASES = (("minor=128, full-copy", 128, False), ("minor=64, full-copy", 64, False),
         ("minor=128, batch-slice", 128, True), ("minor=64, batch-slice", 64, True))


def bulk_double(x: torch.Tensor, bb: int) -> torch.Tensor:
    """2 x for x [T, Bp, minor] bf16, block (t-steps, b) brought into shared
    memory by a bulk copy of batch slice b (bb rows; bb == Bp copies the
    whole array). CPU tensors take the plain `2 * x`."""
    if x.device.type == "cpu":
        return 2 * x
    Tn, Bp, minor = x.shape
    native.require(x, "x", torch.bfloat16, (Tn, Bp, minor), x.device)
    if bb <= 0 or Bp % bb or minor % 8 or x.data_ptr() % 16:
        raise ValueError(f"bulk_double: bb {bb} must divide Bp {Bp}, minor {minor} be a "
                         f"multiple of 8 and x 16-byte aligned")
    out = torch.empty_like(x)
    native.check(native.library().cld_dma_probe(
        x.data_ptr(), out.data_ptr(), Tn, Bp, bb, minor, native.stream_ptr(x.device)),
        "dma_probe")
    native.count_launch("dma_probe")
    return out


def probe_input(minor: int, slice_batch: bool, device) -> torch.Tensor:
    """The TPU probe's input: arange(T Bp minor) in bf16, times 1e-3."""
    Bp = B if slice_batch else BB
    x = torch.arange(T * Bp * minor, dtype=torch.float32).to(torch.bfloat16) * 1e-3
    return x.reshape(T, Bp, minor).to(device)


def copy_shape(minor: int, slice_batch: bool) -> dict:
    """What one case launches: CTAs, bulk copies per CTA and bytes each."""
    Bp = B if slice_batch else BB
    return dict(ctas=-(-T // STEPS_PER_CTA) * (Bp // BB), copies_per_cta=STEPS_PER_CTA,
                bytes_per_copy=BB * minor * 2, shared_bytes=STEPS_PER_CTA * BB * minor * 2)


def run_cases(device) -> List[dict]:
    """Each case once: the copy shape and whether `bulk_double` equals 2 x
    bit for bit."""
    results = []
    for name, minor, sl in CASES:
        x = probe_input(minor, sl, device)
        out = bulk_double(x, BB)
        results.append(dict(case=name, minor=minor, batch_slice=sl,
                            exact=bool(torch.equal(out, 2 * x)), **copy_shape(minor, sl)))
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
