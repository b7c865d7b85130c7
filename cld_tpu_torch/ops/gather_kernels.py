"""Bit-packed drivable-map gather: CUDA kernel, plain version, packing.

Counterpart of the bit-gather part of `cld_tpu/ops/pallas_kernels.py`
(`pack_drivable_bits`, `drivable_bit_gather_pallas`). The map binarizes
(value > 0) and packs 8 columns per int8 byte, LSB first; the gather returns
the on-road bit under each query pixel. `MapCollisionLoss` only needs that
bit, so the guided sampler packs the map once per context and gathers from
the packed form at every guidance step.

`drivable_bit_gather` dispatches by device: CUDA tensors launch
`bit_gather_kernel` (`csrc/bit_gather.cu`), CPU tensors take
`drivable_bit_gather_ref`. The gather has no gradient (pixel coordinates
are detached integers).
"""

from __future__ import annotations

import torch

from cld_tpu_torch.ops import native


def pack_drivable_bits(drivable: torch.Tensor) -> torch.Tensor:
    """[B, H, W] map -> [B, H, ceil(W/8)] int8: bit k of byte w8 holds
    map[:, :, 8*w8 + k] > 0. Bytes >= 128 wrap to negative int8 values, as
    the JAX package stores them; the bit pattern is unchanged."""
    B, H, W = drivable.shape
    wpad = (-W) % 8
    bits = (drivable > 0).to(torch.int32)
    if wpad:
        bits = torch.nn.functional.pad(bits, (0, wpad))
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32,
                           device=drivable.device)
    packed = torch.sum(bits.reshape(B, H, -1, 8) * weights, dim=-1)
    packed = torch.where(packed >= 128, packed - 256, packed)  # signed-byte wrap
    return packed.to(torch.int8)


def drivable_bit_gather_ref(pix: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """Plain version: pix [B, Q, 2] int32 (col, row), packed [B, H, W8] int8
    -> [B, Q] f32 in {0, 1}. Coordinates clamp to the packed map, as in the
    kernel."""
    B = pix.shape[0]
    Hm, W8 = packed.shape[1:]
    col = pix[..., 0].long().clamp(0, 8 * W8 - 1)
    row = pix[..., 1].long().clamp(0, Hm - 1)
    b = torch.arange(B, device=pix.device)[:, None]
    byte = packed[b, row, col >> 3].to(torch.int32) & 0xFF
    return ((byte >> (col & 7)) & 1).to(torch.float32)


def drivable_bit_gather(pix: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """On-road bit per query point: pix [B, Q, 2] int32 (col, row), packed
    [B, H, W8] int8 (`pack_drivable_bits`) -> [B, Q] f32 in {0, 1}."""
    if pix.device.type == "cpu":
        return drivable_bit_gather_ref(pix, packed)
    if pix.device.type != "cuda":
        raise ValueError(f"drivable_bit_gather: unsupported device {pix.device}")
    B, Q, _ = pix.shape
    Hm, W8 = packed.shape[1:]
    native.require(pix, "pix", torch.int32, (B, Q, 2), pix.device)
    native.require(packed, "packed", torch.int8, (B, Hm, W8), pix.device)
    if pix.data_ptr() % 8:
        raise ValueError("pix: the kernel reads (col, row) as 8-byte pairs; "
                         "the storage must be 8-byte aligned")
    out = torch.empty((B, Q), dtype=torch.float32, device=pix.device)
    lib = native.library()
    native.check(lib.cld_bit_gather(
        pix.data_ptr(), packed.data_ptr(), out.data_ptr(), B, Q, Hm, W8,
        native.stream_ptr(pix.device),
    ), "bit_gather")
    native.count_launch("bit_gather")
    return out
