"""Map gathers under integer query pixels: CUDA kernels, plain versions,
packing.

Counterpart of the gathers of `cld_tpu/ops/pallas_kernels.py`
(`pack_drivable_bits`, `drivable_bit_gather_pallas`,
`drivable_gather_pallas`, `value_gather_pallas`).

Bit gather: the map binarizes
(value > 0) and packs 8 columns per int8 byte, LSB first; the gather returns
the on-road bit under each query pixel. `MapCollisionLoss` only needs that
bit, so the guided sampler packs the map once per context and gathers from
the packed form at every guidance step.

Unpacked gather (`drivable_gather`): the raw map value under each query
pixel, from an int8 or float32 map. Value gather (`value_gather`): the C
int8 channel bytes under each window-local query of per-window map crops,
the inner step of the banded semantic-map warp (`ops.raster.warp_scene_maps`).

Every wrapper dispatches by device: CUDA tensors launch the kernel
(`csrc/bit_gather.cu`, `csrc/drivable_gather.cu`, `csrc/value_gather.cu`),
CPU tensors take the `_ref` plain version beside it. The gathers have no
gradient (pixel coordinates are detached integers).
"""

from __future__ import annotations

import torch

from cld_tpu_torch.ops import native


def _require_pix(pix: torch.Tensor, shape) -> None:
    native.require(pix, "pix", torch.int32, shape, pix.device)
    if pix.data_ptr() % 8:
        raise ValueError("pix: the kernel reads (col, row) as 8-byte pairs; "
                         "the storage must be 8-byte aligned")


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
    _require_pix(pix, (B, Q, 2))
    native.require(packed, "packed", torch.int8, (B, Hm, W8), pix.device)
    out = torch.empty((B, Q), dtype=torch.float32, device=pix.device)
    lib = native.library()
    native.check(lib.cld_bit_gather(
        pix.data_ptr(), packed.data_ptr(), out.data_ptr(), B, Q, Hm, W8,
        native.stream_ptr(pix.device),
    ), "bit_gather")
    native.count_launch("bit_gather")
    return out


def drivable_gather_ref(pix: torch.Tensor, drivable: torch.Tensor) -> torch.Tensor:
    """Plain version: pix [B, Q, 2] int32 (col, row), drivable [B, H, W]
    -> [B, Q] f32 map values. Coordinates clamp to the map, as in the
    kernel."""
    B = pix.shape[0]
    Hm, W = drivable.shape[1:]
    col = pix[..., 0].long().clamp(0, W - 1)
    row = pix[..., 1].long().clamp(0, Hm - 1)
    b = torch.arange(B, device=pix.device)[:, None]
    return drivable[b, row, col].to(torch.float32)


def drivable_gather_vector(pix: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether `drivable_gather`'s kernel takes its 16-byte path for pix
    [B, Q, 2] and out [B, Q]: Q a multiple of its group of 4 queries, and
    pix and out 16-byte aligned, so that every group starts aligned. Else it
    takes the scalar path (8-byte pix loads, scalar stores)."""
    return pix.shape[1] % 4 == 0 and pix.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0


def drivable_gather_attributes(dtype: torch.dtype, vec: bool) -> dict:
    """The compiler's verdict on the kernel's instantiation for an int8 or
    float32 map, on its 16-byte path or its scalar one: registers and local
    memory bytes (spills) per thread, max threads per block."""
    if dtype not in (torch.int8, torch.float32):
        raise TypeError(f"drivable: dtype {dtype}, expected int8 or float32")
    regs, local, threads = native.attributes(
        native.library().cld_drivable_gather_attributes, int(dtype == torch.float32), int(vec))
    return dict(registers=regs, local_bytes=local, max_threads=threads)


def drivable_gather(pix: torch.Tensor, drivable: torch.Tensor) -> torch.Tensor:
    """Map value per query point: pix [B, Q, 2] int32 (col, row), drivable
    [B, H, W] int8 or float32 -> [B, Q] f32. An int8 map's values come back
    exactly. A float32 map's values come back as they are; the JAX package's
    kernel rounds float maps through bf16 (sign-preserving; consumers
    threshold at <= 0), so the two agree exactly only where the values are
    bf16-representable, e.g. {0, 1} masks."""
    if pix.device.type == "cpu":
        return drivable_gather_ref(pix, drivable)
    if pix.device.type != "cuda":
        raise ValueError(f"drivable_gather: unsupported device {pix.device}")
    B, Q, _ = pix.shape
    Hm, W = drivable.shape[1:]
    _require_pix(pix, (B, Q, 2))
    lib = native.library()
    if drivable.dtype == torch.int8:
        fn = lib.cld_drivable_gather_i8
    elif drivable.dtype == torch.float32:
        fn = lib.cld_drivable_gather_f32
    else:
        raise TypeError(f"drivable: dtype {drivable.dtype}, expected int8 or float32")
    native.require(drivable, "drivable", drivable.dtype, (B, Hm, W), pix.device)
    out = torch.empty((B, Q), dtype=torch.float32, device=pix.device)
    native.check(fn(pix.data_ptr(), drivable.data_ptr(), out.data_ptr(), B, Q, Hm, W,
                    int(drivable_gather_vector(pix, out)), native.stream_ptr(pix.device)),
                 "drivable_gather")
    native.count_launch("drivable_gather")
    return out


def value_gather_ref(pix: torch.Tensor, wins: torch.Tensor) -> torch.Tensor:
    """Plain version: pix [M, Q, 2] int32 (col, row) window-local, wins
    [M, H, W, C] int8 -> [M, Q, C] f32 signed byte values. Coordinates clamp
    to the window, as in the kernel."""
    M = pix.shape[0]
    H, W = wins.shape[1:3]
    col = pix[..., 0].long().clamp(0, W - 1)
    row = pix[..., 1].long().clamp(0, H - 1)
    m = torch.arange(M, device=pix.device)[:, None]
    return wins[m, row, col].to(torch.float32)


def value_gather_attributes(C: int, vec: bool) -> dict:
    """The compiler's verdict on the kernel's instantiation for C channels
    (C = 3 unrolled, any other C in a loop), on its 16-byte path (C = 3, Q a
    multiple of 4, pix and out 16-byte aligned) or its scalar one: registers
    and local memory bytes (spills) per thread, max threads per block."""
    regs, local, threads = native.attributes(
        native.library().cld_value_gather_attributes, C, int(vec))
    return dict(registers=regs, local_bytes=local, max_threads=threads)


def value_gather(pix: torch.Tensor, wins: torch.Tensor) -> torch.Tensor:
    """Channel bytes per query point: pix [M, Q, 2] int32 (col, row),
    pre-clamped into the window by the caller; wins [M, H, W, C] int8
    contiguous -> [M, Q, C] f32 holding each byte as a signed value in
    [-128, 127] (callers recover the unsigned byte with +256 where < 0)."""
    if pix.device.type == "cpu":
        return value_gather_ref(pix, wins)
    if pix.device.type != "cuda":
        raise ValueError(f"value_gather: unsupported device {pix.device}")
    M, Q, _ = pix.shape
    H, W, C = wins.shape[1:]
    _require_pix(pix, (M, Q, 2))
    native.require(wins, "wins", torch.int8, (M, H, W, C), pix.device)
    out = torch.empty((M, Q, C), dtype=torch.float32, device=pix.device)
    lib = native.library()
    native.check(lib.cld_value_gather(
        pix.data_ptr(), wins.data_ptr(), out.data_ptr(), M, Q, H, W, C,
        native.stream_ptr(pix.device),
    ), "value_gather")
    native.count_launch("value_gather")
    return out
