"""Fused 2-layer LSTM decoder core: CUDA kernels, plain versions, autograd.

Counterpart of `cld_tpu/ops/lstm_pallas.py`. The guided sampler runs the VAE
decoder and its VJP at every denoise step; the sequential core of that
decoder is one forward kernel and one reverse-sweep kernel (`csrc/lstm.cu`,
in bf16 `csrc/lstm_bf16.cu`), wrapped as the autograd Function `Lstm2Core`:

* forward: xg1 [B, T, 4H] (= z @ Wx1 + b1, computed outside), h0 [B, H]
  (initial hidden of BOTH layers, cell states zero), Wh1 [H, 4H],
  W2 [2H, 4H] (input rows over recurrent rows), b2 [4H] -> y [B, T, H],
  saving the h1, c1, c2 sequences;
* backward: the reverse-sweep kernel emits the pre-activation gate
  cotangents dg1, dg2 [B, T, 4H]; everything else falls out of them as
  batched matmuls (as `lstm_pallas.py:697-718` does outside its kernel):
  dxg1 = dg1, dWh1 = h1prev^T dg1, dW2 = [h1; h2prev]^T dg2,
  db2 = sum dg2, dh0 = dg1[:, 0] Wh1^T + dg2[:, 0] W2[H:]^T.
  The VJP is exact in all five arguments.

Dispatch is by the device of the tensors: CUDA tensors launch the kernels
(or the wrapper raises), CPU tensors take the plain PyTorch versions
`lstm2_core_ref` / `lstm2_bwd_ref`, which compute the same functions.

Two storage types, picked by the inputs' dtype (one dtype for all of them,
else the wrapper raises; there is no silent cast): float32, and bfloat16,
the TPU kernels' production configuration (`lstm_pallas.py:742-753`). Under
bf16 the sequences, h0 and the weights are stored in bf16; each matmul
operand is rounded to bf16 (the carried h, the dg vectors), the products
are summed in f32, and the gate math and the c / dh / dc carries stay f32,
as the Pallas kernels' `mm(a, w) = dot(a.astype(w.dtype), w, f32)` does.
The f32 sweeps are `csrc/lstm.cu`; the bf16 ones are other kernels, on the
tensor cores (`csrc/lstm_bf16.cu`), whose launches count as
`lstm2_fwd_bf16` / `lstm2_bwd_bf16`. `fused_decode_actions` stores in bf16
inside a bf16 autocast region (`ops.precision`).

Hidden sizes: every H in [1, 320], the range in which the JAX package's
Pallas kernels run both sweeps (`check_hidden`). The wrapper pads H to the
kernels' granularity with zero units (`padded_hidden`, `pad_blocks` and its
exact inverse `unpad_blocks`: a zero unit stays exactly zero in every state
and cotangent, and adds nothing to the real ones), launches at the padded
size and slices the outputs back. Padded H <= 64 (a multiple of 8) goes to
`lstm.cu` / `lstm_bf16.cu`, which keep each thread's weights in registers,
in an order of their own: `pack_weights` lays Wh1 and W2 out that way
before each launch (one gather; "fwd" / "bwd" f32 floats for `lstm.cu`,
"fwd_bf16" / "bwd_bf16" bf16 mma fragments for `lstm_bf16.cu`, no f32
copy), `unpack_weights` inverts it; they run `rows_per_cta` (f32) or
`ROWS_PER_CTA_BF16` batch rows in each CTA. Padded H in [80, 320] (a
multiple of 16) goes to `csrc/lstm_wide.cu`, which spreads the units over a
thread-block cluster of `wide_cluster` CTAs ("wide_fwd", "wide_gates",
"wide_chain" layouts, and "wide_gates_bf16", "wide_chain_bf16" for the bf16
reverse sweep's tensor-core tiles), counted as `lstm2_fwd_wide` /
`lstm2_bwd_wide` and their `_bf16` twins. The reverse sweep there is a gates
GEMM and a chain whose rows a cluster (8 or 16) `wide_bwd_plan` picks.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from cld_tpu_torch.ops import native
from cld_tpu_torch.ops.precision import autocast_dtype, no_autocast


class LSTMDecodeParams(NamedTuple):
    """Concatenated decoder weights (gate order i, f, g, o).

    Wc [C, H], bc [H] (cond2hidden); Wx1 [L, 4H], Wh1 [H, 4H], b1 [4H];
    W2 [2H, 4H], b2 [4H]; Wo [H, 2], bo [2] (hid2act)."""

    Wc: torch.Tensor
    bc: torch.Tensor
    Wx1: torch.Tensor
    Wh1: torch.Tensor
    b1: torch.Tensor
    W2: torch.Tensor
    b2: torch.Tensor
    Wo: torch.Tensor
    bo: torch.Tensor


def extract_decoder_params(decoder) -> LSTMDecodeParams:
    """`models.vae.LSTMDecoder` (reference torch layout: Linear [out, in],
    fused-gate LSTM weights [4H, in], two summed biases) -> the kernels'
    [in, out] layout, contiguous."""
    lstm = decoder.lstm
    c = lambda w: w.t().contiguous()
    return LSTMDecodeParams(
        Wc=c(decoder.cond2hidden.weight),
        bc=decoder.cond2hidden.bias,
        Wx1=c(lstm.weight_ih_l0),
        Wh1=c(lstm.weight_hh_l0),
        b1=lstm.bias_ih_l0 + lstm.bias_hh_l0,
        W2=torch.cat([lstm.weight_ih_l1.t(), lstm.weight_hh_l1.t()], dim=0).contiguous(),
        b2=lstm.bias_ih_l1 + lstm.bias_hh_l1,
        Wo=c(decoder.hid2act.weight),
        bo=decoder.hid2act.bias,
    )


def _gate_act(pre: torch.Tensor, H: int):
    i = torch.sigmoid(pre[..., 0 * H : 1 * H])
    f = torch.sigmoid(pre[..., 1 * H : 2 * H])
    g = torch.tanh(pre[..., 2 * H : 3 * H])
    o = torch.sigmoid(pre[..., 3 * H : 4 * H])
    return i, f, g, o


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _math_dtype(dt: torch.dtype) -> torch.dtype:
    """The plain versions' arithmetic type: at least float32 (float64 stays)."""
    return torch.promote_types(dt, torch.float32)


def _mm(a: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """a @ w with a rounded to the storage type dt first (w holds dt values
    in the math type): exact products, sums in the math type."""
    return a.to(dt).to(w.dtype) @ w


def lstm2_core_ref(xg1, h0, Wh1, W2, b2) -> Tuple[torch.Tensor, ...]:
    """Plain forward: -> (y, h1s, c1s, c2s), each [B, T, H] in xg1's dtype.
    Differentiable by autograd, which makes it the reference for
    `Lstm2Core`'s VJP. The math runs in at least float32; under bf16 storage
    the matmul operands round to bf16 and the outputs are stored rounded (see
    the module docstring), at float32 every cast is the identity."""
    dt = xg1.dtype
    acc = _math_dtype(dt)
    with no_autocast(xg1.device.type):
        H = h0.shape[-1]
        Wh1, W2, b2, h0 = Wh1.to(acc), W2.to(acc), b2.to(acc), h0.to(acc)
        h1, h2 = h0, h0
        c1 = c2 = torch.zeros_like(h0)
        ys, h1s, c1s, c2s = [], [], [], []
        for t in range(xg1.shape[1]):
            i1, f1, g1, o1 = _gate_act(xg1[:, t].to(acc) + _mm(h1, Wh1, dt), H)
            c1 = f1 * c1 + i1 * g1
            h1 = o1 * torch.tanh(c1)
            i2, f2, g2, o2 = _gate_act(_mm(torch.cat([h1, h2], -1), W2, dt) + b2, H)
            c2 = f2 * c2 + i2 * g2
            h2 = o2 * torch.tanh(c2)
            ys.append(h2)
            h1s.append(h1)
            c1s.append(c1)
            c2s.append(c2)
        st = lambda s: torch.stack(s, dim=1).to(dt)
        return st(ys), st(h1s), st(c1s), st(c2s)


def lstm2_bwd_ref(dy, xg1, h0, Wh1, W2, b2, h1s, c1s, ys, c2s):
    """Plain reverse sweep: recompute each step's gates from the saved
    states, return the gate cotangents (dg1, dg2), each [B, T, 4H] in xg1's
    dtype. Under bf16 storage the dg vectors round to bf16 as stored and as
    the operands of the W^T products; the carries stay in the math type."""
    with no_autocast(xg1.device.type):
        return _lstm2_bwd_ref(dy, xg1, h0, Wh1, W2, b2, h1s, c1s, ys, c2s)


def _lstm2_bwd_ref(dy, xg1, h0, Wh1, W2, b2, h1s, c1s, ys, c2s):
    B, T, H4 = xg1.shape
    H = H4 // 4
    dt = xg1.dtype
    acc = _math_dtype(dt)
    dy, xg1, h0, h1s, c1s, ys, c2s = (a.to(acc) for a in (dy, xg1, h0, h1s, c1s, ys, c2s))
    Wh1, W2, b2 = Wh1.to(acc), W2.to(acc), b2.to(acc)
    zero = torch.zeros_like(h0)
    dh1c = dc1c = dh2c = dc2c = zero
    dg1 = torch.empty_like(xg1, dtype=dt)
    dg2 = torch.empty_like(xg1, dtype=dt)
    W2t = W2.t()
    Wh1t = Wh1.t()
    for t in range(T - 1, -1, -1):
        h1p = h1s[:, t - 1] if t > 0 else h0
        c1p = c1s[:, t - 1] if t > 0 else zero
        h2p = ys[:, t - 1] if t > 0 else h0
        c2p = c2s[:, t - 1] if t > 0 else zero
        i1, f1, g1, o1 = _gate_act(xg1[:, t] + _mm(h1p, Wh1, dt), H)
        i2, f2, g2, o2 = _gate_act(_mm(torch.cat([h1s[:, t], h2p], -1), W2, dt) + b2, H)

        dh2 = dy[:, t] + dh2c
        tc2 = torch.tanh(c2s[:, t])
        do2 = dh2 * tc2
        dc2 = dc2c + dh2 * o2 * (1.0 - tc2 * tc2)
        d2 = torch.cat([
            dc2 * g2 * i2 * (1.0 - i2),
            dc2 * c2p * f2 * (1.0 - f2),
            dc2 * i2 * (1.0 - g2 * g2),
            do2 * o2 * (1.0 - o2),
        ], dim=-1)
        dxh = _mm(d2, W2t, dt)  # [B, 2H]

        dh1 = dxh[:, :H] + dh1c
        tc1 = torch.tanh(c1s[:, t])
        do1 = dh1 * tc1
        dc1 = dc1c + dh1 * o1 * (1.0 - tc1 * tc1)
        d1 = torch.cat([
            dc1 * g1 * i1 * (1.0 - i1),
            dc1 * c1p * f1 * (1.0 - f1),
            dc1 * i1 * (1.0 - g1 * g1),
            do1 * o1 * (1.0 - o1),
        ], dim=-1)
        dg1[:, t] = d1
        dg2[:, t] = d2
        dh1c, dc1c, dh2c, dc2c = _mm(d1, Wh1t, dt), dc1 * f1, dxh[:, H:], dc2 * f2
    return dg1, dg2


# ---------------------------------------------------------------------------
# the kernels' weight layout, hidden sizes and grid
# ---------------------------------------------------------------------------

LANES = 8  # lanes of one warp that own a hidden unit (`kLanes` in csrc/lstm.cu)
H_RANGE = range(8, 65, 8)  # hidden sizes `lstm.cu` and `lstm_bf16.cu` are built for
MAX_HIDDEN = 320  # the largest H at which the JAX package's kernels run both sweeps
WIDE_GRAIN = 16  # `lstm_wide.cu` takes H a multiple of this in [80, MAX_HIDDEN]
COEF_PLANES = 13  # reverse-sweep coefficients per (b, t, unit) (`kPlanes`)


def check_hidden(H: int) -> None:
    """Raise ValueError unless the CUDA kernels take hidden size H."""
    if not 1 <= H <= MAX_HIDDEN:
        raise ValueError(f"LSTM kernels: hidden size {H} is not supported; they take H in "
                         f"[1, {MAX_HIDDEN}]")


def padded_hidden(H: int) -> int:
    """The hidden size a kernel runs H at: H <= 64 rounds up to a multiple
    of 8 (`lstm.cu`, `lstm_bf16.cu`), a larger H to a multiple of 16
    (`lstm_wide.cu`)."""
    check_hidden(H)
    grain = LANES if H <= H_RANGE[-1] else WIDE_GRAIN
    return -(-H // grain) * grain


def pad_blocks(a: torch.Tensor, dim: int, blocks: int, H: int, Hp: int) -> torch.Tensor:
    """Axis `dim` of `a` as `blocks` blocks of H units (the four gates of a
    [.., 4H] axis, the two inputs of W2's rows, one block for a state) ->
    each block zero-padded to Hp units. `unpad_blocks` is its exact inverse;
    Hp == H returns `a` itself."""
    if Hp == H:
        return a
    dim %= a.dim()
    shape = a.shape
    a = a.reshape(*shape[:dim], blocks, H, *shape[dim + 1:])
    pad = [0, 0] * (a.dim() - dim - 2) + [0, Hp - H]
    out = torch.nn.functional.pad(a, pad)
    return out.reshape(*shape[:dim], blocks * Hp, *shape[dim + 1:])


def unpad_blocks(a: torch.Tensor, dim: int, blocks: int, H: int, Hp: int) -> torch.Tensor:
    """Inverse of `pad_blocks`: the first H units of each block, contiguous."""
    if Hp == H:
        return a
    dim %= a.dim()
    shape = a.shape
    a = a.reshape(*shape[:dim], blocks, Hp, *shape[dim + 1:])
    a = a.narrow(dim + 1, 0, H).reshape(*shape[:dim], blocks * H, *shape[dim + 1:])
    return a.contiguous()


# how each input of the sweeps is laid out over the hidden units: (axis,
# blocks of H) pairs; sequences and h0 carry one block, gate axes four,
# W2's rows two (the h1 and h2 inputs)
_GATES, _UNITS = (-1, 4), (-1, 1)
_PAD_LAYOUT = dict(xg1=(_GATES,), h0=(_UNITS,), Wh1=((0, 1), _GATES), W2=((0, 2), _GATES),
                   b2=(_GATES,), dy=(_UNITS,), h1s=(_UNITS,), c1s=(_UNITS,), ys=(_UNITS,),
                   c2s=(_UNITS,))


def pad_hidden(name: str, a: torch.Tensor, H: int, Hp: int) -> torch.Tensor:
    """One sweep input (by its name in `lstm2_fwd` / `lstm2_bwd`) padded from
    H to Hp units along each of its hidden axes."""
    for dim, blocks in _PAD_LAYOUT[name]:
        a = pad_blocks(a, dim, blocks, H, Hp)
    return a


ROWS_PER_CTA = (1, 2)  # the f32 kernels' instantiations


def rows_per_cta(B: int, sms: int) -> int:
    """Batch rows per CTA of both f32 sweeps: one while the B rows fit the
    card's `sms` multiprocessors (one CTA each), two beyond. A step's time
    grows with the rows a CTA carries, nearly in proportion from four rows
    on, so on an H100 two rows in several waves beat four rows in one."""
    return 1 if B <= sms else 2


# Batch rows per CTA of both bf16 sweeps, at any B: the even slots of one
# mma N tile of eight, so that each lane owns one cell (`lstm_bf16.cu`).
ROWS_PER_CTA_BF16 = 4
COEF_PLANES_BF16 = 12  # the bf16 and wide reverse sweeps' coefficients per (b, t, unit)


def _lane_elems(n: int) -> torch.Tensor:
    """[LANES, n // LANES]: the indices, into a vector of n, that lane l of a
    unit reads, in the order the kernels walk them. Lane l's m-th element is
    (m // v * LANES + l) * v + m % v, with v = 4 (float4 reads) when each lane
    has a multiple of 4 elements, else 1: the eight lanes read eight
    consecutive float4s (or floats)."""
    per = n // LANES
    v = 4 if per % 4 == 0 else 1
    m = torch.arange(per)
    return ((m // v) * LANES + torch.arange(LANES)[:, None]) * v + m % v


def mma_a_fragment() -> Tuple[torch.Tensor, torch.Tensor]:
    """Where each bf16 of a lane's A fragment of `mma.m16n8k16` sits in its
    16 x 16 tile: (row, column), each [4 registers, 32 lanes, 2 halves].
    Register r holds row lane/4 (+8 for odd r), columns 2 (lane%4) and +1
    (+8 for r >= 2), the lower column in the lower half."""
    r = torch.arange(4)[:, None, None]
    lane = torch.arange(32)[None, :, None]
    e = torch.arange(2)[None, None, :]
    return lane // 4 + 8 * (r % 2), 2 * (lane % 4) + e + 8 * (r // 2)


def _fwd_bf16_index(H: int, pad: int) -> torch.Tensor:
    """"fwd_bf16": the forward's and the gates kernel's A tiles, W^T with M
    = gate columns and K = the inputs. Warp u of a layer owns units 8u ..
    8u+7: m-tile 0 holds their gates i (rows 0-7) and f (rows 8-15), m-tile 1
    g and o. Tiles [layer-1 warps][m-tile][k-tile] (Wh1), then [layer-2
    warps][m-tile][operand][k-tile] (operand 0: W2[:H], 1: W2[H:]), each
    [4, 32, 2] as `mma_a_fragment`; inputs k >= H are zero (`pad`)."""
    G, KT, UB = 4 * H, -(-H // 16), H // 8
    m, kk = mma_a_fragment()
    u = torch.arange(UB)[:, None, None, None, None, None, None]
    mt = torch.arange(2)[None, :, None, None, None, None, None]
    op = torch.arange(2)[None, None, :, None, None, None, None]
    kt = torch.arange(KT)[None, None, None, :, None, None, None]
    col = (2 * mt + m // 8) * H + 8 * u + m % 8
    k = 16 * kt + kk
    l1 = torch.where(k < H, k * G + col, pad)[:, :, 0]  # [UB, 2, KT, 4, 32, 2]
    l2 = torch.where(k < H, H * G + (op * H + k) * G + col, pad)  # [UB, 2, 2, KT, 4, 32, 2]
    return torch.cat((l1.reshape(-1), l2.reshape(-1)))


def _bwd_bf16_index(H: int, pad: int) -> torch.Tensor:
    """"bwd_bf16": the chain's A tiles, W with M = 16 units and K = the 4H
    gate columns. Tiles [role][m-tile][k-tile] for the roles W2[H:] (rows H +
    unit), W2[:H] and Wh1 (rows unit), each [4, 32, 2] as `mma_a_fragment`;
    units >= H are zero (`pad`)."""
    G, MT, KT = 4 * H, -(-H // 16), H // 4
    m, kk = mma_a_fragment()
    mt = torch.arange(MT)[:, None, None, None, None]
    kt = torch.arange(KT)[None, :, None, None, None]
    unit = 16 * mt + m
    k = 16 * kt + kk
    rows = (H * G + (H + unit) * G, H * G + unit * G, unit * G)  # into cat(Wh1, W2)
    return torch.stack([torch.where(unit < H, r + k, pad) for r in rows]).reshape(-1)


WIDE_CLUSTERS = (8, 16)  # `lstm_wide.cu`'s cluster sizes (16 is non-portable)
WIDE_SLICE_BYTES = 160 * 1024  # a CTA's weight slice at cluster 8, at most


def wide_cluster(H: int, dtype: torch.dtype) -> int:
    """CTAs per cluster of `lstm_wide.cu` at padded hidden size H: 8 while a
    CTA's slice of Wh1 and W2 (12 H^2 / 8 values) leaves room for the
    buffers in 227 KB of shared memory, else 16. In bf16 that is 8 up to H =
    224, in f32 up to 160."""
    elem = 2 if dtype == torch.bfloat16 else 4
    return WIDE_CLUSTERS[0] if 12 * H * H * elem // 8 <= WIDE_SLICE_BYTES else WIDE_CLUSTERS[1]


WIDE_ROWS = (8, 16)  # batch rows a cluster of the f32 wide forward owns (its instantiations)
# a step's time at each R, relative to R = 8's: the FMAs double from 8 to 16
# rows, the exchange and the wait do not (an H100 at H = 128 and 320, both
# with the slice in shared memory and read from L2: 1.8x; `wide_rows`)
WIDE_ROW_COST = {8: 1.0, 16: 1.8}
WIDE_NO_PLAN = 1  # cudaErrorInvalidValue: `wide_f32_config` has no plan at (H, C, R)


class WidePlan(NamedTuple):
    """The f32 wide forward's plan at one row count, as `wide_f32_config` in
    csrc/lstm_wide.cu makes it (`lstm2_wide_fwd_f32_kernel`): rows a
    cluster, chunks of K (S), threads a CTA (6 U S), the weight slice in
    shared memory or not, dynamic shared memory bytes; and the compiler's
    verdict on its instantiation: registers and local memory bytes (spills)
    per thread, max threads per block, clusters the card holds at once."""

    rows: int
    chunks: int
    threads: int
    resident: bool
    smem: int
    registers: int
    local_bytes: int
    max_threads: int
    max_active_clusters: int


@functools.lru_cache(maxsize=None)
def wide_fwd_plan(device: torch.device, H: int, R: int) -> Optional[WidePlan]:
    """The f32 wide forward's plan at padded H and R rows a cluster on
    `device` (`cld_lstm2_wide_fwd_f32_query`), or None where the kernel has
    none (the weight slice would leave shared memory at R where R = 8 keeps
    it there)."""
    out = (ctypes.c_int * 8)()
    with torch.cuda.device(device):
        err = native.library().cld_lstm2_wide_fwd_f32_query(
            H, wide_cluster(H, torch.float32), R, ctypes.addressof(out))
    if err == WIDE_NO_PLAN:
        return None
    native.check(err, "lstm2_fwd plan")
    regs, local, max_threads, smem, threads, clusters, chunks, resident = out
    return WidePlan(R, chunks, threads, bool(resident), smem, regs, local, max_threads, clusters)


def wide_rows(B: int, clusters: Dict[int, int], row_cost: Dict[int, float] = WIDE_ROW_COST,
              kernel: str = "lstm2_wide_fwd_f32_kernel") -> int:
    """Rows a cluster of a wide sweep owns at batch B, from `clusters` (R ->
    clusters of that instantiation the card holds at once): the least waves
    of ceil(B / R) row tiles times a step's cost at R (`row_cost`: the f32
    forward's `WIDE_ROW_COST` by default, the chain's `CHAIN_ROW_COST`), the
    fewer rows on a tie. So the row tiles fit one wave where the card holds
    them (B = 128 at H = 128: 8 clusters of 16 rows, where 16 of 8 took two
    waves), and 8 rows stay where 16 would save less than their steps cost
    (the f32 forward at H = 320, B = 128: three waves of 8 rows against two
    of 16). `kernel` names the kernel in the error a card without room for
    one cluster raises."""
    cost = {R: -(-(-(-B // R)) // n) * row_cost[R] for R, n in clusters.items() if n > 0}
    if not cost:
        raise RuntimeError(f"this card cannot hold one cluster of `{kernel}`")
    return min(cost, key=lambda R: (cost[R], R))


def wide_f32_plan(B: int, H: int, device: torch.device) -> WidePlan:
    """The plan the f32 wide forward launches at batch B: `wide_rows` over
    the row counts that have a plan."""
    plans = {R: wide_fwd_plan(device, H, R) for R in WIDE_ROWS}
    plans = {R: pl for R, pl in plans.items() if pl is not None}
    return plans[wide_rows(B, {R: pl.max_active_clusters for R, pl in plans.items()})]


# The reverse sweep's chain (`lstm2_wide_chain_kernel<T, R, KT>`): a step's
# time at 16 rows a cluster relative to 8's, per storage type (an H100 at H
# = 128, B = 64, one wave at either R: the chain's device time with R forced,
# `kernel_ab.py`'s `chain_rows_H128_B64`, 1.75-1.80 in f32, 1.56-1.58 in bf16)
CHAIN_ROW_COST = {torch.float32: {8: 1.0, 16: 1.77}, torch.bfloat16: {8: 1.0, 16: 1.57}}


class ChainPlan(NamedTuple):
    """The wide chain's plan at one row count and storage type, as
    `wide_chain_config` in csrc/lstm_wide.cu makes it: rows a cluster, chunks
    of K (f32), threads a CTA, rows of the CTA's weight slice resident in
    shared memory (f32; of 4 H / C), k-tiles of its A fragments (bf16),
    dynamic shared memory bytes; and the compiler's verdict on its
    instantiation: registers and local memory bytes (spills) per thread, max
    threads per block, clusters the card holds at once."""

    rows: int
    chunks: int
    threads: int
    resident_rows: int
    k_tiles: int
    smem: int
    registers: int
    local_bytes: int
    max_threads: int
    max_active_clusters: int


@functools.lru_cache(maxsize=None)
def wide_chain_plan(device: torch.device, H: int, R: int,
                    dtype: torch.dtype) -> Optional[ChainPlan]:
    """The wide chain's plan at padded H, R rows a cluster and storage dtype
    on `device` (`cld_lstm2_wide_chain_query`), or None where it has none
    (its buffers alone overflow shared memory: R = 16 at H = 320)."""
    out = (ctypes.c_int * 9)()
    with torch.cuda.device(device):
        err = native.library().cld_lstm2_wide_chain_query(
            H, wide_cluster(H, dtype), R, int(dtype == torch.bfloat16), ctypes.addressof(out))
    if err == WIDE_NO_PLAN:
        return None
    native.check(err, "lstm2_bwd plan")
    regs, local, max_threads, smem, threads, clusters, chunks, kres, k_tiles = out
    return ChainPlan(R, chunks, threads, kres, k_tiles, smem, regs, local, max_threads, clusters)


def wide_bwd_plan(B: int, H: int, dtype: torch.dtype, device: torch.device) -> ChainPlan:
    """The chain plan the wide reverse sweep launches at batch B: `wide_rows`
    with the chain's `CHAIN_ROW_COST` over the row counts that have a plan."""
    plans = {R: wide_chain_plan(device, H, R, dtype) for R in WIDE_ROWS}
    plans = {R: pl for R, pl in plans.items() if pl is not None}
    R = wide_rows(B, {R: pl.max_active_clusters for R, pl in plans.items()},
                  CHAIN_ROW_COST[dtype], "lstm2_wide_chain_kernel")
    return plans[R]


GATES_UNITS = 16  # hidden units of a gates-GEMM tile of `lstm_wide.cu` (`kGUnits`)


def gates_tile_units(bf16: bool) -> torch.Tensor:
    """[64]: the unit, of a gates tile's 16, that each of its 64 columns
    holds; column g 16 + m is gate g. f32 ("wide_gates"): unit m. bf16
    ("wide_gates_bf16"): m = 8 ub + c is column c of the gate's n-tile ub,
    unit 4 (c // 2) + 2 ub + c % 2, so that the mma C fragment of lane tq
    (columns 2 tq, 2 tq + 1 of each n-tile) holds units 4 tq .. 4 tq + 3."""
    m = torch.arange(GATES_UNITS).repeat(4)
    if not bf16:
        return m
    ub, c = m // 8, m % 8
    return 4 * (c // 2) + 2 * ub + c % 2


def chain_k_tiles(H: int, C: int) -> int:
    """k-tiles of 16 over a CTA's 4 H / C gate columns: the bf16 chain's A
    fragments ("wide_chain_bf16", zero-padded past 4 H / C)."""
    return -(-4 * (H // C) // 16)


def _wide_index(kind: str, H: int, C: int) -> torch.Tensor:
    """The wide layouts as indices into cat(Wh1, W2) [3H, 4H], flattened
    (12 H^2: the zero a bf16 tile pads with). CTA q of a cluster of C owns
    units q U .. q U + U - 1 (U = H / C) and their gate columns j = g H + q U
    + u.

    "wide_fwd" [C, H, 12 U]: CTA q's row k, column v = part * 4U + g U + u:
    Wh1[k] (part 0), W2[k] (1), W2[H + k] (2) at column j. "wide_chain" [C,
    4U, 3H]: CTA q's row g U + u (column j), column grp * H + i: W2[H + i]
    (grp 0), W2[i] (1), Wh1[i] (2) at column j. "wide_gates" /
    "wide_gates_bf16" [H / 16, 3H, 64]: unit tile ut's row k of cat(Wh1,
    W2), column g 16 + m: cat[k, g H + 16 ut + unit(m)] (`gates_tile_units`).
    "wide_chain_bf16" [C, H / 16, 3, KT, 4, 32, 2]: CTA q's mma A fragments
    (`mma_a_fragment`) of warp w, group grp and k-tile kt: row m is unit i =
    16 w + m of the group's weights (as "wide_chain"), column 16 kt + k the
    CTA's gate column g U + u (past 4U: the zero)."""
    G = 4 * H
    if kind in ("wide_gates", "wide_gates_bf16"):
        unit = gates_tile_units(kind.endswith("_bf16"))
        col = (torch.arange(4 * GATES_UNITS) // GATES_UNITS) * H + unit  # [64]
        ut = torch.arange(H // GATES_UNITS)[:, None, None] * GATES_UNITS
        return torch.arange(3 * H)[None, :, None] * G + ut + col[None, None, :]
    U = H // C
    q = torch.arange(C)
    gu = torch.arange(4 * U)
    j = (gu // U) * H + q[:, None] * U + gu % U  # [C, 4U]: the CTA's gate columns
    if kind == "wide_fwd":
        rows = torch.tensor([0, H, 2 * H])[:, None] + torch.arange(H)  # Wh1, W2[:H], W2[H:]
        idx = rows[None, :, :, None] * G + j[:, None, None, :]  # [C, 3, H, 4U]
        return idx.permute(0, 2, 1, 3).reshape(C, H, 12 * U)
    rows = torch.stack([2 * H + torch.arange(H), H + torch.arange(H), torch.arange(H)])
    if kind == "wide_chain":
        return rows.reshape(-1)[None, None, :] * G + j[:, :, None]  # [C, 4U, 3H]
    KT = chain_k_tiles(H, C)
    m, kk = mma_a_fragment()  # [4, 32, 2] each
    shape = lambda n, at: [n if d == at else 1 for d in range(7)]  # [C, H/16, 3, KT, 4, 32, 2]
    unit = 16 * torch.arange(H // 16).reshape(shape(H // 16, 1)) + m
    row = rows[torch.arange(3).reshape(shape(3, 2)), unit]
    kcol = 16 * torch.arange(KT).reshape(shape(KT, 3)) + kk
    col = j[q.reshape(shape(C, 0)), kcol.clamp(max=4 * U - 1)]
    return torch.where(kcol < 4 * U, row * G + col, 12 * H * H)


WEIGHT_KINDS = ("fwd", "bwd", "fwd_bf16", "bwd_bf16", "wide_fwd", "wide_chain", "wide_gates",
                "wide_gates_bf16", "wide_chain_bf16")
WIDE_BWD_KINDS = {torch.float32: ("wide_gates", "wide_chain"),
                  torch.bfloat16: ("wide_gates_bf16", "wide_chain_bf16")}


@functools.lru_cache(maxsize=None)
def weight_index(kind: str, H: int, device: torch.device = torch.device("cpu"),
                 cluster: int = WIDE_CLUSTERS[0]) -> torch.Tensor:
    """Packed weight order of one kernel as indices into
    cat(Wh1.flatten(), W2.flatten(), [0]): index 12 H^2 is the zero that
    pads a bf16 tile. `cluster` is the wide layouts' cluster size (see
    `_wide_index`), unused by the others.

    f32 kinds, shape [3, H // 8, 8H, 4], thread t = 8k + l (unit k, lane l)
    of the kernel at [:, :, t]. "fwd": parts Wh1, W2[:H], W2[H:]; entry
    [p, m, t, g] is row e of the part (e = lane l's m-th element of the H
    inputs) at gate column g*H + k. "bwd": parts W2[k], W2[H + k], Wh1[k]
    (rows); entry [p, m, t, c] is column (m*8 + l)*4 + c of that row.

    bf16 kinds, flat, mma A fragments in `lstm_bf16.cu`'s order (a lane
    reads its four 32-bit registers of a tile at [tile][r][lane]):
    "fwd_bf16" (`_fwd_bf16_index`), "bwd_bf16" (`_bwd_bf16_index`)."""
    G, K = 4 * H, H // LANES
    k = torch.arange(H)
    if kind == "fwd":
        rows = _lane_elems(H).t()  # [K, LANES]
        base = torch.tensor([0, H * G, 2 * H * G])
        idx = (base[:, None, None, None, None] + rows[None, :, None, :, None] * G
               + (torch.arange(4) * H)[None, None, None, None, :] + k[None, None, :, None, None])
    elif kind == "bwd":
        cols = _lane_elems(G).reshape(LANES, K, 4).permute(1, 0, 2)  # [K, LANES, 4]
        rows = torch.stack([H + k, 2 * H + k, k])  # W2[k], W2[H + k], Wh1[k] as rows of the cat
        idx = rows[:, None, :, None, None] * G + cols[None, :, None, :, :]
    elif kind == "fwd_bf16":
        return _fwd_bf16_index(H, 12 * H * H).to(device)
    elif kind == "bwd_bf16":
        return _bwd_bf16_index(H, 12 * H * H).to(device)
    elif kind.startswith("wide_") and kind in WEIGHT_KINDS:
        return _wide_index(kind, H, cluster).to(device)
    else:
        raise ValueError(f"weight_index: kind {kind!r}, expected one of {WEIGHT_KINDS}")
    return idx.reshape(3, K, LANES * H, 4).to(device)


def pack_weights(kind: str, Wh1: torch.Tensor, W2: torch.Tensor) -> torch.Tensor:
    """Wh1 [H, 4H], W2 [2H, 4H] -> one kernel's weight layout (see
    `weight_index`), in the weights' dtype: one gather, no copy in another
    type."""
    return pack_layouts(Wh1, W2, kind)[0]


def pack_layouts(Wh1: torch.Tensor, W2: torch.Tensor, *kinds: str) -> Tuple[torch.Tensor, ...]:
    """`pack_weights` of each kind, from one concatenation of the weights
    (and of the zero a bf16 layout pads with, where H is not a multiple of
    16 or, in "wide_chain_bf16", 4 H / C not one): the reverse sweep's two
    layouts in three launches."""
    H = Wh1.shape[0]
    parts = (Wh1.reshape(-1), W2.reshape(-1))
    if any(k.endswith("_bf16") for k in kinds) and (H % 16 or "wide_chain_bf16" in kinds):
        parts += (Wh1.new_zeros(1),)
    flat = torch.cat(parts)
    C = wide_cluster(H, Wh1.dtype)
    return tuple(flat.take(weight_index(k, H, flat.device, C)) for k in kinds)


def unpack_weights(kind: str, packed: torch.Tensor, H: int):
    """Inverse of `pack_weights` -> (Wh1, W2)."""
    idx = weight_index(kind, H, packed.device, wide_cluster(H, packed.dtype)).reshape(-1)
    keep = idx < 12 * H * H  # a bf16 tile's padding holds no weight
    flat = torch.empty(12 * H * H, dtype=packed.dtype, device=packed.device)
    flat[idx[keep]] = packed.reshape(-1)[keep]
    return flat[: 4 * H * H].reshape(H, 4 * H), flat[4 * H * H:].reshape(2 * H, 4 * H)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def kernel_attributes(which: int, H: int, R: int = 1,
                      dtype: torch.dtype = torch.float32) -> dict:
    """The compiler's verdict on the instantiation that runs hidden size H
    (which: 0 the forward, 1 the reverse sweep's gates kernel, 2 its chain;
    `dtype` the storage type; R of `ROWS_PER_CTA` for f32 H <= 64, of
    `WIDE_ROWS` for the f32 wide forward and the wide chain (8 otherwise),
    unused by the others): registers and local memory bytes (spills) per
    thread, max threads per block; for bf16 and the wide kernels the shared
    memory bytes (static, and the wide kernels' dynamic); for the wide
    kernels also the cluster size (1: the gates GEMM), whether the weight
    slice is resident in shared memory, the threads a launch runs and how
    many clusters the card holds at once; for the f32 wide forward and the
    chain also their rows a cluster and chunks of K, for the chain the rows
    of its slice in shared memory (f32) and its k-tiles (bf16)."""
    lib = native.library()
    Hp = padded_hidden(H)
    if Hp > H_RANGE[-1] and which == 0 and dtype == torch.float32:
        R = R if R in WIDE_ROWS else WIDE_ROWS[0]
        plan = wide_fwd_plan(torch.device("cuda", torch.cuda.current_device()), Hp, R)
        if plan is None:
            raise ValueError(f"kernel_attributes: the f32 wide forward has no plan at H={Hp}, "
                             f"R={R}")
        return dict(registers=plan.registers, local_bytes=plan.local_bytes,
                    max_threads=plan.max_threads, shared_bytes=plan.smem, threads=plan.threads,
                    max_active_clusters=plan.max_active_clusters,
                    cluster=wide_cluster(Hp, dtype), resident=int(plan.resident),
                    rows=plan.rows, chunks=plan.chunks)
    if Hp > H_RANGE[-1] and which == 2:
        R = R if R in WIDE_ROWS else WIDE_ROWS[0]
        plan = wide_chain_plan(torch.device("cuda", torch.cuda.current_device()), Hp, R, dtype)
        if plan is None:
            raise ValueError(f"kernel_attributes: the wide chain has no plan at H={Hp}, R={R} "
                             f"({dtype})")
        C = wide_cluster(Hp, dtype)
        return dict(registers=plan.registers, local_bytes=plan.local_bytes,
                    max_threads=plan.max_threads, shared_bytes=plan.smem, threads=plan.threads,
                    max_active_clusters=plan.max_active_clusters, cluster=C,
                    resident=int(plan.resident_rows == 4 * Hp // C), rows=plan.rows,
                    chunks=plan.chunks, resident_rows=plan.resident_rows,
                    k_tiles=plan.k_tiles)
    if Hp > H_RANGE[-1]:
        C = wide_cluster(Hp, dtype)
        vals = native.attributes(lib.cld_lstm2_wide_attributes, which, Hp, C,
                                 int(dtype == torch.bfloat16), n=8)
        return dict(zip(("registers", "local_bytes", "max_threads", "shared_bytes", "cluster",
                         "resident", "threads", "max_active_clusters"), vals))
    if dtype == torch.bfloat16:
        regs, local, threads, smem = native.attributes(lib.cld_lstm2_attributes_bf16, which, Hp,
                                                       n=4)
        return dict(registers=regs, local_bytes=local, max_threads=threads, shared_bytes=smem)
    regs, local, threads = native.attributes(lib.cld_lstm2_attributes, which, Hp, R)
    return dict(registers=regs, local_bytes=local, max_threads=threads)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _shapes(xg1, h0):
    B, T, H4 = xg1.shape
    H = H4 // 4
    check_hidden(H)
    return B, T, H


STORAGE_DTYPES = (torch.float32, torch.bfloat16)  # the kernels' instantiations


def _storage(name: str, **tensors) -> torch.dtype:
    """The one dtype of a call's tensors; raise on mixed dtypes, and on a
    CUDA tensor of a dtype the kernels are not built for."""
    dtypes = {t.dtype for t in tensors.values()}
    if len(dtypes) != 1:
        got = ", ".join(f"{k} {t.dtype}" for k, t in tensors.items())
        raise TypeError(f"{name}: mixed dtypes ({got}); give every tensor one dtype")
    dt = dtypes.pop()
    if next(iter(tensors.values())).device.type == "cuda" and dt not in STORAGE_DTYPES:
        raise TypeError(f"{name}: dtype {dt}; the kernels store float32 or bfloat16")
    return dt


def _require_aligned(**tensors) -> None:
    """The kernels read these 16 bytes at a time: 16-byte aligned storage."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: storage must be 16-byte aligned for the LSTM kernels")


WIDE_UNSCHEDULABLE = 10001  # `lstm_wide.cu`'s code for a cluster the card cannot hold


def _check_wide(err: int, name: str, H: int, C: int, dt: torch.dtype) -> None:
    """Raise on a failed wide launch; a cluster the card cannot schedule is
    refused by name (there is no fallback)."""
    if err == WIDE_UNSCHEDULABLE:
        kernel = ("lstm2_wide_chain_kernel" if name == "lstm2_bwd" else "lstm2_wide_fwd_kernel"
                  if dt == torch.bfloat16 else "lstm2_wide_fwd_f32_kernel")
        raise RuntimeError(f"{name}: this card cannot hold one cluster of {C} CTAs of "
                           f"`{kernel}` (`lstm_wide.cu`) at H={H} ({dt})")
    native.check(err, name)


def lstm2_fwd(xg1, h0, Wh1, W2, b2):
    """Forward sweep -> (y, h1s, c1s, c2s), in the inputs' dtype. CUDA
    tensors launch, at the padded hidden size (`padded_hidden`),
    `lstm2_fwd_kernel` (f32, `csrc/lstm.cu`), `lstm2_fwd_mma_kernel` (bf16,
    `csrc/lstm_bf16.cu`) or above 64 `lstm2_wide_fwd_kernel`
    (`csrc/lstm_wide.cu`); CPU tensors take `lstm2_core_ref`."""
    if xg1.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lstm2_fwd: unsupported device {xg1.device}")
    dt = _storage("lstm2_fwd", xg1=xg1, h0=h0, Wh1=Wh1, W2=W2, b2=b2)
    if xg1.device.type == "cpu":
        return lstm2_core_ref(xg1, h0, Wh1, W2, b2)
    B, T, H = _shapes(xg1, h0)
    dev = xg1.device
    ins = dict(xg1=xg1, h0=h0, Wh1=Wh1, W2=W2, b2=b2)
    for name, shape in (("xg1", (B, T, 4 * H)), ("h0", (B, H)), ("Wh1", (H, 4 * H)),
                        ("W2", (2 * H, 4 * H)), ("b2", (4 * H,))):
        native.require(ins[name], name, dt, shape, dev)
    Hp = padded_hidden(H)
    outs = _fwd_launch(B, T, Hp, dt, **{k: pad_hidden(k, a, H, Hp) for k, a in ins.items()})
    return tuple(unpad_blocks(a, -1, 1, H, Hp) for a in outs)


def _fwd_launch(B, T, H, dt, xg1, h0, Wh1, W2, b2):
    dev = xg1.device
    y, h1s, c1s, c2s = torch.empty((4, B, T, H), dtype=dt, device=dev).unbind(0)
    lib = native.library()
    if H > H_RANGE[-1]:
        C = wide_cluster(H, dt)
        wpk = pack_weights("wide_fwd", Wh1, W2)  # alive until the launch is queued
        ptrs = (xg1.data_ptr(), h0.data_ptr(), wpk.data_ptr(), b2.data_ptr(), y.data_ptr(),
                h1s.data_ptr(), c1s.data_ptr(), c2s.data_ptr(), B, T, H, C)
        if dt == torch.bfloat16:
            err = lib.cld_lstm2_wide_fwd(*ptrs, 1, native.stream_ptr(dev))
        else:
            plan = wide_f32_plan(B, H, dev)
            err = lib.cld_lstm2_wide_fwd_f32(*ptrs, plan.rows, native.stream_ptr(dev))
        _check_wide(err, "lstm2_fwd", H, C, dt)
        native.count_launch("lstm2_fwd_wide_bf16" if dt == torch.bfloat16 else "lstm2_fwd_wide")
        return y, h1s, c1s, c2s
    if dt == torch.bfloat16:
        wpk = pack_weights("fwd_bf16", Wh1, W2)  # alive until the launch is queued
        native.check(lib.cld_lstm2_fwd_bf16(
            xg1.data_ptr(), h0.data_ptr(), wpk.data_ptr(), b2.data_ptr(), y.data_ptr(),
            h1s.data_ptr(), c1s.data_ptr(), c2s.data_ptr(), B, T, H, native.stream_ptr(dev),
        ), "lstm2_fwd")
        native.count_launch("lstm2_fwd_bf16")
        return y, h1s, c1s, c2s
    wpk = pack_weights("fwd", Wh1, W2)
    native.check(lib.cld_lstm2_fwd(
        xg1.data_ptr(), h0.data_ptr(), wpk.data_ptr(), b2.data_ptr(),
        y.data_ptr(), h1s.data_ptr(), c1s.data_ptr(), c2s.data_ptr(), B, T, H,
        rows_per_cta(B, _sm_count(dev)), native.stream_ptr(dev),
    ), "lstm2_fwd")
    native.count_launch("lstm2_fwd")
    return y, h1s, c1s, c2s


def lstm2_bwd(dy, xg1, h0, Wh1, W2, b2, h1s, c1s, ys, c2s):
    """Reverse sweep -> (dg1, dg2), in the inputs' dtype. CUDA tensors
    launch, at the padded hidden size, a gates kernel into an f32 scratch
    buffer and then the chain (one launch counted): `lstm2_bwd_gates_kernel`
    + `lstm2_bwd_kernel` (f32), `lstm2_gates_mma_kernel` +
    `lstm2_chain_mma_kernel` (bf16), or above 64 the gates GEMM
    (`lstm2_wide_gates_f32_kernel`, in bf16 `lstm2_wide_gates_mma_kernel`) +
    `lstm2_wide_chain_kernel` at `wide_bwd_plan`'s rows; CPU tensors take
    `lstm2_bwd_ref`."""
    if xg1.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lstm2_bwd: unsupported device {xg1.device}")
    ins = dict(dy=dy, xg1=xg1, h0=h0, Wh1=Wh1, W2=W2, b2=b2, h1s=h1s, c1s=c1s, ys=ys, c2s=c2s)
    dt = _storage("lstm2_bwd", **ins)
    if xg1.device.type == "cpu":
        return lstm2_bwd_ref(dy, xg1, h0, Wh1, W2, b2, h1s, c1s, ys, c2s)
    B, T, H = _shapes(xg1, h0)
    dev = xg1.device
    seq = (B, T, H)
    for name, shape in (("dy", seq), ("xg1", (B, T, 4 * H)), ("h0", (B, H)),
                        ("Wh1", (H, 4 * H)), ("W2", (2 * H, 4 * H)), ("b2", (4 * H,)),
                        ("h1s", seq), ("c1s", seq), ("ys", seq), ("c2s", seq)):
        native.require(ins[name], name, dt, shape, dev)
    Hp = padded_hidden(H)
    dg = _bwd_launch(B, T, Hp, dt, **{k: pad_hidden(k, a, H, Hp) for k, a in ins.items()})
    return tuple(unpad_blocks(a, -1, 4, H, Hp) for a in dg)


def _aligned(a: torch.Tensor) -> torch.Tensor:
    """`a`, or a copy of it where its storage is not 16-byte aligned (the
    wide reverse sweep reads it 16 bytes at a time)."""
    return a if a.data_ptr() % 16 == 0 else a.clone()


def _bwd_launch(B, T, H, dt, dy, xg1, h0, Wh1, W2, b2, h1s, c1s, ys, c2s, rows=None):
    """The reverse sweep's launch at padded H. `rows` (wide H only) forces
    the chain's rows a cluster, for measuring a step's cost at each R
    (`CHAIN_ROW_COST`); None takes `wide_bwd_plan`'s choice."""
    dev = xg1.device
    dg1 = torch.empty((B, T, 4 * H), dtype=dt, device=dev)
    dg2 = torch.empty_like(dg1)
    lib = native.library()
    sms = _sm_count(dev)
    if H > H_RANGE[-1]:
        C = wide_cluster(H, dt)
        R = wide_bwd_plan(B, H, dt, dev).rows if rows is None else rows
        coef = torch.empty((B, T, COEF_PLANES_BF16, H), dtype=torch.float32, device=dev)
        wgates, wchain = pack_layouts(Wh1, W2, *WIDE_BWD_KINDS[dt])  # alive until queued
        ins = [_aligned(a) for a in (dy, xg1, h0, b2, h1s, c1s, ys, c2s)]
        _check_wide(lib.cld_lstm2_wide_bwd(
            *(a.data_ptr() for a in ins), wgates.data_ptr(), wchain.data_ptr(),
            coef.data_ptr(), dg1.data_ptr(), dg2.data_ptr(), B, T, H, C, R,
            int(dt == torch.bfloat16), native.stream_ptr(dev),
        ), "lstm2_bwd", H, C, dt)
        native.count_launch("lstm2_bwd_wide_bf16" if dt == torch.bfloat16 else "lstm2_bwd_wide")
        return dg1, dg2
    if dt == torch.bfloat16:
        _require_aligned(dy=dy, h0=h0, h1s=h1s, ys=ys)
        coef = torch.empty((B, T, COEF_PLANES_BF16, H), dtype=torch.float32, device=dev)
        wfwd, wbwd = pack_layouts(Wh1, W2, "fwd_bf16", "bwd_bf16")  # alive until the launch is queued
        native.check(lib.cld_lstm2_bwd_bf16(
            dy.data_ptr(), xg1.data_ptr(), h0.data_ptr(), b2.data_ptr(), h1s.data_ptr(),
            c1s.data_ptr(), ys.data_ptr(), c2s.data_ptr(), wfwd.data_ptr(), wbwd.data_ptr(),
            coef.data_ptr(), dg1.data_ptr(), dg2.data_ptr(), B, T, H, sms, native.stream_ptr(dev),
        ), "lstm2_bwd")
        native.count_launch("lstm2_bwd_bf16")
        return dg1, dg2
    _require_aligned(xg1=xg1, Wh1=Wh1, W2=W2, b2=b2)
    coef = torch.empty((B, T, COEF_PLANES, H), dtype=torch.float32, device=dev)
    wpk = pack_weights("bwd", Wh1, W2)
    native.check(lib.cld_lstm2_bwd(
        dy.data_ptr(), xg1.data_ptr(), h0.data_ptr(), Wh1.data_ptr(), W2.data_ptr(),
        b2.data_ptr(), h1s.data_ptr(), c1s.data_ptr(), ys.data_ptr(), c2s.data_ptr(),
        wpk.data_ptr(), coef.data_ptr(), dg1.data_ptr(), dg2.data_ptr(), B, T, H,
        rows_per_cta(B, sms), native.stream_ptr(dev),
    ), "lstm2_bwd")
    native.count_launch("lstm2_bwd")
    return dg1, dg2


class Lstm2Core(torch.autograd.Function):
    """y = core(xg1, h0, Wh1, W2, b2), differentiable in all five inputs.
    Under bf16 storage the weight, bias and h0 gradients are formed in f32
    from the bf16 gate cotangents and returned in each input's dtype, as the
    JAX package's `_core_bwd` does."""

    @staticmethod
    def forward(ctx, xg1, h0, Wh1, W2, b2):
        y, h1s, c1s, c2s = lstm2_fwd(xg1, h0, Wh1, W2, b2)
        ctx.save_for_backward(xg1, h0, Wh1, W2, b2, h1s, c1s, y, c2s)
        return y

    @staticmethod
    def backward(ctx, dy):
        xg1, h0, Wh1, W2, b2, h1s, c1s, y, c2s = ctx.saved_tensors
        with no_autocast(xg1.device.type):
            return Lstm2Core._grads(ctx.needs_input_grad, dy, xg1, h0, Wh1, W2, b2, h1s, c1s,
                                    y, c2s)

    @staticmethod
    def _grads(need, dy, xg1, h0, Wh1, W2, b2, h1s, c1s, y, c2s):
        H = h0.shape[-1]
        dg1, dg2 = lstm2_bwd(dy.to(xg1.dtype).contiguous(), xg1, h0, Wh1, W2, b2, h1s, c1s,
                             y, c2s)
        acc = _math_dtype(xg1.dtype)
        up = lambda a: a.to(acc)
        flat = lambda a: a.reshape(-1, a.shape[-1])
        dWh1 = dW2 = db2 = dh0 = None
        if need[2]:
            h1prev = torch.cat([up(h0)[:, None], up(h1s[:, :-1])], dim=1)
            dWh1 = (flat(h1prev).t() @ flat(up(dg1))).to(Wh1.dtype)
        if need[3]:
            h2prev = torch.cat([up(h0)[:, None], up(y[:, :-1])], dim=1)
            dW2 = (flat(torch.cat([up(h1s), h2prev], dim=-1)).t() @ flat(up(dg2))).to(W2.dtype)
        if need[4]:
            db2 = up(dg2).sum(dim=(0, 1)).to(b2.dtype)
        if need[1]:
            dh0 = (up(dg1[:, 0]) @ up(Wh1).t() + up(dg2[:, 0]) @ up(W2[H:]).t()).to(h0.dtype)
        return dg1, dh0, dWh1, dW2, db2


def lstm2_core(xg1, h0, Wh1, W2, b2) -> torch.Tensor:
    """Fused sequential core -> y [B, T, H] (see `Lstm2Core`)."""
    return Lstm2Core.apply(xg1, h0, Wh1, W2, b2)


def fused_decode_actions(decoder, z: torch.Tensor, cond_feat: torch.Tensor) -> torch.Tensor:
    """Latents z [..., T, L] + cond_feat [..., C] -> scaled actions
    [..., T, 2], through the kernel-backed core. Differentiable in z,
    cond_feat and the decoder weights. Inside a bf16 autocast region the
    weights, z, cond_feat and every intermediate are stored in bf16 (the
    JAX package's `fused_decode_actions` on its accelerator), and the
    actions come out in bf16; elsewhere in the weights' dtype."""
    p = extract_decoder_params(decoder)
    dt = autocast_dtype(z.device.type)
    if dt == torch.float32:
        dt = p.Wc.dtype
    with no_autocast(z.device.type):
        if dt != p.Wc.dtype:
            p = LSTMDecodeParams(*(a.to(dt) for a in p))
        lead = z.shape[:-2]
        T, L = z.shape[-2:]
        z2 = z.reshape(-1, T, L).to(dt)
        cond2 = cond_feat.reshape(-1, cond_feat.shape[-1]).to(dt)
        xg1 = z2 @ p.Wx1 + p.b1
        h0 = cond2 @ p.Wc + p.bc
        y = lstm2_core(xg1.contiguous(), h0.contiguous(), p.Wh1, p.W2, p.b2)
        acts = y @ p.Wo + p.bo
        return acts.reshape(*lead, T, p.Wo.shape[-1])
