// Two-layer LSTM decoder sweeps in bf16 on Hopper's tensor cores (sm_90a).
//
// Replaces, under bf16 storage (the TPU kernels' production configuration,
// `cld_tpu/ops/lstm_pallas.py:742-753`), the TPU kernels `_fwd_kernel`
// (`lstm_pallas.py:169`, the forward sweep) and `_bwd_kernel_v2` (`:312`,
// the reverse sweep). The f32 sweeps stay in `lstm.cu`. Both take H a
// multiple of 8 in [8, 64]: the wrapper pads a smaller or ragged H with zero
// units, and sends H > 64 (up to 320) to `lstm_wide.cu`.
//
// Numbers: every input and output is bf16. Each recurrent product is
// `mma.sync.m16n8k16.f32.bf16.bf16.f32`, which is what the TPU kernels'
// `dot(a.astype(w.dtype), w, preferred_element_type=f32)` asks for: the
// operand vectors (h in the forward, dg in the reverse sweep) are rounded to
// bf16 once, where the TPU kernels round them, products of two bf16 values
// are exact and the sums run in f32. The c carries, the dh / dc carries and
// the gate math stay f32, with `expf` / `tanhf` as in `lstm.cu`. Every sum
// runs in a fixed order and nothing is atomic, so two launches agree bit for
// bit.
//
// What bounds them: the chain. Each sweep is T = 52 dependent steps; a step
// is two small products per batch row ([H] x [H, 4H] and [2H] x [2H, 4H], or
// their transposes), the gate math of every cell, and a barrier. Bytes
// (~0.002 / 0.004 ms at B = 128) and tensor-core operations are far below
// the chain's latency, so the design cuts what each step issues and waits on:
//
// * Transposed products. A step computes pre^T [4H, rows] = W^T [4H, K] .
//   h^T [K, rows]: the weights are the mma's A operand (M = gate columns, 16
//   a tile) and the batch rows its N operand (8 slots a tile). A CTA's rows
//   fill one N tile, so a step is 12 H^2 / 256 mma tiles (192 at H = 64)
//   whatever the rows, with no M padding.
// * Weights resident in registers for the whole sweep, as A fragments: each
//   warp loads its tiles once from `wpk`, packed by
//   `lstm_kernels.py:pack_weights` ("fwd_bf16" / "bwd_bf16") in fragment
//   order ([tile][register][lane], one coalesced 32-bit load per register).
//   At H = 64 a layer-2 warp holds 64 registers of weights.
// * A warp of the forward owns 8 hidden units and their four gates: its two
//   M tiles are (i; f) and (g; o) of the 8 units, so each lane's
//   accumulators hold all four gates of its cells and the cell update needs
//   no shuffle. H / 8 warps a layer, 8H threads.
// * Four batch rows a CTA (`lstm_kernels.py:ROWS_PER_CTA_BF16`), in the
//   even N slots, so that every lane owns exactly one cell of its warp's 8
//   units x 4 rows (N slot 2 (lane % 4), CTA row lane % 4): the gate math
//   (five transcendentals a cell) is spread over ceil(B / 4) CTAs, in more
//   than one wave beyond 4 x the SM count.
// * The layers run as a wavefront: iteration s computes layer 1 at step s
//   and layer 2 at step s - 1, which read only what iteration s - 1 wrote
//   (h1[s-1], h2[s-2]), so a step costs one barrier, not two.
// * Operands in shared memory: h (forward) or dg (reverse) of the CTA's rows
//   as [slot][k] bf16, double-buffered by parity, rows padded by 8 elements
//   so that each `ldmatrix` phase (8 rows of 16 bytes) hits 32 distinct
//   banks; one `ldmatrix.x4` gives the B fragments of two k-tiles. K = H is
//   padded to a multiple of 16 with zeros (H = 8, 24, 40, 56), never refused.
//
// Reverse sweep (`cld_lstm2_bwd_bf16`), two launches, one for the caller:
// * `lstm2_gates_mma_kernel`, parallel over all B T (b, t) pairs: the gate
//   recompute as a tensor-core GEMM in the forward's tiling (the same packed
//   weights, N = 8 pairs a tile, 64 pairs staged a time, a grid of at most
//   one CTA per SM looping over the pairs), folded with c_t, c_{t-1} into
//   the 12 per-unit coefficients the chain needs (per layer: o (1 - tanh^2
//   c), f, g i (1 - i), c_prev f (1 - f), i (1 - g^2), tanh(c) o (1 - o)),
//   written to an f32 scratch [B, T, 12, H] that the wrapper allocates (at B
//   = 128 it fits the 50 MB L2 between the two launches). The scratch stays
//   f32: f and o (1 - tanh^2 c) multiply the carries 52 times over.
// * `lstm2_chain_mma_kernel`: dh = W dg with M = 16 units a tile, K = the
//   4H gate columns (four accumulator chains, summed in a fixed order). Warp
//   roles per 16-unit tile: W2[H:] dg2 (layer 2's dh carry; its lanes run
//   layer 2's cells), W2[:H] dg2 and Wh1 dg1 (layer 1's dh, two halves of
//   K = 8H that meet through shared memory at a named barrier; the first
//   warp runs layer 1's cells). A wavefront again: iteration s runs layer 2
//   at step T-1-s and layer 1 at step T-s. The Wh1 warps, idle during the
//   cells, bring each step's coefficient and dy rows into a five-stage
//   shared-memory ring by cp.async, three iterations ahead.
// * The outputs leave as plain stores from the lanes that compute them; the
//   forward's xg1 comes in registers one step ahead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kSlots = 8;        // batch slots of an mma N tile
constexpr int kRows = 4;         // batch rows of a CTA, in the even slots
constexpr int kPlanes = 12;      // reverse-sweep coefficients per (b, t, unit)
constexpr int kPairTile = 64;    // (b, t) pairs the gates kernel stages at a time
constexpr int kTileWords = 128;  // 32-bit words of one packed A tile: [4 registers][32 lanes]

// The gate activations, as `lstm.cu` computes them.
__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ bf16 rn(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ unsigned saddr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// d += a b: one m16n8k16 product of bf16 fragments with f32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(saddr(p))
               : "memory");
}

// f(kt, b) for each k-tile's B fragment of x [slot][stride] bf16 in shared
// memory (B[k][n] = x[n][k]). One ldmatrix.x4 reads two k-tiles: lane l
// addresses row l % 8 of matrix l / 8, the matrices being columns 16 kt + 0,
// + 8, + 16, + 24; each lane receives slot lane / 4, columns 2 (lane % 4)
// and + 1 of each, which is the m16n8k16 B fragment.
template <int KT, typename F>
__device__ __forceinline__ void for_b(const bf16* x, int stride, int lane, F&& f) {
#pragma unroll
  for (int kt = 0; kt < KT; kt += 2) {
    const bf16* p = x + (lane & 7) * stride + 16 * kt;
    if (kt + 1 < KT) {
      uint32_t r[4];
      ldsm_x4(r, p + 8 * (lane >> 3));
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      f(kt, b0);
      f(kt + 1, b1);
    } else {
      uint32_t r[2];
      ldsm_x2(r, p + 8 * ((lane >> 3) & 1));
      f(kt, r);
    }
  }
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// 16-byte asynchronous copies from global to shared memory, in per-thread
// groups.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The forward's (and the gates kernel's) tiling at hidden size H.
template <int H>
struct Fwd {
  static constexpr int G = 4 * H;
  static constexpr int KT = (H + 15) / 16;  // k-tiles of an H-wide operand, zero-padded
  static constexpr int KS = 16 * KT + 8;    // operand row stride in bf16 (bank-conflict free)
  static constexpr int UB = H / 8;          // blocks of 8 units = warps per layer
  static constexpr int NT = 64 * UB;        // threads: two layers of UB warps (8H)
};

// A warp's resident weight tiles, [m-tile][operand][k-tile][register]. Packed
// order ("fwd_bf16"): the layer-1 warps' tiles [UB][2][KT], then the layer-2
// warps' [UB][2][2][KT] (operand 0 h1 against W2[:H], 1 h2 against W2[H:]).
// A layer-1 warp has one operand; its second stays zero and unused.
template <int H>
__device__ __forceinline__ void load_fwd_tiles(uint32_t (&a)[2][2][Fwd<H>::KT][4],
                                               const uint32_t* __restrict__ wpk, bool l2, int u,
                                               int lane) {
  constexpr int KT = Fwd<H>::KT, UB = Fwd<H>::UB;
  const uint32_t* w = wpk + (l2 ? (size_t)UB * 2 * KT + (size_t)u * 4 * KT : (size_t)u * 2 * KT) *
                                kTileWords + lane;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int op = 0; op < 2; ++op)
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int tile = (l2 ? mt * 2 + op : mt) * KT + kt;
          a[mt][op][kt][r] = (l2 || op == 0) ? w[tile * kTileWords + r * 32] : 0u;
        }
}

// acc[mt] += (tiles of operand op) . x over K: each B fragment feeds both
// m-tiles.
template <int KT>
__device__ __forceinline__ void gate_products(float (&acc)[2][4], const uint32_t (&a)[2][2][KT][4],
                                              int op, const bf16* x, int stride, int lane) {
  for_b<KT>(x, stride, lane, [&](int kt, const uint32_t (&b)[2]) {
    mma(acc[0], a[0][op][kt], b);
    mma(acc[1], a[1][op][kt], b);
  });
}

// Forward sweep. Outputs y (= h2), h1, c1, c2 sequences, each [B, T, H].
template <int H>
__global__ void __launch_bounds__(8 * H, 1) lstm2_fwd_mma_kernel(
    const bf16* __restrict__ xg1, const bf16* __restrict__ h0, const uint32_t* __restrict__ wpk,
    const bf16* __restrict__ b2, bf16* __restrict__ y, bf16* __restrict__ h1s,
    bf16* __restrict__ c1s, bf16* __restrict__ c2s, int B, int T) {
  using D = Fwd<H>;
  constexpr int KT = D::KT, KS = D::KS, G = D::G;
  __shared__ __align__(16) bf16 hb[2][2][kSlots * KS];  // [layer][parity][slot][k]: h1, h2
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const bool l2 = warp >= D::UB;
  const int unit = 8 * (l2 ? warp - D::UB : warp) + gq;
  const int b0 = blockIdx.x * kRows;

  uint32_t a[2][2][KT][4];
  load_fwd_tiles<H>(a, wpk, l2, l2 ? warp - D::UB : warp, lane);
  bf16* flat = &hb[0][0][0];
  for (int i = threadIdx.x; i < 4 * kSlots * KS; i += D::NT) flat[i] = rn(0.0f);
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * H; i += D::NT) {
    const int r = i / H, k = i % H, b = b0 + r;
    const bf16 v = b < B ? h0[(size_t)b * H + k] : rn(0.0f);
    hb[0][1][2 * r * KS + k] = v;  // h1[-1], read at iteration 0
    hb[1][0][2 * r * KS + k] = v;  // h2[-1], read at iteration 1
  }

  // the lane's cell: N slot 2 tq, batch row b0 + tq
  const int brow = b0 + tq;
  float c = 0.0f, xin[4];  // layer 1: xg1 of the coming step (i, f, g, o); layer 2: b2
#pragma unroll
  for (int q = 0; q < 4; ++q)
    xin[q] = l2 ? ld(b2 + q * H + unit)
                : (brow < B ? ld(xg1 + (size_t)brow * T * G + q * H + unit) : 0.0f);
  __syncthreads();

  for (int s = 0; s <= T; ++s) {
    const int cur = s & 1, prv = cur ^ 1;
    if (l2 ? s > 0 : s < T) {
      float acc[2][4], x[4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][e] = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        x[q] = xin[q];
        if (!l2)  // step s + 1's input projection, in flight during this step
          xin[q] = (brow < B && s + 1 < T)
                       ? ld(xg1 + ((size_t)brow * T + s + 1) * G + q * H + unit)
                       : 0.0f;
      }
      gate_products<KT>(acc, a, 0, hb[0][prv], KS, lane);  // h1[s-1]: both layers
      if (l2) {
        float acc2[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
        gate_products<KT>(acc2, a, 1, hb[1][prv], KS, lane);  // h2[s-2]
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][e] += acc2[mt][e];
      }
      const int step = l2 ? s - 1 : s;
      // C fragment: rows gq (i; g) and gq + 8 (f; o), column 2 tq in
      // registers 0 and 2
      const float ig = sigm(acc[0][0] + x[0]), fg = sigm(acc[0][2] + x[1]);
      const float gg = tanhf(acc[1][0] + x[2]), og = sigm(acc[1][2] + x[3]);
      c = fg * c + ig * gg;
      const bf16 h = rn(og * tanhf(c));
      hb[l2 ? 1 : 0][cur][2 * tq * KS + unit] = h;  // the next products' operand
      if (brow < B) {
        const size_t o = ((size_t)brow * T + step) * H + unit;
        (l2 ? y : h1s)[o] = h;
        (l2 ? c2s : c1s)[o] = rn(c);
      }
    }
    __syncthreads();
  }
}

// Reverse sweep, part 1, parallel over the B T pairs: the 12 coefficients of
// each (pair, unit), coef [B, T, 12, H]: planes 0-5 layer 2 (o (1 - tanh^2 c),
// f, g i (1-i), c_prev f (1-f), i (1-g^2), tanh(c) o (1-o)), 6-11 layer 1.
template <int H>
__global__ void __launch_bounds__(8 * H, 1) lstm2_gates_mma_kernel(
    const bf16* __restrict__ xg1, const bf16* __restrict__ h0, const uint32_t* __restrict__ wpk,
    const bf16* __restrict__ b2, const bf16* __restrict__ h1s, const bf16* __restrict__ c1s,
    const bf16* __restrict__ ys, const bf16* __restrict__ c2s, float* __restrict__ coef, int B,
    int T) {
  using D = Fwd<H>;
  constexpr int KT = D::KT, KS = D::KS, G = D::G, P = kPairTile;
  constexpr int V = H / 8, VS = KS / 8;  // 16-byte vectors of a state row, of a staged row
  __shared__ __align__(16) bf16 xs[3][P * KS];  // h1[t-1], h1[t], h2[t-1] of the staged pairs
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const bool l2 = warp >= D::UB;
  const int unit = 8 * (l2 ? warp - D::UB : warp) + gq;

  uint32_t a[2][2][KT][4];
  load_fwd_tiles<H>(a, wpk, l2, l2 ? warp - D::UB : warp, lane);
  float bias[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) bias[q] = ld(b2 + q * H + unit);
  const bf16* cs = l2 ? c2s : c1s;
  const int N = B * T, tiles = (N + P - 1) / P;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = tile * P;
    __syncthreads();  // the previous tile's operands are read
    for (int i = threadIdx.x; i < 3 * P * VS; i += D::NT) {
      const int op = i / (P * VS), p = (i / VS) % P, v = i % VS, n = n0 + p;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (v < V && n < N) {
        const int b = n / T, t = n % T;
        const bf16* src = op == 1  ? h1s + (size_t)n * H
                          : t > 0  ? (op == 0 ? h1s : ys) + (size_t)(n - 1) * H
                                   : h0 + (size_t)b * H;
        val = reinterpret_cast<const uint4*>(src)[v];
      }
      reinterpret_cast<uint4*>(xs[op] + p * KS)[v] = val;
    }
    __syncthreads();

#pragma unroll 1
    for (int nt = 0; nt < P / kSlots; ++nt) {
      // this lane's pairs n0 + 8 nt + 2 tq + j: their loads are in flight
      // during the products
      float xin[2][4], cv[2], cp[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = n0 + nt * kSlots + 2 * tq + j, t = n % T;
        const bool in = n < N;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          xin[j][q] = l2 ? bias[q] : (in ? ld(xg1 + (size_t)n * G + q * H + unit) : 0.0f);
        cv[j] = in ? ld(cs + (size_t)n * H + unit) : 0.0f;
        cp[j] = in && t > 0 ? ld(cs + (size_t)(n - 1) * H + unit) : 0.0f;
      }
      float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      const int row0 = nt * kSlots * KS;
      gate_products<KT>(acc, a, 0, xs[l2 ? 1 : 0] + row0, KS, lane);
      if (l2) gate_products<KT>(acc, a, 1, xs[2] + row0, KS, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = n0 + nt * kSlots + 2 * tq + j;
        if (n >= N) continue;
        const float ig = sigm(acc[0][j] + xin[j][0]), fg = sigm(acc[0][2 + j] + xin[j][1]);
        const float gg = tanhf(acc[1][j] + xin[j][2]), og = sigm(acc[1][2 + j] + xin[j][3]);
        const float tc = tanhf(cv[j]);
        float* q = coef + ((size_t)n * kPlanes + (l2 ? 0 : 6)) * H + unit;
        q[0] = og * (1.0f - tc * tc);
        q[H] = fg;
        q[2 * H] = gg * ig * (1.0f - ig);
        q[3 * H] = cp[j] * fg * (1.0f - fg);
        q[4 * H] = ig * (1.0f - gg * gg);
        q[5 * H] = tc * og * (1.0f - og);
      }
    }
  }
}

// The chain's tiling at hidden size H.
template <int H>
struct Bwd {
  static constexpr int G = 4 * H;
  static constexpr int MT = (H + 15) / 16;      // m-tiles of 16 units (the last one zero-padded)
  static constexpr int KT = H / 4;              // k-tiles over the 4H gate columns
  static constexpr int GS = G + 8;              // operand row stride in bf16
  static constexpr int NT = 96 * MT;            // threads: three roles of MT warps
  static constexpr int NACC = KT < 4 ? KT : 4;  // independent accumulator chains
  static constexpr int NS = 5;                  // stages of the input ring
  static constexpr int CS = kPlanes * H + 8;    // a staged coefficient row, floats
  static constexpr int DS = H + 8;              // a staged dy row, bf16
  // dynamic shared memory: the input ring, then the dg operands
  static constexpr size_t kRing = (size_t)NS * kRows * (CS * 4 + DS * 2);
  static constexpr size_t kSmem = kRing + (size_t)2 * 2 * kSlots * GS * 2;
};

// Reverse sweep, part 2, the chain: the pre-activation gate cotangents dg1,
// dg2 [B, T, 4H]. wpk ("bwd_bf16"): [3][MT][KT] tiles, roles W2[H:] (layer
// 2's dh carry), W2[:H] and Wh1 (the two halves of layer 1's dh), rows =
// units. The coefficient and dy rows of step t sit in ring stage (T-1-t) %
// NS.
template <int H>
__global__ void __launch_bounds__(96 * Bwd<H>::MT, 1) lstm2_chain_mma_kernel(
    const bf16* __restrict__ dy, const float* __restrict__ coef, const uint32_t* __restrict__ wpk,
    bf16* __restrict__ dg1, bf16* __restrict__ dg2, int B, int T) {
  using D = Bwd<H>;
  constexpr int KT = D::KT, GS = D::GS, G = D::G, MT = D::MT, NACC = D::NACC, NS = D::NS;
  constexpr int CS = D::CS, DS = D::DS, MOVERS = 32 * MT, R = kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  float* cring = reinterpret_cast<float*>(smem);               // [stage][row][CS]
  bf16* dring = reinterpret_cast<bf16*>(cring + NS * R * CS);  // [stage][row][DS]
  bf16* db = reinterpret_cast<bf16*>(smem + D::kRing);         // [dg2, dg1][parity][slot][GS]
  __shared__ float part[MT][4][32];  // Wh1 dg1 of each m-tile, C fragments
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int role = warp / MT, mtile = warp % MT;  // 0: W2[H:] dg2, 1: W2[:H] dg2, 2: Wh1 dg1
  const int b0 = blockIdx.x * R, rows = B - b0 < R ? B - b0 : R;
  const auto dbuf = [&](int layer, int par) { return db + (layer * 2 + par) * kSlots * GS; };

  // a Wh1 thread's share of step t's coefficient and dy rows (one group)
  const auto load_step = [&](int t) {
    if (t >= 0) {
      const int st = (T - 1 - t) % NS;
      constexpr int CV = kPlanes * H / 4, DV = H / 8;  // 16-byte pieces of a row
      for (int i = threadIdx.x - 2 * MOVERS; i < rows * (CV + DV); i += MOVERS) {
        const int r = i / (CV + DV), v = i % (CV + DV);
        const size_t n = (size_t)(b0 + r) * T + t;
        if (v < CV)
          cp_async16(cring + (st * R + r) * CS + 4 * v, coef + n * kPlanes * H + 4 * v);
        else
          cp_async16(dring + (st * R + r) * DS + 8 * (v - CV), dy + n * H + 8 * (v - CV));
      }
    }
    cp_async_commit();
  };

  uint32_t a[KT][4];
  {
    const uint32_t* w = wpk + (size_t)(role * MT + mtile) * KT * kTileWords + lane;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int r = 0; r < 4; ++r) a[kt][r] = w[kt * kTileWords + r * 32];
  }
  // every byte zero (the operands' padding, the ring rows of rows past B),
  // then the first stages
  for (int i = threadIdx.x; i < (int)(D::kSmem / 16); i += D::NT)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  if (role == 2) {
    for (int k = 0; k < NS; ++k) load_step(T - 1 - k);
    cp_async_wait<NS - 2>();  // the first two steps' rows
  }

  // the lane's cells: units 16 mtile + gq + 8 hh, N slot 2 tq, CTA row tq
  const int pl = role == 0 ? 0 : 6;  // the layer's coefficient planes
  int unit[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) unit[hh] = 16 * mtile + gq + 8 * hh;
  float carry[2] = {0.0f, 0.0f};  // the layer's dc carry
  __syncthreads();

  for (int s = 0; s <= T; ++s) {
    const int cur = s & 1, prv = cur ^ 1;
    if (role == 0 ? s < T : s > 0) {
      float acc[NACC][4];
#pragma unroll
      for (int q = 0; q < NACC; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;
      for_b<KT>(dbuf(role == 2 ? 1 : 0, prv), GS, lane,
                [&](int kt, const uint32_t (&b)[2]) { mma(acc[kt % NACC], a[kt], b); });
#pragma unroll
      for (int q = 1; q < NACC; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][e] += acc[q][e];

      if (role == 2) {
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mtile][e][lane] = acc[0][e];
        named_arrive(1 + mtile, 64);
      } else {
        const int t = role == 0 ? T - 1 - s : T - s;
        const int st = (T - 1 - t) % NS;
        if (role == 1) {  // dh1 = W2[:H] dg2[t] + Wh1 dg1[t+1]
          named_sync(1 + mtile, 64);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[0][e] += part[mtile][e][lane];
        }
        bf16* dout = dbuf(role == 0 ? 0 : 1, cur);
        bf16* gout = role == 0 ? dg2 : dg1;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {  // C fragment rows gq + 8 hh, column 2 tq
          if (unit[hh] >= H) continue;
          const float* k = cring + (st * R + tq) * CS + pl * H + unit[hh];
          const float dyv = role == 0 ? ld(dring + (st * R + tq) * DS + unit[hh]) : 0.0f;
          const float dh = acc[0][2 * hh] + dyv;
          const float dc = fmaf(dh, k[0], carry[hh]);
          carry[hh] = dc * k[H];
          const bf16 d[4] = {rn(dc * k[2 * H]), rn(dc * k[3 * H]), rn(dc * k[4 * H]),
                             rn(dh * k[5 * H])};
          bf16* o = dout + 2 * tq * GS + unit[hh];
#pragma unroll
          for (int q = 0; q < 4; ++q) o[q * H] = d[q];  // the next products' operand
          if (b0 + tq < B) {
            bf16* og = gout + ((size_t)(b0 + tq) * T + t) * G + unit[hh];
#pragma unroll
            for (int q = 0; q < 4; ++q) og[q * H] = d[q];
          }
        }
      }
    }
    if (role == 2) {
      // the stage of step T+1-s (read at iterations s-2 and s-1) is free
      if (s >= 2) load_step(T + 1 - s - NS);
      cp_async_wait<NS - 3>();  // the rows of step T-2-s, visible after the barrier
    }
    __syncthreads();
  }
}

template <int V>
using Int = std::integral_constant<int, V>;

// f(Int<H>{}) for H a multiple of 8 in [8, 64]; cudaErrorInvalidValue else.
template <typename F>
int with_hidden(int H, F&& f) {
  switch (H) {
    case 8: return f(Int<8>{});
    case 16: return f(Int<16>{});
    case 24: return f(Int<24>{});
    case 32: return f(Int<32>{});
    case 40: return f(Int<40>{});
    case 48: return f(Int<48>{});
    case 56: return f(Int<56>{});
    case 64: return f(Int<64>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// Lets the chain use its dynamic shared memory (above the 48 KiB default):
// one cudaFuncSetAttribute per instantiation and device, not per launch.
template <int H>
int chain_prep() {
  static std::atomic<unsigned long long> ready{0};  // a bit per device
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (ready.load(std::memory_order_acquire) & bit) return 0;
  err = (int)cudaFuncSetAttribute(lstm2_chain_mma_kernel<H>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)Bwd<H>::kSmem);
  if (err == 0) ready.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns a cudaError_t (0 on
// success). Shapes: xg1 [B, T, 4H], h0 [B, H], b2 [4H], every state /
// cotangent sequence [B, T, H], dg1, dg2 [B, T, 4H], all bf16; wfwd / wbwd
// the weights packed by `lstm_kernels.py:pack_weights` ("fwd_bf16" /
// "bwd_bf16"); coef an f32 scratch [B, T, 12, H]; h0, h1s, ys, dy and coef
// 16-byte aligned (vector reads). H a multiple of 8 in [8, 64]; sms the
// card's SM count (the gates kernel's grid). All tensors contiguous on the
// current device.

int cld_lstm2_fwd_bf16(const bf16* xg1, const bf16* h0, const uint32_t* wfwd, const bf16* b2,
                       bf16* y, bf16* h1s, bf16* c1s, bf16* c2s, int B, int T, int H,
                       void* stream) {
  if (B == 0 || T == 0) return 0;
  return with_hidden(H, [&](auto h) {
    constexpr int kH = decltype(h)::value;
    lstm2_fwd_mma_kernel<kH><<<(B + kRows - 1) / kRows, Fwd<kH>::NT, 0, (cudaStream_t)stream>>>(
        xg1, h0, wfwd, b2, y, h1s, c1s, c2s, B, T);
    return (int)cudaGetLastError();
  });
}

// Launches the gates kernel (into coef) and then the chain: one reverse
// sweep for the caller.
int cld_lstm2_bwd_bf16(const bf16* dy, const bf16* xg1, const bf16* h0, const bf16* b2,
                       const bf16* h1s, const bf16* c1s, const bf16* ys, const bf16* c2s,
                       const uint32_t* wfwd, const uint32_t* wbwd, float* coef, bf16* dg1,
                       bf16* dg2, int B, int T, int H, int sms, void* stream) {
  if (B == 0 || T == 0) return 0;
  return with_hidden(H, [&](auto h) {
    constexpr int kH = decltype(h)::value;
    const cudaStream_t s = (cudaStream_t)stream;
    const int tiles = (B * T + kPairTile - 1) / kPairTile;
    lstm2_gates_mma_kernel<kH><<<tiles < sms ? tiles : sms, Fwd<kH>::NT, 0, s>>>(
        xg1, h0, wfwd, b2, h1s, c1s, ys, c2s, coef, B, T);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    err = chain_prep<kH>();
    if (err != 0) return err;
    lstm2_chain_mma_kernel<kH><<<(B + kRows - 1) / kRows, Bwd<kH>::NT, Bwd<kH>::kSmem, s>>>(
        dy, coef, wbwd, dg1, dg2, B, T);
    return (int)cudaGetLastError();
  });
}

// Compiler's verdict on one instantiation: out = {registers per thread,
// local memory bytes per thread (spills), max threads per block, shared
// memory bytes (static, and the chain's dynamic)}. which: 0 the forward, 1
// the reverse sweep's gates kernel, 2 its chain.
int cld_lstm2_attributes_bf16(int which, int H, int* out) {
  return with_hidden(H, [&](auto h) {
    constexpr int kH = decltype(h)::value;
    const void* kernel = which == 0   ? (const void*)lstm2_fwd_mma_kernel<kH>
                         : which == 1 ? (const void*)lstm2_gates_mma_kernel<kH>
                                      : (const void*)lstm2_chain_mma_kernel<kH>;
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
    if (err != cudaSuccess) return (int)err;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = a.maxThreadsPerBlock;
    out[3] = (int)a.sharedSizeBytes + (which == 2 ? (int)Bwd<kH>::kSmem : 0);
    return 0;
  });
}

}  // extern "C"
