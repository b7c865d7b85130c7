// Rigid map-distance forward for Hopper (sm_90a): masked min and argmin over
// a pose-invariant distance cache, under two schedules.
//
// Replaces the TPU kernels
// `cld_tpu/ops/pallas_kernels.py:_rigid_min_kernel` (`rigid_min_pallas`) and
// `cld_tpu/ops/pallas_kernels.py:_rigid_min_fused_kernel`
// (`rigid_min_fused_pallas`). For agent b, step q and bbox point j:
//     m    = min over rows i of (onroad[b, q, i] ? d2[b, i, j] : 1e12)
//     idx  = the lowest row i that attains m
//     dist = sqrt(m + 1e-12)
// The TPU kernels flatten to [BB*QB*P, P] tiles, pad the horizon to a multiple
// of 8, take the mask as f32 and mask the last axis, leaning on d2 being
// symmetric; all of that is the TPU compiler's tiling. Here the rows (axis
// -2) are masked as the plain version does, and nothing is padded.
//
// What bounds it on the H100: at the guided path's shapes (B = 128, Q = 52,
// P = 100) it must move 11 MB (the cache 5.1 MB, the mask 0.7 MB, two outputs
// 5.3 MB), 3.3 us at the memory rate, and do B*Q*P*P = 67 M compare-selects.
// A masked compare-select with its argmin is no single f32 operation: the
// first design spent ~6.5 instructions on each (compares, selects, a mask
// test) and two shared-memory loads (the cache word and the mask byte), and
// staged the cache 7 times per agent. Instruction issue and shared-memory
// delivery bound it, not the bytes.
//
// What the design does about it:
// - Two passes. The first keeps only running minima: a thread owns a tile of
//   QT = 2 steps x 4 columns, loads each cache row's 4 words once (one
//   16-byte load, neighbouring threads on neighbouring column groups) and
//   folds it in with an FADD of the step's row penalty (0 on-road, +inf
//   off-road: the sum is the word itself or +inf, exactly) and an FMNMX: two
//   instructions per compare-select, no select, no argmin. Every RB = 4 rows
//   it notes, per minimum, whether it went down in that block.
// - The second pass finds each argmin in its noted block alone: the minimum
//   went down there last, so its first on-road occurrence there is its first
//   anywhere, and rows walk in ascending order, so the lowest row wins a tie
//   (the bbox grid is a lattice, full of tied distances). Its loads issue
//   whatever the minimum, so that they overlap.
// - The mask is staged once per chunk of steps as those penalties and,
//   bit-packed by `__ballot_sync`, as 32-row words for the second pass and
//   each step's first off-road row. Off-road rows all weigh 1e12, so of them
//   only the first can win, and it is merged once per output: (1e12, first
//   off-road row) wins if the on-road minimum exceeds 1e12, or ties it with a
//   lower row. No arithmetic touches a value before the final add and the
//   IEEE sqrtf, so the result equals the plain version's bit for bit.
// - The cache (P x S floats, S = P rounded up to 4: 40 KB at P = 100) is
//   staged with 16-byte `cp.async` (4-byte where P % 4 != 0), one commit
//   group per 32 rows; the first pass waits for a group just before it walks
//   those rows, so the staging overlaps the first rows' work.
//
// What still bounds it is not visible without a per-pipe profiler: from a
// CUDA graph on an H100 at 700 W it takes ~0.0185 ms at B = 128, 5.6x its
// byte bound (`cld_tpu_torch/kernel_ab.py`, `chip_smoke.py`; PERF.md).
//
// `rigid_min_kernel`: grid (B, ceil(Q / qb)), qb steps a block from the
// caller (`ops/rigid_kernels.py:rigid_min_steps_per_block`: about two blocks
// an SM, so 26 steps and 256 blocks at B = 128, 8 steps and 224 blocks at
// B = 32): the cache is staged twice per agent at B = 128.
// `rigid_min_fused_kernel`: one block per agent stages the cache once and
// sweeps the horizon in chunks of up to 64 steps (650 first-pass threads at
// Q = 52, P = 100); one SM carries an agent's whole horizon, so it is no
// faster at B = 32 than at B = 128.
//
// Above P = 224 the whole cache (4 P^2 bytes) no longer fits one block's
// 227 KB beside the mask. Column j's minimum runs over every row i, so a
// block can own a chunk of pc columns instead: it stages P x pc floats of
// the cache (rows at stride pc) and the mask of all P rows, and sweeps its
// columns exactly as above. Both kernels are templates on `kTiled`: the
// untiled instantiation (P <= 224, one chunk of all P columns at stride S)
// is the code the schedules above were measured with; the tiled one adds a
// grid dimension of ceil(P / pc) column chunks (`rigid_min_kernel`: grid (B,
// step chunks, column chunks); `rigid_min_fused_kernel`: grid (B, column
// chunks)). The wrapper plans qb and pc (`ops/rigid_kernels.py:
// rigid_min_tiling`): at most 16 steps a block, the widest chunk that fits
// beside them, the chunks balanced (P = 256: 2 of 128; P = 1,024: 26 of 40,
// the last 24 wide). The function, the tie rule and the bit-exactness do
// not change: each column is still one thread's walk over the rows in
// ascending order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QT = 2;          // steps per thread tile
constexpr int MAX_THREADS = 1024;
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a block may use (227 KB)
constexpr float BIG_D2 = 1e12f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's commit groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

// Start copying d2b [P, P] into d2s [P, S] (S = P rounded up to 4 floats, so
// that every row starts 16-byte aligned): one commit group per word of 32
// rows (W groups, some maybe empty for a thread), in row order. 16-byte
// copies where S == P and d2b is 16-byte aligned, else 4-byte ones.
__device__ __forceinline__ void stage_cache(float* d2s, const float* __restrict__ d2b, int P,
                                            int S, int W) {
  const bool vec = S == P && (reinterpret_cast<uintptr_t>(d2b) & 15) == 0;
  for (int w = 0; w < W; ++w) {
    const int lo = w * 32 * P;  // a multiple of 4: 16-byte aligned in d2s when S == P
    const int hi = min(P, (w + 1) * 32) * P;
    if (vec) {
      for (int k = lo + 4 * threadIdx.x; k < hi; k += 4 * blockDim.x) cp_async16(d2s + k, d2b + k);
    } else {
      for (int k = lo + threadIdx.x; k < hi; k += blockDim.x) {
        const int i = k / P;
        cp_async4(d2s + i * S + (k - i * P), d2b + k);
      }
    }
    cp_async_commit();
  }
}

// Start copying columns [c0, c0 + pn) of d2b [P, P] into d2s [P, sc] (sc a
// multiple of 4 >= pn): one commit group per word of 32 rows, in row order,
// as `stage_cache`. 16-byte copies where every row segment starts 16-byte
// aligned (P and c0 multiples of 4, d2b aligned; then pn is one too), else
// 4-byte ones.
__device__ __forceinline__ void stage_cols(float* d2s, const float* __restrict__ d2b, int P,
                                           int sc, int W, int c0, int pn) {
  const bool vec = (P & 3) == 0 && (c0 & 3) == 0 && (reinterpret_cast<uintptr_t>(d2b) & 15) == 0;
  for (int w = 0; w < W; ++w) {
    const int i0 = w * 32, rows = min(32, P - i0);
    if (vec) {
      const int n4 = pn / 4;
      for (int k = threadIdx.x; k < rows * n4; k += blockDim.x) {
        const int i = i0 + k / n4, c = 4 * (k % n4);
        cp_async16(d2s + i * sc + c, d2b + (size_t)i * P + c0 + c);
      }
    } else {
      for (int k = threadIdx.x; k < rows * pn; k += blockDim.x) {
        const int i = i0 + k / pn, c = k % pn;
        cp_async4(d2s + i * sc + c, d2b + (size_t)i * P + c0 + c);
      }
    }
    cp_async_commit();
  }
}

// The mask of nq steps (on: [nq, P] bytes) as penalties pen [qr, S] (0 for
// an on-road row, +inf for an off-road one; rows nq..qr-1, the last tile's
// steps past the chunk, all +inf), every load issued before any is waited
// for (one latency, not one per step).
__device__ __forceinline__ void load_mask(float* pen, const uint8_t* __restrict__ on, int nq,
                                          int qr, int P, int S) {
  const float inf = __int_as_float(0x7f800000);
  const int n = nq * P;
  int k = threadIdx.x;
  for (; k + 3 * (int)blockDim.x < n; k += 4 * blockDim.x) {
    uint8_t v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = on[k + u * blockDim.x];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int kk = k + u * blockDim.x, q = kk / P;
      pen[q * S + kk - q * P] = v[u] ? 0.0f : inf;
    }
  }
  for (; k < n; k += blockDim.x) {
    const int q = k / P;
    pen[q * S + k - q * P] = on[k] ? 0.0f : inf;
  }
  for (k = nq * S + threadIdx.x; k < qr * S; k += blockDim.x) pen[k] = inf;
}

// Bit-pack the staged penalties of nq steps into mb [nq, W] words (row i of a
// step at bit i % 32 of word i / 32: on-road) and note each step's first
// off-road row in foff (P if none). One warp per step.
__device__ __forceinline__ void pack_mask(uint32_t* mb, int* foff, const float* pen, int nq,
                                          int P, int S, int W) {
  const int lane = threadIdx.x & 31;
  for (int q = threadIdx.x >> 5; q < nq; q += blockDim.x >> 5) {
    int first = P;
    for (int w = 0; w < W; ++w) {
      const int i = w * 32 + lane;
      const uint32_t word = __ballot_sync(0xffffffffu, i < P && pen[q * S + i] == 0.0f);
      const int rows = min(32, P - w * 32);
      const uint32_t off = ~word & (rows == 32 ? 0xffffffffu : (1u << rows) - 1u);
      if (first == P && off != 0u) first = w * 32 + __ffs(off) - 1;
      if (lane == 0) mb[q * W + w] = word;
    }
    if (lane == 0) foff[q] = first;
  }
}

constexpr int RB = 4;  // rows per block of the first pass's record

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// best = min(best, v + pen) for a tile's QT steps x 4 columns: an FADD (the
// FMA pipe) and an FMNMX each, no select. pen is 0 or +inf, so the sum is v
// itself or +inf, exactly.
__device__ __forceinline__ void fold_row(float (*best)[4], const float4& v, const float* pen) {
#pragma unroll
  for (int k = 0; k < QT; ++k) {
#pragma unroll
    for (int e = 0; e < 4; ++e) best[k][e] = fminf(best[k][e], lane_of(v, e) + pen[k]);
  }
}

// Note, for each running minimum, whether it went down since the last note
// (prev): if so, rows up to `row` hold its first occurrence in block row / RB.
__device__ __forceinline__ void note_block(float (*best)[4], float (*prev)[4], int (*blk)[4],
                                           int row) {
#pragma unroll
  for (int k = 0; k < QT; ++k) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (best[k][e] < prev[k][e]) blk[k][e] = row / RB;
      prev[k][e] = best[k][e];
    }
  }
}

// First pass over one word of 32 cache rows i0.. of four columns (c[r * sc]:
// row i0 + r of them, 16-byte aligned; pq[k * S + r]: row i0 + r's penalty
// at the tile's step k): 4 rows of penalties per LDS.128, a note per block
// of RB = 4 rows.
__device__ __forceinline__ void fold_word(const float* c, int sc, const float* pq, int S, int i0,
                                          float (*best)[4], float (*prev)[4], int (*blk)[4]) {
#pragma unroll
  for (int r4 = 0; r4 < 32; r4 += 4) {
    float4 p4[QT];
#pragma unroll
    for (int k = 0; k < QT; ++k) p4[k] = *reinterpret_cast<const float4*>(pq + k * S + r4);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float pen[QT];
#pragma unroll
      for (int k = 0; k < QT; ++k) pen[k] = lane_of(p4[k], u);
      fold_row(best, *reinterpret_cast<const float4*>(c + (r4 + u) * sc), pen);
    }
    note_block(best, prev, blk, i0 + r4 + 3);  // RB = 4: a note per group of 4 rows
  }
}

// Second pass for one output: the lowest on-road row of block `b` whose
// cache word equals the minimum mn (c: column j of the cache at row stride
// sc, mbq: the step's mask words). The first pass saw the minimum go down
// last in that block, so its first on-road occurrence there is its first
// anywhere.
__device__ __forceinline__ int first_row(const float* c, const uint32_t* mbq, int sc, int P,
                                         int b, float mn) {
  const int i0 = b * RB;
  const uint32_t bits = (mbq[i0 >> 5] >> (i0 & 31)) & ((1u << RB) - 1u);
  uint32_t eq = 0u;
#pragma unroll
  for (int r = 0; r < RB; ++r)
    if (i0 + r < P && c[(i0 + r) * sc] == mn) eq |= 1u << r;
  return i0 + __ffs(eq & bits) - 1;
}

// Shared memory of a block: the cache [P, sc] (sc = S untiled, the column
// chunk tiled); for qb steps (a multiple of QT), the penalties [qb, S], the
// mask words [qb, W] and the first off-road rows [qb].
struct Smem {
  float* d2s;
  float* pen;
  uint32_t* mb;
  int* foff;
};

__device__ __forceinline__ Smem carve(float* smem, int P, int S, int sc, int W, int qb) {
  Smem m;
  m.d2s = smem;
  m.pen = smem + P * sc;  // 16-byte aligned: sc is a multiple of 4
  m.mb = reinterpret_cast<uint32_t*>(m.pen + qb * S);
  m.foff = reinterpret_cast<int*>(m.mb + qb * W);
  return m;
}

// Steps [0, nq) of the staged chunk of agent steps at out0 (outputs dist/idx
// + out0 + q * P + c0 + j): one item per (tile of QT steps, group of 4 of
// the block's pn columns, c0 the first), in rounds of blockDim.x; the cache
// rows lie at stride sc. With `pending`, the cache's W commit groups are
// still in flight: every thread (with an item or not) waits for each word's
// rows, then the block syncs, before anyone walks them.
__device__ __forceinline__ void sweep(const Smem& m, int nq, int P, int S, int sc, int c0,
                                      int pn, int W, bool pending, float* __restrict__ dist,
                                      int* __restrict__ idx, size_t out0) {
  const float inf = __int_as_float(0x7f800000);
  const int G = (pn + 3) / 4;
  const int nitems = (nq + QT - 1) / QT * G;
  // 16-byte stores where every row of outputs starts 16-byte aligned
  const bool vec = S == P && ((reinterpret_cast<uintptr_t>(dist + out0 + c0) |
                               reinterpret_cast<uintptr_t>(idx + out0 + c0)) & 15) == 0;
  for (int base = 0; base < nitems; base += blockDim.x) {  // uniform over the block
    const int item = base + threadIdx.x;
    const bool live = item < nitems;
    const int t = live ? item / G : 0;
    const int j0 = live ? 4 * (item - t * G) : 0;
    const float* pt = m.pen + t * QT * S;  // the tile's penalty rows
    float best[QT][4], prev[QT][4];
    int blk[QT][4];
#pragma unroll
    for (int k = 0; k < QT; ++k) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        best[k][e] = inf;  // only on-road rows enter
        prev[k][e] = inf;
        blk[k][e] = 0;
      }
    }
    for (int w = 0; w < W; ++w) {
      if (pending) {
        cp_async_wait(W - 1 - w);
        __syncthreads();
      }
      if (!live) continue;
      const int i0 = w * 32;
      const float* c = m.d2s + i0 * sc + j0;
      const int rows = min(32, P - i0);
      if (rows == 32) {
        fold_word(c, sc, pt + i0, S, i0, best, prev, blk);
      } else {
        for (int r = 0; r < rows; ++r) {  // a partial word: a note per row
          float p[QT];
#pragma unroll
          for (int k = 0; k < QT; ++k) p[k] = pt[k * S + i0 + r];
          fold_row(best, *reinterpret_cast<const float4*>(c + r * sc), p);
          note_block(best, prev, blk, i0 + r);
        }
      }
    }
    pending = false;
    if (!live) continue;
#pragma unroll
    for (int k = 0; k < QT; ++k) {
      const int q = t * QT + k;
      if (q >= nq) break;
      const int f = m.foff[q];
      float d[4];
      int a[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float mn = best[k][e];
        // taken whatever mn, so that its loads issue with the others';
        // +inf: no on-road row below +inf, so row 0 ties at +inf (all
        // on-road) or the first off-road row wins below
        const int fr = first_row(m.d2s + j0 + e, m.mb + q * W, sc, P, blk[k][e], mn);
        a[e] = mn < inf ? fr : 0;
        if (f < P) {  // the off-road rows weigh 1e12; the first of them is the lowest
          if (BIG_D2 < mn) {
            mn = BIG_D2;
            a[e] = f;
          } else if (BIG_D2 == mn) {
            a[e] = min(a[e], f);
          }
        }
        d[e] = sqrtf(mn + 1e-12f);
      }
      const size_t o = out0 + (size_t)q * P + c0 + j0;
      if (vec) {
        *reinterpret_cast<float4*>(dist + o) = make_float4(d[0], d[1], d[2], d[3]);
        *reinterpret_cast<int4*>(idx + o) = make_int4(a[0], a[1], a[2], a[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j0 + e < pn) {
            dist[o + e] = d[e];
            idx[o + e] = a[e];
          }
        }
      }
    }
  }
}

// Shared memory of a block of qb steps whose cache rows lie at stride sc.
size_t smem_bytes(int P, int qb, int sc) {
  const int S = (P + 3) & ~3, W = (P + 31) / 32;
  return (size_t)P * sc * sizeof(float) +
         (size_t)qb * (S * sizeof(float) + W * sizeof(uint32_t) + sizeof(int));
}

// Stage the steps [q0, q0 + nq) of agent b and sweep them.
__device__ __forceinline__ void chunk(const Smem& m, const uint8_t* __restrict__ onroad,
                                      float* __restrict__ dist, int* __restrict__ idx, int b,
                                      int Q, int P, int S, int sc, int c0, int pn, int W, int q0,
                                      int nq, bool pending) {
  const size_t base = ((size_t)b * Q + q0) * P;
  load_mask(m.pen, onroad + base, nq, (nq + QT - 1) / QT * QT, P, S);
  __syncthreads();
  pack_mask(m.mb, m.foff, m.pen, nq, P, S, W);
  __syncthreads();
  sweep(m, nq, P, S, sc, c0, pn, W, pending, dist, idx, base);
}

// The block's cache columns: all P at stride S (untiled), or chunk `cb` of
// pc (tiled): (sc, c0, pn), and the copies that stage them.
template <bool kTiled>
__device__ __forceinline__ void stage(float* d2s, const float* __restrict__ d2b, int P, int S,
                                      int W, int pc, int cb, int* sc, int* c0, int* pn) {
  if (kTiled) {
    *sc = pc;
    *c0 = cb * pc;
    *pn = min(pc, P - *c0);
    stage_cols(d2s, d2b, P, *sc, W, *c0, *pn);
  } else {
    *sc = S;
    *c0 = 0;
    *pn = P;
    stage_cache(d2s, d2b, P, S, W);
  }
}

template <bool kTiled>
__global__ void __launch_bounds__(MAX_THREADS)
rigid_min_kernel(const float* __restrict__ d2, const uint8_t* __restrict__ onroad,
                 float* __restrict__ dist, int* __restrict__ idx, int Q, int P, int qb, int pc) {
  extern __shared__ __align__(16) float smem[];
  const int S = (P + 3) & ~3, W = (P + 31) / 32;
  const Smem m = carve(smem, P, S, kTiled ? pc : S, W, qb);
  const int q0 = blockIdx.y * qb;
  int sc, c0, pn;
  stage<kTiled>(m.d2s, d2 + (size_t)blockIdx.x * P * P, P, S, W, pc, blockIdx.z, &sc, &c0, &pn);
  chunk(m, onroad, dist, idx, blockIdx.x, Q, P, S, sc, c0, pn, W, q0, min(qb, Q - q0), true);
}

template <bool kTiled>
__global__ void __launch_bounds__(MAX_THREADS)
rigid_min_fused_kernel(const float* __restrict__ d2, const uint8_t* __restrict__ onroad,
                       float* __restrict__ dist, int* __restrict__ idx, int Q, int P, int qb,
                       int pc) {
  extern __shared__ __align__(16) float smem[];
  const int S = (P + 3) & ~3, W = (P + 31) / 32;
  const Smem m = carve(smem, P, S, kTiled ? pc : S, W, qb);
  int sc, c0, pn;
  stage<kTiled>(m.d2s, d2 + (size_t)blockIdx.x * P * P, P, S, W, pc, blockIdx.y, &sc, &c0, &pn);
  for (int q0 = 0; q0 < Q; q0 += qb) {
    if (q0 > 0) __syncthreads();  // the last chunk's shared memory is read
    chunk(m, onroad, dist, idx, blockIdx.x, Q, P, S, sc, c0, pn, W, q0, min(qb, Q - q0),
          q0 == 0);
  }
}

// One thread per (tile, group of 4 of the block's columns) of a block's
// first chunk of steps, in whole warps, at most MAX_THREADS.
int threads_for(int Q, int cols, int qb) {
  const int items = (min(Q, qb) + QT - 1) / QT * ((cols + 3) / 4);
  return min(MAX_THREADS, (items + 31) / 32 * 32);
}

constexpr int MAX_DEVICES = 64;

// Raise the kernel's dynamic shared-memory limit on the current device to
// `smem` bytes, once per size that grows it (`raised[d]` is the limit set so
// far on device d; the attribute is kept per device).
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, size_t* raised) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && smem <= raised[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && dev < MAX_DEVICES) raised[dev] = smem;
  return err;
}

// The checks both entry points share: qb a positive multiple of QT, pc a
// positive multiple of 4 (tiled: pc < P), the block's shared memory within
// the card's. Returns the bytes, or 0 if the plan is refused.
size_t plan_bytes(int P, int qb, int pc) {
  if (qb <= 0 || qb % QT != 0 || pc <= 0) return 0;
  const bool tiled = pc < P;
  if (tiled && pc % 4 != 0) return 0;
  const size_t smem = smem_bytes(P, qb, tiled ? pc : (P + 3) & ~3);
  return smem <= SMEM_MAX ? smem : 0;
}

}  // namespace

extern "C" {

// d2 [B, P, P] f32; onroad [B, Q, P] one byte per row (0 = off-road);
// dist [B, Q, P] f32; idx [B, Q, P] int32; qb steps a block, a multiple of
// QT; pc the columns a block owns: pc >= P runs the untiled kernel (the whole
// cache a block), pc < P (a multiple of 4) the tiled one over ceil(P / pc)
// column chunks (`ops/rigid_kernels.py:rigid_min_tiling` plans both). Returns
// cudaErrorInvalidValue for a plan whose block exceeds the card's shared
// memory. Launches on `stream`; returns cudaGetLastError() (or the error of
// raising the shared-memory limit).
int cld_rigid_min(const float* d2, const uint8_t* onroad, float* dist, int* idx, int B, int Q,
                  int P, int qb, int pc, void* stream) {
  if (B == 0 || Q == 0 || P == 0) return 0;
  const size_t smem = plan_bytes(P, qb, pc);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)B, (unsigned)((Q + qb - 1) / qb), (unsigned)((P + pc - 1) / pc));
  cudaError_t err;
  if (pc < P) {
    static size_t raised[MAX_DEVICES] = {};
    err = allow_smem(rigid_min_kernel<true>, smem, raised);
    if (err != cudaSuccess) return (int)err;
    rigid_min_kernel<true><<<grid, threads_for(Q, pc, qb), smem, (cudaStream_t)stream>>>(
        d2, onroad, dist, idx, Q, P, qb, pc);
  } else {
    static size_t raised[MAX_DEVICES] = {};
    err = allow_smem(rigid_min_kernel<false>, smem, raised);
    if (err != cudaSuccess) return (int)err;
    rigid_min_kernel<false><<<grid, threads_for(Q, P, qb), smem, (cudaStream_t)stream>>>(
        d2, onroad, dist, idx, Q, P, qb, P);
  }
  return (int)cudaGetLastError();
}

int cld_rigid_min_fused(const float* d2, const uint8_t* onroad, float* dist, int* idx, int B,
                        int Q, int P, int qb, int pc, void* stream) {
  if (B == 0 || Q == 0 || P == 0) return 0;
  const size_t smem = plan_bytes(P, qb, pc);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)B, (unsigned)((P + pc - 1) / pc));
  cudaError_t err;
  if (pc < P) {
    static size_t raised[MAX_DEVICES] = {};
    err = allow_smem(rigid_min_fused_kernel<true>, smem, raised);
    if (err != cudaSuccess) return (int)err;
    rigid_min_fused_kernel<true><<<grid, threads_for(Q, pc, qb), smem,
                                   (cudaStream_t)stream>>>(d2, onroad, dist, idx, Q, P, qb, pc);
  } else {
    static size_t raised[MAX_DEVICES] = {};
    err = allow_smem(rigid_min_fused_kernel<false>, smem, raised);
    if (err != cudaSuccess) return (int)err;
    rigid_min_fused_kernel<false><<<grid, threads_for(Q, P, qb), smem,
                                    (cudaStream_t)stream>>>(d2, onroad, dist, idx, Q, P, qb, P);
  }
  return (int)cudaGetLastError();
}

// Registers, local memory bytes (spills) per thread and max threads per
// block of rigid_min_kernel (fused = 0) or rigid_min_fused_kernel (fused =
// 1), untiled (tiled = 0) or tiled (tiled = 1).
int cld_rigid_min_attributes(int fused, int tiled, int* out) {
  const void* kernel =
      fused ? (tiled ? (const void*)rigid_min_fused_kernel<true>
                     : (const void*)rigid_min_fused_kernel<false>)
            : (tiled ? (const void*)rigid_min_kernel<true> : (const void*)rigid_min_kernel<false>);
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  return 0;
}

}  // extern "C"
