// Two-layer LSTM decoder sweeps for hidden sizes 65-320 on Hopper (sm_90a).
//
// Replaces, at the hidden sizes above 64, the TPU kernels
// `cld_tpu/ops/lstm_pallas.py:_fwd_kernel` (`:169`, the forward sweep) and
// `_bwd_kernel_v2` (`:312`, the reverse sweep), in float32 and in bf16
// storage. The JAX package sends every hidden size to those kernels; its
// only limit is the scoped-VMEM model of `pick_block`, which admits both
// sweeps up to H = 320. H <= 64 stays with `lstm.cu` (f32) and
// `lstm_bf16.cu` (bf16), which keep a sweep's weights inside one SM.
//
// Why another layout: Wh1 and W2 are 12 H^2 values, 2.4 MB in bf16 and
// 4.8 MB in f32 at H = 320, against the 227 KB of shared memory and 256 KB
// of registers of one SM. So the units of a hidden vector are spread over a
// thread-block cluster:
//
// * a cluster of C CTAs (8, or 16 where 8 slices do not fit: a non-portable
//   size, `lstm_kernels.py:wide_cluster`) owns kRows = 8 batch rows; CTA q
//   owns U = H / C hidden units with all four of their gates, so its cell
//   updates are local, and keeps its slice of the weights (12 H U values)
//   in shared memory for the whole sweep. Where the slice and the buffers
//   do not fit (f32 from H = 256) it reads the slice from global memory
//   (L2-resident, one copy for every cluster) at each step;
// * forward in bf16 (`lstm2_wide_fwd_kernel`, the first design): a step's
//   products run over the CTA's 12 U "columns" (Wh1, W2[:H], W2[H:] against
//   h1[t-1], h1[t-1], h2[t-2]: the two layers as a wavefront, as in
//   `lstm_bf16.cu`), each column's K = H split into S chunks, one thread
//   per (column, chunk) and eight rows; the chunks meet in shared memory in
//   a fixed order; one thread per (layer, unit, row) runs the cell and
//   writes its new h into every CTA of the cluster (distributed shared
//   memory, an all-gather), then one cluster barrier a step;
// * forward in f32 (`lstm2_wide_fwd_f32_kernel<R, kResident>`, redesigned
//   below): the same products and all-gather, but 8 or 16 rows a
//   cluster (one wave where the card holds the row tiles), two columns a
//   product thread, and per-CTA mbarriers fed by DSMEM bulk copies
//   (`cp.async.bulk.shared::cluster`) in place of the cluster barrier;
// * reverse sweep, two launches counted as one, redesigned below: a gates
//   GEMM (`lstm2_wide_gates_f32_kernel`, on the tensor cores in bf16
//   `lstm2_wide_gates_mma_kernel`) recomputes both layers' gates over all B
//   T (b, t) pairs at once (no cluster) into the 12 coefficients per (pair,
//   unit) of `lstm_bf16.cu`, in an f32 scratch [B, T, 12, H]; then the chain
//   (`lstm2_wide_chain_kernel<T, R, KT>`) carries dh / dc backwards: each
//   CTA forms, from its own units' gate cotangents, partial products for
//   EVERY unit (W2[H:] dg2, W2[:H] dg2, Wh1 dg1) and sends each owner its
//   block of them (a reduce-scatter through distributed shared memory, 3 H
//   floats a row instead of the 8 H that gathering dg would take) by bulk
//   copies onto per-CTA mbarriers, as the f32 forward does; the owner sums
//   the C partials in rank order.
//
// Numbers: products on the CUDA cores in f32. Under bf16 storage the weights
// stay bf16 and the h (forward) or dg (reverse) operand is rounded to bf16
// once, where the TPU kernels round it (`mm(a, w) = dot(a.astype(bf16), w,
// f32)`): a product of two bf16 values is exact in f32 and the sums run in
// f32; the c carries, the dh / dc carries, the gate math (`expf` /
// `tanhf`) and the coefficient scratch stay f32. Every sum runs in a fixed
// order, nothing is atomic: two launches agree bit for bit.
//
// What bounds them: the chain of T + 1 dependent steps, each an exchange
// after products of 12 H U MACs per row in every CTA. The bf16 forward is
// still the simple form: its products are not on the tensor cores, a step's
// products are bound by the shared-memory reads of the h operand, and a
// cluster barrier ends each step. The f32 forward's design is set out above
// its kernel, the reverse sweep's (both storage types) above its gates
// kernels.
//
// The wrapper (`lstm_kernels.py`) pads H to a multiple of 16 (zero units,
// exact) and packs the weights per CTA or tile ("wide_fwd", "wide_gates",
// "wide_chain", and in bf16 "wide_gates_bf16" and "wide_chain_bf16" of
// `weight_index`), so that consecutive threads read consecutive weights.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 8;              // batch rows of a cluster
constexpr int kPlanes = 12;           // reverse-sweep coefficients per (b, t, unit)
constexpr int kGrain = 16;            // H is padded to a multiple of this
constexpr int kMaxHidden = 320;
constexpr int kMaxThreads = 1024;
constexpr size_t kSmemMax = 232448;   // dynamic shared memory a CTA may use (227 KB)
constexpr int kUnschedulable = 10001;  // returned when no cluster fits the card

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// The value a product sees: rounded to the storage type once.
template <typename T>
__device__ __forceinline__ float operand(float v) { return to_f(from_f<T>(v)); }

// Four consecutive storage values as floats (16- or 8-byte aligned).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// acc[r] += x[k][r] w for the kRows rows of an operand row (two float4s).
__device__ __forceinline__ void fma_rows(float (&acc)[kRows], const float* x, float w) {
  const float4 a = *reinterpret_cast<const float4*>(x);
  const float4 b = *reinterpret_cast<const float4*>(x + 4);
  acc[0] = fmaf(a.x, w, acc[0]);
  acc[1] = fmaf(a.y, w, acc[1]);
  acc[2] = fmaf(a.z, w, acc[2]);
  acc[3] = fmaf(a.w, w, acc[3]);
  acc[4] = fmaf(b.x, w, acc[4]);
  acc[5] = fmaf(b.y, w, acc[5]);
  acc[6] = fmaf(b.z, w, acc[6]);
  acc[7] = fmaf(b.w, w, acc[7]);
}

__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[kRows]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

// Copy the CTA's weight slice (n storage values, 16-byte multiple) into
// shared memory.
template <typename T>
__device__ __forceinline__ void stage_weights(T* dst, const T* __restrict__ src, size_t n) {
  const size_t n16 = n * sizeof(T) / 16;
  for (size_t i = threadIdx.x; i < n16; i += blockDim.x)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
}

// The bf16 forward's launch geometry at one hidden size and cluster size.
struct Wide {
  int H, C, U, S;     // padded hidden size, cluster, units per CTA, K chunks
  int fwd_threads;
  bool fwd_resident;  // the weight slice lives in shared memory
  size_t fwd_smem;    // dynamic shared memory bytes
};

bool wide_config(int H, int C, int elem, Wide* w) {
  if (H <= 64 || H > kMaxHidden || H % kGrain || (C != 8 && C != 16) || H % C) return false;
  w->H = H;
  w->C = C;
  w->U = H / C;
  int S = 16;
  while (S > 1 && (12 * w->U * S > kMaxThreads || H % S)) S /= 2;
  w->S = S;
  w->fwd_threads = 12 * w->U * S;
  // one thread per (layer, unit, row) runs a cell
  if (w->fwd_threads < 2 * kRows * w->U) return false;
  const size_t slice = (size_t)12 * H * w->U * elem;
  const size_t fbuf = sizeof(float) * ((size_t)4 * H * kRows + (size_t)S * 12 * w->U * kRows);
  w->fwd_resident = slice + fbuf <= kSmemMax;
  w->fwd_smem = fbuf + (w->fwd_resident ? slice : 0);
  return true;
}

// Forward sweep. wpk ("wide_fwd"): [C][H][12 U], CTA q's slice: row k,
// column v = part * 4U + g * U + u holds Wh1[k] (part 0), W2[k] (1) or
// W2[H + k] (2) at gate column g H + q U + u. Outputs y (= h2), h1, c1, c2
// sequences, each [B, T, H]. 12 U S threads a CTA, C CTAs a cluster.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1) lstm2_wide_fwd_kernel(
    const T* __restrict__ xg1, const T* __restrict__ h0, const T* __restrict__ wpk,
    const T* __restrict__ b2, T* __restrict__ y, T* __restrict__ h1s, T* __restrict__ c1s,
    T* __restrict__ c2s, int B, int Tn, int H, int U, int S, int resident) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / C) * kRows;
  const int NV = 12 * U, G = 4 * H, KC = H / S, tid = threadIdx.x;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t slice = (size_t)H * NV;
  const T* w = wpk + (size_t)q * slice;
  size_t off = 0;
  if (resident) {
    stage_weights(reinterpret_cast<T*>(smem), w, slice);
    w = reinterpret_cast<const T*>(smem);
    off = slice * sizeof(T);
  }
  float* hb = reinterpret_cast<float*>(smem + off);  // [parity][layer][H][kRows]
  float* red = hb + 4 * H * kRows;                     // [S][NV][kRows] partial sums
  for (int i = tid; i < H * kRows; i += blockDim.x) {  // h1[-1] (read at s = 0), h2[-1] (s = 1)
    const int k = i / kRows, r = i % kRows, b = b0 + r;
    const float v = b < B ? to_f(h0[(size_t)b * H + k]) : 0.0f;
    hb[(1 * 2 + 0) * H * kRows + i] = v;
    hb[(0 * 2 + 1) * H * kRows + i] = v;
  }

  // products: every thread, virtual column v and K chunk `chunk`
  const int v = tid % NV, chunk = tid / NV;
  const int part = v / (4 * U);  // 0: Wh1 . h1, 1: W2[:H] . h1, 2: W2[H:] . h2
  // cells: layer cl (0: 1, 1: 2), unit u of the CTA, row r
  const int r = tid % kRows, u = (tid / kRows) % U, cl = tid / (kRows * U);
  const bool cell = cl < 2;
  const int unit = q * U + u, b = b0 + r;
  float c = 0.0f, bias[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bias[g] = cell && cl == 1 ? to_f(b2[g * H + unit]) : 0.0f;
  cluster.sync();  // every CTA of the cluster runs and holds h0 before any remote store

  for (int s = 0; s <= Tn; ++s) {
    const int cur = s & 1, prv = cur ^ 1;
    const bool on1 = s < Tn, on2 = s > 0;  // layer 1 runs step s, layer 2 step s - 1
    float xin[4];  // layer 1's input projection, in flight during the products
#pragma unroll
    for (int g = 0; g < 4; ++g)
      xin[g] = cell && cl == 0 && on1 && b < B
                   ? to_f(xg1[((size_t)b * Tn + s) * G + g * H + unit])
                   : 0.0f;
    {
      float acc[kRows] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (part == 0 ? on1 : on2) {
        const float* x = hb + (prv * 2 + (part == 2)) * H * kRows;
        for (int k = chunk * KC; k < (chunk + 1) * KC; ++k)
          fma_rows(acc, x + k * kRows, to_f(w[(size_t)k * NV + v]));
      }
      store_rows(red + ((size_t)chunk * NV + v) * kRows, acc);
    }
    __syncthreads();

    if (cell && (cl == 0 ? on1 : on2)) {
      float pre[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int col = cl * 4 * U + g * U + u;
        float a = 0.0f;
        for (int j = 0; j < S; ++j) a += red[((size_t)j * NV + col) * kRows + r];
        if (cl == 1)
          for (int j = 0; j < S; ++j) a += red[((size_t)j * NV + col + 4 * U) * kRows + r];
        pre[g] = a + (cl == 0 ? xin[g] : bias[g]);
      }
      const float ig = sigm(pre[0]), fg = sigm(pre[1]), gg = tanhf(pre[2]), og = sigm(pre[3]);
      c = fg * c + ig * gg;
      const float h = og * tanhf(c);
      const float hx = operand<T>(h);
      const size_t slot = ((size_t)(cur * 2 + cl) * H + unit) * kRows + r;
      for (int p = 0; p < C; ++p) cluster.map_shared_rank(hb, p)[slot] = hx;
      if (b < B) {
        const size_t o = ((size_t)b * Tn + (cl == 0 ? s : s - 1)) * H + unit;
        (cl == 0 ? h1s : y)[o] = from_f<T>(h);
        (cl == 0 ? c1s : c2s)[o] = from_f<T>(c);
      }
    }
    cluster.sync();  // the step's h in every CTA; the partial sums free again
  }
}

// ---------------------------------------------------------------------------
// The f32 forward, redesigned (`lstm2_wide_fwd_f32_kernel<R, kResident>`).
// ---------------------------------------------------------------------------
//
// What held the first design back at H = 128 (0.519 ms from a graph at B =
// 128, 13x its operation bound): a cluster owned 8 rows, so B = 128 needed
// 16 clusters of 8 where the card holds 15 (two waves), and a step was
// latency: 768 threads of 256 FMAs each, a block barrier, 256 of them
// running the cells while 512 waited, then a full cluster barrier, whose
// release also waits for the step's global stores. This design:
// - a cluster owns R = 8 or 16 rows, chosen by the wrapper from B and the
//   clusters the card holds at once (`lstm_kernels.py:wide_rows`): B = 128
//   at H = 128 is 8 clusters of 16 rows, one wave;
// - each CTA has an mbarrier per parity of its h buffer. The cell threads
//   stage their new h in shared memory ([layer][unit][row], the block the
//   CTA owns in every h buffer), and one lane per peer sends each layer's
//   block there by a DSMEM bulk copy (`cp.async.bulk.shared::cluster`),
//   which completes its bytes on the peer's barrier (`complete_tx`): 2 C
//   transactions a barrier a step (sending each h by `st.async` from its
//   cell thread made 16 U C, which cost more than the products at H =
//   320). The owner arms the barrier with the step's bytes
//   once it has read the phase before (`expect_tx`), and waits only for the
//   h it reads next. No cluster barrier inside the sweep, and the global
//   stores of h and c leave without a fence;
// - a product thread owns two adjacent columns (one float2 of the "wide_fwd"
//   layout) for R rows over a chunk of K: each h row read from shared
//   memory feeds 2 R FMAs (the first design: R); its partial sums go to
//   shared memory as [chunk][row][column] (float2 stores, no bank
//   conflict), summed by the cells in chunk order;
// - 16 U cell threads each run R / 8 rows of one unit, units fastest across
//   threads (coalesced global stores); layer 1's input projection comes
//   into shared memory by `cp.async` before the wait (loads into registers
//   there the compiler may sink to their use, into the step's critical
//   path), the bias once;
// - where the weight slice does not fit (H >= 256) it is read from L2 as
//   before, kResident = false.
// The products stay f32 FMAs (TF32 would miss 1e-5 of max |plain|); every
// sum runs in a fixed order: two launches agree bit for bit.

constexpr int kPad = 8;         // extra floats per row of the partial sums (bank spread)
constexpr int kBarBytes = 16;   // the two mbarriers at the head of shared memory
// Most threads a block: 128 registers a thread hold the 2 R sums and the
// rows of h and weights in flight (at 768 threads the R = 16 build spilled).
constexpr int kF32Threads = 512;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// The shared::cluster address of shared address `a` in the CTA of rank p.
__device__ __forceinline__ unsigned map_rank(unsigned a, unsigned p) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(p));
  return r;
}

__device__ __forceinline__ void bar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// The one local arrival of a phase, with the bytes the phase waits for.
__device__ __forceinline__ void bar_arm(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// `bytes` of this CTA's shared memory at `src` into shared::cluster address
// `dst`, completed on the barrier at shared::cluster address `bar`.
__device__ __forceinline__ void send(unsigned dst, unsigned src, unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Forward sweep in f32, R rows a cluster. wpk ("wide_fwd", as the first
// design): [C][H][12 U], CTA q's row k, column v = part * 4U + g U + u.
// Threads: 6 U S (column pair, K chunk); the first 16 U also run the cells
// (unit u = t % U, row group t / U % 8 of R / 8 rows, layer t / 8U).
template <int R, bool kResident>
__global__ void __launch_bounds__(kF32Threads, 1) lstm2_wide_fwd_f32_kernel(
    const float* __restrict__ xg1, const float* __restrict__ h0, const float* __restrict__ wpk,
    const float* __restrict__ b2, float* __restrict__ y, float* __restrict__ h1s,
    float* __restrict__ c1s, float* __restrict__ c2s, int B, int Tn, int H, int U, int S) {
  constexpr int RC = R / 8;  // rows a cell thread runs
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / C) * R;
  const int NV = 12 * U, NP = 6 * U, NR = NV + kPad, G = 4 * H, KC = H / S, tid = threadIdx.x;
  extern __shared__ __align__(16) unsigned char smem[];
  // per parity of hb, the barrier its step's h completes on
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  const size_t slice = (size_t)H * NV;
  const float* w = wpk + (size_t)q * slice;
  float* hb = reinterpret_cast<float*>(smem + kBarBytes);  // [parity][layer][H][R]
  float* stage = hb + 4 * H * R;                // [parity][layer][U][R] this CTA's new h
  float* xs = stage + 4 * U * R;                // [4][U][R] layer 1's input projection
  float* bs = xs + 4 * U * R;                   // [4][U] layer 2's bias
  float* red = bs + 4 * U;                      // [S][R][NR] partial sums
  float* ws = red + (size_t)S * R * NR;         // [H][NV] the weight slice (kResident)
  if (kResident) {  // four 16-byte loads in flight a thread
    const size_t n4 = slice / 4;
#pragma unroll 4
    for (size_t i = tid; i < n4; i += blockDim.x)
      reinterpret_cast<float4*>(ws)[i] = reinterpret_cast<const float4*>(w)[i];
  }
  for (int i = tid; i < 4 * U; i += blockDim.x) bs[i] = b2[i / U * H + q * U + i % U];
  for (int i = tid; i < H * R; i += blockDim.x) {  // h1[-1] (read at s = 0), h2[-1] (s = 1)
    const int k = i / R, r = i % R, b = b0 + r;
    const float v = b < B ? h0[(size_t)b * H + k] : 0.0f;
    hb[(1 * 2 + 0) * H * R + i] = v;
    hb[(0 * 2 + 1) * H * R + i] = v;
  }
  const unsigned step_bytes = (unsigned)(H * R * sizeof(float));  // one layer's h, all CTAs
  if (tid == 0) {
    bar_init(smem_addr(&full[0]), 1);
    bar_init(smem_addr(&full[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (Tn > 0) bar_arm(smem_addr(&full[0]), step_bytes);  // step 0: layer 1 alone
    if (Tn > 1) bar_arm(smem_addr(&full[1]), 2 * step_bytes);
  }

  // products: column pair pp (columns 2 pp, 2 pp + 1, one part), K chunk
  const int pp = tid % NP, chunk = tid / NP;
  const int v0 = 2 * pp, part = v0 / (4 * U);  // 0: Wh1 . h1, 1: W2[:H] . h1, 2: W2[H:] . h2
  const float* wc = (kResident ? ws : w) + (size_t)chunk * KC * NV + v0;
  // cells: layer cl (0: 1, 1: 2), unit u of the CTA, rows r0 .. r0 + RC - 1
  const int u = tid % U, r0 = (tid / U) % 8 * RC, cl = tid / (8 * U);
  const bool cell = cl < 2;
  const int unit = q * U + u;
  float c[RC];
#pragma unroll
  for (int j = 0; j < RC; ++j) c[j] = 0.0f;
  cluster.sync();  // every CTA's barriers armed and h0 in place before any remote store

  for (int s = 0; s <= Tn; ++s) {
    const int cur = s & 1, prv = cur ^ 1;
    const bool on1 = s < Tn, on2 = s > 0;  // layer 1 runs step s, layer 2 step s - 1
    if (cell && cl == 0 && on1) {  // layer 1's input projection, in flight during the wait
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int j = 0; j < RC; ++j) {
          const int b = b0 + r0 + j;
          float* dst = xs + (g * U + u) * R + r0 + j;
          if (b < B)
            cp_async4(dst, xg1 + ((size_t)b * Tn + s) * G + g * H + unit);
          else
            *dst = 0.0f;
        }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    if (s > 0) {  // step s - 1's h from every CTA, in buffer prv
      bar_wait(smem_addr(&full[prv]), ((s - 1) >> 1) & 1);
      if (tid == 0 && s + 1 < Tn) bar_arm(smem_addr(&full[prv]), 2 * step_bytes);
    }

    if (part == 0 ? on1 : on2) {
      float a0[R], a1[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a0[r] = a1[r] = 0.0f;
      const float* x = hb + ((prv * 2 + (part == 2)) * H + chunk * KC) * R;
      // the loads of kUnroll rows of K in flight: 4, but 2 for 16 rows from
      // shared memory (4 spilled there; from L2, 2 lost more to latency)
      constexpr int kUnroll = R == 16 && kResident ? 2 : 4;
#pragma unroll kUnroll
      for (int k = 0; k < KC; ++k) {
        const float2 wv = *reinterpret_cast<const float2*>(wc + (size_t)k * NV);
#pragma unroll
        for (int r4 = 0; r4 < R; r4 += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(x + k * R + r4);
          a0[r4] = fmaf(xv.x, wv.x, a0[r4]);
          a0[r4 + 1] = fmaf(xv.y, wv.x, a0[r4 + 1]);
          a0[r4 + 2] = fmaf(xv.z, wv.x, a0[r4 + 2]);
          a0[r4 + 3] = fmaf(xv.w, wv.x, a0[r4 + 3]);
          a1[r4] = fmaf(xv.x, wv.y, a1[r4]);
          a1[r4 + 1] = fmaf(xv.y, wv.y, a1[r4 + 1]);
          a1[r4 + 2] = fmaf(xv.z, wv.y, a1[r4 + 2]);
          a1[r4 + 3] = fmaf(xv.w, wv.y, a1[r4 + 3]);
        }
      }
      float* dst = red + (size_t)chunk * R * NR + v0;
#pragma unroll
      for (int r = 0; r < R; ++r)
        *reinterpret_cast<float2*>(dst + r * NR) = make_float2(a0[r], a1[r]);
    }
    __syncthreads();  // the step's partial sums

    const bool run = cell && (cl == 0 ? on1 : on2);
    float h[RC];
    if (run) {
      if (cl == 0) asm volatile("cp.async.wait_all;\n" ::: "memory");  // this thread's xs
#pragma unroll
      for (int j = 0; j < RC; ++j) {
        float pre[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {  // the chunks' partial sums in order
          const int col = cl * 4 * U + g * U + u;
          const float* p = red + (size_t)(r0 + j) * NR + col;
          float a = 0.0f;
#pragma unroll 4
          for (int ch = 0; ch < S; ++ch) a += p[(size_t)ch * R * NR];
          if (cl == 1) {
#pragma unroll 4
            for (int ch = 0; ch < S; ++ch) a += p[(size_t)ch * R * NR + 4 * U];
          }
          pre[g] = a + (cl == 0 ? xs[(g * U + u) * R + r0 + j] : bs[g * U + u]);
        }
        const float ig = sigm(pre[0]), fg = sigm(pre[1]), gg = tanhf(pre[2]), og = sigm(pre[3]);
        c[j] = fg * c[j] + ig * gg;
        h[j] = og * tanhf(c[j]);
      }
      if (s < Tn) {  // staged for the bulk copies below
#pragma unroll
        for (int j = 0; j < RC; ++j) stage[((cur * 2 + cl) * U + u) * R + r0 + j] = h[j];
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
    }
    if (s < Tn) {  // read at step s + 1 by every CTA of the cluster: lane p of warp 0 sends
      __syncthreads();  // the staged block to CTA p, each layer that ran
      if (tid < C) {
        const unsigned bar = map_rank(smem_addr(&full[cur]), tid);
        const unsigned bytes = (unsigned)(U * R * sizeof(float));
        for (int l = 0; l < (on2 ? 2 : 1); ++l) {
          const unsigned dst = smem_addr(hb + ((size_t)(cur * 2 + l) * H + q * U) * R);
          send(map_rank(dst, tid), smem_addr(stage + (cur * 2 + l) * U * R), bytes, bar);
        }
      }
    }
    if (run) {
#pragma unroll
      for (int j = 0; j < RC; ++j) {
        const int b = b0 + r0 + j;
        if (b < B) {
          const size_t o = ((size_t)b * Tn + (cl == 0 ? s : s - 1)) * H + unit;
          (cl == 0 ? h1s : y)[o] = h[j];
          (cl == 0 ? c1s : c2s)[o] = c[j];
        }
      }
    }
  }
  cluster.sync();  // no CTA leaves while a peer may still address it
}

// ---------------------------------------------------------------------------
// The reverse sweep, redesigned: a gates GEMM, then a chain without cluster
// barriers.
// ---------------------------------------------------------------------------
//
// Part 1, the gates (`lstm2_wide_gates_f32_kernel`,
// `lstm2_wide_gates_mma_kernel`): a GEMM of the B T (b, t) pairs by each
// layer's [K, 4H] weights (layer 1: K = H over h1[t-1]; layer 2: K = 2H over
// h1[t] and h2[t-1]; h0 stands in at t = 0), folded in its epilogue into
// the 12 coefficient planes. A CTA owns 128 pairs x 16 units, with their
// four gates (64 columns), of one layer. K comes in chunks (16 rows in f32,
// 32 in bf16) through a three-stage `cp.async` ring in shared memory: the
// pairs' operand rows and the tile's rows of "wide_gates" (the weights laid
// out [unit tile][K row][64 columns]), 16 bytes a copy. So a CTA reads its
// weight tile once for 128 pairs (the first design re-read all 12 H^2
// weights from L2 for every 32 pairs, 16 FMAs a weight).
// - f32: register-blocked outer products on the CUDA cores, kept f32 (TF32
//   would miss 1e-5 of max |plain|): a thread holds 4 pairs x 4 units x 4
//   gates, so its epilogue has every gate of its 16 cells, and writes each
//   plane's 4 units as one 16-byte store.
// - bf16: `mma.sync.m16n8k16.f32.bf16.bf16.f32`, A = the pairs' operand
//   rows (a warp: 32 pairs, two m-tiles), B = the weight tile through
//   `ldmatrix.trans` (eight n-tiles of 8 columns). The operands are bf16
//   already, a product of two bf16 values is exact in f32, and the mma sums
//   in a fixed order. `mma.sync` rather than `wgmma`: a 128 x 64 tile needs
//   no warpgroup-wide operand layout, and its C fragment lands where the
//   epilogue wants it ("wide_gates_bf16" orders each gate's two n-tiles so
//   that lane tq holds units 4 tq .. 4 tq + 3: 16-byte coefficient stores
//   again, with no pass through shared memory).
// The scratch is written once, [B, T, 12, H] f32, each (pair, plane) as
// 64-byte runs of 16-byte stores.
//
// Part 2, the chain (`lstm2_wide_chain_kernel<T, R, KT>`), the f32 forward's
// design carried over to the reduce-scatter:
// - a cluster of C CTAs owns R = 8 or 16 rows (`lstm_kernels.py:wide_bwd_plan`
//   picks R from B, the clusters the card holds at once and the chain's own
//   row-cost table); CTA q owns U = H / C units with their four gates;
// - each step, each CTA forms from its own units' dg partial products for
//   EVERY unit (W2[H:] dg2, W2[:H] dg2, Wh1 dg1: groups 0-2) into a staged
//   block per owner, and one lane per peer sends each owner its block by one
//   DSMEM bulk copy (`cp.async.bulk.shared::cluster`) into the owner's
//   receive buffer [parity][source rank][grp][R][U], completing on the
//   owner's mbarrier of that parity (`complete_tx`). The owner arms it with
//   the step's bytes (12 H R: C blocks of 3 R U floats, `expect_tx`), waits
//   only for the partials it sums next, and sums them in rank order. Rows
//   outer and units inner ([R][U]) because the product threads own units:
//   their scalar stores then fall on distinct banks (two columns a thread:
//   two-way), where [U][R] put 16 lanes of a warp on one bank;
// - no cluster barrier inside the sweep: one before it (every CTA's
//   barriers initialised before a peer's copy), one after it (no CTA leaves
//   while a peer's copy may still read it);
// - the cells: 16 U threads, one unit and R / 8 rows each (units fastest:
//   coalesced dg stores), their step's six coefficients and dy brought by
//   `cp.async` into per-thread slots before the products and the wait (plain
//   loads there the compiler may sink into the step's critical path);
// - products in f32 on the CUDA cores: two columns (one float2 of
//   "wide_chain") a thread over R rows and a chunk of K = 4U, the chunks
//   summed in chunk order through shared memory at a named barrier per group
//   of warps. The slice (4U x 3H) lives in shared memory where it fits; where
//   it does not (from H = 176 at 8 rows, H = 144 at 16), its first K rows
//   do, as many as fit beside the buffers (24 of 80 at H = 320, R = 8), and
//   the rest is read from L2 at each step;
// - products in bf16 on `mma.sync`: warp w holds, as A fragments in
//   registers for the whole sweep, the slice's rows for units 16 w .. 16 w +
//   15 of the three groups (M = 16 units, K = the 4U gate columns zero-padded
//   to KT k-tiles; "wide_chain_bf16"); B = the CTA's own dg, rounded to bf16
//   once (`operand<T>`), by `ldmatrix`; N = the rows (1 or 2 n-tiles).
// Why a buffer of parity p may be reused at iteration s + 2:
// - recv[p] of owner o: a peer sends its s + 2 partials after its wait at
//   s + 1, which needs o's s + 1 partials, which o sends after its cells of
//   iteration s have read recv[p] (program order and a block barrier);
// - stage[p] of CTA q: q overwrites it at s + 2 after its wait at s + 1,
//   which needs every peer's s + 1 partials; a peer sends those after its
//   wait at s, which completed only once q's copy of iteration s had landed
//   there, so had been read;
// - the barrier of parity p is re-armed for s + 2 right after its wait at s:
//   the bytes of s + 2 come later (the first point), and bytes that came
//   before an arm would only make the phase's count negative, never
//   complete it.

constexpr int kGPairs = 128;    // (b, t) pairs of a gates CTA
constexpr int kGUnits = 16;     // hidden units of a gates CTA, with their four gates
constexpr int kGCols = 4 * kGUnits;
constexpr int kGThreads = 128;
constexpr int kGStages = 3;     // the cp.async ring of K chunks
constexpr int kGChunkF32 = 16;  // K rows of an f32 chunk
constexpr int kGChunkBf16 = 32;         // K rows of a bf16 chunk (two mma k-steps)
constexpr int kGXF32 = kGChunkF32 + 4;  // padded row of the staged f32 operand
constexpr int kGXBf16 = kGChunkBf16 + 8;  // padded rows of the staged bf16 operand and
constexpr int kGWBf16 = kGCols + 8;       // weight tile (ldmatrix without bank conflicts)
constexpr size_t kGStageF32 =
    sizeof(float) * ((size_t)kGPairs * kGXF32 + (size_t)kGChunkF32 * kGCols);
constexpr size_t kGStageBf16 =
    sizeof(bf16) * ((size_t)kGPairs * kGXBf16 + (size_t)kGChunkBf16 * kGWBf16);
constexpr int kChainF32Threads = 512;  // 128 registers a thread: the 2 R sums and loads in flight

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
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

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d += a b: one m16n8k16 product of bf16 fragments with f32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// Where pair n's operand of K row kr of the packed layers sits ("wide_gates"
// rows: 0 .. H-1 Wh1 against h1[t-1], H .. 2H-1 W2[:H] against h1[t], 2H ..
// 3H-1 W2[H:] against h2[t-1]; h0 at t = 0). A 16-byte piece (4 or 8 rows
// from a multiple of 4 or 8) never straddles two operands; a 32-row bf16
// chunk does where H % 32 = 16, so each piece finds its own.
template <typename T>
__device__ __forceinline__ const T* operand_at(const T* h0, const T* h1s, const T* ys, int n,
                                               int Tn, int H, int kr) {
  if (kr >= H && kr < 2 * H) return h1s + (size_t)n * H + (kr - H);
  const int col = kr < H ? kr : kr - 2 * H;
  if (n % Tn == 0) return h0 + (size_t)(n / Tn) * H + col;
  return (kr < H ? h1s : ys) + (size_t)(n - 1) * H + col;
}

// K rows kr0 .. kr0 + width - 1 of the CTA's tile into one ring slot: the
// pairs' operand rows ([pair][XS]) and the weight rows ([k][WS]), 16 bytes a
// copy; the rows of pairs past the last are zero.
template <typename T, int XS, int WS>
__device__ __forceinline__ void stage_chunk(T* xs, T* ws, const T* h0, const T* h1s,
                                            const T* ys, const T* wtile, int n0, int N, int Tn,
                                            int H, int kr0, int width) {
  constexpr int E = 16 / sizeof(T);  // elements of a 16-byte copy
  const int per = width / E;
  for (int i = threadIdx.x; i < kGPairs * per; i += kGThreads) {
    const int p = i / per, v = i % per, n = n0 + p;
    T* dst = xs + p * XS + v * E;
    if (n < N)
      cp_async16(dst, operand_at(h0, h1s, ys, n, Tn, H, kr0 + v * E));
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  constexpr int WP = kGCols / E;
  for (int i = threadIdx.x; i < width * WP; i += kGThreads) {
    const int k = i / WP, v = i % WP;
    cp_async16(ws + k * WS + v * E, wtile + (size_t)(kr0 + k) * kGCols + v * E);
  }
}

// One layer's six coefficient planes of pair n for units unit0 .. unit0 + 3
// from their pre-activations pre [gate][unit] (planes 0-5 layer 2, 6-11
// layer 1: o (1 - tanh^2 c), f, g i (1-i), c_prev f (1-f), i (1-g^2), tanh(c)
// o (1-o)), one 16-byte store a plane.
template <typename T>
__device__ __forceinline__ void store_coef(float* __restrict__ coef, const float (&pre)[4][4],
                                           const T* __restrict__ cs, int n, int Tn, int H,
                                           int unit0, int cl) {
  const float4 cv = load4(cs + (size_t)n * H + unit0);
  const float4 cq = n % Tn > 0 ? load4(cs + (size_t)(n - 1) * H + unit0)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float c[4] = {cv.x, cv.y, cv.z, cv.w}, cp[4] = {cq.x, cq.y, cq.z, cq.w};
  float o[6][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float ig = sigm(pre[0][e]), fg = sigm(pre[1][e]), gg = tanhf(pre[2][e]),
                og = sigm(pre[3][e]);
    const float tc = tanhf(c[e]);
    o[0][e] = og * (1.0f - tc * tc);
    o[1][e] = fg;
    o[2][e] = gg * ig * (1.0f - ig);
    o[3][e] = cp[e] * fg * (1.0f - fg);
    o[4][e] = ig * (1.0f - gg * gg);
    o[5][e] = tc * og * (1.0f - og);
  }
  float* dst = coef + ((size_t)n * kPlanes + 6 * cl) * H + unit0;
#pragma unroll
  for (int j = 0; j < 6; ++j)
    *reinterpret_cast<float4*>(dst + (size_t)j * H) = make_float4(o[j][0], o[j][1], o[j][2], o[j][3]);
}

// The bias of pre [gate][unit]: xg1 (layer 1) or b2 (layer 2) of units
// unit0 .. unit0 + 3.
template <typename T>
__device__ __forceinline__ void add_input(float (&pre)[4][4], const T* __restrict__ xg1,
                                          const T* __restrict__ b2, int n, int H, int unit0,
                                          int cl) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const float4 v = cl ? load4(xg1 + (size_t)n * 4 * H + g * H + unit0) : load4(b2 + g * H + unit0);
    pre[g][0] += v.x;
    pre[g][1] += v.y;
    pre[g][2] += v.z;
    pre[g][3] += v.w;
  }
}

// Reverse sweep, part 1, f32: coef [B, T, 12, H]. wg ("wide_gates"): [H /
// 16][3H][64], unit tile ut's K row kr, column g 16 + m = cat(Wh1, W2)[kr][g
// H + 16 ut + m]. Grid: (pair tiles of 128, 2 H / 16: unit tile, layer).
__global__ void __launch_bounds__(kGThreads) lstm2_wide_gates_f32_kernel(
    const float* __restrict__ xg1, const float* __restrict__ h0, const float* __restrict__ wg,
    const float* __restrict__ b2, const float* __restrict__ h1s, const float* __restrict__ c1s,
    const float* __restrict__ ys, const float* __restrict__ c2s, float* __restrict__ coef, int B,
    int Tn, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int KC = kGChunkF32, XS = kGXF32;
  const int N = B * Tn, n0 = blockIdx.x * kGPairs;
  const int ut = blockIdx.y >> 1, cl = blockIdx.y & 1;  // cl 0: layer 2 (planes 0-5), 1: layer 1
  const int kbeg = cl ? 0 : H, nch = (cl ? H : 2 * H) / KC;
  const float* wtile = wg + (size_t)ut * 3 * H * kGCols;
  const auto xs = [&](int c) { return reinterpret_cast<float*>(smem + (c % kGStages) * kGStageF32); };
  const auto load = [&](int c) {
    if (c < nch)
      stage_chunk<float, XS, kGCols>(xs(c), xs(c) + kGPairs * XS, h0, h1s, ys, wtile, n0, N, Tn,
                                     H, kbeg + c * KC, KC);
    cp_async_commit();
  };
  const int ug = threadIdx.x % 4, pg = threadIdx.x / 4;  // units 4 ug + e, pairs pg + 32 i
  float acc[4][4][4];                                    // [pair][gate][unit]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.0f;
  load(0);
  load(1);
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<1>();
    __syncthreads();  // chunk c in place; the slot chunk c + 2 refills was read by all
    load(c + 2);
    const float* x = xs(c) + pg * XS;
    const float* w = xs(c) + kGPairs * XS + 4 * ug;
#pragma unroll
    for (int k4 = 0; k4 < KC; k4 += 4) {
      float4 xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = *reinterpret_cast<const float4*>(x + 32 * i * XS + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 wv[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          wv[g] = *reinterpret_cast<const float4*>(w + (k4 + kk) * kGCols + 16 * g);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xi = kk == 0 ? xv[i].x : kk == 1 ? xv[i].y : kk == 2 ? xv[i].z : xv[i].w;
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            acc[i][g][0] = fmaf(xi, wv[g].x, acc[i][g][0]);
            acc[i][g][1] = fmaf(xi, wv[g].y, acc[i][g][1]);
            acc[i][g][2] = fmaf(xi, wv[g].z, acc[i][g][2]);
            acc[i][g][3] = fmaf(xi, wv[g].w, acc[i][g][3]);
          }
        }
      }
    }
  }
  const int unit0 = ut * kGUnits + 4 * ug;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + pg + 32 * i;
    if (n >= N) continue;
    add_input(acc[i], xg1, b2, n, H, unit0, cl);
    store_coef(coef, acc[i], cl ? c1s : c2s, n, Tn, H, unit0, cl);
  }
}

// Reverse sweep, part 1, bf16 on the tensor cores: coef as above. wg
// ("wide_gates_bf16"): [H / 16][3H][64], unit tile ut's K row kr, column g
// 16 + 8 ub + c = cat(Wh1, W2)[kr][g H + 16 ut + 4 (c / 2) + 2 ub + c % 2]:
// n-tile (g, ub)'s column 2 tq + e is unit 4 tq + 2 ub + e. Warp w: pairs
// 32 w .. 32 w + 31 of the CTA's 128.
__global__ void __launch_bounds__(kGThreads) lstm2_wide_gates_mma_kernel(
    const bf16* __restrict__ xg1, const bf16* __restrict__ h0, const bf16* __restrict__ wg,
    const bf16* __restrict__ b2, const bf16* __restrict__ h1s, const bf16* __restrict__ c1s,
    const bf16* __restrict__ ys, const bf16* __restrict__ c2s, float* __restrict__ coef, int B,
    int Tn, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int KC = kGChunkBf16, XS = kGXBf16, WS = kGWBf16;
  const int N = B * Tn, n0 = blockIdx.x * kGPairs;
  const int ut = blockIdx.y >> 1, cl = blockIdx.y & 1;
  const int kbeg = cl ? 0 : H, K = cl ? H : 2 * H, nch = (K + KC - 1) / KC;
  const bf16* wtile = wg + (size_t)ut * 3 * H * kGCols;
  const auto xs = [&](int c) { return reinterpret_cast<bf16*>(smem + (c % kGStages) * kGStageBf16); };
  const auto width = [&](int c) { return K - c * KC < KC ? K - c * KC : KC; };  // 16 or 32
  const auto load = [&](int c) {
    if (c < nch)
      stage_chunk<bf16, XS, WS>(xs(c), xs(c) + kGPairs * XS, h0, h1s, ys, wtile, n0, N, Tn, H,
                                kbeg + c * KC, width(c));
    cp_async_commit();
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  float acc[2][4][2][4];  // [m-tile][gate][n-tile of the gate][C fragment]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int ub = 0; ub < 2; ++ub)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][g][ub][e] = 0.0f;
  load(0);
  load(1);
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<1>();
    __syncthreads();
    load(c + 2);
    // A: rows 32 warp + (lane % 16) (+ 16 for m-tile 1), k + 8 (lane / 16);
    // B (.trans): k row (lane % 8) + 8 ((lane / 8) % 2), columns + 8 (lane / 16)
    const bf16* x = xs(c) + (32 * warp + (lane & 15)) * XS + 8 * (lane >> 4);
    const bf16* w = xs(c) + kGPairs * XS + ((lane & 7) + 8 * ((lane >> 3) & 1)) * WS + 8 * (lane >> 4);
    for (int ks = 0; ks < width(c) / 16; ++ks) {
      uint32_t a[2][4];
      ldsm_x4(a[0], x + 16 * ks);
      ldsm_x4(a[1], x + 16 * XS + 16 * ks);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        uint32_t b[4];
        ldsm_x4_trans(b, w + 16 * ks * WS + 16 * g);
        const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma(acc[mt][g][0], a[mt], b0);
          mma(acc[mt][g][1], a[mt], b1);
        }
      }
    }
  }
  const int unit0 = ut * kGUnits + 4 * tq;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // C fragment rows gq (registers 0, 1) and gq + 8 (2, 3)
      const int n = n0 + 32 * warp + 16 * mt + gq + 8 * h;
      if (n >= N) continue;
      float pre[4][4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int ub = 0; ub < 2; ++ub) {
          pre[g][2 * ub] = acc[mt][g][ub][2 * h];
          pre[g][2 * ub + 1] = acc[mt][g][ub][2 * h + 1];
        }
      add_input(pre, xg1, b2, n, H, unit0, cl);
      store_coef(coef, pre, cl ? c1s : c2s, n, Tn, H, unit0, cl);
    }
}

// acc0 / acc1[r] += x[k][r] w[k][0 / 1] for k in [k0, k1): one float2 of
// weights (row stride nv) and R rows of the operand (row stride R + 4) a k.
template <int R>
__device__ __forceinline__ void chain_fma(float (&a0)[R], float (&a1)[R], const float* x,
                                          const float* w, int k0, int k1, int nv) {
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const float2 wv = *reinterpret_cast<const float2*>(w + (size_t)k * nv);
#pragma unroll
    for (int r4 = 0; r4 < R; r4 += 4) {
      const float4 xv = *reinterpret_cast<const float4*>(x + k * (R + 4) + r4);
      a0[r4] = fmaf(xv.x, wv.x, a0[r4]);
      a0[r4 + 1] = fmaf(xv.y, wv.x, a0[r4 + 1]);
      a0[r4 + 2] = fmaf(xv.z, wv.x, a0[r4 + 2]);
      a0[r4 + 3] = fmaf(xv.w, wv.x, a0[r4 + 3]);
      a1[r4] = fmaf(xv.x, wv.y, a1[r4]);
      a1[r4 + 1] = fmaf(xv.y, wv.y, a1[r4 + 1]);
      a1[r4 + 2] = fmaf(xv.z, wv.y, a1[r4 + 2]);
      a1[r4 + 3] = fmaf(xv.w, wv.y, a1[r4 + 3]);
    }
  }
}

// Most threads a chain CTA runs: 512 in f32; 2 H in bf16, the largest H of
// each k-tile count (KT = ceil(4 U / 16)), so that the A fragments (12 KT
// registers) and the sums fit the registers a thread may have.
template <typename T, int KT>
constexpr int chain_bound() {
  return std::is_same<T, float>::value ? kChainF32Threads
         : KT == 3                     ? 192
         : KT == 4                     ? 512
         : KT == 5                     ? 640
         : KT == 6                     ? 384
                                       : 448;
}

// The step's dy of `unit` for the cp.async of its cell: the 4-byte word that
// holds it (bf16: the aligned pair).
__device__ __forceinline__ const float* dy_word(const float* dy, size_t n, int H, int unit) {
  return dy + n * H + unit;
}
__device__ __forceinline__ const float* dy_word(const bf16* dy, size_t n, int H, int unit) {
  return reinterpret_cast<const float*>(dy + n * H + (unit & ~1));
}

// Reverse sweep, part 2, the chain: dg1, dg2 [B, T, 4H]. Iteration s runs
// layer 2 at step T-1-s and layer 1 at step T-s (a wavefront); the products
// of iteration s >= 1 read the dg of iteration s - 1. wpk: f32 "wide_chain"
// [C][4U][3H], CTA q's row k = g U + u (gate column g H + q U + u), column
// grp H + i: W2[H + i] (grp 0), W2[i] (1), Wh1[i] (2); bf16
// "wide_chain_bf16" [C][H / 16][3][KT][4][32] 32-bit A fragments (warp w,
// group grp, k-tile kt: units 16 w + m, gate columns 16 kt + k < 4U). S
// chunks of K and the slice's first kres rows resident (f32) as planned by
// `wide_chain_config`.
template <typename T, int R, int KT>
__global__ void __launch_bounds__(chain_bound<T, KT>(), 1) lstm2_wide_chain_kernel(
    const T* __restrict__ dy, const float* __restrict__ coef, const T* __restrict__ wpk,
    T* __restrict__ dg1, T* __restrict__ dg2, int B, int Tn, int H, int U, int S, int kres) {
  constexpr bool kMma = std::is_same<T, bf16>::value;
  constexpr int RC = R / 8, RSF = R + 4, KS = 16 * KT + 8;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / C) * R, tid = threadIdx.x;
  const int K = 4 * U, G = 4 * H, NV = 3 * H, NCELL = 16 * U;
  const int NPW = 32 * ((3 * H / 2 + 31) / 32);  // f32: column pairs, in whole warps
  const int blk = 3 * R * U;                     // floats of one source's partials [grp][R][U]
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // per parity: the step's partials are in
  float* recv = reinterpret_cast<float*>(smem + kBarBytes);  // [parity][source][grp][R][U]
  float* stage = recv + 2 * C * blk;                          // [parity][owner][grp][R][U]
  float* slots = stage + 2 * C * blk;  // [7 RC][16 U]: a cell's coefficients, then its dy
  float* ownf = slots + 7 * RC * NCELL;  // own dg: f32 [layer 2, 1][K][R + 4]
  bf16* ownb = reinterpret_cast<bf16*>(ownf);  //         bf16 [layer 2, 1][R][KS]
  const int own_floats = kMma ? R * KS : 2 * K * RSF;
  float2* red = reinterpret_cast<float2*>(ownf + own_floats);  // f32: [S-1][R][NPW] chunk sums
  float* ws = ownf + own_floats + 2 * (S - 1) * R * NPW;        // f32: the slice's first kres rows
  for (int i = tid; i < own_floats / 4; i += blockDim.x)
    reinterpret_cast<float4*>(ownf)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float* wq = reinterpret_cast<const float*>(wpk) + (kMma ? 0 : (size_t)q * K * NV);
  if constexpr (!kMma) {  // the slice's resident rows, four 16-byte loads in flight a thread
    const size_t n4 = (size_t)kres * NV / 4;
#pragma unroll 4
    for (size_t i = tid; i < n4; i += blockDim.x)
      reinterpret_cast<float4*>(ws)[i] = reinterpret_cast<const float4*>(wq)[i];
  }
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  uint32_t a[3][kMma ? KT : 1][4];  // bf16: the warp's A fragments, [group][k-tile]
  if constexpr (kMma) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(wpk) +
                        (size_t)(q * (H / 16) + warp) * 3 * KT * 128 + lane;
#pragma unroll
    for (int grp = 0; grp < 3; ++grp)
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
#pragma unroll
        for (int r = 0; r < 4; ++r) a[grp][kt][r] = w[((grp * KT + kt) * 4 + r) * 32];
  }
  const unsigned step_bytes = (unsigned)(C * blk * sizeof(float));
  if (tid == 0) {
    bar_init(smem_addr(&full[0]), 1);
    bar_init(smem_addr(&full[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (Tn >= 1) bar_arm(smem_addr(&full[1]), step_bytes);  // iteration 1
    if (Tn >= 2) bar_arm(smem_addr(&full[0]), step_bytes);  // iteration 2
  }
  // cells: layer cl (0: 2, 1: 1), unit u of the CTA, rows r0 .. r0 + RC - 1
  const int u = tid % U, r0 = (tid / U) % 8 * RC, cl = tid / (8 * U);
  const bool cell = tid < NCELL;
  const int unit = q * U + u;
  float carry[RC];  // the layer's dc carry
#pragma unroll
  for (int j = 0; j < RC; ++j) carry[j] = 0.0f;
  cluster.sync();  // every CTA's barriers armed before any copy lands

  for (int s = 0; s <= Tn; ++s) {
    const int par = s & 1;
    const bool run = cell && (cl == 0 ? s < Tn : s > 0);
    const int t = cl == 0 ? Tn - 1 - s : Tn - s;
    if (run) {  // the step's coefficients and dy, in flight during the products and the wait
#pragma unroll
      for (int jr = 0; jr < RC; ++jr) {
        const int b = b0 + r0 + jr;
        const size_t n = (size_t)b * Tn + t;
#pragma unroll
        for (int j = 0; j < 7; ++j) {
          if (j == 6 && cl != 0) break;
          float* dst = slots + (j * RC + jr) * NCELL + tid;
          if (b >= B)
            *dst = 0.0f;
          else if (j < 6)
            cp_async4(dst, coef + (n * kPlanes + 6 * cl + j) * H + unit);
          else
            cp_async4(dst, dy_word(dy, n, H, unit));
        }
      }
      cp_async_commit();
    }

    if (s > 0) {  // partial products of the dg of iteration s - 1, to their owners
      float* st = stage + (size_t)par * C * blk;
      if constexpr (kMma) {
        float acc[3][R / 8][4];
#pragma unroll
        for (int grp = 0; grp < 3; ++grp)
#pragma unroll
          for (int nt = 0; nt < R / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[grp][nt][e] = 0.0f;
        // B: row (lane % 8) of the n-tile, k + 8 ((lane / 8) % 2)
        const bf16* x2 = ownb + (lane & 7) * KS + 8 * ((lane >> 3) & 1);
#pragma unroll
        for (int nt = 0; nt < R / 8; ++nt)
#pragma unroll
          for (int kt = 0; kt < KT; ++kt) {
            uint32_t b2f[2], b1f[2];
            ldsm_x2(b2f, x2 + nt * 8 * KS + 16 * kt);           // dg2
            ldsm_x2(b1f, x2 + (R + nt * 8) * KS + 16 * kt);     // dg1
            mma(acc[0][nt], a[0][kt], b2f);
            mma(acc[1][nt], a[1][kt], b2f);
            mma(acc[2][nt], a[2][kt], b1f);
          }
        // C fragment: unit 16 warp + gq (+ 8), rows 8 nt + 2 tq (+ 1)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 16 * warp + gq + 8 * h, o = i / U, uu = i % U;
#pragma unroll
          for (int grp = 0; grp < 3; ++grp)
#pragma unroll
            for (int nt = 0; nt < R / 8; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                st[((size_t)o * 3 + grp) * R * U + (8 * nt + 2 * tq + e) * U + uu] =
                    acc[grp][nt][2 * h + e];
        }
        fence_async_smem();
      } else {
        const int pp = tid % NPW, chunk = tid / NPW, v0 = 2 * pp, KCh = K / S;
        const bool on = chunk < S && pp < NV / 2;
        float a0[R], a1[R];
#pragma unroll
        for (int r = 0; r < R; ++r) a0[r] = a1[r] = 0.0f;
        if (on) {
          const float* x = ownf + (v0 >= 2 * H ? K * RSF : 0);  // grp 2: dg1, else dg2
          const int k0 = chunk * KCh, k1 = k0 + KCh;
          chain_fma<R>(a0, a1, x, ws + v0, k0, k1 < kres ? k1 : kres, NV);
          chain_fma<R>(a0, a1, x, wq + v0, k0 > kres ? k0 : kres, k1, NV);
        }
        if (S > 1 && chunk < S) {  // the chunks' sums meet at chunk 0, in chunk order
          if (chunk > 0) {
            if (on)
#pragma unroll
              for (int r = 0; r < R; ++r)
                red[((chunk - 1) * R + r) * NPW + pp] = make_float2(a0[r], a1[r]);
            named_arrive(1 + pp / 32, 32 * S);
          } else {
            named_sync(1 + pp / 32, 32 * S);
            if (on)
              for (int ch = 1; ch < S; ++ch)
#pragma unroll
                for (int r = 0; r < R; ++r) {
                  const float2 v = red[((ch - 1) * R + r) * NPW + pp];
                  a0[r] += v.x;
                  a1[r] += v.y;
                }
          }
        }
        if (on && chunk == 0) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int v = v0 + e, grp = v / H, i = v % H;
            float* dst = st + ((size_t)(i / U) * 3 + grp) * R * U + i % U;
#pragma unroll
            for (int r = 0; r < R; ++r) dst[r * U] = e ? a1[r] : a0[r];
          }
          fence_async_smem();
        }
      }
      __syncthreads();  // the staged blocks; lane p of warp 0 sends CTA p its block
      if (tid < C)
        send(map_rank(smem_addr(recv + ((size_t)par * C + q) * blk), tid),
             smem_addr(st + (size_t)tid * blk), (unsigned)(blk * sizeof(float)),
             map_rank(smem_addr(&full[par]), tid));
      bar_wait(smem_addr(&full[par]), ((s - 1) >> 1) & 1);
      if (tid == 0 && s + 2 <= Tn) bar_arm(smem_addr(&full[par]), step_bytes);
    }

    if (run) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");  // this thread's slots
      const float* part = recv + (size_t)par * C * blk + u;
      const size_t gstride = (size_t)R * U, qstride = (size_t)3 * R * U;
      T* out = cl == 0 ? dg2 : dg1;
#pragma unroll
      for (int jr = 0; jr < RC; ++jr) {
        const int r = r0 + jr, b = b0 + r;
        float kf[6];
#pragma unroll
        for (int j = 0; j < 6; ++j) kf[j] = slots[(j * RC + jr) * NCELL + tid];
        float dh;
        if (cl == 0) {  // dh2 = dy + W2[H:] dg2[t+1]
          float dyv = slots[(6 * RC + jr) * NCELL + tid];
          if constexpr (kMma)
            dyv = to_f(reinterpret_cast<const bf16*>(slots + (6 * RC + jr) * NCELL + tid)[unit & 1]);
          float acc = 0.0f;
          if (s > 0)
            for (int p = 0; p < C; ++p) acc += part[p * qstride + r * U];
          dh = dyv + acc;
        } else {  // dh1 = W2[:H] dg2[t] + Wh1 dg1[t+1]
          float acc = 0.0f, e = 0.0f;
          for (int p = 0; p < C; ++p) acc += part[p * qstride + gstride + r * U];
          for (int p = 0; p < C; ++p) e += part[p * qstride + 2 * gstride + r * U];
          dh = acc + e;
        }
        const float dc = fmaf(dh, kf[0], carry[jr]);
        carry[jr] = dc * kf[1];
        const float d[4] = {dc * kf[2], dc * kf[3], dc * kf[4], dh * kf[5]};
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          if constexpr (kMma)
            ownb[(cl * R + r) * KS + g * U + u] = from_f<bf16>(d[g]);
          else
            ownf[(cl * K + g * U + u) * RSF + r] = d[g];
          if (b < B) out[((size_t)b * Tn + t) * G + g * H + unit] = from_f<T>(d[g]);
        }
      }
    }
    __syncthreads();  // this iteration's dg before the next products
  }
  cluster.sync();  // no CTA leaves while a peer's copy may still read it
}

// The set-up every cluster launch shares: a shared-memory ceiling high
// enough for every hidden size, the non-portable cluster size above 8, the
// launch configuration (`attr` holds its cluster dimension), and how many
// such clusters the card holds at once.
int cluster_prep(const void* kernel, int C, int grid, int threads, size_t smem,
                 cudaStream_t stream, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                 int* clusters) {
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)kSmemMax);
  if (err != 0) return err;
  if (C > 8) {
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != 0) return err;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(grid);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  *clusters = 0;
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, cfg);
}

// Launch a cluster kernel, or refuse (no fallback) where the card cannot
// hold one cluster.
int cluster_launch(const void* kernel, int C, int grid, int threads, size_t smem,
                   cudaStream_t stream, void** args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters;
  const int err = cluster_prep(kernel, C, grid, threads, smem, stream, &cfg, &attr, &clusters);
  if (err != 0) return err;
  if (clusters < 1) return kUnschedulable;
  return (int)cudaLaunchKernelExC(&cfg, kernel, args);
}

template <typename T>
int wide_fwd(const void* xg1, const void* h0, const void* wpk, const void* b2, void* y,
             void* h1s, void* c1s, void* c2s, int B, int Tn, const Wide& w,
             cudaStream_t stream) {
  const T *px = (const T*)xg1, *ph = (const T*)h0, *pw = (const T*)wpk, *pb = (const T*)b2;
  T *py = (T*)y, *p1 = (T*)h1s, *pc1 = (T*)c1s, *pc2 = (T*)c2s;
  int H = w.H, U = w.U, S = w.S, res = w.fwd_resident;
  void* args[] = {&px, &ph, &pw, &pb, &py, &p1, &pc1, &pc2, &B, &Tn, &H, &U, &S, &res};
  const int tiles = (B + kRows - 1) / kRows;
  return cluster_launch((const void*)lstm2_wide_fwd_kernel<T>, w.C, w.C * tiles, w.fwd_threads,
                        w.fwd_smem, stream, args);
}

// The chain's plan at (H, C, R, storage type).
struct Chain {
  int H, C, U, R, K, S, KT, threads, kres;  // kres: f32 slice rows resident in shared memory
  bool mma;                                 // bf16 storage: products on mma.sync
  size_t smem;
};

// Shared memory every plan needs: the two mbarriers, the receive and staged
// partials ([2][C][3][R][U] each), the cells' slots ([7 R / 8][16 U]) and
// the own dg operand (f32 [2][4U][R + 4]; bf16 [2][R][16 KT + 8]).
size_t chain_base_smem(int H, int C, int R, bool mma, int KT) {
  const int U = H / C;
  size_t b = kBarBytes + sizeof(float) * ((size_t)12 * H * R + (size_t)7 * (R / 8) * 16 * U);
  return b + (mma ? (size_t)2 * R * (16 * KT + 8) * sizeof(bf16)
                  : (size_t)2 * 4 * U * (R + 4) * sizeof(float));
}

// The plan at (H, C, R), or false where there is none (the buffers alone
// do not fit: R = 16 at H = 320). bf16: 2 H threads (a warp per 16 units),
// KT k-tiles. f32: the most chunks of K (8, 4, 2, 1; 3H / 2 column pairs
// times the chunks within 512 threads) with which the slice and the chunk
// sums fit shared memory; where none does, one chunk and the slice's first
// rows, as many as fit. Every plan has a thread for each of the 16 U cells.
bool wide_chain_config(int H, int C, int R, int bf16_storage, Chain* c) {
  if (H <= 64 || H > kMaxHidden || H % kGrain || (C != 8 && C != 16) || H % C) return false;
  if (R != 8 && R != 16) return false;
  c->H = H;
  c->C = C;
  c->U = H / C;
  c->R = R;
  c->K = 4 * c->U;
  c->mma = bf16_storage != 0;
  c->KT = c->mma ? (c->K + 15) / 16 : 0;
  if (c->mma && (c->KT < 3 || c->KT > 7)) return false;
  const size_t base = chain_base_smem(H, C, R, c->mma, c->KT);
  if (base > kSmemMax) return false;
  const int cells = 32 * ((16 * c->U + 31) / 32);
  c->S = 1;
  c->kres = 0;
  if (c->mma) {
    c->threads = 2 * H;
    c->smem = base;
    return c->threads >= cells;
  }
  const int npw = 32 * ((3 * H / 2 + 31) / 32);
  const size_t row = sizeof(float) * 3 * H;  // one K row of the slice
  for (int S = 8; S >= 1; S /= 2) {
    if (c->K % S || npw * S > kChainF32Threads) continue;
    const size_t need = base + sizeof(float) * 2 * (size_t)(S - 1) * R * npw + row * c->K;
    if (need <= kSmemMax) {
      c->S = S;
      c->kres = c->K;
      c->threads = npw * S > cells ? npw * S : cells;
      c->smem = need;
      return true;
    }
  }
  const int fit = (int)((kSmemMax - base) / row);
  c->kres = fit < c->K ? fit : c->K;
  c->threads = npw > cells ? npw : cells;
  c->smem = base + row * c->kres;
  return true;
}

template <typename T, int R>
const void* chain_kernel_kt(int KT) {
  switch (KT) {
    case 3: return (const void*)lstm2_wide_chain_kernel<T, R, 3>;
    case 4: return (const void*)lstm2_wide_chain_kernel<T, R, 4>;
    case 5: return (const void*)lstm2_wide_chain_kernel<T, R, 5>;
    case 6: return (const void*)lstm2_wide_chain_kernel<T, R, 6>;
    default: return (const void*)lstm2_wide_chain_kernel<T, R, 7>;
  }
}

const void* chain_kernel(const Chain& c) {
  if (!c.mma)
    return c.R == 8 ? (const void*)lstm2_wide_chain_kernel<float, 8, 0>
                    : (const void*)lstm2_wide_chain_kernel<float, 16, 0>;
  return c.R == 8 ? chain_kernel_kt<bf16, 8>(c.KT) : chain_kernel_kt<bf16, 16>(c.KT);
}

const void* gates_kernel(bool mma) {
  return mma ? (const void*)lstm2_wide_gates_mma_kernel
              : (const void*)lstm2_wide_gates_f32_kernel;
}

size_t gates_smem(bool mma) { return kGStages * (mma ? kGStageBf16 : kGStageF32); }

template <typename T>
int wide_bwd(const void* dy, const void* xg1, const void* h0, const void* b2, const void* h1s,
             const void* c1s, const void* ys, const void* c2s, const void* wgates,
             const void* wchain, float* coef, void* dg1, void* dg2, int B, int Tn,
             const Chain& c, cudaStream_t stream) {
  int H = c.H;
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  const void* gk = gates_kernel(kBf16);
  const size_t gsm = gates_smem(kBf16);
  int err = (int)cudaFuncSetAttribute(gk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)gsm);
  if (err != 0) return err;
  const T *px = (const T*)xg1, *ph = (const T*)h0, *pg = (const T*)wgates, *pb = (const T*)b2,
          *p1s = (const T*)h1s, *pc1 = (const T*)c1s, *pys = (const T*)ys, *pc2 = (const T*)c2s;
  void* gargs[] = {&px, &ph, &pg, &pb, &p1s, &pc1, &pys, &pc2, &coef, &B, &Tn, &H};
  const dim3 grid((B * Tn + kGPairs - 1) / kGPairs, 2 * (H / kGUnits));
  err = (int)cudaLaunchKernel(gk, grid, dim3(kGThreads), gargs, gsm, stream);
  if (err != 0) return err;
  const T *pd = (const T*)dy, *pw = (const T*)wchain;
  const float* pc = coef;
  T *p1 = (T*)dg1, *p2 = (T*)dg2;
  int U = c.U, S = c.S, kres = c.kres;
  void* args[] = {&pd, &pc, &pw, &p1, &p2, &B, &Tn, &H, &U, &S, &kres};
  return cluster_launch(chain_kernel(c), c.C, c.C * ((B + c.R - 1) / c.R), c.threads, c.smem,
                        stream, args);
}

// The launch geometry of the f32 forward at (H, C, R).
struct WideF32 {
  int H, C, U, R, S, threads;
  bool resident;
  size_t smem;
};

// One candidate plan: S chunks of K, the weight slice resident in shared
// memory or not. Shared memory: the two mbarriers, the h buffers
// [2][2][H][R], the staged h of the CTA's units [2][2][U][R], layer 1's
// input projection [4][U][R], layer 2's bias [4][U], the partial sums
// [S][R][12 U + kPad] and, resident, the slice [H][12 U]. The threads
// (6 U S) fit kF32Threads and cover the 16 U cell threads.
bool wide_f32_fits(int H, int C, int R, int S, bool resident, WideF32* w) {
  w->H = H;
  w->C = C;
  w->U = H / C;
  w->R = R;
  w->S = S;
  w->threads = 6 * w->U * S;
  if (H % S || w->threads > kF32Threads || w->threads < 16 * w->U) return false;
  w->resident = resident;
  w->smem = kBarBytes + sizeof(float) * ((size_t)4 * (H + 2 * w->U) * R + 4 * w->U +
                                         (size_t)S * R * (12 * w->U + kPad) +
                                         (resident ? (size_t)12 * H * w->U : 0));
  return w->smem <= kSmemMax;
}

// The plan at (H, C, R), or false where there is none: the residency of R =
// 8's plan (the slice in shared memory where it fits at 8 rows; more rows
// never keep it where 8 could not, and a row count that would push it out
// gets no plan), then the most chunks of K (8, else 4) that fit.
bool wide_f32_config(int H, int C, int R, WideF32* w) {
  if (H <= 64 || H > kMaxHidden || H % kGrain || (C != 8 && C != 16) || H % C) return false;
  if (R != 8 && R != 16) return false;
  for (int r = 1; r >= 0; --r) {
    const bool resident = r != 0;
    if (!wide_f32_fits(H, C, 8, 8, resident, w) && !wide_f32_fits(H, C, 8, 4, resident, w))
      continue;
    return wide_f32_fits(H, C, R, 8, resident, w) || wide_f32_fits(H, C, R, 4, resident, w);
  }
  return false;
}

const void* f32_kernel(int R, bool resident) {
  if (R == 8)
    return resident ? (const void*)lstm2_wide_fwd_f32_kernel<8, true>
                    : (const void*)lstm2_wide_fwd_f32_kernel<8, false>;
  return resident ? (const void*)lstm2_wide_fwd_f32_kernel<16, true>
                  : (const void*)lstm2_wide_fwd_f32_kernel<16, false>;
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns a cudaError_t (0 on
// success; 10001 when the card cannot hold one cluster). Shapes, all
// contiguous on the current device in one storage type (bf16 != 0: bf16,
// else f32): xg1 [B, T, 4H], h0 [B, H], b2 [4H], every state / cotangent
// sequence [B, T, H], dg1, dg2 [B, T, 4H]; wfwd / wgates / wchain the weights
// packed by `lstm_kernels.py:pack_weights` ("wide_fwd"; "wide_gates" /
// "wide_gates_bf16"; "wide_chain" / "wide_chain_bf16") for cluster size C,
// 16-byte aligned (copied 16 bytes at a time), as are h0, the sequences, xg1
// and b2 (read 16 or 8 bytes at a time) and dy; coef an f32 scratch [B, T,
// 12, H]. H a multiple of 16 in [80, 320], C 8 or 16 dividing H.

// The bf16 forward (the first design; bf16_storage must be 1: the f32
// forward is `cld_lstm2_wide_fwd_f32`).
int cld_lstm2_wide_fwd(const void* xg1, const void* h0, const void* wfwd, const void* b2,
                       void* y, void* h1s, void* c1s, void* c2s, int B, int T, int H, int C,
                       int bf16_storage, void* stream) {
  Wide w;
  if (!bf16_storage || !wide_config(H, C, 2, &w)) return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  return wide_fwd<bf16>(xg1, h0, wfwd, b2, y, h1s, c1s, c2s, B, T, w, (cudaStream_t)stream);
}

// The f32 forward: R (8 or 16) rows a cluster, its chunks of K and the
// weight slice's residency planned by `wide_f32_config`; refused
// (cudaErrorInvalidValue) where there is no plan at (H, C, R).
int cld_lstm2_wide_fwd_f32(const void* xg1, const void* h0, const void* wfwd, const void* b2,
                           void* y, void* h1s, void* c1s, void* c2s, int B, int T, int H,
                           int C, int R, void* stream) {
  WideF32 w;
  if (!wide_f32_config(H, C, R, &w)) return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  const float *px = (const float*)xg1, *ph = (const float*)h0, *pw = (const float*)wfwd,
              *pb = (const float*)b2;
  float *py = (float*)y, *p1 = (float*)h1s, *pc1 = (float*)c1s, *pc2 = (float*)c2s;
  int U = w.U, S = w.S;
  void* args[] = {&px, &ph, &pw, &pb, &py, &p1, &pc1, &pc2, &B, &T, &H, &U, &S};
  return cluster_launch(f32_kernel(R, w.resident), C, C * ((B + R - 1) / R), w.threads, w.smem,
                        (cudaStream_t)stream, args);
}

// The f32 forward's plan at (H, C, R) and the compiler's verdict on it: out =
// {registers per thread, local memory bytes per thread (spills), max threads
// per block, dynamic shared memory bytes, threads per block, clusters the
// card can hold at once, chunks of K, weight slice resident (0/1)};
// cudaErrorInvalidValue where there is no plan.
int cld_lstm2_wide_fwd_f32_query(int H, int C, int R, int* out) {
  WideF32 w;
  if (!wide_f32_config(H, C, R, &w)) return (int)cudaErrorInvalidValue;
  const void* kernel = f32_kernel(R, w.resident);
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  out[3] = (int)w.smem;
  out[4] = w.threads;
  out[6] = w.S;
  out[7] = w.resident;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  return cluster_prep(kernel, C, C, w.threads, w.smem, 0, &cfg, &attr, &out[5]);
}

// Launches the gates GEMM (into coef) and then the chain at R (8 or 16) rows
// a cluster: one reverse sweep for the caller; refused (cudaErrorInvalidValue)
// where the chain has no plan at (H, C, R).
int cld_lstm2_wide_bwd(const void* dy, const void* xg1, const void* h0, const void* b2,
                       const void* h1s, const void* c1s, const void* ys, const void* c2s,
                       const void* wgates, const void* wchain, float* coef, void* dg1,
                       void* dg2, int B, int T, int H, int C, int R, int bf16_storage,
                       void* stream) {
  Chain c;
  if (!wide_chain_config(H, C, R, bf16_storage, &c)) return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return bf16_storage
             ? wide_bwd<bf16>(dy, xg1, h0, b2, h1s, c1s, ys, c2s, wgates, wchain, coef, dg1,
                              dg2, B, T, c, s)
             : wide_bwd<float>(dy, xg1, h0, b2, h1s, c1s, ys, c2s, wgates, wchain, coef, dg1,
                               dg2, B, T, c, s);
}

// The chain's plan at (H, C, R, storage) and the compiler's verdict on it:
// out = {registers per thread, local memory bytes per thread (spills), max
// threads per block, dynamic shared memory bytes, threads per block,
// clusters the card can hold at once, chunks of K (f32; 1 in bf16), rows of
// the slice resident in shared memory (f32, of 4 H / C; 0 in bf16: its
// slice is in registers), k-tiles (bf16; 0 in f32)}; cudaErrorInvalidValue
// where there is no plan.
int cld_lstm2_wide_chain_query(int H, int C, int R, int bf16_storage, int* out) {
  Chain c;
  if (!wide_chain_config(H, C, R, bf16_storage, &c)) return (int)cudaErrorInvalidValue;
  const void* kernel = chain_kernel(c);
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  out[3] = (int)c.smem;
  out[4] = c.threads;
  out[6] = c.S;
  out[7] = c.kres;
  out[8] = c.KT;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  return cluster_prep(kernel, C, C, c.threads, c.smem, 0, &cfg, &attr, &out[5]);
}

// Compiler's verdict and the launch geometry of one kernel at (H, C, storage):
// out = {registers per thread, local memory bytes per thread (spills), max
// threads per block, dynamic shared memory bytes, cluster size, weights
// resident in shared memory (0/1), threads per block, clusters the card can
// hold at once}. which: 0 the forward (bf16 only: the f32 forward's is
// `cld_lstm2_wide_fwd_f32_query`), 1 the reverse sweep's gates GEMM (no
// cluster: size 1; its weight tiles pass through shared memory: 0). The
// chain's is `cld_lstm2_wide_chain_query`.
int cld_lstm2_wide_attributes(int which, int H, int C, int bf16_storage, int* out) {
  Wide w;
  if ((which == 0 && !bf16_storage) || which < 0 || which > 1 || !wide_config(H, C, 2, &w))
    return (int)cudaErrorInvalidValue;
  const void* kernel =
      which == 0 ? (const void*)lstm2_wide_fwd_kernel<bf16> : gates_kernel(bf16_storage != 0);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  if (which == 1) {
    out[3] = (int)gates_smem(bf16_storage != 0);
    out[4] = 1;
    out[5] = 0;
    out[6] = kGThreads;
    out[7] = 0;
    return 0;
  }
  out[3] = (int)w.fwd_smem;
  out[4] = C;
  out[5] = w.fwd_resident;
  out[6] = w.fwd_threads;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  return cluster_prep(kernel, C, C, out[6], out[3], 0, &cfg, &attr, &out[7]);
}

}  // extern "C"
