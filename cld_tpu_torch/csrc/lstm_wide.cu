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
// * reverse sweep, two launches counted as one: `lstm2_wide_gates_kernel`
//   recomputes both layers' gates over all B T (b, t) pairs at once (a
//   tiled product, no cluster) into the 12 coefficients per (pair, unit) of
//   `lstm_bf16.cu`, in an f32 scratch [B, T, 12, H]; then
//   `lstm2_wide_chain_kernel` carries dh / dc backwards: each CTA forms,
//   from its own units' gate cotangents, partial products for EVERY unit
//   (W2[H:] dg2, W2[:H] dg2, Wh1 dg1) and sends each partial to the unit's
//   owner (a reduce-scatter through distributed shared memory, 3 H floats a
//   row instead of the 8 H that gathering dg would take), one cluster
//   barrier a step; the owner sums the C partials in rank order.
//
// Numbers: products on the CUDA cores in f32. Under bf16 storage the weights
// stay bf16 and the h (forward) or dg (reverse) operand is rounded to bf16
// once, where the TPU kernels round it (`mm(a, w) = dot(a.astype(bf16), w,
// f32)`): a product of two bf16 values is exact in f32 and the sums run in
// f32; the c carries, the dh / dc carries, the gate math (`expf` /
// `tanhf`) and the coefficient scratch stay f32. Every sum runs in a fixed
// order, nothing is atomic: two launches agree bit for bit.
//
// What bounds them: the chain of T + 1 dependent steps, each a barrier
// after products of 12 H U MACs per row in every CTA. The bf16 forward and
// both reverse sweeps are the simple form: the bf16 products are not on the
// tensor cores, and a step's products are bound by the shared-memory reads
// of the h / dg operand. The f32 forward's design is set out above its
// kernel.
//
// The wrapper (`lstm_kernels.py`) pads H to a multiple of 16 (zero units,
// exact) and packs the weights per CTA ("wide_fwd", "wide_chain",
// "wide_gates" of `weight_index`), so that consecutive threads read
// consecutive weights.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 8;              // batch rows of a cluster
constexpr int kPlanes = 12;           // reverse-sweep coefficients per (b, t, unit)
constexpr int kPairs = 32;            // (b, t) pairs of a gates-kernel CTA
constexpr int kPairStride = kPairs + 4;  // padded row of the staged operands
constexpr int kGatesThreads = 256;    // 32 units x 8 quads of pairs
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

// The launch geometry of one hidden size, cluster size and storage type.
struct Wide {
  int H, C, U, S;             // padded hidden size, cluster, units per CTA, K chunks
  int fwd_threads, chain_threads;
  bool fwd_resident, chain_resident;  // the weight slice lives in shared memory
  size_t fwd_smem, chain_smem;        // dynamic shared memory bytes
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
  w->chain_threads = 3 * H;
  // one thread per (layer, unit, row) runs a cell in each kernel
  if (w->fwd_threads < 2 * kRows * w->U || w->chain_threads < 2 * kRows * w->U) return false;
  const size_t slice = (size_t)12 * H * w->U * elem;
  const size_t fbuf = sizeof(float) * ((size_t)4 * H * kRows + (size_t)S * 12 * w->U * kRows);
  const size_t cbuf = sizeof(float) * ((size_t)6 * H * kRows + (size_t)8 * w->U * kRows);
  w->fwd_resident = slice + fbuf <= kSmemMax;
  w->chain_resident = slice + cbuf <= kSmemMax;
  w->fwd_smem = fbuf + (w->fwd_resident ? slice : 0);
  w->chain_smem = cbuf + (w->chain_resident ? slice : 0);
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

// a[p][g] += sum over k < H of x[k][p] w[k][g] for four pairs (x rows
// kPairStride apart in shared memory) and four gates (w rows 4 H apart).
template <typename T>
__device__ __forceinline__ void gate_sums(float (&a)[4][4], const float* x, const T* w, int H) {
#pragma unroll 4
  for (int k = 0; k < H; ++k) {
    const float4 wv = load4(w + (size_t)k * H * 4);
    const float4 xv = *reinterpret_cast<const float4*>(x + k * kPairStride);
    const float xp[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      a[p][0] = fmaf(xp[p], wv.x, a[p][0]);
      a[p][1] = fmaf(xp[p], wv.y, a[p][1]);
      a[p][2] = fmaf(xp[p], wv.z, a[p][2]);
      a[p][3] = fmaf(xp[p], wv.w, a[p][3]);
    }
  }
}

// Reverse sweep, part 1, parallel over the B T pairs: the 12 coefficients of
// each (pair, unit) into coef [B, T, 12, H], as `lstm_bf16.cu`'s gates kernel:
// planes 0-5 layer 2 (o (1 - tanh^2 c), f, g i (1-i), c_prev f (1-f),
// i (1-g^2), tanh(c) o (1-o)), 6-11 layer 1. wg ("wide_gates"): [3H][H][4],
// row k of cat(Wh1, W2), unit u, gate g = cat(Wh1, W2)[k][g H + u].
template <typename T>
__global__ void __launch_bounds__(kGatesThreads) lstm2_wide_gates_kernel(
    const T* __restrict__ xg1, const T* __restrict__ h0, const T* __restrict__ wg,
    const T* __restrict__ b2, const T* __restrict__ h1s, const T* __restrict__ c1s,
    const T* __restrict__ ys, const T* __restrict__ c2s, float* __restrict__ coef, int B,
    int Tn, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [3][H][kPairStride]: h1[t-1], h1[t], h2[t-1]
  const int tid = threadIdx.x, N = B * Tn, n0 = blockIdx.x * kPairs, G = 4 * H;
  for (int i = tid; i < 3 * kPairs * H; i += kGatesThreads) {
    const int op = i / (kPairs * H), p = (i / H) % kPairs, k = i % H, n = n0 + p;
    float v = 0.0f;
    if (n < N) {
      const int bb = n / Tn, t = n % Tn;
      const T* src = op == 1 ? h1s + (size_t)n * H
                     : t > 0 ? (op == 0 ? h1s : ys) + (size_t)(n - 1) * H
                             : h0 + (size_t)bb * H;
      v = to_f(src[k]);
    }
    xs[(op * H + k) * kPairStride + p] = v;
  }
  __syncthreads();

  const int ul = tid % 32, pq = tid / 32;  // unit lane, quad of pairs
  for (int u = ul; u < H; u += 32) {
    float a1[4][4], a2[4][4];  // [pair][gate]
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int g = 0; g < 4; ++g) a1[p][g] = a2[p][g] = 0.0f;
    // layer 1: h1[t-1] Wh1; layer 2: h1[t] W2[:H] + h2[t-1] W2[H:]
    gate_sums(a1, xs + 4 * pq, wg + (size_t)u * 4, H);
    gate_sums(a2, xs + H * kPairStride + 4 * pq, wg + ((size_t)H * H + u) * 4, H);
    gate_sums(a2, xs + 2 * H * kPairStride + 4 * pq, wg + ((size_t)2 * H * H + u) * 4, H);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int n = n0 + 4 * pq + p;
      if (n >= N) continue;
      const int t = n % Tn;
#pragma unroll
      for (int layer = 0; layer < 2; ++layer) {  // layer 2 (planes 0-5), then layer 1 (6-11)
        float pre[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          pre[g] = layer == 0 ? a2[p][g] + to_f(b2[g * H + u])
                              : a1[p][g] + to_f(xg1[(size_t)n * G + g * H + u]);
        const float ig = sigm(pre[0]), fg = sigm(pre[1]), gg = tanhf(pre[2]), og = sigm(pre[3]);
        const T* cs = layer == 0 ? c2s : c1s;
        const float cv = to_f(cs[(size_t)n * H + u]);
        const float cp = t > 0 ? to_f(cs[(size_t)(n - 1) * H + u]) : 0.0f;
        const float tc = tanhf(cv);
        float* o = coef + ((size_t)n * kPlanes + 6 * layer) * H + u;
        o[0] = og * (1.0f - tc * tc);
        o[H] = fg;
        o[2 * H] = gg * ig * (1.0f - ig);
        o[3 * H] = cp * fg * (1.0f - fg);
        o[4 * H] = ig * (1.0f - gg * gg);
        o[5 * H] = tc * og * (1.0f - og);
      }
    }
  }
}

// Reverse sweep, part 2, the chain: dg1, dg2 [B, T, 4H]. wpk ("wide_chain"):
// [C][4U][3H], CTA q's slice: row k = g U + u (the CTA's gate column
// j = g H + q U + u), column v = grp * H + i holds W2[H + i][j] (grp 0:
// layer 2's dh carry), W2[i][j] (1) or Wh1[i][j] (2: the two halves of
// layer 1's dh). Iteration s runs layer 2 at step T-1-s and layer 1 at step
// T-s (a wavefront); each reads the partial products of iteration s. 3 H
// threads a CTA, C CTAs a cluster.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1) lstm2_wide_chain_kernel(
    const T* __restrict__ dy, const float* __restrict__ coef, const T* __restrict__ wpk,
    T* __restrict__ dg1, T* __restrict__ dg2, int B, int Tn, int H, int U, int resident) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / C) * kRows;
  const int NV = 3 * H, K = 4 * U, G = 4 * H, tid = threadIdx.x;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t slice = (size_t)K * NV;
  const T* w = wpk + (size_t)q * slice;
  size_t off = 0;
  if (resident) {
    stage_weights(reinterpret_cast<T*>(smem), w, slice);
    w = reinterpret_cast<const T*>(smem);
    off = slice * sizeof(T);
  }
  float* rb = reinterpret_cast<float*>(smem + off);  // [parity][grp][source rank][U][kRows]
  float* db = rb + 6 * H * kRows;                     // [layer 2, layer 1][K][kRows]: own dg
  for (int i = tid; i < 2 * K * kRows; i += blockDim.x) db[i] = 0.0f;

  // products: every thread, virtual column tid (group grp, unit i of the
  // whole hidden vector, owned by CTA `owner`)
  const int grp = tid / H, i = tid % H, owner = i / U;
  // cells: cl 0 = layer 2, 1 = layer 1; unit u of the CTA, row r
  const int r = tid % kRows, u = (tid / kRows) % U, cl = tid / (kRows * U);
  const bool cell = cl < 2;
  const int unit = q * U + u, b = b0 + r;
  float carry = 0.0f;  // the layer's dc carry
  cluster.sync();

  for (int s = 0; s <= Tn; ++s) {
    const int cur = s & 1;
    const bool on2 = s < Tn, on1 = s > 0;
    const int t = cl == 0 ? Tn - 1 - s : Tn - s;
    // the cell's coefficients and dy, in flight during the products
    float kf[6], dyv = 0.0f;
    const bool run = cell && (cl == 0 ? on2 : on1);
    const bool live = run && b < B;
#pragma unroll
    for (int j = 0; j < 6; ++j)
      kf[j] = live ? coef[(((size_t)b * Tn + t) * kPlanes + 6 * cl + j) * H + unit] : 0.0f;
    if (live && cl == 0) dyv = to_f(dy[((size_t)b * Tn + t) * H + unit]);

    {
      float acc[kRows] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      const float* x = db + (grp == 2 ? K * kRows : 0);
      for (int k = 0; k < K; ++k) fma_rows(acc, x + k * kRows, to_f(w[(size_t)k * NV + tid]));
      float* dst = cluster.map_shared_rank(rb, owner);
      store_rows(dst + ((((size_t)cur * 3 + grp) * C + q) * U + i % U) * kRows, acc);
    }
    cluster.sync();  // every partial product of this iteration at its owner

    if (run) {
      const float* part = rb + (size_t)cur * 3 * C * U * kRows + (size_t)u * kRows + r;
      const size_t gstride = (size_t)C * U * kRows, qstride = (size_t)U * kRows;
      float dh;
      if (cl == 0) {  // dh2 = dy + W2[H:] dg2[t+1]
        float a = 0.0f;
        for (int p = 0; p < C; ++p) a += part[p * qstride];
        dh = dyv + a;
      } else {  // dh1 = W2[:H] dg2[t] + Wh1 dg1[t+1]
        float a = 0.0f, e = 0.0f;
        for (int p = 0; p < C; ++p) a += part[gstride + p * qstride];
        for (int p = 0; p < C; ++p) e += part[2 * gstride + p * qstride];
        dh = a + e;
      }
      const float dc = fmaf(dh, kf[0], carry);
      carry = dc * kf[1];
      const float d[4] = {dc * kf[2], dc * kf[3], dc * kf[4], dh * kf[5]};
      float* own = db + (cl == 0 ? 0 : K * kRows);
      T* out = cl == 0 ? dg2 : dg1;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        own[(g * U + u) * kRows + r] = operand<T>(d[g]);
        if (b < B) out[((size_t)b * Tn + t) * G + g * H + unit] = from_f<T>(d[g]);
      }
    }
    __syncthreads();  // this iteration's dg before the next products
  }
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

template <typename T>
int wide_bwd(const void* dy, const void* xg1, const void* h0, const void* b2, const void* h1s,
             const void* c1s, const void* ys, const void* c2s, const void* wgates,
             const void* wchain, float* coef, void* dg1, void* dg2, int B, int Tn,
             const Wide& w, cudaStream_t stream) {
  int H = w.H;
  const size_t gsm = sizeof(float) * 3 * H * kPairStride;
  int err = (int)cudaFuncSetAttribute((const void*)lstm2_wide_gates_kernel<T>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)gsm);
  if (err != 0) return err;
  lstm2_wide_gates_kernel<T><<<(B * Tn + kPairs - 1) / kPairs, kGatesThreads, gsm, stream>>>(
      (const T*)xg1, (const T*)h0, (const T*)wgates, (const T*)b2, (const T*)h1s,
      (const T*)c1s, (const T*)ys, (const T*)c2s, coef, B, Tn, H);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const T *pd = (const T*)dy, *pw = (const T*)wchain;
  const float* pc = coef;
  T *p1 = (T*)dg1, *p2 = (T*)dg2;
  int U = w.U, res = w.chain_resident;
  void* args[] = {&pd, &pc, &pw, &p1, &p2, &B, &Tn, &H, &U, &res};
  const int tiles = (B + kRows - 1) / kRows;
  return cluster_launch((const void*)lstm2_wide_chain_kernel<T>, w.C, w.C * tiles,
                        w.chain_threads, w.chain_smem, stream, args);
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
// packed by `lstm_kernels.py:pack_weights` ("wide_fwd", "wide_gates",
// "wide_chain") for cluster size C, 16-byte aligned (copied 16 bytes at a
// time); coef an f32 scratch [B, T, 12, H]. H a multiple of 16 in [80, 320],
// C 8 or 16 dividing H.

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

// Launches the gates kernel (into coef) and then the chain: one reverse
// sweep for the caller.
int cld_lstm2_wide_bwd(const void* dy, const void* xg1, const void* h0, const void* b2,
                       const void* h1s, const void* c1s, const void* ys, const void* c2s,
                       const void* wgates, const void* wchain, float* coef, void* dg1,
                       void* dg2, int B, int T, int H, int C, int bf16_storage, void* stream) {
  Wide w;
  if (!wide_config(H, C, bf16_storage ? 2 : 4, &w)) return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return bf16_storage
             ? wide_bwd<bf16>(dy, xg1, h0, b2, h1s, c1s, ys, c2s, wgates, wchain, coef, dg1,
                              dg2, B, T, w, s)
             : wide_bwd<float>(dy, xg1, h0, b2, h1s, c1s, ys, c2s, wgates, wchain, coef, dg1,
                               dg2, B, T, w, s);
}

// Compiler's verdict and the launch geometry of one kernel at (H, C, storage):
// out = {registers per thread, local memory bytes per thread (spills), max
// threads per block, dynamic shared memory bytes, cluster size, weights
// resident in shared memory (0/1), threads per block, clusters the card can
// hold at once}. which: 0 the forward (bf16 only: the f32 forward's is
// `cld_lstm2_wide_fwd_f32_query`), 1 the reverse sweep's gates kernel (no
// cluster: size 1), 2 its chain.
int cld_lstm2_wide_attributes(int which, int H, int C, int bf16_storage, int* out) {
  Wide w;
  if ((which == 0 && !bf16_storage) || !wide_config(H, C, bf16_storage ? 2 : 4, &w))
    return (int)cudaErrorInvalidValue;
  const void* kernel =
      bf16_storage ? (which == 0   ? (const void*)lstm2_wide_fwd_kernel<bf16>
                      : which == 1 ? (const void*)lstm2_wide_gates_kernel<bf16>
                                   : (const void*)lstm2_wide_chain_kernel<bf16>)
                   : (which == 1 ? (const void*)lstm2_wide_gates_kernel<float>
                                 : (const void*)lstm2_wide_chain_kernel<float>);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  if (which == 1) {
    out[3] = (int)(sizeof(float) * 3 * H * kPairStride);
    out[4] = 1;
    out[5] = 0;
    out[6] = kGatesThreads;
    out[7] = 0;
    return 0;
  }
  out[3] = (int)(which == 0 ? w.fwd_smem : w.chain_smem);
  out[4] = C;
  out[5] = which == 0 ? w.fwd_resident : w.chain_resident;
  out[6] = which == 0 ? w.fwd_threads : w.chain_threads;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  return cluster_prep(kernel, C, C, out[6], out[3], 0, &cfg, &attr, &out[7]);
}

}  // extern "C"
