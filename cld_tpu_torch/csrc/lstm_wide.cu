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
// * forward (`lstm2_wide_fwd_kernel`): a step's products run over the
//   CTA's 12 U "columns" (Wh1, W2[:H], W2[H:] against h1[t-1], h1[t-1],
//   h2[t-2]: the two layers as a wavefront, as in `lstm_bf16.cu`), each
//   column's K = H split into S chunks, one thread per (column, chunk) and
//   eight rows; the chunks meet in shared memory in a fixed order; one
//   thread per (layer, unit, row) runs the cell and writes its new h into
//   every CTA of the cluster (distributed shared memory, an all-gather),
//   then one cluster barrier a step;
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
// What bounds them: the chain of T + 1 dependent steps, each a cluster
// barrier after products of 12 H U MACs per row in every CTA. This is the
// simple form: the bf16 products are not on the tensor cores, and a step's
// products are bound by the shared-memory reads of the h / dg operand.
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

int cld_lstm2_wide_fwd(const void* xg1, const void* h0, const void* wfwd, const void* b2,
                       void* y, void* h1s, void* c1s, void* c2s, int B, int T, int H, int C,
                       int bf16_storage, void* stream) {
  Wide w;
  if (!wide_config(H, C, bf16_storage ? 2 : 4, &w)) return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return bf16_storage ? wide_fwd<bf16>(xg1, h0, wfwd, b2, y, h1s, c1s, c2s, B, T, w, s)
                      : wide_fwd<float>(xg1, h0, wfwd, b2, y, h1s, c1s, c2s, B, T, w, s);
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
// hold at once}. which: 0 the forward, 1 the reverse sweep's gates kernel
// (no cluster: size 1), 2 its chain.
int cld_lstm2_wide_attributes(int which, int H, int C, int bf16_storage, int* out) {
  Wide w;
  if (!wide_config(H, C, bf16_storage ? 2 : 4, &w)) return (int)cudaErrorInvalidValue;
  const void* kernel =
      bf16_storage ? (which == 0   ? (const void*)lstm2_wide_fwd_kernel<bf16>
                      : which == 1 ? (const void*)lstm2_wide_gates_kernel<bf16>
                                   : (const void*)lstm2_wide_chain_kernel<bf16>)
                   : (which == 0   ? (const void*)lstm2_wide_fwd_kernel<float>
                      : which == 1 ? (const void*)lstm2_wide_gates_kernel<float>
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
