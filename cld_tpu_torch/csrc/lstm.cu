// Fused two-layer LSTM decoder sweeps for Hopper (sm_90a).
//
// Replaces the TPU kernels `cld_tpu/ops/lstm_pallas.py:_fwd_kernel` (forward)
// and `_bwd_kernel_v2` (reverse sweep); `_bwd_kernel` (v1) computes the same
// dg1/dg2 and needs no kernel of its own here.
//
// Hidden sizes: the port takes every H in [1, 320], as the TPU kernels do.
// The wrapper (`lstm_kernels.py:padded_hidden`) pads H with zero units:
// H <= 64 to a multiple of 8, run here (f32) or in `lstm_bf16.cu` (bf16);
// a larger H to a multiple of 16, run by `lstm_wide.cu` in both types.
//
// Cell math is flax `OptimizedLSTMCell`: gate order i, f, g, o; i/f/o
// sigmoid, g tanh; c' = f*c + i*g; h' = o*tanh(c'). h0 is the initial hidden
// state of BOTH layers, c0 = 0. The input projection xg1 = z @ Wx1 + b1 and
// the output head run outside the kernels.
//
// What bounds them on the H100: the chain, not operations or bytes. Each
// sweep is T = 52 dependent steps, and a step's work is two small
// matrix-vector products per batch row ([H] x [H, 4H] and [2H] x [2H, 4H]);
// at B = 128, H = 64 a whole sweep is ~0.66 GFLOP (~0.01 ms of the card's
// f32 rate) and ~14 MB. With one row per SM a step is the instructions every
// warp issues between two barriers (shared-memory reads of the h or dg
// vector, FMAs, shuffles, the cell math) and their latency, 52 times over.
// The design takes everything it can off that chain: weight loads, the
// gate recompute of the reverse sweep, global reads, and barriers.
//
// Forward (`lstm2_fwd_kernel`), a persistent RNN (Diamos et al., ICML 2016):
// * one CTA owns R batch rows for the whole sweep, 8H threads. Eight lanes
//   of one warp own hidden unit k: its four gate columns (i, f, g, o), the K
//   dimension split across the eight lanes. A reduce-scatter of four
//   shuffles in a fixed order leaves each gate's pre-activation in two lanes,
//   which activate it; four more shuffles hand every lane the four
//   activations, all eight update c in a register (c never leaves it for 52
//   steps) and one lane writes h into a double-buffered shared array: one
//   barrier per layer and step. Layer 2's recurrent product h2[t-1] W2[H:]
//   runs beside layer 1, off layer 2's part of the chain.
// * weights stay where the threads are: each thread loads its slices of
//   Wh1 and W2 into registers once (96 floats at H = 64, 128 registers in
//   all, the most 512 threads can have, no spill). With two rows per CTA W2's recurrent
//   half (W2[H:], 64 KiB) moves to shared memory, read as float4 in thread
//   order (conflict-free). The h vectors are read as float4 broadcasts. The
//   weights arrive packed in that thread order
//   (`lstm_kernels.py:pack_weights`), so every load is coalesced.
// * xg1 of step t+1 is loaded during step t; the four state outputs are
//   stored by four lanes of each unit, off the chain.
// * R (1 or 2) comes from B and the SM count (`rows_per_cta`): one row per
//   CTA while B fits the card, two beyond it (a step's issue work grows with
//   R, so four rows in one wave lose to two rows in two waves); the last CTA
//   masks its rows past B.
//
// Reverse sweep (`cld_lstm2_bwd`): the gate activations of step t depend
// only on the saved forward states, never on the carries, so they come off
// the serial chain. Two kernels, one launch of `lstm2_bwd` for the caller:
// * `lstm2_bwd_gates_kernel`, parallel over all (b, t): recomputes both
//   layers' gates (a 32-pair tile per CTA, 8 pairs x 4 gate columns per
//   thread: each float4 of weights, read coalesced, meets 8 inputs from
//   shared memory) and folds them with c_t, c_{t-1} and dy into the
//   13 per-unit coefficients the chain needs: dy, then per layer
//   o(1 - tanh^2 c), f, and the four gate factors, so that dc = dc' + dh*B
//   and dg = dc*A (dh*A for o). It writes them to a scratch buffer
//   [B, T, 13, H] that the wrapper allocates.
// * `lstm2_bwd_kernel`, the chain: same thread layout as the forward, the
//   W^T products in the transposed split (unit k's lanes hold W2[k, :],
//   Wh1[k, :] in registers and W2[H + k, :] in shared memory, eight lanes
//   splitting the 4H gate columns), the step's coefficients fetched by
//   cp.async into a double buffer one step ahead. Per step: layer 2's
//   cotangents -> barrier -> dxh = dg2 W2^T (shuffle-reduced; its second
//   half is the next step's dh2) -> layer 1's cotangents -> barrier ->
//   dh1 = dg1 Wh1^T. Two barriers, down from six.
//
// f32 only, and no tensor cores: the tolerance against the plain version is
// 1e-5 of the largest value in f32, and TF32 keeps ~3 digits. Storage and
// math are f32 without fast-math intrinsics (expf / tanhf); every sum runs
// in a fixed order with no atomics, so two launches agree bit for bit.
// Results differ from a plain PyTorch loop by summation order and, in the
// forward's g gate, by tanh taken as 2 sigm(2x) - 1 (~1e-7 absolute). Under
// bf16 storage the sweeps are other kernels, on the tensor cores
// (`lstm_bf16.cu`).

#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

namespace {

constexpr int kLanes = 8;    // lanes per hidden unit
constexpr int kPlanes = 13;  // reverse-sweep coefficients per (b, t, unit)
constexpr int kPairs = 32;   // (b, t) pairs per gates-kernel CTA
constexpr int kPairStride = kPairs + 4;  // padded row of the gates kernel's inputs

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

constexpr unsigned kFull = 0xffffffffu;

// Sum over the eight lanes of a unit; every lane gets the same bits.
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  v += __shfl_xor_sync(kFull, v, 2);
  v += __shfl_xor_sync(kFull, v, 4);
  return v;
}

// Reduce-scatter of four partial sums (gates i, f, g, o) over the eight
// lanes of a unit in four shuffles: lane l gets the full sum of gate
// 2*(l>>2 & 1) + (l>>1 & 1), lanes 0-1 i, 2-3 f, 4-5 g, 6-7 o. Each gate's
// sum is taken in one fixed order, and both lanes of a pair get its bits.
__device__ __forceinline__ float gate_reduce(const float (&v)[4], int l) {
  const bool hi = l & 4, mid = l & 2;
  const float u0 = (hi ? v[2] : v[0]) + __shfl_xor_sync(kFull, hi ? v[0] : v[2], 4);
  const float u1 = (hi ? v[3] : v[1]) + __shfl_xor_sync(kFull, hi ? v[1] : v[3], 4);
  const float w = (mid ? u1 : u0) + __shfl_xor_sync(kFull, mid ? u0 : u1, 2);
  return w + __shfl_xor_sync(kFull, w, 1);
}

__device__ __forceinline__ void fma4(float (&a)[4], float h, float4 w) {
  a[0] = fmaf(h, w.x, a[0]);
  a[1] = fmaf(h, w.y, a[1]);
  a[2] = fmaf(h, w.z, a[2]);
  a[3] = fmaf(h, w.w, a[3]);
}

__device__ __forceinline__ float dot4(float4 d, float4 w, float acc) {
  acc = fmaf(d.x, w.x, acc);
  acc = fmaf(d.y, w.y, acc);
  acc = fmaf(d.z, w.z, acc);
  return fmaf(d.w, w.w, acc);
}

// a[r][g] += sum over lane l's elements of h_r[e] * w(m)[g]. Lane l's m-th
// element is (m/V*8 + l)*V + m%V (V = 4 when each lane has a multiple of 4,
// else 1): eight lanes read eight consecutive float4 (or floats).
template <int H, int R, typename W>
__device__ __forceinline__ void accum(float (&a)[R][4], const float* hb, int l, W w) {
  constexpr int K = H / kLanes;
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int e = 0; e < K / 4; ++e) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 h = reinterpret_cast<const float4*>(hb + r * H)[e * kLanes + l];
        fma4(a[r], h.x, w(4 * e + 0));
        fma4(a[r], h.y, w(4 * e + 1));
        fma4(a[r], h.z, w(4 * e + 2));
        fma4(a[r], h.w, w(4 * e + 3));
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < K; ++e) {
#pragma unroll
      for (int r = 0; r < R; ++r) fma4(a[r], hb[r * H + e * kLanes + l], w(e));
    }
  }
}

// One LSTM cell from the unit's partial sums v (i, f, g, o): each lane
// activates the gate `gate_reduce` gave it (the g lanes through the
// sigmoid's form of tanh, so that the warp does not diverge: ~1e-7 absolute
// from tanhf), the four activations meet by shuffles, and every lane updates
// c the same way; returns h.
__device__ __forceinline__ float cell(const float (&v)[4], int l, float& c) {
  const float pre = gate_reduce(v, l);
  const bool tanh_gate = (l >> 1) == 2;  // g = tanh(x) = 2 sigm(2x) - 1: no divergence
  const float sg = sigm(tanh_gate ? 2.0f * pre : pre);
  const float a = tanh_gate ? 2.0f * sg - 1.0f : sg;
  const float ig = __shfl_sync(kFull, a, 0, kLanes), fg = __shfl_sync(kFull, a, 2, kLanes);
  const float gg = __shfl_sync(kFull, a, 4, kLanes), og = __shfl_sync(kFull, a, 6, kLanes);
  c = fg * c + ig * gg;
  return og * tanhf(c);
}

// W2[H:] joins the other weights in registers at one row per CTA (128
// registers a thread at H = 64, no spill); with two rows it stays in shared
// memory.
template <int R>
constexpr bool kW2hInRegisters = R == 1;

template <int H, int R>
constexpr size_t fwd_smem_bytes() {
  return (kW2hInRegisters<R> ? 0 : sizeof(float4) * (H / kLanes) * (kLanes * H)) +
         sizeof(float) * 4 * R * H;
}

// Forward sweep. wpk: [3][H/8][8H] float4 (Wh1, W2[:H], W2[H:] in thread
// order, the four gates of one element per float4). Outputs y (= h2), h1, c1,
// c2 sequences, each [B, T, H].
template <int H, int R>
__global__ void __launch_bounds__(kLanes * H, 1) lstm2_fwd_kernel(
    const float* __restrict__ xg1, const float* __restrict__ h0,
    const float4* __restrict__ wpk, const float* __restrict__ b2, float* __restrict__ y,
    float* __restrict__ h1s, float* __restrict__ c1s, float* __restrict__ c2s, int B, int T) {
  constexpr int NT = kLanes * H, G = 4 * H, K = H / kLanes;
  extern __shared__ float4 smem4[];
  float4* w2h = smem4;                                     // [K][NT] unless in registers
  float* hb1 = reinterpret_cast<float*>(w2h + (kW2hInRegisters<R> ? 0 : K * NT));  // [2][R][H]
  float* hb2 = hb1 + 2 * R * H;                            // [2][R][H]
  const int tid = threadIdx.x, k = tid / kLanes, l = tid % kLanes;
  const int b0 = blockIdx.x * R;

  float4 w1[K], w2l[K], w2r[kW2hInRegisters<R> ? K : 1];
#pragma unroll
  for (int m = 0; m < K; ++m) {
    w1[m] = wpk[m * NT + tid];
    w2l[m] = wpk[(K + m) * NT + tid];
    if constexpr (kW2hInRegisters<R>) {
      w2r[m] = wpk[(2 * K + m) * NT + tid];
    } else {
      w2h[m * NT + tid] = wpk[(2 * K + m) * NT + tid];
    }
  }
  for (int i = tid; i < R * H; i += NT) {  // buffer 1 holds step -1
    const int b = b0 + i / H;
    const float v = b < B ? h0[(size_t)b * H + i % H] : 0.0f;
    hb1[R * H + i] = v;
    hb2[R * H + i] = v;
  }
  const float bias = l < 4 ? b2[l * H + k] : 0.0f;
  float c1[R], c2[R], xn[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int b = b0 + r;
    c1[r] = c2[r] = 0.0f;
    xn[r] = (l < 4 && b < B) ? xg1[(size_t)b * T * G + l * H + k] : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1, prv = cur ^ 1;
    float a[R][4], a2[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int b = b0 + r;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        a[r][g] = g == l ? xn[r] : 0.0f;
        a2[r][g] = g == l ? bias : 0.0f;
      }
      xn[r] = (l < 4 && b < B && t + 1 < T) ? xg1[((size_t)b * T + t + 1) * G + l * H + k]
                                            : 0.0f;
    }
    accum<H, R>(a, hb1 + prv * R * H, l, [&](int m) { return w1[m]; });
    // layer 2's recurrent half needs only h2[t-1]: it runs beside layer 1
    accum<H, R>(a2, hb2 + prv * R * H, l, [&](int m) {
      if constexpr (kW2hInRegisters<R>) return w2r[m];
      else return w2h[m * NT + tid];
    });
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float h = cell(a[r], l, c1[r]);
      if (l == 0) hb1[(cur * R + r) * H + k] = h;
      const int b = b0 + r;
      if (b < B) {
        const size_t o = ((size_t)b * T + t) * H + k;
        if (l == 0) h1s[o] = h;
        if (l == 1) c1s[o] = c1[r];
      }
    }
    __syncthreads();

    accum<H, R>(a2, hb1 + cur * R * H, l, [&](int m) { return w2l[m]; });
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float h = cell(a2[r], l, c2[r]);
      if (l == 0) hb2[(cur * R + r) * H + k] = h;
      const int b = b0 + r;
      if (b < B) {
        const size_t o = ((size_t)b * T + t) * H + k;
        if (l == 2) y[o] = h;
        if (l == 3) c2s[o] = c2[r];
      }
    }
    __syncthreads();
  }
}

template <int H>
constexpr size_t gates_smem_bytes() {
  return sizeof(float) * (3 * H * kPairStride + kPairs * 2 * 4 * H);
}

// Reverse sweep, part 1, parallel over (b, t): the 13 coefficients of each
// unit, coef [B, T, 13, H] with planes
//   0 dy;  1 o2(1 - tanh^2 c2), 2 f2, 3-6 layer 2's gate factors
//   (g i(1-i), c_prev f(1-f), i(1-g^2), tanh(c) o(1-o));  7-12 the same of
//   layer 1.
template <int H>
__global__ void __launch_bounds__(4 * H) lstm2_bwd_gates_kernel(
    const float* __restrict__ dy, const float* __restrict__ xg1,
    const float* __restrict__ h0, const float* __restrict__ Wh1,
    const float* __restrict__ W2, const float* __restrict__ b2,
    const float* __restrict__ h1s, const float* __restrict__ c1s,
    const float* __restrict__ ys, const float* __restrict__ c2s, float* __restrict__ coef,
    int B, int T) {
  constexpr int G = 4 * H, CG = G / 4, PT = 8;  // column groups of 4; pairs per thread
  constexpr int XS4 = kPairStride / 4;
  extern __shared__ float4 smem4[];
  float* xin = reinterpret_cast<float*>(smem4);  // [3H][kPairStride]: h1[t-1], h1[t], h2[t-1]
  float* act = xin + 3 * H * kPairStride;        // [kPairs][2][G]
  const int j = threadIdx.x;
  const int n0 = blockIdx.x * kPairs, N = B * T;

  // every loop below has a trip count fixed at compile time (3 kPairs / 4,
  // then kPairs / 4 per thread, for any H): unrolled, its loads are in flight
  // together
#pragma unroll
  for (int it = 0; it < 3 * kPairs / 4; ++it) {
    const int i = j + it * G, p = i / (3 * H), kk = i % (3 * H), n = n0 + p;
    float v = 0.0f;
    if (n < N) {
      const int b = n / T, t = n % T;
      if (kk < H) {
        v = t > 0 ? h1s[(size_t)(n - 1) * H + kk] : h0[(size_t)b * H + kk];
      } else if (kk < 2 * H) {
        v = h1s[(size_t)n * H + kk - H];
      } else {
        v = t > 0 ? ys[(size_t)(n - 1) * H + kk - 2 * H] : h0[(size_t)b * H + kk - 2 * H];
      }
    }
    xin[kk * kPairStride + p] = v;
  }
  // thread tile: pairs p0 .. p0+7 x gate columns c0 .. c0+3 of both layers
  const int cg = j % CG, p0 = PT * (j / CG), c0 = 4 * cg;
  float a1[PT][4], a2[PT][4];
  const float4 bias = reinterpret_cast<const float4*>(b2)[cg];
#pragma unroll
  for (int p = 0; p < PT; ++p) {
    const int n = n0 + p0 + p;
    const float4 x = n < N ? reinterpret_cast<const float4*>(xg1 + (size_t)n * G)[cg]
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    a1[p][0] = x.x, a1[p][1] = x.y, a1[p][2] = x.z, a1[p][3] = x.w;
    a2[p][0] = bias.x, a2[p][1] = bias.y, a2[p][2] = bias.z, a2[p][3] = bias.w;
  }
  __syncthreads();

  const float4* x4 = reinterpret_cast<const float4*>(xin);
#pragma unroll 8
  for (int kk = 0; kk < H; ++kk) {
    const float4 w = reinterpret_cast<const float4*>(Wh1 + kk * G)[cg];
    const float4 xa = x4[kk * XS4 + p0 / 4], xb = x4[kk * XS4 + p0 / 4 + 1];
    const float xv[PT] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
    for (int p = 0; p < PT; ++p) fma4(a1[p], xv[p], w);
  }
#pragma unroll 8
  for (int kk = 0; kk < 2 * H; ++kk) {
    const float4 w = reinterpret_cast<const float4*>(W2 + kk * G)[cg];
    const float4 xa = x4[(H + kk) * XS4 + p0 / 4], xb = x4[(H + kk) * XS4 + p0 / 4 + 1];
    const float xv[PT] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
    for (int p = 0; p < PT; ++p) fma4(a2[p], xv[p], w);
  }
  const bool tanh_gate = c0 / H == 2;  // four columns of one gate
  const auto activate = [&](const float (&v)[4]) {
    return tanh_gate ? make_float4(tanhf(v[0]), tanhf(v[1]), tanhf(v[2]), tanhf(v[3]))
                     : make_float4(sigm(v[0]), sigm(v[1]), sigm(v[2]), sigm(v[3]));
  };
#pragma unroll
  for (int p = 0; p < PT; ++p) {
    reinterpret_cast<float4*>(act + 2 * (p0 + p) * G)[cg] = activate(a1[p]);
    reinterpret_cast<float4*>(act + (2 * (p0 + p) + 1) * G)[cg] = activate(a2[p]);
  }
  __syncthreads();

#pragma unroll
  for (int it = 0; it < kPairs / 4; ++it) {
    const int i = j + it * G, p = i / H, k = i % H, n = n0 + p;
    if (n >= N) continue;
    const int t = n % T;
    float* o = coef + (size_t)n * kPlanes * H + k;
    o[0] = dy[(size_t)n * H + k];
#pragma unroll
    for (int layer = 0; layer < 2; ++layer) {  // layer 2 (planes 1-6), then layer 1 (7-12)
      const float* a = act + (2 * p + 1 - layer) * G;
      const float* cs = layer == 0 ? c2s : c1s;
      const float ig = a[k], fg = a[H + k], gg = a[2 * H + k], og = a[3 * H + k];
      const float c = cs[(size_t)n * H + k];
      const float cp = t > 0 ? cs[(size_t)(n - 1) * H + k] : 0.0f;
      const float tc = tanhf(c);
      float* q = o + (1 + 6 * layer) * H;
      q[0] = og * (1.0f - tc * tc);
      q[H] = fg;
      q[2 * H] = gg * ig * (1.0f - ig);
      q[3 * H] = cp * fg * (1.0f - fg);
      q[4 * H] = ig * (1.0f - gg * gg);
      q[5 * H] = tc * og * (1.0f - og);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying step t's coefficients of the CTA's rows into stage [R][13H].
// Rows past B are not copied: they compute on stale values and store nothing.
template <int H, int R>
__device__ __forceinline__ void stage_coef(float* stage, const float* __restrict__ coef,
                                           int b0, int B, int T, int t) {
  constexpr int NT = kLanes * H, ROW4 = kPlanes * H / 4;
  for (int i = threadIdx.x; i < R * ROW4; i += NT) {
    const int r = i / ROW4, q = i % ROW4, b = b0 + r;
    if (b < B) {
      cp_async16(stage + r * kPlanes * H + 4 * q,
                 coef + ((size_t)b * T + t) * kPlanes * H + 4 * q);
    }
  }
}

template <int H, int R>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float4) * (H / kLanes) * (kLanes * H) +
         sizeof(float) * (2 * R * kPlanes * H + 2 * R * 4 * H);
}

// Reverse sweep, part 2, the chain: writes the pre-activation gate
// cotangents dg1, dg2 [B, T, 4H]. wpk: [3][H/8][8H] float4 holding, for
// unit k's lane l, columns (m*8 + l)*4 .. +3 of the rows W2[k], W2[H + k]
// and Wh1[k].
template <int H, int R>
__global__ void __launch_bounds__(kLanes * H, 1) lstm2_bwd_kernel(
    const float* __restrict__ coef, const float4* __restrict__ wpk, float* __restrict__ dg1,
    float* __restrict__ dg2, int B, int T) {
  constexpr int NT = kLanes * H, G = 4 * H, J4 = H / kLanes, S = kPlanes * H;
  extern __shared__ float4 smem4[];
  float4* w2h = smem4;                                     // [J4][NT]
  float* stage = reinterpret_cast<float*>(w2h + J4 * NT);  // [2][R][S]
  float* d2b = stage + 2 * R * S;                          // [R][G] dg2 of step t
  float* d1b = d2b + R * G;                                // [R][G] dg1 of step t
  const int tid = threadIdx.x, k = tid / kLanes, l = tid % kLanes;
  const int b0 = blockIdx.x * R;

  float4 wa[J4], wb[J4];
#pragma unroll
  for (int m = 0; m < J4; ++m) {
    wa[m] = wpk[m * NT + tid];
    w2h[m * NT + tid] = wpk[(J4 + m) * NT + tid];
    wb[m] = wpk[(2 * J4 + m) * NT + tid];
  }
  float dh1c[R], dc1c[R], dh2c[R], dc2c[R];
#pragma unroll
  for (int r = 0; r < R; ++r) dh1c[r] = dc1c[r] = dh2c[r] = dc2c[r] = 0.0f;
  stage_coef<H, R>(stage + ((T - 1) & 1) * R * S, coef, b0, B, T, T - 1);
  cp_async_wait_all();
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const float* s = stage + (t & 1) * R * S;
    if (t > 0) stage_coef<H, R>(stage + ((t - 1) & 1) * R * S, coef, b0, B, T, t - 1);

    // layer 2
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float* sr = s + r * S;
      const float dh2 = sr[k] + dh2c[r];
      const float dc2 = fmaf(dh2, sr[H + k], dc2c[r]);
      dc2c[r] = dc2 * sr[2 * H + k];
      if (l < 4) {
        const float d = (l == 3 ? dh2 : dc2) * sr[(3 + l) * H + k];
        d2b[r * G + l * H + k] = d;
        const int b = b0 + r;
        if (b < B) dg2[((size_t)b * T + t) * G + l * H + k] = d;
      }
    }
    __syncthreads();

    // dxh = dg2 W2^T (both halves share the dg2 reads), then layer 1
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4* d4 = reinterpret_cast<const float4*>(d2b + r * G);
      float lo = 0.0f, hi = 0.0f;
#pragma unroll
      for (int m = 0; m < J4; ++m) {
        const float4 d = d4[m * kLanes + l];
        lo = dot4(d, wa[m], lo);
        hi = dot4(d, w2h[m * NT + tid], hi);
      }
      dh2c[r] = group_sum(hi);
      lo = group_sum(lo);
      const float* sr = s + r * S;
      const float dh1 = lo + dh1c[r];
      const float dc1 = fmaf(dh1, sr[7 * H + k], dc1c[r]);
      dc1c[r] = dc1 * sr[8 * H + k];
      if (l < 4) {
        const float d = (l == 3 ? dh1 : dc1) * sr[(9 + l) * H + k];
        d1b[r * G + l * H + k] = d;
        const int b = b0 + r;
        if (b < B) dg1[((size_t)b * T + t) * G + l * H + k] = d;
      }
    }
    cp_async_wait_all();  // step t-1's coefficients, visible to all after the barrier
    __syncthreads();

    // dh1 carry = dg1 Wh1^T
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4* d4 = reinterpret_cast<const float4*>(d1b + r * G);
      float acc = 0.0f;
#pragma unroll
      for (int m = 0; m < J4; ++m) acc = dot4(d4[m * kLanes + l], wb[m], acc);
      dh1c[r] = group_sum(acc);
    }
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

template <typename F>
int with_rows(int R, F&& f) {
  switch (R) {
    case 1: return f(Int<1>{});
    case 2: return f(Int<2>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_prep(const void* kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns a cudaError_t (0 on
// success). Shapes: xg1 [B, T, 4H], h0 [B, H], Wh1 [H, 4H], W2 [2H, 4H],
// b2 [4H]; every state / cotangent sequence [B, T, H]; dg1, dg2 [B, T, 4H];
// wpk the weights packed by `lstm_kernels.py:pack_weights` ("fwd" / "bwd"),
// 12H^2 floats; coef scratch [B, T, 13, H]; xg1, Wh1,
// W2, b2 and wpk 16-byte aligned (float4 reads). H a multiple
// of 8 in [8, 64]; R (rows per CTA) 1 or 2. All tensors contiguous f32 on
// the current device.

int cld_lstm2_fwd(const float* xg1, const float* h0, const float* wpk, const float* b2,
                  float* y, float* h1s, float* c1s, float* c2s, int B, int T, int H, int R,
                  void* stream) {
  if (B == 0 || T == 0) return 0;
  return with_hidden(H, [&](auto h) {
    return with_rows(R, [&](auto r) {
      constexpr int kH = decltype(h)::value, kR = decltype(r)::value;
      const auto kernel = lstm2_fwd_kernel<kH, kR>;
      const size_t smem = fwd_smem_bytes<kH, kR>();
      const int err = launch_prep((const void*)kernel, smem);
      if (err != 0) return err;
      kernel<<<(B + kR - 1) / kR, kLanes * kH, smem, (cudaStream_t)stream>>>(
          xg1, h0, reinterpret_cast<const float4*>(wpk), b2, y, h1s, c1s, c2s, B, T);
      return (int)cudaGetLastError();
    });
  });
}

// Launches the gates kernel (into coef) and then the chain: one reverse
// sweep for the caller.
int cld_lstm2_bwd(const float* dy, const float* xg1, const float* h0, const float* Wh1,
                  const float* W2, const float* b2, const float* h1s, const float* c1s,
                  const float* ys, const float* c2s, const float* wpk, float* coef,
                  float* dg1, float* dg2, int B, int T, int H, int R, void* stream) {
  if (B == 0 || T == 0) return 0;
  return with_hidden(H, [&](auto h) {
    return with_rows(R, [&](auto r) {
      constexpr int kH = decltype(h)::value, kR = decltype(r)::value;
      const cudaStream_t s = (cudaStream_t)stream;
      const auto gates = lstm2_bwd_gates_kernel<kH>;
      constexpr size_t gsm = gates_smem_bytes<kH>();
      int err = launch_prep((const void*)gates, gsm);
      if (err != 0) return err;
      gates<<<(B * T + kPairs - 1) / kPairs, 4 * kH, gsm, s>>>(
          dy, xg1, h0, Wh1, W2, b2, h1s, c1s, ys, c2s, coef, B, T);
      err = (int)cudaGetLastError();
      if (err != 0) return err;
      const auto chain = lstm2_bwd_kernel<kH, kR>;
      err = launch_prep((const void*)chain, bwd_smem_bytes<kH, kR>());
      if (err != 0) return err;
      chain<<<(B + kR - 1) / kR, kLanes * kH, bwd_smem_bytes<kH, kR>(), s>>>(
          coef, reinterpret_cast<const float4*>(wpk), dg1, dg2, B, T);
      return (int)cudaGetLastError();
    });
  });
}

// Compiler's verdict on one instantiation: out = {registers per thread,
// local memory bytes per thread (spills), max threads per block}. which: 0
// the forward, 1 the reverse sweep's gates kernel (R ignored), 2 its chain.
int cld_lstm2_attributes(int which, int H, int R, int* out) {
  return with_hidden(H, [&](auto h) {
    return with_rows(R, [&](auto r) {
      constexpr int kH = decltype(h)::value, kR = decltype(r)::value;
      const void* kernel = which == 0   ? (const void*)lstm2_fwd_kernel<kH, kR>
                           : which == 1 ? (const void*)lstm2_bwd_gates_kernel<kH>
                                        : (const void*)lstm2_bwd_kernel<kH, kR>;
      cudaFuncAttributes a;
      const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
      if (err != cudaSuccess) return (int)err;
      out[0] = a.numRegs;
      out[1] = (int)a.localSizeBytes;
      out[2] = a.maxThreadsPerBlock;
      return 0;
    });
  });
}

}  // extern "C"
