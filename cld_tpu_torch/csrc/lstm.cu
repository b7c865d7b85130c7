// Fused two-layer LSTM decoder sweeps for Hopper (sm_90a).
//
// Replaces the TPU kernels `cld_tpu/ops/lstm_pallas.py:_fwd_kernel` (forward)
// and `_bwd_kernel_v2` (reverse sweep); `_bwd_kernel` (v1) computes the same
// dg1/dg2 and needs no kernel of its own here.
//
// Cell math is flax `OptimizedLSTMCell`: gate order i, f, g, o; i/f/o
// sigmoid, g tanh; c' = f*c + i*g; h' = o*tanh(c'). h0 is the initial hidden
// state of BOTH layers, c0 = 0. The input projection xg1 = z @ Wx1 + b1 and
// the output head run outside the kernels.
//
// What bounds them on the H100: latency. Each sweep is T = 52 dependent
// steps, and a step's work is two tiny matrix-vector products per batch row
// ([64] x [64, 256] and [128] x [128, 256]); at B = 128 the whole sweep is
// ~0.66 GFLOP, a few microseconds of the card's f32 rate, and the bytes are
// ~14 MB. The time goes to the chain of steps, each of them a few dependent
// shared-memory reads, FMAs and barriers.
//
// What the design does about it: one CTA owns kRows batch rows for the whole
// sweep, so the carries (h, c, and in the backward dh, dc) never leave the
// SM, and 64 CTAs run side by side at B = 128. The weights (Wh1 64 KiB + W2
// 128 KiB in f32) are copied ONCE per CTA into shared memory (dynamic shared
// memory above 48 KB, opted in with cudaFuncAttributeMaxDynamicSharedMemorySize)
// with a padded row stride of 4H+1 floats: a warp reading a row of W (the
// forward's gate columns) and a warp reading a column of W (the backward's
// W^T products) both hit 32 different banks, so W^T needs no transposed copy.
// One thread owns one gate column (blockDim = 4H); each dot product keeps 4
// partial sums per row to break the FMA dependency chain.
//
// Storage is f32 and the math is f32 without fast-math intrinsics; results
// differ from a plain PyTorch loop only by summation order.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kRows = 2;  // batch rows per CTA

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

// Copy W [K, 4H] (row-major) into shared memory with row stride 4H + 1.
__device__ void stage_weights(float* dst, const float* __restrict__ src, int K, int G) {
  const int LD = G + 1;
  for (int i = threadIdx.x; i < K * G; i += blockDim.x) {
    dst[(i / G) * LD + (i % G)] = src[i];
  }
}

// acc[r] += sum_{k<K} x[r * xs + k] * w[k * LD + j]  (column j of a staged W)
__device__ __forceinline__ void dot_column(float (&acc)[kRows], const float* x, int xs,
                                           const float* w, int LD, int K, int j) {
  float p[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    p[r][0] = p[r][1] = p[r][2] = p[r][3] = 0.0f;
  }
  int k = 0;
  for (; k + 3 < K; k += 4) {
    const float w0 = w[(k + 0) * LD + j];
    const float w1 = w[(k + 1) * LD + j];
    const float w2 = w[(k + 2) * LD + j];
    const float w3 = w[(k + 3) * LD + j];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float* xr = x + r * xs + k;
      p[r][0] = fmaf(xr[0], w0, p[r][0]);
      p[r][1] = fmaf(xr[1], w1, p[r][1]);
      p[r][2] = fmaf(xr[2], w2, p[r][2]);
      p[r][3] = fmaf(xr[3], w3, p[r][3]);
    }
  }
  for (; k < K; ++k) {
    const float wk = w[k * LD + j];
#pragma unroll
    for (int r = 0; r < kRows; ++r) p[r][0] = fmaf(x[r * xs + k], wk, p[r][0]);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] += (p[r][0] + p[r][1]) + (p[r][2] + p[r][3]);
}

// sum_{j<G} d[j] * wrow[j]  (a row of a staged W: the W^T product)
__device__ __forceinline__ float dot_row(const float* d, const float* wrow, int G) {
  float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;
  int j = 0;
  for (; j + 3 < G; j += 4) {
    p0 = fmaf(d[j + 0], wrow[j + 0], p0);
    p1 = fmaf(d[j + 1], wrow[j + 1], p1);
    p2 = fmaf(d[j + 2], wrow[j + 2], p2);
    p3 = fmaf(d[j + 3], wrow[j + 3], p3);
  }
  for (; j < G; ++j) p0 = fmaf(d[j], wrow[j], p0);
  return (p0 + p1) + (p2 + p3);
}

size_t fwd_smem_bytes(int H) {
  const size_t G = 4 * (size_t)H, LD = G + 1;
  return sizeof(float) * (3 * H * LD + 4 * kRows * H + kRows * G);
}

size_t bwd_smem_bytes(int H) {
  const size_t G = 4 * (size_t)H, LD = G + 1;
  return sizeof(float) *
         (3 * H * LD + 4 * kRows * G + kRows * 2 * H + 3 * kRows * H + 4 * kRows * H);
}

// Forward sweep. Outputs y (= h2), h1, c1, c2 sequences, each [B, T, H].
__global__ void __launch_bounds__(1024) lstm2_fwd_kernel(
    const float* __restrict__ xg1, const float* __restrict__ h0,
    const float* __restrict__ Wh1, const float* __restrict__ W2,
    const float* __restrict__ b2, float* __restrict__ y, float* __restrict__ h1s,
    float* __restrict__ c1s, float* __restrict__ c2s, int B, int T, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H, LD = G + 1;
  float* wh1 = smem;              // [H][LD]
  float* w2 = wh1 + H * LD;       // [2H][LD]
  float* h1 = w2 + 2 * H * LD;    // [kRows][H] carries
  float* c1 = h1 + kRows * H;
  float* h2 = c1 + kRows * H;
  float* c2 = h2 + kRows * H;
  float* gates = c2 + kRows * H;  // [kRows][G] pre-activations
  const int j = threadIdx.x;      // gate column, blockDim == G
  const int b0 = blockIdx.x * kRows;

  stage_weights(wh1, Wh1, H, G);
  stage_weights(w2, W2, 2 * H, G);
  for (int i = j; i < kRows * H; i += blockDim.x) {
    const int b = b0 + i / H;
    const float v = b < B ? h0[(size_t)b * H + i % H] : 0.0f;
    h1[i] = v;
    h2[i] = v;
    c1[i] = 0.0f;
    c2[i] = 0.0f;
  }
  __syncthreads();
  const float bias2 = b2[j];
  const bool cell = j < kRows * H;
  const int cr = j / H, ck = j % H, cb = b0 + cr;  // cell-thread row, unit, batch

  for (int t = 0; t < T; ++t) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int b = b0 + r;
      acc[r] = b < B ? xg1[((size_t)b * T + t) * G + j] : 0.0f;
    }
    dot_column(acc, h1, H, wh1, LD, H, j);
#pragma unroll
    for (int r = 0; r < kRows; ++r) gates[r * G + j] = acc[r];
    __syncthreads();
    if (cell) {
      const float* g = gates + cr * G;
      const float ig = sigm(g[ck]), fg = sigm(g[H + ck]);
      const float gg = tanhf(g[2 * H + ck]), og = sigm(g[3 * H + ck]);
      const float c = fg * c1[j] + ig * gg;
      const float h = og * tanhf(c);
      c1[j] = c;
      h1[j] = h;
      if (cb < B) {
        const size_t o = ((size_t)cb * T + t) * H + ck;
        h1s[o] = h;
        c1s[o] = c;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = bias2;
    dot_column(acc, h1, H, w2, LD, H, j);
    dot_column(acc, h2, H, w2 + H * LD, LD, H, j);
#pragma unroll
    for (int r = 0; r < kRows; ++r) gates[r * G + j] = acc[r];
    __syncthreads();
    if (cell) {
      const float* g = gates + cr * G;
      const float ig = sigm(g[ck]), fg = sigm(g[H + ck]);
      const float gg = tanhf(g[2 * H + ck]), og = sigm(g[3 * H + ck]);
      const float c = fg * c2[j] + ig * gg;
      const float h = og * tanhf(c);
      c2[j] = c;
      h2[j] = h;
      if (cb < B) {
        const size_t o = ((size_t)cb * T + t) * H + ck;
        y[o] = h;
        c2s[o] = c;
      }
    }
    __syncthreads();
  }
}

// Reverse sweep: recomputes the gate activations of step t from the saved
// states and writes the pre-activation gate cotangents dg1, dg2 [B, T, 4H].
// blockDim == 4H == kRows * 2H, so the dxh = dg2 @ W2^T stage has one output
// per thread.
__global__ void __launch_bounds__(1024) lstm2_bwd_kernel(
    const float* __restrict__ dy, const float* __restrict__ xg1,
    const float* __restrict__ h0, const float* __restrict__ Wh1,
    const float* __restrict__ W2, const float* __restrict__ b2,
    const float* __restrict__ h1s, const float* __restrict__ c1s,
    const float* __restrict__ ys, const float* __restrict__ c2s,
    float* __restrict__ dg1, float* __restrict__ dg2, int B, int T, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H, LD = G + 1;
  float* wh1 = smem;               // [H][LD]
  float* w2 = wh1 + H * LD;        // [2H][LD]
  float* a1 = w2 + 2 * H * LD;     // [kRows][G] layer-1 activations
  float* a2 = a1 + kRows * G;      // [kRows][G] layer-2 activations
  float* d1 = a2 + kRows * G;      // [kRows][G] dg1 of step t
  float* d2 = d1 + kRows * G;      // [kRows][G] dg2 of step t
  float* dxh = d2 + kRows * G;     // [kRows][2H] dg2 @ W2^T
  float* h1p = dxh + kRows * 2 * H;  // [kRows][H] h1[t-1]
  float* h2p = h1p + kRows * H;    // [kRows][H] h2[t-1]
  float* h1t = h2p + kRows * H;    // [kRows][H] h1[t]
  float* dh1c = h1t + kRows * H;   // carries
  float* dc1c = dh1c + kRows * H;
  float* dh2c = dc1c + kRows * H;
  float* dc2c = dh2c + kRows * H;
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kRows;
  const bool tanh_gate = (tid / H) == 2;

  stage_weights(wh1, Wh1, H, G);
  stage_weights(w2, W2, 2 * H, G);
  for (int i = tid; i < 4 * kRows * H; i += blockDim.x) dh1c[i] = 0.0f;
  const float bias2 = b2[tid];
  const bool cell = tid < kRows * H;
  const int cr = tid / H, ck = tid % H, cb = b0 + cr;

  for (int t = T - 1; t >= 0; --t) {
    for (int i = tid; i < kRows * H; i += blockDim.x) {
      const int b = b0 + i / H, k = i % H;
      float v1 = 0.0f, vp1 = 0.0f, vp2 = 0.0f;
      if (b < B) {
        const size_t o = ((size_t)b * T + t) * H + k;
        v1 = h1s[o];
        vp1 = t > 0 ? h1s[o - H] : h0[(size_t)b * H + k];
        vp2 = t > 0 ? ys[o - H] : h0[(size_t)b * H + k];
      }
      h1t[i] = v1;
      h1p[i] = vp1;
      h2p[i] = vp2;
    }
    __syncthreads();

    // recompute both layers' gate activations (column tid)
    float p1[kRows], p2[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int b = b0 + r;
      p1[r] = b < B ? xg1[((size_t)b * T + t) * G + tid] : 0.0f;
      p2[r] = bias2;
    }
    dot_column(p1, h1p, H, wh1, LD, H, tid);
    dot_column(p2, h1t, H, w2, LD, H, tid);
    dot_column(p2, h2p, H, w2 + H * LD, LD, H, tid);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      a1[r * G + tid] = tanh_gate ? tanhf(p1[r]) : sigm(p1[r]);
      a2[r * G + tid] = tanh_gate ? tanhf(p2[r]) : sigm(p2[r]);
    }
    __syncthreads();

    // layer 2
    if (cell) {
      const float* a = a2 + cr * G;
      const float i2 = a[ck], f2 = a[H + ck], g2 = a[2 * H + ck], o2 = a[3 * H + ck];
      float c2t = 0.0f, c2p = 0.0f, dyt = 0.0f;
      if (cb < B) {
        const size_t o = ((size_t)cb * T + t) * H + ck;
        c2t = c2s[o];
        c2p = t > 0 ? c2s[o - H] : 0.0f;
        dyt = dy[o];
      }
      const float dh2 = dyt + dh2c[tid];
      const float tc2 = tanhf(c2t);
      const float do2 = dh2 * tc2;
      const float dc2 = dc2c[tid] + dh2 * o2 * (1.0f - tc2 * tc2);
      float* d = d2 + cr * G;
      d[ck] = dc2 * g2 * i2 * (1.0f - i2);
      d[H + ck] = dc2 * c2p * f2 * (1.0f - f2);
      d[2 * H + ck] = dc2 * i2 * (1.0f - g2 * g2);
      d[3 * H + ck] = do2 * o2 * (1.0f - o2);
      dc2c[tid] = dc2 * f2;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int b = b0 + r;
      if (b < B) dg2[((size_t)b * T + t) * G + tid] = d2[r * G + tid];
    }
    {
      const int r = tid / (2 * H), m = tid % (2 * H);
      dxh[tid] = dot_row(d2 + r * G, w2 + m * LD, G);
    }
    __syncthreads();

    // layer 1
    if (cell) {
      const float* a = a1 + cr * G;
      const float i1 = a[ck], f1 = a[H + ck], g1 = a[2 * H + ck], o1 = a[3 * H + ck];
      float c1t = 0.0f, c1p = 0.0f;
      if (cb < B) {
        const size_t o = ((size_t)cb * T + t) * H + ck;
        c1t = c1s[o];
        c1p = t > 0 ? c1s[o - H] : 0.0f;
      }
      const float dh1 = dxh[cr * 2 * H + ck] + dh1c[tid];
      const float tc1 = tanhf(c1t);
      const float do1 = dh1 * tc1;
      const float dc1 = dc1c[tid] + dh1 * o1 * (1.0f - tc1 * tc1);
      float* d = d1 + cr * G;
      d[ck] = dc1 * g1 * i1 * (1.0f - i1);
      d[H + ck] = dc1 * c1p * f1 * (1.0f - f1);
      d[2 * H + ck] = dc1 * i1 * (1.0f - g1 * g1);
      d[3 * H + ck] = do1 * o1 * (1.0f - o1);
      dc1c[tid] = dc1 * f1;
      dh2c[tid] = dxh[cr * 2 * H + H + ck];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int b = b0 + r;
      if (b < B) dg1[((size_t)b * T + t) * G + tid] = d1[r * G + tid];
    }
    if (cell) dh1c[tid] = dot_row(d1 + cr * G, wh1 + ck * LD, G);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError() (0 on
// success). Shapes: xg1 [B, T, 4H], h0 [B, H], Wh1 [H, 4H], W2 [2H, 4H],
// b2 [4H]; every state / cotangent sequence [B, T, H]; dg1, dg2 [B, T, 4H].
// All tensors contiguous f32 on the current device.

int cld_lstm2_fwd(const float* xg1, const float* h0, const float* Wh1, const float* W2,
                  const float* b2, float* y, float* h1s, float* c1s, float* c2s, int B,
                  int T, int H, void* stream) {
  const size_t smem = fwd_smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(
      lstm2_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows);
  lstm2_fwd_kernel<<<grid, 4 * H, smem, (cudaStream_t)stream>>>(
      xg1, h0, Wh1, W2, b2, y, h1s, c1s, c2s, B, T, H);
  return (int)cudaGetLastError();
}

int cld_lstm2_bwd(const float* dy, const float* xg1, const float* h0, const float* Wh1,
                  const float* W2, const float* b2, const float* h1s, const float* c1s,
                  const float* ys, const float* c2s, float* dg1, float* dg2, int B, int T,
                  int H, void* stream) {
  const size_t smem = bwd_smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(
      lstm2_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows);
  lstm2_bwd_kernel<<<grid, 4 * H, smem, (cudaStream_t)stream>>>(
      dy, xg1, h0, Wh1, W2, b2, h1s, c1s, ys, c2s, dg1, dg2, B, T, H);
  return (int)cudaGetLastError();
}

}  // extern "C"
