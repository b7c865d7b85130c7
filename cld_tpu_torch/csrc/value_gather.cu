// Multi-channel int8 value gather from per-window map crops, for Hopper
// (sm_90a): the semantic-map warp of the closed-loop observation renderer.
//
// Replaces the TPU kernel `cld_tpu/ops/pallas_kernels.py:_value_gather_kernel`
// (called by `value_gather_pallas`). That kernel fetched window bytes with a
// row one-hot matrix product per channel over transposed [C, W, H] windows and
// a masked column reduce, because the TPU has no fast per-lane gather; on the
// GPU each thread reads its bytes directly:
//     out[m, q, c] = (float)wins[m, row, col, c]      (signed byte value)
// with (col, row) = pix[m, q], clamped to the window.
//
// What bounds it on the H100: bytes. At the closed loop's shapes (M = 64
// windows of 256 x 256 x 3 int8, Q = 25,088 queries per window) it reads
// 12.8 MB of int32 coordinates and writes 19.3 MB of f32. Of the 12.6 MB of
// windows it needs only the bytes under its queries: at most 3 x 25,088 per
// window, 4.8 MB in all, which the 50 MB L2 holds. The bound is 0.0108 ms.
//
// The first design (one query per thread; 0.0379 ms from a CUDA graph on an
// H100 at 700 W, slower than one torch.take at 0.0263 ms) kept one gather in
// flight per thread: an 8-byte pix load, then C dependent byte loads, then C
// scalar stores at a 4C-byte stride, so a warp's store covered 12 B a lane in
// three partial passes. It also divided a 64-bit index by Q in every thread.
//
// What this design does about it (0.0243 ms from a graph with random
// queries, 0.0178 with the warp's rotated bands; one torch.take 0.0261 and
// 0.0236 in the same run):
// - A thread takes kGroup = 4 consecutive queries of one window. Their pix
//   pairs arrive as two 16-byte loads marked evict-first (each is read once),
//   all 12 byte loads issue before any is used (through the read-only path),
//   and the 12 floats leave as three 16-byte stores: a warp's store
//   instruction covers 32 x 16 contiguous bytes.
// - The grid is (blocks per window, M), a block of 256 threads per 1,024
//   queries of one window: the window is blockIdx.y and no thread divides.
// - The vector path needs Q % 4 == 0 and 16-byte aligned pix and out (then
//   every group starts 16-byte aligned); otherwise the same schedule runs
//   with scalar loads and stores and a ragged last group. C = 3, the
//   semantic maps' channels, is unrolled; any other C takes a runtime loop.
// What still bounds it: random queries fetch a 32-byte sector from L2 for
// each 3-byte pixel, traffic that the byte bound above does not count.
// Measured slower in probe runs on the card (their scripts are not kept):
// one wave of blocks sized from the SM count, each thread striding over two
// groups; 8 queries a thread; 128 threads a block; the C bytes of a pixel as
// one aligned 8-byte load (and a second where they straddle); a warp's pix
// read as 32 consecutive 16-byte vectors twice. Evict-first stores of out
// were faster in a graph of repeated launches, but in the warp the next
// operation reads out at once, so out is stored normally.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 4;      // consecutive queries per thread
constexpr int kThreads = 256;  // per block

__device__ __forceinline__ int clampi(int v, int hi) { return min(max(v, 0), hi); }

// kC > 0: C fixed at compile time; kC == 0: C = C_rt.
template <int kC, bool kVec>
__global__ void __launch_bounds__(kThreads)
value_gather_kernel(const int* __restrict__ pix, const int8_t* __restrict__ wins,
                    float* __restrict__ out, int Q, int H, int W, int C_rt) {
  const int C = kC > 0 ? kC : C_rt;
  const int m = blockIdx.y;
  const int q0 = (blockIdx.x * kThreads + threadIdx.x) * kGroup;
  if (q0 >= Q) return;
  const int* pm = pix + (size_t)m * Q * 2;
  const int8_t* wm = wins + (size_t)m * H * W * C;
  float* dst = out + ((size_t)m * Q + q0) * C;

  int px[kGroup], py[kGroup];
  if constexpr (kVec) {
    const int4* src = reinterpret_cast<const int4*>(pm + 2 * q0);
    const int4 a = __ldcs(src), b = __ldcs(src + 1);
    px[0] = a.x; py[0] = a.y; px[1] = a.z; py[1] = a.w;
    px[2] = b.x; py[2] = b.y; px[3] = b.z; py[3] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      // a ragged last group repeats its last query; only real ones are stored
      const int2 p = __ldcs(reinterpret_cast<const int2*>(pm) + min(q0 + k, Q - 1));
      px[k] = p.x;
      py[k] = p.y;
    }
  }
  int off[kGroup];
#pragma unroll
  for (int k = 0; k < kGroup; ++k) off[k] = (clampi(py[k], H - 1) * W + clampi(px[k], W - 1)) * C;

  if constexpr (kC > 0) {
    int8_t v[kGroup * kC];
#pragma unroll
    for (int k = 0; k < kGroup; ++k)
#pragma unroll
      for (int c = 0; c < kC; ++c) v[k * kC + c] = __ldg(wm + off[k] + c);
    if constexpr (kVec) {
#pragma unroll
      for (int i = 0; i < kC; ++i)
        reinterpret_cast<float4*>(dst)[i] = make_float4((float)v[4 * i], (float)v[4 * i + 1],
                                                        (float)v[4 * i + 2], (float)v[4 * i + 3]);
    } else {
      const int n = min(kGroup, Q - q0) * kC;
#pragma unroll
      for (int i = 0; i < kGroup * kC; ++i)
        if (i < n) dst[i] = (float)v[i];
    }
  } else {
    const int n = min(kGroup, Q - q0);
    for (int k = 0; k < n; ++k)
      for (int c = 0; c < C; ++c) dst[k * C + c] = (float)__ldg(wm + off[k] + c);
  }
}

// The instantiation for C channels: the semantic maps' C = 3 unrolled, any
// other C through the runtime-C loop (scalar, no vector path).
const void* kernel_for(int C, bool vec) {
  if (C != 3) return (const void*)value_gather_kernel<0, false>;
  return vec ? (const void*)value_gather_kernel<3, true>
             : (const void*)value_gather_kernel<3, false>;
}

}  // namespace

extern "C" {

// pix [M, Q, 2] int32 (col, row) window-local, 8-byte aligned; wins
// [M, H, W, C] int8; out [M, Q, C] f32. Launches on `stream`; returns
// cudaGetLastError().
int cld_value_gather(const int* pix, const int8_t* wins, float* out, int M, int Q, int H, int W,
                     int C, void* stream) {
  if (M == 0 || Q == 0 || C == 0) return 0;
  if (M > 65535) return (int)cudaErrorInvalidValue;
  const bool vec = Q % kGroup == 0 && (uintptr_t)pix % 16 == 0 && (uintptr_t)out % 16 == 0;
  const int per_window = (Q + kGroup * kThreads - 1) / (kGroup * kThreads);
  void* args[] = {&pix, &wins, &out, &Q, &H, &W, &C};
  const cudaError_t err = cudaLaunchKernel(kernel_for(C, vec), dim3(per_window, M),
                                           dim3(kThreads), args, 0, (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The compiler's verdict on the instantiation that `cld_value_gather` runs for
// C channels on the vector path (vec != 0) or the scalar one: registers and
// local memory bytes (spills) per thread, max threads per block.
int cld_value_gather_attributes(int C, int vec, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel_for(C, vec != 0));
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  return 0;
}

}  // extern "C"
