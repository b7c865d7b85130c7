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
// window, 4.8 MB in all, and fewer where queries share a pixel. There is no
// arithmetic to speak of.
//
// What the design does about it: one thread per query point, the (col, row)
// pair read as one 8-byte int2 load, the C channel bytes of a pixel adjacent
// in memory (channels-last windows, no transpose), neighbouring threads on
// neighbouring queries so the coordinate loads and the C-float stores of a
// warp cover contiguous memory. The queries of one window are a rotated
// raster band, so neighbouring threads read neighbouring window pixels and
// the byte reads hit in L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void value_gather_kernel(const int2* __restrict__ pix,
                                    const int8_t* __restrict__ wins,
                                    float* __restrict__ out, int M, int Q, int H, int W, int C) {
  const long long n = (long long)M * Q;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int m = (int)(idx / Q);
  const int2 p = pix[idx];
  const int col = min(max(p.x, 0), W - 1);
  const int row = min(max(p.y, 0), H - 1);
  const int8_t* src = wins + (((size_t)m * H + row) * W + col) * C;
  float* dst = out + (size_t)idx * C;
  for (int c = 0; c < C; ++c) dst[c] = (float)src[c];
}

}  // namespace

extern "C" {

// pix [M, Q, 2] int32 (col, row) window-local; wins [M, H, W, C] int8;
// out [M, Q, C] f32. Launches on `stream`; returns cudaGetLastError().
int cld_value_gather(const int* pix, const int8_t* wins, float* out, int M, int Q, int H, int W,
                     int C, void* stream) {
  const long long n = (long long)M * Q;
  if (n == 0 || C == 0) return 0;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  value_gather_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const int2*>(pix), wins, out, M, Q, H, W, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
