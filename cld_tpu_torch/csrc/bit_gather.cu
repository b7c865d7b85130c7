// On-road bit gather from a bit-packed drivable map, for Hopper (sm_90a).
//
// Replaces the TPU kernel `cld_tpu/ops/pallas_kernels.py:_bit_gather_kernel`
// (called by `drivable_bit_gather_pallas`). That kernel fetched packed bytes
// with a one-hot matrix product because the TPU has no fast per-lane gather;
// on the GPU each thread reads its byte directly:
//     out[b, q] = ((packed[b, row, col >> 3] & 0xFF) >> (col & 7)) & 1
// with (col, row) = pix[b, q], clamped to the map.
//
// What bounds it on the H100: bytes. At the guided path's shapes (B = 128,
// Q = 5200 query points, a 224 x 28-byte packed map per agent) it reads
// 5.3 MB of int32 coordinates and writes 2.7 MB of f32; the packed maps are
// 0.8 MB, of which it needs at most the 5200 bytes per map under its queries,
// and stay in L2. There is no arithmetic to speak of.
//
// What the design does about it: one thread per query point, the (col, row)
// pair read as one 8-byte int2 load, neighbouring threads on neighbouring
// points so both the coordinate loads and the output stores coalesce. The
// byte reads scatter, but a point's bbox neighbours fall in the same map rows
// and the whole packed map set fits in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void bit_gather_kernel(const int2* __restrict__ pix,
                                  const int8_t* __restrict__ packed,
                                  float* __restrict__ out, int B, int Q, int Hm, int W8) {
  const long long n = (long long)B * Q;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int b = (int)(idx / Q);
  const int2 p = pix[idx];
  const int col = min(max(p.x, 0), 8 * W8 - 1);
  const int row = min(max(p.y, 0), Hm - 1);
  const unsigned int byte =
      (unsigned int)(uint8_t)packed[((size_t)b * Hm + row) * W8 + (col >> 3)];
  out[idx] = (float)((byte >> (col & 7)) & 1u);
}

}  // namespace

extern "C" {

// pix [B, Q, 2] int32 (col, row); packed [B, Hm, W8] int8 (8 columns per byte,
// LSB first); out [B, Q] f32. Launches on `stream`; returns cudaGetLastError().
int cld_bit_gather(const int* pix, const int8_t* packed, float* out, int B, int Q, int Hm,
                   int W8, void* stream) {
  const long long n = (long long)B * Q;
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  bit_gather_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const int2*>(pix), packed, out, B, Q, Hm, W8);
  return (int)cudaGetLastError();
}

}  // extern "C"
