// Unpacked drivable-map value gather, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// `cld_tpu/ops/pallas_kernels.py:_drivable_gather_kernel` (called by
// `drivable_gather_pallas`). That kernel fetched map values with a row
// one-hot matrix product over transposed maps, 8 agents per program and the
// query list padded to 512/2048, because the TPU has no fast per-lane gather;
// on the GPU each thread reads its map value directly:
//     out[b, q] = (float)map[b, row, col]
// with (col, row) = pix[b, q], clamped to the map. int8 and float32 maps are
// both taken; the float32 value is returned as it is (the TPU kernel rounds
// float maps through bf16).
//
// What bounds it on the H100: bytes. At the guided path's shapes (B = 32,
// Q = 5200 query points, a 224 x 224 int8 map per agent) it reads 1.3 MB of
// int32 coordinates and writes 0.7 MB of f32. Of the 1.6 MB of maps it needs
// only the bytes under its queries: at most 5200 per map, 0.17 MB in all.
// The float32 entry point has no caller in the package yet: the map loss
// passes int8 maps.
//
// What the design does about it: one thread per query point, the (col, row)
// pair read as one 8-byte int2 load, neighbouring threads on neighbouring
// points so the coordinate loads and output stores coalesce. The map reads
// scatter, but a point's bbox neighbours fall in the same map rows and the
// whole map set fits in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void drivable_gather_kernel(const int2* __restrict__ pix, const T* __restrict__ map,
                                       float* __restrict__ out, int B, int Q, int Hm, int W) {
  const long long n = (long long)B * Q;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int b = (int)(idx / Q);
  const int2 p = pix[idx];
  const int col = min(max(p.x, 0), W - 1);
  const int row = min(max(p.y, 0), Hm - 1);
  out[idx] = (float)map[((size_t)b * Hm + row) * W + col];
}

template <typename T>
int launch(const int* pix, const T* map, float* out, int B, int Q, int Hm, int W, void* stream) {
  const long long n = (long long)B * Q;
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  drivable_gather_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const int2*>(pix), map, out, B, Q, Hm, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// pix [B, Q, 2] int32 (col, row); map [B, Hm, W] int8 or f32; out [B, Q] f32.
// Launches on `stream`; returns cudaGetLastError().
int cld_drivable_gather_i8(const int* pix, const int8_t* map, float* out, int B, int Q, int Hm,
                           int W, void* stream) {
  return launch<int8_t>(pix, map, out, B, Q, Hm, W, stream);
}

int cld_drivable_gather_f32(const int* pix, const float* map, float* out, int B, int Q, int Hm,
                            int W, void* stream) {
  return launch<float>(pix, map, out, B, Q, Hm, W, stream);
}

}  // extern "C"
