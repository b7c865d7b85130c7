// Off-road count of the PPO reward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `cld_tpu/ops/pallas_kernels.py:_offroad_kernel`
// (called by `offroad_count_pallas`). That kernel kept a whole 224 x 224 f32
// map in VMEM per program and fetched the P map values with a one-hot
// row-select matrix product and a lane select, because the TPU has no fast
// per-lane gather. On the GPU a thread reads its map value directly:
//     out[b, g] = #{ p : map[b, row, col] <= 0,  (col, row) = pix[b, g, p] }
// The count is an integer stored as f32, so it equals the plain version
// exactly. The group axis g lets one launch score every sample of an agent
// against the agent's one map (the reward's [B, N, T] points); the TPU
// kernel's [B, P] form is G = 1.
//
// What bounds it on the H100: the launch. At the reward's shapes (B = 128,
// G = 1, P = 52, a 224 x 224 f32 map per agent) it reads 53 KB of
// coordinates and at most 6,656 32-byte sectors of map and writes 512 bytes:
// well under a microsecond of memory traffic.
//
// What the design does about it: one block per (b, g), one warp-shuffle
// reduction and one pass over shared memory, no atomics; the (col, row) pair
// is one 8-byte load. Nothing else is worth doing at this size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void offroad_count_kernel(const int2* __restrict__ pix, const float* __restrict__ map,
                                     float* __restrict__ out, int G, int P, int Hm, int W) {
  __shared__ int warp_sums[kThreads / 32];
  const int bg = blockIdx.x;
  const int b = bg / G;
  const int2* p = pix + (size_t)bg * P;
  const float* m = map + (size_t)b * Hm * W;
  int n = 0;
  for (int q = threadIdx.x; q < P; q += kThreads) {
    const int2 cr = p[q];
    const int col = min(max(cr.x, 0), W - 1);
    const int row = min(max(cr.y, 0), Hm - 1);
    n += (m[(size_t)row * W + col] <= 0.0f) ? 1 : 0;
  }
  for (int off = 16; off > 0; off >>= 1) n += __shfl_down_sync(0xffffffffu, n, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    out[bg] = (float)total;
  }
}

}  // namespace

extern "C" {

// pix [B, G, P, 2] int32 (col, row); map [B, Hm, W] f32; out [B, G] f32.
// Launches on `stream`; returns cudaGetLastError().
int cld_offroad_count(const int* pix, const float* map, float* out, int B, int G, int P, int Hm,
                      int W, void* stream) {
  if ((long long)B * G == 0) return 0;
  offroad_count_kernel<<<(unsigned int)(B * G), kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const int2*>(pix), map, out, G, P, Hm, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
