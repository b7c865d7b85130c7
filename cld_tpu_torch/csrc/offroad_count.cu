// Off-road count of the PPO reward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `cld_tpu/ops/pallas_kernels.py:_offroad_kernel`
// (called by `offroad_count_pallas`). That kernel kept a whole 224 x 224 f32
// map in VMEM per program and fetched the P map values with a one-hot
// row-select matrix product and a lane select, because the TPU has no fast
// per-lane gather. On the GPU a lane reads its map values directly:
//     out[b, g] = #{ p : map[b, row, col] <= 0,  (col, row) = pix[b, g, p] }
// The count is an integer stored as f32, so it equals the plain version
// exactly. The group axis g lets one launch score every sample of an agent
// against the agent's one map (the reward's [B, N, T] points); the TPU
// kernel's [B, P] form is G = 1.
//
// What bounds it on the H100: the launch. At the reward's shapes (B = 128,
// G = 1, P = 52, a 224 x 224 f32 map per agent) it reads 53 KB of
// coordinates and at most 6,656 32-byte sectors of map and writes 512 bytes:
// well under a microsecond of memory traffic, and under the cost of one
// kernel node of a CUDA graph.
//
// The first design (one 128-thread block per (b, g), 1.82 us from a CUDA
// graph on an H100 at 700 W) left 76 of its 128 threads without a point at
// P = 52, and after the warp shuffle passed the partial sums through shared
// memory, a barrier and a serial sum by thread 0.
//
// What this design does about it: one warp per (b, g), kWarps groups a
// block (B * G = 128 is 32 blocks; a ragged last block's spare warps exit).
// A lane takes points lane, lane + 32, ..., kUnroll = 4 of them per pass,
// all of their coordinate loads (evict-first: read once) before any of their
// map loads, so a pass is one dependent round trip; P <= 128 is one pass, as
// in the first design's 128-thread block (a lane past P loads point P - 1
// again, which the warp reads as one broadcast, and does not count it). One
// `__reduce_add_sync` sums the lanes' integer counts and lane 0 stores: no
// shared memory, no barrier.
// Measured (`kernel_ab.py`, CUDA graphs on an H100 at 700 W, the first design
// in the same call): 1.69 us against 1.83 at P = 52, and 1.54-1.72 against
// 1.84 at P = 65, where an empty kernel reads 0.8-1.0 us. What is left above
// that floor is the one dependent pass and the reduction and store behind
// it: with 2 points a lane, P = 65 takes a second pass and read 2.17 us.
// Measured no faster in probe runs on the card (their scripts are not kept):
// 1, 2 or 8 warps a block; 1 point a lane a pass (two passes at P = 52); pix
// through the read-only path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;   // (b, g) groups per block, one warp each
constexpr int kUnroll = 4;  // points per lane in flight: P <= 128 is one pass

__device__ __forceinline__ int clampi(int v, int hi) { return min(max(v, 0), hi); }

__global__ void __launch_bounds__(kWarps * 32)
offroad_count_kernel(const int2* __restrict__ pix, const float* __restrict__ map,
                     float* __restrict__ out, int BG, int G, int P, int Hm, int W) {
  const int bg = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (bg >= BG) return;  // the whole warp: the reduction below stays full-mask
  const int lane = threadIdx.x & 31;
  const int2* p = pix + (size_t)bg * P;
  const float* m = map + (size_t)(bg / G) * Hm * W;
  unsigned int n = 0;
  for (int q = lane; q < P; q += 32 * kUnroll) {
    int2 cr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cr[u] = __ldcs(p + min(q + 32 * u, P - 1));
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = __ldg(m + clampi(cr[u].y, Hm - 1) * W + clampi(cr[u].x, W - 1));
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) n += (q + 32 * u < P && v[u] <= 0.0f) ? 1u : 0u;
  }
  n = __reduce_add_sync(0xffffffffu, n);
  if (lane == 0) out[bg] = (float)n;
}

}  // namespace

extern "C" {

// pix [B, G, P, 2] int32 (col, row), 8-byte aligned; map [B, Hm, W] f32;
// out [B, G] f32. Launches on `stream`; returns cudaGetLastError().
int cld_offroad_count(const int* pix, const float* map, float* out, int B, int G, int P, int Hm,
                      int W, void* stream) {
  const int BG = B * G;
  if (BG == 0) return 0;
  offroad_count_kernel<<<(unsigned int)((BG + kWarps - 1) / kWarps), kWarps * 32, 0,
                         (cudaStream_t)stream>>>(reinterpret_cast<const int2*>(pix), map, out,
                                                 BG, G, P, Hm, W);
  return (int)cudaGetLastError();
}

// The compiler's verdict on the kernel: registers and local memory bytes
// (spills) per thread, max threads per block.
int cld_offroad_count_attributes(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, (const void*)offroad_count_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  return 0;
}

}  // extern "C"
