// Rigid map-distance forward for Hopper (sm_90a): masked min and argmin over
// a pose-invariant distance cache, under two schedules.
//
// Replaces the TPU kernels
// `cld_tpu/ops/pallas_kernels.py:_rigid_min_kernel` (`rigid_min_pallas`) and
// `cld_tpu/ops/pallas_kernels.py:_rigid_min_fused_kernel`
// (`rigid_min_fused_pallas`). For agent b, step q and bbox point j:
//     m    = min over rows i of (onroad[b, q, i] ? d2[b, i, j] : 1e12)
//     idx  = the lowest row i that attains m
//     dist = sqrt(m + 1e-12)
// The TPU kernels flatten to [BB*QB*P, P] tiles, pad the horizon to a multiple
// of 8, take the mask as f32 and mask the last axis, leaning on d2 being
// symmetric; all of that is the TPU compiler's tiling. Here the rows (axis
// -2) are masked as the plain version does, the mask is one byte per row, and
// nothing is padded.
//
// What bounds it on the H100: at the guided path's shapes (B = 128, Q = 52,
// P = 100) it must move 11 MB (the cache 5.1 MB, the mask 0.7 MB, two outputs
// 5.3 MB), 3.3 us at the memory rate, and do B*Q*P*P = 67 M compare-selects,
// 2 us at the f32 rate: bytes, narrowly. In practice the inner loop's
// shared-memory reads and the launch path set its time.
//
// What the design does about it: a block stages d2[b] (P*P floats, 40 KB at
// P = 100) in dynamic shared memory, and a chunk of steps' mask bytes beside
// it. One thread per (q, j) walks the rows i in ascending order: it reads the
// mask byte (the same address across a warp's threads of one step: a
// broadcast) and d2[i*P + j] (neighbouring threads on neighbouring j:
// conflict-free), and keeps the running minimum with a strict <, so the
// lowest row wins a tie. No arithmetic touches the values before the final
// add and the IEEE sqrtf, so the result equals the plain version's bit for
// bit.
//
// `rigid_min_kernel`: grid (B, ceil(Q / RIGID_QB)); every block loads the
// cache again for its chunk of steps (from L2 after the first), and B*Q/8
// blocks fill the card. `rigid_min_fused_kernel`: one block per agent loads
// the cache once and sweeps the whole horizon in chunks; B blocks of 1024
// threads, which at B < 132 leaves SMs idle.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RIGID_QB = 8;         // steps per block of rigid_min_kernel
constexpr int RIGID_THREADS = 256;  // threads per block of rigid_min_kernel
constexpr int FUSED_QB = 10;        // steps per sweep of rigid_min_fused_kernel
constexpr int FUSED_THREADS = 1024;
constexpr float BIG_D2 = 1e12f;

__device__ __forceinline__ void stage_cache(float* d2s, const float* __restrict__ d2b, int PP) {
  for (int k = threadIdx.x; k < PP; k += blockDim.x) d2s[k] = d2b[k];
}

// Steps [q0, q0 + nq) of agent b: stage their mask bytes, then one thread per
// (q, j). The caller has staged d2s; ends with the block in step.
__device__ __forceinline__ void min_chunk(const float* d2s, uint8_t* ms,
                                          const uint8_t* __restrict__ onroad,
                                          float* __restrict__ dist, int* __restrict__ idx,
                                          size_t base, int nq, int P) {
  const int n = nq * P;
  for (int k = threadIdx.x; k < n; k += blockDim.x) ms[k] = onroad[base + k];
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int ql = k / P;
    const int j = k - ql * P;
    const uint8_t* m = ms + ql * P;
    float best = m[0] ? d2s[j] : BIG_D2;
    int arg = 0;
    for (int i = 1; i < P; ++i) {
      const float v = m[i] ? d2s[i * P + j] : BIG_D2;
      if (v < best) {
        best = v;
        arg = i;
      }
    }
    dist[base + k] = sqrtf(best + 1e-12f);
    idx[base + k] = arg;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(RIGID_THREADS)
rigid_min_kernel(const float* __restrict__ d2, const uint8_t* __restrict__ onroad,
                 float* __restrict__ dist, int* __restrict__ idx, int Q, int P) {
  extern __shared__ float smem[];
  float* d2s = smem;
  uint8_t* ms = reinterpret_cast<uint8_t*>(smem + P * P);
  const int b = blockIdx.x;
  const int q0 = blockIdx.y * RIGID_QB;
  stage_cache(d2s, d2 + (size_t)b * P * P, P * P);
  min_chunk(d2s, ms, onroad, dist, idx, ((size_t)b * Q + q0) * P, min(RIGID_QB, Q - q0), P);
}

__global__ void __launch_bounds__(FUSED_THREADS)
rigid_min_fused_kernel(const float* __restrict__ d2, const uint8_t* __restrict__ onroad,
                       float* __restrict__ dist, int* __restrict__ idx, int Q, int P) {
  extern __shared__ float smem[];
  float* d2s = smem;
  uint8_t* ms = reinterpret_cast<uint8_t*>(smem + P * P);
  const int b = blockIdx.x;
  stage_cache(d2s, d2 + (size_t)b * P * P, P * P);
  for (int q0 = 0; q0 < Q; q0 += FUSED_QB)
    min_chunk(d2s, ms, onroad, dist, idx, ((size_t)b * Q + q0) * P, min(FUSED_QB, Q - q0), P);
}

size_t smem_bytes(int P, int qb) { return (size_t)P * P * sizeof(float) + (size_t)qb * P; }

constexpr int MAX_DEVICES = 64;

// Raise the kernel's dynamic shared-memory limit on the current device to
// `smem` bytes, once per size that grows it (`raised[d]` is the limit set so
// far on device d; the attribute is kept per device).
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, size_t* raised) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && smem <= raised[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && dev < MAX_DEVICES) raised[dev] = smem;
  return err;
}

}  // namespace

extern "C" {

// d2 [B, P, P] f32; onroad [B, Q, P] one byte per row (0 = off-road);
// dist [B, Q, P] f32; idx [B, Q, P] int32. Launches on `stream`; returns
// cudaGetLastError() (or the error of raising the shared-memory limit).
int cld_rigid_min(const float* d2, const uint8_t* onroad, float* dist, int* idx, int B, int Q,
                  int P, void* stream) {
  if (B == 0 || Q == 0 || P == 0) return 0;
  static size_t raised[MAX_DEVICES] = {};
  const size_t smem = smem_bytes(P, RIGID_QB);
  cudaError_t err = allow_smem(rigid_min_kernel, smem, raised);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)B, (unsigned)((Q + RIGID_QB - 1) / RIGID_QB));
  rigid_min_kernel<<<grid, RIGID_THREADS, smem, (cudaStream_t)stream>>>(d2, onroad, dist, idx, Q,
                                                                        P);
  return (int)cudaGetLastError();
}

int cld_rigid_min_fused(const float* d2, const uint8_t* onroad, float* dist, int* idx, int B,
                        int Q, int P, void* stream) {
  if (B == 0 || Q == 0 || P == 0) return 0;
  static size_t raised[MAX_DEVICES] = {};
  const size_t smem = smem_bytes(P, FUSED_QB);
  cudaError_t err = allow_smem(rigid_min_fused_kernel, smem, raised);
  if (err != cudaSuccess) return (int)err;
  rigid_min_fused_kernel<<<(unsigned)B, FUSED_THREADS, smem, (cudaStream_t)stream>>>(
      d2, onroad, dist, idx, Q, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
