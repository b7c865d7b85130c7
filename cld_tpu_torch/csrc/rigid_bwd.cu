// Rigid map-distance backward for Hopper (sm_90a): routes each column's
// cotangent to its argmin row.
//
// Replaces the TPU kernel
// `cld_tpu/ops/pallas_kernels.py:_rigid_bwd_kernel` (`rigid_bwd_pallas`). For
// agent b and step q, with a_j = g_j / dist_j:
//     grad_i = p_i * sum_{j: idx_j = i} a_j  -  sum_{j: idx_j = i} a_j p_j
// The TPU kernel builds a [BB*QB, P, P] one-hot in its fast memory and reduces
// it, because scatters are slow there, and takes x and y as separate planes.
// Here pts and grad stay [B, Q, P, 2] interleaved and are read and written as
// float2.
//
// What bounds it on the H100: bytes. At B = 128, Q = 52, P = 100 it moves
// 18.6 MB (pts and grad 5.3 MB each, idx, dist and g 2.7 MB each), 0.00556 ms
// at the memory rate. The routing itself is P adds per (b, q).
//
// The first design (0.0405 ms from a CUDA graph on an H100 at 700 W, 7.3x its
// bound) ran one block of 128 threads per (b, q): after a barrier every
// thread walked all P staged columns with a compare and a branch each, P^2 =
// 10,000 steps per (b, q) for P useful adds, so it was bound by issue.
//
// What this design does about it: one warp per (b, q), `kWarps` per block,
// and O(P) routing with no block barrier:
// 1. Lane l loads columns j = 32k + l, k < kChunks = ceil(P / 32), a template
//    parameter so that the columns stay in registers (coalesced; pts as
//    float2), all loads first, then a_j = g_j / dist_j.
// 2. Chunk by chunk in ascending j, `__match_any_sync` groups the chunk's
//    lanes by row; each group reads its row's running sums from the warp's
//    slice of shared memory, adds its members' a_j, a_j x_j and a_j y_j in
//    ascending lane order (shuffles from each member), and its lowest lane
//    writes them back.
// 3. Row i (the lane that loaded column i, so p_i is in its registers) reads
//    its sums and stores grad_i.
// Every sum runs in ascending j from 0, the order of the first design, with
// no atomics: the gradient is the same bit for bit on every launch, and as
// the first design's. Measured slower in probe runs on the card (their
// scripts are not kept): a counting sort of the columns by row (histogram,
// scan, placement, then a walk of each row's segment), which computes the
// same sums in the same order; all chunks' matches issued before the first
// sum; 4 or 8 warps per block. The approximate division (`__fdividef`) was
// faster, but its 2 ulp in a_j cost more than rtol 1e-4 against the plain
// version where the two terms of grad_i nearly cancel.
//
// Any P: the template above holds every column of a (b, q) in registers,
// one instantiation per chunk count up to 7 (P <= 224, the bbox grids of
// record). Above that, `rigid_bwd_loop_kernel` walks the chunks in a loop:
// it loads, divides and routes one chunk of 32 columns at a time (the same
// `route_chunk`, so the same sums in the same ascending order), and reloads
// p_i for step 3. Its running sums take 3 P floats a warp of shared memory
// (24 KB for the block at P = 1,024).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 2;  // (b, q) per block
constexpr unsigned kFull = 0xffffffffu;

// Step 2 for one chunk of a warp's columns: lane l holds column j's row r
// (-1: routes nowhere), a_j and p_j. `__match_any_sync` groups the chunk's
// lanes by row; every lane of a group adds the same members in ascending
// lane order to its row's sums so far (sum: [3][P], a, a x, a y by row), and
// the lowest one writes them back.
__device__ __forceinline__ void route_chunk(float* sum, int P, int r, float a, float2 p,
                                            int lane, unsigned lower) {
  const unsigned same = __match_any_sync(kFull, r);
  const int most = __reduce_max_sync(kFull, r >= 0 ? __popc(same) : 0);
  float s_a = 0.f, s_x = 0.f, s_y = 0.f;
  if (r >= 0) {
    s_a = sum[r];
    s_x = sum[P + r];
    s_y = sum[2 * P + r];
  }
  const float ax = a * p.x, ay = a * p.y;
  unsigned members = r >= 0 ? same : 0u;
  for (int t = 0; t < most; ++t) {
    const int src = members ? __ffs(members) - 1 : lane;
    const float va = __shfl_sync(kFull, a, src);
    const float vx = __shfl_sync(kFull, ax, src);
    const float vy = __shfl_sync(kFull, ay, src);
    if (members) {
      s_a += va;
      s_x += vx;
      s_y += vy;
      members &= members - 1u;
    }
  }
  __syncwarp();
  if (r >= 0 && (same & lower) == 0) {
    sum[r] = s_a;
    sum[P + r] = s_x;
    sum[2 * P + r] = s_y;
  }
  __syncwarp();
}

template <int kChunks>
__global__ void __launch_bounds__(32 * kWarps)
rigid_bwd_kernel(const float2* __restrict__ pts, const int* __restrict__ idx,
                 const float* __restrict__ dist, const float* __restrict__ g,
                 float2* __restrict__ grad, int BQ, int P) {
  extern __shared__ float smem[];  // per warp: sums of a, a x, a y by row [3][P]
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int bq = blockIdx.x * kWarps + w;
  if (bq >= BQ) return;  // the whole warp: no lane of it syncs below
  float* sum = smem + (size_t)w * 3 * P;
  const size_t base = (size_t)bq * P;
  const unsigned lower = (1u << lane) - 1u;

  // 1. loads, every chunk's before the first division (IEEE division may
  // branch to a slow path, which would hold back the loads after it); a
  // column whose row is out of range routes nowhere, as in the plain
  // version, and so does a lane past P
  float2 p[kChunks];
  float a[kChunks], d[kChunks];
  int row[kChunks];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int j = 32 * k + lane;
    p[k] = make_float2(0.f, 0.f);
    a[k] = 0.f;
    d[k] = 1.f;
    row[k] = -1;
    if (j < P) {
      p[k] = pts[base + j];
      a[k] = g[base + j];
      d[k] = dist[base + j];
      const int r = idx[base + j];
      row[k] = (unsigned)r < (unsigned)P ? r : -1;
    }
  }
#pragma unroll
  for (int k = 0; k < kChunks; ++k) a[k] /= d[k];
  for (int i = lane; i < 3 * P; i += 32) sum[i] = 0.f;
  __syncwarp();

  // 2. running sums, chunk by chunk in ascending j
#pragma unroll
  for (int k = 0; k < kChunks; ++k) route_chunk(sum, P, row[k], a[k], p[k], lane, lower);

  // 3. row i's gradient
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int i = 32 * k + lane;
    if (i < P)
      grad[base + i] =
          make_float2(p[k].x * sum[i] - sum[P + i], p[k].y * sum[i] - sum[2 * P + i]);
  }
}

// The same function for any number of chunks: each chunk loaded, divided
// and routed in turn, p_i reloaded for the gradient.
__global__ void __launch_bounds__(32 * kWarps)
rigid_bwd_loop_kernel(const float2* __restrict__ pts, const int* __restrict__ idx,
                      const float* __restrict__ dist, const float* __restrict__ g,
                      float2* __restrict__ grad, int BQ, int P) {
  extern __shared__ float smem[];  // per warp: sums of a, a x, a y by row [3][P]
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int bq = blockIdx.x * kWarps + w;
  if (bq >= BQ) return;  // the whole warp: no lane of it syncs below
  float* sum = smem + (size_t)w * 3 * P;
  const size_t base = (size_t)bq * P;
  const unsigned lower = (1u << lane) - 1u;
  for (int i = lane; i < 3 * P; i += 32) sum[i] = 0.f;
  __syncwarp();
  for (int j0 = 0; j0 < P; j0 += 32) {
    const int j = j0 + lane;
    float2 p = make_float2(0.f, 0.f);
    float a = 0.f, d = 1.f;
    int row = -1;
    if (j < P) {
      p = pts[base + j];
      a = g[base + j];
      d = dist[base + j];
      const int r = idx[base + j];
      row = (unsigned)r < (unsigned)P ? r : -1;
    }
    route_chunk(sum, P, row, a / d, p, lane, lower);
  }
  for (int i = lane; i < P; i += 32) {
    const float2 p = pts[base + i];
    grad[base + i] = make_float2(p.x * sum[i] - sum[P + i], p.y * sum[i] - sum[2 * P + i]);
  }
}

template <int kChunks>
const void* kernel_for() {
  return (const void*)rigid_bwd_kernel<kChunks>;
}

// The kernel for P columns: the register-resident instantiation for
// ceil(P / 32) chunks up to 7 (P <= 224), the loop kernel above.
const void* kernel_for(int P) {
  switch ((P + 31) / 32) {
    case 1: return kernel_for<1>();
    case 2: return kernel_for<2>();
    case 3: return kernel_for<3>();
    case 4: return kernel_for<4>();
    case 5: return kernel_for<5>();
    case 6: return kernel_for<6>();
    case 7: return kernel_for<7>();
    default: return (const void*)rigid_bwd_loop_kernel;
  }
}

constexpr int kMaxDevices = 64;
constexpr size_t kSmemMax = 232448;  // dynamic shared memory a block may use (227 KB)

}  // namespace

extern "C" {

// pts [B, Q, P, 2] f32 (8-byte aligned); idx [B, Q, P] int32; dist, g
// [B, Q, P] f32; grad [B, Q, P, 2] f32; BQ = B * Q. One warp per (b, q), two
// per block; cudaErrorInvalidValue where the block's running sums (24 P
// bytes) exceed the card's shared memory. Launches on `stream`; returns
// cudaGetLastError() (or the error of raising the shared-memory limit).
int cld_rigid_bwd(const float* pts, const int* idx, const float* dist, const float* g,
                  float* grad, int BQ, int P, void* stream) {
  if (BQ == 0 || P == 0) return 0;
  const size_t smem = (size_t)kWarps * 3 * P * sizeof(float);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const void* kernel = kernel_for(P);
  if (smem > 48 * 1024) {  // only the loop kernel gets here (P > 2,048)
    static size_t raised[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices || smem > raised[dev]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      if (dev < kMaxDevices) raised[dev] = smem;
    }
  }
  void* args[] = {&pts, &idx, &dist, &g, &grad, &BQ, &P};
  const cudaError_t err = cudaLaunchKernel(
      kernel, dim3((BQ + kWarps - 1) / kWarps), dim3(32 * kWarps), args, smem,
      (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The compiler's verdict on the kernel for P columns: registers and local
// memory bytes (spills) per thread, max threads per block.
int cld_rigid_bwd_attributes(int P, int* out) {
  if (P <= 0) return (int)cudaErrorInvalidValue;
  const void* kernel = kernel_for(P);
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  return 0;
}

}  // extern "C"
