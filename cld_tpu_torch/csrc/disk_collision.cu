// Disk-collision penalty, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// `cld_tpu/ops/pallas_kernels.py:_disk_collision_kernel` (called by
// `disk_collision_penalty_pallas`). That kernel ran a sequential grid over
// the T steps, built one [B, B, D, D] distance tile per step in VMEM and
// added `decay[t] * mean_j` into an output block that the grid carried from
// step to step, the decay weights in SMEM. On the GPU blocks run in no order
// and carry nothing, so the loop over steps moves inside the block:
//     pair[t, i, j] = min over (di, dj) of sqrt(|c[t,i,di] - c[t,j,dj]|^2 + 1e-12)
//     pen[t, i, j]  = 1 - pair / pd[i, j]   where pair <= pd[i, j] and mask[i, j]
//     out[i]        = (1 / B) * sum over (t, j) of decay[t] * pen[t, i, j]
// sqrt(. + 1e-12) is monotone, so the min is taken over the squared distances
// and one sqrt follows.
//
// What bounds it on the H100: operations, barely. At T = 52, B = 128, D = 5
// it is 52 * 128 * 128 pairs of 25 disk distances, ~130 MFLOP (2 us at the
// f32 peak), over 0.33 MB of input.
//
// What the design does about it: one block per agent i, with its T * D disk
// centres, its row of penalty distances and the list of its unmasked partners
// staged in shared memory once. Threads stride over (t, partner), so a masked
// pair costs nothing and the work of a sparse mask spreads over the block
// (striding over every (t, j) left a same-scene mask's work to the 12 threads
// whose j was a scene-mate). The D x D distances of a pair are independent of
// each other; for D <= 8 they are fully unrolled from registers, so a thread's
// time is no longer one dependent shared-memory read per distance. The first
// version (every (t, j), runtime-D loops, 256 threads, then 512) took 0.035
// and 0.0215 ms on the H100 whatever the mask held: the chain of 26 and 13
// pair evaluations per thread. The partner list alone brought the same-scene
// mask to 0.0048 ms; the unrolling adds 9% there (0.0043 ms) and 1.56x with
// every pair unmasked (0.0220 -> 0.0141 ms), which is what the switch over D
// below is for. D > 8 takes the runtime-D loop. The sum is taken in a fixed order (each thread
// over its own strided pairs, then a tree over the block) with no atomics, so
// two launches agree bit for bit. The squares and the sum are kept as
// separate roundings (no fused multiply-add), as the plain version computes
// them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxUnrolledD = 8;

// min over (di, dj) of |ci[di] - cj[dj]|^2; D_ > 0 unrolls from registers
template <int D_>
__device__ __forceinline__ float min_d2(const float* __restrict__ ci,
                                        const float* __restrict__ cj, int D) {
  float best = 3.4e38f;
  if constexpr (D_ > 0) {
    float xi[D_], yi[D_];
#pragma unroll
    for (int d = 0; d < D_; ++d) {
      xi[d] = ci[2 * d];
      yi[d] = ci[2 * d + 1];
    }
#pragma unroll
    for (int dj = 0; dj < D_; ++dj) {
      const float xj = cj[2 * dj], yj = cj[2 * dj + 1];
#pragma unroll
      for (int di = 0; di < D_; ++di) {
        const float dx = xi[di] - xj, dy = yi[di] - yj;
        best = fminf(best, __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
      }
    }
  } else {
    for (int dj = 0; dj < D; ++dj) {
      const float xj = cj[2 * dj], yj = cj[2 * dj + 1];
      for (int di = 0; di < D; ++di) {
        const float dx = ci[2 * di] - xj, dy = ci[2 * di + 1] - yj;
        best = fminf(best, __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
      }
    }
  }
  return best;
}

template <int D_>
__global__ void disk_collision_kernel(const float* __restrict__ cent,
                                      const float* __restrict__ pen_dists,
                                      const uint8_t* __restrict__ pair_mask,
                                      const float* __restrict__ decay, float* __restrict__ out,
                                      int T, int B, int D) {
  // agent i's disk centres [T, D, 2], its penalty distances [B], its unmasked
  // partners in ascending order [B] (ints), its mask row [B] (bytes)
  extern __shared__ float smem[];
  __shared__ float partial[kThreads];
  __shared__ int n_partners;
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const int D2 = 2 * D;
  float* own = smem;
  float* pd_i = smem + T * D2;
  int* partners = reinterpret_cast<int*>(pd_i + B);
  uint8_t* mask_i = reinterpret_cast<uint8_t*>(partners + B);
  for (int k = tid; k < T * D2; k += kThreads) {
    const int t = k / D2;
    own[k] = cent[((size_t)t * B + i) * D2 + (k - t * D2)];
  }
  for (int j = tid; j < B; j += kThreads) {
    pd_i[j] = pen_dists[(size_t)i * B + j];
    mask_i[j] = pair_mask[(size_t)i * B + j] ? 1 : 0;
  }
  __syncthreads();
  // partner j goes to the slot that counts the unmasked partners before it
  for (int j = tid; j < B; j += kThreads) {
    int before = 0;
    for (int q = 0; q < j; ++q) before += mask_i[q];
    if (mask_i[j]) partners[before] = j;
    if (j == B - 1) n_partners = before + mask_i[j];
  }
  __syncthreads();

  float acc = 0.0f;
  const int np = n_partners;
  const int n = T * np;
  for (int k = tid; k < n; k += kThreads) {
    const int t = k / np;
    const int j = partners[k - t * np];
    const float best = min_d2<D_>(own + t * D2, cent + ((size_t)t * B + j) * D2, D);
    const float pair = sqrtf(best + 1e-12f);
    const float pd = pd_i[j];
    if (pair <= pd) acc += decay[t] * (1.0f - pair / pd);
  }
  partial[tid] = acc;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) partial[tid] += partial[tid + s];
    __syncthreads();
  }
  if (tid == 0) out[i] = partial[0] / (float)B;
}

template <int D_>
void launch(const float* cent, const float* pen_dists, const uint8_t* pair_mask,
            const float* decay, float* out, int T, int B, int D, size_t smem,
            cudaStream_t stream) {
  disk_collision_kernel<D_><<<(unsigned int)B, kThreads, smem, stream>>>(
      cent, pen_dists, pair_mask, decay, out, T, B, D);
}

}  // namespace

extern "C" {

// cent [T, B, D, 2] f32; pen_dists [B, B] f32; pair_mask [B, B] bytes (0 or
// not); decay [T] f32; out [B] f32. `unrolled` = 0 takes the runtime-D loop
// whatever D is (D > 8 always does). Launches on `stream`; returns
// cudaGetLastError(). (T * D * 8 + B * 9) bytes of dynamic shared memory (the
// wrapper keeps it under 48 KB).
int cld_disk_collision(const float* cent, const float* pen_dists, const uint8_t* pair_mask,
                       const float* decay, float* out, int T, int B, int D, int unrolled,
                       void* stream) {
  if (B == 0) return 0;
  const size_t smem = ((size_t)T * D * 2 + 2 * (size_t)B) * sizeof(float) + (size_t)B;
  cudaStream_t st = (cudaStream_t)stream;
  switch (unrolled && D <= kMaxUnrolledD ? D : 0) {
    case 1: launch<1>(cent, pen_dists, pair_mask, decay, out, T, B, D, smem, st); break;
    case 2: launch<2>(cent, pen_dists, pair_mask, decay, out, T, B, D, smem, st); break;
    case 3: launch<3>(cent, pen_dists, pair_mask, decay, out, T, B, D, smem, st); break;
    case 4: launch<4>(cent, pen_dists, pair_mask, decay, out, T, B, D, smem, st); break;
    case 5: launch<5>(cent, pen_dists, pair_mask, decay, out, T, B, D, smem, st); break;
    case 6: launch<6>(cent, pen_dists, pair_mask, decay, out, T, B, D, smem, st); break;
    case 7: launch<7>(cent, pen_dists, pair_mask, decay, out, T, B, D, smem, st); break;
    case 8: launch<8>(cent, pen_dists, pair_mask, decay, out, T, B, D, smem, st); break;
    default: launch<0>(cent, pen_dists, pair_mask, decay, out, T, B, D, smem, st); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
