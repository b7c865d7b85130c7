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
// The design (the first one took 4.34 us at the same-scene mask and 14.09
// us with every pair unmasked from a CUDA graph on the H100):
// - one block of 1,024 threads per agent;
// - warp 0 compacts the partner list with one `__ballot_sync` and `__popc`
//   per 32 mask columns, the mask bytes of up to 128 columns loaded at once
//   (the first design counted the partners before each column one shared
//   byte at a time, up to B - 1 loads on the critical path), while the other
//   warps stage the agent's own disk centres; one barrier covers both;
// - threads stride over the (step, partner) items of the agent, two items in
//   flight per thread, the (step, partner) pair advanced by additions; a
//   partner's disks are read as (x, y) pairs; the D x D distances are
//   unrolled from registers for D <= 8 as D independent min chains (D > 8,
//   or `unrolled` = 0, takes a runtime-D loop);
// - the squares and the sum stay separate roundings (no fused multiply-add),
//   as the plain version computes them;
// - the sum is reduced by warp shuffles and one barrier, in a fixed order,
//   so two launches agree bit for bit.
//
// What bounds it on the H100. Same-scene mask (T = 52, B = 128, D = 5,
// scenes of 4, 156 items an agent): latency, about 2.2 us above the launch
// floor: the mask row's round trip, the barrier, the partners' disks' round
// trip, an IEEE sqrt and divide, and the reduction; not spills (42
// registers at D = 5 and none spilled; of the nine instantiations only D = 4
// spills, 8 bytes, per `disk_collision_attributes`). Every pair unmasked
// (6,604 items an agent): each block reads every partner's disks at every
// step, 266 KB an agent, 34 MB from L2 in all, which this design neither
// reuses across agents nor halves by symmetry (it computes each symmetric
// pair twice, once for i, once for j); its instruction issue alone would
// be ~3.9 us (6 instructions a disk distance, 845,312 pairs of 25, on 128 of
// the 132 SMs), against the function's operation bound of ~1.0 us (each
// symmetric pair's 25 distances once, the penalty in both directions).
// Tried on intermediate versions of this file and dropped: blocks of 512
// threads (slower at both masks), a
// cluster of 2 or 4 blocks per agent splitting the steps, summed through
// distributed shared memory (slower at both masks: the cluster launch and
// barriers), and staging every agent's disks in shared memory step-chunk by
// step-chunk (2x slower with every pair: the same 34 MB through shared
// memory, and two barriers a chunk).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;  // one block per agent
static_assert(kThreads == 32 * 32, "the final reduction takes one warp's partial per lane");
constexpr int kMaxUnrolledD = 8;
constexpr int kMaskBatch = 4;  // 32-column mask chunks whose loads warp 0 keeps in flight

// min over (di, dj) of |ci[di] - cj[dj]|^2, cj read as (x, y) pairs; D_ > 0
// unrolls from registers as D_ independent chains, one per partner disk,
// then a tree
template <int D_>
__device__ __forceinline__ float min_d2(const float* __restrict__ ci,
                                        const float2* __restrict__ cj, int D) {
  if constexpr (D_ > 0) {
    float xi[D_], yi[D_], m[D_];
    float2 c[D_];
#pragma unroll
    for (int d = 0; d < D_; ++d) c[d] = cj[d];
#pragma unroll
    for (int d = 0; d < D_; ++d) {
      xi[d] = ci[2 * d];
      yi[d] = ci[2 * d + 1];
    }
#pragma unroll
    for (int dj = 0; dj < D_; ++dj) {
      float best = 3.4e38f;
#pragma unroll
      for (int di = 0; di < D_; ++di) {
        const float dx = xi[di] - c[dj].x, dy = yi[di] - c[dj].y;
        best = fminf(best, __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
      }
      m[dj] = best;
    }
#pragma unroll
    for (int s = 1; s < D_; s *= 2) {
#pragma unroll
      for (int d = 0; d + s < D_; d += 2 * s) m[d] = fminf(m[d], m[d + s]);
    }
    return m[0];
  } else {
    float best = 3.4e38f;
    for (int dj = 0; dj < D; ++dj) {
      const float2 c = cj[dj];
      for (int di = 0; di < D; ++di) {
        const float dx = ci[2 * di] - c.x, dy = ci[2 * di + 1] - c.y;
        best = fminf(best, __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
      }
    }
    return best;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  return v;  // lane 0 holds the sum
}

// one (step, partner) item: decay[t] * (1 - pair / pd) where pair <= pd
template <int D_>
__device__ __forceinline__ float item(const float* own_t, const float2* cj,
                                      const float* __restrict__ pd_row,
                                      const float* __restrict__ decay, int t, int j, int D) {
  const float best = min_d2<D_>(own_t, cj, D);
  const float pair = sqrtf(best + 1e-12f);
  const float pd = __ldg(pd_row + j);
  return pair <= pd ? __ldg(decay + t) * (1.0f - pair / pd) : 0.0f;
}

// sum over items k = tid, tid + kThreads, ... < nt * np of item (step t =
// k / np, partner p = k % np), partner disks read from c2 [T, B, D] pairs;
// two items in flight, (step, partner) advanced by additions
template <int D_>
__device__ __forceinline__ float sweep(const float* own, const int* partners,
                                       const float* __restrict__ pd_row,
                                       const float* __restrict__ decay,
                                       const float2* __restrict__ c2, int nt, int np, int B,
                                       int D) {
  const int tid = threadIdx.x, D2 = 2 * D;
  const int n = nt * np;
  float acc = 0.0f;
  if (tid >= n) return acc;
  const int q1 = kThreads / np, r1 = kThreads - q1 * np;
  int ta = tid / np, pa = tid - ta * np;  // item a: relative step and partner
  for (int k = tid; k < n; k += 2 * kThreads) {
    int tb = ta + q1, pb = pa + r1;  // item b = k + kThreads
    if (pb >= np) { pb -= np; ++tb; }
    const int ja = partners[pa];
    const float va = item<D_>(own + ta * D2, c2 + ((size_t)ta * B + ja) * D, pd_row, decay, ta,
                              ja, D);
    float vb = 0.0f;
    if (k + kThreads < n) {
      const int jb = partners[pb];
      vb = item<D_>(own + tb * D2, c2 + ((size_t)tb * B + jb) * D, pd_row, decay, tb, jb, D);
    }
    acc += va;
    acc += vb;
    ta = tb + q1;  // item a of the next round = b + kThreads
    pa = pb + r1;
    if (pa >= np) { pa -= np; ++ta; }
  }
  return acc;
}

// one block per agent i. Dynamic shared memory: own disk centres [T, D, 2],
// then the partner list [B] (ints)
template <int D_>
__global__ void __launch_bounds__(kThreads)
    disk_collision_kernel(const float* __restrict__ cent, const float* __restrict__ pen_dists,
                          const uint8_t* __restrict__ pair_mask,
                          const float* __restrict__ decay, float* __restrict__ out, int T,
                          int B, int D) {
  extern __shared__ float smem[];
  __shared__ float partial[kThreads / 32];
  __shared__ int n_partners;
  const int i = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D2 = 2 * D;
  float* own = smem;
  int* partners = reinterpret_cast<int*>(own + T * D2);

  if (warp == 0) {
    // partners in ascending order: one ballot per 32 columns, kMaskBatch
    // chunks' loads in flight at a time
    const uint8_t* row = pair_mask + (size_t)i * B;
    int base = 0;
    for (int c0 = 0; c0 < B; c0 += 32 * kMaskBatch) {
      uint8_t v[kMaskBatch];
#pragma unroll
      for (int u = 0; u < kMaskBatch; ++u) {
        const int j = c0 + 32 * u + lane;
        v[u] = j < B ? __ldg(row + j) : 0;
      }
#pragma unroll
      for (int u = 0; u < kMaskBatch; ++u) {
        const unsigned bits = __ballot_sync(0xffffffffu, v[u] != 0);
        if (v[u]) partners[base + __popc(bits & ((1u << lane) - 1u))] = c0 + 32 * u + lane;
        base += __popc(bits);
      }
    }
    if (lane == 0) n_partners = base;
  }
  // the other warps stage the agent's own disks
  if (warp > 0) {
    for (int k = tid - 32; k < T * D2; k += kThreads - 32) {
      const int t = k / D2;
      own[k] = cent[((size_t)t * B + i) * D2 + (k - t * D2)];
    }
  }
  __syncthreads();

  const int np = n_partners;
  const float* pd_row = pen_dists + (size_t)i * B;
  float acc = sweep<D_>(own, partners, pd_row, decay, reinterpret_cast<const float2*>(cent), T,
                        np, B, D);
  acc = warp_sum(acc);
  if (lane == 0) partial[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    float v = partial[lane];  // kThreads / 32 = 32 warps
    v = warp_sum(v);
    if (lane == 0) out[i] = v / (float)B;
  }
}

}  // namespace

extern "C" {

// cent [T, B, D, 2] f32; pen_dists [B, B] f32; pair_mask [B, B] bytes (0 or
// not); decay [T] f32; out [B] f32. One block of 1,024 threads per agent,
// with T * D * 8 + B * 4 bytes of dynamic shared memory (the wrapper keeps
// it under 48 KB). `unrolled` = 0 takes the runtime-D loop whatever D is
// (D > 8 always does). Launches on `stream`; returns cudaGetLastError().
int cld_disk_collision(const float* cent, const float* pen_dists, const uint8_t* pair_mask,
                       const float* decay, float* out, int T, int B, int D, int unrolled,
                       void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned int grid = (unsigned int)B;
  const size_t sm = ((size_t)T * D * 2 + (size_t)B) * 4;
#define CLD_DISK_CASE(d)                                                                     \
  case d:                                                                                    \
    disk_collision_kernel<d><<<grid, kThreads, sm, st>>>(cent, pen_dists, pair_mask, decay,  \
                                                         out, T, B, D);                      \
    break;
  switch (unrolled && D <= kMaxUnrolledD ? D : 0) {
    CLD_DISK_CASE(1)
    CLD_DISK_CASE(2)
    CLD_DISK_CASE(3)
    CLD_DISK_CASE(4)
    CLD_DISK_CASE(5)
    CLD_DISK_CASE(6)
    CLD_DISK_CASE(7)
    CLD_DISK_CASE(8)
    CLD_DISK_CASE(0)
  }
#undef CLD_DISK_CASE
  return (int)cudaGetLastError();
}

// The compiler's verdict on the instantiation for D disks (1..8; 0, or any
// other D, the runtime-D loop): registers and local memory bytes (spills)
// per thread, max threads per block.
int cld_disk_collision_attributes(int D, int* out) {
  const void* fn;
  switch (D >= 1 && D <= kMaxUnrolledD ? D : 0) {
    case 1: fn = (const void*)disk_collision_kernel<1>; break;
    case 2: fn = (const void*)disk_collision_kernel<2>; break;
    case 3: fn = (const void*)disk_collision_kernel<3>; break;
    case 4: fn = (const void*)disk_collision_kernel<4>; break;
    case 5: fn = (const void*)disk_collision_kernel<5>; break;
    case 6: fn = (const void*)disk_collision_kernel<6>; break;
    case 7: fn = (const void*)disk_collision_kernel<7>; break;
    case 8: fn = (const void*)disk_collision_kernel<8>; break;
    default: fn = (const void*)disk_collision_kernel<0>; break;
  }
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  return 0;
}

}  // extern "C"
