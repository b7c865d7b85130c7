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
// 18.6 MB (pts and grad 5.3 MB each, idx, dist and g 2.7 MB each), 5.6 us at
// the memory rate, against B*Q*P*P = 67 M compares.
//
// What the design does about it: one block per (b, q) stages a_j, a_j p_j and
// idx_j in shared memory; thread i then walks j in ascending order and sums
// the columns whose argmin is row i. A gather, not a scatter with atomics:
// the order of every sum is fixed, so the gradient is the same bit for bit on
// every launch. All threads read the same shared address at each j (a
// broadcast), so the walk is conflict-free.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_P = 256;  // shared arrays' size; the wrapper keeps P below it

__global__ void rigid_bwd_kernel(const float2* __restrict__ pts, const int* __restrict__ idx,
                                 const float* __restrict__ dist, const float* __restrict__ g,
                                 float2* __restrict__ grad, int P) {
  __shared__ float sa[MAX_P];
  __shared__ float sax[MAX_P];
  __shared__ float say[MAX_P];
  __shared__ int sidx[MAX_P];
  const size_t base = (size_t)blockIdx.x * P;
  const int i = threadIdx.x;
  float2 p = make_float2(0.f, 0.f);
  if (i < P) {
    p = pts[base + i];
    const float a = g[base + i] / dist[base + i];
    sa[i] = a;
    sax[i] = a * p.x;
    say[i] = a * p.y;
    sidx[i] = idx[base + i];
  }
  __syncthreads();
  if (i >= P) return;
  float s_a = 0.f, s_ax = 0.f, s_ay = 0.f;
  for (int j = 0; j < P; ++j) {
    if (sidx[j] == i) {
      s_a += sa[j];
      s_ax += sax[j];
      s_ay += say[j];
    }
  }
  grad[base + i] = make_float2(p.x * s_a - s_ax, p.y * s_a - s_ay);
}

}  // namespace

extern "C" {

// pts [B, Q, P, 2] f32 (8-byte aligned); idx [B, Q, P] int32; dist, g
// [B, Q, P] f32; grad [B, Q, P, 2] f32; BQ = B * Q. Launches on `stream`;
// returns cudaGetLastError().
int cld_rigid_bwd(const float* pts, const int* idx, const float* dist, const float* g,
                  float* grad, int BQ, int P, void* stream) {
  if (BQ == 0 || P == 0) return 0;
  if (P > MAX_P) return (int)cudaErrorInvalidValue;
  const int threads = ((P + 31) / 32) * 32;
  rigid_bwd_kernel<<<(unsigned)BQ, threads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float2*>(pts), idx, dist, g, reinterpret_cast<float2*>(grad), P);
  return (int)cudaGetLastError();
}

}  // extern "C"
