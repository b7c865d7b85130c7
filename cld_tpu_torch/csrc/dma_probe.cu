// Probe of Hopper's bulk asynchronous copy (sm_90a): a [T, bb, minor] bf16
// block of x [T, Bp, minor] brought into shared memory by
// `cp.async.bulk` completing on an mbarrier, doubled, written out.
//
// Replaces `scripts/micro_dma_probe.py:38`, the TPU probe of which
// ANY -> VMEM scratch copies Mosaic accepts (minor 64 or 128; the whole
// array, or a batch slice x[:, b bb : (b + 1) bb, :]). There a block was one
// strided DMA into 16 MiB of VMEM; here a CTA's shared memory holds 227 KB,
// so CTA (t-block, b) copies kSteps time steps of its batch slice, one bulk
// copy per step (a step's bb x minor slice is contiguous in x: bb minor 2
// bytes, 16-byte aligned), and the mbarrier counts the bytes of all of
// them. What bounds it: bytes (x read once, the output written once).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kSteps = 4;      // time steps a CTA brings in
constexpr int kThreads = 256;
constexpr size_t kSmemMax = 232448;

__device__ __forceinline__ unsigned saddr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool bar_try_wait(unsigned bar, unsigned phase) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(phase)
      : "memory");
  return done != 0;
}

__global__ void __launch_bounds__(kThreads) bulk_double_kernel(const bf16* __restrict__ x,
                                                              bf16* __restrict__ out, int T,
                                                              int Bp, int bb, int minor) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  const int t0 = blockIdx.x * kSteps, b = blockIdx.y;
  const int steps = T - t0 < kSteps ? T - t0 : kSteps;
  const unsigned row = (unsigned)(bb * minor * sizeof(bf16));  // one step's slice, bytes
  const unsigned bar_a = saddr(&bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_a) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar_a),
                 "r"(row * steps)
                 : "memory");
    for (int s = 0; s < steps; ++s) {
      const bf16* src = x + ((size_t)(t0 + s) * Bp + (size_t)b * bb) * minor;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(saddr(smem + (size_t)s * row)),
          "l"(src), "r"(row), "r"(bar_a)
          : "memory");
    }
  }
  while (!bar_try_wait(bar_a, 0)) {
  }
  const int per = bb * minor / 8;  // 16-byte vectors of one step's slice
  for (int i = threadIdx.x; i < steps * per; i += kThreads) {
    const int s = i / per, e = i % per;
    uint4 v = reinterpret_cast<const uint4*>(smem)[i];
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      h[j] = __floats2bfloat162_rn(2.0f * f.x, 2.0f * f.y);  // exact: an exponent step
    }
    reinterpret_cast<uint4*>(out + ((size_t)(t0 + s) * Bp + (size_t)b * bb) * minor)[e] = v;
  }
}

}  // namespace

extern "C" {

// out = 2 x for x, out [T, Bp, minor] bf16, contiguous and 16-byte aligned
// on the current device; CTA (t-block, b) copies x[t-block, b bb : (b+1) bb]
// (bb | Bp; Bp == bb copies the whole array). minor a multiple of 8.
// Launches on `stream`; returns a cudaError_t.
int cld_dma_probe(const void* x, void* out, int T, int Bp, int bb, int minor, void* stream) {
  if (bb <= 0 || Bp % bb || minor <= 0 || minor % 8) return (int)cudaErrorInvalidValue;
  if (T == 0 || Bp == 0) return 0;
  const size_t smem = (size_t)kSteps * bb * minor * sizeof(bf16);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute((const void*)bulk_double_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != 0) return err;
  const dim3 grid((T + kSteps - 1) / kSteps, Bp / bb);
  bulk_double_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (bf16*)out, T, Bp, bb, minor);
  return (int)cudaGetLastError();
}

// out = {registers per thread, local memory bytes per thread, max threads
// per block, static shared memory bytes}.
int cld_dma_probe_attributes(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, (const void*)bulk_double_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  out[3] = (int)a.sharedSizeBytes;
  return 0;
}

}  // extern "C"
