// Probe of Hopper's bulk asynchronous copy (sm_90a): x bf16 (the probe's
// [T, Bp, minor]) brought into shared memory tile by tile by `cp.async.bulk` completing on
// mbarriers, doubled, written out.
//
// Replaces `scripts/micro_dma_probe.py:38`, the TPU probe of which
// ANY -> VMEM scratch copies Mosaic accepts (minor 64 or 128; the whole
// array, or a batch slice x[:, b bb : (b + 1) bb, :]). There a block was one
// strided DMA into 16 MiB of VMEM. Here the whole contiguous array is cut
// into equal flat tiles of bytes (`dma_probe.py:tile_bytes`), so the TPU
// probe's whole-array and batch-slice copies have no counterpart: its cases
// differ only in the array's shape.
//
// What bounds it: bytes (x read once, the output written once; 3.4 MB at
// [52, 128, 128], 1.02 us at the memory rate). The first design ran
// 26 CTAs of 4 whole steps' slices (64 KB each) on the 132-SM card and took
// 3.26x its bound from a CUDA graph, 2.1x `2 * x`. This design is for
// bytes:
// - tiles of 2 KB (8 rows of a step at minor 128, 16 at 64), two a CTA where
//   that leaves at least as many CTAs as SMs (`dma_probe.py:tiles_per_cta`:
//   416 CTAs at [52, 128, 128]), every bulk copy of a CTA issued at once by
//   one thread before the block barrier, each on its own mbarrier (the
//   whole array in flight across the card: 12.9 KB an SM against the ~3 MB
//   that the memory rate times the latency asks for);
// - the CTA's threads split over its tiles (128 a tile of 2 KB, one 16-byte
//   vector each): each doubles its vector as soon as its own tile's barrier
//   completes, and writes it back with a 16-byte store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxStages = 4;  // tiles (bulk copies in flight) a CTA, at most
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

// CTA c owns tiles c per, ..., c per + per - 1 of the ntiles tiles of
// `tile` bytes each (tile k at byte k tile of x and of out).
__global__ void __launch_bounds__(kThreads) bulk_double_kernel(const bf16* __restrict__ x,
                                                              bf16* __restrict__ out,
                                                              int ntiles, int tile, int per) {
  extern __shared__ __align__(128) unsigned char smem[];  // [per][tile]
  __shared__ __align__(8) uint64_t bar[kMaxStages];
  const int first = blockIdx.x * per;
  const int n = ntiles - first < per ? ntiles - first : per;
  // thread 0 sets up every barrier and issues every copy before the block
  // barrier that lets the others wait on them: the copies' latency starts
  // at once
  if (threadIdx.x == 0) {
    for (int s = 0; s < n; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(saddr(&bar[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < n; ++s) {
      const unsigned b = saddr(&bar[s]);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                   "r"(tile)
                   : "memory");
      const unsigned char* src = reinterpret_cast<const unsigned char*>(x) +
                                 (size_t)(first + s) * tile;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(saddr(smem + (size_t)s * tile)),
          "l"(src), "r"(tile), "r"(b)
          : "memory");
    }
  }
  __syncthreads();  // the barriers are initialised
  const int vecs = tile / 16;  // 16-byte vectors a tile; the CTA's n tiles are contiguous
  for (int i = threadIdx.x; i < n * vecs; i += kThreads) {
    while (!bar_try_wait(saddr(&bar[i / vecs]), 0)) {  // this vector's tile has landed
    }
    uint4 v = reinterpret_cast<const uint4*>(smem)[i];
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      h[j] = __floats2bfloat162_rn(2.0f * f.x, 2.0f * f.y);  // exact: an exponent step
    }
    reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(out) + (size_t)first * tile)[i] = v;
  }
}

}  // namespace

extern "C" {

// out = 2 x for x, out bf16, contiguous and 16-byte aligned on the current
// device: ntiles tiles of `tile` bytes (a multiple of 16), `per` tiles a CTA
// (1 to kMaxStages). Launches on `stream`; returns a cudaError_t.
int cld_dma_probe(const void* x, void* out, int ntiles, int tile, int per, void* stream) {
  if (ntiles < 0 || tile <= 0 || tile % 16 || per < 1 || per > kMaxStages)
    return (int)cudaErrorInvalidValue;
  if (ntiles == 0) return 0;
  const size_t smem = (size_t)per * tile;
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        (const void*)bulk_double_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != 0) return err;
  }
  bulk_double_kernel<<<(ntiles + per - 1) / per, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (bf16*)out, ntiles, tile, per);
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
