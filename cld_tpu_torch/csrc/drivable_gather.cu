// Unpacked drivable-map value gather, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// `cld_tpu/ops/pallas_kernels.py:_drivable_gather_kernel` (called by
// `drivable_gather_pallas`). That kernel fetched map values with a row
// one-hot matrix product over transposed maps, 8 agents per program and the
// query list padded to 512/2048, because the TPU has no fast per-lane gather;
// on the GPU each thread reads its map values directly:
//     out[b, q] = (float)map[b, row, col]
// with (col, row) = pix[b, q], clamped to the map. int8 and float32 maps are
// both taken; the float32 value is returned as it is (the TPU kernel rounds
// float maps through bf16).
//
// What bounds it on the H100: bytes, and at this size the launch. At the
// guided path's shapes (B = 32, Q = 5200 query points, a 224 x 224 int8 map
// per agent) it reads 1.3 MB of int32 coordinates and writes 0.7 MB of f32.
// Of the 1.6 MB of maps it needs only the bytes under its queries: at most
// 5200 per map, 0.17 MB in all. The bound is 0.64 us, under the ~1-2 us that
// one kernel node of a CUDA graph costs. The float32 entry point has no
// caller in the package yet: the map loss passes int8 maps.
//
// The first design (one query per thread; 2.7 us from a CUDA graph on an
// H100 at 700 W, torch.take 3.3 us) divided a 64-bit index by Q in every
// thread and kept one gather in flight per thread: an 8-byte pix load, a
// dependent byte load, a 4-byte store.
//
// What this design does about it:
// - A thread takes kGroup = 4 consecutive queries of one agent. Their pix
//   pairs arrive as two 16-byte loads marked evict-first (each is read once),
//   the 4 map loads issue back to back through the read-only path before any
//   is used, and the 4 floats leave as one 16-byte store.
// - The grid is (blocks per agent, B): the agent is blockIdx.y and no thread
//   divides. Blocks of 128 threads: B = 32, Q = 5200 is 352 blocks, 2-3 on
//   each of the 132 SMs.
// - The vector path needs Q % 4 == 0 and 16-byte aligned pix and out (then
//   every group starts 16-byte aligned). The wrapper chooses the path
//   (`ops/gather_kernels.py:drivable_gather_vector`); otherwise the same
//   schedule runs with 8-byte pix loads, scalar stores and a ragged last
//   group.
// Measured (`kernel_ab.py`, CUDA graphs on an H100 at 700 W, the first design
// in the same call): 2.38 us on random queries (2.63; one torch.take 3.33)
// and 1.67 us on the "px" replan's own queries (1.78; torch.take 2.77), where
// an empty kernel reads 0.8-1.0 us. What still bounds it above that floor:
// random queries miss L1 and fetch a 32-byte sector from L2 per map byte;
// the replan's queries (a step's bbox points fall on a few pixels) hit L1,
// which leaves the chain of a pix load, a map load and a store.
// Measured no faster in probe runs on the card (their scripts are not kept):
// 32 or 64 threads a block; 2 or 8 queries a thread (each slower on one of
// the two query sets); 256 threads a block and pix through the read-only
// path (the same within the runs' spread).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 4;      // consecutive queries per thread
constexpr int kThreads = 128;  // per block

__device__ __forceinline__ int clampi(int v, int hi) { return min(max(v, 0), hi); }

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
drivable_gather_kernel(const int* __restrict__ pix, const T* __restrict__ map,
                       float* __restrict__ out, int Q, int Hm, int W) {
  const int b = blockIdx.y;
  const int q0 = (blockIdx.x * kThreads + threadIdx.x) * kGroup;
  if (q0 >= Q) return;
  const int* pb = pix + (size_t)b * Q * 2;
  const T* mb = map + (size_t)b * Hm * W;
  float* dst = out + (size_t)b * Q + q0;

  int px[kGroup], py[kGroup];
  if constexpr (kVec) {
    const int4* src = reinterpret_cast<const int4*>(pb + 2 * q0);
    const int4 a = __ldcs(src), c = __ldcs(src + 1);
    px[0] = a.x; py[0] = a.y; px[1] = a.z; py[1] = a.w;
    px[2] = c.x; py[2] = c.y; px[3] = c.z; py[3] = c.w;
  } else {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      // a ragged last group repeats its last query; only real ones are stored
      const int2 p = __ldcs(reinterpret_cast<const int2*>(pb) + min(q0 + k, Q - 1));
      px[k] = p.x;
      py[k] = p.y;
    }
  }
  T v[kGroup];
#pragma unroll
  for (int k = 0; k < kGroup; ++k)
    v[k] = __ldg(mb + clampi(py[k], Hm - 1) * W + clampi(px[k], W - 1));

  if constexpr (kVec) {
    *reinterpret_cast<float4*>(dst) =
        make_float4((float)v[0], (float)v[1], (float)v[2], (float)v[3]);
  } else {
    const int n = min(kGroup, Q - q0);
#pragma unroll
    for (int k = 0; k < kGroup; ++k)
      if (k < n) dst[k] = (float)v[k];
  }
}

template <typename T>
const void* kernel_for(bool vec) {
  return vec ? (const void*)drivable_gather_kernel<T, true>
             : (const void*)drivable_gather_kernel<T, false>;
}

template <typename T>
int launch(const int* pix, const T* map, float* out, int B, int Q, int Hm, int W, int vec,
           void* stream) {
  if (B == 0 || Q == 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  // the vector path reads and writes 16 bytes at a time: refuse it where
  // a group would not start 16-byte aligned
  if (vec && (Q % kGroup != 0 || (uintptr_t)pix % 16 != 0 || (uintptr_t)out % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const int per_agent = (Q + kGroup * kThreads - 1) / (kGroup * kThreads);
  void* args[] = {&pix, &map, &out, &Q, &Hm, &W};
  const cudaError_t err = cudaLaunchKernel(kernel_for<T>(vec != 0), dim3(per_agent, B),
                                           dim3(kThreads), args, 0, (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// pix [B, Q, 2] int32 (col, row), 8-byte aligned; map [B, Hm, W] int8 or
// f32; out [B, Q] f32; vec != 0 takes the 16-byte path (Q % 4 == 0, pix and
// out 16-byte aligned, else cudaErrorInvalidValue). Launches on `stream`;
// returns cudaGetLastError().
int cld_drivable_gather_i8(const int* pix, const int8_t* map, float* out, int B, int Q, int Hm,
                           int W, int vec, void* stream) {
  return launch<int8_t>(pix, map, out, B, Q, Hm, W, vec, stream);
}

int cld_drivable_gather_f32(const int* pix, const float* map, float* out, int B, int Q, int Hm,
                            int W, int vec, void* stream) {
  return launch<float>(pix, map, out, B, Q, Hm, W, vec, stream);
}

// The compiler's verdict on the instantiation for an f32 (f32 != 0) or int8
// map on the vector path (vec != 0) or the scalar one: registers and local
// memory bytes (spills) per thread, max threads per block.
int cld_drivable_gather_attributes(int f32, int vec, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, f32 ? kernel_for<float>(vec != 0) : kernel_for<int8_t>(vec != 0));
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  return 0;
}

}  // extern "C"
