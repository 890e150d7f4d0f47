// Shared helpers for the port's hand-written Hopper kernels (sm_90a).
//
// Every entry point has a plain C interface (loaded with ctypes by
// kernels/build.py), launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() so that a refused launch is reported.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace evlm {

// 16-byte asynchronous global->shared copy; src_bytes = 0 zero-fills the
// destination (used for the ragged edge of a tile).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(saddr), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// The launch set-up of one kernel, done once per device and not on every
// launch: its dynamic shared memory limit raised to `smem_bytes`, the most
// any launch of it asks for (so that no order of shapes can fail), an
// optional shared memory carveout in percent (-1: left to the runtime), and
// the device's SM count. The caller keeps one cache per kernel instance.
struct DeviceCache {
  int sms[16] = {};
};

inline cudaError_t once_per_device(DeviceCache& cache, const void* kernel, int smem_bytes,
                                   int* sms, int carveout = -1) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 16) return cudaErrorInvalidDevice;
  if (cache.sms[dev] == 0) {
    int n = 0;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e == cudaSuccess && carveout >= 0)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    cache.sms[dev] = n;
  }
  *sms = cache.sms[dev];
  return cudaSuccess;
}

// Small parameter vectors (biases, LayerNorm scale and shift, positional
// rows, head gates) are read as stored, bf16 or f32, so that no wrapper
// converts them per call. `bf16` selects the type; i is an element index.
__device__ __forceinline__ float load1(const void* p, bool bf16, size_t i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// elements i and i + 1 (i even; the base is 8-byte aligned for f32)
__device__ __forceinline__ float2 load2(const void* p, bool bf16, size_t i) {
  if (bf16)
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(static_cast<const __nv_bfloat16*>(p) + i));
  return *reinterpret_cast<const float2*>(static_cast<const float*>(p) + i);
}

// 2^x (the SFU's approximation, denormals flushed)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// --- mma.sync building blocks of the two attention kernels ---------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// d[16x8] += a[16x16] . b[16x8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

}  // namespace evlm
