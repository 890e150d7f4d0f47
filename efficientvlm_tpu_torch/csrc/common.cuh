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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace evlm
