// residual_layernorm: out = LN(x + residual) * gamma + beta, statistics in f32,
// written as bf16. x is f32 (a gemm_bias output), residual bf16 or null.
//
// Serves the LayerNorm epilogues of two TPU kernels:
// efficientvlm_tpu/ops/pallas_patch_embed.py (_kernel: pre-LN of the patch
// rows, eps 1e-5) and ops/pallas_fused_mha.py (_fused_cross_grouped_kernel
// with ln_params: the BERT layer's residual add + post-LN, eps 1e-12).
//
// What bounds it on the H100: bytes (about 10 bytes per element moved for 8
// FLOP). Design: one warp per row, so the row's reductions are warp shuffles
// with no shared memory or block barrier; mean and variance are two passes
// over the row (the JAX kernels' formula), which the second and third
// passes read from L1/L2. The output row mapping
// out_row = (row / group) * out_group_stride + out_offset + row % group
// lets the patch embedding write straight behind each image's CLS row.
#pragma once

#include "common.cuh"

namespace evlm {
namespace ln_impl {
namespace {  // internal linkage: each .cu includes its own copy

constexpr int ROWS_PER_BLOCK = 8;

__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
residual_layernorm_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ res,
                          const float* __restrict__ gamma, const float* __restrict__ beta,
                          __nv_bfloat16* __restrict__ out, int rows, int d, float eps,
                          int group, int out_group_stride, int out_offset) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* xr = x + (size_t)row * d;
  const __nv_bfloat16* rr = res ? res + (size_t)row * d : nullptr;

  float sum = 0.0f;
  for (int c = lane; c < d; c += 32) sum += xr[c] + (rr ? __bfloat162float(rr[c]) : 0.0f);
  const float mean = evlm::warp_sum(sum) / d;
  float sq = 0.0f;
  for (int c = lane; c < d; c += 32) {
    float y = xr[c] + (rr ? __bfloat162float(rr[c]) : 0.0f) - mean;
    sq += y * y;
  }
  const float inv = rsqrtf(evlm::warp_sum(sq) / d + eps);
  const size_t orow = (size_t)(row / group) * out_group_stride + out_offset + row % group;
  __nv_bfloat16* o = out + orow * d;
  for (int c = lane; c < d; c += 32) {
    float y = xr[c] + (rr ? __bfloat162float(rr[c]) : 0.0f) - mean;
    o[c] = __float2bfloat16(y * inv * gamma[c] + beta[c]);
  }
}

}  // namespace
}  // namespace ln_impl
}  // namespace evlm

namespace evlm {

// x [rows, d] f32, residual [rows, d] bf16 or null, gamma/beta [d] f32,
// out bf16 with rows placed by the mapping above.
static inline cudaError_t residual_layernorm(const float* x, const void* residual, const float* gamma,
                                      const float* beta, void* out, int rows, int d, float eps,
                                      int group, int out_group_stride, int out_offset,
                                      cudaStream_t stream) {
  using namespace ln_impl;
  dim3 grid((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  residual_layernorm_kernel<<<grid, ROWS_PER_BLOCK * 32, 0, stream>>>(
      x, static_cast<const __nv_bfloat16*>(residual), gamma, beta,
      static_cast<__nv_bfloat16*>(out), rows, d, eps, group, out_group_stride, out_offset);
  return cudaGetLastError();
}

}  // namespace evlm
