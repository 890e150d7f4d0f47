// Fused ViT input stage on Hopper: port of the TPU kernel
// efficientvlm_tpu/ops/pallas_patch_embed.py:_patch_embed_padded (body
// _kernel): Y = patches[B*Np, P*P*3] @ W[K, D] + bias + pos[1:1+Np], then the
// pre-LayerNorm in f32 (eps 1e-5), written as bf16 behind each image's CLS
// row (which the caller fills).
//
// What bounds it on the H100: at the main path's shape (B*Np = 18432 rows,
// K = D = 768) the matmul is 21.7 GFLOP over ~57 MB of unavoidable traffic,
// ~22 us at the tensor-core peak and ~17 us at the memory rate, so the two
// are close. Design: the matmul runs in gemm_bias with the bias and
// positional rows added in its f32 epilogue (no separate add pass), then one
// warp per row normalizes in f32. The TPU kernel keeps Y in VMEM between the
// two; here Y makes one f32 round trip through device memory (2 x 57 MB),
// which normalizing in the GEMM epilogue with a full 768-wide row tile
// would remove.
#include "gemm_bias.cuh"
#include "residual_layernorm.cuh"

// patches [batch*n_patches, k] bf16 (im2col'd, (ph, pw, c) order), w [k, d]
// bf16, bias [d] f32 or null, pos [n_patches, d] f32, gamma/beta [d] f32,
// ws [batch*n_patches, d] f32 workspace, out [batch, 1+n_patches, d] bf16.
extern "C" int evlm_patch_embed(const void* patches, const void* w, const float* bias,
                                const float* pos, const float* gamma, const float* beta,
                                float* ws, void* out, int batch, int n_patches, int k, int d,
                                float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = batch * n_patches;
  cudaError_t e = evlm::gemm_bias(patches, w, bias, pos, n_patches, ws, true, rows, d, k, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(evlm::residual_layernorm(ws, nullptr, gamma, beta, out, rows, d, eps,
                                                   n_patches, n_patches + 1, 1, s));
}
