// Fused ViT input stage on Hopper: port of the TPU kernel
// efficientvlm_tpu/ops/pallas_patch_embed.py:_patch_embed_padded (body
// _kernel): Y = patches[B*Np, P*P*3] @ W[K, D] + bias + pos[1:1+Np], then the
// pre-LayerNorm in f32 (eps 1e-5), written as bf16 behind each image's CLS
// row LN(cls + pos[0]).
//
// What bounds it on the H100: at the main path's shape (B*Np = 18,432 rows,
// K = D = 768) the matmul is 21.7 GFLOP, ~22 us at the tensor-core peak,
// over ~57 MB of unavoidable traffic (~17 us at the memory rate): the two
// are close, so every extra pass over the activations shows. Design: one
// launch of gemm_ln in its gather form (gemm_ln.cuh): the producer gathers
// the patch rows from the NHWC image itself (no im2col copy), the epilogue
// adds bias and positional rows and normalises each row across a cluster of
// D / 128 blocks (no f32 round trip), and the same launch writes every
// image's CLS row. The small parameters are read as stored (bf16 or f32).
//
// D outside gemm_ln's rule (not a multiple of 128, or above 1024) keeps the
// earlier two launches over patches im2col'd by the caller:
// evlm_patch_embed_im2col.
#include "gemm_bias.cuh"
#include "gemm_ln.cuh"
#include "residual_layernorm.cuh"

// image [batch, height, width, 3] bf16 (NHWC), w [patch*patch*3, d] bf16;
// bias [d] (or null), pos [1 + Np, d], cls [d], gamma/beta [d] bf16 (vec16)
// or f32; out [batch, 1 + Np, d] bf16. The patches tile the image's
// top-left floor(H/P)*P x floor(W/P)*P (Np = floor(H/P) * floor(W/P)), as
// a VALID convolution does. patch*3 % 8 == 0, width*3 % 8 == 0, d a
// multiple of 128 up to 1024.
extern "C" int evlm_patch_embed(const void* image, const void* w, const void* bias,
                                const void* pos, const void* cls, const void* gamma,
                                const void* beta, void* out, int batch, int height, int width,
                                int patch, int d, int vec16, float eps, void* stream) {
  return static_cast<int>(evlm::patch_embed_ln(image, w, bias, pos, cls, gamma, beta, vec16 != 0,
                                               out, batch, height, width, patch, d, eps,
                                               static_cast<cudaStream_t>(stream)));
}

// patches [batch*n_patches, k] bf16 (im2col'd, (ph, pw, c) order), w [k, d]
// bf16, bias [d] (or null), pos [n_patches, d], gamma/beta [d] bf16 (vec16)
// or f32; ws [batch*n_patches, d] f32 workspace, out [batch,
// 1+n_patches, d] bf16 with row 0 of each image left for the caller's CLS
// row.
extern "C" int evlm_patch_embed_im2col(const void* patches, const void* w, const void* bias,
                                       const void* pos, const void* gamma, const void* beta,
                                       float* ws, void* out, int batch, int n_patches, int k,
                                       int d, int vec16, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = batch * n_patches;
  cudaError_t e =
      evlm::gemm_bias(patches, w, bias, pos, n_patches, vec16 != 0, ws, true, rows, d, k, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(evlm::residual_layernorm(ws, nullptr, gamma, beta, vec16 != 0, out,
                                                   rows, d, eps, n_patches, n_patches + 1, 1, s));
}
