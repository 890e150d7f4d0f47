// The FFN sublayer of a post-LN BERT layer at inference, as two launches:
//   out = LN(x + act(x . W1 + b1) . W2 + b2) * gamma + beta.
//
// Replaces no TPU kernel: the JAX package leaves the FFN to XLA, which
// fuses the activation, the residual and the LayerNorm around its GEMMs. The
// port ran it as torch ops: the f32 kernels cast to bf16 at every call, two
// cuBLAS GEMMs, GELU, the residual add and LayerNorm's f32 round trip, each
// a pass over device memory. At the pruned export's widths (an intermediate
// width I that is no multiple of 8: 2,244 and 2,332 in the retrieval
// evaluation) a row of I bf16 values is not 16 bytes long, so cuBLAS has no
// TMA / wgmma kernel for either GEMM and runs an sm80 one at about a third
// of the card's peak.
//
// What bounds it on the H100: tensor-core operations. At the rerank's
// M = 40,960 rows, D = 768 and I ~ 2,300 the two GEMMs do 4 M D I = 290
// GFLOP against ~2 M (2 D + I) bytes of activations (0.3 GB): ~1,000
// FLOP a byte, above the card's ~295 ridge. Design:
//   - the caller (ops/fused_ffn.py) pads I to a multiple of 64 once per
//     weight tensor: zero columns of W1 and b1, zero rows of W2. A padded
//     unit computes act(0) = 0 against a zero row, so the function does not
//     change; TMA can read both GEMMs' operands (it needs rows of 16-byte
//     pieces), and every row is whole 128-byte lines, which the swizzled
//     boxes read fastest (0.751 against 0.873 ms at 2,244 padded to 2,304
//     and to 2,248, PERF.md);
//   - GEMM 1 is gemm_bias with the activation in its epilogue: f32 on the
//     accumulators, the [M, I] intermediate stored once, as bf16;
//   - GEMM 2 is gemm_ln: W2, b2 and the residual x added in f32 (x is not
//     rounded together with the product first, as the torch path did), the
//     LayerNorm's statistics across a thread-block cluster of D / 128
//     blocks, bf16 out. At K = I there are ~36 k-blocks a tile for one LN
//     exchange: 0.873 ms at I 2,244 (padded to 8) against 0.917 ms for
//     gemm_bias into f32
//     and residual_layernorm (PERF.md). Hidden widths outside gemm_ln's rule
//     (bindings.gemm_ln_fits) are refused: ops/fused_ffn sends them to the
//     plain path.
#include "gemm_bias.cuh"
#include "gemm_ln.cuh"

namespace evlm {

// gemm_bias with the activation `act` (gemm_impl::ACT_*) chosen at run time
static cudaError_t gemm_bias_act(const void* A, const void* B, const void* bias,
                                 const void* row_add, int period, bool vec16, void* C,
                                 bool out_f32, int M, int N, int K, int act, cudaStream_t s) {
  using namespace gemm_impl;
  switch (act) {
    case ACT_NONE:
      return gemm_bias_multi<ACT_NONE>(A, 1, &B, &bias, &C, row_add, period, vec16, out_f32, M,
                                       N, K, s);
    case ACT_GELU:
      return gemm_bias_multi<ACT_GELU>(A, 1, &B, &bias, &C, row_add, period, vec16, out_f32, M,
                                       N, K, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace evlm

// x [m, d] bf16, the sublayer's input and its residual, d a width gemm_ln
// normalises (gemm_ln_impl::width_ok); w1 [d, i], w2 [i, d] bf16 ([in,
// out]), i a multiple of 8 (the caller pads it to 64); b1 [i] (or null)
// bf16 (vec16_1) or f32; b2 [d] (or null), gamma, beta [d] bf16 (vec16_2)
// or f32; act: gemm_impl::ACT_GELU; ws_inter [m, i] bf16; out [m, d] bf16.
// Every bf16 pointer is 16-byte aligned (TMA).
extern "C" int evlm_fused_ffn(const void* x, const void* w1, const void* b1, const void* w2,
                              const void* b2, const void* gamma, const void* beta,
                              void* ws_inter, void* out, int m, int d, int i, int act,
                              int vec16_1, int vec16_2, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!gamma || !beta || act == evlm::gemm_impl::ACT_NONE || !evlm::gemm_ln_impl::width_ok(d))
    return cudaErrorInvalidValue;
  cudaError_t e = evlm::gemm_bias_act(x, w1, b1, nullptr, 1, vec16_1 != 0, ws_inter, false, m, i,
                                      d, act, st);
  if (e != cudaSuccess) return e;
  return static_cast<int>(evlm::gemm_ln(ws_inter, w2, b2, nullptr, 1, x, gamma, beta,
                                        vec16_2 != 0, out, m, m, 0, m, d, i, eps, st));
}

// The projection kernel on its own, for the card tests and chip_smoke.py.
// a [m, k], b [k, n] bf16; bias [n] and row_add [period, n] or null, bf16
// (vec16) or f32; c [m, n] bf16 or f32 (out_f32); act: gemm_impl::ACT_*.
extern "C" int evlm_gemm_bias(const void* a, const void* b, const void* bias, const void* row_add,
                              void* c, int period, int out_f32, int vec16, int m, int n, int k,
                              int act, void* stream) {
  return static_cast<int>(evlm::gemm_bias_act(a, b, bias, row_add, period, vec16 != 0, c,
                                              out_f32 != 0, m, n, k, act,
                                              static_cast<cudaStream_t>(stream)));
}
