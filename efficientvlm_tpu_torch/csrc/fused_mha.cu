// Fused attention sublayers on Hopper: one entry serves three TPU kernels of
// efficientvlm_tpu/ops/pallas_fused_mha.py:
//   - _fused_mha_padded (body _fused_kernel): self-attention, enc == x;
//   - _fused_cross_padded (body _fused_cross_kernel): cross-attention, Q from
//     the text rows, K/V from the image rows;
//   - _fused_cross_grouped_padded (body _fused_cross_grouped_kernel): G
//     contiguous text rows share one image's K/V; the caller passes the Bk
//     images as `batch` and each group's G*T rows as `tq`, so K/V are
//     projected for the Bk images only, and with ln_gamma the epilogue
//     returns LN(x + attn_out) (the BERT layer's residual + post-LN).
// Each computes Q/K/V = x/enc @ W + b (f32 accumulate, rounded to bf16); per
// head softmax(Q K^T / sqrt(dh) + key_bias) V in f32 with bf16 probabilities,
// times head_z[h]; then ctx @ Wo + bo. A = heads*head_dim may be < D.
//
// What bounds it on the H100: tensor-core operations. One teacher ViT
// sublayer (B=32, T=577, D=A=768) is 0.12 TFLOP, 0.12 ms at the bf16 peak,
// against ~60 MB of traffic (0.02 ms). The TPU kernel keeps a batch row's
// Q/K/V in VMEM and walks the heads in order; a Hopper SM has 227 KB of
// shared memory and 132 SMs want parallel work, so here the projections are
// whole-batch GEMMs on wgmma fed by TMA (gemm_bias) whose bf16 outputs make
// one round trip through device memory (the L2 holds much of it), and the
// attention is a flash kernel with the scores and probabilities in
// registers (attn_core). A self-attention sublayer is three launches: Q, K
// and V projected by one gemm_bias launch that reads x once, attn_core, the
// output projection; a cross-attention sublayer projects Q, then K and V in
// one launch over the image rows.
#include "attn_core.cuh"
#include "gemm_bias.cuh"
#include "residual_layernorm.cuh"

// x [batch*tq, d] bf16; enc [batch*s, de] bf16 (== x for self-attention);
// wq [d, A], wk/wv [de, A], wo [A, d] bf16; bq/bk/bv [A], bo [d] f32;
// key_bias [batch, s] f32; gates [heads] f32; ln_gamma/ln_beta [d] f32 or
// null; workspaces ws_q/ws_ctx [batch*tq, A], ws_k/ws_v [batch*s, A] bf16,
// ws_out [batch*tq, d] f32 (used only with ln_gamma); out [batch*tq, d] bf16.
// Every bf16 pointer is 16-byte aligned (TMA).
extern "C" int evlm_fused_attention(
    const void* x, const void* enc, const void* wq, const float* bq, const void* wk,
    const float* bk, const void* wv, const float* bv, const void* wo, const float* bo,
    const float* key_bias, const float* gates, const float* ln_gamma, const float* ln_beta,
    void* ws_q, void* ws_k, void* ws_v, void* ws_ctx, float* ws_out, void* out,
    int batch, int tq, int s, int d, int de, int heads, int head_dim, float ln_eps,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int a = heads * head_dim, rows_q = batch * tq, rows_kv = batch * s;
  cudaError_t e;
  if (enc == x && s == tq && de == d) {  // self-attention: Q, K, V in one launch
    const void* w[3] = {wq, wk, wv};
    const float* b[3] = {bq, bk, bv};
    void* c[3] = {ws_q, ws_k, ws_v};
    e = evlm::gemm_bias_multi(x, 3, w, b, c, nullptr, 1, false, rows_q, a, d, st);
  } else {
    const void* w[2] = {wk, wv};
    const float* b[2] = {bk, bv};
    void* c[2] = {ws_k, ws_v};
    e = evlm::gemm_bias(x, wq, bq, nullptr, 1, ws_q, false, rows_q, a, d, st);
    if (e == cudaSuccess)
      e = evlm::gemm_bias_multi(enc, 2, w, b, c, nullptr, 1, false, rows_kv, a, de, st);
  }
  if (e != cudaSuccess) return e;
  if ((e = evlm::attn_core(ws_q, ws_k, ws_v, key_bias, gates, ws_ctx, batch, tq, s, heads,
                           head_dim, 1.0f / sqrtf(static_cast<float>(head_dim)), st)))
    return e;
  if (ln_gamma == nullptr)
    return static_cast<int>(evlm::gemm_bias(ws_ctx, wo, bo, nullptr, 1, out, false, rows_q, d,
                                            a, st));
  if ((e = evlm::gemm_bias(ws_ctx, wo, bo, nullptr, 1, ws_out, true, rows_q, d, a, st))) return e;
  return static_cast<int>(evlm::residual_layernorm(ws_out, x, ln_gamma, ln_beta, out, rows_q, d,
                                                   ln_eps, rows_q, 0, 0, st));
}

// The two device kernels on their own, for the card tests and chip_smoke.py.
// a [m, k], b [k, n] bf16; bias [n] and row_add [period, n] f32 or null;
// c [m, n] bf16 or f32 (out_f32).
extern "C" int evlm_gemm_bias(const void* a, const void* b, const float* bias,
                              const float* row_add, void* c, int period, int out_f32, int m,
                              int n, int k, void* stream) {
  return static_cast<int>(evlm::gemm_bias(a, b, bias, row_add, period, c, out_f32 != 0, m, n, k,
                                          static_cast<cudaStream_t>(stream)));
}

// q/out [batch*tq, heads*head_dim], k/v [batch*s, heads*head_dim] bf16;
// key_bias [batch, s], gates [heads] f32.
extern "C" int evlm_attn_core(const void* q, const void* k, const void* v, const float* key_bias,
                              const float* gates, void* out, int batch, int tq, int s, int heads,
                              int head_dim, float scale, void* stream) {
  return static_cast<int>(evlm::attn_core(q, k, v, key_bias, gates, out, batch, tq, s, heads,
                                          head_dim, scale, static_cast<cudaStream_t>(stream)));
}
