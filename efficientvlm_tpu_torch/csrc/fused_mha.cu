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
// against ~60 MB of traffic (0.02 ms); the grouped i2t rerank sublayer (Bk
// 4, G 256, T 40, S 577) is 0.17 TFLOP. The TPU kernel keeps a batch row's
// Q/K/V in VMEM and walks the heads in order; a Hopper SM has 227 KB of
// shared memory and 132 SMs want parallel work, so here the projections are
// whole-batch GEMMs on wgmma fed by TMA (gemm_bias) whose bf16 outputs make
// one round trip through device memory (the L2 holds much of it), then an
// attention core, then the output projection:
//   - self-attention: Q, K and V in one gemm_bias launch that reads x once,
//     attn_core (mma.sync), the output projection: three launches;
//   - cross-attention: Q, then K and V in one launch over the image rows,
//     attn_core, the output projection: four launches;
//   - grouped cross-attention: the same four launches, with the wgmma core
//     attn_wgmma (head dim 64; 32 and 128 stay on attn_core) and, with the
//     LayerNorm, the output projection through gemm_ln, which adds the
//     residual and normalises in its epilogue across a thread-block cluster
//     (D a multiple of 128 up to 1024; other widths keep gemm_bias into an
//     f32 workspace + residual_layernorm).
// The caller chooses the core and the LayerNorm route by those shape rules
// (kernels/bindings.py) and passes them as `core` and `ln_route`; a route
// the shape does not allow is refused here. With `probs` (the emit_probs
// forms of _fused_kernel and _fused_cross_kernel, the training path's KD
// taps) the core also writes the pre-gate f32 softmax maps: attn_probs
// (CORE_PROBS, head dim 64 up to the staging limit, `probs_rows` query rows
// a block served by `probs_ks` warps a 16-row group; bindings.probs_tile)
// or, outside that rule, attn_core's two-sweep
// form (CORE_MMA); the grouped sublayer (eval-only) never asks for maps.
// Biases and the LN parameters are read as stored, all bf16 (vec16) or all
// f32; the gates likewise (gates16).
//
// A second entry, evlm_fused_attention_bank, is the cross-attention sublayer
// over a bank of K/V projected once per image (the t2i rerank: each image
// is a candidate of many texts a pass, so projecting its K/V for every pair
// did the same GEMM again for each of them): the Q projection, attn_core's
// indexed form reading query row b's K/V at bank row kv_rows[b], and the
// output projection: three launches, and no K/V workspace.
#include "attn_core.cuh"
#include "attn_probs.cuh"
#include "attn_wgmma.cuh"
#include "gemm_bias.cuh"
#include "gemm_ln.cuh"
#include "residual_layernorm.cuh"

namespace {

enum { CORE_MMA = 0, CORE_WGMMA = 1, CORE_PROBS = 2 };
enum { LN_NONE = 0, LN_CLUSTER = 1, LN_SEPARATE = 2 };

}  // namespace

// x [batch*tq, d] bf16; enc [batch*s, de] bf16 (== x for self-attention);
// wq [d, A], wk/wv [de, A], wo [A, d] bf16; bq/bk/bv [A], bo [d],
// ln_gamma/ln_beta [d] (or null): bf16 (vec16) or f32; gates [heads] bf16
// (gates16) or f32, or null; key_bias [batch, s] f32; workspaces ws_q/ws_ctx
// [batch*tq, A], ws_k/ws_v [batch*s, A] bf16, ws_out [batch*tq, d] f32
// (ln_route 2 only); out [batch*tq, d] bf16; probs (or null) [batch, heads,
// tq, pitch] f32, the first s of each row written (CORE_PROBS: 16-byte
// aligned, pitch a multiple of 4; probs_rows query rows a block, probs_ks
// warps a 16-row group). Every bf16
// pointer is 16-byte aligned (TMA).
extern "C" int evlm_fused_attention(
    const void* x, const void* enc, const void* wq, const void* bq, const void* wk,
    const void* bk, const void* wv, const void* bv, const void* wo, const void* bo,
    const float* key_bias, const void* gates, const void* ln_gamma, const void* ln_beta,
    void* ws_q, void* ws_k, void* ws_v, void* ws_ctx, float* ws_out, void* out, float* probs,
    int pitch, int batch, int tq, int s, int d, int de, int heads, int head_dim, int core,
    int probs_rows, int probs_ks, int ln_route, int vec16, int gates16, float ln_eps,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int a = heads * head_dim, rows_q = batch * tq, rows_kv = batch * s;
  const bool with_ln = ln_route != LN_NONE, v16 = vec16 != 0, g16 = gates16 != 0;
  if ((core != CORE_MMA && core != CORE_WGMMA && core != CORE_PROBS) ||
      (core != CORE_MMA && head_dim != 64) || (probs && core == CORE_WGMMA) ||
      ((core == CORE_PROBS) != (probs && probs_rows > 0 && probs_ks > 0)) ||
      !key_bias || (with_ln && !(ln_gamma && ln_beta)) ||
      (ln_route == LN_CLUSTER && !evlm::gemm_ln_impl::width_ok(d)) ||
      (ln_route == LN_SEPARATE && !ws_out) || ln_route < LN_NONE || ln_route > LN_SEPARATE)
    return cudaErrorInvalidValue;
  cudaError_t e;
  if (enc == x && s == tq && de == d) {  // self-attention: Q, K, V in one launch
    const void* w[3] = {wq, wk, wv};
    const void* b[3] = {bq, bk, bv};
    void* c[3] = {ws_q, ws_k, ws_v};
    e = evlm::gemm_bias_multi(x, 3, w, b, c, nullptr, 1, v16, false, rows_q, a, d, st);
  } else {
    const void* w[2] = {wk, wv};
    const void* b[2] = {bk, bv};
    void* c[2] = {ws_k, ws_v};
    e = evlm::gemm_bias(x, wq, bq, nullptr, 1, v16, ws_q, false, rows_q, a, d, st);
    if (e == cudaSuccess)
      e = evlm::gemm_bias_multi(enc, 2, w, b, c, nullptr, 1, v16, false, rows_kv, a, de, st);
  }
  if (e != cudaSuccess) return e;
  const float scale = 1.0f / sqrtf(static_cast<float>(head_dim));
  if (core == CORE_WGMMA)
    e = evlm::attn_wgmma(ws_q, ws_k, ws_v, key_bias, gates, g16, ws_ctx, batch, tq, s, heads,
                         scale, st);
  else if (core == CORE_PROBS)
    e = evlm::attn_probs(ws_q, ws_k, ws_v, key_bias, gates, g16, ws_ctx, probs, pitch, batch, tq,
                         s, heads, probs_rows, probs_ks, scale, st);
  else
    e = evlm::attn_core(ws_q, ws_k, ws_v, key_bias, gates, g16, ws_ctx, batch, tq, s, heads,
                        head_dim, scale, st, probs, pitch);
  if (e != cudaSuccess) return e;
  if (ln_route == LN_NONE)
    return static_cast<int>(evlm::gemm_bias(ws_ctx, wo, bo, nullptr, 1, v16, out, false, rows_q,
                                            d, a, st));
  if (ln_route == LN_CLUSTER)
    return static_cast<int>(evlm::gemm_ln(ws_ctx, wo, bo, nullptr, 1, x, ln_gamma, ln_beta, v16,
                                          out, rows_q, rows_q, 0, rows_q, d, a, ln_eps, st));
  if ((e = evlm::gemm_bias(ws_ctx, wo, bo, nullptr, 1, v16, ws_out, true, rows_q, d, a, st)))
    return e;
  return static_cast<int>(evlm::residual_layernorm(ws_out, x, ln_gamma, ln_beta, v16, out, rows_q,
                                                   d, ln_eps, rows_q, 0, 0, st));
}

// x [batch*tq, d] bf16; wq [d, A], wo [A, d] bf16; bq [A], bo [d] bf16
// (vec16) or f32; k_bank/v_bank [n*s, A] bf16, the K/V of n encoder rows
// projected as evlm_fused_attention projects them; kv_rows [batch] int32,
// each in [0, n) (a row outside gets NaN: attn_core.cuh); key_bias [batch,
// s] f32, per query row; gates as above; workspaces ws_q/ws_ctx [batch*tq,
// A] bf16; out [batch*tq, d] bf16. Every bf16 pointer is 16-byte aligned
// (TMA).
extern "C" int evlm_fused_attention_bank(
    const void* x, const void* wq, const void* bq, const void* wo, const void* bo,
    const void* k_bank, const void* v_bank, const int* kv_rows, const float* key_bias,
    const void* gates, void* ws_q, void* ws_ctx, void* out, int n, int batch, int tq, int s,
    int d, int heads, int head_dim, int vec16, int gates16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int a = heads * head_dim, rows_q = batch * tq;
  const bool v16 = vec16 != 0;
  if (!kv_rows || !key_bias) return cudaErrorInvalidValue;
  cudaError_t e = evlm::gemm_bias(x, wq, bq, nullptr, 1, v16, ws_q, false, rows_q, a, d, st);
  if (e != cudaSuccess) return e;
  e = evlm::attn_core(ws_q, k_bank, v_bank, key_bias, gates, gates16 != 0, ws_ctx, batch, tq, s,
                      heads, head_dim, 1.0f / sqrtf(static_cast<float>(head_dim)), st, nullptr,
                      0, kv_rows, n);
  if (e != cudaSuccess) return e;
  return static_cast<int>(evlm::gemm_bias(ws_ctx, wo, bo, nullptr, 1, v16, out, false, rows_q,
                                          d, a, st));
}

// The device kernels on their own, for the card tests and chip_smoke.py
// (evlm_gemm_bias, with its activations, is in fused_ffn.cu).
// out[map(row)] = LN(a @ b + bias + row_add[row % period] + residual[row]);
// a [m, k], b [k, n], residual [m, n] (or null) bf16; bias, row_add, gamma,
// beta bf16 (vec16) or f32; n a multiple of 128 up to 1024.
extern "C" int evlm_gemm_ln(const void* a, const void* b, const void* bias, const void* row_add,
                            const void* residual, const void* gamma, const void* beta, void* out,
                            int period, int group, int out_group_stride, int out_offset,
                            int vec16, int m, int n, int k, float eps, void* stream) {
  return static_cast<int>(evlm::gemm_ln(a, b, bias, row_add, period, residual, gamma, beta,
                                        vec16 != 0, out, group, out_group_stride, out_offset, m,
                                        n, k, eps, static_cast<cudaStream_t>(stream)));
}

// the clusters of gemm_ln (gather = its patch-embedding form) the card keeps
// resident at width n; negative when n is outside the rule or on an error
extern "C" int evlm_gemm_ln_clusters(int n, int gather) {
  return evlm::gemm_ln_clusters(n, gather != 0);
}

// q/out [batch*tq, heads*head_dim], k/v [batch*s, heads*head_dim] bf16;
// key_bias [batch, s] f32; gates [heads] bf16 (gates16) or f32, or null;
// probs (or null) [batch, heads, tq, pitch] f32, the probs form.
extern "C" int evlm_attn_core(const void* q, const void* k, const void* v, const float* key_bias,
                              const void* gates, void* out, float* probs, int pitch, int batch,
                              int tq, int s, int heads, int head_dim, int gates16, float scale,
                              void* stream) {
  return static_cast<int>(evlm::attn_core(q, k, v, key_bias, gates, gates16 != 0, out, batch, tq,
                                          s, heads, head_dim, scale,
                                          static_cast<cudaStream_t>(stream), probs, pitch));
}

// the probs form at head dim 64 (attn_probs): q/out [batch*tq, heads*64],
// k/v [batch*s, heads*64] bf16; key_bias [batch, s] f32; gates [heads] bf16
// (gates16) or f32, or null; probs [batch, heads, tq, pitch] f32; `rows`
// query rows a block and `ks` warps a 16-row group (bindings.probs_tile)
extern "C" int evlm_attn_probs(const void* q, const void* k, const void* v, const float* key_bias,
                               const void* gates, void* out, float* probs, int pitch, int batch,
                               int tq, int s, int heads, int rows, int ks, int gates16,
                               float scale, void* stream) {
  return static_cast<int>(evlm::attn_probs(q, k, v, key_bias, gates, gates16 != 0, out, probs,
                                           pitch, batch, tq, s, heads, rows, ks, scale,
                                           static_cast<cudaStream_t>(stream)));
}

// the same function and arguments as evlm_attn_core, for head dim 64
extern "C" int evlm_attn_wgmma(const void* q, const void* k, const void* v, const float* key_bias,
                               const void* gates, void* out, int batch, int tq, int s, int heads,
                               int gates16, float scale, void* stream) {
  return static_cast<int>(evlm::attn_wgmma(q, k, v, key_bias, gates, gates16 != 0, out, batch,
                                           tq, s, heads, scale,
                                           static_cast<cudaStream_t>(stream)));
}
