// attn_core: per head, ctx = softmax(q k^T * scale + key_bias) v * gate[h],
// over projected q [B*Tq, A], k/v [B*S, A] (A = H*DH, heads side by side),
// written as ctx [B*Tq, A] bf16.
//
// Replaces the attention part of the bodies of
// efficientvlm_tpu/ops/pallas_fused_mha.py: _fused_kernel (self),
// _fused_cross_kernel (cross) and _fused_cross_grouped_kernel (grouped
// cross). For the grouped case the caller folds each image's G contiguous
// query rows into one batch row of G*T queries, so one K/V tile in shared
// memory serves every text of the group and K/V are never repeated.
//
// What bounds it on the H100: the two products do 4*Tq*S*DH FLOP per
// (row, head) against reads of q, k, v once, so at S = 577 it is compute
// bound on paper; in this simple form it is bound by shared-memory traffic
// and the f32 softmax between the two WMMA products. Design: one 128-thread
// block per (64-query tile, head, batch row); K/V stream through shared
// memory in 64-key tiles with an online softmax in f32, so the [Tq, S]
// scores never reach device memory. As in the TPU kernel the probabilities
// are rounded to bf16 before P.V and the sums stay in f32. Keys past S get
// -inf; masked keys carry the caller's -1e9 bias.
#pragma once

#include <math.h>
#include <mma.h>

#include "common.cuh"

namespace evlm {
namespace attn_impl {
namespace {  // internal linkage: each .cu includes its own copy

using namespace nvcuda;

constexpr int TQ = 64;         // query rows per block (16 per warp)
constexpr int TK = 64;         // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

template <int DH>
struct Layout {
  static constexpr int QKV_LD = DH + 8;                    // bf16 row stride
  static constexpr int S_LD = (DH > TK ? DH : TK) + 4;      // f32 scores / P.V rows
  static constexpr int P_LD = TK + 8;                       // bf16 probabilities
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(__nv_bfloat16) * TQ * QKV_LD;
  static constexpr size_t v_off = k_off + sizeof(__nv_bfloat16) * TK * QKV_LD;
  static constexpr size_t s_off = v_off + sizeof(__nv_bfloat16) * TK * QKV_LD;
  static constexpr size_t p_off = s_off + sizeof(float) * WARPS * 16 * S_LD;
  static constexpr size_t bytes = p_off + sizeof(__nv_bfloat16) * WARPS * 16 * P_LD;
};

// rows x DH bf16 block of a [*, ld] matrix into shared memory, zero past `valid`
template <int DH>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int ld, int valid, int rows) {
  constexpr int CH = DH / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < rows * CH; c += THREADS) {
    int r = c / CH, d = (c % CH) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < valid) v = *reinterpret_cast<const uint4*>(src + (size_t)r * ld + d);
    *reinterpret_cast<uint4*>(dst + r * Layout<DH>::QKV_LD + d) = v;
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
attn_core_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const float* __restrict__ key_bias,
                 const float* __restrict__ gates, __nv_bfloat16* __restrict__ out,
                 int Tq, int S, int ld, float scale) {
  using L = Layout<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sw = reinterpret_cast<float*>(smem + L::s_off) + warp * 16 * L::S_LD;
  __nv_bfloat16* pw = reinterpret_cast<__nv_bfloat16*>(smem + L::p_off) + warp * 16 * L::P_LD;

  const int t0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const size_t col = (size_t)h * DH;
  load_rows<DH>(qs, q + ((size_t)b * Tq + t0) * ld + col, ld, Tq - t0, TQ);

  // each lane owns half of one query row: row r, columns [half*.., +..)
  const int r = lane / 2, half = lane % 2;
  float m_i = -INFINITY, l_i = 0.0f;
  float o[DH / 2];
#pragma unroll
  for (int c = 0; c < DH / 2; ++c) o[c] = 0.0f;
  const float* kb = key_bias + (size_t)b * S;

  for (int s0 = 0; s0 < S; s0 += TK) {
    __syncthreads();  // previous tile fully consumed (and q loaded on entry)
    load_rows<DH>(ks, k + ((size_t)b * S + s0) * ld + col, ld, S - s0, TK);
    load_rows<DH>(vs, v + ((size_t)b * S + s0) * ld + col, ld, S - s0, TK);
    __syncthreads();

    // S_w[16, TK] = Q_w[16, DH] . K^T
#pragma unroll
    for (int j = 0; j < TK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < DH; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, qs + (warp * 16) * L::QKV_LD + kk, L::QKV_LD);
        wmma::load_matrix_sync(fb, ks + (j * 16) * L::QKV_LD + kk, L::QKV_LD);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sw + j * 16, acc, L::S_LD, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this tile, f32
    constexpr int HC = TK / 2;
    float sv[HC];
    float tmax = -INFINITY;
#pragma unroll
    for (int c = 0; c < HC; ++c) {
      int key = s0 + half * HC + c;
      float x = key < S ? sw[r * L::S_LD + half * HC + c] * scale + kb[key] : -INFINITY;
      sv[c] = x;
      tmax = fmaxf(tmax, x);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m_i, tmax);  // finite: every tile holds a real key
    const float alpha = __expf(m_i - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int c = 0; c < HC; ++c) {
      float p = __expf(sv[c] - m_new);
      psum += p;
      pw[r * L::P_LD + half * HC + c] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_i = l_i * alpha + psum;
    m_i = m_new;
    __syncwarp();

    // PV_w[16, DH] = P_w[16, TK] . V, staged through the score scratch
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < TK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, pw + kk, L::P_LD);
        wmma::load_matrix_sync(fb, vs + kk * L::QKV_LD + j * 16, L::QKV_LD);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sw + j * 16, acc, L::S_LD, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < DH / 2; ++c) o[c] = o[c] * alpha + sw[r * L::S_LD + half * (DH / 2) + c];
    __syncwarp();
  }

  const int t = t0 + warp * 16 + r;
  if (t < Tq) {
    const float f = gates[h] / l_i;
    __nv_bfloat16* dst = out + ((size_t)b * Tq + t) * ld + col + half * (DH / 2);
#pragma unroll
    for (int c = 0; c < DH / 2; c += 8) {
      __align__(16) __nv_bfloat162 hv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        hv[e] = __floats2bfloat162_rn(o[c + 2 * e] * f, o[c + 2 * e + 1] * f);
      *reinterpret_cast<uint4*>(dst + c) = *reinterpret_cast<uint4*>(hv);
    }
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const float* key_bias,
                   const float* gates, void* out, int batch, int Tq, int S, int heads, int ld,
                   float scale, cudaStream_t stream) {
  const size_t smem = Layout<DH>::bytes;
  cudaError_t e = cudaFuncSetAttribute(attn_core_kernel<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((Tq + TQ - 1) / TQ, heads, batch);
  attn_core_kernel<DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), key_bias, gates,
      static_cast<__nv_bfloat16*>(out), Tq, S, ld, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace attn_impl
}  // namespace evlm

namespace evlm {

// q/out [batch*Tq, ld], k/v [batch*S, ld] bf16 with ld = heads*head_dim;
// key_bias [batch, S] f32; gates [heads] f32. head_dim is 32, 64 or 128.
static inline cudaError_t attn_core(const void* q, const void* k, const void* v,
                             const float* key_bias, const float* gates, void* out,
                             int batch, int Tq, int S, int heads, int head_dim, float scale,
                             cudaStream_t s) {
  using attn_impl::launch;
  const int ld = heads * head_dim;
  switch (head_dim) {
    case 32: return launch<32>(q, k, v, key_bias, gates, out, batch, Tq, S, heads, ld, scale, s);
    case 64: return launch<64>(q, k, v, key_bias, gates, out, batch, Tq, S, heads, ld, scale, s);
    case 128: return launch<128>(q, k, v, key_bias, gates, out, batch, Tq, S, heads, ld, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace evlm
