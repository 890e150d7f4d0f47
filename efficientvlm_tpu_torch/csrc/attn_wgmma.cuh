// attn_wgmma: per (batch row b, head h), ctx = softmax(q k^T * scale +
// key_bias[b]) v * gate[h], over projected q [B*Tq, A], k/v [B*S, A]
// (A = H*64, heads side by side), written as ctx [B*Tq, A] bf16. The same
// function as attn_core, for head dim 64, on Hopper's wgmma.
//
// Replaces the attention part of the body of
// efficientvlm_tpu/ops/pallas_fused_mha.py:_fused_cross_grouped_kernel
// (_fused_cross_grouped_padded): the caller folds each image's G contiguous
// query rows into one batch row of G*T queries (10,240 at the i2t rerank),
// so one (image, head)'s K/V serve every text of the group.
//
// What bounds it on the H100: tensor-core operations (4*Tq*S*64 FLOP per
// (b, h) against reads of q, k, v once: at the rerank shape 72.6 GFLOP
// over ~130 MB). attn_core (mma.sync, FlashAttention-2 style) reaches about
// a sixth of the bf16 peak. Design, FlashAttention-3 style:
//   - persistent blocks (one per SM) each walk a contiguous run of work
//     items (b, h, 128-row query tile), query tiles fastest, so a block
//     stays on one (b, h) for many tiles;
//   - a producer warp loads each item's 128-row Q tile by TMA (double
//     buffered) and streams that (b, h)'s K and V in 128-key tiles through
//     a 5-stage mbarrier ring (TMA, 128-byte swizzle; a (b, h)'s K/V stay
//     in L2 across its query tiles), with the key bias tile (the f32 key
//     bias, -inf past S, times log2 e) written by its 32 lanes; its
//     warpgroup's registers go to the consumers (setmaxnreg);
//   - two consumer warpgroups own 64 query rows each: S = Q K^T by wgmma
//     m64n128k16 with both operands in shared memory (K rows are K-major
//     for B), the online softmax in f32 registers (quad shuffles, exp2),
//     P rounded to bf16 in registers and fed as wgmma's register A operand
//     of m64n64k16 for P V (the f32 accumulator fragment of S is already
//     the A-fragment layout), V read through the transpose bit, O in
//     registers;
//   - O is scaled by gate[h] / l, staged over the warpgroup's half of its
//     Q buffer and stored with 16-byte stores (rows past Tq are not).
// Tried on the card and not kept (PERF.md): keeping a (b, h)'s K/V
// resident in shared memory across its query tiles (no faster than
// streaming them from L2), and issuing the next tile's Q K^T before this
// tile's softmax (ptxas serialised the wgmmas; slower).
// As in attn_core, the un-normalised weights are rounded to bf16 before
// P V, the sums stay in f32, every key tile starts at a real key (so a
// row's running max is finite from the first tile on), and masked keys
// carry the caller's -1e9 key bias.
#pragma once

#include <math.h>

#include "gemm_bias.cuh"

namespace evlm {
namespace attn_wg_impl {
namespace {  // internal linkage: each .cu includes its own copy

using gemm_impl::desc_k_major;
using gemm_impl::desc_mn_major;
using gemm_impl::encode_map;
using gemm_impl::mbar_arrive;
using gemm_impl::mbar_expect_tx;
using gemm_impl::mbar_init;
using gemm_impl::mbar_wait;
using gemm_impl::tma_load_2d;
using gemm_impl::warpgroup_sync;
using gemm_impl::wgmma_commit;
using gemm_impl::wgmma_fence;
using gemm_impl::wgmma_wait;

constexpr int DH = 64, TN = 128, QT = 128, KV_STAGES = 5;
// two consumer warpgroups and a producer warpgroup, whose registers
// setmaxnreg hands to the consumers
constexpr int THREADS = 3 * 128;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int TILE_BYTES = TN * DH * 2;         // one K or V tile: 128 rows of 128 bytes
constexpr int Q_BYTES = QT * DH * 2;
constexpr float LOG2E = 1.4426950408889634f;
constexpr size_t SMEM_BYTES = 2 * Q_BYTES + 2 * KV_STAGES * TILE_BYTES +
                              KV_STAGES * TN * sizeof(float) +
                              (2 * KV_STAGES + 4) * sizeof(uint64_t) + 1024;

struct AttnParams {
  CUtensorMap q;          // [B*Tq, A], box 64 x 128 rows
  CUtensorMap k, v;       // [B*S, A], box 64 x 128 rows
  __nv_bfloat16* out;     // [B*Tq, A]
  const float* key_bias;  // [B, S] f32
  const void* gates;      // [H] bf16 (gates16) or f32, or null (all ones)
  int batch, tq, s, heads, gates16;
  float scale_log2;       // softmax scale * log2 e
};

template <int N>
__device__ __forceinline__ void fence_f(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_u(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j]) :: "memory");
}

#define EVLM_ACC8(i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// S[64x128] (+)= Q[64x16] . K^T[16x128], both K-major in shared memory
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : EVLM_ACC8(0), EVLM_ACC8(8), EVLM_ACC8(16), EVLM_ACC8(24), EVLM_ACC8(32), EVLM_ACC8(40),
        EVLM_ACC8(48), EVLM_ACC8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// O[64x64] += P[64x16] (registers) . V[16x64] (MN-major in shared memory)
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : EVLM_ACC8(0), EVLM_ACC8(8), EVLM_ACC8(16), EVLM_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef EVLM_ACC8

// S = Q K^T of one key tile into sc: four wgmma over the head dim, issued
// and committed, not waited for
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t qa, uint32_t kb) {
  fence_f(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_qk(sc, desc_k_major(qa + kk * 32), desc_k_major(kb + kk * 32), kk > 0);
  wgmma_commit();
}

// the online softmax of one key tile's scores sc (rows r, r + 8 of this
// thread) in the log2 domain: x = s * scale * log2 e + bias * log2 e (keys
// past S carry -inf); updates the running max m and sum l, returns P
// (bf16, in wgmma's A-fragment layout: k16 chunk kc is score blocks 2kc,
// 2kc + 1) and the factors a0, a1 that rescale O.
__device__ __forceinline__ void softmax_p(float (&sc)[64], uint32_t (&pf)[TN / 16][4], float& m0,
                                          float& m1, float& l0, float& l1, float& a0, float& a1,
                                          const float* bt, float scale_log2) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int nb = 0; nb < TN / 8; ++nb) {
    const float2 bb = *reinterpret_cast<const float2*>(bt + nb * 8);
    sc[4 * nb] = fmaf(sc[4 * nb], scale_log2, bb.x);
    sc[4 * nb + 1] = fmaf(sc[4 * nb + 1], scale_log2, bb.y);
    sc[4 * nb + 2] = fmaf(sc[4 * nb + 2], scale_log2, bb.x);
    sc[4 * nb + 3] = fmaf(sc[4 * nb + 3], scale_log2, bb.y);
    mx0 = fmaxf(mx0, fmaxf(sc[4 * nb], sc[4 * nb + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * nb + 2], sc[4 * nb + 3]));
  }
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: a real key
  a0 = ex2(m0 - mn0);
  a1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
  for (int nb = 0; nb < TN / 8; ++nb) {
    const float p0 = ex2(sc[4 * nb] - mn0), p1 = ex2(sc[4 * nb + 1] - mn0);
    const float p2 = ex2(sc[4 * nb + 2] - mn1), p3 = ex2(sc[4 * nb + 3] - mn1);
    ps0 += p0 + p1;
    ps1 += p2 + p3;
    pf[nb / 2][(nb % 2) * 2] = pack_bf16(p0, p1);
    pf[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(p2, p3);
  }
  l0 = l0 * a0 + ps0;
  l1 = l1 * a1 + ps1;
}

// O = O * a + P V: the rescale, then the products issued and committed
// with P as wgmma's register A operand (V MN-major, read through the
// transpose bit)
__device__ __forceinline__ void rescale_pv(float (&o)[32], uint32_t (&pf)[TN / 16][4], float a0,
                                           float a1, uint32_t vb) {
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) {
    o[4 * nd] *= a0;
    o[4 * nd + 1] *= a0;
    o[4 * nd + 2] *= a1;
    o[4 * nd + 3] *= a1;
  }
  fence_f(o);
  fence_u(pf);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < TN / 16; ++kc) wgmma_pv(o, pf[kc], desc_mn_major(vb + kc * 2048));
  wgmma_commit();
  fence_u(pf);
}

__global__ void __launch_bounds__(THREADS, 1)
attn_wgmma_kernel(const __grid_constant__ AttnParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* qs = smem;                           // [2] Q tiles
  unsigned char* ks = qs + 2 * Q_BYTES;               // [KV_STAGES] K tiles
  unsigned char* vs = ks + KV_STAGES * TILE_BYTES;    // [KV_STAGES] V tiles
  float* bs = reinterpret_cast<float*>(vs + KV_STAGES * TILE_BYTES);  // [KV_STAGES][TN]
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + KV_STAGES * TN);
  uint64_t* empty = full + KV_STAGES;
  uint64_t* qfull = empty + KV_STAGES;
  uint64_t* qempty = qfull + 2;

  const int nq = (p.tq + QT - 1) / QT, nk = (p.s + TN - 1) / TN;
  const int items = p.batch * p.heads * nq;
  const int w0 = (int)((long)blockIdx.x * items / gridDim.x);
  const int w1 = (int)((long)(blockIdx.x + 1) * items / gridDim.x);
  const int a = p.heads * DH;

  if (threadIdx.x == 0) {
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA's expected bytes + the 32 bias lanes
      mbar_init(&empty[s], 2);      // both consumer warpgroups
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&qfull[i], 1);
      mbar_init(&qempty[i], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: Q, K, V and the bias tiles of every item, going round the
    // ring in order. Its first warp works; the others only give up their
    // registers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (threadIdx.x >= 2 * 128 + 32) return;
    const int lane = threadIdx.x % 32;
    int fill = 0, qn = 0;
    for (int w = w0; w < w1; ++w) {
      const int qt = w % nq, bh = w / nq, h = bh % p.heads, b = bh / p.heads;
      if (lane == 0) {
        const int qb = qn & 1;
        mbar_wait(&qempty[qb], ((qn >> 1) & 1) ^ 1);
        mbar_expect_tx(&qfull[qb], Q_BYTES);
        tma_load_2d(qs + qb * Q_BYTES, &p.q, h * DH, b * p.tq + qt * QT, &qfull[qb]);
      }
      ++qn;
      for (int kt = 0; kt < nk; ++kt, ++fill) {
        const int st = fill % KV_STAGES;
        mbar_wait(&empty[st], ((fill / KV_STAGES) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[st], 2 * TILE_BYTES);
          tma_load_2d(ks + st * TILE_BYTES, &p.k, h * DH, b * p.s + kt * TN, &full[st]);
          tma_load_2d(vs + st * TILE_BYTES, &p.v, h * DH, b * p.s + kt * TN, &full[st]);
        }
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = kt * TN + lane * 4 + i;
          const size_t at = (size_t)b * p.s + key;
          e[i] = key >= p.s ? -INFINITY : p.key_bias[at] * LOG2E;
        }
        *reinterpret_cast<float4*>(bs + st * TN + lane * 4) =
            make_float4(e[0], e[1], e[2], e[3]);
        mbar_arrive(&full[st]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of every Q tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int tid = threadIdx.x % 128;
  const int r = (tid / 32) * 16 + (tid % 32) / 4, q4 = tid % 4;
  int fill = 0, qn = 0;
  for (int w = w0; w < w1; ++w) {
    const int qt = w % nq, bh = w / nq, h = bh % p.heads, b = bh / p.heads;
    const int qb = qn & 1;
    mbar_wait(&qfull[qb], (qn >> 1) & 1);
    unsigned char* qw = qs + qb * Q_BYTES + wg * 64 * 128;  // this warpgroup's 64 rows
    const uint32_t qa = smem_u32(qw);

    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.0f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
    for (int kt = 0; kt < nk; ++kt, ++fill) {
      const int st = fill % KV_STAGES;
      mbar_wait(&full[st], (fill / KV_STAGES) & 1);
      float sc[64];
      issue_qk(sc, qa, smem_u32(ks + st * TILE_BYTES));
      wgmma_wait<0>();
      fence_f(sc);
      uint32_t pf[TN / 16][4];
      float a0, a1;
      softmax_p(sc, pf, m0, m1, l0, l1, a0, a1, bs + st * TN + 2 * q4, p.scale_log2);
      rescale_pv(o, pf, a0, a1, smem_u32(vs + st * TILE_BYTES));
      wgmma_wait<0>();
      fence_f(o);
      if (tid == 0) mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, x);
      l1 += __shfl_xor_sync(0xffffffffu, l1, x);
    }
    const float gate = p.gates ? load1(p.gates, p.gates16, h) : 1.0f;
    const float f0 = gate / l0, f1 = gate / l1;
    // stage the 64 x 64 context over this warpgroup's Q rows (the Q reads
    // are done), swizzled as TMA wrote Q, then 16-byte stores
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(qw + r * 128 + ((nd ^ (r % 8)) << 4) + 4 * q4) =
          __floats2bfloat162_rn(o[4 * nd] * f0, o[4 * nd + 1] * f0);
      *reinterpret_cast<__nv_bfloat162*>(qw + (r + 8) * 128 + ((nd ^ (r % 8)) << 4) + 4 * q4) =
          __floats2bfloat162_rn(o[4 * nd + 2] * f1, o[4 * nd + 3] * f1);
    }
    warpgroup_sync(wg);
#pragma unroll
    for (int it = 0; it < 64 * 8 / 128; ++it) {
      const int idx = it * 128 + tid, rr = idx / 8, c8 = idx % 8;
      const int t = qt * QT + wg * 64 + rr;
      if (t < p.tq)
        *reinterpret_cast<uint4*>(p.out + ((size_t)b * p.tq + t) * a + h * DH + c8 * 8) =
            *reinterpret_cast<const uint4*>(qw + rr * 128 + ((c8 ^ (rr % 8)) << 4));
    }
    // the buffer's next writer is TMA (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    warpgroup_sync(wg);
    if (tid == 0) mbar_arrive(&qempty[qb]);
    ++qn;
  }
}

}  // namespace
}  // namespace attn_wg_impl
}  // namespace evlm

namespace evlm {

// q/out [batch*Tq, heads*64], k/v [batch*S, heads*64] bf16, 16-byte
// aligned; key_bias [batch, S] f32; gates [heads] bf16 (gates16) or f32, or
// null. The arguments of attn_core, for head dim 64.
static inline cudaError_t attn_wgmma(const void* q, const void* k, const void* v,
                                     const float* key_bias, const void* gates, bool gates16,
                                     void* out, int batch, int Tq, int S, int heads, float scale,
                                     cudaStream_t s) {
  using namespace attn_wg_impl;
  if (batch <= 0 || Tq <= 0 || S <= 0 || heads <= 0 || !key_bias) return cudaErrorInvalidValue;
  const int a = heads * DH;
  AttnParams p{};
  if (!encode_map(&p.q, q, batch * Tq, a, QT) || !encode_map(&p.k, k, batch * S, a, TN) ||
      !encode_map(&p.v, v, batch * S, a, TN))
    return cudaErrorInvalidValue;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.key_bias = key_bias;
  p.gates = gates;
  p.gates16 = gates16;
  p.batch = batch;
  p.tq = Tq;
  p.s = S;
  p.heads = heads;
  p.scale_log2 = scale * LOG2E;
  static DeviceCache cache;
  int sms = 0;
  cudaError_t e = once_per_device(cache, reinterpret_cast<const void*>(attn_wgmma_kernel),
                                  static_cast<int>(SMEM_BYTES), &sms);
  if (e != cudaSuccess) return e;
  const int items = batch * heads * ((Tq + QT - 1) / QT);
  attn_wgmma_kernel<<<items < sms ? items : sms, THREADS, SMEM_BYTES, s>>>(p);
  return cudaGetLastError();
}

}  // namespace evlm
