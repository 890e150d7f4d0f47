// gemm_bias: C[M,N] = A[M,K] @ B[K,N] (+ bias[N]) (+ row_add[m % period, N]),
// bf16 operands, f32 accumulation, C written as bf16 or f32.
//
// Replaces the projections that the TPU kernels compute inside their own
// bodies: the patch matmul of efficientvlm_tpu/ops/pallas_patch_embed.py
// (_kernel, with the positional rows as row_add) and the Q/K/V/output
// projections of ops/pallas_fused_mha.py (_fused_kernel, _fused_cross_kernel,
// _fused_cross_grouped_kernel).
//
// What bounds it on the H100: at the main path's shapes (M = 1e4..4e4 rows,
// K = N = 768) a projection does ~150 FLOP per byte moved, below the card's
// ~295 FLOP/byte ridge, so memory and tensor-core issue both matter. Design:
// 128x128 output tiles per 256-thread block (each operand tile is reused
// 128 times from shared memory), a two-stage cp.async pipeline so the next
// K slice loads while the tensor cores (WMMA 16x16x16 bf16) work on this one,
// and an epilogue that adds bias / positional rows in f32 while the tile is
// in registers, so no separate elementwise pass touches device memory.
// wgmma + TMA is later work.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace evlm {
namespace gemm_impl {
namespace {  // internal linkage: each .cu includes its own copy

using namespace nvcuda;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int WM = 64, WN = 32;           // warp tile: 2 warps along M x 4 along N
constexpr int THREADS = 256;
constexpr int A_LD = BK + 8;              // +8 bf16 breaks shared-memory bank conflicts
constexpr int B_LD = BN + 8;

struct __align__(128) Smem {
  __nv_bfloat16 a[2][BM][A_LD];
  __nv_bfloat16 b[2][BK][B_LD];
  float scratch[THREADS / 32][16][16];
};

__device__ __forceinline__ void load_tile(Smem& sm, int stage, const __nv_bfloat16* A,
                                          const __nv_bfloat16* B, int M, int N, int K,
                                          int m0, int n0, int k0) {
  const int tid = threadIdx.x;
  // A tile: BM rows x BK cols = 512 16-byte chunks, 2 per thread
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int c = tid + i * THREADS;
    int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
    int gm = m0 + r, gk = k0 + kc;
    bool ok = gm < M && gk < K;
    const __nv_bfloat16* src = ok ? A + (size_t)gm * K + gk : A;
    evlm::cp_async16(&sm.a[stage][r][kc], src, ok ? 16 : 0);
  }
  // B tile: BK rows x BN cols = 512 chunks, 2 per thread
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int c = tid + i * THREADS;
    int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
    int gk = k0 + r, gn = n0 + nc;
    bool ok = gk < K && gn < N;
    const __nv_bfloat16* src = ok ? B + (size_t)gk * N + gn : B;
    evlm::cp_async16(&sm.b[stage][r][nc], src, ok ? 16 : 0);
  }
}

template <bool OUT_F32>
__global__ void __launch_bounds__(THREADS)
gemm_bias_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
                 const float* __restrict__ bias, const float* __restrict__ row_add,
                 int period, void* __restrict__ C, int M, int N, int K) {
  __shared__ Smem sm;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[WM / 16][WN / 16];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 16; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int kt_count = (K + BK - 1) / BK;
  load_tile(sm, 0, A, B, M, N, K, m0, n0, 0);
  evlm::cp_async_commit();
  for (int kt = 0; kt < kt_count; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < kt_count) {
      load_tile(sm, st ^ 1, A, B, M, N, K, m0, n0, (kt + 1) * BK);
      evlm::cp_async_commit();
      evlm::cp_async_wait<1>();
    } else {
      evlm::cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[WM / 16];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[WN / 16];
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
        wmma::load_matrix_sync(fa[i], &sm.a[st][wm * WM + i * 16][kk], A_LD);
#pragma unroll
      for (int j = 0; j < WN / 16; ++j)
        wmma::load_matrix_sync(fb[j], &sm.b[st][kk][wn * WN + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
#pragma unroll
        for (int j = 0; j < WN / 16; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // the stage just read is the next iteration's load target
  }

  // epilogue, one 16x16 fragment at a time through the warp's scratch:
  // each lane finishes 8 consecutive columns of one row
  float (*scr)[16] = sm.scratch[warp];
  const int er = lane / 2, ec = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < WM / 16; ++i) {
#pragma unroll
    for (int j = 0; j < WN / 16; ++j) {
      wmma::store_matrix_sync(&scr[0][0], acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm * WM + i * 16 + er;
      const int gn = n0 + wn * WN + j * 16 + ec;
      if (gm < M && gn < N) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[e] = scr[er][ec + e];
          if (bias) v[e] += bias[gn + e];
          if (row_add) v[e] += row_add[(size_t)(gm % period) * N + gn + e];
        }
        if (OUT_F32) {
          float4* dst = reinterpret_cast<float4*>(static_cast<float*>(C) + (size_t)gm * N + gn);
          dst[0] = make_float4(v[0], v[1], v[2], v[3]);
          dst[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else {
          __align__(16) __nv_bfloat162 h[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
          *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(C) + (size_t)gm * N + gn) =
              *reinterpret_cast<uint4*>(h);
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace
}  // namespace gemm_impl
}  // namespace evlm

namespace evlm {

// A [M,K] bf16 row-major, B [K,N] bf16 row-major (a dense kernel's [in, out]
// layout), C [M,N] contiguous, bf16 or f32 (out_f32). K and N must be
// multiples of 8 (16-byte rows); the caller checks this. bias [N] and
// row_add [period, N] (f32) may be null.
static inline cudaError_t gemm_bias(const void* A, const void* B, const float* bias,
                             const float* row_add, int period, void* C, bool out_f32,
                             int M, int N, int K, cudaStream_t s) {
  using namespace gemm_impl;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(A);
  const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(B);
  if (out_f32)
    gemm_bias_kernel<true><<<grid, THREADS, 0, s>>>(a, b, bias, row_add, period, C, M, N, K);
  else
    gemm_bias_kernel<false><<<grid, THREADS, 0, s>>>(a, b, bias, row_add, period, C, M, N, K);
  return cudaGetLastError();
}

}  // namespace evlm
