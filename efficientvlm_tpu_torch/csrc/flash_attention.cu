// Bare attention core over already projected q/k/v in [batch, heads, T, dh]
// layout: out = softmax(q k^T + bias) v per (batch row, head), with q already
// scaled. Two C entries, one per TPU kernel of
// efficientvlm_tpu/ops/pallas_attention.py:
//   - evlm_flash_attention replaces _flash_attention_padded (bodies
//     _kernel_vec and _kernel_mat): the bias is a key vector [B|1, Tk] or a
//     full matrix [B|1, Tq, Tk];
//   - evlm_flash_attention_grouped replaces _flash_attention_grouped_padded:
//     q [Bk*G, H, Tq, dh] with each group's G query rows contiguous, k/v
//     [Bk, H, S, dh] shared by the group, one key vector per group.
// As in the TPU kernels the scores and the softmax are f32, the weights are
// rounded to bf16 before P.V, and P.V accumulates in f32.
//
// What bounds it on the H100: memory and launch latency. On the generation
// path these cores are small: 4*Tq*Tk*dh FLOP per (row, head) against reads
// of q, k, v and the bias once, e.g. a caption decode step (Tq = 1 over 577
// image keys, 3 beams) moves 28 MB for 0.1 GFLOP, and answer scoring (6
// rows x 25 keys) is a few microseconds of traffic. Design: one block per
// (query tile, head, batch row). For the grouped entry the group is folded
// into the query rows in the kernel's addressing (row r of a block is
// group r / Tq, position r % Tq), so one K/V tile in shared memory serves all
// G*Tq rows of a group and K/V are never repeated in memory. K/V stream
// through shared memory in 64-key tiles with an online softmax, so the
// scores never reach device memory. Query tiles are 64 rows (4 warps) when a
// (batch row, head) has more than 16 rows and 16 rows (1 warp) otherwise, so
// decode steps (1-12 rows) do not run 48 idle rows per block. Keys past Tk
// get -inf; every key tile starts at a real key, whose bias is finite (the
// caller masks with -1e9), so a row's running max is finite and no row with
// a visible key ever holds -inf alone.
#include <math.h>
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int TK = 64;  // keys per tile

template <int DH, int WARPS>
struct Layout {
  static constexpr int TQ = 16 * WARPS;                   // query rows per block
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int QKV_LD = DH + 8;                   // bf16 row stride
  static constexpr int S_LD = (DH > TK ? DH : TK) + 4;    // f32 scores / P.V rows
  static constexpr int P_LD = TK + 8;                     // bf16 weights
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(__nv_bfloat16) * TQ * QKV_LD;
  static constexpr size_t v_off = k_off + sizeof(__nv_bfloat16) * TK * QKV_LD;
  static constexpr size_t s_off = v_off + sizeof(__nv_bfloat16) * TK * QKV_LD;
  static constexpr size_t p_off = s_off + sizeof(float) * WARPS * 16 * S_LD;
  static constexpr size_t bytes = p_off + sizeof(__nv_bfloat16) * WARPS * 16 * P_LD;
};

struct Args {
  const __nv_bfloat16* q;  // [batch*groups, heads, tq, dh]
  const __nv_bfloat16* k;  // [batch, heads, tk, dh]
  const __nv_bfloat16* v;
  const float* bias;       // bias + b*bias_b + t*bias_t + key
  __nv_bfloat16* out;      // like q
  int groups, heads, tq, tk, bias_b, bias_t;
};

// offset of query row r (group r / tq, position r % tq) of (b, h), in elements
template <int DH>
__device__ __forceinline__ size_t q_row(const Args& a, int b, int h, int r) {
  const int g = r / a.tq, t = r - g * a.tq;
  return ((((size_t)b * a.groups + g) * a.heads + h) * a.tq + t) * DH;
}

// rows x DH bf16 rows of a contiguous [*, DH] block into shared memory,
// zero past `valid`
template <int DH, int WARPS>
__device__ __forceinline__ void load_kv(__nv_bfloat16* dst, const __nv_bfloat16* src, int valid) {
  constexpr int CH = DH / 8;  // 16-byte chunks per row
  using L = Layout<DH, WARPS>;
  for (int c = threadIdx.x; c < TK * CH; c += L::THREADS) {
    const int r = c / CH, d = (c % CH) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + (size_t)r * DH + d);
    *reinterpret_cast<uint4*>(dst + r * L::QKV_LD + d) = val;
  }
}

template <int DH, int WARPS>
__global__ void __launch_bounds__(Layout<DH, WARPS>::THREADS) flash_kernel(Args a) {
  using L = Layout<DH, WARPS>;
  constexpr int CH = DH / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sw = reinterpret_cast<float*>(smem + L::s_off) + warp * 16 * L::S_LD;
  __nv_bfloat16* pw = reinterpret_cast<__nv_bfloat16*>(smem + L::p_off) + warp * 16 * L::P_LD;

  const int r0 = blockIdx.x * L::TQ, h = blockIdx.y, b = blockIdx.z;
  const int rows = a.groups * a.tq;
  for (int c = threadIdx.x; c < L::TQ * CH; c += L::THREADS) {
    const int r = c / CH, d = (c % CH) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows) val = *reinterpret_cast<const uint4*>(a.q + q_row<DH>(a, b, h, r0 + r) + d);
    *reinterpret_cast<uint4*>(qs + r * L::QKV_LD + d) = val;
  }
  const size_t kv_base = ((size_t)b * a.heads + h) * a.tk * DH;

  // each lane owns half of one query row of its warp's 16
  const int r = lane / 2, half = lane % 2;
  const int row = r0 + warp * 16 + r;
  const bool row_ok = row < rows;
  const float* brow = a.bias + (size_t)b * a.bias_b +
                      (size_t)(row_ok ? row % a.tq : 0) * a.bias_t;
  float m_i = -INFINITY, l_i = 0.0f;
  float o[DH / 2];
#pragma unroll
  for (int c = 0; c < DH / 2; ++c) o[c] = 0.0f;

  for (int s0 = 0; s0 < a.tk; s0 += TK) {
    __syncthreads();  // previous tile fully consumed (and q loaded on entry)
    load_kv<DH, WARPS>(ks, a.k + kv_base + (size_t)s0 * DH, a.tk - s0);
    load_kv<DH, WARPS>(vs, a.v + kv_base + (size_t)s0 * DH, a.tk - s0);
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
      const int key = s0 + half * HC + c;
      const float x = key < a.tk ? sw[r * L::S_LD + half * HC + c] + brow[key] : -INFINITY;
      sv[c] = x;
      tmax = fmaxf(tmax, x);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m_i, tmax);  // finite: key s0 is real
    const float alpha = __expf(m_i - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int c = 0; c < HC; ++c) {
      const float p = __expf(sv[c] - m_new);
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

  if (row_ok) {
    const float f = 1.0f / l_i;
    __nv_bfloat16* dst = a.out + q_row<DH>(a, b, h, row) + half * (DH / 2);
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

template <int DH, int WARPS>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  using L = Layout<DH, WARPS>;
  cudaError_t e = cudaFuncSetAttribute(flash_kernel<DH, WARPS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L::bytes));
  if (e != cudaSuccess) return e;
  const int rows = a.groups * a.tq;
  dim3 grid((rows + L::TQ - 1) / L::TQ, a.heads, batch);
  flash_kernel<DH, WARPS><<<grid, L::THREADS, L::bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_rows(const Args& a, int batch, cudaStream_t stream) {
  if (a.groups * a.tq <= 16) return launch<DH, 1>(a, batch, stream);
  return launch<DH, 4>(a, batch, stream);
}

int run(const Args& a, int batch, int head_dim, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || batch > 65535 || a.heads <= 0 || a.heads > 65535 || a.tq <= 0 ||
      a.tk <= 0 || a.groups <= 0)
    return cudaErrorInvalidValue;
  switch (head_dim) {
    case 32: return launch_rows<32>(a, batch, st);
    case 64: return launch_rows<64>(a, batch, st);
    case 128: return launch_rows<128>(a, batch, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/out [batch, heads, tq, head_dim], k/v [batch, heads, tk, head_dim] bf16,
// contiguous, 16-byte aligned; bias f32 at bias + b*bias_b + t*bias_t + key
// (a key vector: bias_t = 0; a matrix: bias_t = tk; bias_b = 0 broadcasts
// one bias row over the batch). head_dim is 32, 64 or 128.
extern "C" int evlm_flash_attention(const void* q, const void* k, const void* v,
                                    const float* bias, void* out, int batch, int heads, int tq,
                                    int tk, int head_dim, int bias_b, int bias_t, void* stream) {
  Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
         static_cast<const __nv_bfloat16*>(v), bias, static_cast<__nv_bfloat16*>(out),
         1, heads, tq, tk, bias_b, bias_t};
  return run(a, batch, head_dim, stream);
}

// q/out [kv_batch*groups, heads, tq, head_dim] (a group's rows contiguous),
// k/v [kv_batch, heads, s, head_dim] bf16, contiguous, 16-byte aligned; bias
// f32 key vector per group at bias + b*bias_b + key (bias_b = 0 or s).
extern "C" int evlm_flash_attention_grouped(const void* q, const void* k, const void* v,
                                            const float* bias, void* out, int kv_batch,
                                            int groups, int heads, int tq, int s, int head_dim,
                                            int bias_b, void* stream) {
  Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
         static_cast<const __nv_bfloat16*>(v), bias, static_cast<__nv_bfloat16*>(out),
         groups, heads, tq, s, bias_b, 0};
  return run(a, kv_batch, head_dim, stream);
}
