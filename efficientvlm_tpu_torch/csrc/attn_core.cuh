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
// (row, head) against reads of q, k, v once, so at S = 577 it is
// tensor-core bound on paper. What keeps a simple kernel far from that is
// moving scores and probabilities through shared memory between the two
// products. Design (FlashAttention-2's forward):
//   - one block per (query tile, head, batch row); each warp owns 16 query
//     rows, and the tile is as tall as Tq needs, up to 128 rows (8 warps):
//     3 warps for the fusion layers' Tq = 40, 8 for the ViT's 577;
//   - K/V and the key bias stream through shared memory in 64-key tiles,
//     double-buffered with cp.async, so the next tile loads while this one
//     computes; rows are padded by 16 bytes so ldmatrix reads hit distinct
//     banks; a warp whose rows all lie past Tq only loads and syncs;
//   - Q K^T with mma.sync m16n8k16 (bf16, f32 accumulate) on ldmatrix
//     fragments: the scores stay in the accumulator registers, where the
//     online softmax scales, biases and exponentiates them in f32 (row max
//     and sum across each quad of lanes with shuffles);
//   - the accumulator layout of the scores is the A-operand layout of P.V,
//     so P is rounded to bf16 and fed to the second product from registers
//     (V through ldmatrix.trans), and O is accumulated in registers;
//   - only the finished context goes through shared memory, to leave the
//     block as 16-byte stores.
// As in the TPU kernel the probabilities are rounded to bf16 before P.V
// (here the un-normalised ones) and the sums stay in f32. Keys past S get
// -inf; masked keys carry the caller's -1e9 bias. Every key tile starts at a
// real key, so a row's running max is finite from the first tile on.
//
// The probs form (PROBS, the emit_probs=True instances of _fused_kernel and
// _fused_cross_kernel, which the KD taps read) also writes the normalised,
// pre-gate f32 probabilities [B, H, Tq, S] (rows `pitch` floats apart). An
// online softmax cannot write normalised maps in one sweep, so the block
// walks the key tiles twice: sweep 1 computes Q K^T and keeps only each
// row's max and sum; sweep 2 recomputes each score tile, writes p = exp(s -
// m) / l, rounds the normalised p to bf16 for P.V (where the TPU kernel
// rounds) and accumulates O, which then needs no final division. Sweep 1
// skips V's loads. At the ViT shape the maps are ~3x the bytes of
// everything else the sublayer moves, so the store bounds it; each lane
// writes its two columns of a row as one 8-byte store (4-byte at an odd S's
// last key), and keys past S are never written. The exp is expf in both
// sweeps, so a row sums to 1 within f32 rounding; masked keys come out as
// exact zeros (exp of about -1e9).
#pragma once

#include <math.h>

#include "common.cuh"

namespace evlm {
namespace attn_impl {
namespace {  // internal linkage: each .cu includes its own copy

constexpr int TK = 64;          // keys per tile
constexpr int MAX_WARPS = 8;    // 16 query rows per warp, up to 128 per block

template <int DH>
struct Layout {
  static constexpr int LD = DH + 8;       // bf16 row stride
  static constexpr int TILE = TK * LD;    // one K or V tile
  // q rows of the block, K[2], V[2], key bias[2]
  static constexpr size_t bytes(int warps) {
    return sizeof(__nv_bfloat16) * (warps * 16 * LD + 4 * TILE) + sizeof(float) * 2 * TK;
  }
};

// 4-byte asynchronous global->shared copy; src_bytes = 0 writes zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}

// rows x DH bf16 block of a [*, ld] matrix into shared memory (row stride
// LD) with cp.async, zero past `valid`
template <int DH>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int ld,
                                          int valid, int rows) {
  constexpr int CH = DH / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < rows * CH; c += blockDim.x) {
    const int r = c / CH, d = (c % CH) * 8;
    const bool ok = r < valid;
    evlm::cp_async16(dst + r * Layout<DH>::LD + d, ok ? src + (size_t)r * ld + d : src,
                     ok ? 16 : 0);
  }
}

template <int DH, bool PROBS>
__global__ void __launch_bounds__(MAX_WARPS * 32, DH == 128 ? 1 : 2)
attn_core_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const float* __restrict__ key_bias,
                 const void* __restrict__ gates, bool gates16, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ probs, int pitch, int Tq, int S, int ld, float scale) {
  using L = Layout<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + warps * 16 * L::LD;
  __nv_bfloat16* vs = ks + 2 * L::TILE;
  float* bs = reinterpret_cast<float*>(vs + 2 * L::TILE);

  const int t0 = blockIdx.x * warps * 16, h = blockIdx.y, b = blockIdx.z;
  const size_t col = (size_t)h * DH;
  const __nv_bfloat16* kg = k + (size_t)b * S * ld + col;
  const __nv_bfloat16* vg = v + (size_t)b * S * ld + col;
  const float* kb = key_bias + (size_t)b * S;
  const int ntiles = (S + TK - 1) / TK;
  // the probs form walks the key tiles twice (see the note at the top)
  const int steps = PROBS ? 2 * ntiles : ntiles;

  // K, V and the key bias of step it's tile, all asynchronous (a plain load
  // of the bias would stall its threads, and the barrier after them
  // everyone); the probs form's first sweep needs no V
  auto load_kv = [&](int it, int buf) {
    const int s0 = (PROBS ? it % ntiles : it) * TK;
    load_rows<DH>(ks + buf * L::TILE, kg + (size_t)s0 * ld, ld, S - s0, TK);
    if (!PROBS || it >= ntiles)
      load_rows<DH>(vs + buf * L::TILE, vg + (size_t)s0 * ld, ld, S - s0, TK);
    for (int i = threadIdx.x; i < TK; i += blockDim.x) {
      const bool ok = s0 + i < S;
      cp_async4(bs + buf * TK + i, ok ? kb + s0 + i : kb, ok ? 4 : 0);
    }
  };
  load_rows<DH>(qs, q + ((size_t)b * Tq + t0) * ld + col, ld, Tq - t0, warps * 16);
  load_kv(0, 0);
  evlm::cp_async_commit();

  // lane owns rows r = lane / 4 and r + 8 of the warp's 16, and in every
  // 8-column block the columns c2, c2 + 1
  const int c2 = 2 * (lane % 4);
  const bool active = t0 + warp * 16 < Tq;
  uint32_t qf[DH / 16][4];
  float o[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  // the probs form: this lane's rows of the maps (r = lane / 4, r + 8)
  const int pr = t0 + warp * 16 + lane / 4;
  float* prow0 = PROBS ? probs + ((size_t)(b * gridDim.y + h) * Tq + pr) * pitch : nullptr;
  float* prow1 = PROBS ? prow0 + (size_t)8 * pitch : nullptr;

  for (int it = 0; it < steps; ++it) {
    const int buf = it & 1;
    const int j = PROBS ? it % ntiles : it;
    if (it + 1 < steps) {
      load_kv(it + 1, buf ^ 1);
      evlm::cp_async_commit();
      evlm::cp_async_wait<1>();
    } else {
      evlm::cp_async_wait<0>();
    }
    __syncthreads();
    // a warp whose 16 rows all lie past Tq only helps load and sync
    if (active) {
      if (it == 0) {
        const __nv_bfloat16* qw = qs + (warp * 16 + lane % 16) * L::LD + (lane / 16) * 8;
#pragma unroll
        for (int kc = 0; kc < DH / 16; ++kc) ldsm_x4(qf[kc], qw + kc * 16);
      }

      // scores [16, TK] = Q K^T, in registers
      float s[TK / 8][4];
#pragma unroll
      for (int i = 0; i < TK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
      const __nv_bfloat16* kt =
          ks + buf * L::TILE + ((lane / 16) * 8 + lane % 8) * L::LD + ((lane / 8) % 2) * 8;
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc) {
#pragma unroll
        for (int np = 0; np < TK / 16; ++np) {
          uint32_t r[4];
          ldsm_x4(r, kt + np * 16 * L::LD + kc * 16);
          mma16816(s[2 * np], qf[kc], r[0], r[1]);
          mma16816(s[2 * np + 1], qf[kc], r[2], r[3]);
        }
      }

      // online softmax over this tile, f32; keys past S (only in the last
      // tile) get -inf
      const float* bt = bs + buf * TK + c2;
      const int valid = S - j * TK;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < TK / 8; ++nb) {
        const float2 bb = *reinterpret_cast<const float2*>(bt + nb * 8);
        s[nb][0] = s[nb][0] * scale + bb.x;
        s[nb][1] = s[nb][1] * scale + bb.y;
        s[nb][2] = s[nb][2] * scale + bb.x;
        s[nb][3] = s[nb][3] * scale + bb.y;
        if (valid < TK) {
          if (nb * 8 + c2 >= valid) s[nb][0] = s[nb][2] = -INFINITY;
          if (nb * 8 + c2 + 1 >= valid) s[nb][1] = s[nb][3] = -INFINITY;
        }
        mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      if constexpr (PROBS) {
        if (it < ntiles) {
          // sweep 1: each row's running max and (lane-partial) sum only
          const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
          float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
          for (int nb = 0; nb < TK / 8; ++nb) {
            ps0 += expf(s[nb][0] - mn0) + expf(s[nb][1] - mn0);
            ps1 += expf(s[nb][2] - mn1) + expf(s[nb][3] - mn1);
          }
          l0 = l0 * expf(m0 - mn0) + ps0;
          l1 = l1 * expf(m1 - mn1) + ps1;
          m0 = mn0;
          m1 = mn1;
          if (it == ntiles - 1) {  // the rows' sums, then their inverses
#pragma unroll
            for (int x = 1; x <= 2; x <<= 1) {
              l0 += __shfl_xor_sync(0xffffffffu, l0, x);
              l1 += __shfl_xor_sync(0xffffffffu, l1, x);
            }
            l0 = 1.0f / l0;
            l1 = 1.0f / l1;
          }
        } else {
          // sweep 2: the normalised p, written in f32 and rounded to bf16
          // for P.V; l0 / l1 hold the inverse sums
          uint32_t pf[TK / 16][4];
          const int c0 = j * TK + c2;
          const bool row0 = pr < Tq, row1 = pr + 8 < Tq;
#pragma unroll
          for (int nb = 0; nb < TK / 8; ++nb) {
            const float p0 = expf(s[nb][0] - m0) * l0, p1 = expf(s[nb][1] - m0) * l0;
            const float p2 = expf(s[nb][2] - m1) * l1, p3 = expf(s[nb][3] - m1) * l1;
            const int c = c0 + nb * 8;
            if (c + 1 < S) {
              if (row0) *reinterpret_cast<float2*>(prow0 + c) = make_float2(p0, p1);
              if (row1) *reinterpret_cast<float2*>(prow1 + c) = make_float2(p2, p3);
            } else if (c < S) {
              if (row0) prow0[c] = p0;
              if (row1) prow1[c] = p2;
            }
            pf[nb / 2][(nb % 2) * 2] = pack_bf16(p0, p1);
            pf[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(p2, p3);
          }
          const __nv_bfloat16* vt =
              vs + buf * L::TILE + (lane % 8 + ((lane / 8) % 2) * 8) * L::LD + (lane / 16) * 8;
#pragma unroll
          for (int kc = 0; kc < TK / 16; ++kc) {
#pragma unroll
            for (int dp = 0; dp < DH / 16; ++dp) {
              uint32_t r[4];
              ldsm_x4_trans(r, vt + kc * 16 * L::LD + dp * 16);
              mma16816(o[2 * dp], pf[kc], r[0], r[1]);
              mma16816(o[2 * dp + 1], pf[kc], r[2], r[3]);
            }
          }
        }
      } else {
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: the tile holds a real key
      const float a0 = __expf(m0 - mn0), a1 = __expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      // P in the A-operand layout of P.V: k16 chunk kc is score blocks 2kc, 2kc+1
      uint32_t pf[TK / 16][4];
      float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
      for (int nb = 0; nb < TK / 8; ++nb) {
        const float p0 = __expf(s[nb][0] - mn0), p1 = __expf(s[nb][1] - mn0);
        const float p2 = __expf(s[nb][2] - mn1), p3 = __expf(s[nb][3] - mn1);
        ps0 += p0 + p1;
        ps1 += p2 + p3;
        pf[nb / 2][(nb % 2) * 2] = pack_bf16(p0, p1);
        pf[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(p2, p3);
      }
      l0 = l0 * a0 + ps0;
      l1 = l1 * a1 + ps1;
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) {
        o[nd][0] *= a0;
        o[nd][1] *= a0;
        o[nd][2] *= a1;
        o[nd][3] *= a1;
      }

      // O [16, DH] += P V
      const __nv_bfloat16* vt =
          vs + buf * L::TILE + (lane % 8 + ((lane / 8) % 2) * 8) * L::LD + (lane / 16) * 8;
#pragma unroll
      for (int kc = 0; kc < TK / 16; ++kc) {
#pragma unroll
        for (int dp = 0; dp < DH / 16; ++dp) {
          uint32_t r[4];
          ldsm_x4_trans(r, vt + kc * 16 * L::LD + dp * 16);
          mma16816(o[2 * dp], pf[kc], r[0], r[1]);
          mma16816(o[2 * dp + 1], pf[kc], r[2], r[3]);
        }
      }
      }  // !PROBS
    }
    __syncthreads();  // this buffer is the next iteration's load target
  }

  const float gate = gates ? load1(gates, gates16, h) : 1.0f;
  float f0 = gate, f1 = gate;  // the probs form's O is normalised already
  if constexpr (!PROBS) {
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, x);
      l1 += __shfl_xor_sync(0xffffffffu, l1, x);
    }
    f0 = gate / l0;
    f1 = gate / l1;
  }
  // stage the warp's 16 context rows where its Q rows were, then store
  // them 16 bytes per lane
  __nv_bfloat16* ow = qs + warp * 16 * L::LD;
  const int r = lane / 4;
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) {
    *reinterpret_cast<__nv_bfloat162*>(ow + r * L::LD + nd * 8 + c2) =
        __floats2bfloat162_rn(o[nd][0] * f0, o[nd][1] * f0);
    *reinterpret_cast<__nv_bfloat162*>(ow + (r + 8) * L::LD + nd * 8 + c2) =
        __floats2bfloat162_rn(o[nd][2] * f1, o[nd][3] * f1);
  }
  __syncwarp();
  constexpr int CH = DH / 8;
  for (int c = lane; c < 16 * CH; c += 32) {
    const int rr = c / CH, d = (c % CH) * 8;
    const int t = t0 + warp * 16 + rr;
    if (t < Tq)
      *reinterpret_cast<uint4*>(out + ((size_t)b * Tq + t) * ld + col + d) =
          *reinterpret_cast<const uint4*>(ow + rr * L::LD + d);
  }
}

template <int DH, bool PROBS>
cudaError_t launch(const void* q, const void* k, const void* v, const float* key_bias,
                   const void* gates, bool gates16, void* out, float* probs, int pitch,
                   int batch, int Tq, int S, int heads, int ld, float scale,
                   cudaStream_t stream) {
  // a 128-row query tile for long query runs, else just enough 16-row warps
  const int warps = Tq > 64 ? MAX_WARPS : (Tq + 15) / 16;
  static DeviceCache cache;
  int sms = 0;
  cudaError_t e = once_per_device(cache, reinterpret_cast<const void*>(attn_core_kernel<DH, PROBS>),
                                  static_cast<int>(Layout<DH>::bytes(MAX_WARPS)), &sms);
  if (e != cudaSuccess) return e;
  dim3 grid((Tq + warps * 16 - 1) / (warps * 16), heads, batch);
  attn_core_kernel<DH, PROBS><<<grid, warps * 32, Layout<DH>::bytes(warps), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), key_bias, gates, gates16,
      static_cast<__nv_bfloat16*>(out), probs, pitch, Tq, S, ld, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dh(const void* q, const void* k, const void* v, const float* key_bias,
                      const void* gates, bool gates16, void* out, float* probs, int pitch,
                      int batch, int Tq, int S, int heads, int ld, float scale,
                      cudaStream_t stream) {
  return probs ? launch<DH, true>(q, k, v, key_bias, gates, gates16, out, probs, pitch, batch,
                                  Tq, S, heads, ld, scale, stream)
               : launch<DH, false>(q, k, v, key_bias, gates, gates16, out, nullptr, 0, batch,
                                   Tq, S, heads, ld, scale, stream);
}

}  // namespace
}  // namespace attn_impl
}  // namespace evlm

namespace evlm {

// q/out [batch*Tq, ld], k/v [batch*S, ld] bf16 with ld = heads*head_dim,
// 16-byte aligned; key_bias [batch, S] f32; gates [heads] bf16 (gates16)
// or f32, or null for all ones. head_dim is 32, 64 or 128. probs (or null):
// the probs form also writes the pre-gate f32 probabilities [batch, heads,
// Tq, S] with rows `pitch` floats apart (pitch >= S, even; 8-byte aligned).
static inline cudaError_t attn_core(const void* q, const void* k, const void* v,
                                    const float* key_bias, const void* gates, bool gates16,
                                    void* out, int batch, int Tq, int S, int heads, int head_dim,
                                    float scale, cudaStream_t s, float* probs = nullptr,
                                    int pitch = 0) {
  using attn_impl::launch_dh;
  if (batch <= 0 || Tq <= 0 || S <= 0 || heads <= 0 ||
      (probs && (pitch < S || pitch % 2 || reinterpret_cast<uintptr_t>(probs) % 8)))
    return cudaErrorInvalidValue;
  const int ld = heads * head_dim;
  switch (head_dim) {
    case 32:
      return launch_dh<32>(q, k, v, key_bias, gates, gates16, out, probs, pitch, batch, Tq, S,
                           heads, ld, scale, s);
    case 64:
      return launch_dh<64>(q, k, v, key_bias, gates, gates16, out, probs, pitch, batch, Tq, S,
                           heads, ld, scale, s);
    case 128:
      return launch_dh<128>(q, k, v, key_bias, gates, gates16, out, probs, pitch, batch, Tq, S,
                            heads, ld, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace evlm
