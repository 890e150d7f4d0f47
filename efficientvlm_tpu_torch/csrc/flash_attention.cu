// Bare attention core over already projected q/k/v: out = softmax(bf16(q *
// scale) k^T + bias) v per (batch row, head). One C entry serves both TPU
// kernels of efficientvlm_tpu/ops/pallas_attention.py:
//   - _flash_attention_padded (bodies _kernel_vec and _kernel_mat): groups =
//     1, the bias a key vector [B|1, Tk] or a matrix [B|1, Tq, Tk];
//   - _flash_attention_grouped_padded: q [Bk*G, H, Tq, dh] with each group's
//     G query rows side by side share k/v [Bk, H, S, dh] and one key vector;
//     the group is folded into the query rows (row r of a (b, h) is group
//     r / Tq, position r % Tq), so K/V are never repeated in memory.
// As in the TPU kernels the scores and the softmax are f32, the weights are
// rounded to bf16 before P.V, and P.V accumulates in f32. q is read through
// its strides (the projection's [B, T, H, dh] view), multiplied by `scale`
// and rounded to bf16 once it is in registers (the rounding of the caller's
// bf16 q * scale); k and v are read through their strides; the output is
// written [B*G, Tq, H, dh], the layout that merging the heads turns into a
// view.
//
// What bounds it on the H100: bytes, and the latency of getting them. 4*Tq*
// Tk*dh FLOP per (row, head) against one read of q, k, v and the bias: a
// caption cross step (Tq = 1 over 577 image keys, 16 images x 3 beams, 12
// heads) moves 28 MB (8.5 us at 3.35 TB/s) for 0.1 GFLOP; answer scoring
// (6 x 6 per (row, head), 24,576 of them) moves 76 MB in pieces of 3 KB.
// So the design keeps many loads in flight and spends nothing on idle
// lanes or on waiting:
//   - the unit of work is a piece (16 folded query rows of one (b, h)) over
//     one split of its keys. Warps are independent (4 per block,
//     each with its own shared memory, no block barrier) and persistent:
//     the grid holds one wave of warps, and each warp walks a contiguous
//     range of units, tile by tile, loading the next tile (its q rows, K, V
//     and bias) with cp.async while it computes this one. Tiny problems thus
//     pack many (b, h) per warp with their loads overlapped, and the warps
//     of one (b, h)'s row chunks read its K/V through L1;
//   - key tiles are 16 or 32 keys (16 for dh 128 and for Tk <= 16), so 6,
//     20 or 25 keys waste at most one 8-key column block of the product;
//   - Q K^T and P V run on mma.sync m16n8k16 with the scores, the softmax
//     and P in registers (the core of attn_core.cuh);
//   - split-KV (flash-decoding) when the (b, h) are too few to fill the card
//     and Tk is long; the wrapper picks the keys per split. Each unit writes
//     its split's partial (m, l, un-normalised O) in f32 to a workspace; the
//     last unit of a piece to arrive, through an atomic ticket that it
//     resets to 0, merges the partials in the same launch, all rows and
//     splits at once, so nothing is zeroed per call and no second launch is
//     needed.
// Dispatch (ops/flash_attention.py picks the split, launch_dh the tile),
// from the card's own measurements (chip_smoke.py's device times and split
// sweep; H100 80GB HBM3, 700 W):
//   - split only when there are fewer than 3,168 pieces of 16 rows (3 per
//     resident warp: two 4-warp blocks of 108-124 KB fit on each of 132
//     SMs) and Tk > 128, in splits of 128 keys: at the one-row caption
//     cross steps (577 keys; 28 MB, bound 8.5 us) 128 keys ran 12.5-14.2 us
//     of device time, 64 keys 12.1-17.4, 192 keys 13.2-14.9 and no split
//     21.4-22.8; at the 12-row beam prefill 192 keys ran 18.6-19.6 us
//     against 19.7-20.7 at 128. A split of 128 keys is 4 tiles that one
//     warp streams while the merge stays 5 partials deep;
//   - key tiles of 32 (16 at dh 128 for shared memory, and for Tk <= 16):
//     answer scoring self (6 x 6, 24,576 (b, h); 76 MB, bound 22.6 us) ran
//     36.6-38.2 us, grouped scoring (G 128, Tq 6, S 25; 39 MB, bound 11.6
//     us) 25.2-26.9 us, the 20-slot self-attention steps 3.0-4.2 us, where
//     launch latency is most of it (bound under 1.1 us).
// The keys-in-M form (S^T = K q^T, so 1-3 query rows fill an n = 8 operand)
// was weighed and not taken: its P comes out of the accumulator transposed
// against the operand layout of the second product, and the 13-15 idle rows
// of a 16-row tile cost tensor-core time that these bytes-bound shapes have
// to spare (well under a microsecond at the caption cross step).
//
// Invariants of the masking: keys past a split's end (and past Tk) get
// -inf; the caller masks with -1e9, which stays finite. Every split and
// every key tile starts at a real key, so a row's running max is finite
// from the first tile on and no weight is exp(-inf - -inf). A split whose
// keys are all masked has m near -1e9: once the merge rescales it by
// exp(m_split - m_row) it contributes nothing, unless every key of the row
// is masked, where the result is the softmax over the masked keys, as in
// the unsplit kernel and the plain version.
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

using evlm::ldsm_x4;
using evlm::ldsm_x4_trans;
using evlm::mma16816;
using evlm::pack_bf16;
using evlm::smem_u32;

constexpr int WARPS = 4;        // warps per block, each on its own units
constexpr int MAX_SPLITS = 30;  // the merge's scratch holds 16 rows x 30 splits

struct Args {
  const __nv_bfloat16* q;  // [batch*groups, heads, tq, DH] through q_b, q_h, q_t
  const __nv_bfloat16* k;  // [batch, heads, tk, DH] through k_b, k_h, k_t
  const __nv_bfloat16* v;  // [batch, heads, tk, DH] through v_b, v_h, v_t
  const float* bias;       // bias + b*bias_b + t*bias_t + key, or nullptr
  __nv_bfloat16* out;      // [batch*groups, tq, heads, DH]
  float* ws;               // split partials: O [pieces*nsplit*16, DH], then (m, l)
  int* tickets;            // [pieces] arrivals per piece, 0 between launches
  int groups, heads, tq, tk, rows, chunks, nsplit, split_keys, pieces, per_warp;
  int q_b, q_h, q_t, k_b, k_h, k_t, v_b, v_h, v_t, bias_b, bias_t;
  float scale;
};

// a unit: 16 folded query rows (row chunk) of one (b, h) over one key split
struct Unit {
  int b, h, chunk, split, piece, key0, key_end, ntiles, nrows;
};

template <int TK>
__device__ __forceinline__ void set_keys(const Args& a, Unit& x) {
  x.piece = (x.b * a.heads + x.h) * a.chunks + x.chunk;
  x.key0 = x.split * a.split_keys;  // < tk: every split starts at a real key
  x.key_end = min(x.key0 + a.split_keys, a.tk);
  x.ntiles = (x.key_end - x.key0 + TK - 1) / TK;
  x.nrows = min(16, a.rows - x.chunk * 16);
}

// units in order: row chunk fastest, then split, head, batch row, so that a
// warp's consecutive units share a (b, h) and its K/V where they can
template <int TK>
__device__ __forceinline__ Unit unit_of(const Args& a, int u) {
  Unit x;
  x.chunk = u % a.chunks;
  x.split = (u / a.chunks) % a.nsplit;
  const int bh = u / (a.chunks * a.nsplit);
  x.h = bh % a.heads;
  x.b = bh / a.heads;
  set_keys<TK>(a, x);
  return x;
}

template <int TK>
__device__ __forceinline__ Unit next_unit(const Args& a, Unit x) {
  if (++x.chunk == a.chunks) {
    x.chunk = 0;
    if (++x.split == a.nsplit) {
      x.split = 0;
      if (++x.h == a.heads) {
        x.h = 0;
        ++x.b;
      }
    }
  }
  set_keys<TK>(a, x);
  return x;
}

// a warp's shared memory: two K/V stages [K TK x LD | V TK x LD] bf16, two
// q stages [q 16 x LD bf16 | bias bias_rows x TK f32] (1 bias row for a key
// vector, 16 for a matrix), and with splits the merge's scratch of 16 rows
// x MAX_SPLITS (m, l) pairs
template <int DH, int TK>
struct Layout {
  static constexpr int LD = DH + 8;        // bf16 row stride: ldmatrix rows on distinct banks
  static constexpr int KV = 2 * TK * LD;   // bf16 per K/V stage
  static constexpr int SCRATCH = 16 * MAX_SPLITS * 2;  // floats
  __host__ __device__ static constexpr int qb(int bias_rows) {  // bf16 per q stage
    return 16 * LD + 2 * bias_rows * TK;
  }
  __host__ __device__ static constexpr size_t stages_bytes(int bias_rows) {
    return sizeof(__nv_bfloat16) * (2 * KV + 2 * qb(bias_rows));
  }
  __host__ __device__ static constexpr size_t warp_bytes(int bias_rows, bool split) {
    return stages_bytes(bias_rows) + (split ? sizeof(float) * SCRATCH : 0);
  }
};

// 4- and 16-byte asynchronous global->shared copies through L1
__device__ __forceinline__ void cp_async4_ca(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async16_ca(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" :: "r"(smem_u32(dst)), "l"(src));
}

// a step's q stage: the unit's q rows on its first tile, and the bias of
// the tile's keys. Only real rows and keys are copied: the rest of a stage
// keeps earlier (finite) values, which only rows past the unit's rows and
// keys masked to -inf ever meet.
template <int DH, int TK>
__device__ __forceinline__ void issue_q(const Args& a, const Unit& x, int tile,
                                        __nv_bfloat16* qb, int lane) {
  constexpr int LD = DH + 8, CH = DH / 8;  // 16-byte chunks per row
  const int s0 = x.key0 + tile * TK, valid = min(TK, x.key_end - s0);
  if (tile == 0) {
    for (int c = lane; c < x.nrows * CH; c += 32) {
      const int r = c / CH, d = (c % CH) * 8, row = x.chunk * 16 + r;
      int n = x.b, t = row;  // one group: the row is the position
      if (a.groups > 1) {
        const int g = row / a.tq;
        n = x.b * a.groups + g;
        t = row - g * a.tq;
      }
      cp_async16_ca(qb + r * LD + d,
                    a.q + (size_t)n * a.q_b + (size_t)x.h * a.q_h + (size_t)t * a.q_t + d);
    }
  }
  if (a.bias != nullptr) {
    float* bs = reinterpret_cast<float*>(qb + 16 * LD);
    const float* src = a.bias + (size_t)x.b * a.bias_b + s0;
    if (a.bias_t == 0) {
      for (int c = lane; c < valid; c += 32) cp_async4_ca(bs + c, src + c);
    } else {  // a matrix (one group): row r of the chunk is position chunk*16 + r
      for (int c = lane; c < x.nrows * TK; c += 32) {
        const int r = c / TK, key = c % TK;
        if (key < valid) cp_async4_ca(bs + c, src + (size_t)(x.chunk * 16 + r) * a.bias_t + key);
      }
    }
  }
}

// a step's K/V stage: the tile's real keys
template <int DH, int TK>
__device__ __forceinline__ void issue_kv(const Args& a, const Unit& x, int tile,
                                         __nv_bfloat16* kv, int lane) {
  constexpr int LD = DH + 8, CH = DH / 8;
  const int s0 = x.key0 + tile * TK, valid = min(TK, x.key_end - s0);
  const __nv_bfloat16* kg = a.k + (size_t)x.b * a.k_b + (size_t)x.h * a.k_h + (size_t)s0 * a.k_t;
  const __nv_bfloat16* vg = a.v + (size_t)x.b * a.v_b + (size_t)x.h * a.v_h + (size_t)s0 * a.v_t;
  for (int c = lane; c < valid * CH; c += 32) {
    const int r = c / CH, d = (c % CH) * 8;
    cp_async16_ca(kv + r * LD + d, kg + (size_t)r * a.k_t + d);
    cp_async16_ca(kv + (TK + r) * LD + d, vg + (size_t)r * a.v_t + d);
  }
}

template <int DH, int TK>
__global__ void __launch_bounds__(WARPS * 32) flash_kernel(Args a) {
  using L = Layout<DH, TK>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int u = (blockIdx.x * WARPS + warp) * a.per_warp;
  const int u_end = min(u + a.per_warp, a.pieces * a.nsplit);
  if (u >= u_end) return;  // no block barrier anywhere: idle warps just leave
  const int bias_rows = a.bias_t != 0 ? 16 : 1, qbn = L::qb(bias_rows);
  unsigned char* wbase = smem + warp * L::warp_bytes(bias_rows, a.nsplit > 1);
  __nv_bfloat16* kvs = reinterpret_cast<__nv_bfloat16*>(wbase);
  __nv_bfloat16* qbs = kvs + 2 * L::KV;
  float* scratch = reinterpret_cast<float*>(qbs + 2 * qbn);
  {  // zero the stages once, so that what no copy ever writes is finite
    uint4* z = reinterpret_cast<uint4*>(wbase);
    for (int i = lane; i < (int)(L::stages_bytes(bias_rows) / 16); i += 32)
      z[i] = make_uint4(0, 0, 0, 0);
    __syncwarp();
  }

  // lane owns rows r and r + 8 of the unit's 16, and in every 8-column block
  // the columns c2, c2 + 1 (the mma.sync accumulator layout)
  const int r = lane / 4, c2 = 2 * (lane % 4);
  Unit x = unit_of<TK>(a, u);
  int tile = 0, qs = 0, ks = 0;
  issue_q<DH, TK>(a, x, 0, qbs, lane);
  issue_kv<DH, TK>(a, x, 0, kvs, lane);
  evlm::cp_async_commit();

  uint32_t qf[DH / 16][4];
  float o[DH / 8][4];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  while (true) {
    // the next step: the next tile of this unit or the first of the next
    // unit, whose K/V stay where they are when only the row chunk changes
    Unit nx = x;
    int ntile = tile + 1;
    const bool more = ntile < x.ntiles || u + 1 < u_end;
    bool reuse = false;
    if (ntile == x.ntiles && more) {
      nx = next_unit<TK>(a, x);
      ntile = 0;
      reuse = x.ntiles == 1 && nx.b == x.b && nx.h == x.h && nx.split == x.split;
    }
    const int nks = reuse ? ks : ks ^ 1;
    if (more) {
      issue_q<DH, TK>(a, nx, ntile, qbs + (qs ^ 1) * qbn, lane);
      if (!reuse) issue_kv<DH, TK>(a, nx, ntile, kvs + nks * L::KV, lane);
      evlm::cp_async_commit();
      evlm::cp_async_wait<1>();
    } else {
      evlm::cp_async_wait<0>();
    }
    __syncwarp();
    const __nv_bfloat16* qb = qbs + qs * qbn;
    const __nv_bfloat16* kv = kvs + ks * L::KV;

    if (tile == 0) {  // a new unit: its q fragments, scaled, and a fresh softmax
      const __nv_bfloat16* qw = qb + (lane % 16) * LD + (lane / 16) * 8;
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc) {
        ldsm_x4(qf[kc], qw + kc * 16);
#pragma unroll
        for (int e = 0; e < 4; ++e)  // bf16 pair -> f32 exactly, times scale, rounded back
          qf[kc][e] = pack_bf16(__uint_as_float(qf[kc][e] << 16) * a.scale,
                                __uint_as_float(qf[kc][e] & 0xffff0000u) * a.scale);
      }
#pragma unroll
      for (int i = 0; i < DH / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
      m0 = m1 = -INFINITY;
      l0 = l1 = 0.0f;
    }

    // scores [16, TK] = Q K^T, in registers
    float s[TK / 8][4];
#pragma unroll
    for (int i = 0; i < TK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
    const __nv_bfloat16* kt =
        kv + ((lane / 16) * 8 + lane % 8) * LD + ((lane / 8) % 2) * 8;
#pragma unroll
    for (int kc = 0; kc < DH / 16; ++kc) {
#pragma unroll
      for (int np = 0; np < TK / 16; ++np) {
        uint32_t y[4];
        ldsm_x4(y, kt + np * 16 * LD + kc * 16);
        mma16816(s[2 * np], qf[kc], y[0], y[1]);
        mma16816(s[2 * np + 1], qf[kc], y[2], y[3]);
      }
    }

    // bias, -inf past the split's end, online softmax over this tile, f32
    const int valid = x.key_end - (x.key0 + tile * TK);
    const float* bs = reinterpret_cast<const float*>(qb + 16 * LD);
    const float* ba = bs + (bias_rows == 16 ? r * TK : 0) + c2;
    const float* bb = bs + (bias_rows == 16 ? (r + 8) * TK : 0) + c2;
    const bool has_bias = a.bias != nullptr;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < TK / 8; ++nb) {
      if (has_bias) {
        const float2 za = *reinterpret_cast<const float2*>(ba + nb * 8);
        const float2 zb = *reinterpret_cast<const float2*>(bb + nb * 8);
        s[nb][0] += za.x;
        s[nb][1] += za.y;
        s[nb][2] += zb.x;
        s[nb][3] += zb.y;
      }
      if (nb * 8 + c2 >= valid) s[nb][0] = s[nb][2] = -INFINITY;
      if (nb * 8 + c2 + 1 >= valid) s[nb][1] = s[nb][3] = -INFINITY;
      mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
    }
#pragma unroll
    for (int y = 1; y <= 2; y <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, y));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, y));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: the tile's first key is real
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

    // O [16, DH] += P V (rows of V past the split's end hold stale values of
    // earlier tiles, or the zeros the stage began with: finite, so their
    // weights P = exp(-inf) = 0 cancel them)
    const __nv_bfloat16* vt =
        kv + (TK + lane % 8 + ((lane / 8) % 2) * 8) * LD + (lane / 16) * 8;
#pragma unroll
    for (int kc = 0; kc < TK / 16; ++kc) {
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t y[4];
        ldsm_x4_trans(y, vt + kc * 16 * LD + dp * 16);
        mma16816(o[2 * dp], pf[kc], y[0], y[1]);
        mma16816(o[2 * dp + 1], pf[kc], y[2], y[3]);
      }
    }

    if (tile == x.ntiles - 1) {  // the unit is done
      float t0 = l0, t1 = l1;
#pragma unroll
      for (int y = 1; y <= 2; y <<= 1) {
        t0 += __shfl_xor_sync(0xffffffffu, t0, y);
        t1 += __shfl_xor_sync(0xffffffffu, t1, y);
      }
      const int row0 = x.chunk * 16;
      auto out_row = [&](int row) {
        const int g = row / a.tq, t = row - g * a.tq;
        return a.out + (((size_t)(x.b * a.groups + g) * a.tq + t) * a.heads + x.h) * DH;
      };
      if (a.nsplit == 1) {
        const float f0 = 1.0f / t0, f1 = 1.0f / t1;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (row0 + r + 8 * half >= a.rows) continue;
          __nv_bfloat16* dst = out_row(row0 + r + 8 * half) + c2;
#pragma unroll
          for (int nd = 0; nd < DH / 8; ++nd)
            *reinterpret_cast<__nv_bfloat162*>(dst + nd * 8) =
                half ? __floats2bfloat162_rn(o[nd][2] * f1, o[nd][3] * f1)
                     : __floats2bfloat162_rn(o[nd][0] * f0, o[nd][1] * f0);
        }
      } else {
        // this split's partial (m, l, un-normalised O) in f32, real rows only
        const size_t part = (size_t)x.piece * a.nsplit + x.split;
        float* ws_o = a.ws;
        float* ws_ml = a.ws + (size_t)a.pieces * a.nsplit * 16 * DH;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int rr = r + 8 * half;
          if (row0 + rr >= a.rows) continue;
          float* dst = ws_o + (part * 16 + rr) * DH + c2;
#pragma unroll
          for (int nd = 0; nd < DH / 8; ++nd)
            *reinterpret_cast<float2*>(dst + nd * 8) =
                half ? make_float2(o[nd][2], o[nd][3]) : make_float2(o[nd][0], o[nd][1]);
          if (c2 == 0)
            *reinterpret_cast<float2*>(ws_ml + (part * 16 + rr) * 2) =
                half ? make_float2(m1, t1) : make_float2(m0, t0);
        }
        // the last unit of this piece to arrive merges all its splits
        __threadfence();
        __syncwarp();
        int ticket = 0;
        if (lane == 0) ticket = atomicAdd(a.tickets + x.piece, 1);
        ticket = __shfl_sync(0xffffffffu, ticket, 0);
        if (ticket == a.nsplit - 1) {
          __threadfence();
          const int nrows = x.nrows, ns = a.nsplit;
          const size_t first = (size_t)x.piece * ns;
          // (m, l) of every (row, split) into the scratch, all loads at once
          float* sc = scratch;
          for (int i = lane; i < nrows * ns; i += 32) {
            const int rr = i / ns, sp = i - rr * ns;
            const float2 ml =
                __ldcg(reinterpret_cast<const float2*>(ws_ml + ((first + sp) * 16 + rr) * 2));
            sc[2 * i] = ml.x;
            sc[2 * i + 1] = ml.y;
          }
          __syncwarp();
          if (lane < nrows) {  // per row: each split's weight exp(m_s - M) / L
            float* row = sc + 2 * lane * ns;
            float mrow = -INFINITY, lrow = 0.0f;
            for (int sp = 0; sp < ns; ++sp) mrow = fmaxf(mrow, row[2 * sp]);
            // a split whose keys are all masked gets exp(-1e9 - mrow) = 0
            for (int sp = 0; sp < ns; ++sp) lrow += __expf(row[2 * sp] - mrow) * row[2 * sp + 1];
            for (int sp = 0; sp < ns; ++sp) row[2 * sp] = __expf(row[2 * sp] - mrow) / lrow;
          }
          __syncwarp();
          // the weighted sum of the partials: lanes over (row, column pair)
          for (int i = lane; i < nrows * (DH / 2); i += 32) {
            const int rr = i / (DH / 2), c = 2 * (i - rr * (DH / 2));
            const float* wrow = sc + 2 * rr * ns;
            float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll 4
            for (int sp = 0; sp < ns; ++sp) {
              const float2 po = __ldcg(
                  reinterpret_cast<const float2*>(ws_o + ((first + sp) * 16 + rr) * DH + c));
              acc.x += wrow[2 * sp] * po.x;
              acc.y += wrow[2 * sp] * po.y;
            }
            *reinterpret_cast<__nv_bfloat162*>(out_row(row0 + rr) + c) =
                __floats2bfloat162_rn(acc.x, acc.y);
          }
          if (lane == 0) a.tickets[x.piece] = 0;  // ready for the next launch
        }
      }
    }
    __syncwarp();  // this stage is the load target two steps on
    if (!more) break;
    if (ntile == 0) ++u;
    x = nx;
    tile = ntile;
    qs ^= 1;
    ks = nks;
  }
}

struct Device {
  int sms = 0;
  int blocks[2][2] = {};  // resident blocks per SM by [matrix bias][splits]
};

template <int DH, int TK>
cudaError_t launch(Args a, cudaStream_t stream) {
  using L = Layout<DH, TK>;
  const bool matrix = a.bias_t != 0, split = a.nsplit > 1;
  if (a.nsplit > MAX_SPLITS) return cudaErrorInvalidValue;
  // set once per device and template instance: the shared-memory limit, the
  // SM count, and how many blocks fit on an SM
  static Device devices[16];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 16) return cudaErrorInvalidDevice;
  Device& d = devices[dev];
  if (d.sms == 0) {
    e = cudaFuncSetAttribute(flash_kernel<DH, TK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(WARPS * L::warp_bytes(16, true)));
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    for (int m = 0; m < 4 && e == cudaSuccess; ++m) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &d.blocks[m / 2][m % 2], flash_kernel<DH, TK>, WARPS * 32,
          WARPS * L::warp_bytes(m / 2 ? 16 : 1, m % 2));
      if (e == cudaSuccess && d.blocks[m / 2][m % 2] == 0) e = cudaErrorInvalidConfiguration;
    }
    if (e != cudaSuccess) {
      d.sms = 0;
      return e;
    }
  }
  // one wave of persistent warps, each over a contiguous range of units
  const long long units = (long long)a.pieces * a.nsplit;
  const long long wave = (long long)d.sms * d.blocks[matrix][split] * WARPS;
  a.per_warp = (int)((units + wave - 1) / wave);
  const long long warps = (units + a.per_warp - 1) / a.per_warp;
  flash_kernel<DH, TK><<<(unsigned)((warps + WARPS - 1) / WARPS), WARPS * 32,
                         WARPS * L::warp_bytes(matrix ? 16 : 1, split), stream>>>(a);
  return cudaGetLastError();
}

// key tile: 16 keys for dh 128 (shared memory) and where a split is that short
template <int DH>
cudaError_t launch_dh(const Args& a, cudaStream_t stream) {
  if constexpr (DH == 128) {
    return launch<DH, 16>(a, stream);
  } else {
    if (a.split_keys <= 16) return launch<DH, 16>(a, stream);
    return launch<DH, 32>(a, stream);
  }
}

}  // namespace

// out [kv_batch*groups, tq, heads, head_dim] = softmax(bf16(q * scale) k^T +
// bias) v per (batch row, head), the group folded into the query rows.
// dims holds 18 ints: kv_batch, groups, heads, tq, tk, head_dim, q_b, q_h,
// q_t, k_b, k_h, k_t, v_b, v_h, v_t, bias_b, bias_t, split_keys, in one
// buffer, so that ctypes converts one argument for them, not 18. q
// [kv_batch*groups, heads, tq, head_dim] at q + n*q_b + h*q_h + t*q_t, k/v
// [kv_batch, heads, tk, head_dim] likewise, all bf16 with unit column stride, 16-byte aligned,
// strides multiples of 8; bias f32 at bias + b*bias_b + t*bias_t + key
// (bias_t = 0: a key vector; bias_b = 0: one row for the batch; groups > 1
// takes key vectors only), or null. Keys go in splits of split_keys (= tk:
// none; at most 30 splits); with more than one split, ws holds
// kv_batch*heads*ceil(groups*tq/16) * nsplit * 16 * (head_dim + 2) floats
// and tickets kv_batch*heads*ceil(groups*tq/16) ints, zero on the first
// call. head_dim is 32, 64 or 128.
extern "C" int evlm_flash_attention(const void* q, const void* k, const void* v,
                                    const float* bias, void* out, float* ws, int* tickets,
                                    const int* dims, float scale, void* stream) {
  const int kv_batch = dims[0], groups = dims[1], heads = dims[2], tq = dims[3], tk = dims[4],
            head_dim = dims[5], bias_t = dims[16], split_keys = dims[17];
  if (kv_batch <= 0 || groups <= 0 || heads <= 0 || tq <= 0 || tk <= 0 || split_keys <= 0 ||
      split_keys > tk || (groups > 1 && bias_t != 0))
    return cudaErrorInvalidValue;
  const long long rows = (long long)groups * tq, chunks = (rows + 15) / 16;
  const long long nsplit = (tk + split_keys - 1) / split_keys;
  const long long pieces = (long long)kv_batch * heads * chunks;
  if (pieces * nsplit > INT_MAX / 2 || rows > INT_MAX) return cudaErrorInvalidValue;
  if (nsplit > 1 && (ws == nullptr || tickets == nullptr)) return cudaErrorInvalidValue;
  Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
         static_cast<const __nv_bfloat16*>(v), bias, static_cast<__nv_bfloat16*>(out), ws,
         tickets, groups, heads, tq, tk, (int)rows, (int)chunks, (int)nsplit, split_keys,
         (int)pieces, 1, dims[6], dims[7], dims[8], dims[9], dims[10], dims[11], dims[12],
         dims[13], dims[14], dims[15], bias_t, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return launch_dh<32>(a, st);
    case 64: return launch_dh<64>(a, st);
    case 128: return launch_dh<128>(a, st);
    default: return cudaErrorInvalidValue;
  }
}
