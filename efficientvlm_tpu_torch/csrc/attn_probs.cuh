// attn_probs: the probs form of the attention core at head dim 64. Per
// head, ctx = softmax(q k^T * scale + key_bias) v * gate[h] over projected q
// [B*Tq, A], k/v [B*S, A] (A = H*64, heads side by side), written as ctx
// [B*Tq, A] bf16, and the normalised, pre-gate f32 softmax maps [B, H, Tq,
// S] (rows `pitch` floats apart), which the KD taps read.
//
// Replaces the emit_probs=True instances of the bodies of
// efficientvlm_tpu/ops/pallas_fused_mha.py: _fused_kernel (self, `:119-122`)
// and _fused_cross_kernel (cross, `:244-246`), which write probs_f32 = e /
// sum(e) and round that to bf16 for P.V. The function is theirs: scores in
// f32 from bf16 q and k, times the scale, plus the f32 key bias; the f32
// softmax written as the maps; the normalised p rounded to bf16 for P.V
// with f32 accumulation; the context times gate[h], rounded to bf16.
//
// What bounds it on the H100: the maps. At the ViT shapes they are about 3x
// every other byte of the sublayer (384 MB at [24, 577], 312 MB at [8, 901])
// against 4*Tq*S*64 FLOP per (b, h) that the tensor cores finish in a
// fraction of the store time, so the kernel has to keep the store stream
// busy while it computes. Staging a row's scores costs 4*S bytes of shared
// memory, so a block holds few rows (64 at S = 577, 32 at 901): the work in
// flight on an SM is small, and a kernel whose warps wait on each other or
// on their own dependent chains leaves both the tensor cores and the store
// stream idle. attn_core's two-sweep form (shapes outside
// bindings.probs_tile) computes every score twice and stores the maps from
// registers between its products. Design:
//   - a block owns R query rows of one (b, h) and walks the S keys once, in
//     64-key tiles of K and then of V, which lane 0 of one producer warp
//     loads by TMA (3-d maps [B, S, A], 128-byte swizzle; keys past S read
//     as zeros) after Q, into rings with full / empty mbarriers, one ring per
//     residue class of tiles (three to ten 8 KB slots in all); the consumers
//     copy the key bias of every tile into shared memory with plain loads
//     while the first tiles are in flight (-inf past S), and no block
//     barrier runs inside the walk, so the consumer warps drift apart;
//     blocks are not persistent: a block serves one item and exits;
//   - each 16-row group is served by KS consumer warps (bindings.probs_tile
//     picks R and KS), warp k taking the whole tiles j = k mod KS: Q K^T
//     with mma.sync m16n8k16 on ldmatrix fragments (Q by TMA once, its
//     fragments kept in registers), then the scaled, biased scores
//     exponentiated once against the warp's running row max (online
//     softmax), the f32 e staged in shared memory in the accumulator
//     layout, [R, 32] per 32-key chunk with TMA's 128-byte swizzle
//     (conflict-free float2 writes), the tile's running max beside it;
//   - after its last K tile the group's KS warps merge their (max, sum)
//     through shared memory (a named barrier of the group); the second walk
//     normalises each tile's two chunks in place, p = e * exp(m_tile - m) /
//     l, rounds p to bf16 for P V (V through ldmatrix.trans, O in
//     registers), and hands the chunks to TMA (cp.async.bulk.tensor shared
//     -> global, a 32 x 16 box per warp and chunk, over a 3-d map of the
//     maps [B*H, Tq, S] with rows `pitch` floats apart), which clips the
//     rows past Tq; TMA writes whole 16-byte units, so the map ends at S
//     rounded down to 4 and the lanes that own the last 1-3 keys store
//     them, and no pad column is written; the stores run on while the warp
//     goes on, and lane 0 of each warp waits for their reads only before
//     the block exits;
//   - the group's KS partial contexts are summed through shared memory (the
//     rings, free once every consumer has passed a named barrier) and stored
//     with 16-byte stores.
// bindings.probs_tile takes as many rows as Tq needs, up to 128, within
// the 227 KB a block may use, with up to 5 warps a group (by a sweep on the
// card: 64 x 3 at S = 577, 32 x 5 at 901, 128 x 2 at 197); at 4 key tiles
// or fewer it picks the most warps with which two blocks share an SM, else
// one block an SM. At S <= 64 the one key tile is read once as K and once
// as V: no score is computed twice. Keys past S get -inf (e = 0); masked
// keys carry the caller's -1e9 bias, so their maps are exact zeros; a row
// sums to 1 within f32 rounding. Tried on the card and not kept (PERF.md):
// one warp per 32-key half of each tile, two blocks an SM at half the rows
// or one of 64 rows, with a cp.async ring and a block barrier a tile (the
// warps waited on each other and on their own dependent chains); one ring
// of six slots for all tiles, which at KS = 4 let a warp wait on a slot's
// next phase before the current one had landed (the parity wait then
// passes at once); persistent blocks whose producer ran ahead into the
// next item, and software pipelining of each walk (the next tile's
// products started before this tile's softmax): both slower. Measured with
// one part taken out at a time (scripts/torch_probs_probe.py): the map
// stores are 9-13% of the time, the staging traffic 5-7%, the K/V loads
// and the ring's waits nothing; what bounds the kernel is its consumer
// warps' own dependent chains, 8-16 warps an SM.
#pragma once

#include <math.h>

#include "gemm_bias.cuh"

namespace evlm {
namespace attn_probs_impl {
namespace {  // internal linkage: each .cu includes its own copy

using gemm_impl::mbar_arrive;
using gemm_impl::mbar_expect_tx;
using gemm_impl::mbar_init;
using gemm_impl::mbar_wait;

constexpr int DH = 64, TK = 64, HALF = 32;  // head dim, keys per tile, columns per chunk
constexpr int TILE_BYTES = TK * DH * 2;     // one K or V tile: 64 rows of 128 bytes
constexpr int XO_LD = DH + 8;               // f32 row stride of the context exchange
constexpr int LD_OUT = DH + 8;              // bf16 row stride of the staged context
constexpr int MAX_ROWS = 128, MAX_WARPS = 16;  // consumer warps: (rows / 16) * KS
constexpr size_t SMEM_LIMIT = 227 * 1024;   // a block's shared memory on the H100
constexpr float LOG2E = 1.4426950408889634f;

// K/V ring slots per residue class: 3 at KS <= 2 consumer warps a 16-row
// group, else 2. Each residue class of tiles has its own ring, which only
// that class's warps consume, in order: a warp then never waits on a slot's
// next phase before every consumer of its current one is done.
__host__ __device__ constexpr int slots_per(int ks) { return ks <= 2 ? 3 : 2; }

// shared memory of a block of `rows` query rows over nt key tiles, ks
// consumer warps a 16-row group (kept equal to bindings.probs_smem): the
// staged e [2 nt chunks][rows][32] f32,
// Q [rows][64] bf16, the rings [KS * slots_per][64][64] bf16, the key bias
// [nt * 64] f32, each tile's running max [rows][nt], the warps' (max, sum)
// [KS][rows], the rings' and Q's mbarriers, and 1024 bytes to align the
// staging buffer for TMA's swizzle
// floats of the rings a 16-row group's context exchange takes: its KS - 1
// f32 partials, or at KS = 1 the bf16 context rows alone
__host__ __device__ constexpr size_t exchange_stride(int ks) {
  return ks > 1 ? (size_t)(ks - 1) * 16 * XO_LD : 16 * LD_OUT / 2;
}

__host__ __device__ constexpr size_t smem_bytes(int rows, int nt, int ks) {
  return (size_t)rows * (nt * 260 + 128 + 8 * ks) + (size_t)nt * 256 +
         (size_t)ks * slots_per(ks) * (TILE_BYTES + 16) + 8 + 1024;
}

// tile t of the walk (K tiles 0..nt-1, then V tiles 0..nt-1): its residue
// class k (the warps that consume it), its slot among the KS rings and the
// round of that slot; n counts the earlier tiles of class k
struct Slot {
  int slot, round;
};
__device__ __forceinline__ Slot slot_of(int t, int nt, int ks) {
  const int j = t < nt ? t : t - nt, k = j % ks, spr = slots_per(ks);
  const int n = (t < nt ? 0 : (nt - k + ks - 1) / ks) + j / ks;
  return {k * spr + n % spr, n / spr};
}

struct ProbsParams {
  CUtensorMap q;            // [B, Tq, A] bf16, box 64 x rows x 1
  CUtensorMap k, v;         // [B, S, A] bf16, box 64 x 64 x 1
  CUtensorMap maps;         // [B*H, Tq, s4] f32, rows pitch floats apart; box 32 x 16 x 1
  float* maps_ptr;          // the same maps, for the columns s4..S-1 (plain stores)
  const float* key_bias;    // [B, S] f32
  const void* gates;        // [H] bf16 (gates16) or f32, or null (all ones)
  __nv_bfloat16* out;       // [B*Tq, A]
  int rows, ks, tq, s, s4, pitch, ld, nt, gates16;  // s4: S rounded down to a multiple of 4
  float scale;
};

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// a row of 128 bytes of a tile written by TMA with the 128-byte swizzle:
// the 16-byte unit u of row `row` sits at unit u ^ (row % 8)
__device__ __forceinline__ uint32_t swz(uint32_t tile, int row, int unit) {
  return tile + row * 128 + ((unit ^ (row & 7)) << 4);
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// the float2 at row `row`, columns col and col + 1 (col even) of a staged
// 32-column chunk: 128-byte rows whose 16-byte units are swizzled by row % 8,
// as TMA's SWIZZLE_128B reads them
__device__ __forceinline__ float2* stage_at(float* chunk, int row, int col) {
  return reinterpret_cast<float2*>(chunk + row * HALF + (((col >> 2) ^ (row & 7)) << 2) +
                                   (col & 3));
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__global__ void __launch_bounds__(32 * (MAX_WARPS + 1), 1)
attn_probs_kernel(const __grid_constant__ ProbsParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int R = p.rows, KS = p.ks, groups = R / 16, consumers = groups * KS;
  const int nt = p.nt, slots = KS * slots_per(KS);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float* stage = reinterpret_cast<float*>(base);                       // [2 nt][R][32]
  unsigned char* qs = base + (size_t)R * nt * 256;                      // [R][128 bytes]
  unsigned char* ring = qs + R * 128;                                   // [slots][8 KB]
  float* bs = reinterpret_cast<float*>(ring + slots * TILE_BYTES);      // [nt * 64]
  float* tmax = bs + nt * TK;                                           // [R][nt]
  float2* xml = reinterpret_cast<float2*>(tmax + R * nt);               // [KS][R]
  uint64_t* full = reinterpret_cast<uint64_t*>(xml + KS * R);
  uint64_t* empty = full + slots;
  uint64_t* qfull = empty + slots;

  const int t0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int active_groups = min(groups, (p.tq - t0 + 15) / 16);
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], active_groups);  // the active warps of the ring's class
    }
    mbar_init(qfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are initialised

  if (warp == consumers) {
    // producer: Q once, then K tiles 0..nt-1 and V tiles 0..nt-1, each into
    // the next slot of its class's ring
    if (lane == 0) {
      mbar_expect_tx(qfull, R * 128);
      tma_load_3d(qs, &p.q, h * DH, t0, b, qfull);
      for (int t = 0; t < 2 * nt; ++t) {
        const Slot sl = slot_of(t, nt, KS);
        mbar_wait(&empty[sl.slot], (sl.round & 1) ^ 1);
        mbar_expect_tx(&full[sl.slot], TILE_BYTES);
        tma_load_3d(ring + sl.slot * TILE_BYTES, t < nt ? &p.k : &p.v, h * DH, (t % nt) * TK, b,
                    &full[sl.slot]);
      }
    }
    return;
  }

  // the key bias of every tile, -inf past S, read while the producer's
  // first loads are in flight
  const float* kb = p.key_bias + (size_t)b * p.s;
  for (int i = threadIdx.x; i < nt * TK; i += consumers * 32)
    bs[i] = i < p.s ? kb[i] : -INFINITY;
  named_sync(1, consumers * 32);

  const int g = warp / KS, k = warp % KS;  // row group, tile residue
  const bool active = g < active_groups;
  const int r = lane / 4, c2 = 2 * (lane % 4);
  const int row0 = g * 16 + r;
  float o[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  if (active) {
    uint32_t qf[DH / 16][4];
    mbar_wait(qfull, 0);
#pragma unroll
    for (int kc = 0; kc < DH / 16; ++kc)
      ldsm4(qf[kc], swz(smem_u32(qs), g * 16 + lane % 16, kc * 2 + lane / 16));

    // the first walk: this warp's K tiles; its running max and lane-partial sum
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
    for (int j = k; j < nt; j += KS) {
      const Slot sl = slot_of(j, nt, KS);
      const int st = sl.slot;
      mbar_wait(&full[st], sl.round & 1);
      const uint32_t tile = smem_u32(ring + st * TILE_BYTES);
      float s[TK / 8][4];
#pragma unroll
      for (int i = 0; i < TK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc) {
#pragma unroll
        for (int np = 0; np < TK / 16; ++np) {
          uint32_t rr[4];
          ldsm4(rr, swz(tile, np * 16 + (lane / 16) * 8 + lane % 8, kc * 2 + (lane / 8) % 2));
          mma16816(s[2 * np], qf[kc], rr[0], rr[1]);
          mma16816(s[2 * np + 1], qf[kc], rr[2], rr[3]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);  // K read: the slot goes back to the producer
      // scale and bias in f32 (keys past S: -inf), the running max
      const float* bt = bs + j * TK + c2;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < TK / 8; ++nb) {
        const float2 bb = *reinterpret_cast<const float2*>(bt + nb * 8);
        s[nb][0] = s[nb][0] * p.scale + bb.x;
        s[nb][1] = s[nb][1] * p.scale + bb.y;
        s[nb][2] = s[nb][2] * p.scale + bb.x;
        s[nb][3] = s[nb][3] * p.scale + bb.y;
        mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: a real key
      float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
      for (int nb = 0; nb < TK / 8; ++nb) {
        const float e0 = ex2((s[nb][0] - mn0) * LOG2E), e1 = ex2((s[nb][1] - mn0) * LOG2E);
        const float e2 = ex2((s[nb][2] - mn1) * LOG2E), e3 = ex2((s[nb][3] - mn1) * LOG2E);
        ps0 += e0 + e1;
        ps1 += e2 + e3;
        float* chunk = stage + (size_t)(2 * j + nb / 4) * R * HALF;
        *stage_at(chunk, row0, (nb % 4) * 8 + c2) = make_float2(e0, e1);
        *stage_at(chunk, row0 + 8, (nb % 4) * 8 + c2) = make_float2(e2, e3);
      }
      l0 = l0 * ex2((m0 - mn0) * LOG2E) + ps0;
      l1 = l1 * ex2((m1 - mn1) * LOG2E) + ps1;
      m0 = mn0;
      m1 = mn1;
      if (lane % 4 == 0) {
        tmax[row0 * nt + j] = mn0;
        tmax[(row0 + 8) * nt + j] = mn1;
      }
    }
    // the group's KS warps merge their (max, sum): the row's max and 1 / sum
    // (a warp with no tile, KS > nt, keeps max -inf and sum 0)
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, x);
      l1 += __shfl_xor_sync(0xffffffffu, l1, x);
    }
    if (lane % 4 == 0) {
      xml[k * R + row0] = make_float2(m0, l0);
      xml[k * R + row0 + 8] = make_float2(m1, l1);
    }
    named_sync(2 + g, KS * 32);
    m0 = m1 = -INFINITY;
    for (int i = 0; i < KS; ++i) {
      m0 = fmaxf(m0, xml[i * R + row0].x);
      m1 = fmaxf(m1, xml[i * R + row0 + 8].x);
    }
    l0 = l1 = 0.0f;
    for (int i = 0; i < KS; ++i) {
      const float2 w0 = xml[i * R + row0], w1 = xml[i * R + row0 + 8];
      l0 += w0.y * ex2((w0.x - m0) * LOG2E);
      l1 += w1.y * ex2((w1.x - m1) * LOG2E);
    }
    l0 = 1.0f / l0;
    l1 = 1.0f / l1;

    // the second walk: this warp's V tiles; normalise its two chunks in
    // place, p = e * exp(m_tile - m) / l, hand them to TMA, and O += P V
    float* prow = p.maps_ptr + ((size_t)(b * gridDim.y + h) * p.tq + t0 + row0) * p.pitch;
    const bool in0 = t0 + row0 < p.tq, in1 = t0 + row0 + 8 < p.tq;
    for (int j = k; j < nt; j += KS) {
      const float f0 = ex2((tmax[row0 * nt + j] - m0) * LOG2E) * l0;
      const float f1 = ex2((tmax[(row0 + 8) * nt + j] - m1) * LOG2E) * l1;
      uint32_t pf[TK / 16][4];
#pragma unroll
      for (int nb = 0; nb < TK / 8; ++nb) {
        float* chunk = stage + (size_t)(2 * j + nb / 4) * R * HALF;
        float2* a = stage_at(chunk, row0, (nb % 4) * 8 + c2);
        float2* d = stage_at(chunk, row0 + 8, (nb % 4) * 8 + c2);
        const float2 pa = make_float2(a->x * f0, a->y * f0);
        const float2 pd = make_float2(d->x * f1, d->y * f1);
        *a = pa;
        *d = pd;
        pf[nb / 2][(nb % 2) * 2] = pack_bf16(pa.x, pa.y);
        pf[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(pd.x, pd.y);
        // TMA writes whole 16-byte units, so it stops at s4; the lanes that
        // own keys s4..S-1 store those
        const int key = j * TK + nb * 8 + c2;
        if (key + 1 >= p.s4 && key < p.s) {
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            if (key + x < p.s4 || key + x >= p.s) continue;
            if (in0) prow[key + x] = x ? pa.y : pa.x;
            if (in1) prow[(size_t)8 * p.pitch + key + x] = x ? pd.y : pd.x;
          }
        }
      }
      // the two chunks' 16 rows to device memory, asynchronously
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        for (int c = 0; c < 2; ++c)
          if (j * TK + c * HALF < p.s4)
            tma_store_3d(&p.maps, stage + ((size_t)(2 * j + c) * R + g * 16) * HALF,
                         j * TK + c * HALF, t0 + g * 16, b * gridDim.y + h);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
      const Slot sl = slot_of(nt + j, nt, KS);
      const int st = sl.slot;
      mbar_wait(&full[st], sl.round & 1);
      const uint32_t tile = smem_u32(ring + st * TILE_BYTES);
#pragma unroll
      for (int kc = 0; kc < TK / 16; ++kc) {
#pragma unroll
        for (int dp = 0; dp < DH / 16; ++dp) {
          uint32_t rr[4];
          ldsm4_trans(rr, swz(tile, kc * 16 + lane % 8 + ((lane / 8) % 2) * 8,
                              dp * 2 + lane / 16));
          mma16816(o[2 * dp], pf[kc], rr[0], rr[1]);
          mma16816(o[2 * dp + 1], pf[kc], rr[2], rr[3]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
  }

  // every consumer is past its last tile: the rings hold the group's KS - 1
  // partial contexts, which warp (g, 0) adds, gates and stages in bf16 over
  // the group's share (exchange_stride)
  named_sync(1, consumers * 32);
  float* xo = reinterpret_cast<float*>(ring) + (size_t)g * exchange_stride(KS);
  if (active && k > 0) {
    float* mine = xo + (k - 1) * 16 * XO_LD;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      *reinterpret_cast<float2*>(mine + r * XO_LD + nd * 8 + c2) =
          make_float2(o[nd][0], o[nd][1]);
      *reinterpret_cast<float2*>(mine + (r + 8) * XO_LD + nd * 8 + c2) =
          make_float2(o[nd][2], o[nd][3]);
    }
  }
  named_sync(1, consumers * 32);
  if (active && k == 0) {
    const float gate = p.gates ? load1(p.gates, p.gates16, h) : 1.0f;
    for (int i = 0; i < KS - 1; ++i) {
      const float* part = xo + i * 16 * XO_LD;
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) {
        const float2 x0 = *reinterpret_cast<const float2*>(part + r * XO_LD + nd * 8 + c2);
        const float2 x1 = *reinterpret_cast<const float2*>(part + (r + 8) * XO_LD + nd * 8 + c2);
        o[nd][0] += x0.x;
        o[nd][1] += x0.y;
        o[nd][2] += x1.x;
        o[nd][3] += x1.y;
      }
    }
    __syncwarp();
    // stage the 16 context rows in bf16 over the first partial, then
    // 16-byte stores (rows past Tq are not written)
    __nv_bfloat16* ow = reinterpret_cast<__nv_bfloat16*>(xo);
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(ow + r * LD_OUT + nd * 8 + c2) =
          __floats2bfloat162_rn(o[nd][0] * gate, o[nd][1] * gate);
      *reinterpret_cast<__nv_bfloat162*>(ow + (r + 8) * LD_OUT + nd * 8 + c2) =
          __floats2bfloat162_rn(o[nd][2] * gate, o[nd][3] * gate);
    }
    __syncwarp();
    for (int i = lane; i < 16 * DH / 8; i += 32) {
      const int rr = i / (DH / 8), d = (i % (DH / 8)) * 8;
      const int t = t0 + g * 16 + rr;
      if (t < p.tq)
        *reinterpret_cast<uint4*>(p.out + ((size_t)b * p.tq + t) * p.ld + h * DH + d) =
            *reinterpret_cast<const uint4*>(ow + rr * LD_OUT + d);
    }
  }
  // the staging buffer lives until the TMA unit has read every chunk
  if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// a 3-d tensor map over rows of `inner` elements (f32 or bf16), `mid` rows
// to each step of the outer dimension, rows `pitch` elements apart; boxes of
// box0 x box1 x 1 with the 128-byte swizzle. TMA reads zeros past each
// dimension and drops writes past it (in whole 16-byte units).
bool encode_3d(CUtensorMap* map, const void* ptr, bool f32, int inner, int mid, int outer,
               int pitch, int box0, int box1) {
  const gemm_impl::EncodeTiled fn = gemm_impl::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t elt = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(mid),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {pitch * elt, pitch * elt * mid};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box0), static_cast<cuuint32_t>(box1), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B,
            f32 ? CU_TENSOR_MAP_L2_PROMOTION_NONE : CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// once per device: the kernel's shared memory limit at the staging limit,
// and the carveout at its largest
cudaError_t setup() {
  static DeviceCache cache;
  int sms = 0;
  return once_per_device(cache, reinterpret_cast<const void*>(attn_probs_kernel),
                         static_cast<int>(SMEM_LIMIT), &sms, cudaSharedmemCarveoutMaxShared);
}

}  // namespace
}  // namespace attn_probs_impl
}  // namespace evlm

namespace evlm {

// q/out [batch*Tq, heads*64], k/v [batch*S, heads*64] bf16, 16-byte
// aligned; key_bias [batch, S] f32; gates [heads] bf16 (gates16) or f32, or
// null; probs [batch, heads, Tq, pitch] f32, 16-byte aligned, pitch >= S a
// multiple of 4 (the first S of each row are written); rows: query rows
// per block, a multiple of 16 up to 128, and ks consumer warps a 16-row
// group, at most 16 in all, whose shared memory fits.
static inline cudaError_t attn_probs(const void* q, const void* k, const void* v,
                                     const float* key_bias, const void* gates, bool gates16,
                                     void* out, float* probs, int pitch, int batch, int Tq, int S,
                                     int heads, int rows, int ks, float scale, cudaStream_t s) {
  using namespace attn_probs_impl;
  if (batch <= 0 || batch > 65535 || Tq <= 0 || S <= 0 || heads <= 0 || heads > 65535 ||
      !key_bias || !probs || rows < 16 || rows > MAX_ROWS || rows % 16 || ks < 1 ||
      rows / 16 * ks > MAX_WARPS || pitch < S || pitch % 4 ||
      reinterpret_cast<uintptr_t>(probs) % 16)
    return cudaErrorInvalidValue;
  const int nt = (S + TK - 1) / TK;
  const size_t smem = smem_bytes(rows, nt, ks);
  if (smem > SMEM_LIMIT ||
      rows / 16 * exchange_stride(ks) * 4 > (size_t)ks * slots_per(ks) * TILE_BYTES)
    return cudaErrorInvalidValue;
  cudaError_t e = setup();
  if (e != cudaSuccess) return e;
  const int a = heads * DH;
  ProbsParams p{};
  p.s4 = S & ~3;
  // below 4 keys every column is a plain store and the maps' map is not used
  if (!encode_3d(&p.q, q, false, a, Tq, batch, a, DH, rows) ||
      !encode_3d(&p.k, k, false, a, S, batch, a, DH, TK) ||
      !encode_3d(&p.v, v, false, a, S, batch, a, DH, TK) ||
      !encode_3d(&p.maps, probs, true, p.s4 > 0 ? p.s4 : 4, Tq, batch * heads, pitch, HALF, 16))
    return cudaErrorInvalidValue;
  p.maps_ptr = probs;
  p.key_bias = key_bias;
  p.gates = gates;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.rows = rows;
  p.ks = ks;
  p.tq = Tq;
  p.s = S;
  p.pitch = pitch;
  p.ld = a;
  p.nt = nt;
  p.gates16 = gates16;
  p.scale = scale;
  dim3 grid((Tq + rows - 1) / rows, heads, batch);
  attn_probs_kernel<<<grid, 32 * (rows / 16 * ks + 1), smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace evlm
