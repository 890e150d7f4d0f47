// gemm_bias: C[M,N] = act(A[M,K] @ B[K,N] (+ bias[N]) (+ row_add[m % period, N])),
// bf16 operands, f32 accumulation, C written as bf16 or f32; bias and
// row_add are read as stored, both bf16 or both f32 (the kernel is built for
// each, so the epilogue's loads carry no type test); act is the identity or
// BERT's GELU, applied in f32 on the accumulators (an instance of its own
// each, so the identity's instance is the kernel it was). One launch may
// serve up to three GEMMs over the same A (the Q, K and V projections of a
// self-attention sublayer, or K and V of a cross-attention one), each with
// its own B, bias and C.
//
// Replaces the projections that the TPU kernels compute inside their own
// bodies: the patch matmul of efficientvlm_tpu/ops/pallas_patch_embed.py
// (_kernel, with the positional rows as row_add) and the Q/K/V/output
// projections of ops/pallas_fused_mha.py (_fused_kernel, _fused_cross_kernel,
// _fused_cross_grouped_kernel).
//
// What bounds it on the H100: tensor-core operations. At the main path's
// shapes (M = 1e4..4e4 rows, K = 768, N = 768..2304) a projection does
// 300-600 FLOP per byte of A, B and C, above the card's ~295 FLOP/byte
// ridge, and only wgmma reaches the tensor cores' full rate. With K = 768 a
// 128x128 tile has only 12 k-blocks, so storing the tile costs as much as
// a large share of its products unless the two overlap. Design:
//   - a persistent grid (one block per SM) walks 128x128 output tiles, the
//     tiles of one row block of A next to each other so that A is read from
//     device memory about once for all GEMMs of the launch;
//   - one producer warp keeps a ring of STAGES shared-memory stages full
//     with TMA (cp.async.bulk.tensor, 128-byte swizzle), each stage a 128x64
//     slice of A and a 64x128 slice of B, completion counted on an mbarrier;
//     B is read in its [K, N] layout (N contiguous, the dense kernel's
//     [in, out]) through wgmma's transpose bit, so no weight is transposed;
//     TMA zero-fills the ragged edges of M, N and K;
//   - two consumer warpgroups take whole tiles in turns ("ping-pong"): one
//     issues wgmma.mma_async m64n128k16 (two per 16-deep slice, rows 0-63
//     and 64-127) and hands each stage back through a second mbarrier,
//     while the other finishes its last tile; a named barrier passes the
//     turn once a warpgroup has seen its tile's last k-block arrive;
//   - the epilogue adds bias and row_add in f32 on the accumulator
//     registers (all loads before any store), applies the activation there
//     (the BERT FFN's first GEMM: the [M, I] intermediate is stored once, as
//     bf16, already activated), writes each 64-row half into
//     a swizzled staging buffer of its warpgroup and stores it with TMA,
//     which writes whole lines, clips the ragged edge and runs on while the
//     warpgroup goes back to its products.
// Tried on the card and not kept (PERF.md): 128x256 tiles, a 2-block
// cluster multicasting B, a deeper ring, and stores straight from the
// registers (the tensor cores then waited on the stores).
// TMA descriptors depend on the pointers, so the host encodes them on every
// call (libcuda's cuTensorMapEncodeTiled, looked up through the CUDA
// runtime, so the library needs no link to libcuda) and passes them by value as
// __grid_constant__ parameters.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace evlm {
namespace gemm_impl {
namespace {  // internal linkage: each .cu includes its own copy

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 5;
constexpr int CONSUMERS = 2;                       // warpgroups, whole tiles in turns
constexpr int THREADS = CONSUMERS * 128 + 32;      // + one producer warp
constexpr int MAX_GEMMS = 3;
// the epilogue's activations (bindings.ACTIVATIONS): the identity, BERT's
// exact erf GELU
enum { ACT_NONE = 0, ACT_GELU = 1 };
constexpr int A_BYTES = BM * BK * 2;               // 16 KB: 128 rows of 128 bytes
constexpr int B_CHUNK = BK * 64 * 2;               // 8 KB: 64 K-rows of 64 columns
constexpr int STAGE_BYTES = A_BYTES + (BN / 64) * B_CHUNK;
constexpr int BOX_BYTES = 64 * 128;                // C box: 64 rows of 128 bytes
constexpr int OUT_BYTES = 64 * BN * 4;             // a warpgroup's 64-row half tile, f32 at most
constexpr size_t SMEM_BYTES =
    STAGES * STAGE_BYTES + CONSUMERS * OUT_BYTES + 2 * STAGES * sizeof(uint64_t) + 1024;

struct Params {
  CUtensorMap a;                  // A [M, K], box 64 (K) x 128 (rows)
  CUtensorMap b[MAX_GEMMS];       // B_g [K, N], box 64 (N) x 64 (K rows)
  CUtensorMap c[MAX_GEMMS];       // C_g [M, N], box 128 bytes of columns x 64 rows
  const void* bias[MAX_GEMMS];
  const void* row_add;
  int period, m, n, k, gemms, out_f32;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT;\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1) : "memory");
}

// a box of shared memory to global memory; the parts of the box past the
// tensor's edge are not written
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptors for tiles written by TMA with 128-byte
// swizzle (1024-byte aligned atoms of 8 rows x 128 bytes).
// K-major (A): rows of 64 K values; 8-row groups 1024 bytes apart (SBO).
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 | (uint64_t)(1024 >> 4) << 32 |
         (uint64_t)1 << 62;
}
// MN-major (B, transposed): rows of 64 N values, one row per K; the
// 64-column chunks of the tile are B_CHUNK apart (LBO), 8-K-row groups 1024
// bytes apart (SBO).
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(B_CHUNK >> 4) << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

// named barriers 1 and 2 pass the turn between the consumer warpgroups
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "n"(CONSUMERS * 128) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(1 + (wg + 1) % CONSUMERS), "n"(CONSUMERS * 128)
               : "memory");
}

// named barriers 3 and 4: the 128 threads of one consumer warpgroup
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(3 + wg) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define EVLM_ACC8(i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64x128] (+)= A[64x16] (K-major) . B[16x128] (MN-major); scale_d = 0
// starts the sum
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
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
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : EVLM_ACC8(0), EVLM_ACC8(8), EVLM_ACC8(16), EVLM_ACC8(24), EVLM_ACC8(32), EVLM_ACC8(40),
        EVLM_ACC8(48), EVLM_ACC8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}
#undef EVLM_ACC8

// the activation of one f32 value, as torch's F.gelu computes it in f32
template <int ACT>
__device__ __forceinline__ float activate(float x) {
  if constexpr (ACT == ACT_GELU) {
    return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
  } else {
    return x;
  }
}

// bias and row_add into the accumulators of rows [row0, row0 + 64) of a
// tile, then the activation (thread tid holds rows r and r + 8 of its warp's 16, columns
// 8 i + 2 (tid % 4) + {0, 1}), then the 64 rows out through `buf`: written
// there in the C map's 128-byte swizzled boxes (conflict-free: the 8 rows a
// store instruction touches land in 8 different 16-byte chunks) and stored
// by TMA, which writes whole lines and clips the ragged edge. All loads
// come before the first store, so their latencies overlap. V16: bias and
// row_add are bf16 (else f32).
template <bool V16, int ACT>
__device__ __forceinline__ void epilogue(float (&acc)[64], const Params& p, const void* bias,
                                         const CUtensorMap* map, unsigned char* buf, int row0,
                                         int col0, int wg, int tid) {
  const int r = (tid / 32) * 16 + (tid % 32) / 4, q = tid % 4;
  const int col = col0 + 2 * q;
  if (bias) {
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      if (col + 8 * i >= p.n) continue;  // N is a multiple of 8, so col + 1 < N too
      const float2 bb = load2(bias, V16, col + 8 * i);
      acc[4 * i] += bb.x;
      acc[4 * i + 1] += bb.y;
      acc[4 * i + 2] += bb.x;
      acc[4 * i + 3] += bb.y;
    }
  }
  if (p.row_add) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t ra = (size_t)((row0 + r + 8 * h) % p.period) * p.n;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        if (col + 8 * i >= p.n) continue;
        const float2 v = load2(p.row_add, V16, ra + col + 8 * i);
        acc[4 * i + 2 * h] += v.x;
        acc[4 * i + 2 * h + 1] += v.y;
      }
    }
  }
  if constexpr (ACT != ACT_NONE) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = activate<ACT>(acc[i]);
  }
  // the TMA store of this warpgroup's previous half tile has read `buf`
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  warpgroup_sync(wg);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r + 8 * h;
    unsigned char* row = buf + rr * 128;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
      if (p.out_f32) {  // boxes of 32 columns
        const int byte = (8 * i + 2 * q) % 32 * 4;
        *reinterpret_cast<float2*>(row + (8 * i / 32) * BOX_BYTES +
                                   ((byte / 16) ^ (rr % 8)) * 16 + byte % 16) =
            make_float2(v0, v1);
      } else {  // boxes of 64 columns
        const int byte = (8 * i + 2 * q) % 64 * 2;
        *reinterpret_cast<__nv_bfloat162*>(row + (8 * i / 64) * BOX_BYTES +
                                           ((byte / 16) ^ (rr % 8)) * 16 + byte % 16) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  // make the writes visible to the TMA unit, then one thread stores
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  warpgroup_sync(wg);
  if (tid == 0) {
    const int box_cols = p.out_f32 ? 32 : 64;
    for (int bx = 0; bx < BN / box_cols; ++bx)
      if (col0 + bx * box_cols < p.n)
        tma_store_2d(map, buf + bx * BOX_BYTES, col0 + bx * box_cols, row0);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

template <bool V16, int ACT>
__global__ void __launch_bounds__(THREADS, 1) gemm_bias_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle atoms must start on 1024-byte boundaries
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* out_buf = smem + STAGES * STAGE_BYTES;  // OUT_BYTES per consumer warpgroup
  uint64_t* full = reinterpret_cast<uint64_t*>(out_buf + CONSUMERS * OUT_BYTES);
  uint64_t* empty = full + STAGES;

  // this block's tiles are t = blockIdx.x + j gridDim.x, j = 0, 1, ...;
  // a tile is one (row tile, GEMM, column tile), column tiles fastest
  const int tiles_m = (p.m + BM - 1) / BM, tiles_n = (p.n + BN - 1) / BN;
  const int tiles = tiles_m * tiles_n * p.gemms;
  const int kblocks = (p.k + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // producer: one thread loads the k-blocks of every tile of the block in
    // order into the ring, as far ahead as the ring allows
    if (threadIdx.x != CONSUMERS * 128) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int tn = t % tiles_n, g = (t / tiles_n) % p.gemms, tm = t / (tiles_n * p.gemms);
      const CUtensorMap* mb = g == 0 ? &p.b[0] : (g == 1 ? &p.b[1] : &p.b[2]);
      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], STAGE_BYTES);
        unsigned char* st = smem + stage * STAGE_BYTES;
        tma_load_2d(st, &p.a, kb * BK, tm * BM, &full[stage]);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load_2d(st + A_BYTES + c * B_CHUNK, mb, tn * BN + 64 * c, kb * BK, &full[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg computes whole tiles j = wg, wg + 2, ..., and
  // the two take turns: one runs its products while the other adds the
  // bias and stores its last tile. A warpgroup starts waiting for a tile's
  // k-blocks only once the other has seen every k-block of the previous
  // tile arrive, so no stage it waits on is two fills behind (a barrier's
  // parity could not tell those apart).
  const int tid = threadIdx.x % 128;
  float lo[64], hi[64];  // rows [0, 64) and [64, 128) of the tile
  for (int j = wg;; j += CONSUMERS) {
    const int t = blockIdx.x + j * gridDim.x;
    if (t >= tiles) break;
    if (j > 0) turn_wait(wg);
    const int tn = t % tiles_n, g = (t / tiles_n) % p.gemms, tm = t / (tiles_n * p.gemms);
    const long first = (long)j * kblocks;  // this tile's first k-block in the ring's order
    int stage = static_cast<int>(first % STAGES);
    uint32_t phase = static_cast<uint32_t>(first / STAGES) & 1;
    int prev = 0;
    for (int kb = 0; kb < kblocks; ++kb) {
      mbar_wait(&full[stage], phase);
      const uint32_t a_base = smem_u32(smem + stage * STAGE_BYTES);
      const uint32_t b_base = a_base + A_BYTES;
      fence_acc(lo);
      fence_acc(hi);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = desc_mn_major(b_base + kk * 2048);
        const int acc = (kb > 0 || kk > 0) ? 1 : 0;
        wgmma_m64n128k16(lo, desc_k_major(a_base + kk * 32), db, acc);
        wgmma_m64n128k16(hi, desc_k_major(a_base + 64 * 128 + kk * 32), db, acc);
      }
      wgmma_commit();
      fence_acc(lo);
      fence_acc(hi);
      // the previous stage's products are done: hand it back to the producer
      wgmma_wait<1>();
      if (kb > 0 && tid == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    if (t + (int)gridDim.x < tiles) turn_pass(wg);  // the next tile is the other's
    wgmma_wait<0>();
    fence_acc(lo);
    fence_acc(hi);
    if (tid == 0) mbar_arrive(&empty[prev]);

    const void* bias = g == 0 ? p.bias[0] : (g == 1 ? p.bias[1] : p.bias[2]);
    const CUtensorMap* mc = g == 0 ? &p.c[0] : (g == 1 ? &p.c[1] : &p.c[2]);
    unsigned char* buf = out_buf + wg * OUT_BYTES;
    epilogue<V16, ACT>(lo, p, bias, mc, buf, tm * BM, tn * BN, wg, tid);
    epilogue<V16, ACT>(hi, p, bias, mc, buf, tm * BM + 64, tn * BN, wg, tid);
  }
  // shared memory must outlive the last stores' reads of it
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// libcuda's cuTensorMapEncodeTiled, looked up through the CUDA runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// row-major [rows, cols] bf16 or f32, in boxes of box_rows rows x 128
// bytes of columns (the swizzle span); loads past the edge read zeros and
// stores past it are dropped
bool encode_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows,
                bool f32 = false) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t elt = f32 ? 4 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elt};
  const cuuint32_t box[2] = {128 / elt, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
}  // namespace gemm_impl
}  // namespace evlm

namespace evlm {

// `count` (1-3) GEMMs over one A: C_g = act(A @ B_g (+ bias_g) (+ row_add)).
// A [M,K] bf16 row-major, B_g [K,N] bf16 row-major (a dense kernel's [in,
// out] layout), C_g [M,N] contiguous, bf16 or f32 (out_f32). K and N must be
// multiples of 8 and every pointer 16-byte aligned (TMA); the caller checks
// this. bias_g [N] and row_add [period, N] may be null; vec16: they are
// bf16 (else f32). ACT: gemm_impl::ACT_* (ACT_NONE, the projections'; a
// translation unit compiles only the instances it names: fused_ffn.cu's
// gemm_bias_act names both).
template <int ACT = gemm_impl::ACT_NONE>
static inline cudaError_t gemm_bias_multi(const void* A, int count, const void* const* B,
                                          const void* const* bias, void* const* C,
                                          const void* row_add, int period, bool vec16,
                                          bool out_f32, int M, int N, int K, cudaStream_t s) {
  using namespace gemm_impl;
  if (count < 1 || count > MAX_GEMMS || M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8)
    return cudaErrorInvalidValue;
  Params p{};
  if (!encode_map(&p.a, A, M, K, BM)) return cudaErrorInvalidValue;
  for (int g = 0; g < count; ++g) {
    if (!encode_map(&p.b[g], B[g], K, N, BK) || !encode_map(&p.c[g], C[g], M, N, 64, out_f32))
      return cudaErrorInvalidValue;
    p.bias[g] = bias[g];
  }
  p.row_add = row_add;
  p.period = period;
  p.m = M;
  p.n = N;
  p.k = K;
  p.gemms = count;
  p.out_f32 = out_f32;
  auto kernel = vec16 ? gemm_bias_kernel<true, ACT> : gemm_bias_kernel<false, ACT>;
  static DeviceCache cache[2];  // per instance of the kernel
  int sms = 0;
  cudaError_t e = once_per_device(cache[vec16], reinterpret_cast<const void*>(kernel),
                                  static_cast<int>(SMEM_BYTES), &sms);
  if (e != cudaSuccess) return e;
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN) * count;
  kernel<<<tiles < sms ? tiles : sms, THREADS, SMEM_BYTES, s>>>(p);
  return cudaGetLastError();
}

static inline cudaError_t gemm_bias(const void* A, const void* B, const void* bias,
                                    const void* row_add, int period, bool vec16, void* C,
                                    bool out_f32, int M, int N, int K, cudaStream_t s) {
  return gemm_bias_multi(A, 1, &B, &bias, &C, row_add, period, vec16, out_f32, M, N, K, s);
}

}  // namespace evlm
