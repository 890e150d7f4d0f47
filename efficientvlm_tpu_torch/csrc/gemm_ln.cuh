// gemm_ln: out[map(m)] = LN(A[m] . B + bias + row_add[m % period] + residual[m])
//                        * gamma + beta,
// bf16 operands, the product, the sums and both LayerNorm statistics in f32
// (mean, then the mean of (y - mean)^2: the JAX kernels' two-pass formula),
// written as bf16 with the row mapping
//   map(m) = (m / group) * out_group_stride + out_offset + m % group.
// bias, row_add, gamma and beta are read as stored, all bf16 or all f32
// (vec16); residual is bf16 or null.
//
// Serves the LayerNorm epilogues of two TPU kernels:
//   - efficientvlm_tpu/ops/pallas_patch_embed.py (_patch_embed_padded, body
//     _kernel): patch matmul + bias + positional rows + pre-LN, eps 1e-5.
//     Here A is gathered straight from the NHWC image (the im2col happens in
//     the loader) and the same launch writes every image's CLS row;
//   - efficientvlm_tpu/ops/pallas_fused_mha.py
//     (_fused_cross_grouped_padded, body _fused_cross_grouped_kernel with
//     ln_params): the output projection + the BERT layer's residual add +
//     post-LN, eps 1e-12.
//
// What bounds it on the H100: tensor-core operations, as gemm_bias (2*M*N*K
// FLOP against reads of A, B, residual and one bf16 write). A LayerNorm
// needs a whole row, and a row of D = 768 is six 128-column tiles; before
// this kernel the product made an f32 round trip through device memory
// (written by gemm_bias, read back by residual_layernorm). Design:
//   - gemm_bias's main loop (TMA into a 5-stage mbarrier ring, two consumer
//     warpgroups on wgmma m64n128k16 taking 128x128 tiles in turns), with a
//     producer warpgroup whose registers setmaxnreg hands to the consumers
//     (40 / 232 a thread: the LayerNorm epilogue spilled at gemm_bias's
//     168);
//   - launched as thread-block clusters of D / 128 blocks along N: block
//     `rank` of a cluster owns columns [128 rank, 128 rank + 128), and the
//     blocks of one cluster walk the same row tiles in step, so a row is
//     split over the cluster's blocks;
//   - in the epilogue each block takes, for each row, the sum of its 128
//     columns and the sum of squares about their own mean (two passes in
//     registers, quad shuffles), pushes the pair into every peer's shared
//     memory through distributed shared memory (mapa + st.shared::cluster)
//     and arrives on the peer's mbarrier (release.cluster); each block
//     waits on its own barrier (acquire.cluster) and merges the pairs in
//     rank order: mean = sum / D, and sum((y - mean)^2) = sum over blocks
//     of (M2_b + 128 (mean_b - mean)^2), the exact two-pass variance about
//     the mean (Chan's merge; no E[y^2] - mean^2 cancellation); then it
//     normalises in registers. One exchange a tile: each costs a round trip
//     across the cluster that the other warpgroup's products must cover.
//     The exchange buffers are per consumer warpgroup and double-buffered,
//     so a peer that runs ahead never overwrites pairs not yet read; the
//     block's 128 columns of bias, gamma and beta sit in shared memory as
//     f32;
//   - the bf16 tile goes through a swizzled staging buffer and out with
//     16-byte stores, each row placed by the mapping (patch rows land behind
//     their image's CLS row; a 128-row tile may span two images);
//   - the persistent grid holds as many clusters as the card can keep
//     resident (cudaOccupancyMaxActiveClusters): a 6-block cluster must sit
//     in one GPC and does not tile every GPC.
// Gather mode (the patch embedding): the producer warpgroup gathers the A tile
// from the image with cp.async 16-byte pieces into the 128-byte-swizzled
// K-major layout that the wgmma descriptor reads, completion counted on the
// stage's mbarrier (cp.async.mbarrier.arrive.noinc); B still comes by TMA.
// For patch (b, i, j) and K index (ph, pw, c) the P*3 values of one ph are
// contiguous in the image row, so a 16-byte piece never straddles two ph
// rows when P*3 % 8 == 0 (P = 16 gives 48, P = 8 gives 24); the caller
// refuses other patch sizes. TMA's own im2col mode cannot serve: a 3-channel
// bf16 pixel is 6 bytes, below its 16-byte inner box. The CLS row LN(cls +
// pos[0]) is the same for every image: the second consumer warpgroup of
// block 0 computes it while the first runs its first tile, and writes it to
// row 0 of each image.
#pragma once

#include "gemm_bias.cuh"

namespace evlm {
namespace gemm_ln_impl {
namespace {  // internal linkage: each .cu includes its own copy

using namespace gemm_impl;

constexpr int MAX_CLUSTER = 8;                     // portable cluster size: D <= 1024
// a producer warpgroup and two consumer warpgroups; setmaxnreg moves the
// producer's registers to the consumers (the epilogue holds a 128x128 f32
// tile and the row statistics: 168 registers a thread spilled)
constexpr int LN_THREADS = (CONSUMERS + 1) * 128;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int OUT16 = 64 * BN * 2;                 // a warpgroup's 64-row bf16 half tile
constexpr int EXCHANGES = CONSUMERS * 2;           // (warpgroup, slot)

constexpr size_t smem_bytes(int cluster) {
  // stages, staging, (sum, M2) pairs [EXCHANGES][cluster][BM], bias /
  // gamma / beta [3][BN], barriers
  return STAGES * STAGE_BYTES + CONSUMERS * OUT16 + EXCHANGES * cluster * BM * 2 * sizeof(float) +
         3 * BN * sizeof(float) + (2 * STAGES + EXCHANGES) * sizeof(uint64_t) + 1024;
}

struct LnParams {
  CUtensorMap a;                   // A [M, K] (not read in gather mode)
  CUtensorMap b;                   // B [K, N], box 64 (N) x 64 (K rows)
  const void* bias;                // [N] or null
  const void* row_add;             // [period, N] or null
  const __nv_bfloat16* residual;   // [M, N] or null
  const void* gamma;               // [N]
  const void* beta;                // [N]
  __nv_bfloat16* out;
  int m, n, k, period, group, out_group_stride, out_offset;
  int vec16;                       // bias, row_add, gamma, beta, cls, pos0: bf16 (else f32)
  float eps;
  // gather mode: A[m] is patch m of the NHWC image, its K = P*P*3 values in
  // (ph, pw, c) order; the CLS rows are written at b * out_group_stride
  const __nv_bfloat16* image;
  const void* cls;                 // class embedding [N]
  const void* pos0;                // positional row 0 [N]
  int batch, img_h, img_w, patch, n_patches;
};

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// the address of the same shared-memory location in block `rank` of the cluster
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" :: "r"(addr), "f"(a), "f"(b)
               : "memory");
}

// arrive on a (possibly remote) barrier; the thread's earlier writes to the
// cluster's shared memory are visible to whoever then acquires it
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" :: "r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LN_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra LN_WAIT;\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// the stage's barrier completes once this thread's earlier cp.asyncs have
// landed (its expected count includes this arrival)
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(smem_u32(bar))
               : "memory");
}

// the sums of the quad's four lanes (one row's 128 columns of this block)
__device__ __forceinline__ void quad_sum(float (&s)[4]) {
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
  }
}

// (s[h], m2[h]): this block's sum over its 128 columns of tile row ri[h]
// and the sum of squares about their mean -> the row's mean and variance
// over the cluster. The lane of each quad with q == 0 pushes its four
// pairs into slot `rank` of every block's buffer, then arrives on every
// block's barrier (32 lanes x `cluster` blocks arrivals complete it): all
// stores first, so that only the first release waits for them; then every
// thread waits on its own block's barrier and merges the slots in rank
// order.
__device__ __forceinline__ void exchange(float (&s)[4], float (&m2)[4], const int (&ri)[4],
                                         float2* buf, uint64_t* bar, uint32_t parity,
                                         uint32_t rank, int cluster, int q, int n) {
  if (q == 0) {
    const uint32_t dst = smem_u32(buf + rank * BM), b = smem_u32(bar);
#pragma unroll 1
    for (int peer = 0; peer < cluster; ++peer) {
      const uint32_t d = mapa(dst, peer);
#pragma unroll
      for (int h = 0; h < 4; ++h) st_cluster(d + ri[h] * 8, s[h], m2[h]);
    }
#pragma unroll 1
    for (int peer = 0; peer < cluster; ++peer) mbar_arrive_cluster(mapa(b, peer));
  }
  mbar_wait_cluster(bar, parity);
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    float t = 0.0f;
#pragma unroll 1
    for (int peer = 0; peer < cluster; ++peer) t += buf[peer * BM + ri[h]].x;
    const float mean = t / n;
    float v = 0.0f;
#pragma unroll 1
    for (int peer = 0; peer < cluster; ++peer) {
      const float2 e = buf[peer * BM + ri[h]];
      const float dm = e.x / BN - mean;
      v += e.y + BN * dm * dm;
    }
    s[h] = mean;
    m2[h] = v / n;
  }
}

// bias (vec: this block's columns, in shared memory), the positional rows
// and the residual into the accumulators of rows ra (acc[4i], acc[4i+1])
// and rb (acc[4i+2], acc[4i+3]) at columns col + 8i (c: col - col0)
__device__ __forceinline__ void add_terms(float (&acc)[64], const LnParams& p, const float* vec,
                                          int ra, int rb, int col, int c) {
  if (p.bias) {
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const float2 v = *reinterpret_cast<const float2*>(vec + c + 8 * i);
      acc[4 * i] += v.x;
      acc[4 * i + 1] += v.y;
      acc[4 * i + 2] += v.x;
      acc[4 * i + 3] += v.y;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? rb : ra;
    if (row >= p.m) continue;  // a ragged tile's rows past M are never stored
    if (p.row_add) {
      const size_t base = (size_t)(row % p.period) * p.n + col;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const float2 v = load2(p.row_add, p.vec16, base + 8 * i);
        acc[4 * i + 2 * h] += v.x;
        acc[4 * i + 2 * h + 1] += v.y;
      }
    }
    if (p.residual) {
      const __nv_bfloat16* rr = p.residual + (size_t)row * p.n + col;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rr + 8 * i));
        acc[4 * i + 2 * h] += v.x;
        acc[4 * i + 2 * h + 1] += v.y;
      }
    }
  }
}

// scale and shift a normalised 64-row half tile (rows row0 + r and row0 +
// r + 8 of this thread), stage it as bf16 in `buf` (two 64-column boxes of
// 128-byte rows, 16-byte chunks swizzled by the row: conflict-free) and
// store it with 16-byte stores, each row placed by the mapping
__device__ __forceinline__ void store_half(const float (&acc)[64], const LnParams& p,
                                           const float* vec, int row0, int col0,
                                           unsigned char* buf, int wg, int tid) {
  const int r = (tid / 32) * 16 + (tid % 32) / 4, q = tid % 4;
  warpgroup_sync(wg);  // this warpgroup's last reads of buf are done
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const float2 g = *reinterpret_cast<const float2*>(vec + BN + 8 * i + 2 * q);
    const float2 b = *reinterpret_cast<const float2*>(vec + 2 * BN + 8 * i + 2 * q);
    const int byte = (8 * i + 2 * q) % 64 * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r + 8 * h;
      *reinterpret_cast<__nv_bfloat162*>(buf + (8 * i / 64) * BOX_BYTES + rr * 128 +
                                         ((byte / 16) ^ (rr % 8)) * 16 + byte % 16) =
          __floats2bfloat162_rn(acc[4 * i + 2 * h] * g.x + b.x,
                                acc[4 * i + 2 * h + 1] * g.y + b.y);
    }
  }
  warpgroup_sync(wg);
#pragma unroll
  for (int it = 0; it < 64 * 16 / 128; ++it) {
    const int idx = it * 128 + tid, rr = idx / 16, cc = idx % 16;
    const int row = row0 + rr;
    if (row >= p.m) continue;
    const size_t orow = (size_t)(row / p.group) * p.out_group_stride + p.out_offset + row % p.group;
    *reinterpret_cast<uint4*>(p.out + orow * p.n + col0 + cc * 8) =
        *reinterpret_cast<const uint4*>(buf + (cc / 8) * BOX_BYTES + rr * 128 +
                                        ((cc % 8) ^ (rr % 8)) * 16);
  }
}

// LN(cls + pos[0]) into row b * out_group_stride of every image b, by the
// 128 threads of one consumer warpgroup (warp 0 computes, all store)
__device__ __forceinline__ void cls_rows(const LnParams& p, unsigned char* buf, int wg, int tid) {
  __nv_bfloat16* row = reinterpret_cast<__nv_bfloat16*>(buf);
  if (tid < 32) {
    float sum = 0.0f;
    for (int c = tid; c < p.n; c += 32)
      sum += load1(p.cls, p.vec16, c) + load1(p.pos0, p.vec16, c);
    const float mean = warp_sum(sum) / p.n;
    float sq = 0.0f;
    for (int c = tid; c < p.n; c += 32) {
      const float y = load1(p.cls, p.vec16, c) + load1(p.pos0, p.vec16, c) - mean;
      sq += y * y;
    }
    const float inv = rsqrtf(warp_sum(sq) / p.n + p.eps);
    for (int c = tid; c < p.n; c += 32) {
      const float y = load1(p.cls, p.vec16, c) + load1(p.pos0, p.vec16, c) - mean;
      row[c] = __float2bfloat16(y * inv * load1(p.gamma, p.vec16, c) +
                                load1(p.beta, p.vec16, c));
    }
  }
  warpgroup_sync(wg);
  const int chunks = p.n / 8;
  for (int i = tid; i < p.batch * chunks; i += 128)
    *reinterpret_cast<uint4*>(p.out + (size_t)(i / chunks) * p.out_group_stride * p.n +
                              (i % chunks) * 8) =
        *reinterpret_cast<const uint4*>(row + (i % chunks) * 8);
}

template <bool GATHER>
__global__ void __launch_bounds__(LN_THREADS, 1)
gemm_ln_kernel(const __grid_constant__ LnParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int cluster = p.n / BN;
  unsigned char* out_buf = smem + STAGES * STAGE_BYTES;  // OUT16 per consumer warpgroup
  // (sum, M2) pairs [EXCHANGES][cluster][BM]
  float2* red = reinterpret_cast<float2*>(out_buf + CONSUMERS * OUT16);
  float* vec = reinterpret_cast<float*>(red + EXCHANGES * cluster * BM);  // bias, gamma, beta
  uint64_t* full = reinterpret_cast<uint64_t*>(vec + 3 * BN);
  uint64_t* empty = full + STAGES;
  uint64_t* xbar = empty + STAGES;  // [EXCHANGES]

  const uint32_t rank = cluster_rank();
  const int cid = blockIdx.x / cluster, clusters = gridDim.x / cluster;
  const int tiles_m = (p.m + BM - 1) / BM;
  const int mine = cid < tiles_m ? (tiles_m - cid + clusters - 1) / clusters : 0;
  const int kblocks = (p.k + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // gather mode: the TMA of B plus one cp.async arrival per producer thread
      mbar_init(&full[s], GATHER ? 1 + 128 : 1);
      mbar_init(&empty[s], 1);
    }
    for (int x = 0; x < EXCHANGES; ++x) mbar_init(&xbar[x], 32 * cluster);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {  // this block's columns of bias, gamma and beta as f32
    const int c = threadIdx.x % BN, which = threadIdx.x / BN, col = rank * BN + c;
    const void* src = which == 0 ? p.bias : (which == 1 ? p.gamma : p.beta);
    vec[which * BN + c] = src ? load1(src, p.vec16, col) : 0.0f;
  }
  cluster_sync();  // every peer's barriers exist before anyone arrives on them

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // producer: the k-blocks of this cluster's row tiles in order (thread 0
    // issues the TMA loads; in gather mode all 128 threads gather A)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    const int lane = threadIdx.x % 128;
    if (GATHER || lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < mine; ++j) {
        const int tm = cid + j * clusters;
        // thread `lane` gathers 16-byte piece lane % 8 of rows lane / 8 +
        // 16 t of the tile; off[t] is the image offset of the row's patch
        // (-1 past M)
        int off[GATHER ? 8 : 1];
        if constexpr (GATHER) {
          const int gw = p.img_w / p.patch;
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const int m = tm * BM + lane / 8 + 16 * t;
            const int b = m / p.n_patches, pi = m % p.n_patches;
            off[t] = m < p.m ? ((b * p.img_h + pi / gw * p.patch) * p.img_w + pi % gw * p.patch) * 3
                             : -1;
          }
        }
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + stage * STAGE_BYTES;
          if (lane == 0) {
            mbar_expect_tx(&full[stage], GATHER ? STAGE_BYTES - A_BYTES : STAGE_BYTES);
            if (!GATHER) tma_load_2d(st, &p.a, kb * BK, tm * BM, &full[stage]);
#pragma unroll
            for (int c = 0; c < BN / 64; ++c)
              tma_load_2d(st + A_BYTES + c * B_CHUNK, &p.b, rank * BN + 64 * c, kb * BK,
                          &full[stage]);
          }
          if constexpr (GATHER) {
            const int piece = lane % 8, k = kb * BK + piece * 8, p3 = p.patch * 3;
            const int koff = k / p3 * p.img_w * 3 + k % p3;
#pragma unroll
            for (int t = 0; t < 8; ++t) {
              const int m = lane / 8 + 16 * t;
              const bool ok = k < p.k && off[t] >= 0;
              cp_async16(st + m * 128 + ((piece ^ (m % 8)) << 4),
                         ok ? p.image + off[t] + koff : p.image, ok ? 16 : 0);
            }
            cp_async_mbar_arrive(&full[stage]);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    cluster_sync();  // no block leaves while a peer may still write to it
  } else {
    // consumers: warpgroup wg takes the cluster's row tiles j = wg, wg + 2,
    // ... in turns with the other, as gemm_bias does
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
    const int tid = threadIdx.x % 128;
    unsigned char* buf = out_buf + wg * OUT16;
    if constexpr (GATHER)
      if (blockIdx.x == 0 && wg == 1) cls_rows(p, buf, wg, tid);
    const int r = (tid / 32) * 16 + (tid % 32) / 4, q = tid % 4;
    const int ri[4] = {r, r + 8, 64 + r, 72 + r};
    const int col0 = rank * BN;
    float lo[64], hi[64];  // rows [0, 64) and [64, 128) of the tile
    for (int j = wg; j < mine; j += CONSUMERS) {
      const int tm = cid + j * clusters;
      if (j > 0) turn_wait(wg);
      const long first = (long)j * kblocks;
      int stage = static_cast<int>(first % STAGES);
      uint32_t phase = static_cast<uint32_t>(first / STAGES) & 1;
      int prev = 0;
      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(&full[stage], phase);
        // the gathered A was written by cp.async (generic proxy); wgmma
        // reads shared memory through the async proxy
        if (GATHER) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
        wgmma_wait<1>();
        if (kb > 0 && tid == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (j + 1 < mine) turn_pass(wg);  // the next tile is the other's
      wgmma_wait<0>();
      fence_acc(lo);
      fence_acc(hi);
      if (tid == 0) mbar_arrive(&empty[prev]);

      // y = product + bias + positional rows + residual, then the row's
      // statistics over the cluster
      const int row0 = tm * BM;
      add_terms(lo, p, vec, row0 + ri[0], row0 + ri[1], col0 + 2 * q, 2 * q);
      add_terms(hi, p, vec, row0 + ri[2], row0 + ri[3], col0 + 2 * q, 2 * q);
      // this block's (sum, sum of squares about its own mean) per row, two
      // passes in registers
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f}, m2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        s[0] += lo[4 * i] + lo[4 * i + 1];
        s[1] += lo[4 * i + 2] + lo[4 * i + 3];
        s[2] += hi[4 * i] + hi[4 * i + 1];
        s[3] += hi[4 * i + 2] + hi[4 * i + 3];
      }
      quad_sum(s);
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a0 = lo[4 * i + e] - s[0] / BN, a1 = lo[4 * i + 2 + e] - s[1] / BN;
          const float b0 = hi[4 * i + e] - s[2] / BN, b1 = hi[4 * i + 2 + e] - s[3] / BN;
          m2[0] += a0 * a0;
          m2[1] += a1 * a1;
          m2[2] += b0 * b0;
          m2[3] += b1 * b1;
        }
      }
      quad_sum(m2);
      const int slot = (j / CONSUMERS) & 1;
      const uint32_t parity = (j / (2 * CONSUMERS)) & 1;
      exchange(s, m2, ri, red + (wg * 2 + slot) * cluster * BM, xbar + wg * 2 + slot, parity,
               rank, cluster, q, p.n);  // -> s: mean, m2: variance
#pragma unroll
      for (int h = 0; h < 4; ++h) m2[h] = rsqrtf(m2[h] + p.eps);
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          lo[4 * i + e] = (lo[4 * i + e] - s[0]) * m2[0];
          lo[4 * i + 2 + e] = (lo[4 * i + 2 + e] - s[1]) * m2[1];
          hi[4 * i + e] = (hi[4 * i + e] - s[2]) * m2[2];
          hi[4 * i + 2 + e] = (hi[4 * i + 2 + e] - s[3]) * m2[3];
        }
      }
      store_half(lo, p, vec, row0, col0, buf, wg, tid);
      store_half(hi, p, vec, row0 + 64, col0, buf, wg, tid);
    }
    cluster_sync();  // no block leaves while a peer may still write to it
  }
}

// the resident clusters of `cluster` blocks, per device, gather or not. The
// kernel's dynamic shared memory limit is raised once per device to the
// largest cluster's size (smem_bytes(MAX_CLUSTER) fits the H100's 227 KB),
// so that a launch at any width fits it whatever width ran first.
template <bool GATHER>
int max_clusters(int cluster) {
  static_assert(smem_bytes(MAX_CLUSTER) <= 227 * 1024, "the widest cluster's shared memory");
  static bool raised[16] = {};
  static int cache[16][MAX_CLUSTER + 1] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 16) return 0;
  if (!raised[dev]) {
    if (cudaFuncSetAttribute(gemm_ln_kernel<GATHER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes(MAX_CLUSTER))) != cudaSuccess)
      return 0;
    raised[dev] = true;
  }
  int& n = cache[dev][cluster];
  if (n == 0) {
    const size_t smem = smem_bytes(cluster);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(LN_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (cudaOccupancyMaxActiveClusters(&n, gemm_ln_kernel<GATHER>, &cfg) != cudaSuccess) n = 0;
  }
  return n;
}

template <bool GATHER>
cudaError_t launch(const LnParams& p, cudaStream_t s) {
  const int cluster = p.n / BN;
  const int resident = max_clusters<GATHER>(cluster);
  if (resident <= 0) return cudaErrorLaunchOutOfResources;
  const int tiles_m = (p.m + BM - 1) / BM;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((tiles_m < resident ? tiles_m : resident) * cluster);
  cfg.blockDim = dim3(LN_THREADS);
  cfg.dynamicSmemBytes = smem_bytes(cluster);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, gemm_ln_kernel<GATHER>, p);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// the shape rule shared by both entries: N a multiple of 128, at most 8 tiles
inline bool width_ok(int n) { return n > 0 && n % BN == 0 && n / BN <= MAX_CLUSTER; }

}  // namespace
}  // namespace gemm_ln_impl
}  // namespace evlm

namespace evlm {

// A [M,K] bf16 @ B [K,N] bf16 (+ bias) (+ row_add[m % period]) (+ residual
// [M,N] bf16), LayerNorm(gamma, beta, eps) over each row of N, bf16 out
// with rows placed by the mapping. N a multiple of 128, at most 1024; K a
// multiple of 8; A, B, residual and out 16-byte aligned (the caller checks
// this). vec16: bias, row_add, gamma and beta are bf16 (else f32).
static inline cudaError_t gemm_ln(const void* A, const void* B, const void* bias,
                                  const void* row_add, int period, const void* residual,
                                  const void* gamma, const void* beta, bool vec16, void* out,
                                  int group, int out_group_stride, int out_offset, int M, int N,
                                  int K, float eps, cudaStream_t s) {
  using namespace gemm_ln_impl;
  if (!width_ok(N) || M <= 0 || K <= 0 || K % 8 || period <= 0 || group <= 0)
    return cudaErrorInvalidValue;
  LnParams p{};
  if (!encode_map(&p.a, A, M, K, BM) || !encode_map(&p.b, B, K, N, BK))
    return cudaErrorInvalidValue;
  p.bias = bias;
  p.row_add = row_add;
  p.residual = static_cast<const __nv_bfloat16*>(residual);
  p.gamma = gamma;
  p.beta = beta;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.m = M;
  p.n = N;
  p.k = K;
  p.period = period;
  p.group = group;
  p.out_group_stride = out_group_stride;
  p.out_offset = out_offset;
  p.vec16 = vec16;
  p.eps = eps;
  return launch<false>(p, s);
}

// The patch embedding in one launch: image [batch, H, W, 3] bf16 (NHWC),
// w [P*P*3, D] bf16 ((ph, pw, c) rows: the HWIO conv kernel flattened);
// out [batch, 1 + Np, D] = CLS row LN(cls + pos[0]), then per patch
// LN(patch . w + bias + pos[1 + patch]). The patches tile the top-left
// floor(H/P)*P x floor(W/P)*P of the image (a VALID convolution drops the
// rest), read in place with the full row stride W*3: Np = floor(H/P) *
// floor(W/P). P*3 % 8 == 0 and W*3 % 8 == 0 (16-byte pieces), D under
// gemm_ln's rule; image, w and out 16-byte aligned; vec16: bias, pos, cls,
// gamma and beta are bf16 (else f32).
static inline cudaError_t patch_embed_ln(const void* image, const void* w, const void* bias,
                                         const void* pos, const void* cls, const void* gamma,
                                         const void* beta, bool vec16, void* out, int batch,
                                         int height, int width, int patch, int D, float eps,
                                         cudaStream_t s) {
  using namespace gemm_ln_impl;
  if (!width_ok(D) || batch <= 0 || patch <= 0 || patch * 3 % 8 || width * 3 % 8 ||
      height < patch || width < patch || (long)batch * height * width * 3 >= (1L << 31))
    return cudaErrorInvalidValue;
  const int n_patches = (height / patch) * (width / patch), K = patch * patch * 3;
  LnParams p{};
  if (!encode_map(&p.b, w, K, D, BK)) return cudaErrorInvalidValue;
  p.bias = bias;
  p.row_add = static_cast<const unsigned char*>(pos) + (vec16 ? 2 : 4) * (size_t)D;  // pos[1:]
  p.gamma = gamma;
  p.beta = beta;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.m = batch * n_patches;
  p.n = D;
  p.k = K;
  p.period = n_patches;
  p.group = n_patches;
  p.out_group_stride = n_patches + 1;
  p.out_offset = 1;
  p.vec16 = vec16;
  p.eps = eps;
  p.image = static_cast<const __nv_bfloat16*>(image);
  p.cls = cls;
  p.pos0 = pos;
  p.batch = batch;
  p.img_h = height;
  p.img_w = width;
  p.patch = patch;
  p.n_patches = n_patches;
  return launch<true>(p, s);
}

// clusters of gemm_ln (gather or not) the card keeps resident at width N
static inline int gemm_ln_clusters(int N, bool gather) {
  using namespace gemm_ln_impl;
  if (!width_ok(N)) return -1;
  return gather ? max_clusters<true>(N / BN) : max_clusters<false>(N / BN);
}

}  // namespace evlm
