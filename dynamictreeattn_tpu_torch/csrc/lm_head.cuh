// The LM-head kernels' shared pieces (lm_stats_fwd.cu K8, lm_stats_bwd.cu
// K9): a CTA of two consumer warpgroups and one producer warpgroup, a ring of
// k-chunk stages filled by TMA, and the consumers' wgmma loop over it.
//
// A stage holds one 64-deep k-chunk of an A tile of BM = 128 rows (two
// 64 x 64 boxes, one per consumer warpgroup) and of a B tile of BN = 256
// columns (four boxes), each box 128-byte swizzled as the TMA writes it.
// Consumer warpgroup w multiplies A box w by the whole B tile with wgmma
// m64n256k16: 64 x 256 fp32 accumulators (128 registers a thread), so each
// byte of B fetched feeds 128 rows and each byte of A feeds 256 columns.
// Operands are K-major (contraction along a box's columns) or MN-major
// (along its rows): the logits read hidden [n, d] and wT [V, d] K-major;
// dhidden = dl wT reads dl K-major and wT MN-major; dWT = dl^T hidden reads
// both MN-major.
//
// Registers: a 384-thread CTA enters with 168 a thread (65536 / 384); the
// producer gives back to 40 and the consumers take 232 (setmaxnreg), which
// the host checks by the kernel's entry count.

#pragma once

#include <math_constants.h>

#include "hopper.cuh"

namespace lmh {

using namespace hopper;

constexpr int BM = 128;                    // rows of a CTA tile (64 per consumer warpgroup)
constexpr int BN = 256;                    // columns of a CTA tile
constexpr int BK = 64;                     // depth of a ring stage
constexpr int NCONS = 256;                 // consumer threads
constexpr int NTHREADS = NCONS + 128;      // + the producer warpgroup
constexpr int ENTRY_REGS = 168, PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int A_TILE = BM * BK * 2;        // 16 KB: 2 boxes
constexpr int B_TILE = BN * BK * 2;        // 32 KB: 4 boxes
constexpr int STAGE = A_TILE + B_TILE;     // 48 KB, the bytes a full stage receives
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
}

// The ring: S stages at `ring` (1024-aligned); barriers full[S] then
// empty[S] at `bars`. `it` counts chunks over the CTA's whole walk, the same
// in the producer and the consumers.
template <int S>
struct Ring {
  uint32_t ring, bars;

  __device__ __forceinline__ void init() const {  // one thread
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);        // full: the producer's expect_tx + the copies
      mbar_init(bars + 8 * (S + s), 8);  // empty: every consumer warp
    }
  }

  // producer: stage of chunk `it`, once free, armed for STAGE bytes
  __device__ __forceinline__ uint32_t acquire(int it, uint32_t& full) const {
    const int s = it % S;
    if (it >= S) mbar_wait(bars + 8 * (S + s), ((it / S) - 1) & 1);
    full = bars + 8 * s;
    mbar_expect_tx(full, STAGE);
    return ring + s * STAGE;
  }

  // consumer warp: done with the stage of chunk `it`
  __device__ __forceinline__ void release(int it) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(bars + 8 * (S + it % S));
  }

  // consumer warpgroup: acc = sum over `nk` chunks of A box `a_box` times B.
  // Chunk kc's products go out while kc - 1's finish; a stage is released
  // once its products are done.
  template <int A_MN, int B_MN>
  __device__ __forceinline__ void mma(float (&acc)[32][4], int a_box, int nk, int& it) const {
    for (int kc = 0; kc < nk; ++kc, ++it) {
      const int s = it % S;
      mbar_wait(bars + 8 * s, (it / S) & 1);
      const uint32_t a = ring + s * STAGE + a_box * BOX_BYTES, b = ring + s * STAGE + A_TILE;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_n256<A_MN, B_MN>(acc, A_MN ? desc_mnmaj(a, kk) : desc_kmaj(a, kk),
                               B_MN ? desc_mnmaj(b, kk) : desc_kmaj(b, kk), kc > 0 || kk > 0);
      wg_commit();
      if (kc > 0) {
        wg_wait_one();
        release(it - 1);
      }
    }
    wg_wait_all();
    pin(acc);
    release(it - 1);
  }
};

// producer thread: the nk chunks of the logits tile (rows r0, vocab v0):
// hidden [n, d] rows r0..r0+127 and wT [V, d] rows v0..v0+255, both K-major
// (rows past n or V arrive as zeros)
template <int S>
__device__ __forceinline__ void load_logits(const Ring<S>& rg, const CUtensorMap* th, const CUtensorMap* tw,
                                            int r0, int v0, int nk, int& it) {
  for (int kc = 0; kc < nk; ++kc, ++it) {
    uint32_t full;
    const uint32_t st = rg.acquire(it, full);
#pragma unroll
    for (int w = 0; w < 2; ++w) tma_box(st + w * BOX_BYTES, th, full, kc * BK, r0 + 64 * w);
#pragma unroll
    for (int b = 0; b < 4; ++b) tma_box(st + A_TILE + b * BOX_BYTES, tw, full, kc * BK, v0 + 64 * b);
  }
}

// The accumulator fragment of wgmma m64nN: acc[j][e] holds row
// 16 * warp + grp + 8 * (e >> 1), column 8 * j + 2 * t4 + (e & 1) of the
// warpgroup's 64 x 256 tile (warp = warp in the warpgroup, grp = lane / 4,
// t4 = lane % 4).

}  // namespace lmh
