// Fused LM-head softmax statistics backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _bwd_kernel of
// dynamictreeattn_tpu/ops/lm_stats.py (K9): given the saved per-row fp32 lse
// and the cotangents folded into a = g_lse + g_ent * mean_x and b = g_ent,
//   x  = hidden @ W * inv_temp                 (recomputed, fp32)
//   dl = exp(x - lse) * (a - b * x) * inv_temp  (rounded to bf16; 0 for
//                                                columns >= V)
//   dhidden = dl @ W^T   [n, d]    dWT = dl^T @ hidden   [V, d]
// both accumulated in fp32 and written once, in bf16.
//
// Layouts: hidden [n, d] bf16; wT [V, d] bf16 (the LM head transposed: for a
// tied head this is the embedding itself); lse, a, b [n] f32 -> dh [n, d]
// bf16, dWT [V, d] bf16. Scratch, caller-allocated: dl [n_pad, V_pad] bf16
// (n rounded up to 128, V to 128: 2.02 GB at n = 6656, V = 151936; 11.5 GB
// at n = 37888), rows >= n and columns >= V written as zeros; one int32
// counter.
//
// Design. The TPU kernel walks vocab blocks in order on one core, keeps all
// n rows resident and accumulates dhidden in its output window across the
// walk. A CTA here has no room for that, and CTAs cannot carry a sum across
// the grid, so the products run as two persistent launches, each writing
// every output tile exactly once (no atomics on data, so two launches give
// bit-equal results). Both use lm_head.cuh's CTA: a producer warpgroup
// filling a ring of 64-deep chunks by TMA, two consumer warpgroups on wgmma
// m64n256k16.
//   1. lm_bwd_dlogits: K8's main loop over 128 x 256 logits tiles (CTA c
//      takes tiles c, c + grid, ..., tile u being row tile u % R, vocab
//      tile u / R, so the CTAs running at once share W tiles through L2).
//      The epilogue forms dl in registers, rounds it to bf16, writes it
//      into a 128-byte-swizzled staging tile and stores it by TMA, which
//      overlaps the next tile's products.
//   2. lm_bwd_gemm: both products over one list of 128 x 256 output tiles:
//      first the dhidden tiles (R x ceil(d / 256), each a V_pad-deep
//      contraction: A = dl K-major, B = wT MN-major), then the dWT tiles
//      (V_pad / 128 x ceil(d / 256), n_pad deep: A = dl^T and B = hidden,
//      both MN-major). CTAs take tiles from a counter in device memory, the
//      long dhidden tiles first, so the short dWT tiles fill the tail that
//      dhidden's 208 tiles alone (1.58 waves at n = 6656) would leave.
//      Which CTA computes a tile does not change its sums.
//
// What bounds it on the card: 3 * 2*n*d*V flops (x, dhidden, dWT) against
// one read of hidden and W and one write of dhidden and dWT, so it is
// operation-bound at the bf16 tensor-core rate. Extra bytes of this design:
// dl written once and read twice (6*n*V bytes, ~6 GB at n = 6656, ~1.8 ms at
// 3.35 TB/s, behind the products).

#include <algorithm>

#include "lm_head.cuh"

namespace lmb {

using namespace lmh;

// ------------------------------------------------------ pass 1: dlogits

constexpr int DL_STAGES = 3;                       // 3 x 48 KB + the 64 KB staging tile
constexpr int DL_OUT_OFF = DL_STAGES * STAGE;      // bf16 [2][4 boxes of 64 x 64]
constexpr int DL_BAR_OFF = DL_OUT_OFF + 2 * 4 * BOX_BYTES;
constexpr int DL_SMEM = DL_BAR_OFF + 2 * DL_STAGES * 8 + 1024;

__global__ void __launch_bounds__(NTHREADS, 1)
lm_bwd_dlogits(const __grid_constant__ CUtensorMap tm_h, const __grid_constant__ CUtensorMap tm_w,
               const __grid_constant__ CUtensorMap tm_dl, const float* __restrict__ lse,
               const float* __restrict__ a_row, const float* __restrict__ b_row, int n, int d, int V, int R,
               float inv_temp) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const Ring<DL_STAGES> rg{base, base + DL_BAR_OFF};
  const int tid = threadIdx.x, wg = tid / 128;
  const int NT = (V + BN - 1) / BN, nk = d / BK, units = R * NT;

  if (tid == 0) {
    rg.init();
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    producer_regs();
    if (tid == NCONS) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x)
        load_logits(rg, &tm_h, &tm_w, (u % R) * BM, (u / R) * BN, nk, it);
    }
    return;
  }
  consumer_regs();
  const int wt = tid % 128, warp = wt / 32, lane = tid % 32, grp = lane >> 2, t4 = lane & 3;
  const uint32_t out = base + DL_OUT_OFF + wg * 4 * BOX_BYTES;  // this warpgroup's 64 x 256 staging
  const float c2 = inv_temp * LOG2E;
  float acc[32][4];
  zero(acc);
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int r0 = (u % R) * BM + wg * 64, v0 = (u / R) * BN;
    float l2[2], ar[2], br[2];  // rows past n: dl = 0 (a = b = 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + warp * 16 + grp + 8 * r;
      const bool ok = row < n;
      l2[r] = ok ? lse[row] * LOG2E : 0.f;
      ar[r] = ok ? a_row[row] : 0.f;
      br[r] = ok ? b_row[row] : 0.f;
    }
    rg.mma<0, 0>(acc, wg, nk, it);
    // the staging tile is free once the previous tile's store has read it
    if (wt == 0) bulk_wait_read();
    named_sync(1 + wg, 128);
    const bool ragged = v0 + BN > V;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      // columns 8j + 2 t4 (+1): box j / 8, 16-byte chunk j % 8 of the row,
      // swizzled by row % 8 = grp
      const uint32_t at = out + (j / 8) * BOX_BYTES + (warp * 16 + grp) * 128 + (((j % 8) ^ grp) << 4) + 4 * t4;
      const int col = v0 + 8 * j + 2 * t4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float g0 = ex2(fmaf(acc[j][2 * r], c2, -l2[r])) * (ar[r] - br[r] * (acc[j][2 * r] * inv_temp)) * inv_temp;
        float g1 =
            ex2(fmaf(acc[j][2 * r + 1], c2, -l2[r])) * (ar[r] - br[r] * (acc[j][2 * r + 1] * inv_temp)) * inv_temp;
        if (ragged) {
          g0 = col < V ? g0 : 0.f;
          g1 = col + 1 < V ? g1 : 0.f;
        }
        st_shared(at + r * 8 * 128, pack_bf16(g0, g1));
      }
    }
    fence_async_smem();  // the staging writes, visible to the TMA unit
    named_sync(1 + wg, 128);
    if (wt == 0) {
#pragma unroll
      for (int b = 0; b < 4; ++b) tma_store_box(&tm_dl, out + b * BOX_BYTES, v0 + 64 * b, r0);
      bulk_commit();
    }
  }
  if (wt == 0) bulk_wait();
}

// ------------------------------------------------ pass 2: dhidden and dWT

constexpr int G_STAGES = 4;
constexpr int G_UNIT_OFF = G_STAGES * STAGE;         // int unit[2]
constexpr int G_BAR_OFF = G_UNIT_OFF + 16;           // ring bars, then unit full[2], empty[2]
constexpr int G_SMEM = G_BAR_OFF + (2 * G_STAGES + 4) * 8 + 1024;

struct Gemm {
  bf16* dh;
  bf16* dwT;
  int* counter;
  int n, d, V, R, ND, n_pad, V_pad;
};

__global__ void __launch_bounds__(NTHREADS, 1)
lm_bwd_gemm(const __grid_constant__ CUtensorMap tm_h, const __grid_constant__ CUtensorMap tm_w,
            const __grid_constant__ CUtensorMap tm_dl, const Gemm g) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  volatile int* unit_slot = reinterpret_cast<volatile int*>(smem_raw + (base - raw) + G_UNIT_OFF);
  const Ring<G_STAGES> rg{base, base + G_BAR_OFF};
  const uint32_t ubars = base + G_BAR_OFF + 2 * G_STAGES * 8;  // unit full[2], empty[2]
  const int tid = threadIdx.x, wg = tid / 128;
  const int n_dh = g.R * g.ND, total = n_dh + (g.V_pad / BM) * g.ND;

  if (tid == 0) {
    rg.init();
    for (int s = 0; s < 2; ++s) {
      mbar_init(ubars + 8 * s, 1);        // unit full: the producer
      mbar_init(ubars + 8 * (2 + s), 8);  // unit empty: every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    producer_regs();
    if (tid == NCONS) {
      int it = 0, u = blockIdx.x;
      for (int j = 0;; ++j) {  // hand unit u to the consumers, then load it
        const int slot = j & 1;
        if (j >= 2) mbar_wait(ubars + 8 * (2 + slot), ((j >> 1) - 1) & 1);
        unit_slot[slot] = u;
        mbar_arrive(ubars + 8 * slot);
        if (u >= total) break;
        if (u < n_dh) {  // dhidden tile: A = dl rows (K-major), B = wT rows (MN-major)
          const int m0 = (u / g.ND) * BM, n0 = (u % g.ND) * BN;
          for (int kc = 0; kc < g.V_pad / BK; ++kc, ++it) {
            uint32_t full;
            const uint32_t st = rg.acquire(it, full);
#pragma unroll
            for (int w = 0; w < 2; ++w) tma_box(st + w * BOX_BYTES, &tm_dl, full, kc * BK, m0 + 64 * w);
#pragma unroll
            for (int b = 0; b < 4; ++b) tma_box(st + A_TILE + b * BOX_BYTES, &tm_w, full, n0 + 64 * b, kc * BK);
          }
        } else {  // dWT tile: A = dl^T (MN-major), B = hidden rows (MN-major)
          const int m0 = ((u - n_dh) / g.ND) * BM, n0 = ((u - n_dh) % g.ND) * BN;
          for (int kc = 0; kc < g.n_pad / BK; ++kc, ++it) {
            uint32_t full;
            const uint32_t st = rg.acquire(it, full);
#pragma unroll
            for (int w = 0; w < 2; ++w) tma_box(st + w * BOX_BYTES, &tm_dl, full, m0 + 64 * w, kc * BK);
#pragma unroll
            for (int b = 0; b < 4; ++b) tma_box(st + A_TILE + b * BOX_BYTES, &tm_h, full, n0 + 64 * b, kc * BK);
          }
        }
        u = gridDim.x + atomicAdd(g.counter, 1);
      }
    }
    return;
  }
  consumer_regs();
  const int warp = (tid % 128) / 32, lane = tid % 32, grp = lane >> 2, t4 = lane & 3;
  float acc[32][4];
  zero(acc);
  int it = 0;
  for (int j = 0;; ++j) {
    const int slot = j & 1;
    mbar_wait(ubars + 8 * slot, (j >> 1) & 1);
    const int u = unit_slot[slot];
    __syncwarp();
    if (lane == 0) mbar_arrive(ubars + 8 * (2 + slot));
    if (u >= total) break;
    bf16* out;
    int m0, n0, m_valid;
    if (u < n_dh) {
      rg.mma<0, 1>(acc, wg, g.V_pad / BK, it);
      out = g.dh, m0 = (u / g.ND) * BM, n0 = (u % g.ND) * BN, m_valid = g.n;
    } else {
      rg.mma<1, 1>(acc, wg, g.n_pad / BK, it);
      out = g.dwT, m0 = ((u - n_dh) / g.ND) * BM, n0 = ((u - n_dh) % g.ND) * BN, m_valid = g.V;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + wg * 64 + warp * 16 + grp + 8 * r;
      if (row >= m_valid) continue;
#pragma unroll
      for (int jj = 0; jj < 32; ++jj) {
        const int col = n0 + 8 * jj + 2 * t4;
        if (col < g.d)
          *reinterpret_cast<uint32_t*>(out + size_t(row) * g.d + col) =
              pack_bf16(acc[jj][2 * r], acc[jj][2 * r + 1]);
      }
    }
  }
}

template <typename K>
int prepare(K kernel, int smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return int(err);
  if (attr.numRegs != ENTRY_REGS) return int(cudaErrorInvalidConfiguration);  // setmaxnreg's arithmetic
  return int(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

}  // namespace lmb

// n_pad, V_pad: n and V rounded up to 128; dl [n_pad, V_pad]; counter: one
// int32, zeroed here. grid: CTAs of each pass (the card's SM count).
// Requires d % 64 == 0 and contiguous 16-byte aligned tensors; the Python
// wrapper checks these.
extern "C" int lm_stats_bwd(const void* hidden, const void* wT, const void* lse, const void* a, const void* b,
                            void* dl, void* dh, void* dwT, void* counter, int n, int d, int V, int n_pad,
                            int V_pad, int grid, float inv_temp, void* stream) {
  using namespace lmb;
  if (n < 1 || d < BK || d % BK || V < 1 || n_pad % BM || V_pad % BM || n_pad < n || V_pad < V || grid < 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap th, tw, tdl;
  if (!tensor_map(&th, hidden, n, d) || !tensor_map(&tw, wT, V, d) || !tensor_map(&tdl, dl, n_pad, V_pad))
    return int(cudaErrorInvalidValue);
  static int ready = -1;
  if (ready < 0) {
    const int code = prepare(lm_bwd_dlogits, DL_SMEM);
    ready = code != 0 ? code : prepare(lm_bwd_gemm, G_SMEM);
  }
  if (ready != 0) return ready;
  const int R = n_pad / BM, NT = (V + BN - 1) / BN;
  lm_bwd_dlogits<<<std::min(grid, R * NT), NTHREADS, DL_SMEM, st>>>(
      th, tw, tdl, static_cast<const float*>(lse), static_cast<const float*>(a), static_cast<const float*>(b), n,
      d, V, R, inv_temp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  err = cudaMemsetAsync(counter, 0, sizeof(int), st);
  if (err != cudaSuccess) return int(err);
  const int ND = (d + BN - 1) / BN;
  const Gemm g{static_cast<bf16*>(dh), static_cast<bf16*>(dwT), static_cast<int*>(counter), n, d, V, R, ND,
               n_pad, V_pad};
  lm_bwd_gemm<<<std::min(grid, R * ND + (V_pad / BM) * ND), NTHREADS, G_SMEM, st>>>(th, tw, tdl, g);
  return int(cudaGetLastError());
}
