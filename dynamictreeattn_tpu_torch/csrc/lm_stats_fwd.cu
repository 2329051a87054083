// Fused LM-head softmax statistics forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _fwd_kernel of
// dynamictreeattn_tpu/ops/lm_stats.py (K8): per row of logits =
// hidden @ W * inv_temp, the fp32 (lse, mean_x) of softmax(logits), folded
// online over vocab tiles; columns >= V are masked. The [n, V] logits never
// reach device memory.
//
// Layouts: hidden [n, d] bf16; wT [V, d] bf16 (the LM head transposed: for a
// tied head this is the embedding itself) -> lse, mean_x [n] f32; scratch
// partials pm, pse, psx [splits, n] f32, caller-allocated.
//
// Design. The TPU kernel walks the whole vocab on one core with the hidden
// block resident in VMEM. Here the work is R = ceil(n / 128) row tiles x
// NT = ceil(V / 256) vocab tiles, cut into units: a unit is one row tile
// and one split, a run of T consecutive vocab tiles (splits = ceil(NT / T)).
// lm_fwd_partial is persistent: CTA c walks units c, c + grid, c + 2 grid,
// ..., unit u being (row tile u % R, split u / R), so the CTAs that run at
// once share their splits' W tiles through L2 while hidden (13.6 MB at
// n = 6656, d = 1024) stays there. T and the grid are picked on the host
// (ops/lm_stats.py lm_fwd_plan) so that every CTA gets the same number of
// tiles where the shape allows. The CTA is lm_head.cuh's: a producer
// warpgroup keeps a 4-stage ring of 64-deep hidden / wT chunks full by TMA,
// two consumer warpgroups (64 rows each) run wgmma m64n256k16 on it.
//
// After each tile a consumer folds its 64 x 256 logits from registers into
// each thread's running (m, sum 2^(x - m), sum 2^(x - m) x) of its 2 rows,
// in the log2 domain (inv_temp * log2 e folded into one scale, exp2 by the
// MUFU's ex2.approx); it rescales only when a row's maximum moves, and masks
// columns >= V only in the ragged last tile. The 4 threads sharing a row
// merge at the unit's end and write one partial triple per (split, row).
// While one consumer folds, the other may run its next products: the two
// share the ring but wait on no common barrier. lm_fwd_merge then merges
// each row's splits in split order, so two launches give bit-equal results.
//
// What bounds it on the card: 2*n*d*V flops against one read of hidden and
// W (d*V*2 bytes), so at n in the thousands it is operation-bound at the
// bf16 tensor-core rate. Beyond the products, the fold costs ~6 ordinary
// instructions a logit; hidden is read from L2 once per vocab tile.

#include "lm_head.cuh"

namespace lmf {

using namespace lmh;

constexpr int STAGES = 4;
constexpr int BAR_OFF = STAGES * STAGE;
constexpr int SMEM_BYTES = BAR_OFF + 2 * STAGES * 8 + 1024;  // + room to align the base

struct Stats {  // one thread's running statistics of its two rows, log2 domain
  float m[2], se[2], sx[2];
};

// (m, se, sx) <- merge with (m2, se2, sx2), log2 domain
__device__ __forceinline__ void merge(float& m, float& se, float& sx, float m2, float se2, float sx2) {
  const float mm = fmaxf(m, m2);
  if (mm == -CUDART_INF_F) return;  // both empty
  const float a = ex2(m - mm), b = ex2(m2 - mm);  // ex2(-inf) = 0
  se = se * a + se2 * b;
  sx = sx * a + sx2 * b;
  m = mm;
}

// fold one 64 x 256 tile of accumulators; columns col0 + 8j (+1) (col0 =
// the tile's first column + 2 t4); RAGGED: skip columns >= V
template <bool RAGGED>
__device__ __forceinline__ void fold(const float (&acc)[32][4], float c2, int col0, int V, Stats& st) {
  float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!RAGGED || col0 + 8 * j + (e & 1) < V) mt[e >> 1] = fmaxf(mt[e >> 1], acc[j][e] * c2);
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (mt[r] > st.m[r]) {  // rescale only when the running maximum moves
      const float sc = ex2(st.m[r] - mt[r]);  // 0 while m = -inf
      st.se[r] *= sc;
      st.sx[r] *= sc;
      st.m[r] = mt[r];
    }
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!RAGGED || col0 + 8 * j + (e & 1) < V) {
        const int r = e >> 1;
        const float x2 = acc[j][e] * c2;
        const float p = ex2(x2 - st.m[r]);
        st.se[r] += p;
        st.sx[r] = fmaf(p, x2, st.sx[r]);
      }
}

__global__ void __launch_bounds__(NTHREADS, 1)
lm_fwd_partial(const __grid_constant__ CUtensorMap tm_h, const __grid_constant__ CUtensorMap tm_w,
               float* __restrict__ pm, float* __restrict__ pse, float* __restrict__ psx, int n, int d,
               int V, int R, int splits, int T, float c2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the 128-byte swizzle repeats every 1024 bytes
  const Ring<STAGES> rg{base, base + BAR_OFF};
  const int tid = threadIdx.x, wg = tid / 128;
  const int NT = (V + BN - 1) / BN, nk = d / BK, units = R * splits;

  if (tid == 0) {
    rg.init();
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer warpgroup: one thread issues every copy
    producer_regs();
    if (tid == NCONS) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int r0 = (u % R) * BM, t0 = (u / R) * T, t1 = min(NT, t0 + T);
        for (int t = t0; t < t1; ++t) load_logits(rg, &tm_h, &tm_w, r0, t * BN, nk, it);
      }
    }
    return;
  }
  consumer_regs();
  const int warp = (tid % 128) / 32, lane = tid % 32, grp = lane >> 2, t4 = lane & 3;
  float acc[32][4];
  zero(acc);
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int s = u / R, t0 = s * T, t1 = min(NT, t0 + T);
    Stats st;
#pragma unroll
    for (int r = 0; r < 2; ++r) st.m[r] = -CUDART_INF_F, st.se[r] = st.sx[r] = 0.f;
    for (int t = t0; t < t1; ++t) {
      rg.mma<0, 0>(acc, wg, nk, it);
      const int col0 = t * BN + 2 * t4;
      if (t == NT - 1 && V % BN)
        fold<true>(acc, c2, col0, V, st);
      else
        fold<false>(acc, c2, col0, V, st);
    }
    // the 4 threads of a quad hold the same rows: merge them, then write
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1)
        merge(st.m[r], st.se[r], st.sx[r], __shfl_xor_sync(0xffffffffu, st.m[r], off),
              __shfl_xor_sync(0xffffffffu, st.se[r], off), __shfl_xor_sync(0xffffffffu, st.sx[r], off));
    if (t4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = (u % R) * BM + wg * 64 + warp * 16 + grp + 8 * r;
        if (row < n) {
          const size_t at = size_t(s) * n + row;
          pm[at] = st.m[r];
          pse[at] = st.se[r];
          psx[at] = st.sx[r];
        }
      }
    }
  }
}

__global__ void lm_fwd_merge(const float* __restrict__ pm, const float* __restrict__ pse,
                             const float* __restrict__ psx, int splits, int n, float* __restrict__ lse,
                             float* __restrict__ mean_x) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float m = -CUDART_INF_F, se = 0.f, sx = 0.f;
  for (int s = 0; s < splits; ++s)  // split order: fixed
    merge(m, se, sx, pm[size_t(s) * n + r], pse[size_t(s) * n + r], psx[size_t(s) * n + r]);
  lse[r] = m * LN2 + logf(se);
  mean_x[r] = sx * LN2 / se;
}

}  // namespace lmf

// splits = ceil(ceil(V / 256) / tiles_per_split); grid CTAs (at most
// ceil(n / 128) * splits). Requires d % 64 == 0, contiguous 16-byte aligned
// hidden / wT; the Python wrapper checks these.
extern "C" int lm_stats_fwd(const void* hidden, const void* wT, void* pm, void* pse, void* psx, void* lse,
                            void* mean_x, int n, int d, int V, int splits, int tiles_per_split, int grid,
                            float inv_temp, void* stream) {
  using namespace lmf;
  if (n < 1 || d < BK || d % BK || V < 1 || splits < 1 || tiles_per_split < 1 || grid < 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap th, tw;
  if (!tensor_map(&th, hidden, n, d) || !tensor_map(&tw, wT, V, d)) return int(cudaErrorInvalidValue);
  static int entry_regs = -1;  // setmaxnreg's arithmetic holds at ENTRY_REGS only
  if (entry_regs < 0) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, lm_fwd_partial);
    if (err != cudaSuccess) return int(err);
    entry_regs = attr.numRegs;
  }
  if (entry_regs != ENTRY_REGS) return int(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(lm_fwd_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return int(err);
  const int R = (n + BM - 1) / BM;
  lm_fwd_partial<<<grid, NTHREADS, SMEM_BYTES, st>>>(
      th, tw, static_cast<float*>(pm), static_cast<float*>(pse), static_cast<float*>(psx), n, d, V, R, splits,
      tiles_per_split, inv_temp * LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  lm_fwd_merge<<<(n + 255) / 256, 256, 0, st>>>(static_cast<const float*>(pm), static_cast<const float*>(pse),
                                                static_cast<const float*>(psx), splits, n,
                                                static_cast<float*>(lse), static_cast<float*>(mean_x));
  return int(cudaGetLastError());
}
