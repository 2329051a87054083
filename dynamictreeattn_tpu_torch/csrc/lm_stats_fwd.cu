// Fused LM-head softmax statistics forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _fwd_kernel of
// dynamictreeattn_tpu/ops/lm_stats.py (K8): per row of logits =
// hidden @ W * inv_temp, the fp32 (lse, mean_x) of softmax(logits), folded
// online as (m, sum e^x, sum e^x * x) over vocab tiles; columns >= V are
// masked. The [n, V] logits never reach device memory.
//
// Layouts: hidden [n, d] bf16; wT [V, d] bf16 (the LM head transposed: for a
// tied head this is the embedding itself) -> lse, mean_x [n] f32.
//
// Design. The TPU kernel walks the whole vocab on one core with the hidden
// block resident in VMEM. Here parallelism comes from rows x vocab splits.
// Pass 1 (lm_stats_partial) gives each CTA a 128-row tile and one contiguous
// range of 128-column vocab tiles. It streams 32-deep chunks of hidden and
// wT through a 4-stage cp.async ring in shared memory and forms each 128x128
// logits tile on the tensor cores (mma.sync m16n8k16 bf16, ldmatrix
// fragments, fp32 accumulators in registers: 8 warps of 32x64). Each thread
// folds the logits it holds into its own running (m, se, sx) for its 4 rows,
// straight from registers; the threads sharing a row merge once, at the
// end, and write one partial triple per (split, row). Pass 2
// (lm_stats_merge) merges the splits per row into lse and mean_x.
//
// What bounds it on the card: 2*n*d*V flops against one read of W (d*V*2
// bytes), so at n in the thousands it is operation-bound at the bf16
// tensor-core rate. This version uses mma.sync (not wgmma) and re-reads each
// hidden tile from L2 for every vocab tile, so it stays above that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BN = 128;     // rows per CTA
constexpr int BV = 128;     // vocab columns per tile
constexpr int BD = 32;      // depth chunk per pipeline stage
constexpr int STAGES = 4;
constexpr int NTHREADS = 256;
constexpr int HS = BD + 8;  // bf16 row stride: conflict-free ldmatrix
constexpr size_t STAGE_ELEMS = size_t(BN + BV) * HS;
constexpr size_t SMEM_BYTES = STAGES * STAGE_ELEMS * 2 + size_t(2) * BN * 3 * 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; zero-fills the destination when `pred` is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_stages() {  // chunk c is in
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (m, se, sx) <- merge of two online-softmax partials
__device__ __forceinline__ void merge_stats(float& m, float& se, float& sx, float m2, float se2,
                                            float sx2) {
  const float mm = fmaxf(m, m2);
  if (mm == -CUDART_INF_F) return;  // both empty
  const float a = m == -CUDART_INF_F ? 0.f : expf(m - mm);
  const float b = m2 == -CUDART_INF_F ? 0.f : expf(m2 - mm);
  se = se * a + se2 * b;
  sx = sx * a + sx2 * b;
  m = mm;
}

__global__ void __launch_bounds__(NTHREADS, 2)
lm_stats_partial(const bf16* __restrict__ hidden, const bf16* __restrict__ wT,
                 float* __restrict__ pm, float* __restrict__ pse,
                 float* __restrict__ psx, int n, int d, int V,
                 int tiles_per_split, float inv_temp) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // [STAGES][BN + BV][HS]
  float* xchg = reinterpret_cast<float*>(smem + STAGES * STAGE_ELEMS * 2);  // [2][BN][3]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane >> 2, t4 = lane & 3;
  const int wr = warp >> 1;  // warp's 32-row band
  const int wc = warp & 1;   // warp's 64-column band
  const int r0 = blockIdx.x * BN;
  const int n_tiles = (V + BV - 1) / BV;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const int nkd = d / BD;
  const int nchunks = max(0, t_end - t_begin) * nkd;

  auto load_chunk = [&](int c, int stage) {
    const int v0 = (t_begin + c / nkd) * BV;
    const int d0 = (c % nkd) * BD;
    bf16* hs = ring + stage * STAGE_ELEMS;
    bf16* ws = hs + BN * HS;
    for (int idx = tid; idx < (BN + BV) * (BD / 8); idx += NTHREADS) {
      const int rr = idx / (BD / 8), c8 = idx % (BD / 8);
      if (rr < BN) {
        const bool ok = r0 + rr < n;
        cp_async16(hs + rr * HS + c8 * 8, hidden + size_t(ok ? r0 + rr : 0) * d + d0 + c8 * 8, ok);
      } else {
        const int cc = rr - BN;
        const bool ok = v0 + cc < V;
        cp_async16(ws + cc * HS + c8 * 8, wT + size_t(ok ? v0 + cc : 0) * d + d0 + c8 * 8, ok);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) load_chunk(s, s);
    cp_async_commit();
  }

  // thread's rows: wr*32 + i*16 + h*8 + grp for i, h in {0, 1}
  float m_run[2][2], se[2][2], sx[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) m_run[i][h] = -CUDART_INF_F, se[i][h] = sx[i][h] = 0.f;
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait_stages();
    __syncthreads();  // chunk c visible; the stage of chunk c-1 is free
    if (c + STAGES - 1 < nchunks) load_chunk(c + STAGES - 1, (c + STAGES - 1) % STAGES);
    cp_async_commit();

    const bf16* hs = ring + (c % STAGES) * STAGE_ELEMS;
    const bf16* ws = hs + BN * HS;
#pragma unroll
    for (int kk = 0; kk < BD; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], hs + (wr * 32 + i * 16 + (lane & 15)) * HS + kk + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, ws + (wc * 64 + jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * HS + kk +
                           ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * jp], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * jp + 1], a[i], b[2], b[3]);
        }
      }
    }

    if ((c + 1) % nkd == 0) {  // a logits tile is complete: fold it, reset
      const int col0 = (t_begin + c / nkd) * BV + wc * 64 + 2 * t4;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mt = -CUDART_INF_F;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (col0 + j * 8 + e < V) mt = fmaxf(mt, acc[i][j][2 * h + e] * inv_temp);
          if (mt > m_run[i][h]) {  // rescale only when the running max moves
            const float r = expf(m_run[i][h] - mt);  // 0 when m_run = -inf
            se[i][h] *= r;
            sx[i][h] *= r;
            m_run[i][h] = mt;
          }
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (col0 + j * 8 + e < V) {
                const float x = acc[i][j][2 * h + e] * inv_temp;
                const float ex = expf(x - m_run[i][h]);
                se[i][h] += ex;
                sx[i][h] += ex * x;
              }
              acc[i][j][2 * h + e] = 0.f;
            }
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);  // drain the (empty) tail groups

  // merge the 4 threads of a quad (same rows), then the two column bands
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1)
        merge_stats(m_run[i][h], se[i][h], sx[i][h],
                    __shfl_xor_sync(0xffffffffu, m_run[i][h], off),
                    __shfl_xor_sync(0xffffffffu, se[i][h], off),
                    __shfl_xor_sync(0xffffffffu, sx[i][h], off));
  if (t4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* slot = xchg + (wc * BN + wr * 32 + i * 16 + h * 8 + grp) * 3;
        slot[0] = m_run[i][h];
        slot[1] = se[i][h];
        slot[2] = sx[i][h];
      }
  }
  __syncthreads();
  if (tid < BN && r0 + tid < n) {
    float m = xchg[tid * 3], s = xchg[tid * 3 + 1], x = xchg[tid * 3 + 2];
    const float* other = xchg + (BN + tid) * 3;
    merge_stats(m, s, x, other[0], other[1], other[2]);
    const size_t at = size_t(blockIdx.y) * n + r0 + tid;
    pm[at] = m;
    pse[at] = s;
    psx[at] = x;
  }
}

__global__ void lm_stats_merge(const float* __restrict__ pm, const float* __restrict__ pse,
                               const float* __restrict__ psx, int nsplit, int n,
                               float* __restrict__ lse, float* __restrict__ mean_x) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float m = -CUDART_INF_F, se = 0.f, sx = 0.f;
  for (int s = 0; s < nsplit; ++s)
    merge_stats(m, se, sx, pm[size_t(s) * n + r], pse[size_t(s) * n + r], psx[size_t(s) * n + r]);
  lse[r] = m + logf(se);
  mean_x[r] = sx / se;
}

}  // namespace

// Partials pm/pse/psx are caller-allocated [nsplit, n] f32 scratch.
// Requires d % 32 == 0 and 16-byte aligned hidden / wT; the Python wrapper
// checks these.
extern "C" int lm_stats_fwd(const void* hidden, const void* wT, void* pm, void* pse,
                            void* psx, void* lse, void* mean_x, int n, int d, int V,
                            int nsplit, float inv_temp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      lm_stats_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  const int n_tiles = (V + BV - 1) / BV;
  const int tiles_per_split = (n_tiles + nsplit - 1) / nsplit;
  dim3 grid((n + BN - 1) / BN, nsplit);
  lm_stats_partial<<<grid, NTHREADS, SMEM_BYTES, st>>>(
      static_cast<const bf16*>(hidden), static_cast<const bf16*>(wT),
      static_cast<float*>(pm), static_cast<float*>(pse), static_cast<float*>(psx), n, d,
      V, tiles_per_split, inv_temp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  lm_stats_merge<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(pm), static_cast<const float*>(pse),
      static_cast<const float*>(psx), nsplit, n, static_cast<float*>(lse),
      static_cast<float*>(mean_x));
  return int(cudaGetLastError());
}
