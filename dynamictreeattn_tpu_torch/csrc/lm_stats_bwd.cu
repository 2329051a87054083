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
// bf16, dWT [V, d] bf16; scratch dl [n_pad, V_pad] bf16 (n, V rounded up to
// 128), caller-allocated.
//
// Design. The TPU kernel walks vocab blocks in order on one core, keeps all
// n rows resident and accumulates dhidden in its output window across the
// walk; each dWT block is one [bv, d] fp32 VMEM tile. A CTA here has no room
// for a [bv, d] fp32 tile beside the logits (d = 1024: 512 KB at bv = 128),
// and CTAs cannot carry a sum across the grid. So the three products run as
// three passes, each writing every output tile exactly once, no atomics:
//   1. lm_bwd_dlogits: one CTA per 128 x 128 logits tile recomputes x (K8's
//      mainloop: 4-stage cp.async ring of 32-deep chunks, mma.sync m16n8k16,
//      8 warps of 32 x 64) and writes dl in bf16 — the [n, V] dl is the one
//      intermediate that reaches device memory (2 bytes a logit);
//   2. gemm (A = dl^T): dWT = dl^T hidden, one CTA per 128 x 128 dWT tile,
//      contraction over the rows;
//   3. gemm (A = dl): dhidden = dl W^T, one CTA per 128 x 128 dhidden tile,
//      contraction over the vocabulary.
// Each pass is deterministic; nothing is merged across CTAs.
//
// What bounds it on the card: 3 * 2*n*d*V flops (x, dhidden, dWT) against
// one read of hidden and W and one write of dhidden and dWT, so it is
// operation-bound at the bf16 tensor-core rate. Extra bytes of this design:
// dl written once and read twice (6*n*V bytes, ~6 GB at n = 6656, about 2 ms
// at 3.35 TB/s). This version uses mma.sync (not wgmma).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128;     // rows of a CTA's output tile
constexpr int BN = 128;     // columns of a CTA's output tile
constexpr int BK = 32;      // depth chunk per pipeline stage
constexpr int STAGES = 4;
constexpr int NTHREADS = 256;  // 8 warps of 32 x 64
constexpr int GROUP_ROWS = 32;  // dlogits: row tiles sharing a vocab sweep (L2 reuse)

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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// Shared-memory tile shapes of one pipeline stage. A tile: [BM][BK] when A
// is stored [M][K] (rows of the output), [BK][BM] when stored [K][M]; B tile
// [BK][BN] ([K][N] storage) or, for the dlogits pass, [BN][BK] (rows of wT).
// Strides padded by 8 bf16 so that 8 ldmatrix rows hit 8 distinct banks.
constexpr int S_MK = BK + 8;
constexpr int S_KN = BN + 8;
constexpr int TILE_MK = BM * S_MK;  // = BN * S_MK
constexpr int TILE_KN = BK * S_KN;

// acc (a warp's 32 x 64, fp32) += A . B over one BK chunk. A_KM: A stored
// [K][M] in `as` (else [M][K]); B_KN: B stored [K][N] in `bs` (else [N][K]).
template <bool A_KM, bool B_KN>
__device__ __forceinline__ void warp_mma_chunk(float (&acc)[2][8][4], const bf16* as,
                                               const bf16* bs, int wr, int wc, int lane) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m0 = wr * 32 + i * 16;
      if (A_KM)
        ldmatrix_x4_trans(a[i], as + (kk + (lane & 7) + ((lane >> 4) << 3)) * S_KN + m0 +
                                    ((lane >> 3) & 1) * 8);
      else
        ldmatrix_x4(a[i], as + (m0 + (lane & 15)) * S_MK + kk + (lane >> 4) * 8);
    }
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      const int n0 = wc * 64 + jp * 16;
      uint32_t b[4];
      if (B_KN)
        ldmatrix_x4_trans(b, bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * S_KN + n0 +
                                 (lane >> 4) * 8);
      else
        ldmatrix_x4(b, bs + (n0 + (lane & 7) + ((lane >> 4) << 3)) * S_MK + kk +
                           ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_bf16(acc[i][2 * jp], a[i], b[0], b[1]);
        mma_bf16(acc[i][2 * jp + 1], a[i], b[2], b[3]);
      }
    }
  }
}

// ------------------------------------------------------ pass 1: dlogits

constexpr int DL_STAGE = 2 * TILE_MK;  // hidden [BM][BK] + wT [BN][BK]
constexpr size_t DL_SMEM = size_t(STAGES) * DL_STAGE * 2;

__global__ void __launch_bounds__(NTHREADS, 2)
lm_bwd_dlogits(const bf16* __restrict__ hidden, const bf16* __restrict__ wT,
               const float* __restrict__ lse, const float* __restrict__ a_row,
               const float* __restrict__ b_row, bf16* __restrict__ dl, int n, int d, int V,
               int n_pad, int V_pad, float inv_temp) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane >> 2, t4 = lane & 3;
  const int wr = warp >> 1, wc = warp & 1;
  // grouped order: GROUP_ROWS row tiles sweep the vocabulary together, so
  // their hidden tiles stay in L2 while each wT tile is read once per group
  const int n_rt = n_pad / BM, n_vt = V_pad / BN;
  const int per_group = GROUP_ROWS * n_vt;
  const int first_rt = (blockIdx.x / per_group) * GROUP_ROWS;
  const int rows_here = min(GROUP_ROWS, n_rt - first_rt);
  const int local = blockIdx.x % per_group;
  const int r0 = (first_rt + local % rows_here) * BM;
  const int v0 = (local / rows_here) * BN;
  const int nchunks = d / BK;

  auto load_chunk = [&](int c, int stage) {
    const int d0 = c * BK;
    bf16* hs = ring + stage * DL_STAGE;
    bf16* ws = hs + TILE_MK;
    for (int idx = tid; idx < (BM + BN) * (BK / 8); idx += NTHREADS) {
      const int rr = idx / (BK / 8), c8 = idx % (BK / 8);
      if (rr < BM) {
        const bool ok = r0 + rr < n;
        cp_async16(hs + rr * S_MK + c8 * 8, hidden + size_t(ok ? r0 + rr : 0) * d + d0 + c8 * 8, ok);
      } else {
        const int cc = rr - BM;
        const bool ok = v0 + cc < V;
        cp_async16(ws + cc * S_MK + c8 * 8, wT + size_t(ok ? v0 + cc : 0) * d + d0 + c8 * 8, ok);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) load_chunk(s, s);
    cp_async_commit();
  }
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
    const bf16* hs = ring + (c % STAGES) * DL_STAGE;
    warp_mma_chunk<false, false>(acc, hs, hs + TILE_MK, wr, wc, lane);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // ---- dl = exp(x - lse) * (a - b*x) * inv_temp, 0 past n rows / V columns
  // acc[i][j][2*h + e]: row wr*32 + i*16 + h*8 + grp, col wc*64 + j*8 + 2*t4 + e
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + wr * 32 + i * 16 + h * 8 + grp;
      const bool row_ok = row < n;
      const float l = row_ok ? lse[row] : 0.f;
      const float ar = row_ok ? a_row[row] : 0.f;
      const float br = row_ok ? b_row[row] : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = v0 + wc * 64 + j * 8 + 2 * t4;
        float out[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = acc[i][j][2 * h + e] * inv_temp;
          out[e] = row_ok && col + e < V ? expf(x - l) * (ar - br * x) * inv_temp : 0.f;
        }
        *reinterpret_cast<__nv_bfloat162*>(dl + size_t(row) * V_pad + col) =
            __floats2bfloat162_rn(out[0], out[1]);
      }
    }
  }
}

// --------------------------------------------------- passes 2, 3: gemm

// C[M, N] = sum_k A(m, k) B(k, n) in bf16 with fp32 accumulation. A is
// stored [K][M] (A_KM) or [M][K], row stride lda, every row readable; B is
// stored [K][N], row stride ldb, rows k >= kb_valid read as zero; rows
// m >= m_valid of C are not written. K % BK == 0, N % BN == 0.
template <bool A_KM>
__global__ void __launch_bounds__(NTHREADS, 2)
gemm_bf16(const bf16* __restrict__ A, int lda, const bf16* __restrict__ B, int ldb,
          bf16* __restrict__ C, int ldc, int m_valid, int K, int kb_valid) {
  constexpr int A_TILE = A_KM ? TILE_KN : TILE_MK;
  constexpr int STAGE = A_TILE + TILE_KN;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane >> 2, t4 = lane & 3;
  const int wr = warp >> 1, wc = warp & 1;
  // the N tiles of one M tile are neighbours in launch order: they share
  // their A tile through L2
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nchunks = K / BK;

  auto load_chunk = [&](int c, int stage) {
    const int k0 = c * BK;
    bf16* as = ring + stage * STAGE;
    bf16* bs = as + A_TILE;
    for (int idx = tid; idx < BK * (BN / 8); idx += NTHREADS) {  // 512: BM*BK/8 too
      if (A_KM) {
        const int kr = idx / (BM / 8), c8 = idx % (BM / 8);
        cp_async16(as + kr * S_KN + c8 * 8, A + size_t(k0 + kr) * lda + m0 + c8 * 8, true);
      } else {
        const int rr = idx / (BK / 8), c8 = idx % (BK / 8);
        cp_async16(as + rr * S_MK + c8 * 8, A + size_t(m0 + rr) * lda + k0 + c8 * 8, true);
      }
      const int kr = idx / (BN / 8), c8 = idx % (BN / 8);
      const bool ok = k0 + kr < kb_valid;
      cp_async16(bs + kr * S_KN + c8 * 8, B + size_t(ok ? k0 + kr : 0) * ldb + n0 + c8 * 8, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) load_chunk(s, s);
    cp_async_commit();
  }
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait_stages();
    __syncthreads();
    if (c + STAGES - 1 < nchunks) load_chunk(c + STAGES - 1, (c + STAGES - 1) % STAGES);
    cp_async_commit();
    const bf16* as = ring + (c % STAGES) * STAGE;
    warp_mma_chunk<A_KM, true>(acc, as, as + A_TILE, wr, wc, lane);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wr * 32 + i * 16 + h * 8 + grp;
      if (row >= m_valid) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + wc * 64 + j * 8 + 2 * t4;
        *reinterpret_cast<__nv_bfloat162*>(C + size_t(row) * ldc + col) =
            __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

template <bool A_KM>
int launch_gemm(const bf16* A, int lda, const bf16* B, int ldb, bf16* C, int ldc, int m_pad,
                int m_valid, int N, int K, int kb_valid, cudaStream_t st) {
  const size_t bytes = size_t(STAGES) * ((A_KM ? TILE_KN : TILE_MK) + TILE_KN) * 2;
  cudaError_t err = cudaFuncSetAttribute(gemm_bf16<A_KM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  dim3 grid(N / BN, m_pad / BM);
  gemm_bf16<A_KM><<<grid, NTHREADS, bytes, st>>>(A, lda, B, ldb, C, ldc, m_valid, K, kb_valid);
  return int(cudaGetLastError());
}

}  // namespace

// n_pad, V_pad: n and V rounded up to 128. Requires d % 128 == 0 and 16-byte
// aligned tensors; the Python wrapper checks these.
extern "C" int lm_stats_bwd(const void* hidden, const void* wT, const void* lse, const void* a,
                            const void* b, void* dl, void* dh, void* dwT, int n, int d, int V,
                            int n_pad, int V_pad, float inv_temp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* h = static_cast<const bf16*>(hidden);
  const bf16* w = static_cast<const bf16*>(wT);
  bf16* dlp = static_cast<bf16*>(dl);
  cudaError_t err =
      cudaFuncSetAttribute(lm_bwd_dlogits, cudaFuncAttributeMaxDynamicSharedMemorySize, int(DL_SMEM));
  if (err != cudaSuccess) return int(err);
  lm_bwd_dlogits<<<(n_pad / BM) * (V_pad / BN), NTHREADS, DL_SMEM, st>>>(
      h, w, static_cast<const float*>(lse), static_cast<const float*>(a),
      static_cast<const float*>(b), dlp, n, d, V, n_pad, V_pad, inv_temp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  // dWT [V, d] = dl^T [V_pad x n_pad] . hidden [n_pad x d]
  int code = launch_gemm<true>(dlp, V_pad, h, d, static_cast<bf16*>(dwT), d, V_pad, V, d, n_pad,
                               n, st);
  if (code != 0) return code;
  // dhidden [n, d] = dl [n_pad x V_pad] . wT [V_pad x d]
  return launch_gemm<false>(dlp, V_pad, w, d, static_cast<bf16*>(dh), d, n_pad, n, d, V_pad, V,
                            st);
}
