// Block-sparse tree-masked attention forward for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of dynamictreeattn_tpu/ops/tree_attention.py:
//   * _fwd_bound_kernel (K1): every row is shifted by a fixed per-row bound
//     C >= max score (C = scale*||q_row||*max||k||, computed outside the
//     kernel), so p = exp(s - C) needs no running max and no rescale; it
//     emits lse = C + log(sum p);
//   * _fwd_kernel (K2): classic online softmax (running m and l, rescale of
//     the accumulator); emits lse = m + log(l).
// The template flag BOUND selects the variant.
//
// Layouts (as the JAX package's): q [hkv, G, n, DH] bf16; k, v [hkv, n, DH]
// bf16; last_desc [n] i32; kv_ids / kv_types [nq, slots] i32; kv_counts [nq]
// i32; C [hkv, G, n] f32 (BOUND only) -> o [hkv, G, n, DH] bf16, lse
// [hkv, G, n] f32. The mask is k <= q <= last_desc[k], evaluated only on
// type-1 (partial) tiles; type-2 tiles are full.
//
// Design. On the TPU the kv slots are a sequential grid axis and the
// accumulators live in VMEM scratch across grid steps. Here one CTA owns a
// 64-row q tile of a slice of GS = 2 q heads of one GQA group (one K/V fetch
// serves GS*64 rows; one warp per 16 rows) and walks its q block's active kv
// blocks itself, in 64-key sub-tiles, FlashAttention-2 style: q fragments,
// scores, P and the fp32 output accumulator stay in registers (mma.sync
// m16n8k16 bf16, fragments loaded with ldmatrix); K/V sub-tiles are
// double-buffered in shared memory with cp.async, so the next sub-tile's
// copy overlaps this one's products. The group G is a run-time argument: the
// grid's third axis walks the ceil(G/GS) head slices, each re-reading the
// kv head's K/V tiles; at odd G the last slice's second head is idle: its q
// rows are zero-filled, its warps skip the products and store nothing. Templates are on (DH, BOUND) only, DH in {64, 128}. A 64x64
// sub-tile with no unmasked pair (no key k <= the tile's last row with
// last_desc[k] >= its first row) is skipped: its only effect on the TPU
// kernel is exactly cancelled later (alpha = 0), or is exactly zero (bound
// variant). Scores and statistics are fp32; P is rounded to bf16 before the
// PV product, as on the TPU.
//
// What bounds it on the card: ~4*DH flops per unmasked (q, k) pair per q
// head against one read of q/k/v, so it is operation-bound at the
// tensor-core rate; this version executes whole 64x64 sub-tiles with
// mma.sync (not wgmma), so it stays well above that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TQ = 64;  // q rows per head per CTA
constexpr int TK = 64;  // keys per sub-tile
constexpr int GS = 2;   // q heads of a GQA group per CTA (the group slice)
// same constant as the TPU kernels: -0.7 * float32 max
constexpr float MASK_VALUE = -0.7f * 3.402823466e38f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with valid == false nothing is read and dst is zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_prev() {  // all groups but the newest
  asm volatile("cp.async.wait_group 1;\n" ::);
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

// d += a * b for one m16n8k16 tile: a row-major 16x16, b col-major 16x8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DH>
struct Layout {
  static constexpr int R = GS * TQ;        // q rows per CTA
  static constexpr int NTHREADS = R * 2;   // one warp per 16 rows
  static constexpr int ST = DH + 8;        // bf16 row stride: conflict-free ldmatrix
  static constexpr size_t q_elems = size_t(R) * ST;
  static constexpr size_t kv_elems = size_t(TK) * ST;  // one buffer of K or V
  static constexpr size_t bytes = (q_elems + 4 * kv_elems) * 2 + 2 * TK * 4;
};

template <int DH, bool BOUND>
__global__ void __launch_bounds__(Layout<DH>::NTHREADS, 1)
tree_attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ last_desc,
                     const int* __restrict__ kv_ids, const int* __restrict__ kv_counts,
                     const int* __restrict__ kv_types, const float* __restrict__ cbound,
                     bf16* __restrict__ o, float* __restrict__ lse, int group, int n,
                     int block_q, int block_kv, int slots, float scale) {
  using L = Layout<DH>;
  constexpr int R = L::R, ST = L::ST, NT = L::NTHREADS;
  constexpr int V8 = DH / 8;  // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + L::q_elems;        // [2][TK][ST]
  bf16* Vs = Ks + 2 * L::kv_elems;   // [2][TK][ST]
  int* LDs = reinterpret_cast<int*>(Vs + 2 * L::kv_elems);  // [2][TK]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane >> 2, t4 = lane & 3;  // mma fragment coordinates
  const int r0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int qb = r0 / block_q;
  const int nsub = block_kv / TK;
  const int total = kv_counts[qb] * nsub;

  const int g0 = blockIdx.z * GS;  // first group head of this CTA's slice

  // this warp's 16 rows: head wg of the group, q positions wrow..wrow+15;
  // a warp of the idle head (odd group, last slice) computes and stores nothing
  const int wg = g0 + (warp * 16) / TQ;
  const bool active = wg < group;
  const int wrow = r0 + (warp * 16) % TQ;
  const int qpos[2] = {wrow + grp, wrow + grp + 8};
  const size_t row_base = (size_t(h) * group + (active ? wg : 0)) * n;

  // ---- q tile (cp.async group 0, with the first K/V sub-tile); the idle
  // head's rows are zero-filled
  for (int idx = tid; idx < R * V8; idx += NT) {
    const int rr = idx / V8, c8 = idx % V8;
    const int hg = g0 + rr / TQ;
    cp_async16(Qs + rr * ST + c8 * 8,
               q + ((size_t(h) * group + min(hg, group - 1)) * n + r0 + rr % TQ) * DH + c8 * 8,
               hg < group);
  }
  auto load_tile = [&](int it, int buf) {
    const int s = it / nsub, sub = it % nsub;
    const int c0 = kv_ids[qb * slots + s] * block_kv + sub * TK;
    for (int idx = tid; idx < TK * V8; idx += NT) {
      const int j = idx / V8, c8 = idx % V8;
      const size_t off = (size_t(h) * n + c0 + j) * DH + c8 * 8;
      cp_async16(Ks + (buf * TK + j) * ST + c8 * 8, k + off);
      cp_async16(Vs + (buf * TK + j) * ST + c8 * 8, v + off);
    }
    if (tid < TK / 4) cp_async16(LDs + buf * TK + tid * 4, last_desc + c0 + tid * 4);
  };
  if (total > 0) load_tile(0, 0);
  cp_async_commit();

  float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_r[2] = {0.f, 0.f}, c_r[2] = {0.f, 0.f};
  if (BOUND && active) {
    c_r[0] = cbound[row_base + qpos[0]];
    c_r[1] = cbound[row_base + qpos[1]];
  }
  float o_acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) o_acc[j][0] = o_acc[j][1] = o_acc[j][2] = o_acc[j][3] = 0.f;
  uint32_t q_frag[DH / 16][4];

  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    if (it + 1 < total) load_tile(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // this sub-tile (and at it == 0 the q tile) is visible

    const int s = it / nsub;
    const int typ = kv_types[qb * slots + s];
    const int c0 = kv_ids[qb * slots + s] * block_kv + (it % nsub) * TK;
    const int* ld = LDs + buf * TK;
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks)
        ldmatrix_x4(q_frag[ks], Qs + (warp * 16 + (lane & 15)) * ST + ks * 16 + (lane >> 4) * 8);
    }
    // skip a sub-tile holding no unmasked (q, k) pair of this q tile
    const int live = tid < TK && c0 + tid <= r0 + TQ - 1 && ld[tid] >= r0;
    if (!__syncthreads_or(live)) continue;
    if (!active) {
      __syncthreads();  // the buffer may be refilled by the next iteration
      continue;
    }

    const bf16* Kb = Ks + buf * TK * ST;
    const bf16* Vb = Vs + buf * TK * ST;

    // ---- S = Q K^T: 16 x TK per warp, fp32 in registers
    float s_acc[TK / 8][4];
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) s_acc[j][0] = s_acc[j][1] = s_acc[j][2] = s_acc[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < TK / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, Kb + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * ST + ks * 16 +
                           ((lane >> 3) & 1) * 8);
        mma_bf16(s_acc[2 * np], q_frag[ks], b[0], b[1]);
        mma_bf16(s_acc[2 * np + 1], q_frag[ks], b[2], b[3]);
      }
    }

    // ---- scale, mask (partial tiles only), softmax statistics
    // element e of n-tile j: key j*8 + 2*t4 + (e & 1), row grp + 8*(e >> 1)
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s_acc[j][e] * scale;
        if (typ == 1) {
          const int kl = j * 8 + 2 * t4 + (e & 1);
          const int qp = qpos[e >> 1];
          x += (c0 + kl <= qp && qp <= ld[kl]) ? 0.f : MASK_VALUE;
        }
        s_acc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float shift[2], alpha[2] = {1.f, 1.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (BOUND) {
        shift[r] = c_r[r];
      } else {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        shift[r] = fmaxf(m_r[r], mx[r]);
        alpha[r] = expf(m_r[r] - shift[r]);  // 0 on the first live tile (m = -inf)
        m_r[r] = shift[r];
      }
    }
    float rs[2] = {0.f, 0.f};
    uint32_t p_frag[TK / 16][4];  // P as the A operand of the PV product
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
      const float p0 = expf(s_acc[j][0] - shift[0]), p1 = expf(s_acc[j][1] - shift[0]);
      const float p2 = expf(s_acc[j][2] - shift[1]), p3 = expf(s_acc[j][3] - shift[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      p_frag[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
      p_frag[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    // per-thread partial row sums; the quad's partials are summed at the end
    l_r[0] = alpha[0] * l_r[0] + rs[0];
    l_r[1] = alpha[1] * l_r[1] + rs[1];
    if (!BOUND) {
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        o_acc[j][0] *= alpha[0];
        o_acc[j][1] *= alpha[0];
        o_acc[j][2] *= alpha[1];
        o_acc[j][3] *= alpha[1];
      }
    }

    // ---- O += P V
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Vb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ST + dp * 16 +
                                 (lane >> 4) * 8);
        mma_bf16(o_acc[2 * dp], p_frag[kk], b[0], b[1]);
        mma_bf16(o_acc[2 * dp + 1], p_frag[kk], b[2], b[3]);
      }
    }
    __syncthreads();  // the buffer may be refilled by the next iteration
  }

  // ---- emit o = acc / l (l == 0 -> 1) and lse
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  const float inv0 = l_r[0] == 0.f ? 1.f : 1.f / l_r[0];
  const float inv1 = l_r[1] == 0.f ? 1.f : 1.f / l_r[1];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int d = j * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(o + (row_base + qpos[0]) * DH + d) =
        __floats2bfloat162_rn(o_acc[j][0] * inv0, o_acc[j][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(o + (row_base + qpos[1]) * DH + d) =
        __floats2bfloat162_rn(o_acc[j][2] * inv1, o_acc[j][3] * inv1);
  }
  if (t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      lse[row_base + qpos[r]] = (BOUND ? c_r[r] : m_r[r]) + logf(fmaxf(l_r[r], 1e-30f));
  }
}

template <int DH, bool BOUND>
int launch(const void* q, const void* k, const void* v, const void* last_desc,
           const void* kv_ids, const void* kv_counts, const void* kv_types,
           const void* cbound, void* o, void* lse, int hkv, int group, int n, int block_q,
           int block_kv, int slots, float scale, cudaStream_t stream) {
  using L = Layout<DH>;
  auto kernel = tree_attn_fwd_kernel<DH, BOUND>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::bytes));
  if (err != cudaSuccess) return int(err);
  dim3 grid(n / TQ, hkv, (group + GS - 1) / GS);
  kernel<<<grid, L::NTHREADS, L::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(last_desc),
      static_cast<const int*>(kv_ids), static_cast<const int*>(kv_counts),
      static_cast<const int*>(kv_types), static_cast<const float*>(cbound),
      static_cast<bf16*>(o), static_cast<float*>(lse), group, n, block_q, block_kv,
      slots, scale);
  return int(cudaGetLastError());
}

template <bool BOUND>
int dispatch(const void* q, const void* k, const void* v, const void* last_desc,
             const void* kv_ids, const void* kv_counts, const void* kv_types,
             const void* cbound, void* o, void* lse, int hkv, int group, int n,
             int dh, int block_q, int block_kv, int slots, float scale,
             cudaStream_t stream) {
  if (group < 1) return int(cudaErrorInvalidValue);
  if (dh == 128)
    return launch<128, BOUND>(q, k, v, last_desc, kv_ids, kv_counts, kv_types, cbound, o, lse,
                              hkv, group, n, block_q, block_kv, slots, scale, stream);
  if (dh == 64)
    return launch<64, BOUND>(q, k, v, last_desc, kv_ids, kv_counts, kv_types, cbound, o, lse,
                             hkv, group, n, block_q, block_kv, slots, scale, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// bound != 0: K1 (cbound required); bound == 0: K2 (cbound ignored).
// Requires n % block_q == 0, block_q % 64 == 0, block_kv % 64 == 0,
// dh in {64, 128}, group >= 1 (the Python wrapper takes 1..8), 16-byte
// aligned q/k/v/last_desc; the Python wrapper checks these.
extern "C" int tree_attn_fwd(int bound, const void* q, const void* k, const void* v,
                             const void* last_desc, const void* kv_ids,
                             const void* kv_counts, const void* kv_types,
                             const void* cbound, void* o, void* lse, int hkv,
                             int group, int n, int dh, int block_q, int block_kv,
                             int slots, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bound)
    return dispatch<true>(q, k, v, last_desc, kv_ids, kv_counts, kv_types, cbound, o,
                          lse, hkv, group, n, dh, block_q, block_kv, slots, scale, st);
  return dispatch<false>(q, k, v, last_desc, kv_ids, kv_counts, kv_types, cbound, o,
                         lse, hkv, group, n, dh, block_q, block_kv, slots, scale, st);
}
