// Block-sparse tree-masked attention forward for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of dynamictreeattn_tpu/ops/tree_attention.py:
//   * _fwd_bound_kernel (K1): every row is shifted by a fixed per-row bound
//     C >= max score (C = scale*||q_row||*max||k||, computed outside the
//     kernel), so p = exp(s - C) needs no running max and no rescale; it
//     emits lse = C + log(sum p);
//   * _fwd_kernel (K2): classic online softmax (running m and l, rescale of
//     the accumulator); emits lse = m + log(l).
// One kernel holds both bodies. The branch argument picks one (a direct
// K1 / K2 call), or names a device-side flag, max(C) < 40, that the kernel
// reads once (the dispatch's choice, which the JAX package makes with
// lax.cond: no host read). Thread 0 of block 0 records the branch taken in a
// small int32 record: [0] launches, [1] bound launches, [2 + i % cap] the
// branch of launch i.
//
// Layouts (as the JAX package's): q [hkv, G, n, DH] bf16; k, v [hkv, n, DH]
// bf16; last_desc [n] i32; C [hkv, G, n] f32 -> o [hkv, G, n, DH] bf16, lse
// [hkv, G, n] f32. The mask is k <= q <= last_desc[k]; a ring pair (the JAX
// kernel's `offs`) passes the global positions of its first query and first
// key, q_off and kv_off, and the whole last_desc: the mask is then
// kv_off + k <= q_off + q <= last_desc[kv_off + k], with q, o, lse and K, V
// indexed locally. The kernel is instantiated with and without offsets
// (OFFS): at offset 0 the one-device code runs as written before the
// offsets (folding zero offsets into per-row values at run time slowed K1
// and K2 on the card, in a same-call A/B against the earlier kernel); with
// them, the offsets are folded into two per-row values up front, so the
// per-element test is the same two compares.
//
// The work list (tries.build_qmajor_work, built once per batch on the
// host) and the CTA's structure are the query-major walk of hopper.cuh
// (hopper::qmajor), shared with K11. A sub-tile with no unmasked pair is
// not listed: on the TPU its only effect is exactly cancelled later (alpha =
// 0), or is exactly zero (bound variant). A full sub-tile (every pair
// unmasked) skips the mask; a partial one adds MASK_VALUE where k <= q <=
// last_desc[k] fails.
//
// Design. A CTA owns one q tile of a slice of GS = 2 q heads of one GQA
// group. Warpgroups 0 and 1 are consumers, one group head each (64 rows);
// warpgroup 2 is the producer: one of its threads loads the two heads' Q
// tiles and then walks the tile's entries, keeping a ring of STAGES (K, V,
// last_desc) sub-tiles full (qmajor::fill_ring); both consumers read each
// stage. The producer gives registers back (setmaxnreg 40) and the
// consumers take them (232): at the 168 a 384-thread CTA enters with, the
// walk below spilled.
//
// A consumer walks its entries one sub-tile ahead, FlashAttention-3 style:
// S = Q K^T of sub-tile i (wgmma m64n64k16, Q and K K-major in shared
// memory) and O += P V of sub-tile i - 1 (wgmma m64nDHk16, P from registers,
// V MN-major in shared memory) go out together; the softmax of i -- scale
// and mask in the log2 domain (scale * log2 e folded in, exp2 by the MUFU's
// ex2.approx: ~2 ulp of fp32), P rounded to bf16 -- runs while that PV
// product does. Two P buffers take turns, and the softmax only reads the S
// accumulator (the online variant keeps its scaled scores apart): ptxas
// serialises every wgmma of a kernel whose ordinary instructions write a
// product's input registers while it may be in flight. fp32 O, m and l stay
// in registers; a warp releases a stage once its PV product is done. At odd
// G the last slice's second warpgroup exits at once: its head does not
// exist, nothing is loaded for it and it stores nothing.
//
// Latent attention (MLA, models/deepseek_v3.py) scores q . k over DH = 192
// (a 128-wide part and a 64-wide RoPE part) and sums p v over DV = 128:
// tree_attn_fwd_mla_kernel<192, 128> is the same CTA with the Q and K tiles
// DH wide and the V tiles and O DV wide (S = Q K^T over 12 k-steps, O += P V
// at n = DV), at group 1, so the slice's second warpgroup idles and each
// CTA computes one head; 4 stages of (K, V, last_desc) fit in 215 KB. The
// equal-width kernels keep their names (tree_attn_fwd_kernel<DH, OFFS>).
//
// What bounds it on the card: ~2*(DH + DV) flops per unmasked (q, k) pair per q
// head against one read of q/k/v -- operation-bound at the tensor-core rate.
// This version computes whole 64 x 64 sub-tiles, masked pairs included, and
// its two consumers share one SM's tensor cores without a fixed turn order.

#include <math_constants.h>

#include "hopper.cuh"

namespace fwd {

using namespace hopper;
using namespace hopper::qmajor;

// same constant as the TPU kernels: -0.7 * float32 max
constexpr float MASK_VALUE = -0.7f * 3.402823466e38f;
constexpr float LN2 = 0.6931471805599453f;

template <int DH, int DV = DH>
struct Layout {
  // ring stages: one CTA an SM (its registers), 4 stages fit in 227 KB
  static constexpr int STAGES = 4;
  static constexpr int TILE = TK * DH * 2;    // a [64][DH] bf16 q or k tile: DH / 64 boxes
  static constexpr int TILE_V = TK * DV * 2;  // a [64][DV] bf16 v tile
  static constexpr int Q_OFF = 0;             // [GS] tiles
  static constexpr int K_OFF = Q_OFF + GS * TILE;         // [STAGES] tiles
  static constexpr int V_OFF = K_OFF + STAGES * TILE;     // [STAGES] v tiles
  static constexpr int LD_OFF = V_OFF + STAGES * TILE_V;  // last_desc [STAGES][64] i32
  static constexpr int BAR_OFF = LD_OFF + STAGES * TK * 4;  // full[STAGES], empty[STAGES], q
  static constexpr int BYTES = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;  // + room to align the base
};

// ---------------------------------------------------------------------- kernel

struct Params {
  const int* last_desc;
  const int* entries;
  const float* cbound;
  bf16* o;
  float* lse;
  int group, n;
  float scale;
  int q_off, kv_off;  // global positions of the first query and the first key (0 on one device)
};

// One consumer warpgroup's walk over its q tile's entries for group head g:
// 64 rows, fp32 O / m / l in registers; BOUND shifts by C (no running max).
template <int DH, int DV, bool BOUND, bool OFFS>
__device__ __forceinline__ void consume(const Params& a, uint32_t base, const unsigned char* sm,
                                        uint32_t sQg, int h, int g, int r0, int e0, int cnt) {
  using L = Layout<DH, DV>;
  constexpr int S = L::STAGES, NJ = DV / 8;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int grp = lane >> 2, t4 = lane & 3;  // accumulator fragment coordinates
  const uint32_t sK = base + L::K_OFF, sV = base + L::V_OFF, bars = base + L::BAR_OFF;
  const int* LDs = reinterpret_cast<const int*>(sm + L::LD_OFF);
  // this thread's rows: q positions qrow[0], qrow[1] of head g
  const int qrow[2] = {r0 + warp * 16 + grp, r0 + warp * 16 + grp + 8};
  // the mask's two sides for these rows: the query in the keys' local
  // positions (k <= it) and its global position (it <= last_desc)
  const int shift_k = OFFS ? a.q_off - a.kv_off : 0, shift_g = OFFS ? a.q_off : 0;
  const int qk[2] = {qrow[0] + shift_k, qrow[1] + shift_k};
  const int qg[2] = {qrow[0] + shift_g, qrow[1] + shift_g};
  const size_t row_base = (size_t(h) * a.group + g) * a.n;
  const float scale_log2 = a.scale * LOG2E;

  // log2-domain shift: C * log2 e (bound) or the running max (online)
  float m2[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_r[2] = {0.f, 0.f}, c_r[2] = {0.f, 0.f};
  if (BOUND) {
    c_r[0] = a.cbound[row_base + qrow[0]];
    c_r[1] = a.cbound[row_base + qrow[1]];
    m2[0] = c_r[0] * LOG2E;
    m2[1] = c_r[1] * LOG2E;
  }
  float o_acc[NJ][4];
  zero(o_acc);
  mbar_wait(bars + 8 * 2 * S, 0);  // the Q tiles

  float s_acc[TK / 8][4];
  uint32_t pA[TK / 16][4], pB[TK / 16][4];  // P of two sub-tiles in turn
  // S = Q K^T of sub-tile `it` (stage it % S), issued as one product group
  auto issue_s = [&](int it) {
    zero(s_acc);
    pin(s_acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_n64(s_acc, desc_kmaj(sQg, kk), desc_kmaj(sK + (it % S) * L::TILE, kk), kk);
    wg_commit();
  };
  // O += P V of sub-tile `it`, P from `p`, issued as one product group
  auto issue_pv = [&](int it, uint32_t (&p)[TK / 16][4]) {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      wgmma_rs_t<DV>(o_acc, p[kk], desc_mnmaj(sV + (it % S) * L::TILE_V, kk));
    wg_commit();
  };
  // P of sub-tile `it` from s_acc into `p` (s_acc only read: a product may
  // be in flight); the online variant returns the rescale factors
  auto softmax = [&](int it, uint32_t (&p)[TK / 16][4], float (&alpha)[2]) {
    const int e = a.entries[e0 + it];
    const int c0 = e >> 1;
    const bool partial = e & 1;
    const int* ld = LDs + (it % S) * TK;
    auto score = [&](int j, int el) {
      float x = s_acc[j][el] * scale_log2;
      if (partial) {
        const int2 ld2 = *reinterpret_cast<const int2*>(ld + j * 8 + 2 * t4);
        const int kp = c0 + j * 8 + 2 * t4 + (el & 1);
        if constexpr (OFFS) {
          x += (kp <= qk[el >> 1] && qg[el >> 1] <= ((el & 1) ? ld2.y : ld2.x)) ? 0.f : MASK_VALUE;
        } else {  // the one-device test, as written before the offsets
          const int qp = qrow[el >> 1];
          x += (kp <= qp && qp <= ((el & 1) ? ld2.y : ld2.x)) ? 0.f : MASK_VALUE;
        }
      }
      return x;
    };
    alpha[0] = alpha[1] = 1.f;
    float xs[TK / 8][4];  // the online variant's scaled, masked scores
    if (!BOUND) {
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < TK / 8; ++j)
#pragma unroll
        for (int el = 0; el < 4; ++el) {
          xs[j][el] = score(j, el);
          mx[el >> 1] = fmaxf(mx[el >> 1], xs[j][el]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m2[r], mx[r]);
        alpha[r] = ex2(m2[r] - m_new);  // 0 on the row's first sub-tile (m = -inf)
        m2[r] = m_new;
      }
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
      const float p0 = ex2((BOUND ? score(j, 0) : xs[j][0]) - m2[0]);
      const float p1 = ex2((BOUND ? score(j, 1) : xs[j][1]) - m2[0]);
      const float p2 = ex2((BOUND ? score(j, 2) : xs[j][2]) - m2[1]);
      const float p3 = ex2((BOUND ? score(j, 3) : xs[j][3]) - m2[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      p[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
      p[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l_r[0] = alpha[0] * l_r[0] + rs[0];
    l_r[1] = alpha[1] * l_r[1] + rs[1];
  };
  auto release = [&](int it) {  // this warp is done with stage it % S
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (S + it % S));
  };
  // sub-tile it: S of it and O += P V of it - 1 go out together; the
  // softmax of it overlaps that PV product
  auto step = [&](int it, uint32_t (&p_prev)[TK / 16][4], uint32_t (&p_cur)[TK / 16][4]) {
    float alpha[2];
    mbar_wait(bars + 8 * (it % S), (it / S) & 1);
    issue_s(it);
    issue_pv(it - 1, p_prev);
    wg_wait_one();  // S of sub-tile it
    pin(s_acc);
    softmax(it, p_cur, alpha);
    wg_wait_all();  // O += P V of sub-tile it - 1
    pin(o_acc);
    pin(p_prev);
    pin(s_acc);  // s_acc lives through the stage: no softmax value takes its registers
    release(it - 1);
    if (!BOUND) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        o_acc[j][0] *= alpha[0];
        o_acc[j][1] *= alpha[0];
        o_acc[j][2] *= alpha[1];
        o_acc[j][3] *= alpha[1];
      }
    }
  };
  auto last = [&](uint32_t (&p)[TK / 16][4]) {
    issue_pv(cnt - 1, p);
    wg_wait_all();
    pin(o_acc);
    pin(p);
    release(cnt - 1);
  };

  if (cnt > 0) {
    float alpha[2];
    mbar_wait(bars, 0);  // stage 0
    issue_s(0);
    wg_wait_all();
    pin(s_acc);
    softmax(0, pA, alpha);  // O is zero: no rescale
    int it = 1;
    for (; it + 1 < cnt; it += 2) {
      step(it, pA, pB);
      step(it + 1, pB, pA);
    }
    if (it < cnt) {
      step(it, pA, pB);
      last(pB);
    } else {
      last(pA);
    }
  }

  // ---- emit o = acc / l (l == 0 -> 1) and lse
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  const float inv0 = l_r[0] == 0.f ? 1.f : 1.f / l_r[0];
  const float inv1 = l_r[1] == 0.f ? 1.f : 1.f / l_r[1];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int d = j * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(a.o + (row_base + qrow[0]) * DV + d) =
        __floats2bfloat162_rn(o_acc[j][0] * inv0, o_acc[j][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(a.o + (row_base + qrow[1]) * DV + d) =
        __floats2bfloat162_rn(o_acc[j][2] * inv1, o_acc[j][3] * inv1);
  }
  if (t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      a.lse[row_base + qrow[r]] = (BOUND ? c_r[r] : m2[r] * LN2) + logf(fmaxf(l_r[r], 1e-30f));
  }
}

// one CTA of either kernel below: q and k DH wide, v and o DV wide
template <int DH, int DV, bool OFFS>
__device__ __forceinline__ void fwd_cta(const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                        const int* __restrict__ tiles, const unsigned char* __restrict__ flag,
                                        int branch, int* __restrict__ record, int record_cap, int hkv,
                                        const Params& a) {
  using L = Layout<DH, DV>;
  constexpr int S = L::STAGES, NB = DH / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the 128-byte swizzle repeats every 1024 bytes
  const unsigned char* sm = smem_raw + (base - raw);
  const uint32_t sQ = base + L::Q_OFF, sK = base + L::K_OFF, sV = base + L::V_OFF;
  const uint32_t sLD = base + L::LD_OFF, bars = base + L::BAR_OFF;

  const int tid = threadIdx.x, wg = tid / 128;
  const Cta c = cta(tiles, hkv, a.group);
  // the branch, one uniform read: 2 = the one the device-side flag names
  const bool bound = branch == 2 ? *flag != 0 : branch == 1;

  if (tid == 0) {
    if (blockIdx.x == 0) {
      const int i = atomicAdd(record, 1);
      if (bound) atomicAdd(record + 1, 1);
      record[2 + i % record_cap] = bound;
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);                  // full: the producer's expect_tx + the copies
      mbar_init(bars + 8 * (S + s), 4 * c.heads);  // empty: every consumer warp
    }
    mbar_init(bars + 8 * 2 * S, 1);                // the Q tiles
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == GS) {  // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    if (tid == NCONS) {
      const uint32_t qbar = bars + 8 * 2 * S;
      mbar_expect_tx(qbar, c.heads * L::TILE);
      for (int hh = 0; hh < c.heads; ++hh)
#pragma unroll
        for (int x = 0; x < NB; ++x)
          tma_box(sQ + hh * L::TILE + x * BOX_BYTES, tm_q, qbar, x * 64,
                  (c.h * a.group + c.g0 + hh) * a.n + c.r0);
      fill_ring<DH, S, DV>(tm_k, tm_v, a.last_desc + (OFFS ? a.kv_off : 0), a.entries, c, a.n, sK, sV, sLD, bars);
    }
    return;
  }
  if (wg >= c.heads) return;  // the idle head of an odd group's last slice
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
  if (bound)
    consume<DH, DV, true, OFFS>(a, base, sm, sQ + wg * L::TILE, c.h, c.g0 + wg, c.r0, c.e0, c.cnt);
  else
    consume<DH, DV, false, OFFS>(a, base, sm, sQ + wg * L::TILE, c.h, c.g0 + wg, c.r0, c.e0, c.cnt);
}

template <int DH, bool OFFS>
__global__ void __launch_bounds__(NTHREADS, 1)
tree_attn_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ tiles,
                     const unsigned char* __restrict__ flag, int branch, int* __restrict__ record,
                     int record_cap, int hkv, const Params a) {
  fwd_cta<DH, DH, OFFS>(&tm_q, &tm_k, &tm_v, tiles, flag, branch, record, record_cap, hkv, a);
}

// MLA's widths (q, k DH wide, v and o DV wide), at offset 0
template <int DH, int DV>
__global__ void __launch_bounds__(NTHREADS, 1)
tree_attn_fwd_mla_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ tiles,
                         const unsigned char* __restrict__ flag, int branch, int* __restrict__ record,
                         int record_cap, int hkv, const Params a) {
  fwd_cta<DH, DV, false>(&tm_q, &tm_k, &tm_v, tiles, flag, branch, record, record_cap, hkv, a);
}

// ---------------------------------------------------------------------- launch

template <int DH, bool OFFS, int DV = DH>
int launch(int branch, const void* flag, const void* q, const void* k, const void* v,
           const void* tiles, int* record, int record_cap, int n_tiles, int hkv, const Params& a,
           cudaStream_t stream) {
  using L = Layout<DH, DV>;
  CUtensorMap tq, tk, tv;
  const long long rows_q = (long long)hkv * a.group * a.n, rows_k = (long long)hkv * a.n;
  if (!tensor_map(&tq, q, rows_q, DH) || !tensor_map(&tk, k, rows_k, DH) || !tensor_map(&tv, v, rows_k, DV))
    return int(cudaErrorInvalidValue);
  auto kernel = [] {
    if constexpr (DV != DH) return tree_attn_fwd_mla_kernel<DH, DV>;
    else return tree_attn_fwd_kernel<DH, OFFS>;
  }();
  static const int regs = check_entry_regs(reinterpret_cast<const void*>(kernel));
  if (regs != 0) return regs;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return int(err);
  const int grid = n_tiles * hkv * ((a.group + GS - 1) / GS);
  if (grid == 0) return 0;
  kernel<<<grid, NTHREADS, L::BYTES, stream>>>(tq, tk, tv, static_cast<const int*>(tiles),
                                                 static_cast<const unsigned char*>(flag), branch, record,
                                                 record_cap, hkv, a);
  return int(cudaGetLastError());
}

}  // namespace fwd

// branch 0: K2 (online); 1: K1 (bound); 2: the branch the device-side bool
// `flag` names (bound where it holds). cbound is required for branches 1 and
// 2. tiles [n_tiles, 3] / entries: the work list (tries.build_qmajor_work);
// record: int32 [2 + record_cap] (see the note at the top). q_off, kv_off:
// a ring pair's global offsets (multiples of 64; 0 on one device), last_desc
// then the whole table.
// Requires n % 64 == 0 and n_tiles == n / 64, dh in {64, 128} with dv = dh
// and group >= 1 (the Python wrapper takes 1..8), or (dh, dv) = (192, 128)
// at group 1 and offset 0 (o then dv wide), contiguous 16-byte aligned
// tensors; the Python wrapper checks these.
extern "C" int tree_attn_fwd(int branch, const void* flag, const void* q, const void* k,
                             const void* v, const void* last_desc, const void* tiles,
                             const void* entries, const void* cbound, void* o, void* lse,
                             void* record, int record_cap, int n_tiles, int hkv, int group, int n,
                             int dh, int dv, int q_off, int kv_off, float scale, void* stream) {
  if (group < 1 || hkv < 1 || branch < 0 || branch > 2 || record_cap < 1 || q_off < 0 || kv_off < 0 ||
      (branch == 2 && flag == nullptr) || (branch != 0 && cbound == nullptr))
    return int(cudaErrorInvalidValue);
  const fwd::Params a{static_cast<const int*>(last_desc), static_cast<const int*>(entries),
                      static_cast<const float*>(cbound), static_cast<hopper::bf16*>(o),
                      static_cast<float*>(lse), group, n, scale, q_off, kv_off};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* rec = static_cast<int*>(record);
  const bool offs = q_off != 0 || kv_off != 0;
  if (dv != dh) {
    if (dh == 192 && dv == 128 && group == 1 && !offs)
      return fwd::launch<192, false, 128>(branch, flag, q, k, v, tiles, rec, record_cap, n_tiles, hkv, a, st);
    return int(cudaErrorInvalidValue);
  }
  if (dh == 128)
    return offs ? fwd::launch<128, true>(branch, flag, q, k, v, tiles, rec, record_cap, n_tiles, hkv, a, st)
                : fwd::launch<128, false>(branch, flag, q, k, v, tiles, rec, record_cap, n_tiles, hkv, a, st);
  if (dh == 64)
    return offs ? fwd::launch<64, true>(branch, flag, q, k, v, tiles, rec, record_cap, n_tiles, hkv, a, st)
                : fwd::launch<64, false>(branch, flag, q, k, v, tiles, rec, record_cap, n_tiles, hkv, a, st);
  return int(cudaErrorInvalidValue);
}
