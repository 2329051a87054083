// Grouped-decode attention for Hopper (sm_90a): the current token of G
// branches of each of P prompts (K13).
//
// Replaces the Pallas TPU kernel _decode_kernel of
// dynamictreeattn_tpu/ops/decode_attention.py (launcher
// decode_attention_grouped), together with the launcher's self-column merge.
//
// Layouts (the sampler's): q [P, G, hq, DH] bf16 (post-RoPE); k_self,
// v_self [P, G, hkv, DH] bf16; kp, vp [P, hkv, Lp, DH] bf16 (frozen prompt
// cache); kc, vc [P, G, hkv, Nc, DH] bf16 (branch caches, columns < t live);
// plens [P] i32 -> o [P, G, hq, DH] bf16. Row r = g*grp + j of kv head h is q
// head h*grp + j of branch g. A row sees its prompt's columns < plen, its own
// branch's columns < t and the self column (k_self, v_self).
//
// What bounds it on the card: bytes. Each prompt column (4*DH bytes of K and
// V) serves the G*grp rows of its (prompt, kv head) at 4*DH flops each, each
// branch column its grp rows: ~G*grp and ~grp flops a byte, far below the
// ~295 at which the tensor cores, not memory, would bound it.
//
// Design. The TPU kernel gives one (prompt, kv head) a sequential grid axis
// over every column chunk and carries (acc, m, l) across it in VMEM: P*hkv
// parallel steps, 16 CTAs at the GRPO shape (P=2, hkv=8), ~12% of 132 SMs.
// Here that carried state becomes a flash-decoding split, two passes:
//   pass 1 gives every column chunk its own CTA, which writes an fp32
//   partial (acc, m, l) per row:
//   * a prompt unit (prompt p, kv head h, 64-row tile, CP-column chunk): all
//     of its rows read every column, so it runs on tensor cores (mma.sync
//     m16n8k16 bf16, one warp per 16 rows, q fragments / scores / P / acc in
//     registers, 64-key K/V sub-tiles double-buffered in shared memory with
//     cp.async), online softmax over its sub-tiles;
//   * a branch unit (prompt p, branch g, kv head h, CB-column chunk): only
//     grp <= 8 rows read its columns, so it runs on FP32 FMAs, one thread per
//     key for the scores and pairs of head-dim columns per thread for P*V,
//     rather than padding 16-row tensor-core tiles with dead rows (the TPU's
//     block-diagonal [G*grp, G*chunk] product wastes (G-1)/G of its lanes);
//   pass 2 merges each row's live partials and its self column, in a fixed
//   order: no atomics, so two launches are bit-equal.
// Columns >= plen and >= t are never read: the grid has no branch unit past
// t, a prompt unit whose chunk starts at or past plen returns, and the dead
// keys of a last sub-tile are zero-filled (cp.async src-size 0) and masked.
// Scores and statistics are fp32; P is rounded to bf16 before the P*V
// product, as on the TPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NT = 128;  // threads of a CTA, both passes
constexpr int CP = 256;  // prompt columns per prompt unit (PROMPT_CHUNK in ops/decode_attention.py)
constexpr int CB = 128;  // branch columns per branch unit, one per thread (BRANCH_CHUNK)
constexpr int TR = 64;   // q rows per prompt unit: 4 warps x 16
constexpr int TK = 64;   // keys per K/V sub-tile of a prompt unit
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

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Args {
  const bf16 *q, *k_self, *v_self, *kp, *vp, *kc, *vc;
  const int* plens;
  // fp32 partials: acc [rows][DH], m [rows], l [rows]; prompt row
  // ((p*hkv + h)*ncp + c)*R + r, branch row (((p*G + g)*hkv + h)*ncb + c)*grp + j
  float *pacc, *bacc, *pm, *pl, *bm, *bl;
  bf16* o;
  int P, G, hq, hkv, grp, Lp, Nc, t;
  int ncp, ncb, n_rt, n_prompt_units;  // prompt chunks of Lp, branch chunks of t, 64-row tiles
  float scale;
};

template <int DH>
struct PromptSmem {
  static constexpr int ST = DH + 8;  // bf16 row stride: conflict-free ldmatrix
  static constexpr size_t q_elems = size_t(TR) * ST;
  static constexpr size_t kv_elems = size_t(TK) * ST;  // one buffer of K or V
  static constexpr size_t bytes = (q_elems + 4 * kv_elems) * 2;
};

template <int DH, int GMAX>
struct BranchSmem {
  static constexpr int ST = DH + 8;  // bf16 row stride: conflict-free 16-byte row reads
  static constexpr size_t kv_elems = size_t(CB) * ST;
  static constexpr size_t bytes = 2 * kv_elems * 2 + (GMAX * DH + CB * GMAX + 8 * GMAX) * 4;
};

// Pass 1, prompt unit u = ((p*hkv + h)*n_rt + rt)*ncp + c.
template <int DH>
__device__ void prompt_unit(const Args& a, int u, unsigned char* smem) {
  using S = PromptSmem<DH>;
  constexpr int ST = S::ST, V8 = DH / 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + S::q_elems;       // [2][TK][ST]
  bf16* Vs = Ks + 2 * S::kv_elems;  // [2][TK][ST]

  const int c = u % a.ncp;
  const int rt = (u / a.ncp) % a.n_rt;
  const int ph = u / (a.ncp * a.n_rt);  // p*hkv + h
  const int h = ph % a.hkv, p = ph / a.hkv;
  const int plen = min(max(a.plens[p], 0), a.Lp);
  const int c0 = c * CP;
  if (c0 >= plen) return;  // a chunk with no live column has no partial
  const int c_end = min(c0 + CP, plen);
  const int nsub = (c_end - c0 + TK - 1) / TK;
  const int R = a.G * a.grp, r0 = rt * TR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, t4 = lane & 3;  // mma fragment coordinates
  const bool active = r0 + warp * 16 < R;    // this warp holds a live row

  // q tile (cp.async group 0, with the first K/V sub-tile); rows >= R zero
  for (int idx = tid; idx < TR * V8; idx += NT) {
    const int rr = idx / V8, c8 = idx % V8, r = r0 + rr;
    bf16* dst = Qs + rr * ST + c8 * 8;
    if (r < R) {
      const int g = r / a.grp, j = r % a.grp;
      cp_async16(dst, a.q + ((size_t(p) * a.G + g) * a.hq + h * a.grp + j) * DH + c8 * 8);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  const size_t kv_base = size_t(ph) * a.Lp * DH;
  auto load_tile = [&](int s, int buf) {
    for (int idx = tid; idx < TK * V8; idx += NT) {
      const int j = idx / V8, c8 = idx % V8, col = c0 + s * TK + j;
      const bool live = col < c_end;
      const size_t off = kv_base + size_t(live ? col : c0) * DH + c8 * 8;
      cp_async16(Ks + (buf * TK + j) * ST + c8 * 8, a.kp + off, live);
      cp_async16(Vs + (buf * TK + j) * ST + c8 * 8, a.vp + off, live);
    }
  };
  load_tile(0, 0);
  cp_async_commit();

  float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_r[2] = {0.f, 0.f};
  float o_acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) o_acc[j][0] = o_acc[j][1] = o_acc[j][2] = o_acc[j][3] = 0.f;
  uint32_t q_frag[DH / 16][4];

  for (int s = 0; s < nsub; ++s) {
    const int buf = s & 1;
    if (s + 1 < nsub) load_tile(s + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // this sub-tile (and at s == 0 the q tile) is visible

    if (active) {
      if (s == 0) {
#pragma unroll
        for (int ks = 0; ks < DH / 16; ++ks)
          ldmatrix_x4(q_frag[ks], Qs + (warp * 16 + (lane & 15)) * ST + ks * 16 + (lane >> 4) * 8);
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

      // ---- scale, mask the columns >= plen, online softmax
      // element e of n-tile j: key j*8 + 2*t4 + (e & 1), row gid + 8*(e >> 1)
      const int cbase = c0 + s * TK;
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < TK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = cbase + j * 8 + 2 * t4 + (e & 1) < c_end ? s_acc[j][e] * a.scale : MASK_VALUE;
          s_acc[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float shift[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        shift[r] = fmaxf(m_r[r], mx[r]);  // finite: every sub-tile holds a live column
        alpha[r] = expf(m_r[r] - shift[r]);  // 0 on the first sub-tile (m = -inf)
        m_r[r] = shift[r];
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
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        o_acc[j][0] *= alpha[0];
        o_acc[j][1] *= alpha[0];
        o_acc[j][2] *= alpha[1];
        o_acc[j][3] *= alpha[1];
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
    }
    __syncthreads();  // the buffer may be refilled by the next iteration
  }

  // ---- emit the partial (acc unnormalised, m, l) of the live rows
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + warp * 16 + gid + 8 * r;
    if (row >= R) continue;
    const size_t prow = (size_t(ph) * a.ncp + c) * R + row;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<float2*>(a.pacc + prow * DH + j * 8 + 2 * t4) =
          make_float2(o_acc[j][2 * r], o_acc[j][2 * r + 1]);
    if (t4 == 0) {
      a.pm[prow] = m_r[r];
      a.pl[prow] = l_r[r];
    }
  }
}

// Pass 1, branch unit ub = ((p*G + g)*hkv + h)*ncb + c; rows j < grp <= GMAX.
template <int DH, int GMAX>
__device__ void branch_unit(const Args& a, int ub, unsigned char* smem) {
  using S = BranchSmem<DH, GMAX>;
  constexpr int ST = S::ST, V8 = DH / 8;
  constexpr int NPAIR = DH / 2, KG = NT / NPAIR;  // P*V: column pairs x key groups
  bf16* Ks = reinterpret_cast<bf16*>(smem);        // [CB][ST]
  bf16* Vs = Ks + S::kv_elems;                     // [CB][ST]
  float* qs = reinterpret_cast<float*>(Vs + S::kv_elems);  // [GMAX][DH] fp32
  float* ps = qs + GMAX * DH;                      // [CB][GMAX] P, rounded to bf16
  float* wmax = ps + CB * GMAX;                    // [4 warps][GMAX]
  float* wsum = wmax + 4 * GMAX;                   // [4 warps][GMAX]
  float* red = reinterpret_cast<float*>(smem);     // [KG][GMAX][DH], over Ks once scored

  const int c = ub % a.ncb;
  const int pgh = ub / a.ncb;  // (p*G + g)*hkv + h
  const int h = pgh % a.hkv, pg = pgh / a.hkv;
  const int c0 = c * CB, n = min(CB, a.t - c0);  // n >= 1: the grid stops at t
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const size_t kv_base = size_t(pgh) * a.Nc * DH + size_t(c0) * DH;
  for (int idx = tid; idx < CB * V8; idx += NT) {
    const int j = idx / V8, c8 = idx % V8;
    const bool live = j < n;
    const size_t off = kv_base + size_t(live ? j : 0) * DH + c8 * 8;
    cp_async16(Ks + j * ST + c8 * 8, a.kc + off, live);
    cp_async16(Vs + j * ST + c8 * 8, a.vc + off, live);
  }
  cp_async_commit();
  for (int idx = tid; idx < GMAX * DH; idx += NT) {
    const int j = idx / DH, d = idx % DH;
    qs[idx] = j < a.grp ? __bfloat162float(a.q[(size_t(pg) * a.hq + h * a.grp + j) * DH + d]) : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  // ---- scores: thread tid owns key c0 + tid
  float s[GMAX];
#pragma unroll
  for (int j = 0; j < GMAX; ++j) s[j] = 0.f;
  if (tid < n) {
    const bf16* krow = Ks + tid * ST;
#pragma unroll 4
    for (int d8 = 0; d8 < V8; ++d8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(krow + d8 * 8);
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      float kf[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(k2[e]);
        kf[2 * e] = f.x;
        kf[2 * e + 1] = f.y;
      }
#pragma unroll
      for (int j = 0; j < GMAX; ++j) {
        const float4 qa = *reinterpret_cast<const float4*>(qs + j * DH + d8 * 8);
        const float4 qb = *reinterpret_cast<const float4*>(qs + j * DH + d8 * 8 + 4);
        s[j] += qa.x * kf[0] + qa.y * kf[1] + qa.z * kf[2] + qa.w * kf[3] + qb.x * kf[4] +
                qb.y * kf[5] + qb.z * kf[6] + qb.w * kf[7];
      }
    }
#pragma unroll
    for (int j = 0; j < GMAX; ++j) s[j] *= a.scale;
  } else {
#pragma unroll
    for (int j = 0; j < GMAX; ++j) s[j] = -CUDART_INF_F;
  }

  // ---- softmax statistics of the chunk: m = max, P = exp(s - m), l = sum P
#pragma unroll
  for (int j = 0; j < GMAX; ++j) {
    const float v = warp_max(s[j]);
    if (lane == 0) wmax[warp * GMAX + j] = v;
  }
  __syncthreads();
  float m[GMAX], pr[GMAX];
#pragma unroll
  for (int j = 0; j < GMAX; ++j) {
    m[j] = fmaxf(fmaxf(wmax[j], wmax[GMAX + j]), fmaxf(wmax[2 * GMAX + j], wmax[3 * GMAX + j]));
    pr[j] = tid < n ? expf(s[j] - m[j]) : 0.f;
    const float v = warp_sum(pr[j]);
    if (lane == 0) wsum[warp * GMAX + j] = v;
    ps[tid * GMAX + j] = __bfloat162float(__float2bfloat16(pr[j]));
  }
  __syncthreads();

  // ---- P V: thread (kg, pair) sums keys kg, kg + KG, ... into columns 2*pair, 2*pair + 1
  const int pair = tid % NPAIR, kg = tid / NPAIR;
  float acc[GMAX][2];
#pragma unroll
  for (int j = 0; j < GMAX; ++j) acc[j][0] = acc[j][1] = 0.f;
  for (int i = kg; i < n; i += KG) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Vs + i * ST + 2 * pair));
    const float* pi = ps + i * GMAX;
#pragma unroll
    for (int j = 0; j < GMAX; ++j) {
      acc[j][0] += pi[j] * v.x;
      acc[j][1] += pi[j] * v.y;
    }
  }
  // red overlays Ks: no thread reads Ks past the barrier above
#pragma unroll
  for (int j = 0; j < GMAX; ++j)
    *reinterpret_cast<float2*>(red + (kg * GMAX + j) * DH + 2 * pair) = make_float2(acc[j][0], acc[j][1]);
  __syncthreads();
  for (int idx = tid; idx < a.grp * DH; idx += NT) {
    const int j = idx / DH, d = idx % DH;
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < KG; ++k) sum += red[(k * GMAX + j) * DH + d];
    a.bacc[(size_t(ub) * a.grp + j) * DH + d] = sum;
  }
#pragma unroll
  for (int j = 0; j < GMAX; ++j) {
    if (tid == j && j < a.grp) {
      a.bm[size_t(ub) * a.grp + j] = m[j];
      a.bl[size_t(ub) * a.grp + j] = (wsum[j] + wsum[GMAX + j]) + (wsum[2 * GMAX + j] + wsum[3 * GMAX + j]);
    }
  }
}

template <int DH, int GMAX>
__global__ void __launch_bounds__(NT) decode_partial(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (int(blockIdx.x) < a.n_prompt_units)
    prompt_unit<DH>(a, blockIdx.x, smem);
  else
    branch_unit<DH, GMAX>(a, blockIdx.x - a.n_prompt_units, smem);
}

// Pass 2: one warp per output row (p, g, q head); lane owns DH/32 columns.
template <int DH>
__global__ void __launch_bounds__(NT) decode_merge(Args a) {
  constexpr int E = DH / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (NT / 32) + warp;  // (p*G + g)*hq + head
  if (row >= a.P * a.G * a.hq) return;
  const int head = row % a.hq, pg = row / a.hq;
  const int g = pg % a.G, p = pg / a.G;
  const int h = head / a.grp, j = head % a.grp;
  const int d0 = lane * E;

  // the self column: s = scale * q . k_self of this branch and kv head
  const size_t self = (size_t(pg) * a.hkv + h) * DH + d0;
  float dot = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e)
    dot += __bfloat162float(a.q[size_t(row) * DH + d0 + e]) * __bfloat162float(a.k_self[self + e]);
  const float s_self = warp_sum(dot) * a.scale;

  const int plen = min(max(a.plens[p], 0), a.Lp);
  const int ncp_live = (plen + CP - 1) / CP;
  const int R = a.G * a.grp;
  const size_t prow0 = size_t(p * a.hkv + h) * a.ncp * R + g * a.grp + j;  // + c*R
  const size_t brow0 = (size_t(pg) * a.hkv + h) * a.ncb * a.grp + j;       // + c*grp
  float M = s_self;
  for (int c = 0; c < ncp_live; ++c) M = fmaxf(M, a.pm[prow0 + size_t(c) * R]);
  for (int c = 0; c < a.ncb; ++c) M = fmaxf(M, a.bm[brow0 + size_t(c) * a.grp]);
  const float ws = expf(s_self - M);
  float L = ws, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = ws * __bfloat162float(a.v_self[self + e]);
  for (int c = 0; c < ncp_live; ++c) {
    const size_t prow = prow0 + size_t(c) * R;
    const float w = expf(a.pm[prow] - M);
    L += w * a.pl[prow];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += w * a.pacc[prow * DH + d0 + e];
  }
  for (int c = 0; c < a.ncb; ++c) {
    const size_t brow = brow0 + size_t(c) * a.grp;
    const float w = expf(a.bm[brow] - M);
    L += w * a.bl[brow];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += w * a.bacc[brow * DH + d0 + e];
  }
  const float inv = 1.f / L;
#pragma unroll
  for (int e = 0; e < E; ++e) a.o[size_t(row) * DH + d0 + e] = __float2bfloat16(acc[e] * inv);
}

template <int DH, int GMAX>
int launch(Args a, cudaStream_t st) {
  constexpr size_t pb = PromptSmem<DH>::bytes, bb = BranchSmem<DH, GMAX>::bytes;
  constexpr size_t bytes = pb > bb ? pb : bb;
  auto partial = decode_partial<DH, GMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(partial, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  const int units = a.n_prompt_units + a.P * a.G * a.hkv * a.ncb;
  if (units > 0) partial<<<units, NT, bytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int rows = a.P * a.G * a.hq;
  if (rows > 0) decode_merge<DH><<<(rows + NT / 32 - 1) / (NT / 32), NT, 0, st>>>(a);
  return int(cudaGetLastError());
}

template <int DH>
int dispatch_group(const Args& a, cudaStream_t st) {
  if (a.grp <= 2) return launch<DH, 2>(a, st);  // Qwen3-0.6B .. 1.7B: 16 q heads over 8
  if (a.grp <= 4) return launch<DH, 4>(a, st);  // Llama-3.2-3B, Qwen3-4B/8B
  if (a.grp <= 8) return launch<DH, 8>(a, st);  // Qwen2.5 (7), Qwen3-14B (5)
  return int(cudaErrorInvalidValue);
}

}  // namespace

// K13: o = softmax(q K^T * scale) V over each branch's visible columns.
// ws: fp32 workspace of (prompt_rows + branch_rows) * (dh + 2) floats, with
// prompt_rows = P*hkv*ceil(Lp/CP)*G*grp and branch_rows = P*G*hkv*ceil(t/CB)*grp.
// Requires dh in {64, 128}, 1 <= hq/hkv <= 8, 0 <= t <= Nc, contiguous
// 16-byte aligned inputs; the Python wrapper checks these.
extern "C" int decode_attn(const void* q, const void* k_self, const void* v_self, const void* kp,
                           const void* vp, const void* kc, const void* vc, const void* plens,
                           void* ws, void* o, int P, int G, int hq, int hkv, int dh, int Lp, int Nc,
                           int t, float scale, void* stream) {
  if (hkv <= 0 || hq % hkv) return int(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k_self = static_cast<const bf16*>(k_self);
  a.v_self = static_cast<const bf16*>(v_self);
  a.kp = static_cast<const bf16*>(kp);
  a.vp = static_cast<const bf16*>(vp);
  a.kc = static_cast<const bf16*>(kc);
  a.vc = static_cast<const bf16*>(vc);
  a.plens = static_cast<const int*>(plens);
  a.o = static_cast<bf16*>(o);
  a.P = P, a.G = G, a.hq = hq, a.hkv = hkv, a.grp = hq / hkv, a.Lp = Lp, a.Nc = Nc, a.t = t;
  a.ncp = (Lp + CP - 1) / CP;
  a.ncb = (t + CB - 1) / CB;
  const int R = G * a.grp;
  a.n_rt = (R + TR - 1) / TR;
  a.n_prompt_units = P * hkv * a.n_rt * a.ncp;
  a.scale = scale;
  const size_t prompt_rows = size_t(P) * hkv * a.ncp * R;
  const size_t branch_rows = size_t(P) * G * hkv * a.ncb * a.grp;
  float* f = static_cast<float*>(ws);
  a.pacc = f;
  a.bacc = a.pacc + prompt_rows * dh;
  a.pm = a.bacc + branch_rows * dh;
  a.pl = a.pm + prompt_rows;
  a.bm = a.pl + prompt_rows;
  a.bl = a.bm + branch_rows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh == 128) return dispatch_group<128>(a, st);
  if (dh == 64) return dispatch_group<64>(a, st);
  return int(cudaErrorInvalidValue);
}
