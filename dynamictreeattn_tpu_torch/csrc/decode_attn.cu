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
// plens [P] i32; t one i32 in device memory (or a host int) -> o [P, G, hq,
// DH] bf16. Row r = g*grp + j of kv head h is q head h*grp + j of branch g.
// A row sees its prompt's columns < plen, its own branch's columns < t and
// the self column (k_self, v_self).
//
// What bounds it on the card: bytes. Each prompt column (4*DH bytes of K and
// V) serves the G*grp rows of its (prompt, kv head) at 4*DH flops each, each
// branch column its grp rows: ~G*grp and ~grp flops a byte, far below the
// ~295 at which the tensor cores, not memory, would bound it. So the design
// keeps as many bytes in flight as the card holds and does little else.
//
// Design. The TPU kernel gives one (prompt, kv head) a sequential grid axis
// over every column chunk, carries (acc, m, l) across it in VMEM and reads t
// by scalar prefetch. Here one launch does everything:
// * The grid is sized for Lp and Nc, not for t: t is read from device memory
//   (clamped to [0, Nc], as plen to [0, Lp]), so a CUDA graph can replay the
//   launch at every step. A unit whose chunk starts at or past plen or t
//   returns at once.
// * Work units, one CHUNK-column chunk of one row group each: a prompt unit
//   (prompt p, kv head h, a tile of whole branches, <= 64 rows) or a branch
//   unit (prompt p, branch g, kv head h: its grp rows; chunk-major, so the
//   dead ones come last). A unit asks for its whole chunk at once (cp.async,
//   16 bytes a thread, rows padded for conflict-free ldmatrix): 64 KB in
//   flight a CTA at DH 128, three CTAs an SM.
// * Tensor cores (mma.sync m16n8k16 bf16) for both kinds: one warp per live
//   16-row band, never a dead band; the warps a tile leaves over split the
//   chunk's keys (a branch unit: four warps of 32 keys), and their partials
//   are combined in a fixed order. Scores and statistics are fp32; P is
//   rounded to bf16 before the P*V product, as on the TPU. Each unit writes
//   an fp32 (acc, m, l) partial per row and adds one to the arrival counter
//   of each (p, g, h) it serves.
// * Merge units, one per (p, g, h), last in the grid: each waits until its
//   counter holds every live chunk's arrival (all work units were dispatched
//   before it, the ordering single-pass scans rely on; a wait that never
//   ends traps), zeroes the counter for the next call and merges its grp
//   rows: the self column, then prompt chunks, then branch chunks, always in
//   this order, so two launches (and a graph replay and an eager launch) are
//   bit-equal. The 512 row merges of the GRPO shape run side by side across
//   the card, as a second launch would run them.
// Columns >= plen and >= t are never read: no copy is issued for them, and
// the dead rows of a last V step are zeroed in shared memory and their
// scores masked.
//
// Tried on the card and not kept (H100 80GB HBM3, 700 W): TMA bulk copies,
// one per K or V row into the padded stride (issuing 256 copies took a CTA
// 9-12 us), or one per 64-row sub-tile into unpadded rows (8-way ldmatrix
// bank conflicts: 10-27 us of compute a CTA); and the merge done by the last
// unit to arrive (at t = 0 one CTA merged all 32 rows of a (prompt, kv head):
// up to 42 us).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NT = 128;  // threads of a CTA
constexpr int NW = NT / 32;
constexpr int CHUNK = 128;  // columns per unit (PROMPT_CHUNK, BRANCH_CHUNK in ops/decode_attention.py)
constexpr int KS = 32;      // keys per online-softmax step of a warp
constexpr int TR = 64;      // q rows of a prompt unit at most: four 16-row bands
constexpr int KCH = 16;     // partials a merge unit stages per round
// same constant as the TPU kernels: -0.7 * float32 max
constexpr float MASK_VALUE = -0.7f * 3.402823466e38f;

template <int DH>
struct Smem {
  static constexpr int ST = DH + 8;  // bf16 row stride: conflict-free ldmatrix
  static constexpr size_t kv_elems = size_t(CHUNK) * ST;  // K or V of one chunk
  static constexpr size_t kv_bytes = 2 * kv_elems * 2;
  // per-warp partial (acc [16][DH], m [16], l [16]) fp32, over K/V once spent
  static constexpr size_t scr_floats = size_t(16) * (DH + 2);
  static constexpr size_t wts_off = kv_bytes;  // [TR][NW] fp32: each key part's weight in a row
  static constexpr size_t bytes = wts_off + TR * NW * 4;
  static_assert(NW * scr_floats * 4 <= kv_bytes, "partials overlay K/V");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
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

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

struct Args {
  const bf16 *q, *k_self, *v_self, *kp, *vp, *kc, *vc;
  const int* plens;
  const int* t_dev;  // null: t_host
  // fp32 partials: acc [rows][DH], m [rows], l [rows]; prompt row
  // ((p*hkv + h)*ncp + c)*G*grp + g*grp + j, branch row
  // (((p*G + g)*hkv + h)*ncb + c)*grp + j
  float *pacc, *bacc, *pm, *pl, *bm, *bl;
  int* counters;  // [P*G*hkv] arrivals, zero between calls
  bf16* o;
  int P, G, hq, hkv, grp, Lp, Nc, t_host;
  int ncp, ncb, gpt, n_rt;  // chunks of Lp and of Nc, branches a row tile, row tiles
  int n_prompt_units, n_work_units;
  float scale;
};

__device__ __forceinline__ int live_prompt_chunks(int plen) {
  return max(1, (plen + CHUNK - 1) / CHUNK);  // chunk 0 always reports, empty if plen == 0
}

// One work unit: a chunk of prompt or branch columns for its rows; writes
// their partials and arrives at the counters of the (p, g, h) it serves.
template <int DH>
__device__ void work_unit(const Args& a, int bid, int t, unsigned char* smem) {
  using S = Smem<DH>;
  constexpr int ST = S::ST, C4 = DH / 4;
  bf16* Ks = reinterpret_cast<bf16*>(smem);     // [CHUNK][ST]
  bf16* Vs = Ks + S::kv_elems;                  // [CHUNK][ST]
  float* scr = reinterpret_cast<float*>(smem);  // [NW][16][DH + 2], once K/V are spent
  float* wts = reinterpret_cast<float*>(smem + S::wts_off);

  int p, h, g0, ng, n_live;
  const bf16 *kg, *vg;
  float *part_acc, *part_m, *part_l;
  size_t row0;
  if (bid < a.n_prompt_units) {
    const int c = bid % a.ncp;
    const int rt = (bid / a.ncp) % a.n_rt;
    const int ph = bid / (a.ncp * a.n_rt);
    h = ph % a.hkv;
    p = ph / a.hkv;
    const int plen = min(max(a.plens[p], 0), a.Lp);
    if (c >= live_prompt_chunks(plen)) return;
    n_live = max(0, min(CHUNK, plen - c * CHUNK));
    g0 = rt * a.gpt;
    ng = min(a.gpt, a.G - g0);
    const size_t off = (size_t(ph) * a.Lp + size_t(c) * CHUNK) * DH;
    kg = a.kp + off;
    vg = a.vp + off;
    part_acc = a.pacc, part_m = a.pm, part_l = a.pl;
    row0 = (size_t(ph) * a.ncp + c) * a.G * a.grp + g0 * a.grp;
  } else {
    const int n_groups = a.P * a.G * a.hkv;
    const int ub = bid - a.n_prompt_units;
    const int c = ub / n_groups;
    if (c * CHUNK >= t) return;
    const int pgh = ub % n_groups;  // (p*G + g)*hkv + h
    h = pgh % a.hkv;
    g0 = (pgh / a.hkv) % a.G;
    p = pgh / (a.hkv * a.G);
    ng = 1;
    n_live = min(CHUNK, t - c * CHUNK);
    const size_t off = (size_t(pgh) * a.Nc + size_t(c) * CHUNK) * DH;
    kg = a.kc + off;
    vg = a.vc + off;
    part_acc = a.bacc, part_m = a.bm, part_l = a.bl;
    row0 = (size_t(pgh) * a.ncb + c) * a.grp;
  }
  const int rows = ng * a.grp;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, t4 = lane & 3;  // mma fragment coordinates

  // ---- the whole chunk's live K and V rows, in flight at once
  for (int idx = tid; idx < n_live * (DH / 8); idx += NT) {
    const int r = idx / (DH / 8), c8 = idx % (DH / 8);
    cp_async16(Ks + r * ST + c8 * 8, kg + size_t(r) * DH + c8 * 8);
    cp_async16(Vs + r * ST + c8 * 8, vg + size_t(r) * DH + c8 * 8);
  }

  // ---- warps: one per live 16-row band; the rest split the chunk's keys
  const int nb = (rows + 15) / 16;
  const int ksplit = nb == 1 ? 4 : nb == 2 ? 2 : 1;
  const bool active = warp < nb * ksplit;
  const int band = warp % nb, kpart = warp / nb;
  const int k_lo = kpart * (CHUNK / ksplit), k_hi = min(k_lo + CHUNK / ksplit, n_live);
  const bool busy = active && k_lo < k_hi;

  // q fragments straight from global memory while the chunk lands; rows past
  // the tile are zero
  uint32_t q_frag[DH / 16][4];
  if (busy) {
    const bf16* qrow[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = band * 16 + gid + 8 * r;
      qrow[r] = rr < rows ? a.q + ((size_t(p) * a.G + g0 + rr / a.grp) * a.hq + h * a.grp + rr % a.grp) * DH
                          : nullptr;
    }
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bf16* src = qrow[e & 1];
        q_frag[kk][e] = src ? *reinterpret_cast<const uint32_t*>(src + kk * 16 + (e >> 1) * 8 + 2 * t4) : 0u;
      }
    }
  }
  // dead V rows of the last step: P is 0 there, and 0 * (stale NaN) is not
  for (int idx = tid; idx < ((n_live + KS - 1) / KS * KS - n_live) * (DH / 8); idx += NT) {
    const int r = n_live + idx / (DH / 8), c8 = idx % (DH / 8);
    *reinterpret_cast<uint4*>(Vs + r * ST + c8 * 8) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_wait_all();
  __syncthreads();

  float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_r[2] = {0.f, 0.f};
  float o_acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) o_acc[j][0] = o_acc[j][1] = o_acc[j][2] = o_acc[j][3] = 0.f;
  if (busy) {
    for (int k0 = k_lo; k0 < k_hi; k0 += KS) {
      // ---- S = Q K^T: 16 x KS, fp32 in registers
      float s_acc[KS / 8][4];
#pragma unroll
      for (int j = 0; j < KS / 8; ++j) s_acc[j][0] = s_acc[j][1] = s_acc[j][2] = s_acc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < KS / 16; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, Ks + (k0 + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * ST + kk * 16 +
                             ((lane >> 3) & 1) * 8);
          mma_bf16(s_acc[2 * np], q_frag[kk], b[0], b[1]);
          mma_bf16(s_acc[2 * np + 1], q_frag[kk], b[2], b[3]);
        }
      }
      // ---- scale, mask the dead keys, online softmax
      // element e of n-tile j: key k0 + j*8 + 2*t4 + (e & 1), row gid + 8*(e >> 1)
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < KS / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = k0 + j * 8 + 2 * t4 + (e & 1) < n_live ? s_acc[j][e] * a.scale : MASK_VALUE;
          s_acc[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float shift[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        shift[r] = fmaxf(m_r[r], mx[r]);     // finite: every step holds a live key
        alpha[r] = expf(m_r[r] - shift[r]);  // 0 on the first step (m = -inf)
        m_r[r] = shift[r];
      }
      float rs[2] = {0.f, 0.f};
      uint32_t p_frag[KS / 16][4];  // P as the A operand of the PV product
#pragma unroll
      for (int j = 0; j < KS / 8; ++j) {
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
      for (int kk = 0; kk < KS / 16; ++kk) {
#pragma unroll
        for (int dp = 0; dp < DH / 16; ++dp) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, Vs + (k0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ST + dp * 16 +
                                   (lane >> 4) * 8);
          mma_bf16(o_acc[2 * dp], p_frag[kk], b[0], b[1]);
          mma_bf16(o_acc[2 * dp + 1], p_frag[kk], b[2], b[3]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  __syncthreads();  // every warp is done with K/V: the partials overlay them

  // ---- each warp's partial into shared memory (a warp with no live key: m = -inf, l = 0, acc = 0)
  if (active) {
    float* w_acc = scr + warp * S::scr_floats;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int ri = gid + 8 * r;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<float2*>(w_acc + ri * DH + j * 8 + 2 * t4) =
            make_float2(o_acc[j][2 * r], o_acc[j][2 * r + 1]);
      if (t4 == 0) {
        w_acc[16 * DH + ri] = m_r[r];
        w_acc[16 * DH + 16 + ri] = l_r[r];
      }
    }
  }
  __syncthreads();

  // ---- the unit's partial: the key parts of each row combined in part order
  for (int rr = tid; rr < rows; rr += NT) {
    const int bnd = rr / 16, ri = rr % 16;
    float M = -CUDART_INF_F, l = 0.f;
    for (int k = 0; k < ksplit; ++k) M = fmaxf(M, scr[(k * nb + bnd) * S::scr_floats + 16 * DH + ri]);
    for (int k = 0; k < ksplit; ++k) {
      const float* w = scr + (k * nb + bnd) * S::scr_floats;
      const float wt = M == -CUDART_INF_F ? 0.f : expf(w[16 * DH + ri] - M);
      wts[rr * NW + k] = wt;
      l += wt * w[16 * DH + 16 + ri];
    }
    part_m[row0 + rr] = M;
    part_l[row0 + rr] = l;
  }
  __syncthreads();
  for (int idx = tid; idx < rows * C4; idx += NT) {
    const int rr = idx / C4, c4 = idx % C4;
    const int bnd = rr / 16, ri = rr % 16;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < ksplit; ++k) {
      const float wt = wts[rr * NW + k];
      const float4 x = *reinterpret_cast<const float4*>(scr + (k * nb + bnd) * S::scr_floats + ri * DH + 4 * c4);
      acc.x += wt * x.x;
      acc.y += wt * x.y;
      acc.z += wt * x.z;
      acc.w += wt * x.w;
    }
    *reinterpret_cast<float4*>(part_acc + (row0 + rr) * DH + 4 * c4) = acc;
  }

  // ---- arrive at each served (p, g, h)
  __threadfence();
  __syncthreads();
  if (tid < ng) atomicAdd(a.counters + (size_t(p) * a.G + g0 + tid) * a.hkv + h, 1);
}

// One merge unit: rows (p, g, q head h*grp + j), j < grp, of o. Loads the
// self column, waits for every live chunk's partial, then starts from the
// self column (m = q.k_self*scale, l = 1, acc = v_self) and folds in the
// partials KCH at a time, prompt chunks then branch chunks, rescaling as
// online softmax does.
// A round stages the partials of up to `batch` rows into shared memory by
// cp.async: one L2 round trip per KCH partials.
template <int DH>
__device__ void merge_unit(const Args& a, int pgh, int t, unsigned char* smem) {
  constexpr int C4 = DH / 4, C8 = DH / 8;
  // per row: KCH staged partials (acc [KCH][DH], m -> weight [KCH], l [KCH]),
  // the running acc [DH], m, l, the rescale of this round, q.k_self pieces [C8]
  constexpr int STRIDE = (KCH * (DH + 2) + DH + 3 + C8 + 3) / 4 * 4;  // float4-aligned rows
  constexpr int RUN = KCH * (DH + 2);
  static_assert(STRIDE * 4 <= Smem<DH>::kv_bytes, "one row's merge state fits the K/V area");
  float* f = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x;
  const int h = pgh % a.hkv, g = (pgh / a.hkv) % a.G, p = pgh / (a.hkv * a.G);
  const int ncp_live = live_prompt_chunks(min(max(a.plens[p], 0), a.Lp));
  const int np = ncp_live + (t + CHUNK - 1) / CHUNK;
  const int R = a.G * a.grp;
  const size_t self = size_t(pgh) * DH;
  const size_t qrow0 = (size_t(p) * a.G + g) * a.hq + h * a.grp;
  auto part_row = [&](int j, int k) -> size_t {  // partial row k of merged row j
    return k < ncp_live ? (size_t(p * a.hkv + h) * a.ncp + k) * R + g * a.grp + j
                        : (size_t(pgh) * a.ncb + (k - ncp_live)) * a.grp + j;
  };
  const int batch = int(Smem<DH>::kv_bytes / 4) / STRIDE;
  for (int j0 = 0; j0 < a.grp; j0 += batch) {
    const int nr = min(batch, a.grp - j0);
    // the self column: q . k_self in C8 pieces, acc = v_self
    for (int idx = tid; idx < nr * (C8 + C4); idx += NT) {
      const int i = idx / (C8 + C4), c = idx % (C8 + C4);
      float* run = f + i * STRIDE + RUN;
      if (c < C8) {
        const uint4 qa = *reinterpret_cast<const uint4*>(a.q + (qrow0 + j0 + i) * DH + c * 8);
        const uint4 kb = *reinterpret_cast<const uint4*>(a.k_self + self + c * 8);
        const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(&qa);
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kb);
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(q2[e]), y = __bfloat1622float2(k2[e]);
          dot += x.x * y.x + x.y * y.y;
        }
        run[DH + 3 + c] = dot;
      } else {
        const uint2 raw = *reinterpret_cast<const uint2*>(a.v_self + self + (c - C8) * 4);
        const float2 v01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 v23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        *reinterpret_cast<float4*>(run + 4 * (c - C8)) = make_float4(v01.x, v01.y, v23.x, v23.y);
      }
    }
    if (j0 == 0 && tid == 0) {  // the self column needs no partial: wait only now
      int* cnt = a.counters + pgh;
      const long long t0 = clock64();
      while (ld_acquire(cnt) < np) {
        __nanosleep(100);
        if (clock64() - t0 > 20000000000ll) __trap();  // ~10 s: a unit never arrived
      }
      *cnt = 0;  // every arrival is in: zero for the next call
    }
    __syncthreads();
    for (int i = tid; i < nr; i += NT) {
      float* run = f + i * STRIDE + RUN;
      float s_self = 0.f;
      for (int c = 0; c < C8; ++c) s_self += run[DH + 3 + c];
      run[DH] = s_self * a.scale;  // m
      run[DH + 1] = 1.f;           // l
    }
    for (int k0 = 0; k0 < np; k0 += KCH) {
      const int nk = min(KCH, np - k0);
      // stage: acc rows by cp.async, m and l by loads in flight beside them
      for (int idx = tid; idx < nr * nk * C4; idx += NT) {
        const int i = idx / (nk * C4), k = (idx / C4) % nk, c4 = idx % C4;
        cp_async16(f + i * STRIDE + k * DH + 4 * c4,
                   (k0 + k < ncp_live ? a.pacc : a.bacc) + part_row(j0 + i, k0 + k) * DH + 4 * c4);
      }
      for (int idx = tid; idx < nr * nk; idx += NT) {
        const int i = idx / nk, k = idx % nk;
        const size_t pr = part_row(j0 + i, k0 + k);
        const bool pp = k0 + k < ncp_live;
        float* wm = f + i * STRIDE + KCH * DH;
        wm[k] = __ldcg((pp ? a.pm : a.bm) + pr);
        wm[KCH + k] = __ldcg((pp ? a.pl : a.bl) + pr);
      }
      cp_async_wait_all();
      __syncthreads();
      // per row: the new max, the weights, l, and the rescale of the running acc
      for (int i = tid; i < nr; i += NT) {
        float* wm = f + i * STRIDE + KCH * DH;
        float* run = f + i * STRIDE + RUN;
        float M = run[DH];
        for (int k = 0; k < nk; ++k) M = fmaxf(M, wm[k]);
        const float sc = expf(run[DH] - M);
        float L = run[DH + 1] * sc;
        for (int k = 0; k < nk; ++k) {
          const float w = expf(wm[k] - M);
          wm[k] = w;
          L += w * wm[KCH + k];
        }
        run[DH] = M;
        run[DH + 1] = L;
        run[DH + 2] = sc;
      }
      __syncthreads();
      for (int idx = tid; idx < nr * C4; idx += NT) {
        const int i = idx / C4, c4 = idx % C4;
        const float* fr = f + i * STRIDE;
        float* run = f + i * STRIDE + RUN;
        const float sc = run[DH + 2];
        float4 acc = *reinterpret_cast<float4*>(run + 4 * c4);
        acc.x *= sc;
        acc.y *= sc;
        acc.z *= sc;
        acc.w *= sc;
        for (int k = 0; k < nk; ++k) {
          const float w = fr[KCH * DH + k];
          const float4 x = *reinterpret_cast<const float4*>(fr + k * DH + 4 * c4);
          acc.x += w * x.x;
          acc.y += w * x.y;
          acc.z += w * x.z;
          acc.w += w * x.w;
        }
        *reinterpret_cast<float4*>(run + 4 * c4) = acc;
      }
      __syncthreads();
    }
    for (int idx = tid; idx < nr * C4; idx += NT) {
      const int i = idx / C4, c4 = idx % C4;
      const float* run = f + i * STRIDE + RUN;
      const float inv = 1.f / run[DH + 1];
      const float4 acc = *reinterpret_cast<const float4*>(run + 4 * c4);
      uint2 out;
      out.x = pack_bf16(acc.x * inv, acc.y * inv);
      out.y = pack_bf16(acc.z * inv, acc.w * inv);
      *reinterpret_cast<uint2*>(a.o + (qrow0 + j0 + i) * DH + 4 * c4) = out;
    }
    __syncthreads();
  }
}

template <int DH>
__global__ void __launch_bounds__(NT, 3) decode_attn_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int t = min(max(a.t_dev ? *a.t_dev : a.t_host, 0), a.Nc);
  const int bid = blockIdx.x;
  if (bid < a.n_work_units)
    work_unit<DH>(a, bid, t, smem);
  else
    merge_unit<DH>(a, bid - a.n_work_units, t, smem);
}

template <int DH>
int launch(const Args& a, cudaStream_t st) {
  constexpr int bytes = int(Smem<DH>::bytes);
  // once per process, before any capture: not a stream operation
  static const cudaError_t attr =
      cudaFuncSetAttribute(decode_attn_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return int(attr);
  const int units = a.n_work_units + a.P * a.G * a.hkv;
  if (units > 0) decode_attn_kernel<DH><<<units, NT, bytes, st>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

// K13: o = softmax(q K^T * scale) V over each branch's visible columns.
// t: t_dev (one i32 in device memory) when non-null, else t_host.
// ws: fp32 workspace of (prompt_rows + branch_rows) * (dh + 2) floats, with
// prompt_rows = P*hkv*ceil(Lp/128)*G*grp and branch_rows =
// P*G*hkv*ceil(Nc/128)*grp; counters: P*G*hkv i32, zero before the first
// call (each call leaves them zero). Calls that share counters run on one
// stream. Requires dh in {64, 128}, 1 <= hq/hkv <= 8, contiguous 16-byte
// aligned inputs; the Python wrapper checks these.
extern "C" int decode_attn(const void* q, const void* k_self, const void* v_self, const void* kp,
                           const void* vp, const void* kc, const void* vc, const void* plens,
                           const void* t_dev, void* ws, void* counters, void* o, int P, int G, int hq,
                           int hkv, int dh, int Lp, int Nc, int t_host, float scale, void* stream) {
  if (hkv <= 0 || hq % hkv || hq / hkv > 8) return int(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k_self = static_cast<const bf16*>(k_self);
  a.v_self = static_cast<const bf16*>(v_self);
  a.kp = static_cast<const bf16*>(kp);
  a.vp = static_cast<const bf16*>(vp);
  a.kc = static_cast<const bf16*>(kc);
  a.vc = static_cast<const bf16*>(vc);
  a.plens = static_cast<const int*>(plens);
  a.t_dev = static_cast<const int*>(t_dev);
  a.counters = static_cast<int*>(counters);
  a.o = static_cast<bf16*>(o);
  a.P = P, a.G = G, a.hq = hq, a.hkv = hkv, a.grp = hq / hkv, a.Lp = Lp, a.Nc = Nc, a.t_host = t_host;
  a.ncp = (Lp + CHUNK - 1) / CHUNK;
  a.ncb = (Nc + CHUNK - 1) / CHUNK;
  a.gpt = TR / a.grp;  // whole branches in a prompt unit's row tile
  a.n_rt = (G + a.gpt - 1) / a.gpt;
  a.n_prompt_units = P * hkv * a.n_rt * a.ncp;
  a.n_work_units = a.n_prompt_units + P * G * hkv * a.ncb;
  a.scale = scale;
  const size_t prompt_rows = size_t(P) * hkv * a.ncp * G * a.grp;
  const size_t branch_rows = size_t(P) * G * hkv * a.ncb * a.grp;
  float* f = static_cast<float*>(ws);
  a.pacc = f;
  a.bacc = a.pacc + prompt_rows * dh;
  a.pm = a.bacc + branch_rows * dh;
  a.pl = a.pm + prompt_rows;
  a.bm = a.pl + prompt_rows;
  a.bl = a.bm + branch_rows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh == 128) return launch<128>(a, st);
  if (dh == 64) return launch<64>(a, st);
  return int(cudaErrorInvalidValue);
}
