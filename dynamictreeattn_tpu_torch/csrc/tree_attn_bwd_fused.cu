// Block-sparse tree-masked attention backward, fused (dq, dk, dv in one pass),
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _dqdkv_kernel (K10, bwd_mode="fused") of
// dynamictreeattn_tpu/ops/tree_attention.py: one query-major pass; dk/dv of
// each visited kv block read-modified-written in fp32 device memory. It
// computes, per active (q, k) pair and q head, S, P = exp(S*scale - lse)
// (0 where masked), dP = dO . V and dS = (dP - di) * P * scale ONCE, and from
// them dq += dS K, dk += dS^T Q, dv += P^T dO (10*DH flops per pair, against
// the split pair's 14*DH). P and dS are rounded to bf16 before the products,
// as on the TPU; every sum is fp32. di = sum(do * o) is computed outside.
//
// Layouts (as the JAX package's): q, do [hkv, G, n, DH] bf16; k, v
// [hkv, n, DH] bf16; lse, di [hkv, G, n] f32; last_desc [n] i32; ids / types
// [rows, slots] i32, counts [rows] i32. The mask k <= q <= last_desc[k] is
// evaluated only on type-1 (partial) tiles; type-0 slots are skipped.
//
// Design. The TPU walks (head, q block, slot) as a sequential grid, so a
// read-modify-write or a slot cache may assume every earlier visit has
// finished. Here CTAs run in parallel in no order, so the accumulator that
// crosses CTAs is summed with fp32 atomics (red.global.add) into a zeroed
// fp32 scratch; the wrapper casts it to bf16 afterwards. Sums with atomics
// land in an order that changes from run to run: not bit-reproducible.
//
// K10, tree_attn_bwd_fused: one CTA per (kv head, 64-row q tile, slice
// of GS = 2 group heads), one warp per 16 rows, as K11: the run-time
// group G takes ceil(G/GS) slices, each re-reading the K/V tiles and
// adding its own dk/dv partials; at odd G the last slice's second head
// is idle (zero Q, dO, P and dS rows, no products, no dq store). Q and
// dO stay in shared memory; K/V 64-key sub-tiles are double-buffered
// with cp.async. Per sub-tile: S = Q K^T and dP = dO V^T (mma.sync
// m16n8k16, fp32 in registers), dQ += dS K in registers; P and dS go to
// shared memory as bf16, then dV = P^T dO and dK = dS^T Q over the CTA's
// 128 rows (the slice's group heads summed in the CTA), 16 keys x DH per
// warp, added into the fp32 dk/dv scratch with vector atomics: the
// card's form of the TPU's per-visit read-modify-write.
// A 64 x 64 sub-tile with no unmasked pair is skipped: p = 0 there, exactly.
// Templates are on DH only, DH in {64, 128}. The "cached" backward (K3) is
// the key-major kernel of tree_attn_bwd_kmajor.cu.
//
// What bounds K10 on the card: 10*DH flops per unmasked (q, k) pair per q
// head against one read of q/k/v/do, so operation-bound at the tensor-core
// rate; this version runs whole 64 x 64 sub-tiles with mma.sync (not wgmma)
// and adds 32 KB of fp32 atomics per (64-row, 64-key) pair and q head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TQ = 64;  // q rows per sub-tile
constexpr int TK = 64;  // keys per sub-tile
constexpr int GS = 2;   // group heads per CTA of the query-major kernel (K10)

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

// acc[16 rows x 8*NT cols] += a[16 x 16*KS] . b^T, b stored row-major as
// [8*NT][ST] (rows = the product's columns); a from shared memory rows
// `a_rows` (16 of them, stride ST).
template <int KS, int NT, int ST>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const bf16* a_rows,
                                        const bf16* b_rows, int lane) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, a_rows + (lane & 15) * ST + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, b_rows + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * ST + ks * 16 +
                         ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[16 x 8*NT] += a_frag[16 x 16*KK] . b, b stored row-major [16*KK][ST]
// (rows = the contraction).
template <int KK, int NT, int ST>
__device__ __forceinline__ void mma_ab(float (&acc)[NT][4], const uint32_t (&a_frag)[KK][4],
                                       const bf16* b_rows, int lane) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
    for (int dp = 0; dp < NT / 2; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, b_rows + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ST +
                               dp * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * dp], a_frag[kk], b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], a_frag[kk], b[2], b[3]);
    }
  }
}

// acc[16 x 8*NT] += a^T . b with both operands in shared memory: a stored
// [16*KK][STA] (rows = the contraction; the 16 output rows are the columns
// a[:, 0..15]), b stored row-major [16*KK][STB] (rows = the contraction).
// The A fragment comes transposed out of ldmatrix: matrix j = lane / 8 holds
// output rows 8*(j & 1).. and contraction rows 8*(j >> 1)..
template <int KK, int NT, int STA, int STB>
__device__ __forceinline__ void mma_atb(float (&acc)[NT][4], const bf16* a, const bf16* b_rows,
                                        int lane) {
  const int j = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    uint32_t af[4];
    ldmatrix_x4_trans(af, a + (kk * 16 + (lane & 7) + ((j >> 1) << 3)) * STA + ((j & 1) << 3));
#pragma unroll
    for (int dp = 0; dp < NT / 2; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, b_rows + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * STB +
                               dp * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * dp], af, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], af, b[2], b[3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// dst[r][c], dst[r][c + 1] += (x, y) in fp32 device memory; c even, so the
// pair is 8-byte aligned
__device__ __forceinline__ void atomic_add2(float* dst, float x, float y) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && CUDART_VERSION >= 12010
  atomicAdd(reinterpret_cast<float2*>(dst), make_float2(x, y));  // sm_90: vector atomics
#else
  atomicAdd(dst, x);
  atomicAdd(dst + 1, y);
#endif
}

// acc (16 rows x 8*NT fp32, the mma accumulator layout of one warp) added
// into rows `rows` (stride DH) at columns col0..: row grp and grp + 8,
// columns j*8 + 2*t4, +1
template <int NT, int DH>
__device__ __forceinline__ void atomic_add_tile(float* rows, const float (&acc)[NT][4], int col0,
                                                int lane) {
  const int grp = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = col0 + j * 8 + 2 * t4;
    atomic_add2(rows + size_t(grp) * DH + c, acc[j][0], acc[j][1]);
    atomic_add2(rows + size_t(grp + 8) * DH + c, acc[j][2], acc[j][3]);
  }
}

// ------------------------------------------------------ K10: fused, query-major

template <int DH>
struct FusedLayout {
  static constexpr int R = GS * TQ;       // q rows per CTA
  static constexpr int NTHREADS = R * 2;  // one warp per 16 rows
  static constexpr int ST = DH + 8;       // bf16 row stride: conflict-free ldmatrix
  static constexpr int SP = TK + 8;       // P / dS row stride
  static constexpr size_t row_elems = size_t(R) * ST;  // the Q or dO tile
  static constexpr size_t kv_elems = size_t(TK) * ST;  // one buffer of K or V
  static constexpr size_t p_elems = size_t(R) * SP;    // P or dS of one sub-tile
  static constexpr size_t bytes = (2 * row_elems + 4 * kv_elems + 2 * p_elems) * 2 + 2 * TK * 4;
};

template <int DH>
__global__ void __launch_bounds__(FusedLayout<DH>::NTHREADS, 1)
tree_attn_bwd_fused_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const int* __restrict__ last_desc,
                           const int* __restrict__ kv_ids, const int* __restrict__ kv_counts,
                           const int* __restrict__ kv_types, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ di,
                           bf16* __restrict__ dq, float* __restrict__ dk32,
                           float* __restrict__ dv32, int group, int n, int block_q, int block_kv,
                           int slots, float scale) {
  using L = FusedLayout<DH>;
  constexpr int R = L::R, ST = L::ST, SP = L::SP, NT = L::NTHREADS, NW = NT / 32;
  constexpr int V8 = DH / 8;  // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + L::row_elems;
  bf16* Ks = dOs + L::row_elems;    // [2][TK][ST]
  bf16* Vs = Ks + 2 * L::kv_elems;  // [2][TK][ST]
  bf16* Ps = Vs + 2 * L::kv_elems;  // [R][SP]: P of the sub-tile, rows as Qs
  bf16* dSs = Ps + L::p_elems;      // [R][SP]: dS
  int* LDs = reinterpret_cast<int*>(dSs + L::p_elems);  // [2][TK]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane >> 2, t4 = lane & 3;  // mma fragment coordinates
  const int r0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int qb = r0 / block_q;
  const int nsub = block_kv / TK;
  const int total = kv_counts[qb] * nsub;

  const int g0 = blockIdx.z * GS;  // first group head of this CTA's slice

  // this warp's 16 rows: head wg of the group, q positions wrow..wrow+15; a
  // warp of the idle head (odd group, last slice) leaves its P and dS rows
  // zero and stores nothing
  const int wg = g0 + (warp * 16) / TQ;
  const bool active = wg < group;
  const int wrow = r0 + (warp * 16) % TQ;
  const int qpos[2] = {wrow + grp, wrow + grp + 8};
  const size_t row_base = (size_t(h) * group + (active ? wg : 0)) * n;

  // ---- Q and dO tiles (cp.async group 0, with the first K/V sub-tile); the
  // idle head's rows are zero-filled
  for (int idx = tid; idx < R * V8; idx += NT) {
    const int rr = idx / V8, c8 = idx % V8;
    const int hg = g0 + rr / TQ;
    const size_t src =
        ((size_t(h) * group + min(hg, group - 1)) * n + r0 + rr % TQ) * DH + c8 * 8;
    cp_async16(Qs + rr * ST + c8 * 8, q + src, hg < group);
    cp_async16(dOs + rr * ST + c8 * 8, dout + src, hg < group);
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

  const float lse_r[2] = {active ? lse[row_base + qpos[0]] : 0.f,
                          active ? lse[row_base + qpos[1]] : 0.f};
  const float di_r[2] = {active ? di[row_base + qpos[0]] : 0.f,
                         active ? di[row_base + qpos[1]] : 0.f};
  float dq_acc[DH / 8][4];
  zero(dq_acc);
  const bf16* Qw = Qs + warp * 16 * ST;
  const bf16* dOw = dOs + warp * 16 * ST;
  uint32_t* Pw = reinterpret_cast<uint32_t*>(Ps + warp * 16 * SP);
  uint32_t* dSw = reinterpret_cast<uint32_t*>(dSs + warp * 16 * SP);
  if (!active) {  // the idle head's P and dS rows stay zero (visible after the first barrier)
    for (int w = lane; w < 16 * SP / 2; w += 32) Pw[w] = dSw[w] = 0u;
  }

  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    if (it + 1 < total) load_tile(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // this sub-tile (and at it == 0 the Q/dO tiles) is visible

    const int s = it / nsub;
    const int typ = kv_types[qb * slots + s];
    const int c0 = kv_ids[qb * slots + s] * block_kv + (it % nsub) * TK;
    const int* ld = LDs + buf * TK;
    // skip a sub-tile holding no unmasked (q, k) pair of this q tile
    const int live = typ != 0 && tid < TK && c0 + tid <= r0 + TQ - 1 && ld[tid] >= r0;
    if (!__syncthreads_or(live)) continue;

    const bf16* Kb = Ks + buf * TK * ST;
    const bf16* Vb = Vs + buf * TK * ST;

    if (active) {
      // ---- S = Q K^T and dP = dO V^T: 16 x TK per warp, fp32 in registers
      float s_acc[TK / 8][4], dp_acc[TK / 8][4];
      zero(s_acc);
      zero(dp_acc);
      mma_abt<DH / 16, TK / 8, ST>(s_acc, Qw, Kb, lane);
      mma_abt<DH / 16, TK / 8, ST>(dp_acc, dOw, Vb, lane);

      // ---- P and dS = (dP - di) * P * scale; element e of n-tile j: key
      // j*8 + 2*t4 + (e & 1), row grp + 8*(e >> 1). Both to shared memory as
      // bf16 (row-major [row][key]), dS also as the A operand of dQ += dS K.
      uint32_t ds_frag[TK / 16][4];
#pragma unroll
      for (int j = 0; j < TK / 8; ++j) {
        float pv[4], dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int kl = j * 8 + 2 * t4 + (e & 1);
          const bool keep = typ != 1 || (c0 + kl <= qpos[r] && qpos[r] <= ld[kl]);
          const float p = keep ? expf(s_acc[j][e] * scale - lse_r[r]) : 0.f;
          pv[e] = p;
          dsv[e] = (dp_acc[j][e] - di_r[r]) * p * scale;
        }
        const uint32_t d0 = pack_bf16(dsv[0], dsv[1]), d1 = pack_bf16(dsv[2], dsv[3]);
        ds_frag[j / 2][(j & 1) * 2] = d0;
        ds_frag[j / 2][(j & 1) * 2 + 1] = d1;
        const int w0 = (grp * SP + j * 8 + 2 * t4) / 2, w1 = ((grp + 8) * SP + j * 8 + 2 * t4) / 2;
        Pw[w0] = pack_bf16(pv[0], pv[1]);
        Pw[w1] = pack_bf16(pv[2], pv[3]);
        dSw[w0] = d0;
        dSw[w1] = d1;
      }

      // ---- dQ += dS K
      mma_ab<TK / 16, DH / 8, ST>(dq_acc, ds_frag, Kb, lane);
    }
    __syncthreads();  // every warp's P and dS rows are visible

    // ---- dV = P^T dO and dK = dS^T Q over the CTA's R rows (the slice's
    // group heads): 16 keys x DH per warp and unit, added into the fp32 scratch
    for (int u = warp; u < 2 * (TK / 16); u += NW) {
      const bool is_k = u >= TK / 16;
      const int kr = (u % (TK / 16)) * 16;
      float acc[DH / 8][4];
      zero(acc);
      mma_atb<R / 16, DH / 8, SP, ST>(acc, (is_k ? dSs : Ps) + kr, is_k ? Qs : dOs, lane);
      atomic_add_tile<DH / 8, DH>((is_k ? dk32 : dv32) + (size_t(h) * n + c0 + kr) * DH, acc, 0,
                                  lane);
    }
    __syncthreads();  // the buffers and P/dS may be refilled by the next iteration
  }
  cp_async_wait_all();

  // ---- emit dq
  if (!active) return;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int d = j * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(dq + (row_base + qpos[0]) * DH + d) =
        __floats2bfloat162_rn(dq_acc[j][0], dq_acc[j][1]);
    *reinterpret_cast<__nv_bfloat162*>(dq + (row_base + qpos[1]) * DH + d) =
        __floats2bfloat162_rn(dq_acc[j][2], dq_acc[j][3]);
  }
}

// ------------------------------------------------------------------ launch

struct Args {
  const void *q, *k, *v, *last_desc, *ids, *counts, *types, *dout, *lse, *di;
  int hkv, group, n, block_q, block_kv, slots;
  float scale;
  cudaStream_t stream;
};

template <int DH>
int launch_fused(const Args& a, void* dq, void* dk32, void* dv32) {
  using L = FusedLayout<DH>;
  auto kernel = tree_attn_bwd_fused_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(L::bytes));
  if (err != cudaSuccess) return int(err);
  dim3 grid(a.n / TQ, a.hkv, (a.group + GS - 1) / GS);
  kernel<<<grid, L::NTHREADS, L::bytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const int*>(a.last_desc),
      static_cast<const int*>(a.ids), static_cast<const int*>(a.counts),
      static_cast<const int*>(a.types), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.di),
      static_cast<bf16*>(dq), static_cast<float*>(dk32), static_cast<float*>(dv32), a.group,
      a.n, a.block_q, a.block_kv, a.slots, a.scale);
  return int(cudaGetLastError());
}

}  // namespace

// Requires n % block_q == 0, n % block_kv == 0, block_q % 64 == 0,
// block_kv % 64 == 0, dh in {64, 128}, group >= 1 (the Python wrapper
// takes 1..8), contiguous 16-byte aligned tensors; the Python wrapper checks
// these. `slots` is the width of the metadata rows. K10 reads the
// query-major metadata (kv_ids, ...) and adds into dk32/dv32, fp32
// [hkv, n, dh], zeroed by the caller; it writes dq.
extern "C" int tree_attn_bwd_fused(const void* q, const void* k, const void* v,
                                   const void* last_desc, const void* kv_ids,
                                   const void* kv_counts, const void* kv_types,
                                   const void* dout, const void* lse, const void* di, void* dq,
                                   void* dk32, void* dv32, int hkv, int group, int n, int dh,
                                   int block_q, int block_kv, int slots, float scale,
                                   void* stream) {
  const Args a{q, k, v, last_desc, kv_ids, kv_counts, kv_types, dout, lse, di,
               hkv, group, n, block_q, block_kv, slots, scale, static_cast<cudaStream_t>(stream)};
  if (group < 1) return int(cudaErrorInvalidValue);
  if (dh == 128) return launch_fused<128>(a, dq, dk32, dv32);
  if (dh == 64) return launch_fused<64>(a, dq, dk32, dv32);
  return int(cudaErrorInvalidValue);
}
