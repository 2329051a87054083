// The dq of the split tree-attention backward (K11) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _dq_kernel of
// dynamictreeattn_tpu/ops/tree_attention.py: dq = sum_k dS k, with P =
// exp(S*scale - lse) (0 where masked), dP = dO V^T, dS = (dP - di) * P *
// scale and di = sum(do * o) (computed outside). P is the MUFU's 2^((S*scale
// - lse) * log2 e) (ex2.approx: ~2 ulp of fp32, under the bf16 rounding that
// follows); dS is rounded to bf16 before the dQ product, as on the TPU; every
// sum is fp32. The mask k <= q <= last_desc[k] runs on partial sub-tiles
// only. One CTA owns each (q tile, q head) and sums its sub-tiles in list
// order, so dq is written once, in bf16, with no atomics: it repeats
// bit-equal, and "split" (with K12's fixed-order dk/dv) is the card's
// bit-reproducible backward.
//
// Layouts (as the JAX package's): q, do [hkv, G, n, DH] bf16; k, v
// [hkv, n, DH] bf16; lse, di [hkv, G, n] f32; last_desc [n] i32 -> dq like q.
//
// The work list is the forward's (tries.build_qmajor_work), walked as the
// forward walks it (hopper::qmajor): each 64-row q tile's live 64-key
// sub-tiles, flagged full or partial, the tiles heaviest first. A sub-tile
// that is not listed holds no unmasked pair of the tile: P = 0 there, so it
// adds exactly 0 to dq.
//
// Design, on the forward's structure (tree_attn_fwd.cu). A CTA owns one q
// tile of a slice of GS = 2 group heads; warpgroups 0 and 1 consume, one
// group head each; one thread of warpgroup 2 loads both heads' Q and dO
// tiles and their 64 lse and di values once, then keeps a ring of STAGES
// (K, V, last_desc) sub-tiles full on full / empty mbarriers (setmaxnreg
// 40 / 232; the host checks the entry count, 168). Per listed sub-tile, in
// each consumer (wgmma, fp32 accumulators in registers):
//   S = Q K^T and dP = dO V^T  (m64n64k16, Q / dO and K / V K-major in smem);
//   P and dS in registers (the mask on partial sub-tiles only), dS rounded
//     to bf16 as the A operand of the next product;
//   dQ += dS K  (m64nDHk16, dS from registers, K MN-major in smem: the form
//     of the forward's O += P V).
// At DH 64 the walk runs one sub-tile ahead: S and dP of sub-tile i go out
// beside dQ of i - 1, and dS of i is computed while that dQ product runs.
// Two dS buffers take turns, and dS only reads the S / dP accumulators, so
// no ordinary instruction writes a product's input registers while it may
// be in flight (ptxas would serialise every wgmma of the kernel). At DH 128
// the look-ahead is dropped: dQ (64), S (32), dP (32) and two dS buffers (2
// x 16) did not fit beside the walk's other values in the 232 registers a
// consumer takes -- ptxas spilled and serialised every wgmma -- and that
// build ran slower on an H100 than the walk that waits for each product
// group; there the CTA's two consumer warpgroups overlap one's dS with the
// other's products. A stage is released once dQ of its sub-tile is done
// (its S and dP were done first).
//
// What bounds it on the card: 6*DH flops (S, dP, dQ) per unmasked (q, k)
// pair per q head against one read of q/k/v/do -- operation-bound at the
// tensor-core rate. This version computes whole 64 x 64 sub-tiles, masked
// pairs included; each head slice reads K/V again (through L2), and the two
// consumers share one SM's tensor cores in no fixed turn order.
//
// The split backward's other half, K12 (dk, dv), is the key-major kernel of
// tree_attn_bwd_kmajor.cu.

#include "hopper.cuh"

namespace bwd_dq {

using namespace hopper;
using namespace hopper::qmajor;

template <int DH>
struct Layout {
  // ring stages: one CTA an SM (its registers), 4 stages fit in 227 KB at DH 128
  static constexpr int STAGES = 4;
  static constexpr int TILE = TK * DH * 2;  // a [64][DH] bf16 tile: DH / 64 boxes
  static constexpr int Q_OFF = 0;                           // [GS] tiles
  static constexpr int DO_OFF = Q_OFF + GS * TILE;          // [GS] tiles
  static constexpr int K_OFF = DO_OFF + GS * TILE;          // [STAGES] tiles
  static constexpr int V_OFF = K_OFF + STAGES * TILE;       // [STAGES] tiles
  static constexpr int LD_OFF = V_OFF + STAGES * TILE;      // last_desc [STAGES][64] i32
  static constexpr int L_OFF = LD_OFF + STAGES * TK * 4;    // lse [GS][64] f32
  static constexpr int D_OFF = L_OFF + GS * TK * 4;         // di [GS][64] f32
  static constexpr int BAR_OFF = D_OFF + GS * TK * 4;       // full[STAGES], empty[STAGES], q
  static constexpr int BYTES = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;  // + room to align the base
};

// ---------------------------------------------------------------------- kernel

struct Params {
  const int* last_desc;
  const int* entries;
  const float* lse;
  const float* di;
  bf16* dq;
  int group, n;
  float scale;
  int q_off, kv_off;  // a ring pair's global offsets, as in the forward (0 on one device)
};

// One consumer warpgroup's walk over its q tile's entries for group head
// c.g0 + hl (hl: the head's place in the slice): 64 rows, fp32 dQ in
// registers; one sub-tile ahead at DH 64 only (see the note at the top).
// OFFS: a ring pair's offsets (instantiated apart, as in tree_attn_fwd.cu,
// so that the one-device code runs unchanged).
template <int DH, bool OFFS>
__device__ __forceinline__ void consume(const Params& a, uint32_t base, const unsigned char* sm, int hl,
                                        const Cta& c) {
  using L = Layout<DH>;
  constexpr int S = L::STAGES, NJ = DH / 8;
  constexpr bool AHEAD = DH == 64;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int grp = lane >> 2, t4 = lane & 3;  // accumulator fragment coordinates
  const uint32_t sQg = base + L::Q_OFF + hl * L::TILE, sdOg = base + L::DO_OFF + hl * L::TILE;
  const uint32_t sK = base + L::K_OFF, sV = base + L::V_OFF, bars = base + L::BAR_OFF;
  const int* LDs = reinterpret_cast<const int*>(sm + L::LD_OFF);
  // this thread's rows: tile rows rl[0], rl[1], q positions qrow[0], qrow[1]
  const int rl[2] = {warp * 16 + grp, warp * 16 + grp + 8};
  const int qrow[2] = {c.r0 + rl[0], c.r0 + rl[1]};
  // the mask's two sides (tree_attn_fwd.cu): the query in the keys' local
  // positions and its global position
  const int shift_k = OFFS ? a.q_off - a.kv_off : 0, shift_g = OFFS ? a.q_off : 0;
  const int qk[2] = {qrow[0] + shift_k, qrow[1] + shift_k};
  const int qg[2] = {qrow[0] + shift_g, qrow[1] + shift_g};
  const float scale_log2 = a.scale * LOG2E;

  float dq_acc[NJ][4];
  zero(dq_acc);
  mbar_wait(bars + 8 * 2 * S, 0);  // Q, dO, lse, di
  const float* Ls = reinterpret_cast<const float*>(sm + L::L_OFF) + hl * TK;
  const float* Ds = reinterpret_cast<const float*>(sm + L::D_OFF) + hl * TK;
  const float lse2[2] = {Ls[rl[0]] * LOG2E, Ls[rl[1]] * LOG2E};  // lse in the log2 domain
  const float di_r[2] = {Ds[rl[0]], Ds[rl[1]]};

  float s_acc[TK / 8][4], dp_acc[TK / 8][4];
  uint32_t dsA[TK / 16][4], dsB[TK / 16][4];  // dS of two sub-tiles in turn (B: the look-ahead only)
  // S = Q K^T and dP = dO V^T of sub-tile `it` (stage it % S), one product group
  auto issue_sdp = [&](int it) {
    const uint32_t st = (it % S) * L::TILE;
    zero(s_acc);
    zero(dp_acc);
    pin(s_acc);
    pin(dp_acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss_n64(s_acc, desc_kmaj(sQg, kk), desc_kmaj(sK + st, kk), kk);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss_n64(dp_acc, desc_kmaj(sdOg, kk), desc_kmaj(sV + st, kk), kk);
    wg_commit();
  };
  // dQ += dS K of sub-tile `it`, dS from `ds`, one product group
  auto issue_dq = [&](int it, uint32_t (&ds)[TK / 16][4]) {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) wgmma_rs_t<DH>(dq_acc, ds[kk], desc_mnmaj(sK + (it % S) * L::TILE, kk));
    wg_commit();
  };
  // dS of sub-tile `it` from s_acc and dp_acc into `ds` (the accumulators
  // only read: a product may be in flight); element el of n-tile j: key
  // j*8 + 2*t4 + (el & 1), row rl[el >> 1]
  auto grad = [&](int it, uint32_t (&ds)[TK / 16][4]) {
    const int e = a.entries[c.e0 + it];
    const int c0 = e >> 1;
    const bool partial = e & 1;
    const int* ld = LDs + (it % S) * TK;
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
      float dsv[4];
#pragma unroll
      for (int el = 0; el < 4; ++el) {
        const int r = el >> 1;
        float p = ex2(s_acc[j][el] * scale_log2 - lse2[r]);
        if (partial) {
          const int2 ld2 = *reinterpret_cast<const int2*>(ld + j * 8 + 2 * t4);
          const int kp = c0 + j * 8 + 2 * t4 + (el & 1);
          if constexpr (OFFS) {
            if (!(kp <= qk[r] && qg[r] <= ((el & 1) ? ld2.y : ld2.x))) p = 0.f;
          } else if (!(kp <= qrow[r] && qrow[r] <= ((el & 1) ? ld2.y : ld2.x))) {
            p = 0.f;
          }
        }
        dsv[el] = (dp_acc[j][el] - di_r[r]) * p * a.scale;
      }
      ds[j / 2][(j & 1) * 2] = pack_bf16(dsv[0], dsv[1]);
      ds[j / 2][(j & 1) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
    }
  };
  auto release = [&](int it) {  // this warp is done with stage it % S
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (S + it % S));
  };
  // sub-tile it: S/dP of it and dQ of it - 1 go out together; dS of it
  // overlaps that dQ product
  auto step = [&](int it, uint32_t (&ds_prev)[TK / 16][4], uint32_t (&ds_cur)[TK / 16][4]) {
    mbar_wait(bars + 8 * (it % S), (it / S) & 1);
    issue_sdp(it);
    issue_dq(it - 1, ds_prev);
    wg_wait_one();  // S and dP of sub-tile it
    pin(s_acc);
    pin(dp_acc);
    grad(it, ds_cur);
    wg_wait_all();  // dQ of sub-tile it - 1
    pin(dq_acc);
    pin(ds_prev);
    pin(s_acc);  // the accumulators live through the step: no dS value takes their registers
    pin(dp_acc);
    release(it - 1);
  };
  auto last = [&](uint32_t (&ds)[TK / 16][4]) {
    issue_dq(c.cnt - 1, ds);
    wg_wait_all();
    pin(dq_acc);
    pin(ds);
    release(c.cnt - 1);
  };

  if constexpr (!AHEAD) {
    for (int it = 0; it < c.cnt; ++it) {
      mbar_wait(bars + 8 * (it % S), (it / S) & 1);
      issue_sdp(it);
      wg_wait_all();
      pin(s_acc);
      pin(dp_acc);
      grad(it, dsA);
      issue_dq(it, dsA);
      wg_wait_all();
      pin(dq_acc);
      pin(dsA);
      release(it);
    }
  } else if (c.cnt > 0) {
    mbar_wait(bars, 0);  // stage 0
    issue_sdp(0);
    wg_wait_all();
    pin(s_acc);
    pin(dp_acc);
    grad(0, dsA);
    int it = 1;
    for (; it + 1 < c.cnt; it += 2) {
      step(it, dsA, dsB);
      step(it + 1, dsB, dsA);
    }
    if (it < c.cnt) {
      step(it, dsA, dsB);
      last(dsB);
    } else {
      last(dsA);
    }
  }

  // ---- emit dq (0 for a tile with no live sub-tile)
  const size_t row_base = (size_t(c.h) * a.group + c.g0 + hl) * a.n;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int d = j * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(a.dq + (row_base + qrow[0]) * DH + d) =
        __floats2bfloat162_rn(dq_acc[j][0], dq_acc[j][1]);
    *reinterpret_cast<__nv_bfloat162*>(a.dq + (row_base + qrow[1]) * DH + d) =
        __floats2bfloat162_rn(dq_acc[j][2], dq_acc[j][3]);
  }
}

template <int DH, bool OFFS>
__global__ void __launch_bounds__(NTHREADS, 1)
tree_attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                        const int* __restrict__ tiles, int hkv, const Params a) {
  using L = Layout<DH>;
  constexpr int S = L::STAGES, NB = DH / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the 128-byte swizzle repeats every 1024 bytes
  const unsigned char* sm = smem_raw + (base - raw);
  const uint32_t bars = base + L::BAR_OFF;

  const int tid = threadIdx.x, wg = tid / 128;
  const Cta c = cta(tiles, hkv, a.group);

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);                  // full: the producer's expect_tx + the copies
      mbar_init(bars + 8 * (S + s), 4 * c.heads);  // empty: every consumer warp
    }
    mbar_init(bars + 8 * 2 * S, 1);                // Q, dO, lse, di
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == GS) {  // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    if (tid == NCONS) {
      const uint32_t qbar = bars + 8 * 2 * S;
      mbar_expect_tx(qbar, c.heads * (2 * L::TILE + 2 * TK * 4));
      for (int hh = 0; hh < c.heads; ++hh) {
        const int row = (c.h * a.group + c.g0 + hh) * a.n + c.r0;
#pragma unroll
        for (int x = 0; x < NB; ++x) {
          tma_box(base + L::Q_OFF + hh * L::TILE + x * BOX_BYTES, &tm_q, qbar, x * 64, row);
          tma_box(base + L::DO_OFF + hh * L::TILE + x * BOX_BYTES, &tm_do, qbar, x * 64, row);
        }
        bulk_copy(base + L::L_OFF + hh * TK * 4, a.lse + row, TK * 4, qbar);
        bulk_copy(base + L::D_OFF + hh * TK * 4, a.di + row, TK * 4, qbar);
      }
      fill_ring<DH, S>(&tm_k, &tm_v, a.last_desc + (OFFS ? a.kv_off : 0), a.entries, c, a.n, base + L::K_OFF,
                       base + L::V_OFF, base + L::LD_OFF, bars);
    }
    return;
  }
  if (wg >= c.heads) return;  // the idle head of an odd group's last slice
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
  consume<DH, OFFS>(a, base, sm, wg, c);
}

// ---------------------------------------------------------------------- launch

template <int DH, bool OFFS>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* tiles, int n_tiles,
           int hkv, const Params& a, cudaStream_t stream) {
  using L = Layout<DH>;
  CUtensorMap tq, tdo, tk, tv;
  const long long rows_q = (long long)hkv * a.group * a.n, rows_k = (long long)hkv * a.n;
  if (!tensor_map(&tq, q, rows_q, DH) || !tensor_map(&tdo, dout, rows_q, DH) ||
      !tensor_map(&tk, k, rows_k, DH) || !tensor_map(&tv, v, rows_k, DH))
    return int(cudaErrorInvalidValue);
  auto kernel = tree_attn_bwd_dq_kernel<DH, OFFS>;
  static const int regs = check_entry_regs(reinterpret_cast<const void*>(kernel));
  if (regs != 0) return regs;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return int(err);
  const int grid = n_tiles * hkv * ((a.group + GS - 1) / GS);
  if (grid == 0) return 0;
  kernel<<<grid, NTHREADS, L::BYTES, stream>>>(tq, tdo, tk, tv, static_cast<const int*>(tiles), hkv, a);
  return int(cudaGetLastError());
}

}  // namespace bwd_dq

// K11: dq like q from the query-major work list (tiles [n_tiles, 3] and
// entries, tries.build_qmajor_work: the forward's).
// q_off, kv_off: a ring pair's global offsets (multiples of 64; 0 on one
// device), last_desc then the whole table.
// Requires n % 64 == 0 and n_tiles == n / 64, dh in {64, 128}, group >= 1
// (the Python wrapper takes 1..8), contiguous 16-byte aligned tensors; the
// Python wrapper checks these.
extern "C" int tree_attn_bwd_dq(const void* q, const void* k, const void* v, const void* last_desc,
                                const void* tiles, const void* entries, const void* dout, const void* lse,
                                const void* di, void* dq, int n_tiles, int hkv, int group, int n, int dh,
                                int q_off, int kv_off, float scale, void* stream) {
  if (group < 1 || hkv < 1 || q_off < 0 || kv_off < 0) return int(cudaErrorInvalidValue);
  const bwd_dq::Params a{static_cast<const int*>(last_desc), static_cast<const int*>(entries),
                     static_cast<const float*>(lse), static_cast<const float*>(di),
                     static_cast<hopper::bf16*>(dq), group, n, scale, q_off, kv_off};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool offs = q_off != 0 || kv_off != 0;
  if (dh == 128)
    return offs ? bwd_dq::launch<128, true>(q, k, v, dout, tiles, n_tiles, hkv, a, st)
                : bwd_dq::launch<128, false>(q, k, v, dout, tiles, n_tiles, hkv, a, st);
  if (dh == 64)
    return offs ? bwd_dq::launch<64, true>(q, k, v, dout, tiles, n_tiles, hkv, a, st)
                : bwd_dq::launch<64, false>(q, k, v, dout, tiles, n_tiles, hkv, a, st);
  return int(cudaErrorInvalidValue);
}
