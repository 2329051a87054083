// The key-major tree-attention backward for Hopper (sm_90a): one kernel
// template for K3 (tree_attn_bwd_cached, bwd_mode="cached") and K10
// (tree_attn_bwd_fused, bwd_mode="fused"), both dq, dk, dv (WITH_DQ = true),
// and K12 (tree_attn_bwd_dkv, the dk/dv half of "split": dk, dv summed over
// the GQA group; WITH_DQ = false).
//
// Replaces _dqdkv_cached_kernel, _dqdkv_kernel and _dkv_kernel of
// dynamictreeattn_tpu/ops/tree_attention.py. On the TPU, K10 is one
// query-major pass that reads and writes each kv block's dk/dv in device
// memory at every visit, and K3 the same pass with the accumulators cached
// in VMEM by a host slot schedule. Both compute one function, and on Hopper
// the natural one-pass form is key-major: dk/dv stay on chip for a key
// tile's whole walk and dq is reduced. So K3 and K10 are one kernel here,
// K10's entry taking no schedule (K3's wrapper checks its schedule on the
// CPU only, where the plain K3 replays it: the kernel never reads one).
//
// Per unmasked (q, k) pair and q head: P = exp(S*scale - lse) (0 where
// masked), dS = (dP - di) * P * scale, dV += P^T dO, dK += dS^T Q and, with
// dq, dQ += dS K. P is the MUFU's
// 2^((S*scale - lse) * log2 e) (ex2.approx: ~2 ulp of fp32, under the bf16
// rounding that follows). P and dS are rounded to bf16 before the products;
// every sum is fp32. The mask k <= q <= last_desc[k] runs on units of
// partial (type-1) blocks only. K12 of a ring pair passes the global
// positions of its first query and first key and the whole last_desc: the
// mask is then kv_off + k <= q_off + q <= last_desc[kv_off + k], everything
// else indexed locally (K3 and K10 run at offset 0).
//
// Layouts (as the JAX package's): q, do [hkv, G, n, DH] bf16; k, v
// [hkv, n, DH] bf16; lse, di [hkv, G, n] f32; last_desc [n] i32.
//
// The work list (tries.build_kmajor_work, built once per batch on the host).
// A unit is a live 64-row q sub-tile of a 64-key tile: units[] holds
// row_start * 2 + partial, key tile by key tile. A CTA takes one chunk of one
// key tile for one kv head -- chunks[c] = (key tile, first unit, units, part
// base, part, parts, counter, 0), grid = chunks x kv heads, chunk-major --
// and walks its units over every group head. Under tree attention a key of
// the shared prompt is seen by every later query, so the first key tiles
// carry most of the trie: the host splits a tile whose units exceed
// ceil(kv heads * units / (CTA slots * chunks a slot)) into near-equal
// chunks and orders the chunks heaviest first, so that no CTA walks much
// more than the mean per SM. An unsplit tile keeps its dK/dV in registers
// and writes them once in bf16. The chunks of a split tile write fp32
// partials to `part` (sized by the split chunks only); the CTA that
// finishes the tile last (an arrival counter per tile and kv head, zeroed by
// the caller) sums all the tile's partials in part order and writes bf16: a
// fixed-order reduction, so dK/dV repeat bit-equal. dQ is added into an
// fp32 scratch (zeroed by the caller) by the TMA unit's bulk reduce-add, in
// no fixed order: K3's and K10's dq do not repeat bit-equal.
//
// One warpgroup (128 threads) per CTA, three CTAs per SM at DH 64 and two at
// 128 (the work list is balanced over those slots). K and V of the key
// tile, and a ring of STAGES stages of (Q, dO, lse, di) per (unit, group
// head), arrive by TMA (128-byte swizzle, 64 x 64 boxes) and bulk copies on
// mbarriers; thread 0 refills a stage as soon as the CTA is done with it.
// At DH 128 the walk holds 192 accumulator registers of the 255 a thread
// may have (dK, dV, S^T, dP^T): loop state is kept lean for it (lse / di
// read as pairs, the unit and group head counted, the split fields read
// after the walk); ptxas reports no spill. Five wgmma products per unit,
// fp32 accumulators in registers:
//   S^T = K Q^T and dP^T = V dO^T  (m64n64, both operands K-major in smem);
//   dV += P^T dO and dK += dS^T Q  (m64nDH, P^T / dS^T from the registers of
//     the S^T / dP^T accumulators, dO / Q MN-major in smem);
//   dQ = dS K  (m64nDH, dS^T written to smem by the threads, 128-byte
//     swizzled, read MN-major as A; K MN-major as B), staged as fp32 in the
//     stage's spent Q/dO tiles and added to the scratch by
//     cp.reduce.async.bulk.tensor (no per-thread atomics; thread 0 waits for
//     the stage to be read before refilling it).
//
// What bounds it on the card: 8*DH (K12) or 10*DH (K3, K10) flops per unmasked
// pair per q head against one read of q/k/v/do -- operation-bound at the
// tensor-core rate. This version waits for each product group before the
// next (no intra-CTA overlap; the second CTA of the SM fills the gaps) and
// reduces 64 x DH fp32 of dq per unit into device memory.
//
// Latent attention (MLA, models/deepseek_v3.py) scores q . k over DH = 192
// and sums p v over DV = 128, at group 1: K3 and K10 at those widths are
// tree_attn_bwd_kmajor_mla_kernel<192, 128> (K12 refuses them). Its
// accumulators would not fit the walk above: dK (64 x 192) and dV (64 x 128)
// take 160 fp32 registers a thread for the CTA's whole walk, so with S^T and
// dP^T at 64 queries (64 more) and the loop state it would spill, and dQ
// (64 x 192, 96 more) could not sit beside dK and dV at all. So each unit
// runs in two halves of 32 queries (S^T and dP^T at m64n32, 16 registers
// each; dV += P^T dO and dK += dS^T Q over the half's 32 rows, dK at
// m64n192), and dQ = dS K in three passes of 64 columns (32 registers each),
// staged in the stage's spent Q and dO tiles and a 16 KB staging tile. The
// CTA's shared memory is then 106 KB with one stage, so two CTAs share an
// SM: each unit's loads wait for the unit before it, and the other CTA
// fills the gap.

#include "hopper.cuh"

namespace kmajor {

using namespace hopper;

constexpr int TK = 64;          // keys per CTA: the wgmma M
constexpr int TQ = 64;          // q rows per unit
constexpr int NTHREADS = 128;   // one warpgroup
constexpr int CHUNK_FIELDS = 8;

template <int DH>
struct Layout {
  // CTAs an SM (registers: ~165 a thread at DH 64, 254 at 128) and ring
  // stages that fit beside them in 227 KB of shared memory
  static constexpr int CTAS = DH == 64 ? 3 : 2;
  static constexpr int STAGES = DH == 64 ? 3 : 2;
  static constexpr int TILE = TK * DH * 2;          // a [64][DH] bf16 tile: DH / 64 boxes
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + TILE;
  static constexpr int Q_OFF = V_OFF + TILE;             // [STAGES] tiles
  static constexpr int DO_OFF = Q_OFF + STAGES * TILE;   // [STAGES] tiles
  static constexpr int DS_OFF = DO_OFF + STAGES * TILE;  // dS^T [64 keys][64 q] bf16
  static constexpr int L_OFF = DS_OFF + TK * TQ * 2;     // lse [STAGES][64] f32
  static constexpr int D_OFF = L_OFF + STAGES * TQ * 4;  // di [STAGES][64] f32
  static constexpr int BAR_OFF = D_OFF + STAGES * TQ * 4;  // mbarriers: STAGES, then K/V
  static constexpr int FLAG_OFF = BAR_OFF + (STAGES + 1) * 8;
  static constexpr int BYTES = FLAG_OFF + 16 + 1024;  // + room to align the base to 1024
  static constexpr uint32_t STAGE_TX = 2 * TILE + 2 * TQ * 4;
};

// ---------------------------------------------------------------------- kernel

template <int DH, bool WITH_DQ>
__global__ void __launch_bounds__(NTHREADS, Layout<DH>::CTAS)
tree_attn_bwd_kmajor_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_do,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_dq, const float* __restrict__ lse,
                            const float* __restrict__ di, const int* __restrict__ last_desc,
                            const int* __restrict__ chunks, const int* __restrict__ units,
                            bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ part,
                            int* __restrict__ counters, int hkv, int group, int n, float scale,
                            int q_off, int kv_off) {
  using L = Layout<DH>;
  constexpr int S = L::STAGES, NB = DH / 64, NJ = DH / 8;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the 128-byte swizzle repeats every 1024 bytes
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t sK = base + L::K_OFF, sV = base + L::V_OFF, sQ = base + L::Q_OFF;
  const uint32_t sdO = base + L::DO_OFF, sDS = base + L::DS_OFF, bars = base + L::BAR_OFF;
  const float* Ls = reinterpret_cast<const float*>(sm + L::L_OFF);
  const float* Ds = reinterpret_cast<const float*>(sm + L::D_OFF);
  int* last_flag = reinterpret_cast<int*>(sm + L::FLAG_OFF);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane >> 2, t4 = lane & 3;  // accumulator fragment coordinates
  const int h = blockIdx.x % hkv;
  const int* ch = chunks + (blockIdx.x / hkv) * CHUNK_FIELDS;
  const int k0 = ch[0] * TK, u0 = ch[1], total = ch[2] * group;  // iterations: (unit, group head)

  // thread 0: iteration it's Q, dO (TMA boxes) and lse, di (bulk copies) into stage it % S
  const CUtensorMap *map_q = &tm_q, *map_do = &tm_do;
  auto issue = [&](int it) {
    const int s = it % S;
    const int row = (h * group + it % group) * n + (units[u0 + it / group] >> 1);
    const uint32_t bar = bars + 8 * s;
    mbar_expect_tx(bar, L::STAGE_TX);
#pragma unroll
    for (int x = 0; x < NB; ++x) {
      tma_box(sQ + s * L::TILE + x * BOX_BYTES, map_q, bar, x * 64, row);
      tma_box(sdO + s * L::TILE + x * BOX_BYTES, map_do, bar, x * 64, row);
    }
    bulk_copy(smem_u32(Ls + s * TQ), lse + row, TQ * 4, bar);
    bulk_copy(smem_u32(Ds + s * TQ), di + row, TQ * 4, bar);
  };
  if (tid == 0) {
    for (int s = 0; s <= S; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && total > 0) {
    const uint32_t bar = bars + 8 * S;
    mbar_expect_tx(bar, 2 * L::TILE);
#pragma unroll
    for (int x = 0; x < NB; ++x) {
      tma_box(sK + x * BOX_BYTES, &tm_k, bar, x * 64, h * n + k0);
      tma_box(sV + x * BOX_BYTES, &tm_v, bar, x * 64, h * n + k0);
    }
    for (int it = 0; it < S && it < total; ++it) issue(it);
  }

  // P = exp(S*scale - lse) as exp2 of (S*scale - lse) * log2(e)
  const float scale_log2 = scale * LOG2E;
  // this thread's accumulator rows: keys kw + grp and kw + grp + 8
  const int kw = warp * 16;
  const int kpos[2] = {k0 + kw + grp, k0 + kw + grp + 8};
  // the mask kv_off + k <= q_off + q <= last_desc[kv_off + k] in the
  // queries' local positions: the key and its last_desc shifted once here
  // (a ring pair's offsets; 0 on one device and for K3 / K10)
  const int kq[2] = {kpos[0] + kv_off - q_off, kpos[1] + kv_off - q_off};
  const int ldk[2] = {last_desc[kv_off + kpos[0]] - q_off, last_desc[kv_off + kpos[1]] - q_off};
  float dk_acc[NJ][4], dv_acc[NJ][4];
  zero(dk_acc);
  zero(dv_acc);
  if (total > 0) mbar_wait(bars + 8 * S, 0);

  int ui = 0, g = 0;
  for (int it = 0; it < total; ++it) {
    const int s = it % S;
    const int unit = units[u0 + ui];
    const int r0 = unit >> 1;
    const bool partial = unit & 1;
    const uint32_t sQs = sQ + s * L::TILE, sdOs = sdO + s * L::TILE;
    const float* Lb = Ls + s * TQ;
    const float* Db = Ds + s * TQ;
    mbar_wait(bars + 8 * s, (it / S) & 1);

    // ---- S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
    float s_acc[TQ / 8][4], dp_acc[TQ / 8][4];
    zero(s_acc);
    zero(dp_acc);
    pin(s_acc);
    pin(dp_acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss_n64(s_acc, desc_kmaj(sK, kk), desc_kmaj(sQs, kk), kk);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss_n64(dp_acc, desc_kmaj(sV, kk), desc_kmaj(sdOs, kk), kk);
    wg_commit();
    wg_wait_all();
    pin(s_acc);
    pin(dp_acc);

    // ---- P^T and dS^T; element e of n-tile j: query j*8 + 2*t4 + (e & 1),
    // key row kw + grp + 8*(e >> 1). As bf16 A fragments (k-slice j / 2)
    // and, for dQ, dS^T to shared memory (row = key, 128-byte swizzle:
    // 16-byte chunk j of row r at chunk j ^ (r & 7)).
    uint32_t p_frag[TQ / 16][4], ds_frag[TQ / 16][4];
#pragma unroll
    for (int j = 0; j < TQ / 8; ++j) {
      float pv[4], dsv[4];
      const float2 l2 = *reinterpret_cast<const float2*>(Lb + j * 8 + 2 * t4);
      const float2 d2 = *reinterpret_cast<const float2*>(Db + j * 8 + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int qp = r0 + j * 8 + 2 * t4 + (e & 1);
        const bool keep = !partial || (kq[r] <= qp && qp <= ldk[r]);
        const float p = keep ? ex2(s_acc[j][e] * scale_log2 - (e & 1 ? l2.y : l2.x) * LOG2E) : 0.f;
        pv[e] = p;
        dsv[e] = (dp_acc[j][e] - (e & 1 ? d2.y : d2.x)) * p * scale;
      }
      p_frag[j / 2][(j & 1) * 2] = pack_bf16(pv[0], pv[1]);
      p_frag[j / 2][(j & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
      const uint32_t d0 = pack_bf16(dsv[0], dsv[1]), d1 = pack_bf16(dsv[2], dsv[3]);
      ds_frag[j / 2][(j & 1) * 2] = d0;
      ds_frag[j / 2][(j & 1) * 2 + 1] = d1;
      if constexpr (WITH_DQ) {
        const int rlo = kw + grp;  // rlo and rlo + 8 share (r & 7)
        const int off = ((j ^ (rlo & 7)) << 4) + 4 * t4;
        *reinterpret_cast<uint32_t*>(sm + L::DS_OFF + rlo * 128 + off) = d0;
        *reinterpret_cast<uint32_t*>(sm + L::DS_OFF + (rlo + 8) * 128 + off) = d1;
      }
    }
    if constexpr (WITH_DQ) fence_async_smem();  // dS^T stores -> the dQ product

    // ---- dV += P^T dO, dK += dS^T Q
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < TQ / 16; ++kk) wgmma_rs_t<DH>(dv_acc, p_frag[kk], desc_mnmaj(sdOs, kk));
#pragma unroll
    for (int kk = 0; kk < TQ / 16; ++kk) wgmma_rs_t<DH>(dk_acc, ds_frag[kk], desc_mnmaj(sQs, kk));
    wg_commit();
    wg_wait_all();
    pin(p_frag);  // the products read the fragments until here
    pin(ds_frag);
    pin(dk_acc);
    pin(dv_acc);

    if constexpr (WITH_DQ) {
      __syncthreads();  // every warp's dS^T rows are in shared memory
      // ---- dQ[unit rows] = dS K: 64 q rows x DH
      float dq_acc[NJ][4];
      zero(dq_acc);
      pin(dq_acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) wgmma_ss_tt<DH>(dq_acc, desc_mnmaj(sDS, kk), desc_mnmaj(sK, kk), kk);
      wg_commit();
      wg_wait_all();
      pin(dq_acc);
      // staged as fp32 in the stage's Q and dO tiles, whose products are
      // done: DH / 32 boxes of 64 rows x 32 fp32 (128 bytes, 128-byte
      // swizzle), added into the fp32 scratch by the TMA unit
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int b = j / 4;  // box of columns 8j + 2*t4, +1
        const uint32_t box = b < NB ? sQs + b * BOX_BYTES : sdOs + (b - NB) * BOX_BYTES;
        const int chunk = 2 * (j % 4) + (t4 >> 1), within = (t4 & 1) * 8;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = kw + grp + 8 * r;
          *reinterpret_cast<float2*>(sm + (box - base) + row * 128 + ((chunk ^ grp) << 4) + within) =
              make_float2(dq_acc[j][2 * r], dq_acc[j][2 * r + 1]);
        }
      }
      fence_async_smem();
    }
    __syncthreads();  // stage s (and dS^T) are free; with dq, its dQ tile is staged
    if (tid == 0) {
      if constexpr (WITH_DQ) {
        const int row = (h * group + g) * n + r0;
#pragma unroll
        for (int b = 0; b < DH / 32; ++b)
          tma_reduce_add(&tm_dq, b < NB ? sQs + b * BOX_BYTES : sdOs + (b - NB) * BOX_BYTES, b * 32, row);
        bulk_commit();
      }
      if (it + S < total) {
        if constexpr (WITH_DQ) bulk_wait_read();  // the staged dQ has left the stage
        fence_async_smem();
        issue(it + S);
      }
    }
    if (++g == group) g = 0, ++ui;
  }
  if constexpr (WITH_DQ) {
    if (tid == 0) bulk_wait();  // the dQ reductions are done before the CTA's shared memory goes
  }

  // ---- emit dk, dv: directly, or through the split tile's fixed-order sum
  auto emit = [&]() {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = j * 8 + 2 * t4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const size_t at = (size_t(h) * n + kpos[r]) * DH + d;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(dk_acc[j][2 * r], dk_acc[j][2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
      }
    }
  };
  // the split fields, read after the walk through a fresh read of the block
  // index, so that no chunk field or pointer holds a register through it (at
  // DH 128 that one register spilled)
  uint32_t bid;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(bid));
  const int* ch_end = chunks + (bid / hkv) * CHUNK_FIELDS;
  const int pbase = ch_end[3], mypart = ch_end[4], nparts = ch_end[5], counter = ch_end[6];
  if (nparts == 1) {
    emit();
    return;
  }
  // partial p of (tile, kv head): dK then dV, each thread's registers as
  // float4s at (j * NTHREADS + tid) * 4
  constexpr size_t PART = 2 * size_t(TK) * DH;
  auto part_at = [&](int p) { return part + (size_t(pbase + p) * hkv + h) * PART; };
  float* mine = part_at(mypart);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const size_t at = (size_t(j) * NTHREADS + tid) * 4;
    *reinterpret_cast<float4*>(mine + at) = make_float4(dk_acc[j][0], dk_acc[j][1], dk_acc[j][2], dk_acc[j][3]);
    *reinterpret_cast<float4*>(mine + TK * DH + at) =
        make_float4(dv_acc[j][0], dv_acc[j][1], dv_acc[j][2], dv_acc[j][3]);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *last_flag = atomicAdd(counters + counter * hkv + h, 1) == nparts - 1;
  __syncthreads();
  if (!*last_flag) return;
  __threadfence();
  // every part from the scratch, this CTA's own included, so that the sum
  // takes the registers of one accumulator pair
  zero(dk_acc);
  zero(dv_acc);
  for (int p = 0; p < nparts; ++p) {
    const float* src = part_at(p);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const size_t at = (size_t(j) * NTHREADS + tid) * 4;
      const float4 a = __ldcg(reinterpret_cast<const float4*>(src + at));
      const float4 b = __ldcg(reinterpret_cast<const float4*>(src + TK * DH + at));
      dk_acc[j][0] += a.x, dk_acc[j][1] += a.y, dk_acc[j][2] += a.z, dk_acc[j][3] += a.w;
      dv_acc[j][0] += b.x, dv_acc[j][1] += b.y, dv_acc[j][2] += b.z, dv_acc[j][3] += b.w;
    }
  }
  emit();
}


// ------------------------------------------------------------- MLA's widths

template <int DH, int DV>
struct MlaLayout {
  static constexpr int CTAS = 2;   // CTAs an SM: registers (~255 a thread) and 106 KB each
  static constexpr int PASSES = DH / 64;  // dQ's 64-column passes
  static constexpr int TILE = TK * DH * 2;      // a [64][DH] bf16 k or q tile: DH / 64 boxes
  static constexpr int TILE_V = TK * DV * 2;    // a [64][DV] bf16 v or dO tile
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + TILE;
  static constexpr int Q_OFF = V_OFF + TILE_V;        // the one stage: Q, dO, lse, di
  static constexpr int DO_OFF = Q_OFF + TILE;
  static constexpr int DS_OFF = DO_OFF + TILE_V;      // dS^T [64 keys][64 q] bf16
  static constexpr int X_OFF = DS_OFF + TK * TQ * 2;  // one dQ pass staged: 2 boxes of 64 rows x 32 fp32
  static constexpr int L_OFF = X_OFF + 2 * BOX_BYTES;
  static constexpr int D_OFF = L_OFF + TQ * 4;
  static constexpr int BAR_OFF = D_OFF + TQ * 4;  // mbarriers: the stage, then K/V
  static constexpr int FLAG_OFF = BAR_OFF + 2 * 8;
  static constexpr int BYTES = FLAG_OFF + 16 + 1024;  // + room to align the base to 1024
  static constexpr uint32_t STAGE_TX = TILE + TILE_V + 2 * TQ * 4;
  static_assert(DH % 64 == 0 && DV % 64 == 0 && TILE >= 2 * BOX_BYTES && TILE_V >= 2 * BOX_BYTES,
                "dQ's passes are staged two boxes at a time in Q, dO and the staging tile");
};

template <int DH, int DV>
__global__ void __launch_bounds__(NTHREADS, MlaLayout<DH, DV>::CTAS)
tree_attn_bwd_kmajor_mla_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_do,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const __grid_constant__ CUtensorMap tm_dq, const float* __restrict__ lse,
                                const float* __restrict__ di, const int* __restrict__ last_desc,
                                const int* __restrict__ chunks, const int* __restrict__ units,
                                bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ part,
                                int* __restrict__ counters, int hkv, int group, int n, float scale) {
  using L = MlaLayout<DH, DV>;
  constexpr int NJK = DH / 8, NJV = DV / 8, QH = TQ / 2;  // QH: the queries of a half
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the 128-byte swizzle repeats every 1024 bytes
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t sK = base + L::K_OFF, sV = base + L::V_OFF, sQ = base + L::Q_OFF;
  const uint32_t sdO = base + L::DO_OFF, sDS = base + L::DS_OFF, sX = base + L::X_OFF;
  const uint32_t bars = base + L::BAR_OFF;
  const float* Ls = reinterpret_cast<const float*>(sm + L::L_OFF);
  const float* Ds = reinterpret_cast<const float*>(sm + L::D_OFF);
  int* last_flag = reinterpret_cast<int*>(sm + L::FLAG_OFF);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane >> 2, t4 = lane & 3;  // accumulator fragment coordinates
  const int h = blockIdx.x % hkv;
  const int* ch = chunks + (blockIdx.x / hkv) * CHUNK_FIELDS;
  const int k0 = ch[0] * TK, u0 = ch[1], total = ch[2] * group;  // iterations: (unit, group head)

  // thread 0: iteration it's Q, dO (TMA boxes) and lse, di (bulk copies) into the stage
  const CUtensorMap *map_q = &tm_q, *map_do = &tm_do;
  auto issue = [&](int it) {
    const int row = (h * group + it % group) * n + (units[u0 + it / group] >> 1);
    const uint32_t bar = bars;
    mbar_expect_tx(bar, L::STAGE_TX);
#pragma unroll
    for (int x = 0; x < DH / 64; ++x) tma_box(sQ + x * BOX_BYTES, map_q, bar, x * 64, row);
#pragma unroll
    for (int x = 0; x < DV / 64; ++x) tma_box(sdO + x * BOX_BYTES, map_do, bar, x * 64, row);
    bulk_copy(smem_u32(Ls), lse + row, TQ * 4, bar);
    bulk_copy(smem_u32(Ds), di + row, TQ * 4, bar);
  };
  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && total > 0) {
    const uint32_t bar = bars + 8;
    mbar_expect_tx(bar, L::TILE + L::TILE_V);
#pragma unroll
    for (int x = 0; x < DH / 64; ++x) tma_box(sK + x * BOX_BYTES, &tm_k, bar, x * 64, h * n + k0);
#pragma unroll
    for (int x = 0; x < DV / 64; ++x) tma_box(sV + x * BOX_BYTES, &tm_v, bar, x * 64, h * n + k0);
    issue(0);
  }

  const float scale_log2 = scale * LOG2E;
  // this thread's accumulator rows: keys kw + grp and kw + grp + 8
  const int kw = warp * 16;
  const int kpos[2] = {k0 + kw + grp, k0 + kw + grp + 8};
  const int ldk[2] = {last_desc[kpos[0]], last_desc[kpos[1]]};
  float dk_acc[NJK][4], dv_acc[NJV][4];
  zero(dk_acc);
  zero(dv_acc);
  if (total > 0) mbar_wait(bars + 8, 0);

  int ui = 0, g = 0;
  for (int it = 0; it < total; ++it) {
    const int unit = units[u0 + ui];
    const int r0 = unit >> 1;
    const bool partial = unit & 1;
    mbar_wait(bars, it & 1);

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // ---- S^T = K Q^T and dP^T = V dO^T: 64 keys x the half's 32 queries
      float s_acc[QH / 8][4], dp_acc[QH / 8][4];
      zero(s_acc);
      zero(dp_acc);
      pin(s_acc);
      pin(dp_acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wgmma_ss_n32(s_acc, desc_kmaj(sK, kk), desc_kmaj(sQ + half * QH * 128, kk), kk);
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        wgmma_ss_n32(dp_acc, desc_kmaj(sV, kk), desc_kmaj(sdO + half * QH * 128, kk), kk);
      wg_commit();
      wg_wait_all();
      pin(s_acc);
      pin(dp_acc);

      // ---- P^T and dS^T; element e of n-tile j: query half*32 + j*8 + 2*t4
      // + (e & 1), key row kw + grp + 8*(e >> 1). As bf16 A fragments and
      // dS^T to shared memory (row = key, 16-byte chunk c = half*4 + j of
      // row r at chunk c ^ (r & 7)), which dQ reads after both halves.
      uint32_t p_frag[QH / 16][4], ds_frag[QH / 16][4];
#pragma unroll
      for (int j = 0; j < QH / 8; ++j) {
        float pv[4], dsv[4];
        const int q0 = half * QH + j * 8 + 2 * t4;
        const float2 l2 = *reinterpret_cast<const float2*>(Ls + q0);
        const float2 d2 = *reinterpret_cast<const float2*>(Ds + q0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int qp = r0 + q0 + (e & 1);
          const bool keep = !partial || (kpos[r] <= qp && qp <= ldk[r]);
          const float p = keep ? ex2(s_acc[j][e] * scale_log2 - (e & 1 ? l2.y : l2.x) * LOG2E) : 0.f;
          pv[e] = p;
          dsv[e] = (dp_acc[j][e] - (e & 1 ? d2.y : d2.x)) * p * scale;
        }
        p_frag[j / 2][(j & 1) * 2] = pack_bf16(pv[0], pv[1]);
        p_frag[j / 2][(j & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
        const uint32_t d0 = pack_bf16(dsv[0], dsv[1]), d1 = pack_bf16(dsv[2], dsv[3]);
        ds_frag[j / 2][(j & 1) * 2] = d0;
        ds_frag[j / 2][(j & 1) * 2 + 1] = d1;
        const int rlo = kw + grp;  // rlo and rlo + 8 share (r & 7)
        const int off = (((half * (QH / 8) + j) ^ (rlo & 7)) << 4) + 4 * t4;
        *reinterpret_cast<uint32_t*>(sm + L::DS_OFF + rlo * 128 + off) = d0;
        *reinterpret_cast<uint32_t*>(sm + L::DS_OFF + (rlo + 8) * 128 + off) = d1;
      }

      // ---- dV += P^T dO, dK += dS^T Q over the half's rows
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < QH / 16; ++kk)
        wgmma_rs_t<DV>(dv_acc, p_frag[kk], desc_mnmaj(sdO, half * (QH / 16) + kk));
#pragma unroll
      for (int kk = 0; kk < QH / 16; ++kk)
        wgmma_rs_t<DH>(dk_acc, ds_frag[kk], desc_mnmaj(sQ, half * (QH / 16) + kk));
      wg_commit();
      wg_wait_all();
      pin(p_frag);  // the products read the fragments until here
      pin(ds_frag);
      pin(dk_acc);
      pin(dv_acc);
    }
    fence_async_smem();  // dS^T stores -> the dQ products
    __syncthreads();     // every warp's dS^T rows are in shared memory

    // ---- dQ[unit rows] = dS K in 64-column passes, pass p staged as fp32 in
    // Q's first two boxes, dO's, or the staging tile (Q and dO are spent)
#pragma unroll
    for (int pass = 0; pass < L::PASSES; ++pass) {
      float dq_acc[8][4];
      zero(dq_acc);
      pin(dq_acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
        wgmma_ss_tt_n64(dq_acc, desc_mnmaj(sDS, kk), desc_mnmaj(sK + pass * BOX_BYTES, kk), kk);
      wg_commit();
      wg_wait_all();
      pin(dq_acc);
      const uint32_t stage = pass == 0 ? sQ : pass == 1 ? sdO : sX;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t box = stage + (j / 4) * BOX_BYTES;  // columns 8j + 2*t4, +1 of the pass
        const int chunk = 2 * (j % 4) + (t4 >> 1), within = (t4 & 1) * 8;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = kw + grp + 8 * r;
          *reinterpret_cast<float2*>(sm + (box - base) + row * 128 + ((chunk ^ grp) << 4) + within) =
              make_float2(dq_acc[j][2 * r], dq_acc[j][2 * r + 1]);
        }
      }
    }
    fence_async_smem();
    __syncthreads();  // the dQ tile is staged; Q, dO, dS^T are spent
    if (tid == 0) {
      const int row = (h * group + g) * n + r0;
#pragma unroll
      for (int pass = 0; pass < L::PASSES; ++pass) {
        const uint32_t stage = pass == 0 ? sQ : pass == 1 ? sdO : sX;
#pragma unroll
        for (int b = 0; b < 2; ++b) tma_reduce_add(&tm_dq, stage + b * BOX_BYTES, pass * 64 + b * 32, row);
      }
      bulk_commit();
      // the next unit's loads land in the stage and its dQ in the staging
      // tile only once the staged dQ has left them: every thread waits for
      // that refill before it writes shared memory again
      if (it + 1 < total) {
        bulk_wait_read();
        fence_async_smem();
        issue(it + 1);
      }
    }
    if (++g == group) g = 0, ++ui;
  }
  if (tid == 0) bulk_wait();  // the dQ reductions are done before the CTA's shared memory goes

  // ---- emit dk, dv: directly, or through the split tile's fixed-order sum
  auto emit = [&]() {
#pragma unroll
    for (int j = 0; j < NJK; ++j) {
      const int d = j * 8 + 2 * t4;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<__nv_bfloat162*>(dk + (size_t(h) * n + kpos[r]) * DH + d) =
            __floats2bfloat162_rn(dk_acc[j][2 * r], dk_acc[j][2 * r + 1]);
    }
#pragma unroll
    for (int j = 0; j < NJV; ++j) {
      const int d = j * 8 + 2 * t4;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<__nv_bfloat162*>(dv + (size_t(h) * n + kpos[r]) * DV + d) =
            __floats2bfloat162_rn(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
    }
  };
  // the split fields, read after the walk through a fresh read of the block index
  uint32_t bid;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(bid));
  const int* ch_end = chunks + (bid / hkv) * CHUNK_FIELDS;
  const int pbase = ch_end[3], mypart = ch_end[4], nparts = ch_end[5], counter = ch_end[6];
  if (nparts == 1) {
    emit();
    return;
  }
  // partial p of (tile, kv head): dK then dV, each thread's registers as
  // float4s at (j * NTHREADS + tid) * 4
  constexpr size_t PART = size_t(TK) * (DH + DV);
  auto part_at = [&](int p) { return part + (size_t(pbase + p) * hkv + h) * PART; };
  float* mine = part_at(mypart);
#pragma unroll
  for (int j = 0; j < NJK; ++j)
    *reinterpret_cast<float4*>(mine + (size_t(j) * NTHREADS + tid) * 4) =
        make_float4(dk_acc[j][0], dk_acc[j][1], dk_acc[j][2], dk_acc[j][3]);
#pragma unroll
  for (int j = 0; j < NJV; ++j)
    *reinterpret_cast<float4*>(mine + TK * DH + (size_t(j) * NTHREADS + tid) * 4) =
        make_float4(dv_acc[j][0], dv_acc[j][1], dv_acc[j][2], dv_acc[j][3]);
  __threadfence();
  __syncthreads();
  if (tid == 0) *last_flag = atomicAdd(counters + counter * hkv + h, 1) == nparts - 1;
  __syncthreads();
  if (!*last_flag) return;
  __threadfence();
  zero(dk_acc);
  zero(dv_acc);
  for (int p = 0; p < nparts; ++p) {
    const float* src = part_at(p);
#pragma unroll
    for (int j = 0; j < NJK; ++j) {
      const float4 a = __ldcg(reinterpret_cast<const float4*>(src + (size_t(j) * NTHREADS + tid) * 4));
      dk_acc[j][0] += a.x, dk_acc[j][1] += a.y, dk_acc[j][2] += a.z, dk_acc[j][3] += a.w;
    }
#pragma unroll
    for (int j = 0; j < NJV; ++j) {
      const float4 b = __ldcg(reinterpret_cast<const float4*>(src + TK * DH + (size_t(j) * NTHREADS + tid) * 4));
      dv_acc[j][0] += b.x, dv_acc[j][1] += b.y, dv_acc[j][2] += b.z, dv_acc[j][3] += b.w;
    }
  }
  emit();
}

// ---------------------------------------------------------------------- launch

struct Args {
  const void *q, *k, *v, *last_desc, *chunks, *units, *dout, *lse, *di;
  void *dq32, *dk, *dv, *part, *counters;
  int n_chunks, hkv, group, n;
  float scale;
  cudaStream_t stream;
  int q_off, kv_off;
};

template <int DH, bool WITH_DQ>
int launch(const Args& a) {
  using L = Layout<DH>;
  CUtensorMap tq, tdo, tk, tv, tdq;
  const long long rows_q = (long long)a.hkv * a.group * a.n, rows_k = (long long)a.hkv * a.n;
  if (!tensor_map(&tq, a.q, rows_q, DH) || !tensor_map(&tdo, a.dout, rows_q, DH) ||
      !tensor_map(&tk, a.k, rows_k, DH) || !tensor_map(&tv, a.v, rows_k, DH) ||
      !tensor_map(&tdq, WITH_DQ ? a.dq32 : a.q, rows_q, DH, WITH_DQ))  // K12: an unused map
    return int(cudaErrorInvalidValue);
  auto kernel = tree_attn_bwd_kmajor_kernel<DH, WITH_DQ>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return int(err);
  if (a.n_chunks == 0) return 0;
  kernel<<<a.n_chunks * a.hkv, NTHREADS, L::BYTES, a.stream>>>(
      tq, tdo, tk, tv, tdq, static_cast<const float*>(a.lse), static_cast<const float*>(a.di),
      static_cast<const int*>(a.last_desc), static_cast<const int*>(a.chunks),
      static_cast<const int*>(a.units), static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      static_cast<float*>(a.part), static_cast<int*>(a.counters), a.hkv, a.group, a.n, a.scale, a.q_off,
      a.kv_off);
  return int(cudaGetLastError());
}

// K3 / K10 at MLA's widths (q, k DH wide; v, do DV wide), group 1, offset 0
template <int DH, int DV>
int launch_mla(const Args& a) {
  using L = MlaLayout<DH, DV>;
  CUtensorMap tq, tdo, tk, tv, tdq;
  const long long rows_q = (long long)a.hkv * a.group * a.n, rows_k = (long long)a.hkv * a.n;
  if (!tensor_map(&tq, a.q, rows_q, DH) || !tensor_map(&tdo, a.dout, rows_q, DV) ||
      !tensor_map(&tk, a.k, rows_k, DH) || !tensor_map(&tv, a.v, rows_k, DV) ||
      !tensor_map(&tdq, a.dq32, rows_q, DH, true))
    return int(cudaErrorInvalidValue);
  auto kernel = tree_attn_bwd_kmajor_mla_kernel<DH, DV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return int(err);
  if (a.n_chunks == 0) return 0;
  kernel<<<a.n_chunks * a.hkv, NTHREADS, L::BYTES, a.stream>>>(
      tq, tdo, tk, tv, tdq, static_cast<const float*>(a.lse), static_cast<const float*>(a.di),
      static_cast<const int*>(a.last_desc), static_cast<const int*>(a.chunks),
      static_cast<const int*>(a.units), static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      static_cast<float*>(a.part), static_cast<int*>(a.counters), a.hkv, a.group, a.n, a.scale);
  return int(cudaGetLastError());
}

// Requires n % 64 == 0, dh in {64, 128} with dv = dh, group >= 1 (the Python
// wrapper takes 1..8), or (dh, dv) = (192, 128) with dq (K3, K10) at group
// 1 and offset 0, contiguous 16-byte aligned tensors and a work list whose
// chunks cover each key tile of the n / 64 once per part; the Python wrapper
// checks the tensors. dq32 is written only WITH_DQ (K3, K10).
template <bool WITH_DQ>
int dispatch(const Args& a, int dh, int dv) {
  if (a.group < 1 || a.hkv < 1) return int(cudaErrorInvalidValue);
  if (dv != dh) {
    if (WITH_DQ && dh == 192 && dv == 128 && a.group == 1 && a.q_off == 0 && a.kv_off == 0)
      return launch_mla<192, 128>(a);
    return int(cudaErrorInvalidValue);
  }
  if (dh == 128) return launch<128, WITH_DQ>(a);
  if (dh == 64) return launch<64, WITH_DQ>(a);
  return int(cudaErrorInvalidValue);
}

}  // namespace kmajor

// K12: dk, dv like k, from the key-major work list (chunks [n_chunks, 8] and
// units, tries.build_kmajor_work); dv_width must be dh (MLA's widths are
// refused); part (fp32, 2 * 64 * dh per split chunk and kv head) and counters
// (int32, one per split tile and kv head, zeroed) are the caller's scratch
// for the split tiles' fixed-order sums. q_off, kv_off: a ring pair's global
// offsets (0 on one device), last_desc then the whole
// table and the work list the pair's (tries.build_kmajor_work at offsets).
extern "C" int tree_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* last_desc, const void* chunks, const void* units,
                                 const void* dout, const void* lse, const void* di, void* dk,
                                 void* dv, void* part, void* counters, int n_chunks, int hkv,
                                 int group, int n, int dh, int dv_width, int q_off, int kv_off, float scale,
                                 void* stream) {
  if (q_off < 0 || kv_off < 0) return int(cudaErrorInvalidValue);
  const kmajor::Args a{q, k, v, last_desc, chunks, units, dout, lse, di,
                       nullptr, dk, dv, part, counters,
                       n_chunks, hkv, group, n, scale, static_cast<cudaStream_t>(stream), q_off, kv_off};
  return kmajor::dispatch<false>(a, dh, dv_width);
}

// K3: dq, dk, dv from the key-major work list (see tree_attn_bwd_dkv for
// chunks, units, part and counters; part holds 64 * (dh + dv) fp32 per split
// chunk and kv head); adds into dq32, fp32 [hkv, group, n, dh], zeroed by
// the caller; writes dk and dv. dv_width: v's and do's (dh but for MLA's
// (192, 128)).
extern "C" int tree_attn_bwd_cached(const void* q, const void* k, const void* v,
                                    const void* last_desc, const void* chunks, const void* units,
                                    const void* dout, const void* lse, const void* di, void* dq32,
                                    void* dk, void* dv, void* part, void* counters, int n_chunks,
                                    int hkv, int group, int n, int dh, int dv_width, float scale,
                                    void* stream) {
  const kmajor::Args a{q, k, v, last_desc, chunks, units, dout, lse, di,
                       dq32, dk, dv, part, counters,
                       n_chunks, hkv, group, n, scale, static_cast<cudaStream_t>(stream), 0, 0};
  return kmajor::dispatch<true>(a, dh, dv_width);
}

// K10: dq, dk, dv of the one-pass backward ("fused"): the walk of K3, with
// no slot schedule (see tree_attn_bwd_cached for the arguments).
extern "C" int tree_attn_bwd_fused(const void* q, const void* k, const void* v,
                                   const void* last_desc, const void* chunks, const void* units,
                                   const void* dout, const void* lse, const void* di, void* dq32,
                                   void* dk, void* dv, void* part, void* counters, int n_chunks,
                                   int hkv, int group, int n, int dh, int dv_width, float scale,
                                   void* stream) {
  return tree_attn_bwd_cached(q, k, v, last_desc, chunks, units, dout, lse, di, dq32, dk, dv, part,
                              counters, n_chunks, hkv, group, n, dh, dv_width, scale, stream);
}
