// Fused q/k/v attention-input prep for Hopper (sm_90a): per-head RMSNorm * w,
// RoPE (HF rotate-half) and the head-major transpose, forward and backward.
//
// Replaces the Pallas TPU kernels of dynamictreeattn_tpu/ops/qk_prep.py:
//   K4 _fwd_kernel     q [n, H*dh] -> fp32 RMSNorm_head * w -> RoPE -> [H, n, dh]
//   K5 _kv_fwd_kernel  the same for k; v is transposed only
//   K6 _bwd_kernel     g [H, n, dh] -> RoPE^T -> RMSNorm vjp
//                      dx = r * (du - u * mean(du * u)), du = g' * w -> [n, H*dh];
//                      dw = sum over rows and heads of g' * u
//   K7 _kv_bwd_kernel  the same for k, plus dv = g_v transposed back
// with u = x * rsqrt(mean(x^2) + eps) over one head's dh values and
// RoPE(u) = u * cos + rot(u) * sin, rot([a, b]) = [-b, a]. Values stay fp32
// from the bf16 load to the one rounding at the store: the normed u is
// never rounded, as in the TPU kernels.
//
// Forward. A "group" of dh/8 consecutive lanes handles one (row, head)
// pair: each lane loads 16 bytes (8 bf16) of the head's slice and 8 fp32 of
// cos and sin. The sum of squares over dh is reduced with __shfl_xor inside
// the group; the rotate-half partner of element d (d +- dh/2) lives dh/16
// lanes away and comes with one more xor shuffle per value. The groups of a
// CTA take consecutive (row, head) pairs, so the loads of x are contiguous
// across the CTA, and every lane stores 16 bytes of the [H, n, dh] output.
//
// Backward: one persistent launch. The rows are cut into tiles of `rows`
// rows x all H heads (the TPU kernel's row block); CTA c of the grid takes
// tiles c, c + grid, ... (ops/qk_prep.py qk_bwd_plan gives rows and grid,
// and the CPU tests replay the same walk). Warp 0 keeps a ring of shared-
// memory stages full, one mbarrier a stage, with a few copies a tile: the
// tile's H slabs of g (and gv) [rows, dh] as one 3-D box of a tensor map
// [H, n, dh], and its slice of x [rows, H*dh] and its rows of cos and sin,
// each contiguous, as 1-D bulk copies (a bulk copy per head slab slowed
// the layouts with few heads on an H100: each copy is a TMA request). So the
// next tiles' bytes are in flight while this one is computed, a row's
// cos/sin are read from device memory once for all its heads, and no index
// is divided per item. A group keeps one row of the tile and walks its
// heads; the rotate-half partner is read from shared memory. dx (and dv)
// leave as 16-byte stores.
//
// The TPU backward sums the norm-weight grad over its sequential grid in a
// resident output block. Here each CTA sums its fp32 [dh] partial over its
// tiles in walk order (its groups' partials in group order) into one row of
// a scratch, fences, and draws a ticket of its group of DW_GROUP CTAs; the
// group's last CTA sums the group's rows in CTA order into a group row and
// draws a ticket of the groups; the last group's CTA sums the group rows in
// order into dw. Every ticket is an atomicInc that wraps its counter back
// to 0 at the last draw, so the launcher's counters need no reset between
// calls. dw repeats bit-equal from run to run, in one launch; two short
// sums replace one CTA reading every row, which was the launch's serial
// tail.
//
// What bounds it on the card: bytes. A few flops per byte moved; at n=6656,
// 16 q heads, dh=128 the q backward moves ~88 MB (~26 us at 3.35 TB/s).
// On an H100 the same walk without the arithmetic took nearly the whole
// kernel's time: the data path (the transposing read of g through the
// ring), not the math, stands between it and its bound.

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int NTHREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
// the backward: CTAs an SM (the plan's grid is this many times the SM
// count), its ring's bytes and most stages
constexpr int BWD_CTAS_PER_SM = 2;
constexpr int BWD_RING_BYTES = 100 * 1024;
constexpr int BWD_MAX_STAGES = 8;
// the dw sum: CTAs in groups of DW_GROUP by index; the last of a group to
// finish sums the group's rows, the last group the group sums
constexpr int DW_GROUP = 16;

__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h2[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float (&f)[8]) {
  uint4 raw;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void load8f(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

__device__ __forceinline__ void copy16(bf16* dst, const bf16* src) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

// sum over the LANES lanes of this thread's group (groups are aligned
// LANES-lane slices of the warp; every lane of `mask` must take part)
template <int LANES>
__device__ __forceinline__ float group_sum(float s, unsigned mask = FULL) {
#pragma unroll
  for (int off = LANES / 2; off >= 1; off >>= 1) s += __shfl_xor_sync(mask, s, off);
  return s;
}

// K4 (WITH_V = false) and K5 (WITH_V = true). x, v [n, H*DH]; w [DH];
// cos, sin [n, DH] fp32 -> xo, vo [H, n, DH].
template <int DH, bool NORM, bool WITH_V>
__global__ void __launch_bounds__(NTHREADS)
qk_prep_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ v,
                   const bf16* __restrict__ w, const float* __restrict__ cos_t,
                   const float* __restrict__ sin_t, bf16* __restrict__ xo,
                   bf16* __restrict__ vo, int n, int H, float eps) {
  constexpr int LANES = DH / 8;
  constexpr int GROUPS = NTHREADS / LANES;
  const int lane = threadIdx.x % LANES;
  const int d0 = lane * 8;
  const long long item = (long long)blockIdx.x * GROUPS + threadIdx.x / LANES;
  const bool ok = item < (long long)n * H;
  const long long it = ok ? item : 0;  // out-of-range lanes load pair 0 and store nothing
  const int row = int(it / H), head = int(it % H);
  const size_t in_at = (size_t(row) * H + head) * DH + d0;
  const size_t out_at = (size_t(head) * n + row) * DH + d0;

  float u[8], c[8], s[8];
  load8(x + in_at, u);
  load8f(cos_t + size_t(row) * DH + d0, c);
  load8f(sin_t + size_t(row) * DH + d0, s);
  if constexpr (NORM) {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) ss += u[i] * u[i];
    const float r = rsqrtf(group_sum<LANES>(ss) / DH + eps);
    float wf[8];
    load8(w + d0, wf);
#pragma unroll
    for (int i = 0; i < 8; ++i) u[i] = u[i] * r * wf[i];
  }
  // rot(u)[d] = -u[d + DH/2] in the first half, u[d - DH/2] in the second
  const float sgn = lane < LANES / 2 ? -1.f : 1.f;
  float o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float p = __shfl_xor_sync(FULL, u[i], LANES / 2);
    o[i] = u[i] * c[i] + sgn * p * s[i];
  }
  if (ok) {
    store8(xo + out_at, o);
    if constexpr (WITH_V) copy16(vo + out_at, v + in_at);
  }
}

// Bytes of one backward ring stage: `rows` rows of the H slabs of g (and
// gv), of x (with the norm), and of cos and sin.
template <int DH, bool NORM, bool WITH_V>
__host__ __device__ constexpr int bwd_stage_bytes(int H, int rows) {
  return rows * (H * DH * 2 * (1 + int(NORM) + int(WITH_V)) + 2 * DH * 4);
}

// After this CTA's writes: fence, draw a ticket of `count` from *counter
// (atomicInc wraps it back to 0 at the last draw) and tell every thread
// whether it was the last; the last CTA then sees every writer's rows.
__device__ __forceinline__ bool last_ticket(unsigned* counter, int count, int& flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) flag = atomicInc(counter, unsigned(count - 1)) == unsigned(count - 1);
  __syncthreads();
  const bool last = flag;
  if (last) __threadfence();
  return last;
}

// column d of the sum, in row order, of `count` rows of a [*, DH] fp32
// array written by other CTAs (read past L1), 16 loads in flight at a time
template <int DH>
__device__ __forceinline__ float sum_rows(const float* rows, int count, int d) {
  constexpr int BATCH = 16;
  float s = 0.f;
  for (int c0 = 0; c0 < count; c0 += BATCH) {
    float v[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) v[b] = c0 + b < count ? __ldcg(rows + size_t(c0 + b) * DH + d) : 0.f;
#pragma unroll
    for (int b = 0; b < BATCH; ++b) s += v[b];
  }
  return s;
}

// the box of `rows` rows x all H heads of a [H, n, DH] bf16 tensor at row r0
// (rows past n are zero-filled and counted as landed)
__device__ __forceinline__ void tma_slabs(uint32_t dst, const CUtensorMap* map, uint32_t bar, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(r0), "r"(0)
      : "memory");
}

// g [H, n, dh] bf16 read in boxes of `rows` rows x all H heads, laid out in
// shared memory as [H][rows][dh] (no swizzle)
inline bool slabs_map(CUtensorMap* map, const void* ptr, int H, int n, int dh, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(dh), cuuint64_t(n), cuuint64_t(H)};
  const cuuint64_t strides[2] = {cuuint64_t(dh) * 2, cuuint64_t(n) * dh * 2};
  const cuuint32_t box[3] = {cuuint32_t(dh), cuuint32_t(rows), cuuint32_t(H)};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// K6 (WITH_V = false) and K7 (WITH_V = true). g, gv [H, n, DH] (read
// through tm_g, tm_gv: boxes of `rows` rows x H heads); x [n, H*DH]
// (read only when NORM) -> dx, dv [n, H*DH]; with NORM, dw [DH] fp32 through
// dw_part [gridDim.x, DH] and the ticket counter (0 between launches).
// Tiles of `rows` rows (rows divides the CTA's groups); `stages` ring stages
// of bwd_stage_bytes each in dynamic shared memory.
template <int DH, bool NORM, bool WITH_V>
__global__ void __launch_bounds__(NTHREADS, BWD_CTAS_PER_SM)
qk_prep_bwd_kernel(const __grid_constant__ CUtensorMap tm_g, const __grid_constant__ CUtensorMap tm_gv,
                   const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                   bf16* __restrict__ dx, bf16* __restrict__ dv, float* __restrict__ dw_part,
                   float* __restrict__ dw, unsigned* __restrict__ counter, int n, int H, int rows,
                   int stages, float eps) {
  constexpr int LANES = DH / 8;
  constexpr int GROUPS = NTHREADS / LANES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring_u32 = (smem_u32(smem_raw) + 127) & ~127u;  // a TMA box lands 128-byte aligned
  const unsigned char* ring = smem_raw + (ring_u32 - smem_u32(smem_raw));
  __shared__ __align__(8) uint64_t full[BWD_MAX_STAGES];
  __shared__ int last;

  const int tid = threadIdx.x, warp = tid / 32, lane32 = tid % 32;
  const int lane = tid % LANES, gi = tid / LANES, d0 = lane * 8;
  const unsigned mask = ((1u << LANES) - 1) << (lane32 / LANES * LANES);  // this group's lanes
  // group gi keeps row r of every tile and takes heads j, j + gpr, ...
  const int gpr = GROUPS / rows, r = gi / gpr, j = gi % gpr;
  const float sgn = lane < LANES / 2 ? -1.f : 1.f;
  const int grid = gridDim.x, n_tiles = (n + rows - 1) / rows;
  const int mine = int(blockIdx.x) < n_tiles ? (n_tiles - 1 - int(blockIdx.x)) / grid + 1 : 0;
  // a stage: g [H][rows][DH] bf16, gv (WITH_V) likewise, x [rows][H*DH] bf16
  // (NORM), cos [rows][DH] fp32, sin likewise
  const int slab = rows * DH;
  const int stage_bytes = bwd_stage_bytes<DH, NORM, WITH_V>(H, rows);
  const int off_gv = H * slab * 2;
  const int off_x = off_gv + (WITH_V ? H * slab * 2 : 0);
  const int off_cos = off_x + (NORM ? H * slab * 2 : 0);
  const int off_sin = off_cos + slab * 4;

  // warp 0: the k-th tile of this CTA into stage k % stages; the boxes of
  // g (and gv) land whole (rows past n zero-filled), the rest for nr rows
  auto issue = [&](int k) {
    const int r0 = (int(blockIdx.x) + k * grid) * rows, nr = min(rows, n - r0);
    const uint32_t bar = smem_u32(&full[k % stages]);
    const uint32_t base = ring_u32 + uint32_t(k % stages) * stage_bytes;
    if (lane32 == 0)
      mbar_expect_tx(bar, uint32_t(H * slab * 2 * (1 + int(WITH_V)) + nr * (int(NORM) * H * DH * 2 + 8 * DH)));
    __syncwarp();
    if (lane32 == 0) tma_slabs(base, &tm_g, bar, r0);
    if (WITH_V && lane32 == 1) tma_slabs(base + off_gv, &tm_gv, bar, r0);
    if (lane32 == 2) bulk_copy(base + off_cos, cos_t + size_t(r0) * DH, uint32_t(nr) * DH * 4, bar);
    if (lane32 == 3) bulk_copy(base + off_sin, sin_t + size_t(r0) * DH, uint32_t(nr) * DH * 4, bar);
    if (NORM && lane32 == 4) bulk_copy(base + off_x, x + size_t(r0) * H * DH, uint32_t(nr) * H * DH * 2, bar);
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0)
    for (int k = 0; k < min(stages, mine); ++k) issue(k);

  float wf[8], acc[8];
  if constexpr (NORM) load8(w + d0, wf);
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;

  for (int k = 0; k < mine; ++k) {
    const int s = k % stages;
    mbar_wait(smem_u32(&full[s]), uint32_t(k / stages) & 1u);
    const int r0 = (int(blockIdx.x) + k * grid) * rows;
    if (r < min(rows, n - r0)) {  // uniform over the group
      const unsigned char* st = ring + size_t(s) * stage_bytes;
      const bf16* gs = reinterpret_cast<const bf16*>(st) + r * DH;
      float c[8], sn[8];
      load8f(reinterpret_cast<const float*>(st + off_cos) + r * DH + d0, c);
      load8f(reinterpret_cast<const float*>(st + off_sin) + r * DH + d0, sn);
      for (int h = j; h < H; h += gpr) {
        // RoPE^T: g' = g * cos - rot(g) * sin (rot is antisymmetric); the
        // partner of element d is d ^ (DH/2)
        float gg[8], p[8], gp[8];
        load8(gs + h * slab + d0, gg);
        load8(gs + h * slab + (d0 ^ (DH / 2)), p);
#pragma unroll
        for (int i = 0; i < 8; ++i) gp[i] = gg[i] * c[i] - sgn * p[i] * sn[i];
        if constexpr (NORM) {
          float u[8];
          load8(reinterpret_cast<const bf16*>(st + off_x) + (r * H + h) * DH + d0, u);
          float ss = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) ss += u[i] * u[i];
          const float rr = rsqrtf(group_sum<LANES>(ss, mask) / DH + eps);
          float du[8], dot = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            u[i] *= rr;
            acc[i] += gp[i] * u[i];
            du[i] = gp[i] * wf[i];
            dot += du[i] * u[i];
          }
          const float m = group_sum<LANES>(dot, mask) / DH;
#pragma unroll
          for (int i = 0; i < 8; ++i) gp[i] = rr * (du[i] - u[i] * m);
        }
        const size_t at = (size_t(r0 + r) * H + h) * DH + d0;
        store8(dx + at, gp);
        if constexpr (WITH_V)
          copy16(dv + at, reinterpret_cast<const bf16*>(st + off_gv) + h * slab + r * DH + d0);
      }
    }
    __syncthreads();  // stage s read by every thread: refill it
    if (warp == 0 && k + stages < mine) issue(k + stages);
  }

  if constexpr (NORM) {
    // the groups' partials, over the ring: every stage has been read
    float(*red)[DH] = reinterpret_cast<float(*)[DH]>(smem_raw + (ring_u32 - smem_u32(smem_raw)));
    *reinterpret_cast<float4*>(&red[gi][d0]) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float4*>(&red[gi][d0 + 4]) = make_float4(acc[4], acc[5], acc[6], acc[7]);
    __syncthreads();
    if (tid < DH) {  // this CTA's partial: its groups' in order
      float sum = 0.f;
      for (int q = 0; q < GROUPS; ++q) sum += red[q][tid];
      dw_part[size_t(blockIdx.x) * DH + tid] = sum;
    }
    // the group's last CTA sums its rows, then the last group the group sums
    const int grp = blockIdx.x / DW_GROUP, n_grp = (grid + DW_GROUP - 1) / DW_GROUP;
    const int in_grp = min(DW_GROUP, grid - grp * DW_GROUP);
    if (!last_ticket(counter + 1 + grp, in_grp, last)) return;
    float* gsum = dw_part + size_t(grid) * DH;  // [n_grp, DH] after the CTAs' rows
    if (tid < DH) gsum[size_t(grp) * DH + tid] = sum_rows<DH>(dw_part + size_t(grp) * DW_GROUP * DH, in_grp, tid);
    if (!last_ticket(counter, n_grp, last)) return;
    if (tid < DH) dw[tid] = sum_rows<DH>(gsum, n_grp, tid);
  }
}

template <int DH, bool NORM>
int launch_fwd(const void* x, const void* v, const void* w, const void* cos_t,
               const void* sin_t, void* xo, void* vo, int n, int H, float eps,
               cudaStream_t st) {
  constexpr int GROUPS = NTHREADS / (DH / 8);
  const long long blocks = ((long long)n * H + GROUPS - 1) / GROUPS;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* wb = static_cast<const bf16*>(w);
  const float* cb = static_cast<const float*>(cos_t);
  const float* sb = static_cast<const float*>(sin_t);
  if (v != nullptr)
    qk_prep_fwd_kernel<DH, NORM, true><<<unsigned(blocks), NTHREADS, 0, st>>>(
        xb, vb, wb, cb, sb, static_cast<bf16*>(xo), static_cast<bf16*>(vo), n, H, eps);
  else
    qk_prep_fwd_kernel<DH, NORM, false><<<unsigned(blocks), NTHREADS, 0, st>>>(
        xb, vb, wb, cb, sb, static_cast<bf16*>(xo), nullptr, n, H, eps);
  return int(cudaGetLastError());
}

struct BwdArgs {
  const void *g, *gv, *x, *w, *cos_t, *sin_t;
  void *dx, *dv, *dw_part, *dw, *counter;
  int n, H, rows, grid;
  float eps;
  cudaStream_t st;
};

template <int DH, bool NORM, bool WITH_V>
int launch_bwd(const BwdArgs& a) {
  constexpr int GROUPS = NTHREADS / (DH / 8);
  if (a.n < 1 || a.H < 1 || a.H > 256 || a.grid < 1 || a.rows < 1 || a.rows > GROUPS || GROUPS % a.rows)
    return int(cudaErrorInvalidValue);
  const long long stage = bwd_stage_bytes<DH, NORM, WITH_V>(a.H, a.rows);
  const int stages = int(stage * BWD_MAX_STAGES <= BWD_RING_BYTES ? BWD_MAX_STAGES : BWD_RING_BYTES / stage);
  if (stages < 2) return int(cudaErrorInvalidValue);
  CUtensorMap tm_g, tm_gv;
  if (!slabs_map(&tm_g, a.g, a.H, a.n, DH, a.rows) ||
      !slabs_map(&tm_gv, WITH_V ? a.gv : a.g, a.H, a.n, DH, a.rows))  // K6: an unused map
    return int(cudaErrorInvalidValue);
  auto kernel = qk_prep_bwd_kernel<DH, NORM, WITH_V>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_RING_BYTES + 128);
  if (err != cudaSuccess) return int(err);
  // the ring, or with the norm at least the groups' dw partials that reuse it
  const size_t bytes = std::max<size_t>(stages * stage, NORM ? GROUPS * DH * 4 : 0) + 128;
  kernel<<<a.grid, NTHREADS, bytes, a.st>>>(
      tm_g, tm_gv, static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.w),
      static_cast<const float*>(a.cos_t), static_cast<const float*>(a.sin_t), static_cast<bf16*>(a.dx),
      static_cast<bf16*>(a.dv), static_cast<float*>(a.dw_part), static_cast<float*>(a.dw),
      static_cast<unsigned*>(a.counter), a.n, a.H, a.rows, stages, a.eps);
  return int(cudaGetLastError());
}

template <int DH>
int dispatch_bwd(const BwdArgs& a, bool norm) {
  if (a.gv != nullptr)
    return norm ? launch_bwd<DH, true, true>(a) : launch_bwd<DH, false, true>(a);
  return norm ? launch_bwd<DH, true, false>(a) : launch_bwd<DH, false, false>(a);
}

}  // namespace

// K4 (v == NULL, vo unused) or K5. All tensors contiguous and 16-byte
// aligned; x, v, w, xo, vo bf16, cos/sin fp32; dh 64 or 128 (the Python
// wrapper checks these). Returns a cudaError_t code.
extern "C" int qk_prep_fwd(const void* x, const void* v, const void* w, const void* cos_t,
                           const void* sin_t, void* xo, void* vo, int n, int H, int dh,
                           int use_norm, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh == 128)
    return use_norm ? launch_fwd<128, true>(x, v, w, cos_t, sin_t, xo, vo, n, H, eps, st)
                    : launch_fwd<128, false>(x, v, w, cos_t, sin_t, xo, vo, n, H, eps, st);
  if (dh == 64)
    return use_norm ? launch_fwd<64, true>(x, v, w, cos_t, sin_t, xo, vo, n, H, eps, st)
                    : launch_fwd<64, false>(x, v, w, cos_t, sin_t, xo, vo, n, H, eps, st);
  return int(cudaErrorInvalidValue);
}

// K6 (gv == NULL, dv unused) or K7: one launch of `grid` CTAs over tiles of
// `rows` rows (ops/qk_prep.py qk_bwd_plan). With use_norm, dw_part is fp32
// scratch [grid + ceil(grid / 16), dh], dw fp32 [dh] and counter
// 1 + ceil(grid / 16) unsigned ints that are 0 (and are 0 again when the
// launch ends); without, x, w, dw_part, dw and counter are not read or
// written. Refuses (cudaErrorInvalidValue) a tile that does not divide the
// CTA's groups or whose ring would hold fewer than two stages.
extern "C" int qk_prep_bwd(const void* g, const void* gv, const void* x, const void* w,
                           const void* cos_t, const void* sin_t, void* dx, void* dv,
                           void* dw_part, void* dw, void* counter, int n, int H, int dh,
                           int use_norm, int rows, int grid, float eps, void* stream) {
  const BwdArgs a{g, gv, x, w, cos_t, sin_t, dx, dv, dw_part, dw, counter,
                  n, H, rows, grid, eps, static_cast<cudaStream_t>(stream)};
  if (dh == 128) return dispatch_bwd<128>(a, use_norm != 0);
  if (dh == 64) return dispatch_bwd<64>(a, use_norm != 0);
  return int(cudaErrorInvalidValue);
}
