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
// Design. A "group" of dh/8 consecutive lanes handles one (row, head) pair:
// each lane loads 16 bytes (8 bf16) of the head's slice and 8 fp32 of cos and
// sin. The sum of squares over dh is reduced with __shfl_xor inside the group;
// the rotate-half partner of element d (d +- dh/2) lives dh/16 lanes away
// and comes with one more xor shuffle per value. The groups of a CTA take
// consecutive (row, head) pairs, so the loads of x are contiguous across the
// CTA, and every lane stores 16 bytes of the [H, n, dh] output.
//
// The TPU backward sums the norm-weight grad over its sequential grid in a
// resident output block. CTAs run in no order here, so dw is reduced
// deterministically in two passes: each CTA of the backward sums its groups'
// fp32 [dh] partials in shared memory and writes one row of a scratch
// [CTAs, dh]; a second launch of one CTA sums the rows in a fixed order.
//
// What bounds it on the card: bytes. A few flops per byte moved; at n=6656,
// 16 q heads, dh=128 the q forward moves ~61 MB (~18 us at 3.35 TB/s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NTHREADS = 256;
constexpr int BWD_ITERS = 4;  // (row, head) pairs per group in the backward
constexpr int REDUCE_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

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
// LANES-lane slices of the warp; every lane of the warp must take part)
template <int LANES>
__device__ __forceinline__ float group_sum(float s) {
#pragma unroll
  for (int off = LANES / 2; off >= 1; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
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

// K6 (WITH_V = false) and K7 (WITH_V = true). g, gv [H, n, DH]; x [n, H*DH]
// (read only when NORM) -> dx, dv [n, H*DH]; with NORM, dw_part [gridDim.x, DH]
// fp32: this CTA's sum of g' * u.
template <int DH, bool NORM, bool WITH_V>
__global__ void __launch_bounds__(NTHREADS)
qk_prep_bwd_kernel(const bf16* __restrict__ g, const bf16* __restrict__ gv,
                   const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                   bf16* __restrict__ dx, bf16* __restrict__ dv,
                   float* __restrict__ dw_part, int n, int H, float eps) {
  constexpr int LANES = DH / 8;
  constexpr int GROUPS = NTHREADS / LANES;
  __shared__ float red[NORM ? GROUPS : 1][NORM ? DH : 1];
  const int lane = threadIdx.x % LANES, group = threadIdx.x / LANES;
  const int d0 = lane * 8;
  const float sgn = lane < LANES / 2 ? -1.f : 1.f;
  float wf[8], acc[8];
  if constexpr (NORM) load8(w + d0, wf);
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;

#pragma unroll
  for (int t = 0; t < BWD_ITERS; ++t) {
    const long long item = ((long long)blockIdx.x * BWD_ITERS + t) * GROUPS + group;
    const bool ok = item < (long long)n * H;
    const long long it = ok ? item : 0;
    const int row = int(it / H), head = int(it % H);
    const size_t x_at = (size_t(row) * H + head) * DH + d0;
    const size_t g_at = (size_t(head) * n + row) * DH + d0;

    float gg[8], c[8], s[8], gp[8];
    load8(g + g_at, gg);
    load8f(cos_t + size_t(row) * DH + d0, c);
    load8f(sin_t + size_t(row) * DH + d0, s);
    // RoPE^T: g' = g * cos - rot(g) * sin (rot is antisymmetric)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float p = __shfl_xor_sync(FULL, gg[i], LANES / 2);
      gp[i] = gg[i] * c[i] - sgn * p * s[i];
    }
    if constexpr (NORM) {
      float u[8];
      load8(x + x_at, u);
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) ss += u[i] * u[i];
      const float r = rsqrtf(group_sum<LANES>(ss) / DH + eps);
      float du[8], dot = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        u[i] *= r;
        if (ok) acc[i] += gp[i] * u[i];
        du[i] = gp[i] * wf[i];
        dot += du[i] * u[i];
      }
      const float m = group_sum<LANES>(dot) / DH;
#pragma unroll
      for (int i = 0; i < 8; ++i) gp[i] = r * (du[i] - u[i] * m);
    }
    if (ok) {
      store8(dx + x_at, gp);
      if constexpr (WITH_V) copy16(dv + x_at, gv + g_at);
    }
  }

  if constexpr (NORM) {
#pragma unroll
    for (int i = 0; i < 8; ++i) red[group][d0 + i] = acc[i];
    __syncthreads();
    for (int d = threadIdx.x; d < DH; d += NTHREADS) {
      float sum = 0.f;
      for (int gi = 0; gi < GROUPS; ++gi) sum += red[gi][d];
      dw_part[size_t(blockIdx.x) * DH + d] = sum;
    }
  }
}

// dw[d] = sum over the rows of dw_part [nparts, DH], in a fixed order
template <int DH>
__global__ void __launch_bounds__(REDUCE_THREADS)
qk_prep_dw_reduce(const float* __restrict__ dw_part, int nparts, float* __restrict__ dw) {
  constexpr int SLICES = REDUCE_THREADS / DH;
  __shared__ float red[SLICES][DH];
  const int d = threadIdx.x % DH, sl = threadIdx.x / DH;
  float s = 0.f;
  for (int p = sl; p < nparts; p += SLICES) s += dw_part[size_t(p) * DH + d];
  red[sl][d] = s;
  __syncthreads();
  if (sl == 0) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < SLICES; ++k) t += red[k][d];
    dw[d] = t;
  }
}

template <int DH>
int bwd_ctas(int n, int H) {
  constexpr int per_cta = BWD_ITERS * (NTHREADS / (DH / 8));
  return int(((long long)n * H + per_cta - 1) / per_cta);
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

template <int DH, bool NORM>
int launch_bwd(const void* g, const void* gv, const void* x, const void* w,
               const void* cos_t, const void* sin_t, void* dx, void* dv, void* dw_part,
               void* dw, int n, int H, float eps, cudaStream_t st) {
  const int blocks = bwd_ctas<DH>(n, H);
  const bf16* gb = static_cast<const bf16*>(g);
  const bf16* gvb = static_cast<const bf16*>(gv);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  const float* cb = static_cast<const float*>(cos_t);
  const float* sb = static_cast<const float*>(sin_t);
  float* part = static_cast<float*>(dw_part);
  if (gv != nullptr)
    qk_prep_bwd_kernel<DH, NORM, true><<<blocks, NTHREADS, 0, st>>>(
        gb, gvb, xb, wb, cb, sb, static_cast<bf16*>(dx), static_cast<bf16*>(dv), part, n, H,
        eps);
  else
    qk_prep_bwd_kernel<DH, NORM, false><<<blocks, NTHREADS, 0, st>>>(
        gb, gvb, xb, wb, cb, sb, static_cast<bf16*>(dx), nullptr, part, n, H, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !NORM) return int(err);
  qk_prep_dw_reduce<DH><<<1, REDUCE_THREADS, 0, st>>>(part, blocks, static_cast<float*>(dw));
  return int(cudaGetLastError());
}

}  // namespace

// Rows of the backward's dw scratch (its CTA count) for these shapes.
extern "C" int qk_prep_bwd_parts(int n, int H, int dh) {
  return dh == 128 ? bwd_ctas<128>(n, H) : dh == 64 ? bwd_ctas<64>(n, H) : -1;
}

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

// K6 (gv == NULL, dv unused) or K7. With use_norm, dw_part is fp32 scratch of
// qk_prep_bwd_parts(n, H, dh) x dh and dw fp32 [dh]; without, x, w, dw_part
// and dw are not read or written.
extern "C" int qk_prep_bwd(const void* g, const void* gv, const void* x, const void* w,
                           const void* cos_t, const void* sin_t, void* dx, void* dv,
                           void* dw_part, void* dw, int n, int H, int dh, int use_norm,
                           float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh == 128)
    return use_norm
               ? launch_bwd<128, true>(g, gv, x, w, cos_t, sin_t, dx, dv, dw_part, dw, n, H, eps, st)
               : launch_bwd<128, false>(g, gv, x, w, cos_t, sin_t, dx, dv, dw_part, dw, n, H, eps, st);
  if (dh == 64)
    return use_norm
               ? launch_bwd<64, true>(g, gv, x, w, cos_t, sin_t, dx, dv, dw_part, dw, n, H, eps, st)
               : launch_bwd<64, false>(g, gv, x, w, cos_t, sin_t, dx, dv, dw_part, dw, n, H, eps, st);
  return int(cudaErrorInvalidValue);
}
