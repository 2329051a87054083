// The model step's elementwise chain for Hopper (sm_90a): RMSNorm and SwiGLU,
// forward and backward.
//
// Replaces no Pallas kernel. The JAX model writes rms_norm and
// silu(gate) * up as plain jnp (dynamictreeattn_tpu/models/qwen3.py
// rms_norm, _layer), which XLA fuses into one pass each on the TPU. Run as
// eager PyTorch ops (ops/fused_norm_act.py rms_norm_plain, swiglu_plain) the
// norm is about eight passes over memory in fp32 (a cast up, a square, a
// mean, an add and rsqrt, two broadcast multiplies, a cast down) and the
// SwiGLU four; autograd takes each apart again in the backward, in fp32.
//
// What bounds them on the card: bytes. At a few operations a byte they sit
// far below the card's ridge (about 295 bf16 operations a byte), so each
// kernel reads every input once and writes every output once:
//   N1 rmsnorm_fwd_kernel: x in, y and rstd (one fp32 a row) out: 4 bytes a
//      bf16 element;
//   N2 rmsnorm_bwd_kernel: x, dy and rstd in, dx out (6 bytes a bf16
//      element), and one fp32 partial of dw a CTA; rmsnorm_dw_kernel sums
//      the partials in a fixed order (a second, small launch, as A2 in
//      adamw.cu does), so dw repeats bit-equal from run to run;
//   S1 swiglu_fwd_kernel: a, b in, y out (6 bytes);
//   S2 swiglu_bwd_kernel: a, b, dy in, da, db out (10 bytes).
//
// The norms' walk. A row of d elements is d / VEC 16-byte vectors (VEC 8
// bf16 or 4 fp32), held by `tpr` threads, a power of two: thread t of the row
// holds vectors t, t + tpr, ... (at most NV) in registers, so the row is read
// from memory once. The host (ops/fused_norm_act.py norm_plan) takes the
// fewest threads that hold a row at four vectors a thread in N1 (at d 1024
// bf16 a warp a row, at 2048 two warps, at 128 four threads) and at two in
// N2, which holds x and dy and sums dw in registers (at four it spilled
// under two CTAs an SM), at most NT. A CTA of NT threads holds NT / tpr rows. A row's sum runs over xor shuffles within its
// threads, and for rows wider than a warp over the warps' sums in shared
// memory, added in warp order: every thread of a row gets the same bits.
//
// N1 is one CTA per NT / tpr rows. N2 is a persistent grid (the host's grid,
// at most SMs x 2, x 1 past two vectors a thread): CTA c walks row slots c, c + grid, ..., a slot being its
// NT / tpr rows; each thread sums dy * x_hat of its columns over its rows in
// fp32; at the end the CTA's row groups add theirs into shared memory in
// group order, and the CTA writes its partial row. rmsnorm_dw_kernel sums the
// partials column by column: 8 slices of the CTAs (slice s: CTAs s, s + 8,
// ...), each in order, then the slices in order.
//
// Numerics. N1 rounds where the plain chain rounds: x_hat = x * rstd and
// x_hat * w in fp32, one rounding to the output type; rstd = rsqrtf(sum(x^2)
// * (1/d) + eps), the sum in another order than PyTorch's mean takes, so rstd
// may differ in its last fp32 bits and y by one bf16 ulp. N2 computes
// dx = rstd * (w dy - x_hat * mean(w dy x_hat)) in fp32 and rounds once.
// S1 and S2 repeat ATen's silu and silu_backward expressions at the plain
// chain's rounding points (R: rounding to the input type):
//   act = R(a / (1 + exp(-a))),  y = R(act * b)
//   s = 1 / (1 + exp(-a)),  db = R(dy * act),  da = R(R(dy * b) * s * (1 + a (1 - s)))
// with expf and IEEE division as nvcc compiles them without fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;                    // threads a CTA (ops/fused_norm_act.py NT)
constexpr int BWD_CTAS_PER_SM = 2;         // N2's CTAs an SM at NV <= 2 (ops/fused_norm_act.py bwd_grid)
constexpr int DW_COLS = 32;                // rmsnorm_dw_kernel: columns a CTA
constexpr int DW_SLICES = NT / DW_COLS;    // and the slices of the partials it sums
constexpr int MAX_SMEM_FLOATS = 12288;     // N2's shared row of dw: at most 48 KB

template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ static float load(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16_rn(x); }
  __device__ static float rnd(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
};

template <>
struct Elem<float> {
  static constexpr int VEC = 4;
  __device__ static float load(float x) { return x; }
  __device__ static float store(float x) { return x; }
  __device__ static float rnd(float x) { return x; }
};

template <typename T>
struct alignas(16) Vec {
  T x[Elem<T>::VEC];
};

// The sum of v over the tpr threads of each row, the same bits in each of
// them. Every thread of the CTA calls it; red holds one float a warp.
__device__ __forceinline__ float row_sum(float v, int tpr, float* red) {
  const int width = tpr < 32 ? tpr : 32;
  for (int o = width / 2; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (tpr <= 32) return v;
  const int warp = threadIdx.x / 32, per_row = tpr / 32;
  if (threadIdx.x % 32 == 0) red[warp] = v;
  __syncthreads();
  const int first = warp / per_row * per_row;
  float s = red[first];
  for (int i = 1; i < per_row; ++i) s += red[first + i];
  __syncthreads();  // red is free for the next row
  return s;
}

template <typename T, int NV>
__global__ void __launch_bounds__(NT) rmsnorm_fwd_kernel(const T* __restrict__ x, long long xs,
                                                         const T* __restrict__ w, T* __restrict__ y,
                                                         float* __restrict__ rstd, long long rows, int d, int tpr,
                                                         float inv_d, float eps) {
  using E = Elem<T>;
  constexpr int VEC = E::VEC;
  __shared__ float red[NT / 32];
  const int vecs = d / VEC, lane = threadIdx.x % tpr;
  const long long row = (long long)blockIdx.x * (NT / tpr) + threadIdx.x / tpr;
  const bool live = row < rows;
  const Vec<T>* xr = reinterpret_cast<const Vec<T>*>(x + (live ? row : 0) * xs);
  Vec<T> xv[NV];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = lane + i * tpr;
    if (live && v < vecs) {
      xv[i] = xr[v];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = E::load(xv[i].x[j]);
        ss = __fmaf_rn(f, f, ss);
      }
    }
  }
  ss = row_sum(ss, tpr, red);
  if (!live) return;
  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, inv_d), eps));
  if (lane == 0) rstd[row] = r;
  const Vec<T>* wr = reinterpret_cast<const Vec<T>*>(w);
  Vec<T>* yr = reinterpret_cast<Vec<T>*>(y + row * d);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = lane + i * tpr;
    if (v < vecs) {
      const Vec<T> wv = wr[v];
      Vec<T> out;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        out.x[j] = E::store(__fmul_rn(__fmul_rn(E::load(xv[i].x[j]), r), E::load(wv.x[j])));
      yr[v] = out;
    }
  }
}

template <typename T, int NV>
__global__ void __launch_bounds__(NT, NV <= 2 ? BWD_CTAS_PER_SM : 1)
    rmsnorm_bwd_kernel(const T* __restrict__ x, long long xs, const T* __restrict__ w, const float* __restrict__ rstd,
                       const T* __restrict__ dy, long long gs, T* __restrict__ dx, float* __restrict__ partials,
                       long long rows, int d, int tpr, float inv_d) {
  using E = Elem<T>;
  constexpr int VEC = E::VEC;
  extern __shared__ float dw_cta[];  // [d]: the CTA's row groups' sums of dy * x_hat, group by group
  __shared__ float red[NT / 32];
  const int vecs = d / VEC, lane = threadIdx.x % tpr, group = threadIdx.x / tpr, per_cta = NT / tpr;
  Vec<T> wv[NV];  // w as loaded: its thread's columns, converted where used
  float acc[NV][VEC];
  const Vec<T>* wr = reinterpret_cast<const Vec<T>*>(w);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = lane + i * tpr;
    if (v < vecs) wv[i] = wr[v];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[i][j] = 0.f;
  }
  const long long slots = (rows + per_cta - 1) / per_cta;
  for (long long s = blockIdx.x; s < slots; s += gridDim.x) {
    const long long row = s * per_cta + group;
    const bool live = row < rows;
    const Vec<T>* xr = reinterpret_cast<const Vec<T>*>(x + (live ? row : 0) * xs);
    const Vec<T>* gr = reinterpret_cast<const Vec<T>*>(dy + (live ? row : 0) * gs);
    const float r = live ? rstd[row] : 0.f;
    Vec<T> xv[NV], gv[NV];
    float c = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = lane + i * tpr;
      if (live && v < vecs) {
        xv[i] = xr[v];
        gv[i] = gr[v];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh = __fmul_rn(E::load(xv[i].x[j]), r), g = E::load(gv[i].x[j]);
          c = __fmaf_rn(__fmul_rn(g, E::load(wv[i].x[j])), xh, c);
          acc[i][j] = __fmaf_rn(g, xh, acc[i][j]);
        }
      }
    }
    c = row_sum(c, tpr, red);
    if (live) {
      const float m = __fmul_rn(c, inv_d);
      Vec<T>* dr = reinterpret_cast<Vec<T>*>(dx + row * d);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int v = lane + i * tpr;
        if (v < vecs) {
          Vec<T> out;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float xh = __fmul_rn(E::load(xv[i].x[j]), r);
            const float gw = __fmul_rn(E::load(gv[i].x[j]), E::load(wv[i].x[j]));
            out.x[j] = E::store(__fmul_rn(r, __fsub_rn(gw, __fmul_rn(xh, m))));
          }
          dr[v] = out;
        }
      }
    }
  }
  for (int g = 0; g < per_cta; ++g) {
    if (group == g) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int v = lane + i * tpr;
        if (v < vecs) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            float* slot = dw_cta + v * VEC + j;
            *slot = g == 0 ? acc[i][j] : __fadd_rn(*slot, acc[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }
  for (int col = threadIdx.x; col < d; col += NT) partials[(long long)blockIdx.x * d + col] = dw_cta[col];
}

// dw[col] <- the sum over parts of partials[p, col]: slice s sums p = s,
// s + DW_SLICES, ... in order, then the slices are added in order
template <typename T>
__global__ void __launch_bounds__(NT) rmsnorm_dw_kernel(const float* __restrict__ partials, int parts, int d,
                                                        T* __restrict__ dw) {
  __shared__ float s[DW_SLICES][DW_COLS];
  const int c = threadIdx.x % DW_COLS, slice = threadIdx.x / DW_COLS;
  const int col = blockIdx.x * DW_COLS + c;
  float acc = 0.f;
  if (col < d)
    for (int p = slice; p < parts; p += DW_SLICES) acc = __fadd_rn(acc, partials[(long long)p * d + col]);
  s[slice][c] = acc;
  __syncthreads();
  if (slice == 0 && col < d) {
    float t = s[0][c];
    for (int k = 1; k < DW_SLICES; ++k) t = __fadd_rn(t, s[k][c]);
    dw[col] = Elem<T>::store(t);
  }
}

// ATen's silu and silu_backward, as compiled for float opmath
__device__ __forceinline__ float silu_f(float a) { return a / (1.f + expf(-a)); }

__device__ __forceinline__ float silu_grad(float dy, float a) {
  const float s = 1.f / (1.f + expf(-a));
  return dy * s * (1.f + a * (1.f - s));
}

template <typename T>
__global__ void __launch_bounds__(NT) swiglu_fwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                                        T* __restrict__ y, long long n, long long nvec) {
  using E = Elem<T>;
  constexpr int VEC = E::VEC;
  const long long stride = (long long)gridDim.x * NT, t = (long long)blockIdx.x * NT + threadIdx.x;
  for (long long u = t; u < nvec; u += stride) {
    const Vec<T> av = reinterpret_cast<const Vec<T>*>(a)[u], bv = reinterpret_cast<const Vec<T>*>(b)[u];
    Vec<T> out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) out.x[j] = E::store(E::rnd(silu_f(E::load(av.x[j]))) * E::load(bv.x[j]));
    reinterpret_cast<Vec<T>*>(y)[u] = out;
  }
  for (long long e = nvec * VEC + t; e < n; e += stride) y[e] = E::store(E::rnd(silu_f(E::load(a[e]))) * E::load(b[e]));
}

template <typename T>
__device__ __forceinline__ void swiglu_bwd1(T a, T b, T g, T& da, T& db) {
  using E = Elem<T>;
  const float af = E::load(a), gf = E::load(g);
  db = E::store(gf * E::rnd(silu_f(af)));
  da = E::store(silu_grad(E::rnd(gf * E::load(b)), af));
}

template <typename T>
__global__ void __launch_bounds__(NT) swiglu_bwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                                        const T* __restrict__ dy, T* __restrict__ da,
                                                        T* __restrict__ db, long long n, long long nvec) {
  constexpr int VEC = Elem<T>::VEC;
  const long long stride = (long long)gridDim.x * NT, t = (long long)blockIdx.x * NT + threadIdx.x;
  for (long long u = t; u < nvec; u += stride) {
    const Vec<T> av = reinterpret_cast<const Vec<T>*>(a)[u], bv = reinterpret_cast<const Vec<T>*>(b)[u];
    const Vec<T> gv = reinterpret_cast<const Vec<T>*>(dy)[u];
    Vec<T> dav, dbv;
#pragma unroll
    for (int j = 0; j < VEC; ++j) swiglu_bwd1<T>(av.x[j], bv.x[j], gv.x[j], dav.x[j], dbv.x[j]);
    reinterpret_cast<Vec<T>*>(da)[u] = dav;
    reinterpret_cast<Vec<T>*>(db)[u] = dbv;
  }
  for (long long e = nvec * VEC + t; e < n; e += stride) swiglu_bwd1<T>(a[e], b[e], dy[e], da[e], db[e]);
}

bool bad_norm(long long rows, int d, int tpr, int vec) {
  return rows < 1 || d < 1 || d % vec || tpr < 1 || tpr > NT || NT % tpr;
}

template <typename T, int NV>
int fwd_nv(const void* x, long long xs, const void* w, void* y, void* rstd, long long rows, int d, int tpr,
           float inv_d, float eps, cudaStream_t st) {
  const long long grid = (rows + NT / tpr - 1) / (NT / tpr);
  rmsnorm_fwd_kernel<T, NV><<<(unsigned)grid, NT, 0, st>>>(static_cast<const T*>(x), xs, static_cast<const T*>(w),
                                                            static_cast<T*>(y), static_cast<float*>(rstd), rows, d,
                                                            tpr, inv_d, eps);
  return int(cudaGetLastError());
}

template <typename T>
int fwd_t(int nv, const void* x, long long xs, const void* w, void* y, void* rstd, long long rows, int d, int tpr,
          float inv_d, float eps, cudaStream_t st) {
  if (bad_norm(rows, d, tpr, Elem<T>::VEC) || (long long)nv * tpr * Elem<T>::VEC < d) return int(cudaErrorInvalidValue);
  switch (nv) {
    case 1: return fwd_nv<T, 1>(x, xs, w, y, rstd, rows, d, tpr, inv_d, eps, st);
    case 2: return fwd_nv<T, 2>(x, xs, w, y, rstd, rows, d, tpr, inv_d, eps, st);
    case 4: return fwd_nv<T, 4>(x, xs, w, y, rstd, rows, d, tpr, inv_d, eps, st);
    case 8: return fwd_nv<T, 8>(x, xs, w, y, rstd, rows, d, tpr, inv_d, eps, st);
    default: return int(cudaErrorInvalidValue);
  }
}

template <typename T, int NV>
int bwd_nv(const void* x, long long xs, const void* w, const void* rstd, const void* dy, long long gs, void* dx,
           void* partials, long long rows, int d, int tpr, int grid, float inv_d, cudaStream_t st) {
  rmsnorm_bwd_kernel<T, NV><<<grid, NT, d * sizeof(float), st>>>(
      static_cast<const T*>(x), xs, static_cast<const T*>(w), static_cast<const float*>(rstd),
      static_cast<const T*>(dy), gs, static_cast<T*>(dx), static_cast<float*>(partials), rows, d, tpr, inv_d);
  return int(cudaGetLastError());
}

template <typename T>
int bwd_t(int nv, const void* x, long long xs, const void* w, const void* rstd, const void* dy, long long gs,
          void* dx, void* partials, long long rows, int d, int tpr, int grid, float inv_d, cudaStream_t st) {
  if (bad_norm(rows, d, tpr, Elem<T>::VEC) || (long long)nv * tpr * Elem<T>::VEC < d || d > MAX_SMEM_FLOATS ||
      grid < 1)
    return int(cudaErrorInvalidValue);
  switch (nv) {
    case 1: return bwd_nv<T, 1>(x, xs, w, rstd, dy, gs, dx, partials, rows, d, tpr, grid, inv_d, st);
    case 2: return bwd_nv<T, 2>(x, xs, w, rstd, dy, gs, dx, partials, rows, d, tpr, grid, inv_d, st);
    case 4: return bwd_nv<T, 4>(x, xs, w, rstd, dy, gs, dx, partials, rows, d, tpr, grid, inv_d, st);
    case 8: return bwd_nv<T, 8>(x, xs, w, rstd, dy, gs, dx, partials, rows, d, tpr, grid, inv_d, st);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype 0: bf16, 1: fp32 (x, w, y, dx, dw alike; rstd and partials fp32).
// x's rows `xs` elements apart (16-byte aligned), y dense [rows, d]; nv and
// tpr from the host's norm_plan.
extern "C" int rmsnorm_fwd(const void* x, long long xs, const void* w, void* y, void* rstd, long long rows, int d,
                           int tpr, int nv, float inv_d, float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd_t<__nv_bfloat16>(nv, x, xs, w, y, rstd, rows, d, tpr, inv_d, eps, st);
  if (dtype == 1) return fwd_t<float>(nv, x, xs, w, y, rstd, rows, d, tpr, inv_d, eps, st);
  return int(cudaErrorInvalidValue);
}

// dx dense [rows, d]; partials [grid, d] fp32, one row a CTA
extern "C" int rmsnorm_bwd(const void* x, long long xs, const void* w, const void* rstd, const void* dy, long long gs,
                           void* dx, void* partials, long long rows, int d, int tpr, int nv, int grid, float inv_d,
                           int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd_t<__nv_bfloat16>(nv, x, xs, w, rstd, dy, gs, dx, partials, rows, d, tpr, grid, inv_d, st);
  if (dtype == 1) return bwd_t<float>(nv, x, xs, w, rstd, dy, gs, dx, partials, rows, d, tpr, grid, inv_d, st);
  return int(cudaErrorInvalidValue);
}

// dw [d] <- the column sums of partials [parts, d], in a fixed order
extern "C" int rmsnorm_dw(const void* partials, int parts, int d, void* dw, int dtype, void* stream) {
  if (parts < 1 || d < 1) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = (d + DW_COLS - 1) / DW_COLS;
  const float* p = static_cast<const float*>(partials);
  if (dtype == 0) {
    rmsnorm_dw_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(p, parts, d, static_cast<__nv_bfloat16*>(dw));
  } else if (dtype == 1) {
    rmsnorm_dw_kernel<float><<<grid, NT, 0, st>>>(p, parts, d, static_cast<float*>(dw));
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// y <- R(R(silu(a)) * b) over n elements; `vectors`: whether a, b, y are
// 16-byte aligned (else every element is read alone)
extern "C" int swiglu_fwd(const void* a, const void* b, void* y, long long n, int vectors, int grid, int dtype,
                          void* stream) {
  if (n < 1 || grid < 1) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    using T = __nv_bfloat16;
    swiglu_fwd_kernel<T><<<grid, NT, 0, st>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                              static_cast<T*>(y), n, vectors ? n / Elem<T>::VEC : 0);
  } else if (dtype == 1) {
    swiglu_fwd_kernel<float><<<grid, NT, 0, st>>>(static_cast<const float*>(a), static_cast<const float*>(b),
                                                  static_cast<float*>(y), n, vectors ? n / Elem<float>::VEC : 0);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// (da, db) <- the SwiGLU's vjp at (a, b) for dy, over n elements
extern "C" int swiglu_bwd(const void* a, const void* b, const void* dy, void* da, void* db, long long n, int vectors,
                          int grid, int dtype, void* stream) {
  if (n < 1 || grid < 1) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    using T = __nv_bfloat16;
    swiglu_bwd_kernel<T><<<grid, NT, 0, st>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                              static_cast<const T*>(dy), static_cast<T*>(da), static_cast<T*>(db), n,
                                              vectors ? n / Elem<T>::VEC : 0);
  } else if (dtype == 1) {
    swiglu_bwd_kernel<float><<<grid, NT, 0, st>>>(static_cast<const float*>(a), static_cast<const float*>(b),
                                                  static_cast<const float*>(dy), static_cast<float*>(da),
                                                  static_cast<float*>(db), n, vectors ? n / Elem<float>::VEC : 0);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
