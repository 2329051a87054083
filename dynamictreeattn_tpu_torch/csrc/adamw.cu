// The optimizer layer for Hopper (sm_90a): the clip's global sum of squares
// and the AdamW update, each one multi-tensor launch over every leaf.
//
// Replaces no Pallas kernel. The JAX Trainer runs optax's
// clip_by_global_norm -> adamw chain, which XLA fuses on the TPU; run as
// eager PyTorch ops (ops/adamw.py adamw_update_plain) the same chain is
// about twenty passes over memory a leaf: every mul, add, div, sqrt, cast
// and select reads and writes whole tensors. These kernels read each
// element once and write it once.
//
// What bounds them on the card: bytes. The update reads g, p, mu, nu and
// writes p, mu, nu (14 bytes a bf16 parameter), the sum of squares reads g
// once more (2 bytes): 16 bytes a parameter, ~27 ms for Qwen3-30B-A3B's 8
// layers (5.61 B parameters) at 3.35 TB/s. The arithmetic is some forty
// instructions an element, a quarter of them conversions to bf16; they are
// packed two to an instruction (cvt.rn.bf16x2.f32) so that the conversion
// pipe stays below the memory time.
//
// The walk. The host (ops/adamw.py plan) cuts the leaves into launches of
// at most MAX_LEAVES leaves of one dtype and cuts each leaf into units: a
// few scalar elements up to the first 16-byte boundary (the head), 16-byte
// vectors (8 bf16 or 4 fp32), then the scalar rest (the tail); a leaf
// whose four tensors are not equally misaligned is all head. The units of
// a launch's leaves, in leaf order, are dealt round-robin to its threads:
// unit u of a leaf goes to thread (u + rot) % threads, rot the count of
// the launch's earlier units modulo the threads. The table of pointers and
// units travels in the kernel's parameters; nothing is uploaded, nothing
// is read back.
//
// The update repeats the eager chain op for op (training/trainer.py
// OptaxAdamW, optax's arithmetic), each op computed in fp32 and rounded to
// the leaf's dtype where the eager op rounds its output:
//   g  <- R(R(g / R(div)) * R(mul))                      (the clip, if any)
//   mu <- R(R(c1 * g) + R(b1 * mu)),  c1 = float(1 - b1)
//   nu <- R(R(c2 * R(g * g)) + R(b2 * nu))
//   u  <- R(R(mu / R(bc1)) / R(R(sqrt(R(nu / R(bc2)))) + eps))
//   u  <- R(R(u + R(wd * p)) * R(lr))
//   p  <- R(p + u)
// with IEEE division and square root (__fdiv_rn, __fsqrt_rn) and no fused
// multiply-add, so that an fp32 leaf, where R is the identity, rounds as
// the eager ops do. lr (-lr, the warmup applied), bc1, bc2, the clip's div
// and mul and the commit flag are device scalars: the launch is the same
// every step. Where commit is false the kernel returns before its first
// load: params and moments stay bit-unchanged. g is only read.
//
// The sum of squares: each thread sums its units' squares (fp32 within a
// vector, fp64 across), each CTA its threads' sums in a fixed tree into one
// fp64 partial, and a second one-CTA launch sums the partials in a fixed
// order into an fp32 total. No atomics: two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;          // threads a CTA
constexpr int CTAS_PER_SM = 4;   // ops/adamw.py CTAS_PER_SM: the grid is SMs x this
constexpr int MAX_LEAVES = 64;   // ops/adamw.py MAX_LEAVES: the leaves a launch's table holds

struct Walk {
  long long nvec;  // 16-byte vectors, from element `head` on
  int head, tail;  // scalar elements before and after the vectors
  int rot;         // the launch's earlier units modulo its threads
};

struct UpdateArgs {
  void* p[MAX_LEAVES];
  const void* g[MAX_LEAVES];
  void* m[MAX_LEAVES];
  void* v[MAX_LEAVES];
  Walk walk[MAX_LEAVES];
  int n;
  const float* lr;
  const float* bc1;
  const float* bc2;
  const float* div;  // null: no clip
  const float* mul;
  const unsigned char* commit;
  float c1, b1, c2, b2, eps, wd;
};
static_assert(sizeof(UpdateArgs) <= 4096, "a kernel's parameters hold at most 4 KiB");

struct SumsqArgs {
  const void* g[MAX_LEAVES];
  Walk walk[MAX_LEAVES];
  int n;
  double* partials;  // one a CTA
};
static_assert(sizeof(SumsqArgs) <= 4096, "a kernel's parameters hold at most 4 KiB");

template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ static float load(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16_rn(x); }
  __device__ static float rnd(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
  __device__ static void rnd2(float& x, float& y) {  // one cvt.rn.bf16x2.f32 for both
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    x = __low2float(h);
    y = __high2float(h);
  }
};

template <>
struct Elem<float> {
  static constexpr int VEC = 4;
  __device__ static float load(float x) { return x; }
  __device__ static float store(float x) { return x; }
  __device__ static float rnd(float x) { return x; }
  __device__ static void rnd2(float&, float&) {}
};

template <typename T>
struct alignas(16) Vec {
  T x[Elem<T>::VEC];
};

struct Consts {
  bool clip;
  float div, mul, c1, b1, c2, b2, bc1, bc2, eps, wd, lr;
};

// the eager chain on two elements, each rounding of the pair one instruction
template <typename T>
__device__ __forceinline__ void adamw2(float (&p)[2], float (&g)[2], float (&m)[2], float (&v)[2],
                                       const Consts& k) {
  using E = Elem<T>;
  float x[2], y[2];
  if (k.clip) {
#pragma unroll
    for (int i = 0; i < 2; ++i) x[i] = __fdiv_rn(g[i], k.div);
    E::rnd2(x[0], x[1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) g[i] = __fmul_rn(x[i], k.mul);
    E::rnd2(g[0], g[1]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) x[i] = __fmul_rn(k.c1, g[i]), y[i] = __fmul_rn(k.b1, m[i]);
  E::rnd2(x[0], x[1]);
  E::rnd2(y[0], y[1]);
#pragma unroll
  for (int i = 0; i < 2; ++i) m[i] = __fadd_rn(x[i], y[i]);
  E::rnd2(m[0], m[1]);
#pragma unroll
  for (int i = 0; i < 2; ++i) x[i] = __fmul_rn(g[i], g[i]);
  E::rnd2(x[0], x[1]);
#pragma unroll
  for (int i = 0; i < 2; ++i) x[i] = __fmul_rn(k.c2, x[i]), y[i] = __fmul_rn(k.b2, v[i]);
  E::rnd2(x[0], x[1]);
  E::rnd2(y[0], y[1]);
#pragma unroll
  for (int i = 0; i < 2; ++i) v[i] = __fadd_rn(x[i], y[i]);
  E::rnd2(v[0], v[1]);
#pragma unroll
  for (int i = 0; i < 2; ++i) x[i] = __fdiv_rn(m[i], k.bc1), y[i] = __fdiv_rn(v[i], k.bc2);
  E::rnd2(x[0], x[1]);  // mu / bc1
  E::rnd2(y[0], y[1]);  // nu / bc2
#pragma unroll
  for (int i = 0; i < 2; ++i) y[i] = __fsqrt_rn(y[i]);
  E::rnd2(y[0], y[1]);
#pragma unroll
  for (int i = 0; i < 2; ++i) y[i] = __fadd_rn(y[i], k.eps);
  E::rnd2(y[0], y[1]);
#pragma unroll
  for (int i = 0; i < 2; ++i) x[i] = __fdiv_rn(x[i], y[i]), y[i] = __fmul_rn(k.wd, p[i]);
  E::rnd2(x[0], x[1]);  // u
  E::rnd2(y[0], y[1]);  // wd * p
#pragma unroll
  for (int i = 0; i < 2; ++i) x[i] = __fadd_rn(x[i], y[i]);
  E::rnd2(x[0], x[1]);
#pragma unroll
  for (int i = 0; i < 2; ++i) x[i] = __fmul_rn(x[i], k.lr);
  E::rnd2(x[0], x[1]);
#pragma unroll
  for (int i = 0; i < 2; ++i) p[i] = __fadd_rn(p[i], x[i]);
  E::rnd2(p[0], p[1]);
}

template <typename T>
__global__ void __launch_bounds__(NT, CTAS_PER_SM) adamw_update_kernel(const UpdateArgs a) {
  if (!*a.commit) return;
  using E = Elem<T>;
  constexpr int VEC = E::VEC;
  Consts k;
  k.clip = a.div != nullptr;
  k.div = k.clip ? E::rnd(*a.div) : 1.f;
  k.mul = k.clip ? E::rnd(*a.mul) : 1.f;
  k.bc1 = E::rnd(*a.bc1);
  k.bc2 = E::rnd(*a.bc2);
  k.lr = E::rnd(*a.lr);
  k.c1 = a.c1, k.b1 = a.b1, k.c2 = a.c2, k.b2 = a.b2, k.eps = a.eps, k.wd = a.wd;
  const int threads = gridDim.x * NT;
  const int t = blockIdx.x * NT + threadIdx.x;
  for (int i = 0; i < a.n; ++i) {
    const Walk w = a.walk[i];
    T* p = static_cast<T*>(a.p[i]);
    const T* g = static_cast<const T*>(a.g[i]);
    T* m = static_cast<T*>(a.m[i]);
    T* v = static_cast<T*>(a.v[i]);
    const long long units = w.nvec + w.head + w.tail;
    long long u = t - w.rot;
    if (u < 0) u += threads;
    for (; u < units; u += threads) {
      if (u < w.nvec) {
        const long long off = w.head + u * VEC;
        Vec<T> pv = *reinterpret_cast<const Vec<T>*>(p + off);
        const Vec<T> gv = *reinterpret_cast<const Vec<T>*>(g + off);
        Vec<T> mv = *reinterpret_cast<const Vec<T>*>(m + off);
        Vec<T> vv = *reinterpret_cast<const Vec<T>*>(v + off);
#pragma unroll
        for (int j = 0; j < VEC; j += 2) {
          float pf[2] = {E::load(pv.x[j]), E::load(pv.x[j + 1])};
          float gf[2] = {E::load(gv.x[j]), E::load(gv.x[j + 1])};
          float mf[2] = {E::load(mv.x[j]), E::load(mv.x[j + 1])};
          float vf[2] = {E::load(vv.x[j]), E::load(vv.x[j + 1])};
          adamw2<T>(pf, gf, mf, vf, k);
#pragma unroll
          for (int i2 = 0; i2 < 2; ++i2) {
            pv.x[j + i2] = E::store(pf[i2]);
            mv.x[j + i2] = E::store(mf[i2]);
            vv.x[j + i2] = E::store(vf[i2]);
          }
        }
        *reinterpret_cast<Vec<T>*>(p + off) = pv;
        *reinterpret_cast<Vec<T>*>(m + off) = mv;
        *reinterpret_cast<Vec<T>*>(v + off) = vv;
      } else {
        long long e = u - w.nvec;  // a scalar of the head, or of the tail
        if (e >= w.head) e += w.nvec * VEC;
        float pf[2] = {E::load(p[e]), 0.f}, gf[2] = {E::load(g[e]), 0.f};
        float mf[2] = {E::load(m[e]), 0.f}, vf[2] = {E::load(v[e]), 0.f};
        adamw2<T>(pf, gf, mf, vf, k);
        p[e] = E::store(pf[0]);
        m[e] = E::store(mf[0]);
        v[e] = E::store(vf[0]);
      }
    }
  }
}

// a fixed-order tree over the CTA's NT values; thread 0 returns the total
__device__ double block_sum(double x) {
  __shared__ double s[NT];
  s[threadIdx.x] = x;
  __syncthreads();
#pragma unroll
  for (int half = NT / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) s[threadIdx.x] += s[threadIdx.x + half];
    __syncthreads();
  }
  return s[0];
}

template <typename T>
__global__ void __launch_bounds__(NT, CTAS_PER_SM) adamw_sumsq_kernel(const SumsqArgs a) {
  using E = Elem<T>;
  constexpr int VEC = E::VEC;
  const int threads = gridDim.x * NT;
  const int t = blockIdx.x * NT + threadIdx.x;
  double acc = 0.0;
  for (int i = 0; i < a.n; ++i) {
    const Walk w = a.walk[i];
    const T* g = static_cast<const T*>(a.g[i]);
    const long long units = w.nvec + w.head + w.tail;
    long long u = t - w.rot;
    if (u < 0) u += threads;
    for (; u < units; u += threads) {
      if (u < w.nvec) {
        const Vec<T> gv = *reinterpret_cast<const Vec<T>*>(g + w.head + u * VEC);
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float x = E::load(gv.x[j]);
          s = __fmaf_rn(x, x, s);
        }
        acc += s;
      } else {
        long long e = u - w.nvec;
        if (e >= w.head) e += w.nvec * VEC;
        const float x = E::load(g[e]);
        acc += __fmul_rn(x, x);
      }
    }
  }
  const double total = block_sum(acc);
  if (threadIdx.x == 0) a.partials[blockIdx.x] = total;
}

__global__ void __launch_bounds__(NT) adamw_sumsq_finish_kernel(const double* partials, int n, float* out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += NT) acc += partials[i];
  const double total = block_sum(acc);
  if (threadIdx.x == 0) *out = float(total);
}

template <typename A>
void fill_table(A& a, const long long* nvec, const int* head, const int* tail, const int* rot, int n) {
  a.n = n;
  for (int i = 0; i < n; ++i) a.walk[i] = Walk{nvec[i], head[i], tail[i], rot[i]};
}

}  // namespace

// dtype 0: bf16, 1: fp32. `ptrs` holds n pointers of p, then n of g, of mu,
// of nu; `grid` CTAs of NT threads.
extern "C" int adamw_update(void* const* ptrs, const long long* nvec, const int* head, const int* tail,
                            const int* rot, int n, int dtype, int grid, const void* lr, const void* bc1,
                            const void* bc2, const void* div, const void* mul, const void* commit, float c1,
                            float b1, float c2, float b2, float eps, float wd, void* stream) {
  if (n < 1 || n > MAX_LEAVES || grid < 1 || (div == nullptr) != (mul == nullptr)) return int(cudaErrorInvalidValue);
  UpdateArgs a;
  fill_table(a, nvec, head, tail, rot, n);
  for (int i = 0; i < n; ++i) a.p[i] = ptrs[i], a.g[i] = ptrs[n + i], a.m[i] = ptrs[2 * n + i], a.v[i] = ptrs[3 * n + i];
  a.lr = static_cast<const float*>(lr);
  a.bc1 = static_cast<const float*>(bc1);
  a.bc2 = static_cast<const float*>(bc2);
  a.div = static_cast<const float*>(div);
  a.mul = static_cast<const float*>(mul);
  a.commit = static_cast<const unsigned char*>(commit);
  a.c1 = c1, a.b1 = b1, a.c2 = c2, a.b2 = b2, a.eps = eps, a.wd = wd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    adamw_update_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(a);
  } else if (dtype == 1) {
    adamw_update_kernel<float><<<grid, NT, 0, st>>>(a);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// one CTA's fp64 partial of sum(g^2) over the launch's leaves into partials[0, grid)
extern "C" int adamw_sumsq(const void* const* g, const long long* nvec, const int* head, const int* tail,
                           const int* rot, int n, int dtype, int grid, void* partials, void* stream) {
  if (n < 1 || n > MAX_LEAVES || grid < 1) return int(cudaErrorInvalidValue);
  SumsqArgs a;
  fill_table(a, nvec, head, tail, rot, n);
  for (int i = 0; i < n; ++i) a.g[i] = g[i];
  a.partials = static_cast<double*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    adamw_sumsq_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(a);
  } else if (dtype == 1) {
    adamw_sumsq_kernel<float><<<grid, NT, 0, st>>>(a);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// out (one fp32) <- the sum of partials[0, n), in a fixed order
extern "C" int adamw_sumsq_finish(const void* partials, int n, void* out, void* stream) {
  if (n < 1) return int(cudaErrorInvalidValue);
  adamw_sumsq_finish_kernel<<<1, NT, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const double*>(partials), n,
                                                                                static_cast<float*>(out));
  return int(cudaGetLastError());
}
