// Hopper (sm_90a) building blocks shared by the wgmma / TMA kernels
// (tree_attn_fwd.cu, tree_attn_bwd.cu, tree_attn_bwd_kmajor.cu, lm_head.cuh):
// mbarriers, TMA and bulk copies, wgmma products and their shared-memory
// descriptors, the 2-D tensor maps the copies read through, and the
// query-major walk of the tree-attention forward and dq. Every tile is laid
// out as the TMA writes it with a 128-byte swizzle: 64-row boxes of 128
// bytes (64 bf16), BOX_BYTES apart, the swizzle repeating every 1024 bytes.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

typedef __nv_bfloat16 bf16;

constexpr int BOX_BYTES = 8192;  // one TMA box: 64 rows x 64 bf16 (the 128-byte swizzle span)
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// ---------------------------------------------------------------- mbarriers, TMA

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits for the phase of `parity` to complete. A copy that never lands (a
// bad tensor map or byte count) traps after ~10 s instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000ll) __trap();
  }
}

// one 64 x 64 box at (column c0, row c1) of a 2-D bf16 tensor map
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                        int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// the shared-memory box at src -> global box (column c0, row c1) of a 2-D
// tensor map, by the TMA unit (a bulk-group operation; elements outside the
// tensor are not written)
__device__ __forceinline__ void tma_store_box(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

// barrier `id` (1..15; 0 is __syncthreads) over `threads` threads
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// global box (column c0, row c1) of an fp32 tensor map += the shared-memory
// box at src, by the TMA unit (a bulk-group operation)
__device__ __forceinline__ void tma_reduce_add(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.tile.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// the shared memory of every committed bulk group has been read
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// every committed bulk group is complete
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// ---------------------------------------------------------------------- wgmma

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_one() {  // all but the newest group
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// keep the compiler from moving register accesses across an asynchronous product
template <int NT>
__device__ __forceinline__ void pin(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}
template <int NT>
__device__ __forceinline__ void pin(uint32_t (&a)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

// A shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand: a [64][DH] tile of 64-column boxes, contraction along the
// columns; k-step kk = columns 16kk..16kk+15
__device__ __forceinline__ uint64_t desc_kmaj(uint32_t tile, int kk) {
  return desc_b128(tile + (kk >> 2) * BOX_BYTES + (kk & 3) * 32, 16, 1024);
}
// MN-major operand: contraction along the rows of a [64][N] tile of 64-column
// boxes (BOX_BYTES apart); k-step kk = rows 16kk..16kk+15
__device__ __forceinline__ uint64_t desc_mnmaj(uint32_t tile, int kk) {
  return desc_b128(tile + kk * 2048, BOX_BYTES, 1024);
}

#define HOPPER_ACC(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])

// d[64 x 64] (+)= A B^T: A [64][16] and B [64][16] K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_ACC(0), HOPPER_ACC(1), HOPPER_ACC(2), HOPPER_ACC(3),
        HOPPER_ACC(4), HOPPER_ACC(5), HOPPER_ACC(6), HOPPER_ACC(7)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] (+)= A B: A [16][64] and B [16][64] MN-major in shared memory
__device__ __forceinline__ void wgmma_ss_tt_n64(float (&d)[8][4], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : HOPPER_ACC(0), HOPPER_ACC(1), HOPPER_ACC(2), HOPPER_ACC(3),
        HOPPER_ACC(4), HOPPER_ACC(5), HOPPER_ACC(6), HOPPER_ACC(7)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 128] (+)= A B: A [16][64] and B [16][128] MN-major in shared memory
__device__ __forceinline__ void wgmma_ss_tt_n128(float (&d)[16][4], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : HOPPER_ACC(0), HOPPER_ACC(1), HOPPER_ACC(2), HOPPER_ACC(3),
        HOPPER_ACC(4), HOPPER_ACC(5), HOPPER_ACC(6), HOPPER_ACC(7),
        HOPPER_ACC(8), HOPPER_ACC(9), HOPPER_ACC(10), HOPPER_ACC(11),
        HOPPER_ACC(12), HOPPER_ACC(13), HOPPER_ACC(14), HOPPER_ACC(15)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] += A B: A from registers, B [16][64] MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_t_n64(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_ACC(0), HOPPER_ACC(1), HOPPER_ACC(2), HOPPER_ACC(3),
        HOPPER_ACC(4), HOPPER_ACC(5), HOPPER_ACC(6), HOPPER_ACC(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// d[64 x 128] += A B: A from registers, B [16][128] MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_t_n128(float (&d)[16][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HOPPER_ACC(0), HOPPER_ACC(1), HOPPER_ACC(2), HOPPER_ACC(3),
        HOPPER_ACC(4), HOPPER_ACC(5), HOPPER_ACC(6), HOPPER_ACC(7),
        HOPPER_ACC(8), HOPPER_ACC(9), HOPPER_ACC(10), HOPPER_ACC(11),
        HOPPER_ACC(12), HOPPER_ACC(13), HOPPER_ACC(14), HOPPER_ACC(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// d[64 x 32] (+)= A B^T: A [64][16] and B [32][16] K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_ACC(0), HOPPER_ACC(1), HOPPER_ACC(2), HOPPER_ACC(3)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 192] += A B: A from registers, B [16][192] MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_t_n192(float (&d)[24][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : HOPPER_ACC(0), HOPPER_ACC(1), HOPPER_ACC(2), HOPPER_ACC(3),
        HOPPER_ACC(4), HOPPER_ACC(5), HOPPER_ACC(6), HOPPER_ACC(7),
        HOPPER_ACC(8), HOPPER_ACC(9), HOPPER_ACC(10), HOPPER_ACC(11),
        HOPPER_ACC(12), HOPPER_ACC(13), HOPPER_ACC(14), HOPPER_ACC(15),
        HOPPER_ACC(16), HOPPER_ACC(17), HOPPER_ACC(18), HOPPER_ACC(19),
        HOPPER_ACC(20), HOPPER_ACC(21), HOPPER_ACC(22), HOPPER_ACC(23)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// d[64 x 256] (+)= A B over one k-step of 16. A: [64][16] K-major (A_MN 0)
// or [16][64] MN-major (1); B: [256][16] K-major (B_MN 0) or [16][256]
// MN-major (1), in shared memory
template <int A_MN, int B_MN>
__device__ __forceinline__ void wgmma_n256(float (&d)[32][4], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : HOPPER_ACC(0), HOPPER_ACC(1), HOPPER_ACC(2), HOPPER_ACC(3),
        HOPPER_ACC(4), HOPPER_ACC(5), HOPPER_ACC(6), HOPPER_ACC(7),
        HOPPER_ACC(8), HOPPER_ACC(9), HOPPER_ACC(10), HOPPER_ACC(11),
        HOPPER_ACC(12), HOPPER_ACC(13), HOPPER_ACC(14), HOPPER_ACC(15),
        HOPPER_ACC(16), HOPPER_ACC(17), HOPPER_ACC(18), HOPPER_ACC(19),
        HOPPER_ACC(20), HOPPER_ACC(21), HOPPER_ACC(22), HOPPER_ACC(23),
        HOPPER_ACC(24), HOPPER_ACC(25), HOPPER_ACC(26), HOPPER_ACC(27),
        HOPPER_ACC(28), HOPPER_ACC(29), HOPPER_ACC(30), HOPPER_ACC(31)
      : "l"(da), "l"(db), "r"(scale_d), "n"(A_MN), "n"(B_MN));
}

#undef HOPPER_ACC

// d[64 x DH] += A (registers) B (MN-major smem)
template <int DH>
__device__ __forceinline__ void wgmma_rs_t(float (&d)[DH / 8][4], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DH == 192) {
    wgmma_rs_t_n192(d, a, db);
  } else if constexpr (DH == 128) {
    wgmma_rs_t_n128(d, a, db);
  } else {
    wgmma_rs_t_n64(d, a, db);
  }
}

// d[64 x DH] (+)= A B, both MN-major in smem
template <int DH>
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[DH / 8][4], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (DH == 128) {
    wgmma_ss_tt_n128(d, da, db, scale_d);
  } else {
    wgmma_ss_tt_n64(d, da, db, scale_d);
  }
}

// ---------------------------------------------------------------- tensor maps

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no link to libcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [rows, dh] row-major bf16 (or fp32) tensor in boxes of 64 rows x 128
// bytes, 128-byte swizzle
inline bool tensor_map(CUtensorMap* map, const void* ptr, long long rows, int dh, bool fp32 = false) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t elem = fp32 ? 4 : 2;
  const cuuint64_t dims[2] = {cuuint64_t(dh), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(dh) * elem};
  const cuuint32_t box[2] = {128 / elem, 64};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ------------------------------------------------------- the query-major walk
//
// Shared by the tree-attention forward (K1/K2, tree_attn_fwd.cu) and the dq
// of the split backward (K11, tree_attn_bwd.cu). The work list
// (tries.build_qmajor_work, built once per batch on the host): entries[]
// holds each live 64-key sub-tile of each 64-row q tile as key_start * 2 +
// partial, q tile by q tile; tiles[t] = (row start, first entry, entries),
// heaviest first. A CTA owns one q tile of a slice of GS q heads of one GQA
// group: grid = tiles x kv heads x ceil(G / GS), the tile slowest, so the
// heaviest tiles start first. Warpgroups 0 .. GS-1 consume, one group head
// each (64 rows); warpgroup GS produces: one of its threads issues every
// copy. The producer gives registers back (setmaxnreg PRODUCER_REGS) and the
// consumers take them (CONSUMER_REGS): a 384-thread CTA enters with
// ENTRY_REGS a thread, and the host refuses to launch at any other entry
// count, since the consumers' request could then wait forever.
namespace qmajor {

constexpr int TK = 64;                 // keys per sub-tile
constexpr int GS = 2;                  // q heads of a GQA group per CTA (the group slice)
constexpr int NCONS = GS * 128;        // consumer threads: one warpgroup per group head
constexpr int NTHREADS = NCONS + 128;  // + the producer warpgroup
// registers a thread: at entry (what ptxas gives a 384-thread CTA), and after
// setmaxnreg for the producer and the consumers: 2 x (232 - 168) = 168 - 40
constexpr int ENTRY_REGS = 168, PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// this CTA's share of the work list
struct Cta {
  int h, g0, heads;  // kv head, first group head, heads of the slice (1 at an odd group's last)
  int r0, e0, cnt;   // the q tile's first row, first entry and entries
};

__device__ __forceinline__ Cta cta(const int* tiles, int hkv, int group) {
  const int slices = (group + GS - 1) / GS;
  const int* tl = tiles + (blockIdx.x / (hkv * slices)) * 3;
  const int rest = blockIdx.x % (hkv * slices);
  const int g0 = (rest / hkv) * GS;
  return {rest % hkv, g0, min(GS, group - g0), tl[0], tl[1], tl[2]};
}

// The producer's walk over the tile's entries: keeps a ring of S stages of
// (K, V, last_desc) sub-tiles full, K and V by TMA (2-D tensor maps over
// [rows, DH] and [rows, DV], 64 x 64 boxes, 128-byte swizzle: tiles of
// TK * DH * 2 and TK * DV * 2 bytes at sK / sV) and last_desc by a bulk copy
// (TK int32 at sLD), on the full mbarrier at bars + 8 s and the empty one at
// bars + 8 (S + s) of stage s. DV, v's width, is DH but for MLA's widths.
template <int DH, int S, int DV = DH>
__device__ __forceinline__ void fill_ring(const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                          const int* last_desc, const int* entries, const Cta& c, int n,
                                          uint32_t sK, uint32_t sV, uint32_t sLD, uint32_t bars) {
  constexpr int TILE = TK * DH * 2, TILE_V = TK * DV * 2;
  for (int it = 0; it < c.cnt; ++it) {
    const int s = it % S;
    if (it >= S) mbar_wait(bars + 8 * (S + s), ((it / S) - 1) & 1);
    const int c0 = entries[c.e0 + it] >> 1;
    const uint32_t full = bars + 8 * s;
    mbar_expect_tx(full, TILE + TILE_V + TK * 4);
    if constexpr (DV == DH) {
#pragma unroll
      for (int x = 0; x < DH / 64; ++x) {
        tma_box(sK + s * TILE + x * BOX_BYTES, tm_k, full, x * 64, c.h * n + c0);
        tma_box(sV + s * TILE + x * BOX_BYTES, tm_v, full, x * 64, c.h * n + c0);
      }
    } else {
#pragma unroll
      for (int x = 0; x < DH / 64; ++x) tma_box(sK + s * TILE + x * BOX_BYTES, tm_k, full, x * 64, c.h * n + c0);
#pragma unroll
      for (int x = 0; x < DV / 64; ++x)
        tma_box(sV + s * TILE_V + x * BOX_BYTES, tm_v, full, x * 64, c.h * n + c0);
    }
    bulk_copy(sLD + s * TK * 4, last_desc + c0, TK * 4, full);
  }
}

// host: 0 if `kernel` enters at ENTRY_REGS registers a thread, else an error code
inline int check_entry_regs(const void* kernel) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return int(err);
  return attr.numRegs == ENTRY_REGS ? 0 : int(cudaErrorInvalidConfiguration);
}

}  // namespace qmajor

}  // namespace hopper
