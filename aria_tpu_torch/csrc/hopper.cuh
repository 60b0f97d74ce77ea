// Hopper pieces shared by the wgmma kernels (flash.cu, flash_bwd.cu,
// gmm.cu): TMA loads of tensor-map boxes, the 128-byte-swizzle shared-memory
// descriptor, the wgmma fences and the m64n64k16, m64n128k16 and m64n256k16
// bf16 products (transpose bits as template arguments), and the host-side
// tensor maps.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is looked up at run time

#include "common.cuh"

namespace aria {

// ---- TMA: one box of a tensor map at the given coordinates (innermost
// first) into shared memory, completing on the mbarrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3)
      : "memory");
}

// ---- wgmma
// A shared-memory matrix descriptor with the 128-byte swizzle; offsets in
// bytes. K-major (rows of 64 bf16 along K): SBO is the stride between 8-row
// groups, LBO unused. MN-major (rows of 64 bf16 along M or N, one row per
// k): LBO is the stride between 64-element chunks along M or N, SBO between
// 8-row groups along K.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed groups of products are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accesses of the registers across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ARIA_D32                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

#define ARIA_D64                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, " \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define ARIA_F8(i)                                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define ARIA_F32 ARIA_F8(0), ARIA_F8(8), ARIA_F8(16), ARIA_F8(24)
#define ARIA_F64 ARIA_F32, ARIA_F8(32), ARIA_F8(40), ARIA_F8(48), ARIA_F8(56)

// d (+)= A B: 64 x 64 x 16, bf16 operands from shared memory, f32 sums;
// TA / TB: 0 for a K-major operand, 1 for an MN-major one
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ARIA_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : ARIA_F32
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d (+)= A B: 64 x 128 x 16, bf16 operands from shared memory, f32 sums;
// TA / TB: 0 for a K-major operand, 1 for an MN-major one
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ARIA_D64
      ", %64, %65, p, 1, 1, %67, %68;\n}\n"
      : ARIA_F64
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d += A B: A (64 x 16 bf16) from registers, B from shared memory (TB as above)
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ARIA_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : ARIA_F64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

#define ARIA_D128                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, " \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, " \
  "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, " \
  "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "   \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, " \
  "%123, %124, %125, %126, %127}"
#define ARIA_F128                                                                            \
  ARIA_F64, ARIA_F8(64), ARIA_F8(72), ARIA_F8(80), ARIA_F8(88), ARIA_F8(96), ARIA_F8(104), \
      ARIA_F8(112), ARIA_F8(120)

// d (+)= A B: 64 x 256 x 16 (A read once for both halves of N); the
// fragment's first 64 registers are the m64n128 fragment of columns 0-127
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss256(float (&d)[128], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " ARIA_D128
      ", %128, %129, p, 1, 1, %131, %132;\n}\n"
      : ARIA_F128
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

#undef ARIA_F128
#undef ARIA_D128
#undef ARIA_F64
#undef ARIA_F32
#undef ARIA_F8
#undef ARIA_D64
#undef ARIA_D32

// ---- host side
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once at run time (no -lcuda)
__host__ inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A bf16 tensor of the given rank as a tensor map with the 128-byte
// swizzle: dims innermost first, strides in bytes of dims 1.., box in
// elements (box[0] = 64: one swizzled 128-byte row). Elements past a dim's
// end load as zeros.
__host__ inline bool make_map(CUtensorMap* map, const void* base, int rank,
                              const cuuint64_t* dims, const cuuint64_t* strides,
                              const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// attention's [B, S, H, 128] bf16 as the rank-4 map (d, h, s, b), boxes of
// 64 d x 1 x rows x 1
__host__ inline bool bshd_map(CUtensorMap* map, const void* t, int B, int S, int H, int rows) {
  const cuuint64_t dims[4] = {128, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {256, (cuuint64_t)H * 256, (cuuint64_t)S * H * 256};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return make_map(map, t, 4, dims, strides, box);
}

}  // namespace aria
