// Hopper pieces shared by the wgmma kernels (flash.cu, flash_bwd.cu,
// gmm.cu, vit_attention.cu, vit_attention_bwd.cu, dense_int4.cu,
// moe_prefill.cu) and the decode
// MoE's TMA rings (moe_decode.cu, moe_decode_bf16x.cu): TMA loads of
// tensor-map boxes, the 128-byte-swizzle and the unswizzled shared-memory
// descriptors, the wgmma fences and the m64n8k16 to m64n256k16 bf16
// products (transpose bits as template arguments), the counters that order
// the attention backwards' dq sums across blocks, the packed int4 weights
// unpacked into bf16 A fragments of wgmma or int8 ones of mma.sync, and the
// host-side tensor maps.
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

// An unswizzled (interleaved) descriptor: the operand is core matrices of 8
// rows x 16 bytes, 128 contiguous bytes each. K-major: LBO steps to the next
// 8 columns of K, SBO to the next 8 rows of M or N. MN-major: LBO steps to
// the next 8 rows of K, SBO to the next 8 columns of M or N.
__device__ __forceinline__ uint64_t plain_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
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

// the same for A fragments in registers: they are complete before the
// products that read them are issued
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("" : "+r"(a[i][0]), "+r"(a[i][1]), "+r"(a[i][2]), "+r"(a[i][3])::"memory");
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

// d (+)= A B: 64 x 8 x 16, bf16 operands from shared memory, f32 sums
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss8(float (&d)[4], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}"
      ", %4, %5, p, 1, 1, %7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
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

// d (+)= A B: A (64 x 16 bf16) from registers, B from shared memory (TB as above)
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t db,
                                         int accumulate = 1) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ARIA_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : ARIA_F64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// d (+)= A B: A (64 x 16 bf16) from registers, B from shared memory, N = 64
template <int TB>
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], const uint32_t* a, uint64_t db,
                                           int accumulate = 1) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ARIA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : ARIA_F32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// d (+)= A B: A (64 x 16 bf16) from registers, B from shared memory, N = 32
template <int TB>
__device__ __forceinline__ void wgmma_rs32(float (&d)[16], const uint32_t* a, uint64_t db,
                                           int accumulate = 1) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : ARIA_F8(0), ARIA_F8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// d (+)= A B: A (64 x 16 bf16) from registers, B from shared memory, N = 16
template <int TB>
__device__ __forceinline__ void wgmma_rs16(float (&d)[8], const uint32_t* a, uint64_t db,
                                           int accumulate = 1) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}"
      ", {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : ARIA_F8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// d (+)= A B: A (64 x 16 bf16) from registers, B from shared memory, N = 8
template <int TB>
__device__ __forceinline__ void wgmma_rs8(float (&d)[4], const uint32_t* a, uint64_t db,
                                          int accumulate = 1) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %9, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}"
      ", {%4, %5, %6, %7}, %8, p, 1, 1, %10;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// d (+)= A B: A (64 x 16 bf16) from registers, B from shared memory, N = 48
template <int TB>
__device__ __forceinline__ void wgmma_rs48(float (&d)[24], const uint32_t* a, uint64_t db,
                                           int accumulate = 1) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %29, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}"
      ", {%24, %25, %26, %27}, %28, p, 1, 1, %30;\n}\n"
      : ARIA_F8(0), ARIA_F8(8), ARIA_F8(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// d (+)= A B: A (64 x 16 bf16) from registers, B from shared memory, N = 96
template <int TB>
__device__ __forceinline__ void wgmma_rs96(float (&d)[48], const uint32_t* a, uint64_t db,
                                           int accumulate = 1) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %53, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}"
      ", {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
      : ARIA_F8(0), ARIA_F8(8), ARIA_F8(16), ARIA_F8(24), ARIA_F8(32), ARIA_F8(40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// d (+)= A B, m64 nTN k16, A from registers, B K-major in shared memory
// (TN: 8, 16, 32, 48, 64, 96 or 128)
template <int TN>
__device__ __forceinline__ void wgmma_rsn(float (&d)[TN / 2], const uint32_t* a, uint64_t db,
                                          int accumulate = 1) {
  if constexpr (TN == 8) wgmma_rs8<0>(d, a, db, accumulate);
  else if constexpr (TN == 16) wgmma_rs16<0>(d, a, db, accumulate);
  else if constexpr (TN == 32) wgmma_rs32<0>(d, a, db, accumulate);
  else if constexpr (TN == 48) wgmma_rs48<0>(d, a, db, accumulate);
  else if constexpr (TN == 64) wgmma_rs64<0>(d, a, db, accumulate);
  else if constexpr (TN == 96) wgmma_rs96<0>(d, a, db, accumulate);
  else wgmma_rs<0>(d, a, db, accumulate);
}

// ---- dq of the attention backwards (flash_bwd.cu, vit_attention_bwd.cu):
// each key tile's part of a query tile's dq is added into an f32 scratch
// by a bulk reduce-add in key-tile order, ordered by a counter per query
// tile that counts the parts added

// waits until the counter reads at least `want` (acquire: the adds it
// counts are visible after); a wait that never ends traps
__device__ __forceinline__ void wait_count(const int* ctr, int want) {
  for (uint32_t tries = 0;; ++tries) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(ctr) : "memory");
    if (v >= want) return;
    if (tries == (1u << 24)) __trap();
  }
}

// this thread's bulk add is complete: one more on the counter (release)
__device__ __forceinline__ void release_count(int* ctr) {
  asm volatile(
      "cp.async.bulk.wait_group 0;\n fence.proxy.async.global;\n fence.acq_rel.gpu;\n"
      " red.relaxed.gpu.global.add.s32 [%0], 1;\n" :: "l"(ctr) : "memory");
}

// a warpgroup's 64 x 64 f32 part of dq at (row, col), in floats: rows of 16
// chunks of 4, chunk c at c ^ 2 (row % 4), so that a warp's float2 stores
// of 8 rows take the two passes that 256 bytes need
__device__ __forceinline__ int dq_at(int row, int col) {
  return row * 64 + (((col >> 2) ^ ((row & 3) << 1)) << 2) + (col & 3);
}

// ---- packed int4 weights (biased-lo bytes: B = 16 hi + (lo + 8)) as bf16
// A fragments
__device__ __forceinline__ uint32_t lds16(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

// (a & b) ^ c as one lop3 (C++ with two constants compiles to two)
__device__ __forceinline__ uint32_t and_xor(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// a box row of PB bytes under the PB-byte swizzle: 16-byte chunk c of row
// r sits at chunk c ^ (r % 8) (128 bytes) or c ^ (r / 2 % 4) (64 bytes)
template <int PB>
__device__ __forceinline__ uint32_t swz(int row, int col) {
  const int chunk = PB == 128 ? (col >> 4) ^ (row & 7) : ((col >> 4) ^ (row >> 1)) & 3;
  return row * PB + (chunk << 4) + (col & 15);
}

// a box row of 128 bytes under the 128-byte swizzle (swz<128> for the
// mma.sync kernels): its 16-byte chunks are permuted by the row's index
// within each 1024-byte atom
__device__ __forceinline__ uint32_t sw128(int row, int col) {
  return row * 128 + ((((col >> 4) ^ row) & 7) << 4) + (col & 15);
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}

// ---- packed int4 weights as int8 A fragments of mma.sync m16n8k32
// (moe_decode.cu, dense_int4.cu): four biased-lo packed bytes as int8 words
// of 16 lo and of 16 hi, exactly (B & 0xF0 is 16 hi as a signed byte, and
// ((B << 4) ^ 0x80) & 0xF0 is 16 lo), so x.lo + x.hi over a D-group is one
// int32 sum of two products, 16 G, shifted right by 4 at the group's end
__device__ __forceinline__ uint32_t lo16(uint32_t w) {
  return ((w << 4) ^ 0x80808080u) & 0xF0F0F0F0u;
}
__device__ __forceinline__ uint32_t hi16(uint32_t w) { return w & 0xF0F0F0F0u; }

// c += a (16 x 32 s8, row) . b (32 x 8 s8, col), s32 sums
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the nibbles at bits `shift`..+3 of bytes 0 and 2 of t as the bf16 pair
// (byte 0's, byte 2's): the nibble n = value + 8 (for the high nibble,
// `key` 0x43084308 flips its sign bit; for the low one, 0x43004300) goes
// into the mantissa of 128 (0x4300), and 136 (0x4308) is taken away, all
// exact
__device__ __forceinline__ uint32_t nibbles_bf16(uint32_t t, int shift, uint32_t key) {
  const uint32_t u = and_xor(t >> shift, 0x000F000Fu, key);
  uint32_t v;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(v) : "r"(u), "r"(0x3F803F80u), "r"(0xC308C308u));
  return v;
}

// two packed bytes b0 | b1 << 8 as the bf16 pairs (lo(b0), lo(b1)) and
// (hi(b0), hi(b1)): a prmt, two lop3 and a bf16x2 fma each
__device__ __forceinline__ void unpack2(uint32_t v, uint32_t& lo, uint32_t& hi) {
  const uint32_t t = __byte_perm(v, 0, 0x4140);  // b0 | b1 << 16
  lo = nibbles_bf16(t, 0, 0x43004300u);
  hi = nibbles_bf16(t, 4, 0x43084308u);
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

// A tensor of the given rank (bf16 unless `type` says otherwise) as a
// tensor map, by default with the 128-byte swizzle: dims innermost first,
// strides in bytes of dims 1.., box in elements (box[0] = 64 bf16: one
// swizzled 128-byte row). Elements past a dim's end load as zeros.
__host__ inline bool make_map(CUtensorMap* map, const void* base, int rank,
                              const cuuint64_t* dims, const cuuint64_t* strides,
                              const cuuint32_t* box,
                              CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B,
                              CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// attention's [B, S, H, D] bf16 as the rank-4 map (d, h, s, b), boxes of
// 64 d x 1 x rows x 1 with the 128-byte swizzle, or of `width` (< 64) d
// unswizzled
__host__ inline bool bshd_map(CUtensorMap* map, const void* t, int B, int S, int H, int rows,
                              int D = 128, int width = 64) {
  const cuuint64_t row = 2 * (cuuint64_t)D;  // bytes
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {row, (cuuint64_t)H * row, (cuuint64_t)S * H * row};
  const cuuint32_t box[4] = {(cuuint32_t)width, 1, (cuuint32_t)rows, 1};
  return make_map(map, t, 4, dims, strides, box,
                  width == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace aria
