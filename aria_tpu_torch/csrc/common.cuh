// Shared helpers for the hand kernels (sm_90a). Plain C entry points: each
// launches on the stream it is given and returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define ARIA_EXPORT extern "C" __attribute__((visibility("default")))

namespace aria {

constexpr unsigned FULL_MASK = 0xffffffffu;
// finite "minus infinity": exp(NEG_INF - m) is 0 for any real m, and a
// block with no valid position never produces inf - inf
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float bf2f(__nv_bfloat16 v) { return __bfloat162float(v); }

// the bf16 in the low / high half of a 32-bit word, as f32 (exact)
__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// signed byte k (0..3) of a 32-bit word
__device__ __forceinline__ int sbyte(uint32_t w, int k) {
  return (int)(int8_t)(uint8_t)(w >> (8 * k));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// ---- decode attention (decode_attention.cu): its head width, and 4
// consecutive values of one bf16 value row as f32
constexpr int HEAD_DIM = 128;

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  o[0] = bf_lo(w.x); o[1] = bf_hi(w.x);
  o[2] = bf_lo(w.y); o[3] = bf_hi(w.y);
}

// ---- warp-level tensor-core products (moe_decode_fp.cu, moe_decode_bf16x.cu
// and others): bf16 operands, f32 sums, operand tiles staged in shared
// memory with cp.async or TMA.

// c[0..3] += a (16x16, row) . b (16x8, col): the fragments of PTX's m16n8k16
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(addr), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two f32 as a bf16 pair (lo in the low half), rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- mbarriers (flash.cu, flash_bwd.cu, gmm.cu, decode_attention.cu):
// completion of TMA and bulk copies into shared memory
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// spins until the phase of the given parity has completed; a wait that
// never ends (a fault in the ring's protocol) traps, so the launch fails
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// the same wait as one PTX loop: with no branch in the C++ code, ptxas does
// not take the wgmma products that follow it for a divergent path (which
// makes it serialize them, C7518)
__device__ __forceinline__ void mbar_wait_loop(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n .reg .u32 n;\n mov.u32 n, 0;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @p bra DONE;\n"
      " add.u32 n, n, 1;\n"
      " setp.lt.u32 p, n, 67108864;\n"
      " @p bra WAIT;\n"
      " trap;\n"
      "DONE:\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// a contiguous copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on the mbarrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// D-groups of the int4 layouts (ops/quant.py int4_group_count): the largest
// n <= 8 that divides D into groups of a multiple of 256, else 1
__host__ inline int int4_group_count(int D) {
  for (int n = 8; n > 1; --n)
    if (D % n == 0 && (D / n) % 256 == 0) return n;
  return 1;
}

// Set the dynamic shared memory limit when a launch needs more than 48 KB.
template <typename K>
__host__ inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace aria
