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

// Set the dynamic shared memory limit when a launch needs more than 48 KB.
template <typename K>
__host__ inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace aria
