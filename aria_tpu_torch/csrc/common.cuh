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

// ---- decode attention's per-position math (decode_attention.cu,
// paged_attention.cu): one key row of HEAD_DIM against the f32 query in
// shared memory, and 4 consecutive values of one value row, as f32.
constexpr int HEAD_DIM = 128;

__device__ __forceinline__ float dot_row(const int8_t* kr, const float* qs) {
  float d = 0.f;
#pragma unroll
  for (int c = 0; c < HEAD_DIM / 16; ++c) {
    const uint4 w = reinterpret_cast<const uint4*>(kr)[c];
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) d += qs[c * 16 + i] * (float)sbyte(ws[i >> 2], i & 3);
  }
  return d;
}

__device__ __forceinline__ float dot_row(const __nv_bfloat16* kr, const float* qs) {
  float d = 0.f;
#pragma unroll
  for (int c = 0; c < HEAD_DIM / 8; ++c) {
    const uint4 w = reinterpret_cast<const uint4*>(kr)[c];
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      d += qs[c * 8 + 2 * k] * bf_lo(ws[k]) + qs[c * 8 + 2 * k + 1] * bf_hi(ws[k]);
  }
  return d;
}

__device__ __forceinline__ void load4(const int8_t* p, float* o) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = (float)sbyte(w, i);
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  o[0] = bf_lo(w.x); o[1] = bf_hi(w.x);
  o[2] = bf_lo(w.y); o[3] = bf_hi(w.y);
}

// Set the dynamic shared memory limit when a launch needs more than 48 KB.
template <typename K>
__host__ inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace aria
