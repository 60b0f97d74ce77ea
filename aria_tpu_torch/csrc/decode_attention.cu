// decode_attention: one query per (lane b, head h) over the stacked cache
// [L, B, H, S, 128] at a layer index, keys at positions < lengths[b].
//
// Replaces aria_tpu/ops/decode_attention.py:208 decode_attention
// (`_make_kernel` :154, `_attend_block` :26) for bf16 and int8 caches. The
// query comes pre-scaled by 1/sqrt(D) and cast to bf16 by the wrapper;
// with an int8 cache the scores are multiplied by k_scale and the
// probabilities by v_scale, per (head, position). Output bf16.
//
// Bound: the cache read, 2*len*128 bytes per head for int8 (5.2 MB per
// layer at 1024 positions and 20 heads) against ~4 FLOPs per byte:
// memory-bound. One block per (h, b) with 8 warps; a warp takes a tile of
// 32 positions, each lane one position's full key row (so the score needs
// no cross-lane reduction), then the warp updates its online softmax once
// per tile and accumulates p*v with each lane owning 4 of the 128 dims
// (coalesced value rows). The 8 warps' (m, s, acc) merge at the end.

#include "common.cuh"

namespace {

constexpr int D = 128;
constexpr int WARPS = 8;

__device__ __forceinline__ float dot_row(const int8_t* kr, const float* qs) {
  float d = 0.f;
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    const uint4 w = reinterpret_cast<const uint4*>(kr)[c];
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) d += qs[c * 16 + i] * (float)aria::sbyte(ws[i >> 2], i & 3);
  }
  return d;
}

__device__ __forceinline__ float dot_row(const __nv_bfloat16* kr, const float* qs) {
  float d = 0.f;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const uint4 w = reinterpret_cast<const uint4*>(kr)[c];
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      d += qs[c * 8 + 2 * k] * aria::bf_lo(ws[k]) + qs[c * 8 + 2 * k + 1] * aria::bf_hi(ws[k]);
  }
  return d;
}

__device__ __forceinline__ void load4(const int8_t* p, float* o) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = (float)aria::sbyte(w, i);
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  o[0] = aria::bf_lo(w.x); o[1] = aria::bf_hi(w.x);
  o[2] = aria::bf_lo(w.y); o[3] = aria::bf_hi(w.y);
}

template <typename KT>
__global__ void __launch_bounds__(WARPS * 32)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q, const KT* __restrict__ k,
                        const KT* __restrict__ v, const float* __restrict__ ks,
                        const float* __restrict__ vs, const int* __restrict__ lengths,
                        __nv_bfloat16* __restrict__ out, int B, int H, int S, int layer) {
  __shared__ float qs[D];
  __shared__ float red_m[WARPS], red_s[WARPS];
  __shared__ float red_acc[WARPS][D];
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = min(lengths[b], S);
  const size_t plane = (((size_t)layer * B + b) * H + h) * S;  // first position's row

  if (threadIdx.x < D) qs[threadIdx.x] = aria::bf2f(q[((size_t)b * H + h) * D + threadIdx.x]);
  __syncthreads();

  float m = aria::NEG_INF, s = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int p0 = warp * 32; p0 < len; p0 += WARPS * 32) {
    const int p = p0 + lane;
    float sc = aria::NEG_INF;
    if (p < len) {
      sc = dot_row(k + (plane + p) * D, qs);
      if (ks != nullptr) sc *= ks[plane + p];
    }
    const float mn = fmaxf(m, aria::warp_max(sc));
    const float corr = expf(m - mn);
    const float pr = p < len ? expf(sc - mn) : 0.f;
    s = s * corr + aria::warp_sum(pr);
    const float pv = (vs != nullptr && p < len) ? pr * vs[plane + p] : pr;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] *= corr;
    const int nvalid = min(32, len - p0);
    for (int j = 0; j < nvalid; ++j) {
      const float pj = __shfl_sync(aria::FULL_MASK, pv, j);
      float val[4];
      load4(v + (plane + p0 + j) * D + lane * 4, val);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += pj * val[i];
    }
    m = mn;
  }

  if (lane == 0) { red_m[warp] = m; red_s[warp] = s; }
#pragma unroll
  for (int i = 0; i < 4; ++i) red_acc[warp][lane * 4 + i] = acc[i];
  __syncthreads();
  if (threadIdx.x < D) {
    float M = aria::NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, red_m[w]);
    float tot = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float e = expf(red_m[w] - M);
      tot += red_s[w] * e;
      a += red_acc[w][threadIdx.x] * e;
    }
    out[((size_t)b * H + h) * D + threadIdx.x] = __float2bfloat16(a / tot);
  }
}

}  // namespace

ARIA_EXPORT int aria_decode_attention(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale,
                                      const void* lengths, void* out, int B, int H, int S,
                                      int layer, int quantized, void* stream) {
  dim3 grid(H, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (quantized) {
    decode_attention_kernel<int8_t><<<grid, WARPS * 32, 0, st>>>(
        (const __nv_bfloat16*)q, (const int8_t*)k, (const int8_t*)v, (const float*)k_scale,
        (const float*)v_scale, (const int*)lengths, (__nv_bfloat16*)out, B, H, S, layer);
  } else {
    decode_attention_kernel<__nv_bfloat16><<<grid, WARPS * 32, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, nullptr,
        nullptr, (const int*)lengths, (__nv_bfloat16*)out, B, H, S, layer);
  }
  return cudaGetLastError();
}
