// flash_causal: causal attention forward over fresh q/k/v [B, S, H, 128]
// bf16 (query i attends keys j <= i), output bf16, online softmax in f32.
//
// Replaces the causal forward of aria_tpu/ops/flash.py:30 flash_sdpa (the
// library Pallas TPU flash_attention at :61-101), as the prefill attends
// the whole prompt bucket: the cache is written but not read.
//
// Bound: FLOPs, 4*S^2*128 per head halved by causality; at the prompt
// buckets of this path (S <= 128) the kernel is latency-bound. Block =
// 8 warps = 8 consecutive query rows of one (b, h); the block stages key
// and value tiles of 32 positions in shared memory (f32, key rows padded
// to 129 words so that lane j reading row j is free of bank conflicts).
// Each lane scores one key of the tile against its warp's query row; the
// warp updates its online softmax once per tile and accumulates p*v with
// lane owning dims lane + 32*i. Any S works: tiles are masked at S and at
// the causal edge. p is rounded to bf16 for p*v and kept in f32 for the
// softmax sum, as in the TPU kernel. Scalar FMA, no tensor cores: speed
// is later work.
//
// With a non-null `lse` the kernel also writes each query row's f32
// log-sum-exp of its scaled scores, lse [B, H, S] = m + log(s), which the
// backward (flash_bwd.cu) recomputes the probabilities from; the output
// is the same with or without it.

#include "common.cuh"

namespace {

constexpr int D = 128;
constexpr int WARPS = 8;  // query rows per block
constexpr int KT = 32;    // key positions per tile
constexpr int KSTRIDE = D + 1;

__global__ void __launch_bounds__(WARPS * 32)
flash_causal_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ lse, int S, int H, float scale) {
  __shared__ float qs[WARPS][D];
  __shared__ float ks[KT * KSTRIDE];
  __shared__ float vs[KT * D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * WARPS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int qi = q0 + warp;
  const size_t row_stride = (size_t)H * D;  // between consecutive positions
  const size_t base = (size_t)b * S * row_stride + (size_t)h * D;

  for (int i = threadIdx.x; i < WARPS * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    qs[r][d] = (q0 + r < S) ? aria::bf2f(q[base + (size_t)(q0 + r) * row_stride + d]) : 0.f;
  }

  float m = aria::NEG_INF, s = 0.f, acc[D / 32];
#pragma unroll
  for (int i = 0; i < D / 32; ++i) acc[i] = 0.f;

  const int last = min(q0 + WARPS, S) - 1;  // the block's last query row
  for (int t0 = 0; t0 <= last; t0 += KT) {
    __syncthreads();  // previous tile consumed (and qs staged)
    for (int i = threadIdx.x; i < KT * D / 8; i += blockDim.x) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const int j = t0 + r;
      uint4 kw = make_uint4(0, 0, 0, 0), vw = make_uint4(0, 0, 0, 0);
      if (j < S) {
        kw = *reinterpret_cast<const uint4*>(k + base + (size_t)j * row_stride + c);
        vw = *reinterpret_cast<const uint4*>(v + base + (size_t)j * row_stride + c);
      }
      const uint32_t kv[4] = {kw.x, kw.y, kw.z, kw.w};
      const uint32_t vv[4] = {vw.x, vw.y, vw.z, vw.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ks[r * KSTRIDE + c + 2 * e] = aria::bf_lo(kv[e]);
        ks[r * KSTRIDE + c + 2 * e + 1] = aria::bf_hi(kv[e]);
        vs[r * D + c + 2 * e] = aria::bf_lo(vv[e]);
        vs[r * D + c + 2 * e + 1] = aria::bf_hi(vv[e]);
      }
    }
    __syncthreads();
    if (qi < S && t0 <= qi) {  // warp-uniform
      const int j = t0 + lane;
      float sc = aria::NEG_INF;
      if (j <= qi) {
        float d = 0.f;
#pragma unroll 16
        for (int e = 0; e < D; ++e) d += qs[warp][e] * ks[lane * KSTRIDE + e];
        sc = d * scale;
      }
      const float mn = fmaxf(m, aria::warp_max(sc));
      const float corr = expf(m - mn);
      const float pr = j <= qi ? expf(sc - mn) : 0.f;
      s = s * corr + aria::warp_sum(pr);
      // p enters p.v rounded to bf16 (the sum s keeps it in f32), as the
      // TPU kernel's dot(p.astype(v.dtype), v) does
      const float pv = __bfloat162float(__float2bfloat16(pr));
#pragma unroll
      for (int i = 0; i < D / 32; ++i) acc[i] *= corr;
      const int nvalid = min(KT, qi - t0 + 1);
      for (int jj = 0; jj < nvalid; ++jj) {
        const float pj = __shfl_sync(aria::FULL_MASK, pv, jj);
#pragma unroll
        for (int i = 0; i < D / 32; ++i) acc[i] += pj * vs[jj * D + lane + 32 * i];
      }
      m = mn;
    }
  }
  if (qi < S) {
#pragma unroll
    for (int i = 0; i < D / 32; ++i)
      out[base + (size_t)qi * row_stride + lane + 32 * i] = __float2bfloat16(acc[i] / s);
    if (lse != nullptr && lane == 0) lse[((size_t)b * H + h) * S + qi] = m + logf(s);
  }
}

}  // namespace

// lse: f32 [B, H, S], or null (serving)
ARIA_EXPORT int aria_flash_causal(const void* q, const void* k, const void* v, void* out,
                                  void* lse, int B, int S, int H, float scale, void* stream) {
  dim3 grid((S + WARPS - 1) / WARPS, H, B);
  flash_causal_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, (float*)lse, S, H, scale);
  return cudaGetLastError();
}
