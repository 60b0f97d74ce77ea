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
//
// Both kernels here also have the stats form of the reference
// (`return_stats=True`, decode_attention.py:221-226, :278-289, :311-313),
// which context-parallel decode runs on each rank's block of positions
// (parallel/cp_cache.py): the same loop, with the warps' merge written out
// as f32 (acc, m, s) instead of acc / s in bf16.

#include "common.cuh"

namespace {

constexpr int D = aria::HEAD_DIM;
constexpr int WARPS = 8;
using aria::bf16_round;
using aria::dot_row;
using aria::load4;

template <typename KT>
__global__ void __launch_bounds__(WARPS * 32)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q, const KT* __restrict__ k,
                        const KT* __restrict__ v, const float* __restrict__ ks,
                        const float* __restrict__ vs, const int* __restrict__ lengths,
                        __nv_bfloat16* __restrict__ out, float* __restrict__ acc_out,
                        float* __restrict__ m_out, float* __restrict__ s_out, int B, int H,
                        int S, int layer) {
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
    const size_t o = ((size_t)b * H + h) * D + threadIdx.x;
    if (acc_out != nullptr) {  // the stats form: unnormalised, for a merge
      acc_out[o] = a;
      if (threadIdx.x == 0) {
        m_out[(size_t)b * H + h] = M;
        s_out[(size_t)b * H + h] = tot;
      }
    } else {
      out[o] = __float2bfloat16(a / tot);
    }
  }
}

// ---------------------------------------------------------------------------
// The packed-int4 cache [L, B, H/2, S, 128] int8, head-pair packed with
// biased-lo bytes: head p is the low nibble, lo = (byte & 0xF) - 8, and
// head p + H/2 the high nibble, hi = byte >> 4 (arithmetic shift of the
// signed byte). Scales are bf16 [L, B, H, S].
//
// Replaces `_attend_block_p4` (aria_tpu/ops/decode_attention.py:80) and
// its selection at :234-236. The TPU kernel unpacks on its matrix unit
// through the affine identity lo = byte - (byte & 0xF0) - 8; here the
// nibbles are unpacked in registers and each product q * nibble is exact.
// Bound: the cache read, len*128 bytes per head pair for each of k and v
// (a quarter of a bf16 cache), against ~8 FLOPs per byte: memory-bound.
// One block per (head pair, lane) reads each byte once and serves both
// heads: as above, a warp takes 32 positions, each lane one key row for
// the two scores, then two online softmaxes; for p*v each lane owns 4 of
// the 128 dims of both heads. Numerics as the TPU kernel: scores are
// (q.nibble) in f32 times k_scale, masked at positions >= len; the
// denominator sums the f32 probabilities; p * v_scale rounds to bf16
// before it multiplies v; the output is bf16.

__device__ __forceinline__ void dot_row_p4(const int8_t* kr, const float* qlo, const float* qhi,
                                           float& dlo, float& dhi) {
  dlo = 0.f;
  dhi = 0.f;
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    const uint4 w = reinterpret_cast<const uint4*>(kr)[c];
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int byte = aria::sbyte(ws[i >> 2], i & 3);
      dlo += qlo[c * 16 + i] * (float)((byte & 0xF) - 8);
      dhi += qhi[c * 16 + i] * (float)(byte >> 4);
    }
  }
}

__global__ void __launch_bounds__(WARPS * 32)
decode_attention_p4_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k,
                           const int8_t* __restrict__ v, const __nv_bfloat16* __restrict__ ks,
                           const __nv_bfloat16* __restrict__ vs, const int* __restrict__ lengths,
                           __nv_bfloat16* __restrict__ out, float* __restrict__ acc_out,
                           float* __restrict__ m_out, float* __restrict__ s_out, int B, int Hp,
                           int S, int layer) {
  __shared__ float qs[2][D];
  __shared__ float red_m[2][WARPS], red_s[2][WARPS];
  __shared__ float red_acc[2][WARPS][D];
  const int pair = blockIdx.x, b = blockIdx.y, H = 2 * Hp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = min(lengths[b], S);
  const size_t plane = (((size_t)layer * B + b) * Hp + pair) * S;  // bytes' first row
  const size_t sc_lo = (((size_t)layer * B + b) * H + pair) * S;   // head pair's scales
  const size_t sc_hi = sc_lo + (size_t)Hp * S;                     // head pair + H/2

  {  // threads 0..127 load the low head's query, 128..255 the high head's
    const int sel = threadIdx.x / D, d = threadIdx.x % D;
    qs[sel][d] = aria::bf2f(q[((size_t)b * H + pair + sel * Hp) * D + d]);
  }
  __syncthreads();

  float m[2] = {aria::NEG_INF, aria::NEG_INF}, s[2] = {0.f, 0.f};
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int p0 = warp * 32; p0 < len; p0 += WARPS * 32) {
    const int p = p0 + lane;
    float sc[2] = {aria::NEG_INF, aria::NEG_INF};
    if (p < len) {
      dot_row_p4(k + (plane + p) * D, qs[0], qs[1], sc[0], sc[1]);
      sc[0] *= aria::bf2f(ks[sc_lo + p]);
      sc[1] *= aria::bf2f(ks[sc_hi + p]);
    }
    float pw[2], corr[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const float mn = fmaxf(m[t], aria::warp_max(sc[t]));
      corr[t] = expf(m[t] - mn);
      const float pr = p < len ? expf(sc[t] - mn) : 0.f;
      s[t] = s[t] * corr[t] + aria::warp_sum(pr);
      pw[t] = p < len ? bf16_round(pr * aria::bf2f(vs[(t ? sc_hi : sc_lo) + p])) : 0.f;
      m[t] = mn;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][i] *= corr[t];
    }
    const int nvalid = min(32, len - p0);
    for (int j = 0; j < nvalid; ++j) {
      const float plo = __shfl_sync(aria::FULL_MASK, pw[0], j);
      const float phi = __shfl_sync(aria::FULL_MASK, pw[1], j);
      const uint32_t w = *reinterpret_cast<const uint32_t*>(v + (plane + p0 + j) * D + lane * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int byte = aria::sbyte(w, i);
        acc[0][i] += plo * (float)((byte & 0xF) - 8);
        acc[1][i] += phi * (float)(byte >> 4);
      }
    }
  }

  if (lane == 0) {
    red_m[0][warp] = m[0]; red_s[0][warp] = s[0];
    red_m[1][warp] = m[1]; red_s[1][warp] = s[1];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    red_acc[0][warp][lane * 4 + i] = acc[0][i];
    red_acc[1][warp][lane * 4 + i] = acc[1][i];
  }
  __syncthreads();
  {
    const int sel = threadIdx.x / D, d = threadIdx.x % D;
    float M = aria::NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, red_m[sel][w]);
    float tot = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float e = expf(red_m[sel][w] - M);
      tot += red_s[sel][w] * e;
      a += red_acc[sel][w][d] * e;
    }
    const size_t bh = (size_t)b * H + pair + sel * Hp;
    if (acc_out != nullptr) {  // the stats form: unnormalised, for a merge
      acc_out[bh * D + d] = a;
      if (d == 0) {
        m_out[bh] = M;
        s_out[bh] = tot;
      }
    } else {
      out[bh * D + d] = __float2bfloat16(tot > 0.f ? a / tot : 0.f);
    }
  }
}

}  // namespace

// With acc non-null (the stats form of decode_attention.py:221-226), the
// kernels write the unnormalised accumulator acc [B, H, 128], the running
// max m [B, H] and the denominator s [B, H], all f32, where the normal form
// divides and rounds to bf16 into out. A lane with no position leaves m at
// the finite NEG_INF and acc = s = 0, which a merge's exp(m - m_g) removes.
ARIA_EXPORT int aria_decode_attention_p4(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* lengths, void* out, void* acc, void* m,
                                         void* s, int B, int Hp, int S, int layer,
                                         void* stream) {
  dim3 grid(Hp, B);
  decode_attention_p4_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const int8_t*)k, (const int8_t*)v,
      (const __nv_bfloat16*)k_scale, (const __nv_bfloat16*)v_scale, (const int*)lengths,
      (__nv_bfloat16*)out, (float*)acc, (float*)m, (float*)s, B, Hp, S, layer);
  return cudaGetLastError();
}

ARIA_EXPORT int aria_decode_attention(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale,
                                      const void* lengths, void* out, void* acc, void* m,
                                      void* s, int B, int H, int S, int layer, int quantized,
                                      void* stream) {
  dim3 grid(H, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (quantized) {
    decode_attention_kernel<int8_t><<<grid, WARPS * 32, 0, st>>>(
        (const __nv_bfloat16*)q, (const int8_t*)k, (const int8_t*)v, (const float*)k_scale,
        (const float*)v_scale, (const int*)lengths, (__nv_bfloat16*)out, (float*)acc, (float*)m,
        (float*)s, B, H, S, layer);
  } else {
    decode_attention_kernel<__nv_bfloat16><<<grid, WARPS * 32, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, nullptr,
        nullptr, (const int*)lengths, (__nv_bfloat16*)out, (float*)acc, (float*)m, (float*)s, B,
        H, S, layer);
  }
  return cudaGetLastError();
}
