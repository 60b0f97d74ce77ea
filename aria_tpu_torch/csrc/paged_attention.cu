// paged_decode_attention: one query per (lane b, head h) over the lane's
// pages of a paged cache [L, NP, H, PS, 128] at a layer index, keys at
// logical positions < lengths[b]; logical position p of lane b lives in
// page table[b * MAXP + p / PS], slot p % PS.
//
// Replaces aria_tpu/engine/paged.py:150 paged_decode_attention (`_kernel`
// :117 for bf16 pages, `_kernel_q` :132 for int8 pages with f32 scales,
// both on `_attend_block` of ops/decode_attention.py:26). The TPU grid
// visits all MAXP pages of every lane through the prefetched table and
// masks; here a block visits only the positions below the lane's length,
// capped at MAXP * PS (a lane can run past the table inside a decode
// chunk), so it never reads past the MAXP-th page.
//
// Numerics as the TPU kernel: the query comes pre-scaled by 1/sqrt(D) and
// cast to bf16 by the wrapper; scores are f32 sums of exact products, times
// k_scale for int8 pages; the denominator sums p before v_scale; p (times
// v_scale) rounds to bf16, the TPU's compute dtype, before it multiplies v.
// Output bf16.
//
// Bound: the page reads, 2*len*128 bytes per head for int8 (plus 8 bytes
// of scales per position) against ~4 FLOPs per byte: memory-bound. The
// layout is decode_attention.cu's: one block per (h, b) with 8 warps; a
// warp takes a tile of 32 positions (a page holds whole tiles, PS % 32 ==
// 0, so one table read gives the tile's rows), each lane one position's
// key row, then one online-softmax update per tile and p*v with each lane
// owning 4 of the 128 dims; the warps' (m, s, acc) merge at the end. A
// page id outside the pool is read as masked rather than followed.

#include "common.cuh"

namespace {

constexpr int D = aria::HEAD_DIM;
constexpr int WARPS = 8;
constexpr int TILE = 32;

template <typename KT>
__global__ void __launch_bounds__(WARPS * 32)
paged_decode_attention_kernel(const __nv_bfloat16* __restrict__ q, const KT* __restrict__ k,
                              const KT* __restrict__ v, const float* __restrict__ ks,
                              const float* __restrict__ vs, const int* __restrict__ table,
                              const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
                              int H, int NP, int PS, int MAXP, int layer) {
  __shared__ float qs[D];
  __shared__ float red_m[WARPS], red_s[WARPS];
  __shared__ float red_acc[WARPS][D];
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = min(lengths[b], MAXP * PS);
  const int* pages = table + (size_t)b * MAXP;

  if (threadIdx.x < D) qs[threadIdx.x] = aria::bf2f(q[((size_t)b * H + h) * D + threadIdx.x]);
  __syncthreads();

  float m = aria::NEG_INF, s = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int p0 = warp * TILE; p0 < len; p0 += WARPS * TILE) {
    const int page = pages[p0 / PS];
    if (page < 0 || page >= NP) continue;
    // the tile's first row: (layer, page, head h, slot p0 % PS); the
    // scales share the row index
    const size_t row0 = (((size_t)layer * NP + page) * H + h) * PS + p0 % PS;
    const int p = p0 + lane;
    float sc = aria::NEG_INF;
    if (p < len) {
      sc = aria::dot_row(k + (row0 + lane) * D, qs);
      if (ks != nullptr) sc *= ks[row0 + lane];
    }
    const float mn = fmaxf(m, aria::warp_max(sc));
    const float corr = expf(m - mn);
    const float pr = p < len ? expf(sc - mn) : 0.f;
    s = s * corr + aria::warp_sum(pr);
    const float pv = aria::bf16_round(vs != nullptr && p < len ? pr * vs[row0 + lane] : pr);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] *= corr;
    const int nvalid = min(TILE, len - p0);
    for (int j = 0; j < nvalid; ++j) {
      const float pj = __shfl_sync(aria::FULL_MASK, pv, j);
      float val[4];
      aria::load4(v + (row0 + j) * D + lane * 4, val);
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
    out[((size_t)b * H + h) * D + threadIdx.x] = __float2bfloat16(tot > 0.f ? a / tot : 0.f);
  }
}

}  // namespace

ARIA_EXPORT int aria_paged_decode_attention(const void* q, const void* k, const void* v,
                                            const void* k_scale, const void* v_scale,
                                            const void* table, const void* lengths, void* out,
                                            int B, int H, int NP, int PS, int MAXP, int layer,
                                            int quantized, void* stream) {
  if (PS % TILE != 0) return cudaErrorInvalidValue;
  dim3 grid(H, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (quantized) {
    paged_decode_attention_kernel<int8_t><<<grid, WARPS * 32, 0, st>>>(
        (const __nv_bfloat16*)q, (const int8_t*)k, (const int8_t*)v, (const float*)k_scale,
        (const float*)v_scale, (const int*)table, (const int*)lengths, (__nv_bfloat16*)out, H, NP,
        PS, MAXP, layer);
  } else {
    paged_decode_attention_kernel<__nv_bfloat16><<<grid, WARPS * 32, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, nullptr,
        nullptr, (const int*)table, (const int*)lengths, (__nv_bfloat16*)out, H, NP, PS, MAXP,
        layer);
  }
  return cudaGetLastError();
}
