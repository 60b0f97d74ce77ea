// The decode MoE's routed (token, expert) pairs, shared by the kernels that
// run each expert on the rows of the tokens that picked it (moe_decode.cu,
// the W4A8 form; moe_decode_bf16x.cu, the bf16-activation forms): the list
// launch, the combine, and the pieces of their TMA rings.
//
// prep_kernel lists the T*k pairs sorted by expert (stable: ascending token
// within an expert; the lists of ops/moe_decode_kernel.py:routed_rows) and
// copies each token's row (int8 with its group scales, or bf16 as it is) and
// combine weight to its pairs' places, so an expert's rows are contiguous and
// come by TMA boxes (TMA cannot gather rows). Its last block writes each
// unique expert's id, flag, first place and count, meta [4][U] (unique_meta's
// ids: slot order at T = 1, else ascending), and, where asked, the work list:
// one entry u | chunk << 16 for every PAIR_CHUNK rows of each unique expert,
// then -1 up to its static length U + ceil(T*k / PAIR_CHUNK), so a grid over
// the list runs each expert on its rows and no block on padding.
//
// combine_kernel adds a token's pair rows [T*k, D] f32 from 0 in the
// reference's order (ascending expert id; slot order at T = 1), so every
// output bit is the reference's: an unrouted row adds 0 * partial there,
// which leaves a finite sum as it is.
#pragma once

#include "hopper.cuh"

namespace {

using aria::smem_u32;

constexpr int PAIR_CHUNK = 16;  // the rows of a work-list entry

using aria::lds128;
using aria::sw128;

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// the ring's stages, its full and empty barriers, then EXTRA bytes of the
// block's scales (read in the epilogues, loaded while the ring fills)
template <int STAGE, int STAGES, int EXTRA>
struct Ring {
  static constexpr int BAR = STAGE * STAGES;
  static constexpr int SCALES = BAR + 16 * STAGES;
  static constexpr int BYTES = SCALES + EXTRA + 1024;  // + slack for the alignment
};

// full barriers (one arrival: the producer's expect_tx) then empty ones (one
// arrival a consumer warp)
template <int STAGES>
__device__ __forceinline__ void init_bars(uint32_t bars, int consumers) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      aria::mbar_init(bars + 8 * s, 1);
      aria::mbar_init(bars + 8 * (STAGES + s), consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// warp 0 of the list block, after meta: the work list (see the top)
__device__ void list_work(const int* meta, int* __restrict__ work, int U, int n) {
  const int lane = threadIdx.x & 31;
  const int W = U + (n + PAIR_CHUNK - 1) / PAIR_CHUNK;
  int run = 0;  // entries so far
  for (int u0 = 0; u0 < U; u0 += 32) {
    const int u = u0 + lane;
    const int c = u < U && meta[U + u] ? (meta[3 * U + u] + PAIR_CHUNK - 1) / PAIR_CHUNK : 0;
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(aria::FULL_MASK, incl, o);
      if (lane >= o) incl += v;
    }
    for (int j = 0; j < c; ++j) work[run + incl - c + j] = u | (j << 16);
    run += __shfl_sync(aria::FULL_MASK, incl, 31);
  }
  for (int j = run + lane; j < W; j += 32) work[j] = -1;
}

// Block t < T: find each of token t's pairs' place in the list sorted by
// expert (the pairs of experts below e, then those of earlier tokens on e)
// and copy its row there: QUANT, the row quantized to int8 per (token,
// D-group) with its scales (act_quant_int8's numerics); else the bf16 row.
// Block T: meta [4][U] and, where `work` is not null, the work list. Each
// phase runs across the block's warps at once.
template <bool QUANT>
__global__ void __launch_bounds__(256)
prep_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ ind,
            const void* __restrict__ wts, int w_bf16, void* __restrict__ xs_out,
            float* __restrict__ sxs, float* __restrict__ wsort, int* __restrict__ pos,
            int* __restrict__ meta, int* __restrict__ work, int T, int k, int D, int ng, int E,
            int U) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float sxl[8];
  const int n = T * k, t = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  int* sind = reinterpret_cast<int*>(smem_raw);  // [n]
  for (int j = threadIdx.x; j < n; j += blockDim.x) sind[j] = ind[j];

  if (t == T) {  // the unique experts
    int* cnt = sind + n;  // [E]
    for (int e = threadIdx.x; e < E; e += blockDim.x) cnt[e] = 0;
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += blockDim.x) atomicAdd(&cnt[sind[j]], 1);
    __syncthreads();
    if (warp != 0) return;
    int* ids = meta;
    int* valid = meta + U;
    int* first = meta + 2 * U;
    int* count = meta + 3 * U;
    if (T == 1) {  // the token's slots in order
      for (int u = lane; u < U; u += 32) {
        const int e = sind[u];
        int below = 0;
        for (int s = 0; s < k; ++s) below += sind[s] < e;
        ids[u] = e, valid[u] = 1, first[u] = below, count[u] = 1;
      }
    } else {
      // present experts ascending, then absent ones flagged invalid: a scan
      // of E, 32 experts at a time
      int present = 0;
      for (int e0 = 0; e0 < E; e0 += 32)
        present += __popc(__ballot_sync(aria::FULL_MASK, e0 + lane < E && cnt[e0 + lane] > 0));
      int up = 0, ua = present, run = 0;  // places so far: present, absent; rows so far
      const unsigned below_me = (1u << lane) - 1;
      for (int e0 = 0; e0 < E; e0 += 32) {
        const int e = e0 + lane, c = e < E ? cnt[e] : 0;
        const unsigned pres = __ballot_sync(aria::FULL_MASK, c > 0);
        const unsigned absent = __ballot_sync(aria::FULL_MASK, e < E && c == 0);
        int incl = c;  // inclusive scan of the counts
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(aria::FULL_MASK, incl, o);
          if (lane >= o) incl += v;
        }
        if (c > 0) {
          const int u = up + __popc(pres & below_me);
          if (u < U) ids[u] = e, valid[u] = 1, first[u] = run + incl - c, count[u] = c;
        } else if (e < E) {
          const int u = ua + __popc(absent & below_me);
          if (u < U) ids[u] = e, valid[u] = 0, first[u] = n, count[u] = 0;
        }
        up += __popc(pres), ua += __popc(absent);
        run += __shfl_sync(aria::FULL_MASK, incl, 31);
      }
    }
    if (work != nullptr) {
      __syncwarp();  // meta's entries, written by the warp's lanes, are visible to all
      list_work(meta, work, U, n);
    }
    return;
  }

  float* xf = reinterpret_cast<float*>(sind + n);  // [D]
  int* place = reinterpret_cast<int*>(xf + D);     // [k]
  if (QUANT)
    for (int i = threadIdx.x; i < D; i += blockDim.x) xf[i] = aria::bf2f(x[(size_t)t * D + i]);
  __syncthreads();
  // each warp: the group amax of groups warp, warp + nw.. (as act_quant_int8
  // computes it), then the places of slots warp, warp + nw..
  const int gs = D / ng;
  for (int g = warp; QUANT && g < 8; g += nw) {
    float a = 0.f;
    for (int i = lane; g < ng && i < gs; i += 32) a = fmaxf(a, fabsf(xf[g * gs + i]));
    a = aria::warp_max(a);
    if (lane == 0) sxl[g] = g < ng ? fmaxf(a * (1.f / 127.f), 1e-8f) : 0.f;
  }
  for (int s = warp; s < k; s += nw) {
    const int e = sind[t * k + s];
    int c = 0;
    for (int j = lane; j < n; j += 32) c += (sind[j] < e) + (sind[j] == e && j < t * k);
    c = aria::warp_sum_int(c);
    if (lane == 0) place[s] = c;
  }
  __syncthreads();
  if constexpr (QUANT) {
    // 16 elements a thread at a time (a group holds whole chunks), stored to
    // every place of the token
    int8_t* xs = reinterpret_cast<int8_t*>(xs_out);
    for (int ch = threadIdx.x; ch < D / 16; ch += blockDim.x) {
      const float sc = sxl[ch * 16 / gs];
      uint32_t wv[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float qv = fminf(fmaxf(rintf(xf[ch * 16 + 4 * v + b] / sc), -127.f), 127.f);
          word |= (uint32_t)(uint8_t)(int8_t)qv << (8 * b);
        }
        wv[v] = word;
      }
      const uint4 q4 = make_uint4(wv[0], wv[1], wv[2], wv[3]);
      for (int s = 0; s < k; ++s) reinterpret_cast<uint4*>(xs + (size_t)place[s] * D)[ch] = q4;
    }
  } else {  // 8 bf16 a thread at a time
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)t * D);
    uint4* xs = reinterpret_cast<uint4*>(xs_out);
    for (int ch = threadIdx.x; ch < D / 8; ch += blockDim.x) {
      const uint4 v = xr[ch];
      for (int s = 0; s < k; ++s) xs[(size_t)place[s] * (D / 8) + ch] = v;
    }
  }
  for (int s = threadIdx.x; s < k; s += blockDim.x) {
    const int p = place[s], j = t * k + s;
    if (QUANT)
      for (int g = 0; g < 8; ++g) sxs[p * 8 + g] = sxl[g];
    wsort[p] = w_bf16 ? aria::bf2f(reinterpret_cast<const __nv_bfloat16*>(wts)[j])
                      : reinterpret_cast<const float*>(wts)[j];
    pos[j] = p;
  }
}

template <bool QUANT>
__host__ cudaError_t launch_prep(const void* x, const void* ind, const void* wts, int w_bf16,
                                 void* xs, void* sxs, void* wsort, void* pos, void* meta,
                                 void* work, int T, int k, int D, int ng, int E, int U,
                                 cudaStream_t st) {
  const size_t smem = 4 * ((size_t)T * k + max(D + k, E));
  cudaError_t err = aria::allow_smem(prep_kernel<QUANT>, smem);
  if (err != cudaSuccess) return err;
  prep_kernel<QUANT><<<T + 1, 256, smem, st>>>(
      (const __nv_bfloat16*)x, (const int*)ind, wts, w_bf16, xs, (float*)sxs, (float*)wsort,
      (int*)pos, (int*)meta, (int*)work, T, k, D, ng, E, U);
  return cudaGetLastError();
}

// out[t] = the sum from 0 of token t's parts in the reference's order:
// ascending expert id (sorted), or slot order (T = 1)
__global__ void combine_kernel(const float* __restrict__ part, const int* __restrict__ ind,
                               const int* __restrict__ pos, __nv_bfloat16* __restrict__ out,
                               int D, int k, int sorted) {
  extern __shared__ int order[];  // [k]: the places of t's pairs, in order
  const int t = blockIdx.y;
  if (threadIdx.x == 0) {
    for (int s = 0; s < k; ++s) {
      const int e = ind[t * k + s];
      int at = s;
      if (sorted) {
        at = 0;
        for (int s2 = 0; s2 < k; ++s2) at += ind[t * k + s2] < e;
      }
      order[at] = pos[t * k + s];
    }
  }
  __syncthreads();
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  float acc = 0.f;
  for (int j = 0; j < k; ++j) acc = __fadd_rn(acc, part[(size_t)order[j] * D + d]);
  out[(size_t)t * D + d] = __float2bfloat16(acc);
}

__host__ inline cudaError_t launch_combine(const void* part, const void* ind, const void* pos,
                                           void* out, int T, int k, int D, cudaStream_t st) {
  combine_kernel<<<dim3((D + 255) / 256, T), 256, 4 * k, st>>>(
      (const float*)part, (const int*)ind, (const int*)pos, (__nv_bfloat16*)out, D, k, T > 1);
  return cudaGetLastError();
}

// [outer][rows][cols] of `type` (element bytes `eb`) as a rank-3 map (or
// rank 2 with outer = 0), boxes of box_cols x box_rows
__host__ inline bool map_rows(CUtensorMap* map, const void* t, int outer, int rows, int cols,
                              int box_cols, int box_rows, CUtensorMapSwizzle swizzle,
                              CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_UINT8,
                              int eb = 1) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * eb, (cuuint64_t)rows * cols * eb};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  return aria::make_map(map, t, outer ? 3 : 2, dims, strides, box, swizzle, type);
}

}  // namespace
