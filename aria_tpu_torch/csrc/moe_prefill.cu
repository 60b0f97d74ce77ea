// moe_prefill: the segmented grouped GLU-FFN over packed int4 experts for
// prefill-sized token counts, in two kernels.
//
//   glu:  h[r, i] = silu(x[r] . w1g[e, i]) * (x[r] . w1u[e, i])   (bf16 out)
//   down: out[r, :] = (h[r] . w2[e]) * c[e]                        (f32 out)
//
// with e = tile_expert[r / 128]: rows are the routing slots sorted by
// expert into segments padded to 128 rows, so every 128-row tile belongs
// to one expert. Tiles at or past *rows_used hold only padding, whose
// outputs are never gathered; both kernels skip them.
//
// Replaces aria_tpu/ops/moe_prefill_kernel.py:120 moe_prefill_int4 (`_k1_glu`
// :52, `_k2_down` :91). The TPU kernels accumulate over the intermediate
// tile in the output block along a sequential grid axis; here the block
// loops over the whole contraction itself, and reads its own tile_expert
// entry in place of the scalar prefetch.
//
// Weights are the JAX package's bytes: w1q4 [L, E, 2I, D/2] (gate rows,
// then up rows; within-group nibble pairing over D: byte j of D-group g
// holds element g*gs + j in the biased low nibble and g*gs + gs/2 + j in
// the high one) with bf16 scales w1sg [L, E, 8, 2I] (row g = D-group g);
// w2q4 [L, E, I, D/2] whole-row paired over D (byte j holds columns j and
// j + D/2) with the column scale c in every row of w2s8 [L, E, 8, D].
//
// Bound: tensor-core throughput. At a 512-token prompt (6 routed + 2
// shared experts per token) ~72 tiles of 128 rows run per layer, 25.6
// MFLOP per row. Both products are warp-level mma.sync m16n8k16 with bf16
// operands and f32 sums. The int4 values are unpacked in registers into
// bf16, where they are exact, so every product is exact: the TPU kernels'
// identity xa.B + (xb/16 - xa).hi16 - 8 sum(xa) rounds (xb/16 - xa) to
// bf16 and is not reproduced. The contraction order is permuted so that
// one 16-deep k step takes 8 packed bytes: k 0..7 their low nibbles and
// k 8..15 their high ones, against the matching x columns (glu), or the 8
// packed columns feed two output n-tiles, j and j + D/2 (down). Group
// scales are applied per D-group to a separate partial sum, in the TPU
// kernel's order (gate = sum over groups of dot_g * s_g). Operand tiles
// are double-buffered in shared memory with cp.async.

#include "common.cuh"

namespace {

constexpr int TM = 128;     // rows per expert tile
constexpr int THREADS = 256;  // 8 warps: 4 along rows x 2 along columns

// glu: 32 intermediate columns (32 gate + 32 up weight rows) per block,
// 64 packed bytes (128 elements of D) per pipeline stage
constexpr int G_BN = 32;
constexpr int G_BKP = 64;
constexpr int G_XSTRIDE = 2 * G_BKP + 8;  // bf16 elements per staged x row
constexpr int G_WSTRIDE = G_BKP + 16;     // bytes per staged weight row
constexpr int G_STAGE = TM * G_XSTRIDE * 2 + 2 * G_BN * G_WSTRIDE;

// down: 64 packed columns (128 output columns) per block, 64 intermediate
// rows per stage
constexpr int D_BNP = 64;
constexpr int D_BK = 64;
constexpr int D_HSTRIDE = D_BK + 8;    // bf16 elements per staged h row
constexpr int D_WSTRIDE = D_BNP + 16;  // bytes per staged weight row
constexpr int D_STAGE = TM * D_HSTRIDE * 2 + D_BK * D_WSTRIDE;

using aria::cp_async16;
using aria::cp_async_commit;
using aria::cp_async_wait;
using aria::lds32;
using aria::mma_bf16;
using aria::pack_bf16;

__device__ __forceinline__ float lo_nib(int byte) { return (float)((byte & 15) - 8); }
__device__ __forceinline__ float hi_nib(int byte) { return (float)((int)(int8_t)byte >> 4); }

__global__ void __launch_bounds__(THREADS)
glu_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ tile_expert,
           const int* __restrict__ rows_used, const int8_t* __restrict__ w1q4,
           const __nv_bfloat16* __restrict__ w1sg, __nv_bfloat16* __restrict__ h,
           int D, int I, int E, int layer, int gs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tile = blockIdx.y;
  const int row0 = tile * TM;
  if (row0 >= *rows_used) return;
  const int e = tile_expert[tile];
  const int i0 = blockIdx.x * G_BN;
  const int Dp = D / 2, gsp = gs / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;

  const size_t w_expert = ((size_t)layer * E + e) * (size_t)(2 * I);
  const int8_t* w_base = w1q4 + w_expert * Dp;
  const __nv_bfloat16* s_base = w1sg + ((size_t)layer * E + e) * 8 * (size_t)(2 * I);

  const int per_group = gsp / G_BKP;
  const int nchunks = Dp / G_BKP;
  auto stage_x = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem_raw + s * G_STAGE);
  };
  auto stage_w = [&](int s) {
    return reinterpret_cast<uint8_t*>(smem_raw + s * G_STAGE + TM * G_XSTRIDE * 2);
  };
  auto load_chunk = [&](int c, int s) {
    const int grp = c / per_group, j0 = (c % per_group) * G_BKP;
    const int lo_col = grp * gs + j0, hi_col = grp * gs + gsp + j0;
    __nv_bfloat16* xs = stage_x(s);
    // x: 128 rows x (64 low-nibble columns, then 64 high-nibble columns)
    for (int i = threadIdx.x; i < TM * 16; i += THREADS) {
      const int r = i >> 4, q = i & 15;
      const int col = (q < 8 ? lo_col : hi_col) + (q & 7) * 8;
      cp_async16(xs + r * G_XSTRIDE + q * 8, x + (size_t)(row0 + r) * D + col);
    }
    // weights: 32 gate rows then 32 up rows, 64 packed bytes each
    uint8_t* ws = stage_w(s);
    for (int i = threadIdx.x; i < 2 * G_BN * 4; i += THREADS) {
      const int r = i >> 2, q = i & 3;
      const int wrow = r < G_BN ? i0 + r : I + i0 + (r - G_BN);
      cp_async16(ws + r * G_WSTRIDE + q * 16, w_base + (size_t)wrow * Dp + grp * gsp + j0 + q * 16);
    }
    cp_async_commit();
  };

  // n-tiles of the warp: 0, 1 = gate columns, 2, 3 = the same up columns
  float part[2][4][4], tot[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[mi][nj][i] = tot[mi][nj][i] = 0.f;

  load_chunk(0, 0);
  for (int c = 0; c < nchunks; ++c) {
    const int s = c & 1;
    if (c + 1 < nchunks) {
      load_chunk(c + 1, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* xs = stage_x(s);
    const uint8_t* ws = stage_w(s);
#pragma unroll
    for (int ks = 0; ks < G_BKP / 8; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* xr = xs + (wm * 32 + mi * 16 + g8) * G_XSTRIDE + ks * 8 + 2 * t;
        a[mi][0] = lds32(xr);
        a[mi][1] = lds32(xr + 8 * G_XSTRIDE);
        a[mi][2] = lds32(xr + G_BKP);
        a[mi][3] = lds32(xr + 8 * G_XSTRIDE + G_BKP);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int wrow = (nj < 2 ? 0 : G_BN) + wn * 16 + (nj & 1) * 8 + g8;
        const uint16_t pair = *reinterpret_cast<const uint16_t*>(ws + wrow * G_WSTRIDE + ks * 8 + 2 * t);
        const int b0 = pair & 0xff, b1 = pair >> 8;
        const uint32_t blo = pack_bf16(lo_nib(b0), lo_nib(b1));
        const uint32_t bhi = pack_bf16(hi_nib(b0), hi_nib(b1));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_bf16(part[mi][nj], a[mi], blo, bhi);
      }
    }
    if ((c + 1) % per_group == 0) {  // end of a D-group: fold in its scales
      const int grp = c / per_group;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int col = (nj < 2 ? 0 : I) + i0 + wn * 16 + (nj & 1) * 8 + 2 * t;
        const float s0 = aria::bf2f(s_base[(size_t)grp * 2 * I + col]);
        const float s1 = aria::bf2f(s_base[(size_t)grp * 2 * I + col + 1]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          tot[mi][nj][0] += part[mi][nj][0] * s0;
          tot[mi][nj][1] += part[mi][nj][1] * s1;
          tot[mi][nj][2] += part[mi][nj][2] * s0;
          tot[mi][nj][3] += part[mi][nj][3] * s1;
#pragma unroll
          for (int i = 0; i < 4; ++i) part[mi][nj][i] = 0.f;
        }
      }
    }
    __syncthreads();  // this stage is refilled two chunks on
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      const int col = i0 + wn * 16 + nj * 8 + 2 * t;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = row0 + wm * 32 + mi * 16 + g8 + 8 * hr;
        float hv[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float gt = tot[mi][nj][2 * hr + q], up = tot[mi][nj + 2][2 * hr + q];
          hv[q] = (gt * (1.f / (1.f + expf(-gt)))) * up;
        }
        *reinterpret_cast<__nv_bfloat162*>(h + (size_t)row * I + col) =
            __floats2bfloat162_rn(hv[0], hv[1]);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
down_kernel(const __nv_bfloat16* __restrict__ h, const int* __restrict__ tile_expert,
            const int* __restrict__ rows_used, const int8_t* __restrict__ w2q4,
            const __nv_bfloat16* __restrict__ w2s8, float* __restrict__ out,
            int D, int I, int E, int layer) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tile = blockIdx.y;
  const int row0 = tile * TM;
  if (row0 >= *rows_used) return;
  const int e = tile_expert[tile];
  const int j0 = blockIdx.x * D_BNP;
  const int Dp = D / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int8_t* w_base = w2q4 + ((size_t)layer * E + e) * (size_t)I * Dp;

  auto stage_h = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem_raw + s * D_STAGE);
  };
  auto stage_w = [&](int s) {
    return reinterpret_cast<uint8_t*>(smem_raw + s * D_STAGE + TM * D_HSTRIDE * 2);
  };
  auto load_chunk = [&](int c, int s) {
    const int k0 = c * D_BK;
    __nv_bfloat16* hs = stage_h(s);
    for (int i = threadIdx.x; i < TM * (D_BK / 8); i += THREADS) {
      const int r = i / (D_BK / 8), q = i % (D_BK / 8);
      cp_async16(hs + r * D_HSTRIDE + q * 8, h + (size_t)(row0 + r) * I + k0 + q * 8);
    }
    uint8_t* ws = stage_w(s);
    for (int i = threadIdx.x; i < D_BK * (D_BNP / 16); i += THREADS) {
      const int r = i / (D_BNP / 16), q = i % (D_BNP / 16);
      cp_async16(ws + r * D_WSTRIDE + q * 16, w_base + (size_t)(k0 + r) * Dp + j0 + q * 16);
    }
    cp_async_commit();
  };

  // n-tiles 0..3: packed columns j (low nibbles, output j); 4..7: the same
  // bytes' high nibbles (output j + D/2)
  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][nj][i] = 0.f;

  const int nchunks = I / D_BK;
  load_chunk(0, 0);
  for (int c = 0; c < nchunks; ++c) {
    const int s = c & 1;
    if (c + 1 < nchunks) {
      load_chunk(c + 1, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* hs = stage_h(s);
    const uint8_t* ws = stage_w(s);
#pragma unroll
    for (int ks = 0; ks < D_BK / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* hr = hs + (wm * 32 + mi * 16 + g8) * D_HSTRIDE + ks * 16 + 2 * t;
        a[mi][0] = lds32(hr);
        a[mi][1] = lds32(hr + 8 * D_HSTRIDE);
        a[mi][2] = lds32(hr + 8);
        a[mi][3] = lds32(hr + 8 * D_HSTRIDE + 8);
      }
#pragma unroll
      for (int pn = 0; pn < 4; ++pn) {
        const uint8_t* wc = ws + (ks * 16 + 2 * t) * D_WSTRIDE + wn * 32 + pn * 8 + g8;
        const int q0 = wc[0], q1 = wc[D_WSTRIDE], q8 = wc[8 * D_WSTRIDE], q9 = wc[9 * D_WSTRIDE];
        const uint32_t lo0 = pack_bf16(lo_nib(q0), lo_nib(q1));
        const uint32_t lo1 = pack_bf16(lo_nib(q8), lo_nib(q9));
        const uint32_t hi0 = pack_bf16(hi_nib(q0), hi_nib(q1));
        const uint32_t hi1 = pack_bf16(hi_nib(q8), hi_nib(q9));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][pn], a[mi], lo0, lo1);
          mma_bf16(acc[mi][pn + 4], a[mi], hi0, hi1);
        }
      }
    }
    __syncthreads();
  }

  const __nv_bfloat16* c8 = w2s8 + ((size_t)layer * E + e) * 8 * (size_t)D;  // row 0
#pragma unroll
  for (int nj = 0; nj < 8; ++nj) {
    const int col = (nj < 4 ? 0 : Dp) + j0 + wn * 32 + (nj & 3) * 8 + 2 * t;
    const float s0 = aria::bf2f(c8[col]), s1 = aria::bf2f(c8[col + 1]);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = row0 + wm * 32 + mi * 16 + g8 + 8 * hr;
        *reinterpret_cast<float2*>(out + (size_t)row * D + col) =
            make_float2(acc[mi][nj][2 * hr] * s0, acc[mi][nj][2 * hr + 1] * s1);
      }
    }
  }
}

}  // namespace

ARIA_EXPORT int aria_moe_prefill_glu(const void* x_seg, const void* tile_expert,
                                     const void* rows_used, const void* w1q4, const void* w1sg,
                                     void* h, int R, int D, int I, int E, int layer,
                                     void* stream) {
  const int gs = D / aria::int4_group_count(D);
  if (R % TM || (gs / 2) % G_BKP || I % G_BN) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)G_STAGE;
  cudaError_t err = aria::allow_smem(glu_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(I / G_BN, R / TM);
  glu_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x_seg, (const int*)tile_expert, (const int*)rows_used,
      (const int8_t*)w1q4, (const __nv_bfloat16*)w1sg, (__nv_bfloat16*)h, D, I, E, layer, gs);
  return cudaGetLastError();
}

ARIA_EXPORT int aria_moe_prefill_down(const void* h, const void* tile_expert,
                                      const void* rows_used, const void* w2q4, const void* w2s8,
                                      void* out, int R, int D, int I, int E, int layer,
                                      void* stream) {
  if (R % TM || (D / 2) % D_BNP || I % D_BK) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)D_STAGE;
  cudaError_t err = aria::allow_smem(down_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(D / 2 / D_BNP, R / TM);
  down_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)h, (const int*)tile_expert, (const int*)rows_used,
      (const int8_t*)w2q4, (const __nv_bfloat16*)w2s8, (float*)out, D, I, E, layer);
  return cudaGetLastError();
}
