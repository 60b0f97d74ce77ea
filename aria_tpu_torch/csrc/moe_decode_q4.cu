// moe_decode_int4, bf16-activation form: the fused GLU MoE FFN over the
// unique active experts, packed int4 weights, for T <= 128 token rows.
//
// Replaces aria_tpu/ops/moe_decode_kernel.py:450 moe_decode_int4 with
// act_int8=False (`_kernel_q4` :307, `_ffn_q4` :154):
//
//   h[u]    = silu(sum_g (x . w1g[e])_g * sgg[g]) * (sum_g (x . w1u[e])_g * sgu[g]),
//             in f32, rounded to bf16                          q4_gateup_kernel
//   part[u] = wd[e, t] * ((h[u] . w2[e]) * c)                  q4_down_kernel
//   out     = sum of part[u] over u in order, cast to bf16     moe_combine_kernel
//
// e = ids[u] runs over the unique active experts (the wrapper's
// bookkeeping, static size U = min(T*k, E); entries with valid[u] = 0
// skipped): an expert's weights are read once for all T rows. With one
// intermediate tile (ft = I, as the JAX package picks at I = 1664) the TPU
// grid adds the experts' contributions in u order (ascending, or slot
// order at T = 1); the combine adds them in that order, in f32, from a
// [U, T, D] buffer, so the result does not depend on scheduling.
//
// Weights are the JAX package's bytes: w1q4 [L, E, 2I, D/2] (gate rows,
// then up rows; within-group nibble pairing over D: byte j of D-group g
// holds element g*gs + j in the biased low nibble and g*gs + gs/2 + j in
// the high one) with bf16 group scales w1sg [L, E, 8, 2I]; w2q4 [L, E, I,
// D/2] paired over the output axis (byte j holds columns j and j + D/2)
// with the column scale c in every row of w2s8 [L, E, 8, D].
//
// Numerics: the products are exact. The int4 values are unpacked in
// registers into bf16, where they are exact, and both products are
// warp-level mma.sync m16n8k16 with bf16 x (or h) and f32 sums; group
// scales are applied per D-group to a separate partial sum, in the TPU
// kernel's order. `_ffn_q4` instead evaluates xa.B + (xb/16 - xa).hi16 -
// 8 sum(xa) and rounds (xb/16 - xa) to bf16 (ROADMAP queue 3, fault (d));
// that rounding is not reproduced, as csrc/moe_prefill.cu does not.
//
// Bound: the expert weights, 3*I*D/2 bytes per active expert (6.4 MB at
// I = 1664, D = 2560) against 2 FLOPs per weight per row: memory-bound at
// decode. The contraction is permuted so that one 16-deep k step takes 8
// packed bytes (gate/up: k 0..7 their low nibbles, k 8..15 their high
// ones, against the matching x columns; down: the 8 packed columns feed
// two output n-tiles, j and j + D/2). Token rows are padded to 16, 32, 64
// or 128 (MT m-tiles, zeros past T); operand tiles go through a 3-stage
// cp.async pipeline.

#include "moe_combine.cuh"

namespace {

using aria::cp_async16;
using aria::cp_async_commit;
using aria::cp_async_wait;
using aria::lds32;
using aria::mma_bf16;
using aria::pack_bf16;

constexpr int THREADS = 128;  // 4 warps
constexpr int STAGES = 3;
// gate/up: 32 intermediate columns per block (8 per warp), 64 packed bytes
// (128 elements of D) per stage
constexpr int GU_N = 32;
constexpr int GU_BKP = 64;
constexpr int GU_XS = 2 * GU_BKP + 8;  // bf16 elements per staged x row
constexpr int GU_WS = GU_BKP + 16;     // bytes per staged weight row
// down: 32 packed columns (64 outputs) per block (8 per warp), 64
// intermediate rows per stage
constexpr int DN_NP = 32;
constexpr int DN_BK = 64;
constexpr int DN_HS = DN_BK + 8;   // bf16 elements per staged h row
constexpr int DN_WS = DN_NP + 16;  // bytes per staged weight row

__device__ __forceinline__ float lo_nib(int byte) { return (float)((byte & 15) - 8); }
__device__ __forceinline__ float hi_nib(int byte) { return (float)((int)(int8_t)byte >> 4); }

template <int MT>
__global__ void __launch_bounds__(THREADS)
q4_gateup_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ ids,
                 const int* __restrict__ valid, const int8_t* __restrict__ w1q4,
                 const __nv_bfloat16* __restrict__ w1sg, __nv_bfloat16* __restrict__ h,
                 int T, int D, int I, int E, int layer, int gs) {
  constexpr int ROWS = MT * 16;
  constexpr int X_BYTES = ROWS * GU_XS * 2;
  constexpr int STAGE = X_BYTES + 2 * GU_N * GU_WS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int u = blockIdx.y;
  if (!valid[u]) return;  // block-uniform
  const int e = ids[u];
  const int i0 = blockIdx.x * GU_N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t = lane & 3;
  const int Dp = D / 2, gsp = gs / 2;
  const size_t le = (size_t)layer * E + e;
  const int8_t* wbase = w1q4 + le * (size_t)(2 * I) * Dp;
  const __nv_bfloat16* sbase = w1sg + le * 8 * (size_t)(2 * I);
  const int per_group = gsp / GU_BKP;

  auto xs = [&](int s) { return reinterpret_cast<__nv_bfloat16*>(smem_raw + s * STAGE); };
  auto ws = [&](int s) { return reinterpret_cast<uint8_t*>(smem_raw + s * STAGE + X_BYTES); };
  auto load = [&](int c, int s) {
    const int grp = c / per_group, j0 = (c % per_group) * GU_BKP;
    const int lo_col = grp * gs + j0, hi_col = grp * gs + gsp + j0;
    __nv_bfloat16* xd = xs(s);
    // x: ROWS rows x (64 low-nibble columns, then 64 high-nibble columns)
    for (int i = threadIdx.x; i < ROWS * 16; i += THREADS) {
      const int r = i >> 4, q = i & 15;
      __nv_bfloat16* dst = xd + r * GU_XS + q * 8;
      if (r < T)
        cp_async16(dst, x + (size_t)r * D + (q < 8 ? lo_col : hi_col) + (q & 7) * 8);
      else  // rows past T are zeros, so their h is 0
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    // weights: 32 gate rows, then the 32 up rows of the same columns
    uint8_t* wd = ws(s);
    for (int i = threadIdx.x; i < 2 * GU_N * (GU_BKP / 16); i += THREADS) {
      const int r = i / (GU_BKP / 16), q = i % (GU_BKP / 16);
      const int wrow = r < GU_N ? i0 + r : I + i0 + (r - GU_N);
      cp_async16(wd + r * GU_WS + q * 16, wbase + (size_t)wrow * Dp + grp * gsp + j0 + q * 16);
    }
  };

  // [mi][0] gate, [mi][1] up: the group's partial sums, and the totals
  float part[MT][2][4], tot[MT][2][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[mi][n][i] = tot[mi][n][i] = 0.f;

  const int nk = Dp / GU_BKP;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c is in; chunk c - 1's stage is free to refill
    if (c + STAGES - 1 < nk) load(c + STAGES - 1, (c + STAGES - 1) % STAGES);
    cp_async_commit();
    const __nv_bfloat16* xt = xs(c % STAGES);
    const uint8_t* wt = ws(c % STAGES);
#pragma unroll
    for (int ks = 0; ks < GU_BKP / 8; ++ks) {
      uint32_t b[2][2];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int wrow = n * GU_N + warp * 8 + g8;
        const uint16_t pair =
            *reinterpret_cast<const uint16_t*>(wt + wrow * GU_WS + ks * 8 + 2 * t);
        const int b0 = pair & 0xff, b1 = pair >> 8;
        b[n][0] = pack_bf16(lo_nib(b0), lo_nib(b1));
        b[n][1] = pack_bf16(hi_nib(b0), hi_nib(b1));
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const __nv_bfloat16* xr = xt + (mi * 16 + g8) * GU_XS + ks * 8 + 2 * t;
        uint32_t a[4];
        a[0] = lds32(xr);
        a[1] = lds32(xr + 8 * GU_XS);
        a[2] = lds32(xr + GU_BKP);
        a[3] = lds32(xr + 8 * GU_XS + GU_BKP);
        mma_bf16(part[mi][0], a, b[0][0], b[0][1]);
        mma_bf16(part[mi][1], a, b[1][0], b[1][1]);
      }
    }
    if ((c + 1) % per_group == 0) {  // end of a D-group: fold in its scales
      const int grp = c / per_group;
      const int col = i0 + warp * 8 + 2 * t;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const __nv_bfloat16* sr = sbase + (size_t)grp * 2 * I + n * I + col;
        const float s0 = aria::bf2f(sr[0]), s1 = aria::bf2f(sr[1]);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          tot[mi][n][0] += part[mi][n][0] * s0;
          tot[mi][n][1] += part[mi][n][1] * s1;
          tot[mi][n][2] += part[mi][n][2] * s0;
          tot[mi][n][3] += part[mi][n][3] * s1;
#pragma unroll
          for (int i = 0; i < 4; ++i) part[mi][n][i] = 0.f;
        }
      }
    }
  }

  // h = silu(gate) * up in f32, rounded to bf16 for the down product
  const int col = i0 + warp * 8 + 2 * t;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float hv[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float gt = tot[mi][0][2 * hr + q], up = tot[mi][1][2 * hr + q];
        hv[q] = (gt * (1.f / (1.f + expf(-gt)))) * up;
      }
      const int row = mi * 16 + g8 + 8 * hr;
      *reinterpret_cast<__nv_bfloat162*>(h + ((size_t)u * ROWS + row) * I + col) =
          __floats2bfloat162_rn(hv[0], hv[1]);
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(THREADS)
q4_down_kernel(const __nv_bfloat16* __restrict__ h, const int* __restrict__ ids,
               const int* __restrict__ valid, const float* __restrict__ wd,
               const int8_t* __restrict__ w2q4, const __nv_bfloat16* __restrict__ w2s8,
               float* __restrict__ part, int T, int D, int I, int E, int layer) {
  constexpr int ROWS = MT * 16;
  constexpr int H_BYTES = ROWS * DN_HS * 2;
  constexpr int STAGE = H_BYTES + DN_BK * DN_WS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int u = blockIdx.y;
  if (!valid[u]) return;
  const int e = ids[u];
  const int j0 = blockIdx.x * DN_NP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t = lane & 3;
  const int Dp = D / 2;
  const size_t le = (size_t)layer * E + e;
  const __nv_bfloat16* hb = h + (size_t)u * ROWS * I;
  const int8_t* wbase = w2q4 + le * (size_t)I * Dp;

  auto hs = [&](int s) { return reinterpret_cast<__nv_bfloat16*>(smem_raw + s * STAGE); };
  auto ws = [&](int s) { return reinterpret_cast<uint8_t*>(smem_raw + s * STAGE + H_BYTES); };
  auto load = [&](int c, int s) {
    const int k0 = c * DN_BK;
    __nv_bfloat16* hd = hs(s);
    for (int i = threadIdx.x; i < ROWS * (DN_BK / 8); i += THREADS) {
      const int r = i / (DN_BK / 8), q = i % (DN_BK / 8);
      cp_async16(hd + r * DN_HS + q * 8, hb + (size_t)r * I + k0 + q * 8);
    }
    uint8_t* wdst = ws(s);  // DN_BK rows of w2 (the contraction), DN_NP packed columns
    for (int i = threadIdx.x; i < DN_BK * (DN_NP / 16); i += THREADS) {
      const int r = i / (DN_NP / 16), q = i % (DN_NP / 16);
      cp_async16(wdst + r * DN_WS + q * 16, wbase + (size_t)(k0 + r) * Dp + j0 + q * 16);
    }
  };

  // [mi][0]: the low nibbles (output j), [mi][1]: the high ones (j + D/2)
  float acc[MT][2][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][n][i] = 0.f;

  const int nk = I / DN_BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (c + STAGES - 1 < nk) load(c + STAGES - 1, (c + STAGES - 1) % STAGES);
    cp_async_commit();
    const __nv_bfloat16* ht = hs(c % STAGES);
    const uint8_t* wt = ws(c % STAGES);
#pragma unroll
    for (int ks = 0; ks < DN_BK / 16; ++ks) {
      const uint8_t* wc = wt + (ks * 16 + 2 * t) * DN_WS + warp * 8 + g8;
      const int q0 = wc[0], q1 = wc[DN_WS], q8 = wc[8 * DN_WS], q9 = wc[9 * DN_WS];
      const uint32_t lo0 = pack_bf16(lo_nib(q0), lo_nib(q1));
      const uint32_t lo1 = pack_bf16(lo_nib(q8), lo_nib(q9));
      const uint32_t hi0 = pack_bf16(hi_nib(q0), hi_nib(q1));
      const uint32_t hi1 = pack_bf16(hi_nib(q8), hi_nib(q9));
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const __nv_bfloat16* hr = ht + (mi * 16 + g8) * DN_HS + ks * 16 + 2 * t;
        uint32_t a[4];
        a[0] = lds32(hr);
        a[1] = lds32(hr + 8 * DN_HS);
        a[2] = lds32(hr + 8);
        a[3] = lds32(hr + 8 * DN_HS + 8);
        mma_bf16(acc[mi][0], a, lo0, lo1);
        mma_bf16(acc[mi][1], a, hi0, hi1);
      }
    }
  }

  const __nv_bfloat16* c8 = w2s8 + le * 8 * (size_t)D;  // row 0: the column scales
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int col = n * Dp + j0 + warp * 8 + 2 * t;
    const float s0 = aria::bf2f(c8[col]), s1 = aria::bf2f(c8[col + 1]);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = mi * 16 + g8 + 8 * hr;
        if (row >= T) continue;
        const float wv = wd[(size_t)e * T + row];
        *reinterpret_cast<float2*>(part + ((size_t)u * T + row) * D + col) =
            make_float2(wv * (acc[mi][n][2 * hr] * s0), wv * (acc[mi][n][2 * hr + 1] * s1));
      }
    }
  }
}

template <int MT>
cudaError_t run(const void* x, const void* ids, const void* valid, const void* wd,
                const void* w1q4, const void* w1sg, const void* w2q4, const void* w2s8, void* h,
                void* part, void* out, int T, int D, int I, int E, int U, int layer, int gs,
                cudaStream_t st) {
  constexpr int ROWS = MT * 16;
  const size_t gu_smem = STAGES * ((size_t)ROWS * GU_XS * 2 + 2 * GU_N * GU_WS);
  cudaError_t err = aria::allow_smem(q4_gateup_kernel<MT>, gu_smem);
  if (err != cudaSuccess) return err;
  q4_gateup_kernel<MT><<<dim3(I / GU_N, U), THREADS, gu_smem, st>>>(
      (const __nv_bfloat16*)x, (const int*)ids, (const int*)valid, (const int8_t*)w1q4,
      (const __nv_bfloat16*)w1sg, (__nv_bfloat16*)h, T, D, I, E, layer, gs);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t dn_smem = STAGES * ((size_t)ROWS * DN_HS * 2 + DN_BK * DN_WS);
  if ((err = aria::allow_smem(q4_down_kernel<MT>, dn_smem)) != cudaSuccess) return err;
  q4_down_kernel<MT><<<dim3(D / 2 / DN_NP, U), THREADS, dn_smem, st>>>(
      (const __nv_bfloat16*)h, (const int*)ids, (const int*)valid, (const float*)wd,
      (const int8_t*)w2q4, (const __nv_bfloat16*)w2s8, (float*)part, T, D, I, E, layer);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int TD = T * D;
  moe_combine_kernel<<<(TD + 255) / 256, 256, 0, st>>>(
      (const float*)part, (const int*)valid, (__nv_bfloat16*)out, TD, U);
  return cudaGetLastError();
}

}  // namespace

ARIA_EXPORT int aria_moe_decode_q4(const void* x, const void* ids, const void* valid,
                                   const void* wd, const void* w1q4, const void* w1sg,
                                   const void* w2q4, const void* w2s8, void* h, void* part,
                                   void* out, int T, int D, int I, int E, int U, int layer,
                                   void* stream) {
  const int gs = D / aria::int4_group_count(D);
  if (T < 1 || T > 128 || (gs / 2) % GU_BKP || (D / 2) % DN_NP || I % GU_N || I % DN_BK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // h holds T rounded up to 16, 32, 64 or 128 rows (the wrapper's rule)
  if (T <= 16)
    return run<1>(x, ids, valid, wd, w1q4, w1sg, w2q4, w2s8, h, part, out, T, D, I, E, U, layer, gs, st);
  if (T <= 32)
    return run<2>(x, ids, valid, wd, w1q4, w1sg, w2q4, w2s8, h, part, out, T, D, I, E, U, layer, gs, st);
  if (T <= 64)
    return run<4>(x, ids, valid, wd, w1q4, w1sg, w2q4, w2s8, h, part, out, T, D, I, E, U, layer, gs, st);
  return run<8>(x, ids, valid, wd, w1q4, w1sg, w2q4, w2s8, h, part, out, T, D, I, E, U, layer, gs, st);
}
