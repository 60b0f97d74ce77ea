// moe_decode (bf16 experts) and moe_decode_quant (int8 experts): the fused
// GLU MoE FFN over the unique active experts, for T <= 128 token rows.
//
// Replaces aria_tpu/ops/moe_decode_kernel.py:389 moe_decode (`_kernel` :102)
// and :503 moe_decode_quant (`_kernel_q` :117), both through `_ffn` :81:
//
//   h[u]    = silu(x.w1g[e] * sg) * (x.w1u[e] * su), rounded to bf16   fp_gateup_kernel
//   part[u] = wd[e, t] * ((h[u] . w2[e]) * s2)                         fp_down_kernel
//   out     = sum of part[u] over u in ascending order, cast to bf16   moe_combine_kernel
//
// e = ids[u] runs over the unique active experts (the wrapper's
// bookkeeping, static size U = min(T*k, E), entries with valid[u] = 0
// skipped); the scales sg, su (row 0 of w1's s8, per row of 2I) and s2
// (row 0 of w2's s8, per column of D) exist for int8 weights only. With
// one intermediate tile (ft = I, as the JAX package picks at I = 1664) the
// TPU grid adds the experts' contributions in ascending u: the combine
// adds them in that order, in f32, from a [U, T, D] buffer, so the result
// does not depend on scheduling.
//
// Weights are the JAX package's layout, out-major: w1 [L, E, 2I, D] (gate
// rows, then up rows), w2 [L, E, I, D]; the whole stack is passed with a
// layer index. Both products are warp-level mma.sync m16n8k16 on bf16
// operands with f32 sums: int8 weights are exact in bf16 and the scale is
// applied after the sum, as `_ffn` does. Token rows are padded to 16, 32,
// 64 or 128 (MT m-tiles, zeros past T); each block streams one expert's
// weight tile once for all rows, through a 3-stage cp.async pipeline.
//
// Bound: the expert weights, 3*I*D elements per active expert (25.6 MB in
// bf16, 12.8 MB in int8 at I = 1664, D = 2560), against 2 FLOPs per weight
// per row: memory-bound at T = 1 and still below the bf16 ridge (~295
// FLOP/byte) at T = 128.

#include "moe_combine.cuh"

namespace {

using aria::cp_async16;
using aria::cp_async_commit;
using aria::cp_async_wait;
using aria::lds32;
using aria::mma_bf16;
using aria::pack_bf16;

constexpr int THREADS = 128;  // 4 warps
constexpr int BK = 64;        // contraction depth per pipeline stage
constexpr int STAGES = 3;
constexpr int XS = BK + 8;    // bf16 elements per staged activation row
constexpr int GU_N = 32;      // intermediate columns per gate/up block, 8 per warp
constexpr int DN_N = 64;      // output columns per down block, 16 per warp

// elements per staged weight row of `cols` weights: 16 bytes of padding
// keep rows 16-byte aligned and the fragment reads free of bank conflicts
template <typename W>
__host__ __device__ constexpr int wstride(int cols) { return cols + 16 / (int)sizeof(W); }

// the bf16 pair (k, k+1) of one weight row, k even
__device__ __forceinline__ uint32_t pair_k(const __nv_bfloat16* p) { return lds32(p); }
__device__ __forceinline__ uint32_t pair_k(const int8_t* p) {
  const uint16_t v = *reinterpret_cast<const uint16_t*>(p);
  return pack_bf16((float)(int8_t)(v & 0xff), (float)(int8_t)(v >> 8));
}

// the bf16 pair (rows k, k+1) of one weight column, `stride` apart
__device__ __forceinline__ uint32_t pair_rows(const __nv_bfloat16* p, int stride) {
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + stride);
  return lo | (hi << 16);
}
__device__ __forceinline__ uint32_t pair_rows(const int8_t* p, int stride) {
  return pack_bf16((float)p[0], (float)p[stride]);
}

// A fragment of m-tile rows r0..r0+15 at depth k0 of a staged bf16 tile
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* tile, int r0, int k0,
                                       int g, int t) {
  const __nv_bfloat16* p = tile + (r0 + g) * XS + k0 + 2 * t;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * XS);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * XS + 8);
}

template <typename W, int MT>
__global__ void __launch_bounds__(THREADS)
fp_gateup_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ ids,
                 const int* __restrict__ valid, const W* __restrict__ w1,
                 const float* __restrict__ s1, __nv_bfloat16* __restrict__ h,
                 int T, int D, int I, int E, int layer) {
  constexpr bool QUANT = sizeof(W) == 1;
  constexpr int ROWS = MT * 16;
  constexpr int CE = 16 / (int)sizeof(W);  // weights per 16-byte chunk
  constexpr int WS = wstride<W>(BK);
  constexpr int X_BYTES = ROWS * XS * 2;
  constexpr int STAGE = X_BYTES + 2 * GU_N * WS * (int)sizeof(W);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int u = blockIdx.y;
  if (!valid[u]) return;  // block-uniform
  const int e = ids[u];
  const int i0 = blockIdx.x * GU_N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t le = (size_t)layer * E + e;
  const W* wbase = w1 + le * (size_t)(2 * I) * D;

  auto xs = [&](int s) { return reinterpret_cast<__nv_bfloat16*>(smem_raw + s * STAGE); };
  auto ws = [&](int s) { return reinterpret_cast<W*>(smem_raw + s * STAGE + X_BYTES); };
  auto load = [&](int c, int s) {
    const int k0 = c * BK;
    __nv_bfloat16* xd = xs(s);
    for (int i = threadIdx.x; i < ROWS * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), q = i % (BK / 8);
      if (r < T)
        cp_async16(xd + r * XS + q * 8, x + (size_t)r * D + k0 + q * 8);
      else  // rows past T are zeros, so their h is 0
        *reinterpret_cast<uint4*>(xd + r * XS + q * 8) = make_uint4(0, 0, 0, 0);
    }
    // 32 gate rows, then the 32 up rows of the same intermediate columns
    W* wd = ws(s);
    for (int i = threadIdx.x; i < 2 * GU_N * (BK / CE); i += THREADS) {
      const int r = i / (BK / CE), q = i % (BK / CE);
      const int wrow = r < GU_N ? i0 + r : I + i0 + (r - GU_N);
      cp_async16(wd + r * WS + q * CE, wbase + (size_t)wrow * D + k0 + q * CE);
    }
  };

  float ag[MT][4], au[MT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int i = 0; i < 4; ++i) ag[mi][i] = au[mi][i] = 0.f;

  const int nk = D / BK;
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
    const W* wt = ws(c % STAGES);
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const W* gr = wt + (warp * 8 + g) * WS + ks * 16 + 2 * t;
      const W* ur = gr + GU_N * WS;
      const uint32_t bg0 = pair_k(gr), bg1 = pair_k(gr + 8);
      const uint32_t bu0 = pair_k(ur), bu1 = pair_k(ur + 8);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        uint32_t a[4];
        load_a(a, xt, mi * 16, ks * 16, g, t);
        mma_bf16(ag[mi], a, bg0, bg1);
        mma_bf16(au[mi], a, bu0, bu1);
      }
    }
  }

  // h = silu(gate) * up in f32, rounded to bf16 for the down product
  const int col = i0 + warp * 8 + 2 * t;
  float sg[2] = {1.f, 1.f}, su[2] = {1.f, 1.f};
  if constexpr (QUANT) {
    const float* sr = s1 + le * 8 * (size_t)(2 * I);  // row 0 of s8
    sg[0] = sr[col], sg[1] = sr[col + 1];
    su[0] = sr[I + col], su[1] = sr[I + col + 1];
  }
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float hv[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float gt = ag[mi][2 * hr + q], up = au[mi][2 * hr + q];
        if constexpr (QUANT) {
          gt *= sg[q];
          up *= su[q];
        }
        hv[q] = (gt * (1.f / (1.f + expf(-gt)))) * up;
      }
      const int row = mi * 16 + g + 8 * hr;
      *reinterpret_cast<__nv_bfloat162*>(h + ((size_t)u * ROWS + row) * I + col) =
          __floats2bfloat162_rn(hv[0], hv[1]);
    }
  }
}

template <typename W, int MT>
__global__ void __launch_bounds__(THREADS)
fp_down_kernel(const __nv_bfloat16* __restrict__ h, const int* __restrict__ ids,
               const int* __restrict__ valid, const float* __restrict__ wd,
               const W* __restrict__ w2, const float* __restrict__ s2,
               float* __restrict__ part, int T, int D, int I, int E, int layer) {
  constexpr bool QUANT = sizeof(W) == 1;
  constexpr int ROWS = MT * 16;
  constexpr int CE = 16 / (int)sizeof(W);
  constexpr int WS = wstride<W>(DN_N);
  constexpr int H_BYTES = ROWS * XS * 2;
  constexpr int STAGE = H_BYTES + BK * WS * (int)sizeof(W);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int u = blockIdx.y;
  if (!valid[u]) return;
  const int e = ids[u];
  const int j0 = blockIdx.x * DN_N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t le = (size_t)layer * E + e;
  const __nv_bfloat16* hb = h + (size_t)u * ROWS * I;
  const W* wbase = w2 + le * (size_t)I * D;

  auto hs = [&](int s) { return reinterpret_cast<__nv_bfloat16*>(smem_raw + s * STAGE); };
  auto ws = [&](int s) { return reinterpret_cast<W*>(smem_raw + s * STAGE + H_BYTES); };
  auto load = [&](int c, int s) {
    const int k0 = c * BK;
    __nv_bfloat16* hd = hs(s);
    for (int i = threadIdx.x; i < ROWS * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), q = i % (BK / 8);
      cp_async16(hd + r * XS + q * 8, hb + (size_t)r * I + k0 + q * 8);
    }
    W* wdst = ws(s);  // BK rows of w2 (the contraction), DN_N columns each
    for (int i = threadIdx.x; i < BK * (DN_N / CE); i += THREADS) {
      const int r = i / (DN_N / CE), q = i % (DN_N / CE);
      cp_async16(wdst + r * WS + q * CE, wbase + (size_t)(k0 + r) * D + j0 + q * CE);
    }
  };

  float acc[MT][2][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][nj][i] = 0.f;

  const int nk = I / BK;
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
    const W* wt = ws(c % STAGES);
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t b[2][2];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const W* p = wt + (ks * 16 + 2 * t) * WS + warp * 16 + nj * 8 + g;
        b[nj][0] = pair_rows(p, WS);
        b[nj][1] = pair_rows(p + 8 * WS, WS);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        uint32_t a[4];
        load_a(a, ht, mi * 16, ks * 16, g, t);
        mma_bf16(acc[mi][0], a, b[0][0], b[0][1]);
        mma_bf16(acc[mi][1], a, b[1][0], b[1][1]);
      }
    }
  }

  const float* s2r = QUANT ? s2 + le * 8 * (size_t)D : nullptr;  // row 0 of s8
#pragma unroll
  for (int nj = 0; nj < 2; ++nj) {
    const int col = j0 + warp * 16 + nj * 8 + 2 * t;
    float sc[2] = {1.f, 1.f};
    if constexpr (QUANT) sc[0] = s2r[col], sc[1] = s2r[col + 1];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = mi * 16 + g + 8 * hr;
        if (row >= T) continue;
        float p0 = acc[mi][nj][2 * hr], p1 = acc[mi][nj][2 * hr + 1];
        if constexpr (QUANT) {
          p0 *= sc[0];
          p1 *= sc[1];
        }
        const float wv = wd[(size_t)e * T + row];
        *reinterpret_cast<float2*>(part + ((size_t)u * T + row) * D + col) =
            make_float2(wv * p0, wv * p1);
      }
    }
  }
}

template <typename W, int MT>
cudaError_t run(const void* x, const void* ids, const void* valid, const void* wd,
                const void* w1, const void* s1, const void* w2, const void* s2, void* h,
                void* part, void* out, int T, int D, int I, int E, int U, int layer,
                cudaStream_t st) {
  constexpr int ROWS = MT * 16;
  const size_t gu_smem =
      STAGES * ((size_t)ROWS * XS * 2 + 2 * GU_N * wstride<W>(BK) * sizeof(W));
  cudaError_t err = aria::allow_smem(fp_gateup_kernel<W, MT>, gu_smem);
  if (err != cudaSuccess) return err;
  fp_gateup_kernel<W, MT><<<dim3(I / GU_N, U), THREADS, gu_smem, st>>>(
      (const __nv_bfloat16*)x, (const int*)ids, (const int*)valid, (const W*)w1,
      (const float*)s1, (__nv_bfloat16*)h, T, D, I, E, layer);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t dn_smem = STAGES * ((size_t)ROWS * XS * 2 + BK * wstride<W>(DN_N) * sizeof(W));
  if ((err = aria::allow_smem(fp_down_kernel<W, MT>, dn_smem)) != cudaSuccess) return err;
  fp_down_kernel<W, MT><<<dim3(D / DN_N, U), THREADS, dn_smem, st>>>(
      (const __nv_bfloat16*)h, (const int*)ids, (const int*)valid, (const float*)wd,
      (const W*)w2, (const float*)s2, (float*)part, T, D, I, E, layer);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int TD = T * D;
  moe_combine_kernel<<<(TD + 255) / 256, 256, 0, st>>>(
      (const float*)part, (const int*)valid, (__nv_bfloat16*)out, TD, U);
  return cudaGetLastError();
}

template <typename W>
int moe_fp(const void* x, const void* ids, const void* valid, const void* wd, const void* w1,
           const void* s1, const void* w2, const void* s2, void* h, void* part, void* out,
           int T, int D, int I, int E, int U, int layer, void* stream) {
  if (T < 1 || T > 128 || D % BK || D % DN_N || I % BK || I % GU_N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // h holds T rounded up to 16, 32, 64 or 128 rows (the wrapper's rule)
  if (T <= 16) return run<W, 1>(x, ids, valid, wd, w1, s1, w2, s2, h, part, out, T, D, I, E, U, layer, st);
  if (T <= 32) return run<W, 2>(x, ids, valid, wd, w1, s1, w2, s2, h, part, out, T, D, I, E, U, layer, st);
  if (T <= 64) return run<W, 4>(x, ids, valid, wd, w1, s1, w2, s2, h, part, out, T, D, I, E, U, layer, st);
  return run<W, 8>(x, ids, valid, wd, w1, s1, w2, s2, h, part, out, T, D, I, E, U, layer, st);
}

}  // namespace

ARIA_EXPORT int aria_moe_decode_bf16(const void* x, const void* ids, const void* valid,
                                     const void* wd, const void* w1, const void* w2, void* h,
                                     void* part, void* out, int T, int D, int I, int E, int U,
                                     int layer, void* stream) {
  return moe_fp<__nv_bfloat16>(x, ids, valid, wd, w1, nullptr, w2, nullptr, h, part, out, T, D,
                               I, E, U, layer, stream);
}

ARIA_EXPORT int aria_moe_decode_int8(const void* x, const void* ids, const void* valid,
                                     const void* wd, const void* w1, const void* s1,
                                     const void* w2, const void* s2, void* h, void* part,
                                     void* out, int T, int D, int I, int E, int U, int layer,
                                     void* stream) {
  return moe_fp<int8_t>(x, ids, valid, wd, w1, s1, w2, s2, h, part, out, T, D, I, E, U, layer,
                        stream);
}
