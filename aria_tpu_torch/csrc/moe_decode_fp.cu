// moe_decode (bf16 experts): the fused GLU MoE FFN over the unique active
// experts, for T <= 128 token rows. (The int8 experts' moe_decode_quant is
// moe_decode_bf16x.cu's, over the routed pairs.)
//
// Replaces aria_tpu/ops/moe_decode_kernel.py:389 moe_decode (`_kernel` :102),
// through `_ffn` :81:
//
//   h[u]    = silu(x.w1g[e]) * (x.w1u[e]), rounded to bf16      fp_gateup_kernel
//   part[u] = wd[e, t] * (h[u] . w2[e])                         fp_down_kernel
//   out     = sum of part[u] over u in ascending order, bf16    moe_combine_kernel
//
// e = ids[u] runs over the unique active experts (the wrapper's
// bookkeeping, static size U = min(T*k, E), entries with valid[u] = 0
// skipped). With one intermediate tile (ft = I, as the JAX package picks
// at I = 1664) the TPU grid adds the experts' contributions in ascending
// u: the combine adds them in that order, in f32, from a [U, T, D] buffer,
// so the result does not depend on scheduling.
//
// Weights are the JAX package's layout, out-major: w1 [L, E, 2I, D] (gate
// rows, then up rows), w2 [L, E, I, D]; the whole stack is passed with a
// layer index. Both products are warp-level mma.sync m16n8k16 on bf16
// operands with f32 sums. Token rows are padded to 16, 32, 64 or 128 (MT
// m-tiles, zeros past T); each block streams one expert's weight tile once
// for all rows, through a 3-stage cp.async pipeline.
//
// Bound: the expert weights, 3*I*D elements per active expert (25.6 MB at
// I = 1664, D = 2560), against 2 FLOPs per weight per row: memory-bound at
// T = 1 and still below the bf16 ridge (~295 FLOP/byte) at T = 128.

#include "common.cuh"

namespace {

using aria::cp_async16;
using aria::cp_async_commit;
using aria::cp_async_wait;
using aria::lds32;
using aria::mma_bf16;

constexpr int THREADS = 128;  // 4 warps
constexpr int BK = 64;        // contraction depth per pipeline stage
constexpr int STAGES = 3;
constexpr int XS = BK + 8;    // bf16 elements per staged activation row
constexpr int GU_N = 32;      // intermediate columns per gate/up block, 8 per warp
constexpr int DN_N = 64;      // output columns per down block, 16 per warp

// elements per staged weight row of `cols` weights: 16 bytes of padding
// keep rows 16-byte aligned and the fragment reads free of bank conflicts
__host__ __device__ constexpr int wstride(int cols) { return cols + 8; }

// the bf16 pair (k, k+1) of one weight row, k even
__device__ __forceinline__ uint32_t pair_k(const __nv_bfloat16* p) { return lds32(p); }

// the bf16 pair (rows k, k+1) of one weight column, `stride` apart
__device__ __forceinline__ uint32_t pair_rows(const __nv_bfloat16* p, int stride) {
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + stride);
  return lo | (hi << 16);
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

template <int MT>
__global__ void __launch_bounds__(THREADS)
fp_gateup_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ ids,
                 const int* __restrict__ valid, const __nv_bfloat16* __restrict__ w1,
                 __nv_bfloat16* __restrict__ h, int T, int D, int I, int E, int layer) {
  constexpr int ROWS = MT * 16;
  constexpr int CE = 8;  // weights per 16-byte chunk
  constexpr int WS = wstride(BK);
  constexpr int X_BYTES = ROWS * XS * 2;
  constexpr int STAGE = X_BYTES + 2 * GU_N * WS * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int u = blockIdx.y;
  if (!valid[u]) return;  // block-uniform
  const int e = ids[u];
  const int i0 = blockIdx.x * GU_N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t le = (size_t)layer * E + e;
  const __nv_bfloat16* wbase = w1 + le * (size_t)(2 * I) * D;

  auto xs = [&](int s) { return reinterpret_cast<__nv_bfloat16*>(smem_raw + s * STAGE); };
  auto ws = [&](int s) { return reinterpret_cast<__nv_bfloat16*>(smem_raw + s * STAGE + X_BYTES); };
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
    __nv_bfloat16* wd = ws(s);
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
    const __nv_bfloat16* wt = ws(c % STAGES);
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const __nv_bfloat16* gr = wt + (warp * 8 + g) * WS + ks * 16 + 2 * t;
      const __nv_bfloat16* ur = gr + GU_N * WS;
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
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float hv[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float gt = ag[mi][2 * hr + q], up = au[mi][2 * hr + q];
        hv[q] = (gt * (1.f / (1.f + expf(-gt)))) * up;
      }
      const int row = mi * 16 + g + 8 * hr;
      *reinterpret_cast<__nv_bfloat162*>(h + ((size_t)u * ROWS + row) * I + col) =
          __floats2bfloat162_rn(hv[0], hv[1]);
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(THREADS)
fp_down_kernel(const __nv_bfloat16* __restrict__ h, const int* __restrict__ ids,
               const int* __restrict__ valid, const float* __restrict__ wd,
               const __nv_bfloat16* __restrict__ w2, float* __restrict__ part, int T, int D,
               int I, int E, int layer) {
  constexpr int ROWS = MT * 16;
  constexpr int CE = 8;
  constexpr int WS = wstride(DN_N);
  constexpr int H_BYTES = ROWS * XS * 2;
  constexpr int STAGE = H_BYTES + BK * WS * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int u = blockIdx.y;
  if (!valid[u]) return;
  const int e = ids[u];
  const int j0 = blockIdx.x * DN_N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t le = (size_t)layer * E + e;
  const __nv_bfloat16* hb = h + (size_t)u * ROWS * I;
  const __nv_bfloat16* wbase = w2 + le * (size_t)I * D;

  auto hs = [&](int s) { return reinterpret_cast<__nv_bfloat16*>(smem_raw + s * STAGE); };
  auto ws = [&](int s) { return reinterpret_cast<__nv_bfloat16*>(smem_raw + s * STAGE + H_BYTES); };
  auto load = [&](int c, int s) {
    const int k0 = c * BK;
    __nv_bfloat16* hd = hs(s);
    for (int i = threadIdx.x; i < ROWS * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), q = i % (BK / 8);
      cp_async16(hd + r * XS + q * 8, hb + (size_t)r * I + k0 + q * 8);
    }
    __nv_bfloat16* wdst = ws(s);  // BK rows of w2 (the contraction), DN_N columns each
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
    const __nv_bfloat16* wt = ws(c % STAGES);
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t b[2][2];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const __nv_bfloat16* p = wt + (ks * 16 + 2 * t) * WS + warp * 16 + nj * 8 + g;
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

#pragma unroll
  for (int nj = 0; nj < 2; ++nj) {
    const int col = j0 + warp * 16 + nj * 8 + 2 * t;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = mi * 16 + g + 8 * hr;
        if (row >= T) continue;
        const float p0 = acc[mi][nj][2 * hr], p1 = acc[mi][nj][2 * hr + 1];
        const float wv = wd[(size_t)e * T + row];
        *reinterpret_cast<float2*>(part + ((size_t)u * T + row) * D + col) =
            make_float2(wv * p0, wv * p1);
      }
    }
  }
}

// out = the sum of the valid experts' parts [U, T*D] in u order, in f32,
// cast to bf16: a fixed order, so the result does not depend on scheduling
__global__ void moe_combine_kernel(const float* __restrict__ part, const int* __restrict__ valid,
                                   __nv_bfloat16* __restrict__ out, int TD, int U) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= TD) return;
  float acc = 0.f;
  for (int u = 0; u < U; ++u)
    if (valid[u]) acc += part[(size_t)u * TD + idx];
  out[idx] = __float2bfloat16(acc);
}

template <int MT>
cudaError_t run(const void* x, const void* ids, const void* valid, const void* wd,
                const void* w1, const void* w2, void* h, void* part, void* out, int T, int D,
                int I, int E, int U, int layer, cudaStream_t st) {
  constexpr int ROWS = MT * 16;
  const size_t gu_smem = STAGES * ((size_t)ROWS * XS * 2 + 2 * GU_N * wstride(BK) * 2);
  cudaError_t err = aria::allow_smem(fp_gateup_kernel<MT>, gu_smem);
  if (err != cudaSuccess) return err;
  fp_gateup_kernel<MT><<<dim3(I / GU_N, U), THREADS, gu_smem, st>>>(
      (const __nv_bfloat16*)x, (const int*)ids, (const int*)valid, (const __nv_bfloat16*)w1,
      (__nv_bfloat16*)h, T, D, I, E, layer);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t dn_smem = STAGES * ((size_t)ROWS * XS * 2 + BK * wstride(DN_N) * 2);
  if ((err = aria::allow_smem(fp_down_kernel<MT>, dn_smem)) != cudaSuccess) return err;
  fp_down_kernel<MT><<<dim3(D / DN_N, U), THREADS, dn_smem, st>>>(
      (const __nv_bfloat16*)h, (const int*)ids, (const int*)valid, (const float*)wd,
      (const __nv_bfloat16*)w2, (float*)part, T, D, I, E, layer);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int TD = T * D;
  moe_combine_kernel<<<(TD + 255) / 256, 256, 0, st>>>(
      (const float*)part, (const int*)valid, (__nv_bfloat16*)out, TD, U);
  return cudaGetLastError();
}

}  // namespace

ARIA_EXPORT int aria_moe_decode_bf16(const void* x, const void* ids, const void* valid,
                                     const void* wd, const void* w1, const void* w2, void* h,
                                     void* part, void* out, int T, int D, int I, int E, int U,
                                     int layer, void* stream) {
  if (T < 1 || T > 128 || D % BK || D % DN_N || I % BK || I % GU_N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // h holds T rounded up to 16, 32, 64 or 128 rows (the wrapper's rule)
  if (T <= 16) return run<1>(x, ids, valid, wd, w1, w2, h, part, out, T, D, I, E, U, layer, st);
  if (T <= 32) return run<2>(x, ids, valid, wd, w1, w2, h, part, out, T, D, I, E, U, layer, st);
  if (T <= 64) return run<4>(x, ids, valid, wd, w1, w2, h, part, out, T, D, I, E, U, layer, st);
  return run<8>(x, ids, valid, wd, w1, w2, h, part, out, T, D, I, E, U, layer, st);
}
