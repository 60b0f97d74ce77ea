// dense_int4: out[T, F] (f32) = x[T, D] @ W[layer], W packed int4, in two
// forms.
//
// dense_int4_kernel replaces aria_tpu/ops/dense_int4.py:124 dense_int4
// (`_kernel` :68, the bf16-activation variant). W is the out-major stack q4t
// [L, F, D/2] int8 (biased-lo bytes, within-group pairing over D: packed
// column j of D-group g holds element g*gs + j in the low nibble and
// g*gs + gs/2 + j in the high one) with bf16 scales sg [L, 8, F], row g =
// D-group g.
//
// Bound: at decode (T = 1) it is a matvec over F*D/2 bytes of weights
// (9.8 MB for wqkv at D = 2560, F = 7680): memory-bound, 2 FLOPs per
// weight. The design reads each weight row once per block of TM token rows:
// a warp owns an output column, each lane streams 16-byte chunks of the
// row, unpacks the nibbles in registers, and takes its x values from a
// shared-memory copy of the block's token rows; the f32 partial of each
// chunk is scaled by its group's scale, then the warp reduces.
//
// dense_int4_a8_kernel replaces the W4A8 variant (`_kernel_a8` :97, the
// act_int8=True branch of :124): x arrives quantized to int8 per (token,
// D-group) with f32 scales sx [T, 8] (aria_act_quant_int8 in
// moe_decode.cu), and
//
//   out[t, f] = sum over D-groups g, ascending, of (G_g[t, f] * sx[t, g]) * sg[g, f]
//
// where G_g is the exact int32 dot of the int8 activations with the int4
// values, taken with dp4a on the masked raw bytes: xa.lo = dp4a(xa, B & 0x0F)
// - 8 sum(xa) and xb.hi = dp4a(xb, B & 0xF0) >> 4 (the TPU kernel's
// xa@B - xa@hi16 - 8 sum(xa) + (xb@hi16 >> 4), the same integers). The
// integer part is exact in any order and the float steps are the TPU
// kernel's, each rounded once (no fused multiply-add), so the result is
// bit-equal to the plain version. Bound: the weight read, as above; each
// packed row is read once for all TA (<= 32) token rows of a block. A
// half-warp owns an output column: each lane takes a 16-byte chunk of a
// group at a time, dp4a against every staged row (the two halves share
// each x load), and a reduce-scatter over the half-warp leaves each row's
// G_g in one lane, which applies the float steps. The 8 sum(xa) term is
// per (row, group) and computed once per block.

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int COLS = 2;  // output columns per warp
constexpr int TM = 8;    // token rows per block

__global__ void __launch_bounds__(WARPS * 32)
dense_int4_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q4t,
                  const __nv_bfloat16* __restrict__ sg, float* __restrict__ out,
                  int T, int D, int F, int layer, int gs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [TM][D]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.y * TM;
  const int tm = min(TM, T - t0);
  const int Dp = D >> 1, gsp = gs >> 1;

  {  // stage the block's token rows (8 bf16 per 16-byte copy)
    const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)t0 * D);
    uint4* dst = reinterpret_cast<uint4*>(xs);
    for (int i = threadIdx.x; i < tm * D / 8; i += blockDim.x) dst[i] = src[i];
  }
  __syncthreads();

  const int nch = Dp / 16;
  for (int cc = 0; cc < COLS; ++cc) {
    const int f = (blockIdx.x * WARPS + warp) * COLS + cc;
    if (f >= F) break;  // warp-uniform
    const int8_t* row = q4t + ((size_t)layer * F + f) * Dp;
    float acc[TM];
#pragma unroll
    for (int t = 0; t < TM; ++t) acc[t] = 0.f;

    for (int c = lane; c < nch; c += 32) {
      const uint4 w = *reinterpret_cast<const uint4*>(row + c * 16);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
      const int p0 = c * 16;
      const int g = p0 / gsp;
      const int q0 = p0 - g * gsp;
      const float s = aria::bf2f(sg[((size_t)layer * 8 + g) * F + f]);
      float lo[16], hi[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int b = aria::sbyte(ws[i >> 2], i & 3);
        lo[i] = (float)((b & 15) - 8);
        hi[i] = (float)(b >> 4);  // arithmetic shift: sign-extends
      }
#pragma unroll
      for (int t = 0; t < TM; ++t) {
        if (t < tm) {
          const uint4* xa = reinterpret_cast<const uint4*>(xs + t * D + g * gs + q0);
          const uint4* xb = reinterpret_cast<const uint4*>(xs + t * D + g * gs + gsp + q0);
          float d = 0.f;
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const uint4 a = xa[v], bb = xb[v];
            const uint32_t av[4] = {a.x, a.y, a.z, a.w};
            const uint32_t bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int i = v * 8 + k * 2;
              d += aria::bf_lo(av[k]) * lo[i] + aria::bf_hi(av[k]) * lo[i + 1];
              d += aria::bf_lo(bv[k]) * hi[i] + aria::bf_hi(bv[k]) * hi[i + 1];
            }
          }
          acc[t] += d * s;
        }
      }
    }
#pragma unroll
    for (int t = 0; t < TM; ++t) {
      const float v = aria::warp_sum(acc[t]);
      if (lane == 0 && t < tm) out[(size_t)(t0 + t) * F + f] = v;
    }
  }
}

// Reduce v[0..N) over the 16 lanes of a half-warp: while more than one
// value is held, a reduce-scatter step halves them (the lane keeps the
// half its OFF bit selects, adding the partner's sums of it); then full
// butterfly sums. Returns the first row the lane holds; it holds
// max(N / 16, 1) consecutive rows in v[0..).
template <int OFF, int H, int N>
__device__ __forceinline__ int reduce_half(int (&v)[N], int lane, int row0) {
  if constexpr (OFF == 0) {
    return row0;
  } else if constexpr (H >= 2) {
    constexpr int h = H / 2;
    const bool up = lane & OFF;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const int send = up ? v[i] : v[i + h];
      const int keep = up ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(aria::FULL_MASK, send, OFF);
    }
    return reduce_half<OFF / 2, h>(v, lane, row0 + (up ? h : 0));
  } else {
    v[0] += __shfl_xor_sync(aria::FULL_MASK, v[0], OFF);
    return reduce_half<OFF / 2, 1>(v, lane, row0);
  }
}

template <int TA>
__global__ void __launch_bounds__(WARPS * 32)
dense_int4_a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                     const int8_t* __restrict__ q4t, const __nv_bfloat16* __restrict__ sg,
                     float* __restrict__ out, int T, int D, int F, int layer, int ng) {
  constexpr int HELD = TA >= 16 ? TA / 16 : 1;  // rows a lane holds after the reduction
  constexpr int DUP = TA >= 16 ? 0 : 16 / TA - 1;  // lane bits that hold copies of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* xs = reinterpret_cast<int8_t*>(smem_raw);                  // [TA][D]
  float* sxs = reinterpret_cast<float*>(smem_raw + (size_t)TA * D);  // [TA][8]
  int* sas = reinterpret_cast<int*>(sxs + TA * 8);                   // [TA][8]: 8 sum(xa)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, hl = lane & 15;
  const int t0 = blockIdx.y * TA;
  const int tm = min(TA, T - t0);
  const int Dp = D >> 1, gs = D / ng, gsp = gs >> 1;

  {  // stage the block's token rows (16 bytes per copy); rows past T are zeros
    const uint4* src = reinterpret_cast<const uint4*>(xq + (size_t)t0 * D);
    uint4* dst = reinterpret_cast<uint4*>(xs);
    for (int i = threadIdx.x; i < TA * D / 16; i += blockDim.x)
      dst[i] = i < tm * D / 16 ? src[i] : make_uint4(0, 0, 0, 0);
    for (int i = threadIdx.x; i < TA * 8; i += blockDim.x)
      sxs[i] = i < tm * 8 ? sx[(size_t)t0 * 8 + i] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TA * ng; i += blockDim.x) {  // the bias of each (row, group)
    const int t = i / ng, g = i % ng;
    const int* xa = reinterpret_cast<const int*>(xs + (size_t)t * D + g * gs);
    int a = 0;
    for (int w = 0; w < gsp / 4; ++w) a = __dp4a(xa[w], 0x01010101, a);
    sas[t * 8 + g] = 8 * a;
  }
  __syncthreads();

  // a half-warp per output column: 16 lanes stream the column's packed row
  // 16 bytes at a time and share each x load with the other half's column
  const int f = (blockIdx.x * WARPS + warp) * 2 + (lane >> 4);
  const bool fok = f < F;
  const int8_t* row = q4t + ((size_t)layer * F + min(f, F - 1)) * Dp;
  float acc[HELD];
#pragma unroll
  for (int i = 0; i < HELD; ++i) acc[i] = 0.f;
  int r0 = 0;
  for (int g = 0; g < ng; ++g) {
    int lo[TA], hi[TA];
#pragma unroll
    for (int t = 0; t < TA; ++t) lo[t] = hi[t] = 0;
    for (int c = hl; c < gsp / 16; c += 16) {
      const uint4 b = *reinterpret_cast<const uint4*>(row + g * gsp + c * 16);
      const uint32_t bw[4] = {b.x, b.y, b.z, b.w};
      int blo[4], bhi[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        blo[k] = (int)(bw[k] & 0x0F0F0F0Fu);
        bhi[k] = (int)(bw[k] & 0xF0F0F0F0u);
      }
#pragma unroll
      for (int t = 0; t < TA; ++t) {
        const int8_t* xr = xs + (size_t)t * D + g * gs + c * 16;
        const uint4 a4 = *reinterpret_cast<const uint4*>(xr);
        const uint4 b4 = *reinterpret_cast<const uint4*>(xr + gsp);
        const int xa[4] = {(int)a4.x, (int)a4.y, (int)a4.z, (int)a4.w};
        const int xb[4] = {(int)b4.x, (int)b4.y, (int)b4.z, (int)b4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          lo[t] = __dp4a(xa[k], blo[k], lo[t]);
          hi[t] = __dp4a(xb[k], bhi[k], hi[t]);
        }
      }
    }
    // xa.lo = xa.(B & 0x0F) - 8 sum(xa); xb.hi = xb.(B & 0xF0) >> 4 (a multiple of 16)
#pragma unroll
    for (int t = 0; t < TA; ++t) lo[t] += hi[t] >> 4;
    r0 = reduce_half<8, TA>(lo, lane, 0);
    const float s = fok ? aria::bf2f(sg[((size_t)layer * 8 + g) * F + f]) : 0.f;
#pragma unroll
    for (int i = 0; i < HELD; ++i) {
      const int t = r0 + i;
      const int G = lo[i] - sas[t * 8 + g];
      acc[i] = __fadd_rn(acc[i], __fmul_rn(__fmul_rn((float)G, sxs[t * 8 + g]), s));
    }
  }
  if (fok && (hl & DUP) == 0) {
#pragma unroll
    for (int i = 0; i < HELD; ++i)
      if (r0 + i < tm) out[(size_t)(t0 + r0 + i) * F + f] = acc[i];
  }
}

template <int TA>
cudaError_t launch_a8(const void* xq, const void* sx, const void* q4t, const void* sg, void* out,
                      int T, int D, int F, int layer, int ng, cudaStream_t st) {
  const size_t smem = (size_t)TA * D + TA * 8 * (sizeof(float) + sizeof(int));
  cudaError_t err = aria::allow_smem(dense_int4_a8_kernel<TA>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((F + WARPS * 2 - 1) / (WARPS * 2), (T + TA - 1) / TA);
  dense_int4_a8_kernel<TA><<<grid, WARPS * 32, smem, st>>>(
      (const int8_t*)xq, (const float*)sx, (const int8_t*)q4t, (const __nv_bfloat16*)sg,
      (float*)out, T, D, F, layer, ng);
  return cudaGetLastError();
}

}  // namespace

ARIA_EXPORT int aria_dense_int4(const void* x, const void* q4t, const void* sg, void* out,
                                int T, int D, int F, int layer, void* stream) {
  const int gs = D / aria::int4_group_count(D);
  const size_t smem = (size_t)TM * D * sizeof(__nv_bfloat16);
  cudaError_t err = aria::allow_smem(dense_int4_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((F + WARPS * COLS - 1) / (WARPS * COLS), (T + TM - 1) / TM);
  dense_int4_kernel<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)q4t, (const __nv_bfloat16*)sg, (float*)out,
      T, D, F, layer, gs);
  return cudaGetLastError();
}

ARIA_EXPORT int aria_dense_int4_a8(const void* xq, const void* sx, const void* q4t,
                                   const void* sg, void* out, int T, int D, int F, int layer,
                                   void* stream) {
  const int ng = aria::int4_group_count(D);
  if (T < 1 || D % 32 || (D / ng / 2) % 16) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (T == 1) return launch_a8<1>(xq, sx, q4t, sg, out, T, D, F, layer, ng, st);
  if (T <= 8) return launch_a8<8>(xq, sx, q4t, sg, out, T, D, F, layer, ng, st);
  return launch_a8<32>(xq, sx, q4t, sg, out, T, D, F, layer, ng, st);
}
