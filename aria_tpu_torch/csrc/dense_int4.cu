// dense_int4: out[T, F] (f32) = x[T, D] (bf16) @ W[layer], W packed int4.
//
// Replaces aria_tpu/ops/dense_int4.py:124 dense_int4 (`_kernel` :68, the
// bf16-activation variant). W is the out-major stack q4t [L, F, D/2] int8
// (biased-lo bytes, within-group pairing over D: packed column j of D-group
// g holds element g*gs + j in the low nibble and g*gs + gs/2 + j in the
// high one) with bf16 scales sg [L, 8, F], row g = D-group g.
//
// Bound: at decode (T = 1) it is a matvec over F*D/2 bytes of weights
// (9.8 MB for wqkv at D = 2560, F = 7680): memory-bound, 2 FLOPs per
// weight. The design reads each weight row once per block of TM token rows:
// a warp owns an output column, each lane streams 16-byte chunks of the
// row, unpacks the nibbles in registers, and takes its x values from a
// shared-memory copy of the block's token rows; the f32 partial of each
// chunk is scaled by its group's scale, then the warp reduces.

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

}  // namespace

ARIA_EXPORT int aria_dense_int4(const void* x, const void* q4t, const void* sg, void* out,
                                int T, int D, int F, int layer, void* stream) {
  int ng = 1;
  for (int n = 8; n > 1; --n)
    if (D % n == 0 && (D / n) % 256 == 0) { ng = n; break; }
  const int gs = D / ng;
  const size_t smem = (size_t)TM * D * sizeof(__nv_bfloat16);
  cudaError_t err = aria::allow_smem(dense_int4_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((F + WARPS * COLS - 1) / (WARPS * COLS), (T + TM - 1) / TM);
  dense_int4_kernel<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)q4t, (const __nv_bfloat16*)sg, (float*)out,
      T, D, F, layer, gs);
  return cudaGetLastError();
}
