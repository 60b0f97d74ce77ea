// moe_decode_int4, W4A8 form: the fused GLU MoE FFN over the unique active
// experts, for T <= 128 token rows, plus act_quant_int8.
//
// Replaces aria_tpu/ops/moe_decode_kernel.py:450 moe_decode_int4 with
// act_int8=True (`_kernel_q4_a8` :288, `_ffn_q4_a8` :227) and
// act_quant_int8 (:215):
//
//   xq, sx  = int8 x per (token, D-group)                 act_quant_kernel
//   h[u]    = silu(xq.w1g[e]) * (xq.w1u[e])  in f32       gateup_kernel
//   hq, sh  = int8 h per row over the whole intermediate  hquant_kernel
//   part[u] = wd[e, t] * sh * c[e] * (hq . w2[e])          down_kernel
//   out     = sum over u of part[u], cast to bf16          moe_combine_kernel (moe_combine.cuh)
//
// u runs over the unique active experts (ids/valid from the wrapper's
// bookkeeping, static size U = min(T*k, E)); an expert's weights are read
// once for all T rows. Weights are biased-lo packed int4 (B = 16*hi +
// lo + 8): with int8 activations, dp4a on the masked raw bytes gives exact
// int32 dots, x.lo = dp4a(x, B & 0x0F) - 8*sum(x) and
// x.hi = dp4a(x, B & 0xF0) >> 4, so no nibble is ever shifted out.
//
// Bound: the expert weights, 3*I*D/2 bytes per active expert (6.4 MB at
// I = 1664, D = 2560; 51 MB per layer for the 8 slots of a decode step)
// against ~4 int ops per byte per token row: memory-bound at decode. The
// partial sums go through a [U, T, D] f32 buffer and are added in a fixed
// order, so the result does not depend on scheduling (no atomics).

#include "moe_combine.cuh"

namespace {

constexpr int GU_WARPS = 8;   // gate/up rows per block (one per warp)
constexpr int GU_TT = 16;     // token rows staged at a time
constexpr int GU_MAXCH = 4;   // 16-byte chunks per lane per row: D/2 <= 2048
constexpr int DN_TT = 8;      // token rows per pass of the down projection
constexpr int DN_SLICES = 4;  // warps splitting the intermediate axis

__global__ void act_quant_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ xq,
                                 float* __restrict__ sx, int D, int ng) {
  __shared__ float red[32];
  const int t = blockIdx.x;
  const int gs = D / ng;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int g = 0; g < 8; ++g) {
    if (g >= ng) {
      if (threadIdx.x == 0) sx[t * 8 + g] = 0.f;
      continue;
    }
    const __nv_bfloat16* xr = x + (size_t)t * D + g * gs;
    float a = 0.f;
    for (int i = threadIdx.x; i < gs; i += blockDim.x) a = fmaxf(a, fabsf(aria::bf2f(xr[i])));
    a = aria::warp_max(a);
    if (lane == 0) red[warp] = a;
    __syncthreads();
    float amax = 0.f;
    for (int w = 0; w < nw; ++w) amax = fmaxf(amax, red[w]);
    __syncthreads();
    const float sc = fmaxf(amax * (1.f / 127.f), 1e-8f);
    for (int i = threadIdx.x; i < gs; i += blockDim.x) {
      const float qv = fminf(fmaxf(rintf(aria::bf2f(xr[i]) / sc), -127.f), 127.f);
      xq[(size_t)t * D + g * gs + i] = (int8_t)qv;
    }
    if (threadIdx.x == 0) sx[t * 8 + g] = sc;
  }
}

__global__ void __launch_bounds__(GU_WARPS * 32)
gateup_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
              const int* __restrict__ ids, const int* __restrict__ valid,
              const int8_t* __restrict__ w1q4, const __nv_bfloat16* __restrict__ w1sg,
              float* __restrict__ h, int T, int D, int I, int E, int ng, int layer) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* xs = reinterpret_cast<int8_t*>(smem_raw);                  // [GU_TT][D]
  float* sxs = reinterpret_cast<float*>(smem_raw + GU_TT * D);        // [GU_TT][8]
  const int u = blockIdx.y;
  if (!valid[u]) return;  // block-uniform
  const int e = ids[u];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * GU_WARPS + warp;
  const bool rok = r < I;
  const int Dp = D / 2, gs = D / ng, gsp = gs / 2, nch = Dp / 16;
  const size_t ebase = (size_t)layer * E + e;

  uint4 wg[GU_MAXCH], wu[GU_MAXCH];
  float sgg[GU_MAXCH], sgu[GU_MAXCH];
  int grp[GU_MAXCH];
#pragma unroll
  for (int kk = 0; kk < GU_MAXCH; ++kk) {
    const int c = lane + 32 * kk;
    wg[kk] = wu[kk] = make_uint4(0, 0, 0, 0);
    sgg[kk] = sgu[kk] = 0.f;
    grp[kk] = 0;
    if (rok && c < nch) {
      const int g = (c * 16) / gsp;
      grp[kk] = g;
      wg[kk] = *reinterpret_cast<const uint4*>(w1q4 + (ebase * 2 * I + r) * Dp + c * 16);
      wu[kk] = *reinterpret_cast<const uint4*>(w1q4 + (ebase * 2 * I + I + r) * Dp + c * 16);
      sgg[kk] = aria::bf2f(w1sg[(ebase * 8 + g) * 2 * I + r]);
      sgu[kk] = aria::bf2f(w1sg[(ebase * 8 + g) * 2 * I + I + r]);
    }
  }

  for (int t0 = 0; t0 < T; t0 += GU_TT) {
    const int tt = min(GU_TT, T - t0);
    __syncthreads();
    {
      const uint4* src = reinterpret_cast<const uint4*>(xq + (size_t)t0 * D);
      uint4* dst = reinterpret_cast<uint4*>(xs);
      for (int i = threadIdx.x; i < tt * D / 16; i += blockDim.x) dst[i] = src[i];
      for (int i = threadIdx.x; i < tt * 8; i += blockDim.x) sxs[i] = sx[(size_t)t0 * 8 + i];
    }
    __syncthreads();
    for (int t = 0; t < tt; ++t) {
      float ga = 0.f, ua = 0.f;
#pragma unroll
      for (int kk = 0; kk < GU_MAXCH; ++kk) {
        const int c = lane + 32 * kk;
        if (rok && c < nch) {
          const int g = grp[kk];
          const int q0 = c * 16 - g * gsp;
          const uint4 a4 = *reinterpret_cast<const uint4*>(xs + t * D + g * gs + q0);
          const uint4 b4 = *reinterpret_cast<const uint4*>(xs + t * D + g * gs + gsp + q0);
          const int xa[4] = {(int)a4.x, (int)a4.y, (int)a4.z, (int)a4.w};
          const int xb[4] = {(int)b4.x, (int)b4.y, (int)b4.z, (int)b4.w};
          const uint32_t gw[4] = {wg[kk].x, wg[kk].y, wg[kk].z, wg[kk].w};
          const uint32_t uw[4] = {wu[kk].x, wu[kk].y, wu[kk].z, wu[kk].w};
          int sa = 0, dgl = 0, dgh = 0, dul = 0, duh = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            sa = __dp4a(xa[i], 0x01010101, sa);
            dgl = __dp4a(xa[i], (int)(gw[i] & 0x0F0F0F0Fu), dgl);
            dgh = __dp4a(xb[i], (int)(gw[i] & 0xF0F0F0F0u), dgh);
            dul = __dp4a(xa[i], (int)(uw[i] & 0x0F0F0F0Fu), dul);
            duh = __dp4a(xb[i], (int)(uw[i] & 0xF0F0F0F0u), duh);
          }
          const float s = sxs[t * 8 + g];
          ga += (float)(dgl - 8 * sa + (dgh >> 4)) * s * sgg[kk];
          ua += (float)(dul - 8 * sa + (duh >> 4)) * s * sgu[kk];
        }
      }
      ga = aria::warp_sum(ga);
      ua = aria::warp_sum(ua);
      if (lane == 0 && rok) {
        const float sig = 1.f / (1.f + expf(-ga));
        h[((size_t)u * T + t0 + t) * I + r] = (ga * sig) * ua;
      }
    }
  }
}

__global__ void hquant_kernel(const float* __restrict__ h, const int* __restrict__ valid,
                              int8_t* __restrict__ hq, float* __restrict__ sh,
                              int* __restrict__ hsum, int T, int I) {
  __shared__ float redf[32];
  __shared__ int redi[32];
  const int t = blockIdx.x, u = blockIdx.y;
  if (!valid[u]) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const size_t row = (size_t)u * T + t;
  const float* hr = h + row * I;
  float a = 0.f;
  for (int i = threadIdx.x; i < I; i += blockDim.x) a = fmaxf(a, fabsf(hr[i]));
  a = aria::warp_max(a);
  if (lane == 0) redf[warp] = a;
  __syncthreads();
  float amax = 0.f;
  for (int w = 0; w < nw; ++w) amax = fmaxf(amax, redf[w]);
  const float sc = fmaxf(amax * (1.f / 127.f), 1e-8f);
  int sum = 0;
  for (int i = threadIdx.x; i < I; i += blockDim.x) {
    const int qv = (int)fminf(fmaxf(rintf(hr[i] / sc), -127.f), 127.f);
    hq[row * I + i] = (int8_t)qv;
    sum += qv;
  }
  sum = aria::warp_sum_int(sum);
  if (lane == 0) redi[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    int tot = 0;
    for (int w = 0; w < nw; ++w) tot += redi[w];
    hsum[row] = tot;
    sh[row] = sc;
  }
}

// 4x4 byte transpose: words a..d hold rows i..i+3 of 4 packed columns;
// column k's word gets bytes (a_k, b_k, c_k, d_k)
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                           uint32_t* col) {
  const uint32_t t0 = __byte_perm(a, b, 0x5140), t1 = __byte_perm(c, d, 0x5140);
  const uint32_t t2 = __byte_perm(a, b, 0x7362), t3 = __byte_perm(c, d, 0x7362);
  col[0] = __byte_perm(t0, t1, 0x5410);
  col[1] = __byte_perm(t0, t1, 0x7632);
  col[2] = __byte_perm(t2, t3, 0x5410);
  col[3] = __byte_perm(t2, t3, 0x7632);
}

__global__ void __launch_bounds__(DN_SLICES * 32)
down_kernel(const int8_t* __restrict__ hq, const float* __restrict__ sh,
            const int* __restrict__ hsum, const int* __restrict__ ids,
            const int* __restrict__ valid, const float* __restrict__ wd,
            const int8_t* __restrict__ w2q4, const __nv_bfloat16* __restrict__ w2s8,
            float* __restrict__ part, int T, int D, int I, int E, int layer) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* red = reinterpret_cast<int*>(smem_raw);                           // [SL][TT][128][2]
  int8_t* hs = reinterpret_cast<int8_t*>(smem_raw + DN_SLICES * DN_TT * 128 * 2 * sizeof(int));
  const int u = blockIdx.y;
  if (!valid[u]) return;
  const int e = ids[u];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Dp = D / 2;
  const int j0 = blockIdx.x * 128;
  const size_t ebase = (size_t)layer * E + e;
  const int8_t* wbase = w2q4 + ebase * I * Dp + j0 + lane * 4;
  const int nq = I / 4, qps = nq / DN_SLICES;

  for (int t0 = 0; t0 < T; t0 += DN_TT) {
    const int tt = min(DN_TT, T - t0);
    __syncthreads();
    {
      const uint4* src = reinterpret_cast<const uint4*>(hq + ((size_t)u * T + t0) * I);
      uint4* dst = reinterpret_cast<uint4*>(hs);
      for (int i = threadIdx.x; i < tt * I / 16; i += blockDim.x) dst[i] = src[i];
    }
    __syncthreads();
    int alo[DN_TT][4], ahi[DN_TT][4];
#pragma unroll
    for (int t = 0; t < DN_TT; ++t)
#pragma unroll
      for (int k = 0; k < 4; ++k) alo[t][k] = ahi[t][k] = 0;
    for (int qd = warp * qps; qd < (warp + 1) * qps; ++qd) {
      const int i = qd * 4;
      const uint32_t a = *reinterpret_cast<const uint32_t*>(wbase + (size_t)i * Dp);
      const uint32_t b = *reinterpret_cast<const uint32_t*>(wbase + (size_t)(i + 1) * Dp);
      const uint32_t c = *reinterpret_cast<const uint32_t*>(wbase + (size_t)(i + 2) * Dp);
      const uint32_t d = *reinterpret_cast<const uint32_t*>(wbase + (size_t)(i + 3) * Dp);
      uint32_t col[4];
      transpose4(a, b, c, d, col);
      int clo[4], chi[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        clo[k] = (int)(col[k] & 0x0F0F0F0Fu);
        chi[k] = (int)(col[k] & 0xF0F0F0F0u);
      }
#pragma unroll
      for (int t = 0; t < DN_TT; ++t) {
        if (t < tt) {
          const int hv = *reinterpret_cast<const int*>(hs + t * I + i);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            alo[t][k] = __dp4a(hv, clo[k], alo[t][k]);
            ahi[t][k] = __dp4a(hv, chi[k], ahi[t][k]);
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < DN_TT; ++t)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int jj = lane * 4 + k;
        red[((warp * DN_TT + t) * 128 + jj) * 2 + 0] = alo[t][k];
        red[((warp * DN_TT + t) * 128 + jj) * 2 + 1] = ahi[t][k];
      }
    __syncthreads();
    const int jj = threadIdx.x;  // one packed column per thread
    for (int t = 0; t < tt; ++t) {
      int lo = 0, hi = 0;
#pragma unroll
      for (int w = 0; w < DN_SLICES; ++w) {
        lo += red[((w * DN_TT + t) * 128 + jj) * 2 + 0];
        hi += red[((w * DN_TT + t) * 128 + jj) * 2 + 1];
      }
      const size_t row = (size_t)u * T + t0 + t;
      const float s = sh[row];
      const float wv = wd[(size_t)e * T + t0 + t];
      const int dlo = j0 + jj, dhi = j0 + jj + Dp;
      const float clo_s = aria::bf2f(w2s8[ebase * 8 * D + dlo]);
      const float chi_s = aria::bf2f(w2s8[ebase * 8 * D + dhi]);
      part[row * D + dlo] = (float)(lo - 8 * hsum[row]) * s * clo_s * wv;
      part[row * D + dhi] = (float)(hi >> 4) * s * chi_s * wv;
    }
  }
}

}  // namespace

ARIA_EXPORT int aria_act_quant_int8(const void* x, void* xq, void* sx, int T, int D, int ng,
                                    void* stream) {
  act_quant_kernel<<<T, 256, 0, (cudaStream_t)stream>>>((const __nv_bfloat16*)x, (int8_t*)xq,
                                                        (float*)sx, D, ng);
  return cudaGetLastError();
}

ARIA_EXPORT int aria_moe_w4a8(const void* xq, const void* sx, const void* ids, const void* valid,
                              const void* wd, const void* w1q4, const void* w1sg,
                              const void* w2q4, const void* w2s8, void* h, void* hq, void* sh,
                              void* hsum, void* part, void* out, int T, int D, int I, int E,
                              int U, int ng, int layer, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t gu_smem = (size_t)GU_TT * D + GU_TT * 8 * sizeof(float);
  cudaError_t err = aria::allow_smem(gateup_kernel, gu_smem);
  if (err != cudaSuccess) return err;
  gateup_kernel<<<dim3((I + GU_WARPS - 1) / GU_WARPS, U), GU_WARPS * 32, gu_smem, st>>>(
      (const int8_t*)xq, (const float*)sx, (const int*)ids, (const int*)valid,
      (const int8_t*)w1q4, (const __nv_bfloat16*)w1sg, (float*)h, T, D, I, E, ng, layer);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  hquant_kernel<<<dim3(T, U), 256, 0, st>>>((const float*)h, (const int*)valid, (int8_t*)hq,
                                            (float*)sh, (int*)hsum, T, I);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t dn_smem = (size_t)DN_SLICES * DN_TT * 128 * 2 * sizeof(int) + (size_t)DN_TT * I;
  if ((err = aria::allow_smem(down_kernel, dn_smem)) != cudaSuccess) return err;
  down_kernel<<<dim3(D / 2 / 128, U), DN_SLICES * 32, dn_smem, st>>>(
      (const int8_t*)hq, (const float*)sh, (const int*)hsum, (const int*)ids, (const int*)valid,
      (const float*)wd, (const int8_t*)w2q4, (const __nv_bfloat16*)w2s8, (float*)part, T, D, I,
      E, layer);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int TD = T * D;
  moe_combine_kernel<<<(TD + 255) / 256, 256, 0, st>>>(
      (const float*)part, (const int*)valid, (__nv_bfloat16*)out, TD, U);
  return cudaGetLastError();
}
