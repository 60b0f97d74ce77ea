// expert_dequant: one block of experts [e0, e0 + eb) of a layer's quantized
// expert stack, dequantized to bf16 or f32 in one pass, read in place.
//
// Replaces aria_tpu/models/moe_lm.py:655 _pin_default_layout (the
// pallas_call at :672), fused with the dequantize it feeds (quant.py:179).
// On the TPU the identity copy of each block exists only to stop XLA's
// layout propagation at the block; a block of a contiguous [E, ...] stack
// is a plain view here, so the kernel reads the packed bytes and scales of
// the block where they lie and writes its float weights.
//
// Forms (the block's pointers are passed; e indexes the block):
//   int4, mode 0 (w1): q [eb, R, D/2] nibbles paired within groups of
//     `group` columns (byte j of a group holds column j in its low nibble,
//     biased by +8, and column j + group/2 in its high one), scales
//     sg [eb, 8, R] bf16, row g for group g;
//   int4, mode 1 (w2): the same with one group of D and a scale per column
//     in row 0 of s8 [eb, 8, D] bf16;
//   int8, mode 2 (w1): q [eb, R, D], a f32 scale per row, s [eb, R];
//   int8, mode 3 (w2): q [eb, R, D], a f32 scale per column, s [eb, D].
//
// Arithmetic: value times scale in f32, rounded once to the output type.
// An int4 value times a bf16 scale is exact in f32, so that is the plain
// version's bf16 product (quant.py _deq_compute_dtype); an int8 value
// times an f32 scale is one f32 product, as q.float() * s. Bit-equal.
//
// Bound: bytes. One thread per 16 packed bytes, one 16-byte load; an int4
// thread writes 16 low and 16 high values (two runs of 32 or 64 bytes),
// an int8 thread 16 values; neighbouring threads take neighbouring bytes.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
enum Mode { INT4_ROW_GROUP = 0, INT4_COL = 1, INT8_ROW = 2, INT8_COL = 3 };

template <bool F32>
__device__ __forceinline__ void store16(void* out, size_t at, const float* v) {
  if (F32) {
    float4* o = reinterpret_cast<float4*>(static_cast<float*>(out) + at);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      o[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  } else {
    uint32_t w[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    uint4* o = reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + at);
    o[0] = make_uint4(w[0], w[1], w[2], w[3]);
    o[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// 16 consecutive bf16 scales as f32
__device__ __forceinline__ void load16_bf16(const __nv_bfloat16* p, float* v) {
  const uint4* s = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 u = s[h];
    const uint32_t ws[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[8 * h + 2 * k] = aria::bf_lo(ws[k]);
      v[8 * h + 2 * k + 1] = aria::bf_hi(ws[k]);
    }
  }
}

template <int MODE, bool F32>
__global__ void __launch_bounds__(THREADS)
dequant_int4_kernel(const int8_t* __restrict__ q, const __nv_bfloat16* __restrict__ s,
                    void* __restrict__ out, int R, int D, int group, size_t n_chunks) {
  const size_t t = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n_chunks) return;
  const int per_row = D / 32;  // 16-byte chunks of a packed row of D/2 bytes
  const size_t row = t / per_row;  // e * R + r
  const int p = (int)(t - row * per_row) * 16;
  const int half = group / 2;
  const int g = p / half;
  const int lo_col = g * group + (p - g * half), hi_col = lo_col + half;
  const size_t e = row / R;
  const int r = (int)(row - e * R);
  const uint4 raw = *reinterpret_cast<const uint4*>(q + row * (D / 2) + p);
  const uint32_t ws[4] = {raw.x, raw.y, raw.z, raw.w};
  float lo[16], hi[16];
  if constexpr (MODE == INT4_ROW_GROUP) {
    const float sc = aria::bf2f(s[(e * 8 + g) * R + r]);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int b = aria::sbyte(ws[i >> 2], i & 3);
      lo[i] = (float)((b & 0xF) - 8) * sc;
      hi[i] = (float)(b >> 4) * sc;
    }
  } else {
    float slo[16], shi[16];
    const __nv_bfloat16* srow = s + e * 8 * (size_t)D;  // row 0 of s8
    load16_bf16(srow + lo_col, slo);
    load16_bf16(srow + hi_col, shi);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int b = aria::sbyte(ws[i >> 2], i & 3);
      lo[i] = (float)((b & 0xF) - 8) * slo[i];
      hi[i] = (float)(b >> 4) * shi[i];
    }
  }
  store16<F32>(out, row * D + lo_col, lo);
  store16<F32>(out, row * D + hi_col, hi);
}

template <int MODE, bool F32>
__global__ void __launch_bounds__(THREADS)
dequant_int8_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                    void* __restrict__ out, int R, int D, size_t n_chunks) {
  const size_t t = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n_chunks) return;
  const int per_row = D / 16;
  const size_t row = t / per_row;
  const int c = (int)(t - row * per_row) * 16;
  const uint4 raw = *reinterpret_cast<const uint4*>(q + row * D + c);
  const uint32_t ws[4] = {raw.x, raw.y, raw.z, raw.w};
  float sc[16];
  if constexpr (MODE == INT8_ROW) {
    const float v = s[row];
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = v;
  } else {
    const float4* s4 = reinterpret_cast<const float4*>(s + (row / R) * D + c);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 u = s4[k];
      sc[4 * k] = u.x;
      sc[4 * k + 1] = u.y;
      sc[4 * k + 2] = u.z;
      sc[4 * k + 3] = u.w;
    }
  }
  float v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = (float)aria::sbyte(ws[i >> 2], i & 3) * sc[i];
  store16<F32>(out, row * D + c, v);
}

template <int MODE, bool F32>
cudaError_t launch(const void* q, const void* s, void* out, int eb, int R, int D, int group,
                   cudaStream_t stream) {
  constexpr bool int4 = MODE == INT4_ROW_GROUP || MODE == INT4_COL;
  const size_t n = (size_t)eb * R * (D / (int4 ? 32 : 16));
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  if constexpr (int4) {
    dequant_int4_kernel<MODE, F32><<<blocks, THREADS, 0, stream>>>(
        (const int8_t*)q, (const __nv_bfloat16*)s, out, R, D, group, n);
  } else {
    dequant_int8_kernel<MODE, F32><<<blocks, THREADS, 0, stream>>>(
        (const int8_t*)q, (const float*)s, out, R, D, n);
  }
  return cudaGetLastError();
}

template <bool F32>
cudaError_t dispatch(const void* q, const void* s, void* out, int eb, int R, int D, int group,
                     int mode, cudaStream_t stream) {
  switch (mode) {
    case INT4_ROW_GROUP: return launch<INT4_ROW_GROUP, F32>(q, s, out, eb, R, D, group, stream);
    case INT4_COL: return launch<INT4_COL, F32>(q, s, out, eb, R, D, group, stream);
    case INT8_ROW: return launch<INT8_ROW, F32>(q, s, out, eb, R, D, group, stream);
    case INT8_COL: return launch<INT8_COL, F32>(q, s, out, eb, R, D, group, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

ARIA_EXPORT int aria_expert_dequant(const void* q, const void* s, void* out, int eb, int R, int D,
                                    int group, int mode, int out_f32, void* stream) {
  if (eb <= 0 || R <= 0 || D % 32 || group % 32) return cudaErrorInvalidValue;
  return out_f32 ? dispatch<true>(q, s, out, eb, R, D, group, mode, (cudaStream_t)stream)
                 : dispatch<false>(q, s, out, eb, R, D, group, mode, (cudaStream_t)stream);
}
