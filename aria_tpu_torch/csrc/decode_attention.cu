// decode_attention: one query per (lane b, head h) over the stacked cache
// at a layer index, keys at positions < lengths[b]; bf16, int8 and
// packed-int4 caches, each in the normal form (bf16 output) and in the
// stats form of the reference (f32 acc, m, s).
//
// Replaces aria_tpu/ops/decode_attention.py:208 decode_attention
// (`_attend_block` :26 for bf16 and int8 caches [L, B, H, S, 128],
// `_attend_block_p4` :80 for the head-pair packed int4 cache [L, B, H/2, S,
// 128] int8, the stats form of :221-226, :278-289, :311-313). The query
// comes pre-scaled by 1/sqrt(D) and cast to bf16 by the wrapper. With an
// int8 cache the scores are multiplied by k_scale (f32) and the
// probabilities by v_scale; with the int4 cache likewise by bf16 scales,
// where head p is the low nibble, lo = (byte & 0xF) - 8, and head p + H/2
// the high nibble, hi = byte >> 4 (arithmetic shift of the signed byte).
// Numerics as the TPU kernel: the denominator sums the f32 probabilities;
// p (times v_scale with an int8 or int4 cache) rounds to bf16 before it
// multiplies v (decode_attention.py:53: compute_t is the bf16 query's type
// with a bf16 cache); each product q * k is exact in f32.
//
// Bound: the cache read, 2 * len * 128 bytes per head (int8; twice that for
// bf16, per head pair for int4) against about 4 FLOPs per byte:
// memory-bound. The design is about bytes in flight:
//
// - Split over positions. The grid is (H or H/2, B, P); the wrapper picks P
//   from (B, heads, S) and the card's SM count alone (ops/decode_attention.py
//   split_count), never from the lengths on the device. Split i takes the 64-position tiles
//   [i U / P, (i + 1) U / P) of U = ceil(S / 64), so the P chunks cover
//   [0, S) exactly and differ by at most one tile. A block whose chunk
//   starts at or past the lane's length writes the empty partial (m =
//   NEG_INF, acc = s = 0) at once.
// - Loads staged in shared memory. A block (8 warps) walks its chunk in
//   tiles of 32 positions through a ring of 64 KB (4 stages of bf16 rows, 8
//   of int8 or int4, three blocks an SM): one thread brings each tile's key
//   rows, value rows and scales with bulk copies (cp.async.bulk, contiguous
//   in the cache) completing on the stage's mbarrier, up to the end of the
//   chunk; rows past it keep stale bytes that no result reads.
// - Compute. Warp w takes positions 4w..4w+3 of each tile, 8 lanes a
//   position, each lane 16 of the 128 dims (the query in registers), so the
//   8 lanes reading one row hit 8 distinct banks; the score is reduced over
//   the 8 lanes, and the warp keeps its own online softmax, then
//   accumulates p * v with each lane owning 4 dims. The 8 warps' (m, s,
//   acc) merge at the end of the block. Bytes become f32 by a byte permute
//   into the mantissa of 2^23 and one subtraction (exact).
// - Merge. With P > 1 each block writes its partial (acc, m, s) to a
//   workspace the wrapper keeps per device; the block that finishes a (b,
//   head) last (a __threadfence and an atomic counter per (b, head), which
//   it resets to 0) merges the P partials with the exact online-softmax
//   merge in f32, parallel/cp_cache.py's arithmetic: m = max m_i, acc = sum
//   acc_i exp(m_i - m), s = sum s_i exp(m_i - m). One launch per call.
//
// The normal form writes acc / s rounded to bf16 (0 for a lane of length 0);
// the stats form writes f32 acc [B, H, 128], m [B, H] and s [B, H]. A lane
// with no position leaves m at the finite NEG_INF and acc = s = 0, which a
// merge's exp(m - m_g) removes.

#include "common.cuh"

namespace {

constexpr int D = aria::HEAD_DIM;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ALIGN = 64;    // the chunks' boundaries: a multiple of ALIGN positions

enum Kind { BF16 = 0, INT8 = 1, INT4 = 2 };

template <int KIND>
struct Cfg {
  static constexpr int ROW = KIND == BF16 ? 256 : 128;  // bytes of one key or value row
  static constexpr int NH = KIND == INT4 ? 2 : 1;       // heads a block serves
  static constexpr int T = 32;                          // positions per tile
  static constexpr int PPW = T / WARPS;                 // positions per warp in a tile
  static constexpr int LPP = 32 / PPW;                  // lanes per position
  static constexpr int CHUNKS = ROW / 16;               // 16-byte chunks per row
  static constexpr int CPL = CHUNKS / LPP;              // key chunks per lane
  static constexpr int DPC = KIND == BF16 ? 8 : 16;     // dims per chunk
  static constexpr int DPL = CPL * DPC;                 // query dims per lane
  static constexpr int SCB = KIND == BF16 ? 0 : KIND == INT8 ? 4 : 2;  // bytes of a scale
  static constexpr int SC_BYTES = T * SCB;               // one scale array's tile
  static constexpr int NSC = KIND == BF16 ? 0 : 2 * NH;  // scale arrays: k and v per head
  static constexpr int STAGE = T * 2 * ROW + NSC * SC_BYTES;  // key and value rows, scales
  static constexpr int NST = (64 * 1024) / (T * 2 * ROW);  // ring stages: 3 blocks an SM
  static constexpr int SMEM = NST * STAGE;
};

// four signed bytes as f32, exact: byte ^ 0x80 (the byte + 128) in the low
// mantissa bits of 2^23, less 2^23 + 128
__device__ __forceinline__ void s8x4(uint32_t w, float* o) {
  const uint32_t u = w ^ 0x80808080u;
  o[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  o[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  o[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  o[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
}

// four bytes' nibbles as f32, exact: lo = (byte & 0xF) - 8, hi = byte >> 4
// (signed) = ((byte ^ 0x80) >> 4) - 8
__device__ __forceinline__ void nib4(uint32_t w, float* lo, float* hi) {
  const uint32_t l = w & 0x0F0F0F0Fu, h = ((w ^ 0x80808080u) >> 4) & 0x0F0F0F0Fu;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t sel = 0x7440u | i;
    lo[i] = __uint_as_float(__byte_perm(l, 0x4B000000u, sel)) - 8388616.f;
    hi[i] = __uint_as_float(__byte_perm(h, 0x4B000000u, sel)) - 8388616.f;
  }
}

__device__ __forceinline__ uint4 lds128(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <int KIND>
__global__ void __launch_bounds__(THREADS, 3)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k,
                        const uint8_t* __restrict__ v, const void* __restrict__ k_scale,
                        const void* __restrict__ v_scale, const int* __restrict__ lengths,
                        __nv_bfloat16* __restrict__ out, float* __restrict__ acc_out,
                        float* __restrict__ m_out, float* __restrict__ s_out,
                        float* __restrict__ ws, unsigned* __restrict__ counters, int B, int Hx,
                        int S, int layer) {
  using C = Cfg<KIND>;
  constexpr int NH = C::NH, T = C::T, LPP = C::LPP, PPW = C::PPW;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float red_m[NH][WARPS], red_s[NH][WARPS];
  __shared__ unsigned last;
  __shared__ __align__(8) uint64_t full[C::NST];  // a stage's copies have landed

  const int hx = blockIdx.x, b = blockIdx.y, split = blockIdx.z, P = gridDim.z;
  const int H = Hx * NH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, qd = lane % LPP;
  const int U = (S + ALIGN - 1) / ALIGN;
  const int c0 = ALIGN * (int)((long)split * U / P);
  const int c1 = min(min(S, ALIGN * (int)((long)(split + 1) * U / P)), min(lengths[b], S));
  const int ntile = c1 > c0 ? (c1 - c0 + T - 1) / T : 0;
  const size_t plane = (((size_t)layer * B + b) * Hx + hx) * S;  // the first position's row
  // scales [L, B, H, S]: head hx, and for int4 head hx + H/2
  const size_t sc0 = (((size_t)layer * B + b) * H + hx) * S;
  const size_t sc1 = sc0 + (size_t)Hx * S;
  const int r = warp * PPW + lane / LPP;  // this lane's position in a tile

  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  if (threadIdx.x == 0) {
    for (int st = 0; st < C::NST; ++st) aria::mbar_init(aria::smem_u32(&full[st]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // one thread copies a tile's valid rows (and scales) with bulk copies;
  // rows past the chunk's end keep stale bytes, which no result reads
  auto load = [&](int tile) {
    if (threadIdx.x == 0 && tile < ntile) {
      const int st = tile % C::NST, p0 = c0 + tile * T, n = min(T, c1 - p0);
      const uint32_t ks = sbase + st * C::STAGE, vs = ks + T * C::ROW;
      const uint32_t bar = aria::smem_u32(&full[st]);
      const uint32_t rows = n * C::ROW, scb = (n * C::SCB + 15) / 16 * 16;
      aria::mbar_expect_tx(bar, 2 * rows + C::NSC * scb);
      aria::bulk_load(ks, k + (plane + p0) * C::ROW, rows, bar);
      aria::bulk_load(vs, v + (plane + p0) * C::ROW, rows, bar);
#pragma unroll
      for (int a = 0; a < C::NSC; ++a) {  // [k, v] per head, after the rows
        const uint8_t* base = static_cast<const uint8_t*>(a % 2 ? v_scale : k_scale);
        aria::bulk_load(vs + T * C::ROW + a * C::SC_BYTES,
                        base + ((a / 2 ? sc1 : sc0) + p0) * C::SCB, scb, bar);
      }
    }
  };
  auto wait = [&](int tile) {
    aria::mbar_wait(aria::smem_u32(&full[tile % C::NST]), (tile / C::NST) & 1);
  };

#pragma unroll
  for (int i = 0; i < C::NST - 1; ++i) load(i);
  // the query's dims of this lane: key-row chunks qd + LPP * i
  float qr[NH][C::DPL];
#pragma unroll
  for (int t = 0; t < NH; ++t) {
    const __nv_bfloat16* qh = q + ((size_t)b * H + hx + t * Hx) * D;
#pragma unroll
    for (int i = 0; i < C::DPL; ++i)
      qr[t][i] = aria::bf2f(qh[C::DPC * (qd + LPP * (i / C::DPC)) + i % C::DPC]);
  }

  float m[NH], s[NH], acc[NH][4];
#pragma unroll
  for (int t = 0; t < NH; ++t) {
    m[t] = aria::NEG_INF;
    s[t] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  }

  for (int tile = 0; tile < ntile; ++tile) {
    load(tile + C::NST - 1);
    wait(tile);
    const uint8_t* ks = smem + (tile % C::NST) * C::STAGE;
    const uint8_t* vs = ks + T * C::ROW;
    const bool valid = c0 + tile * T + r < c1;
    float sc_[NH][2];  // this position's k and v scales per head
#pragma unroll
    for (int t = 0; t < NH; ++t) {
      sc_[t][0] = sc_[t][1] = 1.f;
      if constexpr (KIND == INT8) {
        const float* sd = reinterpret_cast<const float*>(vs + T * C::ROW);
        sc_[t][0] = sd[r];
        sc_[t][1] = sd[T + r];
      } else if constexpr (KIND == INT4) {
        const __nv_bfloat16* sd = reinterpret_cast<const __nv_bfloat16*>(vs + T * C::ROW);
        sc_[t][0] = aria::bf2f(sd[2 * t * T + r]);
        sc_[t][1] = aria::bf2f(sd[(2 * t + 1) * T + r]);
      }
    }

    float sc[NH];
#pragma unroll
    for (int t = 0; t < NH; ++t) sc[t] = 0.f;
    const uint8_t* kr = ks + r * C::ROW;
#pragma unroll
    for (int i = 0; i < C::CPL; ++i) {
      const uint4 w = lds128(kr + 16 * (qd + LPP * i));
      const uint32_t ws4[4] = {w.x, w.y, w.z, w.w};
      const float* qi = qr[0] + C::DPC * i;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (KIND == BF16) {
          sc[0] += qi[2 * e] * aria::bf_lo(ws4[e]) + qi[2 * e + 1] * aria::bf_hi(ws4[e]);
        } else if constexpr (KIND == INT8) {
          float f[4];
          s8x4(ws4[e], f);
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[0] += qi[4 * e + j] * f[j];
        } else {
          float lo[4], hi[4];
          nib4(ws4[e], lo, hi);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sc[0] += qi[4 * e + j] * lo[j];
            sc[NH - 1] += qr[NH - 1][C::DPC * i + 4 * e + j] * hi[j];
          }
        }
      }
    }
    float pw[NH];
#pragma unroll
    for (int t = 0; t < NH; ++t) {
#pragma unroll
      for (int x = 1; x < LPP; x <<= 1) sc[t] += __shfl_xor_sync(aria::FULL_MASK, sc[t], x);
      sc[t] = valid ? sc[t] * sc_[t][0] : aria::NEG_INF;
      // the LPP lanes of a position agree: xor LPP .. 16 spans the warp's
      float mx = sc[t];
#pragma unroll
      for (int x = LPP; x < 32; x <<= 1) mx = fmaxf(mx, __shfl_xor_sync(aria::FULL_MASK, mx, x));
      const float mn = fmaxf(m[t], mx);
      const float corr = expf(m[t] - mn);
      const float pr = valid ? expf(sc[t] - mn) : 0.f;
      float sum = pr;
#pragma unroll
      for (int x = LPP; x < 32; x <<= 1) sum += __shfl_xor_sync(aria::FULL_MASK, sum, x);
      s[t] = s[t] * corr + sum;
      m[t] = mn;
      pw[t] = valid ? aria::bf16_round(KIND == BF16 ? pr : pr * sc_[t][1]) : 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] *= corr;
    }
    // p * v over the warp's positions, this lane's 4 dims
#pragma unroll
    for (int j = 0; j < PPW; ++j) {
      if (c0 + tile * T + warp * PPW + j >= c1) break;  // warp-uniform: past the chunk
      const uint8_t* vr = vs + (warp * PPW + j) * C::ROW;
      float pj[NH];
#pragma unroll
      for (int t = 0; t < NH; ++t) pj[t] = __shfl_sync(aria::FULL_MASK, pw[t], LPP * j);
      if constexpr (KIND == BF16) {
        float f[4];
        aria::load4(reinterpret_cast<const __nv_bfloat16*>(vr) + 4 * lane, f);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][e] += pj[0] * f[e];
      } else if constexpr (KIND == INT8) {
        float f[4];
        s8x4(*reinterpret_cast<const uint32_t*>(vr + 4 * lane), f);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][e] += pj[0] * f[e];
      } else {
        float lo[4], hi[4];
        nib4(*reinterpret_cast<const uint32_t*>(vr + 4 * lane), lo, hi);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[0][e] += pj[0] * lo[e];
          acc[NH - 1][e] += pj[NH - 1] * hi[e];
        }
      }
    }
    __syncthreads();  // the stage is read before the next load overwrites it
  }

  // the 8 warps' merge; the ring's memory holds their accumulators
  float* red_acc = reinterpret_cast<float*>(smem);  // [NH][WARPS][D]
#pragma unroll
  for (int t = 0; t < NH; ++t) {
    if (lane == 0) {
      red_m[t][warp] = m[t];
      red_s[t][warp] = s[t];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) red_acc[(t * WARPS + warp) * D + lane * 4 + e] = acc[t][e];
  }
  __syncthreads();
  const int sel = threadIdx.x / D, d = threadIdx.x % D;
  const bool active = sel < NH;
  float M = aria::NEG_INF, tot = 0.f, a = 0.f;
  if (active) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, red_m[sel][w]);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float e = expf(red_m[sel][w] - M);
      tot += red_s[sel][w] * e;
      a += red_acc[(sel * WARPS + w) * D + d] * e;
    }
  }

  const size_t bx = (size_t)b * Hx + hx;  // this block's (lane, head or pair)
  if (P > 1) {
    // the partial to the workspace: acc [B Hx][P][NH][D], then m and s
    const size_t n_part = (size_t)B * Hx * P * NH;
    float* ws_m = ws + n_part * D;
    float* ws_s = ws_m + n_part;
    const size_t slot = (bx * P + split) * NH + sel;
    if (active) {
      ws[slot * D + d] = a;
      if (d == 0) {
        ws_m[slot] = M;
        ws_s[slot] = tot;
      }
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(&counters[bx], 1u) == (unsigned)(P - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (active) {
      const size_t first = bx * P * NH + sel;
      M = aria::NEG_INF;
      for (int i = 0; i < P; ++i) M = fmaxf(M, __ldcg(ws_m + first + i * NH));
      tot = 0.f;
      a = 0.f;
      for (int i = 0; i < P; ++i) {
        const size_t at = first + i * NH;
        const float e = expf(__ldcg(ws_m + at) - M);
        tot += __ldcg(ws_s + at) * e;
        a += __ldcg(ws + at * D + d) * e;
      }
    }
    if (threadIdx.x == 0) counters[bx] = 0;  // ready for the next call
  }
  if (active) {
    const size_t bh = (size_t)b * H + hx + sel * Hx;
    if (acc_out != nullptr) {  // the stats form: unnormalised, for a merge
      acc_out[bh * D + d] = a;
      if (d == 0) {
        m_out[bh] = M;
        s_out[bh] = tot;
      }
    } else {
      out[bh * D + d] = __float2bfloat16(tot > 0.f ? a / tot : 0.f);
    }
  }
}

template <int KIND>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* lengths, void* out, void* acc, void* m, void* s, void* ws, void* counters,
           int B, int Hx, int S, int layer, int P, cudaStream_t stream) {
  using C = Cfg<KIND>;
  const cudaError_t err = aria::allow_smem(decode_attention_kernel<KIND>, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  decode_attention_kernel<KIND><<<dim3(Hx, B, P), THREADS, C::SMEM, stream>>>(
      (const __nv_bfloat16*)q, (const uint8_t*)k, (const uint8_t*)v, ks, vs,
      (const int*)lengths, (__nv_bfloat16*)out, (float*)acc, (float*)m, (float*)s, (float*)ws,
      (unsigned*)counters, B, Hx, S, layer);
  return (int)cudaGetLastError();
}

}  // namespace

// kind: 0 bf16 cache, 1 int8 with f32 scales, 2 packed int4 with bf16 scales
// (Hx = H/2 head pairs, else Hx = H). With acc non-null, the stats form
// (acc, m, s; out null), else the normal form into out. P splits over
// positions; with P > 1, ws holds B * Hx * P * (H / Hx) * (128 + 2) f32 and
// counters B * Hx zeroed unsigned ints, which the kernel leaves zeroed.
ARIA_EXPORT int aria_decode_attention(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale,
                                      const void* lengths, void* out, void* acc, void* m,
                                      void* s, void* ws, void* counters, int B, int Hx, int S,
                                      int layer, int kind, int P, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case BF16:
      return launch<BF16>(q, k, v, k_scale, v_scale, lengths, out, acc, m, s, ws, counters, B,
                          Hx, S, layer, P, st);
    case INT8:
      return launch<INT8>(q, k, v, k_scale, v_scale, lengths, out, acc, m, s, ws, counters, B,
                          Hx, S, layer, P, st);
    case INT4:
      return launch<INT4>(q, k, v, k_scale, v_scale, lengths, out, acc, m, s, ws, counters, B,
                          Hx, S, layer, P, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
