// dense_int4: out[T, F] (f32) = x[T, D] @ W[layer], W packed int4, in two
// forms.
//
// dense_int4_kernel replaces aria_tpu/ops/dense_int4.py:124 dense_int4
// (`_kernel` :68, the bf16-activation variant). W is the out-major stack q4t
// [L, F, D/2] int8 (biased-lo bytes, within-group pairing over D: packed
// column j of D-group g holds element g*gs + j in the low nibble and
// g*gs + gs/2 + j in the high one) with bf16 scales sg [L, 8, F], row g =
// D-group g:
//
//   out[t, f] = sum over D-groups g, ascending, of (x_g[t] . W_g[f]) * sg[g, f]
//
// with each group's dot an f32 sum of exact products. The kernel computes the
// transposed tile out^T = W . x^T on wgmma: the packed weights are the M side
// (64 output features a consumer warpgroup), the token rows the N side (8,
// 16, 32, 64 or 128 a block). TMA brings the packed W tile (128 or 64
// bytes of a row a stage, swizzled) and the x tiles it meets (K-major B
// operands, 128-byte swizzle) into a ring; one producer thread keeps it
// full. Each consumer thread reads its A fragments' packed bytes from
// shared memory and unpacks the nibbles in registers to bf16, where -8..7
// are exact (a prmt, two lop3 and a bf16x2 fma a byte pair: 128 + n built
// in the mantissa, then 136 taken away), and issues wgmma with A from
// registers: 16 packed bytes feed two k-steps, their low nibbles against x's
// columns g*gs + j.., their high ones against g*gs + gs/2 + j.. (x is never
// permuted). A D-group's f32 sum is its own accumulator set; at the group's
// end it is scaled by sg[g, f] and added to the total, in group order.
//
// Bound: at T <= 32 the weight read (9.8 MB for wqkv at D = 2560, F =
// 7680), each weight byte read once, one consumer warpgroup of 64 rows a
// block and a ring of 96 KB, W rows of 128 bytes a stage (TMA's cost goes
// by the row as much as by the byte). At T <= 8 a block's work is too short
// to hide a load's latency, so K is split over the D-groups too (64 rows x
// one group: 600 blocks for wqkv, 200 for wo): each block writes its
// group's sums to an f32 workspace, and the last of a row tile's blocks to
// finish (an atomic counter, left at 0) scales and adds them in group order
// with the unsplit kernel's steps, so a row's bits do not depend on T.
// At 8 < T <= 32 a block takes every group (120 blocks for wqkv, 40 for wo)
// with most of its 80 KB of weights in flight at once. Above 32 rows the
// bf16 tensor cores (2 T D F operations, 161 GFLOP for wqkv at T = 4096):
// two consumer warpgroups of 64 rows share each x tile (128 x 128 tiles),
// one unpacking while the other's products run, and the group totals wait
// in shared memory. The products are exact and every sum runs in a fixed
// order, so the result does not depend on scheduling.
//
// dense_int4_a8_kernel replaces the W4A8 variant (`_kernel_a8` :97, the
// act_int8=True branch of :124): x quantized to int8 per (token, D-group)
// with f32 scales sx [T, 8] (act_quant_int8's arithmetic), and
//
//   out[t, f] = sum over D-groups g, ascending, of (G_g[t, f] * sx[t, g]) * sg[g, f]
//
// where G_g is the exact int32 dot of the int8 activations with the int4
// values. Bound: the weight read, as above. Design: the W4A8 decode MoE's
// gate/up kernel (moe_decode.cu) for one weight matrix. The products run on
// the int8 tensor cores, mma.sync m16n8k32 s8 x s8 -> s32: the packed W rows
// the M side (16 a consumer warp, 64 a block), the token rows the N side in
// tiles of 8. Each thread unpacks its rows' nibbles in registers to int8
// words of 16 lo and 16 hi (hopper.cuh lo16 / hi16, three bit operations a
// word), so a D-group's two products (the low nibbles against x's columns
// g*gs + j.., the high ones against g*gs + gs/2 + j..) sum to 16 G in
// int32, shifted right by 4 at the group's end. One producer
// thread keeps a TMA ring of W boxes (64 rows of 128 packed bytes, swizzled)
// full, and the consumers wait on it with one PTX loop (mbar_wait_loop).
//
// - At most 8 rows (SPLIT), K is split over the D-groups as dense_int4 does:
//   block (x, g) takes W rows 64x.. over group g alone (600 blocks for wqkv
//   at D = 2560, 200 for wo), so a call has all its weight bytes in flight
//   at once. The block quantizes its group of the bf16 x rows itself, with
//   act_quant_int8's arithmetic (the same amax, scale and rounding, so the
//   same bits), into shared memory: one launch a call, no xq or sx in device
//   memory. It writes (G * sx) * sg to the workspace; the last of a row
//   tile's blocks (an atomic counter, left at 0) adds the groups in order.
// - Above 8 rows, act_quant_kernel (below: one block a row, one warp a
//   group, one pass) quantizes x first and a block takes 64 W rows x 16 or
//   32 token rows over every group, the x boxes (lo and hi columns of the
//   stage) coming through the same ring. Its 8 consumer warps take an
//   m-tile and half the n-tiles each, and keep the low and the high
//   nibbles' products in separate accumulators, so each warp has four or
//   two independent products in flight (one warp an m-tile, with one
//   accumulator chain, left a block latency-bound).
//
// The integer sums are exact in any order, and the float steps are the TPU
// kernel's, (G * sx) * sg with __fmul_rn, added in ascending group order
// with __fadd_rn, so the result is bit-equal to the plain version and a
// row's bits do not depend on the rows beside it.

#include <tuple>

#include "hopper.cuh"

namespace {

// ---- dense_int4 on wgmma
constexpr int XROW = 128;        // an x box row: 64 bf16 under the 128-byte swizzle
template <int TN, int NWG, bool SPLIT>
struct Tile {
  // packed bytes of a W row a stage: 128 (a 128-byte-swizzled box row, two x
  // boxes a side) at most 32 rows, where the weight read bounds the call and
  // TMA's cost goes by the row; 64 (a 64-byte-swizzled row, one x box a
  // side) above, where the ring must leave room for the group totals
  static constexpr int PB = TN > 32 ? 64 : 128;
  static constexpr int XBOXES = PB / 64;           // x boxes of 64 bf16 a side
  // NWG consumer warpgroups of 64 W rows each, then the producer: a warp
  // beside one consumer, a warpgroup beside two (setmaxnreg moves its
  // registers to them)
  static constexpr int ROWS = 64 * NWG;            // W rows (output features) a block
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int THREADS = CONSUMERS + (NWG == 1 ? 32 : 128);
  static constexpr int W_BYTES = ROWS * PB;
  static constexpr int X_BYTES = XBOXES * TN * XROW;  // the low or the high nibbles' x
  static constexpr int STAGE = W_BYTES + 2 * X_BYTES;
  // above 32 rows the group totals wait in shared memory, out of the registers;
  // at most 32 rows (the weight read bounds the call) a deep ring keeps most
  // of a block's 80 KB of weights in flight at once
  static constexpr bool TOT_SMEM = TN > 32;
  // (a split block streams one group, 2 stages at D = 2560: a ring of 2)
  static constexpr int STAGES = SPLIT ? 2 : TOT_SMEM ? 4 : 96 * 1024 / STAGE;

  static constexpr int BAR = STAGE * STAGES;
  static constexpr int TOT = BAR + 16 * STAGES;
  static constexpr int SMEM = TOT + (TOT_SMEM ? CONSUMERS * TN / 2 * 4 : 0) + 1024;
};

using aria::lds16;
using aria::swz;
using aria::unpack2;

// SPLIT (T <= TN): block (x, g) takes W rows 64x.. over D-group g only, and
// the last of the row tile's blocks adds the groups; else block (x, y) takes
// W rows 64 NWG x.. and token rows TN y.. over every group. TAIL: a D-group
// is not whole stages (small widths), so the fragments past its end are
// zeroed.
template <int TN, int NWG, bool SPLIT, bool TAIL>
__global__ void __launch_bounds__(Tile<TN, NWG, SPLIT>::THREADS, 1)
dense_int4_kernel(const __grid_constant__ CUtensorMap w_map,
                  const __grid_constant__ CUtensorMap x_map, const __nv_bfloat16* __restrict__ sg,
                  float* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
                  int T, int D, int F, int layer, int ng) {
  using C = Tile<TN, NWG, SPLIT>;
  constexpr int NA = TN / 2, PB = C::PB;  // accumulator registers, packed bytes a stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  const uint32_t base = (aria::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + C::BAR;
  const int f0 = blockIdx.x * C::ROWS;
  const int t0 = SPLIT ? 0 : blockIdx.y * TN;
  const int g0 = SPLIT ? blockIdx.y : 0;  // this block's first group
  const int gs = D / ng, gsp = gs / 2, spg = (gsp + PB - 1) / PB;
  const int nk = (SPLIT ? 1 : ng) * spg;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      aria::mbar_init(bars + 8 * s, 1);
      aria::mbar_init(bars + 8 * (C::STAGES + s), 4 * NWG);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= C::CONSUMERS) {  // the producer: one thread starts every load
    if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == C::CONSUMERS) {
      for (int c = 0; c < nk; ++c) {
        const int s = c % C::STAGES, g = g0 + c / spg, jg = (c % spg) * PB;
        const uint32_t st = base + s * C::STAGE, full = bars + 8 * s;
        if (c >= C::STAGES) aria::mbar_wait(bars + 8 * (C::STAGES + s), (c / C::STAGES - 1) & 1);
        aria::mbar_expect_tx(full, C::STAGE);
        aria::tma_load(st, &w_map, full, g * gsp + jg, f0, layer);  // rows past F: zeros
        for (int b = 0; b < C::XBOXES; ++b) {  // x rows past T: zeros
          const uint32_t xb = st + C::W_BYTES + b * TN * XROW;
          aria::tma_load(xb, &x_map, full, g * gs + jg + 64 * b, t0);
          aria::tma_load(xb + C::X_BYTES, &x_map, full, g * gs + gsp + jg + 64 * b, t0);
        }
      }
    }
    return;
  }

  if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int q = lane / 4, r = lane % 4;
  const int ra = 64 * cw + 16 * warp + q, rb = ra + 8;  // this thread's rows of the W box
  float* tot_s = reinterpret_cast<float*>(smem_raw + (base - aria::smem_u32(smem_raw)) + C::TOT);
  const __nv_bfloat16* sga = sg + (size_t)layer * 8 * F + min(f0 + ra, F - 1);
  const __nv_bfloat16* sgb = sg + (size_t)layer * 8 * F + min(f0 + rb, F - 1);
  float acc[NA], tot[C::TOT_SMEM ? 1 : NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (C::TOT_SMEM ? 1 : NA); ++i) tot[i] = 0.f;
  __nv_bfloat16 sa, sb;  // the group's scales of both rows, loaded at its first stage

  // a stage's products are one batch: its A fragments unpacked (k16 steps of
  // 16 packed bytes, each feeding a low- and a high-nibble product), then
  // the products issued, then the batch before waited for, so a stage's
  // unpacking overlaps the stage before's products
  for (int c = 0; c < nk; ++c) {
    const int s = c % C::STAGES, js = c % spg;
    const uint32_t w = base + s * C::STAGE, xl = w + C::W_BYTES, xh = xl + C::X_BYTES;
    if (js == 0) sa = sga[(size_t)(g0 + c / spg) * F], sb = sgb[(size_t)(g0 + c / spg) * F];
    aria::mbar_wait(bars + 8 * s, (c / C::STAGES) & 1);
    uint32_t alo[PB / 16][4], ahi[PB / 16][4];
#pragma unroll
    for (int kk = 0; kk < PB / 16; ++kk) {
      // packed bytes 16kk + 2r, +1 (k 2r, 2r + 1) and 16kk + 8 + 2r, +1 of both rows
      unpack2(lds16(w + swz<PB>(ra, 16 * kk + 2 * r)), alo[kk][0], ahi[kk][0]);
      unpack2(lds16(w + swz<PB>(rb, 16 * kk + 2 * r)), alo[kk][1], ahi[kk][1]);
      unpack2(lds16(w + swz<PB>(ra, 16 * kk + 8 + 2 * r)), alo[kk][2], ahi[kk][2]);
      unpack2(lds16(w + swz<PB>(rb, 16 * kk + 8 + 2 * r)), alo[kk][3], ahi[kk][3]);
      if constexpr (TAIL) {  // past the group's end the fragment is 0
        const bool ok = js * PB + 16 * kk < gsp;
#pragma unroll
        for (int i = 0; i < 4; ++i) alo[kk][i] = ok ? alo[kk][i] : 0u, ahi[kk][i] = ok ? ahi[kk][i] : 0u;
      }
    }
    aria::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PB / 16; ++kk) {
      const uint32_t off = kk / 4 * TN * XROW + kk % 4 * 32;  // the x box, 16 columns into it
      aria::wgmma_rsn<TN>(acc, alo[kk], aria::sw128_desc(xl + off, 16, 1024));
      aria::wgmma_rsn<TN>(acc, ahi[kk], aria::sw128_desc(xh + off, 16, 1024));
    }
    aria::wgmma_commit();
    aria::wgmma_wait<1>();
    if (c > 0 && lane == 0) aria::mbar_arrive(bars + 8 * (C::STAGES + (c - 1) % C::STAGES));
    if (js == spg - 1) {  // the end of D-group g: scale, add to the total in group order
      aria::wgmma_wait<0>();
      aria::fence_regs(acc);
      const float fa = aria::bf2f(sa), fb = aria::bf2f(sb);
#pragma unroll
      for (int j = 0; j < NA / 4; ++j) {  // acc[4j..4j+3]: rows ra, ra, rb, rb
        if constexpr (C::TOT_SMEM) {
          float4* ts = reinterpret_cast<float4*>(tot_s) + j * C::CONSUMERS + threadIdx.x;
          float4 t4 = c < spg ? make_float4(0.f, 0.f, 0.f, 0.f) : *ts;
          t4.x = __fmaf_rn(acc[4 * j], fa, t4.x);
          t4.y = __fmaf_rn(acc[4 * j + 1], fa, t4.y);
          t4.z = __fmaf_rn(acc[4 * j + 2], fb, t4.z);
          t4.w = __fmaf_rn(acc[4 * j + 3], fb, t4.w);
          *ts = t4;
        } else if constexpr (SPLIT) {  // the group's own sums: the last block scales them
#pragma unroll
          for (int e = 0; e < 4; ++e) tot[4 * j + e] = acc[4 * j + e];
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            tot[4 * j + e] = __fmaf_rn(acc[4 * j + e], e < 2 ? fa : fb, tot[4 * j + e]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * j + e] = 0.f;
      }
    }
  }

  // tot[4j + e]: row ra (e < 2) or rb, token 8j + 2r + (e & 1)
  if constexpr (!SPLIT) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int t = t0 + 8 * (i / 4) + 2 * r + (i & 1), f = f0 + ((i & 2) ? rb : ra);
      const float v = C::TOT_SMEM ? tot_s[((i / 4) * C::CONSUMERS + threadIdx.x) * 4 + i % 4]
                                  : tot[C::TOT_SMEM ? 0 : i];
      if (t < T && f < F) out[(size_t)t * F + f] = v;
    }
  } else {
    static_assert(NWG == 1 && !C::TOT_SMEM, "the split takes one warpgroup of few rows");
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int t = 8 * (i / 4) + 2 * r + (i & 1), f = f0 + ((i & 2) ? rb : ra);
      if (t < T && f < F) ws[((size_t)g0 * T + t) * F + f] = tot[C::TOT_SMEM ? 0 : i];
    }
    __threadfence();
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    if (threadIdx.x == 0) last = atomicAdd(&counters[blockIdx.x], 1) == ng - 1;
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int t = 8 * (i / 4) + 2 * r + (i & 1), f = f0 + ((i & 2) ? rb : ra);
      // the groups' sums, all loads first, scaled and added in group order
      // as the unsplit kernel does: a row's bits do not depend on the rows
      // beside it
      if (t < T && f < F) {
        float v[8], sc[8];
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          v[g] = g < ng ? __ldcg(ws + ((size_t)g * T + t) * F + f) : 0.f;
          sc[g] = g < ng ? aria::bf2f(sg[((size_t)layer * 8 + g) * F + f]) : 0.f;
        }
        float a = 0.f;
#pragma unroll
        for (int g = 0; g < 8; ++g) a = g < ng ? __fmaf_rn(v[g], sc[g], a) : a;
        out[(size_t)t * F + f] = a;
      }
    }
    if (threadIdx.x == 0) counters[blockIdx.x] = 0;  // ready for the next call
  }
}

template <int TN, int NWG, bool SPLIT>
cudaError_t launch_dense(const void* x, const void* q4t, const void* sg, void* out, void* ws,
                         void* counters, int T, int D, int F, int L, int layer, int ng,
                         cudaStream_t st) {
  using C = Tile<TN, NWG, SPLIT>;
  CUtensorMap wm, xm;
  const cuuint64_t wdims[3] = {(cuuint64_t)D / 2, (cuuint64_t)F, (cuuint64_t)L};
  const cuuint64_t wstrides[2] = {(cuuint64_t)D / 2, (cuuint64_t)F * D / 2};
  const cuuint32_t wbox[3] = {C::PB, C::ROWS, 1};
  const cuuint64_t xdims[2] = {(cuuint64_t)D, (cuuint64_t)T};
  const cuuint64_t xstrides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t xbox[2] = {64, TN};
  const auto wswz = C::PB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  if (!aria::make_map(&wm, q4t, 3, wdims, wstrides, wbox, wswz, CU_TENSOR_MAP_DATA_TYPE_UINT8) ||
      !aria::make_map(&xm, x, 2, xdims, xstrides, xbox))
    return cudaErrorInvalidValue;
  const bool tail = D / ng / 2 % C::PB != 0;
  const auto kernel =
      tail ? dense_int4_kernel<TN, NWG, SPLIT, true> : dense_int4_kernel<TN, NWG, SPLIT, false>;
  cudaError_t err = aria::allow_smem(kernel, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((F + C::ROWS - 1) / C::ROWS, SPLIT ? ng : (T + TN - 1) / TN);
  kernel<<<grid, C::THREADS, C::SMEM, st>>>(wm, xm, (const __nv_bfloat16*)sg, (float*)out,
                                           (float*)ws, (int*)counters, T, D, F, layer, ng);
  return cudaGetLastError();
}

// ---- dense_int4_a8 on int8 mma.sync
constexpr int A8_ROWS = 64;                // W rows (output features) a block: 4 m-tiles of 16
constexpr int A8_PB = 128;                 // packed bytes of a W row a stage
constexpr int A8_WBOX = A8_ROWS * A8_PB;   // 8 KB

// act_quant_int8 (above 8 rows): one block a token row, warp g its D-group
// g: the group's amax, scale max(amax / 127, 1e-8), rint(x / scale)
// clamped to +-127, 8 values a lane at a time (gs % 8 == 0)
__global__ void __launch_bounds__(256)
act_quant_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ xq,
                 float* __restrict__ sx, int D, int ng) {
  const int t = blockIdx.x, g = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (g >= ng) {
    if (lane == 0) sx[t * 8 + g] = 0.f;
    return;
  }
  const int gs = D / ng;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)t * D + g * gs);
  float a = 0.f;
  for (int c = lane; c < gs / 8; c += 32) {
    const uint4 v = xr[c];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      a = fmaxf(a, fmaxf(fabsf(aria::bf_lo(w[k])), fabsf(aria::bf_hi(w[k]))));
  }
  const float sc = fmaxf(aria::warp_max(a) * (1.f / 127.f), 1e-8f);
  uint2* qr = reinterpret_cast<uint2*>(xq + (size_t)t * D + g * gs);
  for (int c = lane; c < gs / 8; c += 32) {
    const uint4 v = xr[c];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t o[2] = {0u, 0u};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float e = k & 1 ? aria::bf_hi(w[k / 2]) : aria::bf_lo(w[k / 2]);
      const float qv = fminf(fmaxf(rintf(e / sc), -127.f), 127.f);
      o[k / 4] |= (uint32_t)(uint8_t)(int8_t)qv << (8 * (k % 4));
    }
    qr[c] = make_uint2(o[0], o[1]);
  }
  if (lane == 0) sx[t * 8 + g] = sc;
}

// NT n-tiles of 8 token rows a block, WN consumer warps an m-tile of 16 W
// rows (each NT / WN n-tiles: more warps keep more independent products in
// flight); SPLIT: one D-group a block, x quantized in the block into XS
template <int NT, int WN, bool SPLIT>
struct A8 {
  static constexpr int TN = 8 * NT;
  static constexpr int CW = 4 * WN;                   // consumer warps
  static constexpr int NTW = NT / WN;                 // a warp's n-tiles
  static constexpr int THREADS = 32 * (CW + 1);       // and one producer warp
  static constexpr int XBOX = SPLIT ? 0 : TN * 128;   // x's low (or high) columns of a stage
  static constexpr int STAGE = A8_WBOX + 2 * XBOX;
  // a split block streams one group (2 stages at D = 2560); above, one block
  // an SM streams 80 KB (wqkv, 10 stages) and keeps all of it in flight
  static constexpr int STAGES = SPLIT ? 2 : 12;
  static constexpr int BAR = STAGE * STAGES;
  static constexpr int SG = BAR + 16 * STAGES;      // f32 [8][A8_ROWS]: the block's group scales
  static constexpr int SX = SG + 8 * A8_ROWS * 4;   // f32 [TN][8] (SPLIT: [8], its group)
  static constexpr int XS = SX + (SPLIT ? 8 : TN * 8) * 4;
  // SPLIT: int8 [lo, hi][8 rows][xw], xw = the group's stages' bytes + 16
  // (a row's 16-byte shift keeps the fragments' loads free of bank conflicts)
  static int bytes(int spg) { return XS + (SPLIT ? 2 * 8 * (spg * A8_PB + 16) : 0) + 1024; }
};

// SPLIT (T <= 8): block (x, g) takes W rows 64x.. over D-group g, x its bf16
// rows; else block (x, y) takes W rows 64x.. and token rows TN y.. of xq
// (x_map) over every group, with sx. TAIL: a D-group is not whole stages
// (one group of D/2 packed bytes, not a multiple of 128), so x's words past
// its end are zeroed.
template <int NT, int WN, bool SPLIT, bool TAIL>
__global__ void __launch_bounds__(A8<NT, WN, SPLIT>::THREADS)
dense_int4_a8_kernel(const __grid_constant__ CUtensorMap w_map,
                     const __grid_constant__ CUtensorMap x_map,
                     const __nv_bfloat16* __restrict__ x, const float* __restrict__ sx,
                     const __nv_bfloat16* __restrict__ sg, float* __restrict__ out,
                     float* __restrict__ ws, int* __restrict__ counters, int T, int D, int F,
                     int layer, int ng) {
  using C = A8<NT, WN, SPLIT>;
  constexpr int CW = C::CW, NTW = C::NTW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  const uint32_t raw = aria::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - raw);
  const uint32_t bars = base + C::BAR;
  const int f0 = blockIdx.x * A8_ROWS;
  const int t0 = SPLIT ? 0 : blockIdx.y * C::TN;
  const int g0 = SPLIT ? blockIdx.y : 0;  // this block's first group
  const int gs = D / ng, gsp = gs / 2, spg = (gsp + A8_PB - 1) / A8_PB;
  const int ngb = SPLIT ? 1 : ng;         // this block's groups
  const int nk = ngb * spg;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      aria::mbar_init(bars + 8 * s, 1);
      aria::mbar_init(bars + 8 * (C::STAGES + s), CW);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CW) {  // the producer: one thread starts every load
    if (lane == 0) {
      for (int c = 0; c < nk; ++c) {
        const int s = c % C::STAGES, g = g0 + c / spg, jg = (c % spg) * A8_PB;
        const uint32_t st = base + s * C::STAGE, full = bars + 8 * s;
        if (c >= C::STAGES) aria::mbar_wait(bars + 8 * (C::STAGES + s), (c / C::STAGES - 1) & 1);
        aria::mbar_expect_tx(full, C::STAGE);
        aria::tma_load(st, &w_map, full, g * gsp + jg, f0, layer);  // rows past F: zeros
        if constexpr (!SPLIT) {  // x rows past T: zeros
          aria::tma_load(st + A8_WBOX, &x_map, full, g * gs + jg, t0);
          aria::tma_load(st + A8_WBOX + C::XBOX, &x_map, full, g * gs + gsp + jg, t0);
        }
      }
    }
    return;
  }

  // the block's group scales (and, above 8 rows, its rows' x scales) while
  // the ring fills: the loads first, stored to shared memory after x's
  float* sg_s = reinterpret_cast<float*>(sbase + C::SG);
  float* sx_s = reinterpret_cast<float*>(sbase + C::SX);
  constexpr int NSG = (8 * A8_ROWS + 32 * CW - 1) / (32 * CW);
  float sgv[NSG];
#pragma unroll
  for (int j = 0; j < NSG; ++j) {
    const int i = threadIdx.x + j * 32 * CW, row = min(f0 + i % A8_ROWS, F - 1);
    sgv[j] = i < ngb * A8_ROWS ? aria::bf2f(sg[((size_t)layer * 8 + g0 + i / A8_ROWS) * F + row])
                               : 0.f;
  }
  const int xw = spg * A8_PB + 16;
  const uint32_t xs = base + C::XS;
  if constexpr (SPLIT) {
    // group g0 of each x row, quantized as act_quant_int8 does, 8 values a
    // lane at a time (gsp % 8 == 0), into [lo, hi][row][xw] int8; past the
    // group's end, and rows past T, zeros
    unsigned char* xq = sbase + C::XS;
    static_assert(CW == 4, "a split block's warp quantizes rows w and w + 4");
    const uint4* xr[2];
    bool live[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // both rows' loads in flight together
      const int t = warp + 4 * h;
      live[h] = t < T;
      xr[h] = reinterpret_cast<const uint4*>(x + (size_t)min(t, T - 1) * D + g0 * gs);
    }
    // 8 values as 8 bytes of int8 (act_quant_int8's rounding and clamp)
    auto quant8 = [](const uint4& v, float sc) {
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      uint32_t o[2] = {0u, 0u};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float e = k & 1 ? aria::bf_hi(w[k / 2]) : aria::bf_lo(w[k / 2]);
        const float qv = fminf(fmaxf(rintf(e / sc), -127.f), 127.f);
        o[k / 4] |= (uint32_t)(uint8_t)(int8_t)qv << (8 * (k % 4));
      }
      return make_uint2(o[0], o[1]);
    };
    auto amax8 = [](const uint4& v, float a) {
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        a = fmaxf(a, fmaxf(fabsf(aria::bf_lo(w[k])), fabsf(aria::bf_hi(w[k]))));
      return a;
    };
    float sc[2];
    if (gsp == 256) {
      // the flagship's groups (512 of D): lane l holds chunk l of each half,
      // read once, the row's amax and its bytes from the same registers
      uint4 v[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          v[h][half] = live[h] ? xr[h][32 * half + lane] : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        sc[h] = fmaxf(aria::warp_max(amax8(v[h][1], amax8(v[h][0], 0.f))) * (1.f / 127.f), 1e-8f);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<uint2*>(xq + (half * 8 + warp + 4 * h) * xw + 8 * lane) =
              live[h] ? quant8(v[h][half], sc[h]) : make_uint2(0u, 0u);
    } else {
      float a[2] = {0.f, 0.f};
      for (int c = lane; c < gs / 8; c += 32) {
#pragma unroll
        for (int h = 0; h < 2; ++h) a[h] = live[h] ? amax8(xr[h][c], a[h]) : a[h];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) sc[h] = fmaxf(aria::warp_max(a[h]) * (1.f / 127.f), 1e-8f);
      for (int c = lane; c < spg * A8_PB / 8; c += 32)  // 8 bytes of each half
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            *reinterpret_cast<uint2*>(xq + (half * 8 + warp + 4 * h) * xw + 8 * c) =
                live[h] && c < gsp / 8 ? quant8(xr[h][half * gsp / 8 + c], sc[h])
                                       : make_uint2(0u, 0u);
    }
    if (lane == 0) sx_s[warp] = sc[0], sx_s[warp + 4] = sc[1];
  } else {
    for (int i = threadIdx.x; i < C::TN * 8; i += 32 * CW)
      sx_s[i] = sx[(size_t)min(t0 + i / 8, T - 1) * 8 + i % 8];
  }
#pragma unroll
  for (int j = 0; j < NSG; ++j) {
    const int i = threadIdx.x + j * 32 * CW;
    if (i < ngb * A8_ROWS) sg_s[i] = sgv[j];
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(32 * CW) : "memory");

  const int q = lane >> 2, r = lane & 3;
  const int wrow = warp % 4 * 16 + q;  // this thread's rows wrow and wrow + 8 of the W box
  const int n0 = warp / 4 * NTW;       // this warp's first n-tile
  int acc[NTW][2][4];                  // [n-tile][lo, hi]: 16 G of the current group
  float tot[NTW][4];                   // the scaled sum over the groups so far
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][0][i] = acc[n][1][i] = 0, tot[n][i] = 0.f;

  for (int c = 0; c < nk; ++c) {
    const int s = c % C::STAGES, js = c % spg;
    const uint32_t st = base + s * C::STAGE;
    aria::mbar_wait_loop(bars + 8 * s, (c / C::STAGES) & 1);
    // rows wrow, wrow + 8: packed bytes 32r..32r+31 (word k: bytes 32r + 4k..),
    // unpacked to 16 lo and 16 hi
    uint32_t alo[2][8], ahi[2][8];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const uint4 t4 = aria::lds128(st + aria::sw128(wrow + 8 * hr, 32 * r + 16 * v));
        const uint32_t w4[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          alo[hr][4 * v + k] = aria::lo16(w4[k]), ahi[hr][4 * v + k] = aria::hi16(w4[k]);
      }
    // token row q's x bytes 32r..32r+31 of each n-tile, low and high columns
    uint32_t xl[NTW][8], xh[NTW][8];
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const uint32_t al =
            SPLIT ? xs + q * xw + js * A8_PB + 32 * r + 16 * v
                  : st + A8_WBOX + (n0 + n) * 1024 + aria::sw128(q, 32 * r + 16 * v);
        const uint32_t ah = SPLIT ? al + 8 * xw : al + C::XBOX;
        const uint4 a = aria::lds128(al), b = aria::lds128(ah);
        xl[n][4 * v] = a.x, xl[n][4 * v + 1] = a.y, xl[n][4 * v + 2] = a.z, xl[n][4 * v + 3] = a.w;
        xh[n][4 * v] = b.x, xh[n][4 * v + 1] = b.y, xh[n][4 * v + 2] = b.z, xh[n][4 * v + 3] = b.w;
        if constexpr (TAIL && !SPLIT) {  // past the group's end x is 0
#pragma unroll
          for (int k = 4 * v; k < 4 * v + 4; ++k) {
            const bool ok = js * A8_PB + 32 * r + 4 * k < gsp;
            xl[n][k] = ok ? xl[n][k] : 0u, xh[n][k] = ok ? xh[n][k] : 0u;
          }
        }
      }
    __syncwarp();
    if (lane == 0) aria::mbar_arrive(bars + 8 * (C::STAGES + s));  // the stage is in registers
    // k step t: the weights' packed bytes 32r + 8t.. (a0, a1) and 32r + 8t +
    // 4.. (a2, a3) against the same x bytes (both operands take one order
    // within the 32); the n-tiles' and the halves' products are independent
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint32_t lo[4] = {alo[0][2 * t], alo[1][2 * t], alo[0][2 * t + 1], alo[1][2 * t + 1]};
      const uint32_t hi[4] = {ahi[0][2 * t], ahi[1][2 * t], ahi[0][2 * t + 1], ahi[1][2 * t + 1]};
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        aria::mma_s8(acc[n][0], lo, xl[n][2 * t], xl[n][2 * t + 1]);
        aria::mma_s8(acc[n][1], hi, xh[n][2 * t], xh[n][2 * t + 1]);
      }
    }

    if (js == spg - 1) {  // the end of a D-group: (G * sx) * sg, added in group order
      const int gb = c / spg;  // of the block's groups
      const float sa = sg_s[gb * A8_ROWS + wrow], sb = sg_s[gb * A8_ROWS + wrow + 8];
#pragma unroll
      for (int n = 0; n < NTW; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int tok = (n0 + n) * 8 + 2 * r + (i & 1);
          const float sxv = SPLIT ? sx_s[tok] : sx_s[tok * 8 + gb];
          const int G = (acc[n][0][i] + acc[n][1][i]) >> 4;
          const float d = __fmul_rn(__fmul_rn((float)G, sxv), i < 2 ? sa : sb);
          tot[n][i] = gb == 0 ? d : __fadd_rn(tot[n][i], d);
          acc[n][0][i] = acc[n][1][i] = 0;
        }
    }
  }

  // tot[n][i]: row wrow (i < 2) or wrow + 8, token (n0 + n)*8 + 2r + (i & 1)
  if constexpr (!SPLIT) {
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + (n0 + n) * 8 + 2 * r + (i & 1), f = f0 + wrow + 8 * (i >> 1);
        if (t < T && f < F) out[(size_t)t * F + f] = tot[n][i];
      }
  } else {
    static_assert(NTW == 1, "the split takes one n-tile a warp");
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 2 * r + (i & 1), f = f0 + wrow + 8 * (i >> 1);
      if (t < T && f < F) ws[((size_t)g0 * T + t) * F + f] = tot[0][i];
    }
    __threadfence();
    asm volatile("bar.sync 1, %0;\n" :: "n"(32 * CW) : "memory");
    if (threadIdx.x == 0) last = atomicAdd(&counters[blockIdx.x], 1) == ng - 1;
    asm volatile("bar.sync 1, %0;\n" :: "n"(32 * CW) : "memory");
    if (!last) return;
    __threadfence();
    // the last block: the groups' terms (all loads first) added in group
    // order, as the unsplit form adds them
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 2 * r + (i & 1), f = f0 + wrow + 8 * (i >> 1);
      if (t < T && f < F) {
        float v[8];
#pragma unroll
        for (int g = 0; g < 8; ++g) v[g] = g < ng ? __ldcg(ws + ((size_t)g * T + t) * F + f) : 0.f;
        float a = v[0];
#pragma unroll
        for (int g = 1; g < 8; ++g) a = g < ng ? __fadd_rn(a, v[g]) : a;
        out[(size_t)t * F + f] = a;
      }
    }
    if (threadIdx.x == 0) counters[blockIdx.x] = 0;  // ready for the next call
  }
}

template <int NT, int WN, bool SPLIT>
cudaError_t launch_a8(const void* x, const void* xq, const void* sx, const void* q4t,
                      const void* sg, void* out, void* ws, void* counters, int T, int D, int F,
                      int L, int layer, int ng, cudaStream_t st) {
  using C = A8<NT, WN, SPLIT>;
  CUtensorMap wm, xm{};
  const cuuint64_t wdims[3] = {(cuuint64_t)D / 2, (cuuint64_t)F, (cuuint64_t)L};
  const cuuint64_t wstrides[2] = {(cuuint64_t)D / 2, (cuuint64_t)F * D / 2};
  const cuuint32_t wbox[3] = {A8_PB, A8_ROWS, 1};
  const cuuint64_t xdims[2] = {(cuuint64_t)D, (cuuint64_t)T};
  const cuuint64_t xstrides[1] = {(cuuint64_t)D};
  const cuuint32_t xbox[2] = {128, C::TN};
  if (!aria::make_map(&wm, q4t, 3, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_DATA_TYPE_UINT8) ||
      (!SPLIT && !aria::make_map(&xm, xq, 2, xdims, xstrides, xbox, CU_TENSOR_MAP_SWIZZLE_128B,
                                 CU_TENSOR_MAP_DATA_TYPE_UINT8)))
    return cudaErrorInvalidValue;
  const int spg = (D / ng / 2 + A8_PB - 1) / A8_PB;
  const bool tail = D / ng / 2 % A8_PB != 0;
  const auto kernel = tail ? dense_int4_a8_kernel<NT, WN, SPLIT, true>
                           : dense_int4_a8_kernel<NT, WN, SPLIT, false>;
  const int smem = C::bytes(spg);
  cudaError_t err = aria::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((F + A8_ROWS - 1) / A8_ROWS, SPLIT ? ng : (T + C::TN - 1) / C::TN);
  kernel<<<grid, C::THREADS, smem, st>>>(wm, xm, (const __nv_bfloat16*)x, (const float*)sx,
                                         (const __nv_bfloat16*)sg, (float*)out, (float*)ws,
                                         (int*)counters, T, D, F, layer, ng);
  return cudaGetLastError();
}

}  // namespace

// x bf16 [T, D], q4t int8 [L, F, D/2], sg bf16 [L, 8, F], out f32 [T, F].
// Given ws (ng * T * F f32) and counters (ceil(F / 64) int32 zeroed, which
// the kernel leaves zeroed), K is split over the D-groups: T <= 8 only.
ARIA_EXPORT int aria_dense_int4(const void* x, const void* q4t, const void* sg, void* out,
                                void* ws, void* counters, int T, int D, int F, int L, int layer,
                                void* stream) {
  const int ng = aria::int4_group_count(D);
  if (T < 1 || D % 32 || (D / ng / 2) % 16 || F < 1 || (ws != nullptr && T > 8))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const auto args = std::make_tuple(x, q4t, sg, out, ws, counters, T, D, F, L, layer, ng, st);
  if (ws != nullptr) return std::apply(launch_dense<8, 1, true>, args);
  if (T <= 16) return std::apply(launch_dense<16, 1, false>, args);
  if (T <= 32) return std::apply(launch_dense<32, 1, false>, args);
  if (T <= 64) return std::apply(launch_dense<64, 2, false>, args);
  return std::apply(launch_dense<128, 2, false>, args);
}

// The W4A8 form. T <= 8: x bf16 [T, D] (quantized in the kernel), ws (ng *
// T * F f32) and counters (ceil(F / 64) int32 zeroed, which the kernel leaves
// zeroed), xq and sx unused; above, xq int8 [T, D] and sx f32 [T, 8] from
// aria_act_quant_int8, x, ws and counters unused. q4t int8 [L, F, D/2], sg
// bf16 [L, 8, F], out f32 [T, F].
ARIA_EXPORT int aria_dense_int4_a8(const void* x, const void* xq, const void* sx,
                                   const void* q4t, const void* sg, void* out, void* ws,
                                   void* counters, int T, int D, int F, int L, int layer,
                                   void* stream) {
  const int ng = aria::int4_group_count(D);
  if (T < 1 || D % 32 || (D / ng / 2) % 16 || F < 1 || (T <= 8 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const auto args = std::make_tuple(x, xq, sx, q4t, sg, out, ws, counters, T, D, F, L, layer,
                                    ng, st);
  if (T <= 8) return std::apply(launch_a8<1, 1, true>, args);
  if (T <= 16) return std::apply(launch_a8<2, 2, false>, args);
  return std::apply(launch_a8<4, 2, false>, args);
}

// x bf16 [T, D] -> xq int8 [T, D], sx f32 [T, 8] (columns ng.. zero)
ARIA_EXPORT int aria_act_quant_int8(const void* x, void* xq, void* sx, int T, int D, int ng,
                                    void* stream) {
  if (T < 1 || ng < 1 || ng > 8 || D % ng || (D / ng) % 8) return (int)cudaErrorInvalidValue;
  act_quant_kernel<<<T, 256, 0, (cudaStream_t)stream>>>((const __nv_bfloat16*)x, (int8_t*)xq,
                                                        (float*)sx, D, ng);
  return cudaGetLastError();
}
