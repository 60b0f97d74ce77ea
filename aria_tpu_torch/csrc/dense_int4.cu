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

#include <tuple>

#include "hopper.cuh"

namespace {

constexpr int WARPS = 8;   // dense_int4_a8: 8 warps a block

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
