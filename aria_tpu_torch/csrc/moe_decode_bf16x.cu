// moe_decode_int4 with bf16 activations, and moe_decode_quant: the fused GLU
// MoE FFN over the routed (token, expert) pairs, bf16 x against packed int4
// or int8 experts, for T <= 128 token rows.
//
// Replaces aria_tpu/ops/moe_decode_kernel.py:450 moe_decode_int4 with
// act_int8=False (`_kernel_q4` :307, `_ffn_q4` :154) and :503
// moe_decode_quant (`_kernel_q` :117, `_ffn` :81). For each pair p = (token
// t, slot s) of the T*k routing slots, with e = indices[t, s]:
//
//   xs[p]   = x[t], the pairs listed by expert              prep_kernel<false>
//   h[p]    = silu(gate) * up in f32, rounded to bf16;     bf16x_gateup_kernel
//             int4: gate = sum over the D-groups g, in order, of
//                   (x . w1g[e])_g * sg_g (up alike);
//             int8: gate = (x . w1g[e]) * sg, sg a row's scale
//   part[p] = w[t, s] * ((h[p] . w2[e]) * c), c a column's  bf16x_down_kernel
//             scale
//   out[t]  = the sum of t's parts from 0, cast to bf16     combine_kernel
//
// Only routed rows: the pair lists, the work list and the combine are
// moe_pairs.cuh's, as the W4A8 form (moe_decode.cu) uses them, but the rows
// go as bf16, unquantized. A block takes one work-list entry, at most 16 rows
// of one expert, so no block computes padding; h and the f32 partials are
// one row a pair, [T*k, .], and the combine adds a token's pairs in the
// reference's order from 0.
//
// Numerics: the products are exact. Int4 values (the biased-lo bytes, as
// moe_prefill.cu unpacks them) and int8 values are exact in bf16 and are
// converted in registers with bit operations and one bf16x2 fma; the
// products are warp-level mma.sync m16n8k16, bf16 x (or h) with f32 sums.
// Group sums, scales, silu and the combine weight are applied with
// __fmul_rn / __fadd_rn in the plain version's order; only the order of
// the f32 sums within a dot differs. `_ffn_q4`'s bf16 rounding of (xb/16 -
// xa) is not reproduced (ROADMAP queue 3, fault (d)).
//
// Layouts: weights are the M side (16 rows of w1; 16 byte columns of w2),
// token rows the N side in tiles of 8. The contraction keeps its natural
// order within a 16-deep k step: thread (g, t) of a warp takes k 2t, 2t+1
// and 2t+8, 2t+9. w1 int4 pairs nibbles within a D-group (byte j of group g:
// element g*gs + j low, g*gs + gs/2 + j high), so a k step is 8 packed bytes,
// their low nibbles against x's low columns and their high ones against the
// high columns, and one 16-bit load gives a row's four values. w2's K runs
// along its rows (int4: byte j of a row holds columns j and j + D/2): a
// thread loads a 32-bit word (four byte columns) of its four rows 2t, 2t+1,
// 2t+8, 2t+9 and pairs each column's bytes with a byte permute; fragment
// rows g, g+8 are two adjacent columns. With the 128-byte swizzle no
// shared-memory load of a warp has a bank conflict. The consumer loop has
// one copy for chunks of one n-tile and one for two, picked once a block
// (with the count tested inside the loop, ptxas kept a branch and the x
// address arithmetic in every k step).
//
// Bound: the used experts' weights, read once a call, 3*I*D/2 bytes each
// for int4 (6.4 MB at I = 1664, D = 2560) or 3*I*D for int8 (12.8 MB),
// through a TMA ring of 4 stages fed by one producer thread, each weight
// row 128 bytes a box row: gate/up 64 gate rows and their 64 up rows a stage
// (16 KB) with the chunk's x columns (8 KB int4, 4 KB int8), down 128 rows
// of w2 (16 KB) with the chunk's h columns (4 KB); two blocks an SM. A
// gate/up block covers 64 intermediate columns, so a pair's x row is read
// from L2 I/64 = 26 times (at T = 32, 256 pairs: 34 MB against 416 MB of
// int4 weights); a down block covers 128 byte columns (int4: 256 outputs, h
// read D/256 = 10 times; int8: 128 outputs, 20 times). One stream's 8
// experts fill 208 gate/up blocks and 80 (int4) or 160 (int8) down blocks.

#include "moe_pairs.cuh"

namespace {

constexpr int TOK = PAIR_CHUNK;               // token rows a block: one work-list entry
constexpr int NT = TOK / 8;                   // n-tiles of 8 rows
constexpr int CONSUMERS = 4;                  // consumer warps
constexpr int THREADS = 32 * (CONSUMERS + 1);  // and one producer warp
constexpr int BOXB = 128;                     // bytes of a weight box row
constexpr int XBOX = 8 * 128;                 // a box of 8 bf16 rows x 64 columns
// gate/up: 64 intermediate columns a block (16 a warp): 64 gate rows and the
// 64 up rows of the same columns, 128 bytes of each a stage
constexpr int GU_I = 64;
constexpr int GU_WBOX = GU_I * BOXB;  // 8 KB
constexpr int GU_STAGES = 4;
// down: 128 byte columns of w2 a block (warp w: 32w..), 128 rows a stage
constexpr int DN_K = 128;
constexpr int DN_WBOX = DN_K * BOXB;  // 16 KB
constexpr int DN_STAGES = 4;
constexpr int DN_STAGE = DN_WBOX + 2 * NT * XBOX;

template <bool W4>
struct GateUp {
  // x boxes an n-tile a stage: a stage's 128 bytes of a weight row are 256
  // elements of D for int4 (128 low columns, 128 high) or 128 for int8
  static constexpr int XB = W4 ? 4 : 2;
  static constexpr int STAGE = 2 * GU_WBOX + XB * NT * XBOX;  // 24 KB, 20 KB
  // scales: int4 sg [8 groups][gate, up][64]; int8 [gate, up][64]
  using R = Ring<STAGE, GU_STAGES, (W4 ? 8 : 1) * 2 * GU_I * 4>;
};
// c [lo, hi][128], w [16]
using DNRing = Ring<DN_STAGE, DN_STAGES, (2 * BOXB + TOK) * 4>;

// two signed bytes at bits 0-7 and 16-23 of p as a bf16 pair, exactly:
// 128 + (b & 127) less 128 + (b & 128), one bf16x2 fma
__device__ __forceinline__ uint32_t s8_bf16(uint32_t p) {
  const uint32_t lo7 = aria::and_xor(p, 0x007F007Fu, 0x43004300u);
  const uint32_t top = aria::and_xor(p, 0x00800080u, 0x43004300u);
  uint32_t v;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(v) : "r"(top), "r"(0xBF80BF80u), "r"(lo7));
  return v;
}

// the block's work-list entry: its expert, first row and row count; false
// where the entry is empty (block-uniform)
__device__ __forceinline__ bool block_rows(const int* __restrict__ meta,
                                           const int* __restrict__ work, int U, int& e,
                                           int& row0, int& rows) {
  const int item = work[blockIdx.y];
  if (item < 0) return false;
  const int u = item & 0xFFFF, chunk = item >> 16;
  e = meta[u];
  row0 = meta[2 * U + u] + chunk * TOK;
  rows = min(TOK, meta[3 * U + u] - chunk * TOK);
  return true;
}

__device__ __forceinline__ float silu_times(float gt, float up) {
  const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-gt)));
  return __fmul_rn(__fmul_rn(gt, sig), up);
}

// The gate/up consumers of a block whose chunk has NTT n-tiles (block-
// uniform, so the loops have no branch): A fragments of the warp's gate and
// up rows from each stage, its x against them, h at the end.
template <bool W4, int NTT>
__device__ __forceinline__ void gateup_consume(uint32_t base, uint32_t bars, const float* sc_s,
                                               __nv_bfloat16* __restrict__ h, int nk, int spg,
                                               int row0, int rows, int i0, int I) {
  constexpr int STAGE = GateUp<W4>::STAGE, XB = GateUp<W4>::XB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 2, r = lane & 3;
  const int wrow = warp * 16 + q;  // this thread's rows wrow and wrow + 8 of each box
  float acc[2][NTT][4];  // [gate, up][n-tile]: the dot (int4: of the current group)
  float tot[2][NTT][4];  // int4: the scaled sum over the groups so far
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NTT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f, tot[m][n][i] = 0.f;

  for (int c = 0; c < nk; ++c) {
    const int s = c % GU_STAGES;
    const uint32_t st = base + s * STAGE, xst = st + 2 * GU_WBOX;
    aria::mbar_wait_loop(bars + 8 * s, (c / GU_STAGES) & 1);
#pragma unroll
    for (int ks = 0; ks < (W4 ? 16 : 8); ++ks) {
      uint32_t a[2][4];  // [gate, up]: A fragments of rows wrow, wrow + 8
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const uint32_t row = st + m * GU_WBOX;
          if constexpr (W4) {  // packed bytes 8 ks + 2r, +1: low nibbles k 2r.., high k 2r + 8..
            const uint32_t v = aria::lds16(row + sw128(wrow + 8 * hr, 8 * ks + 2 * r));
            const uint32_t p = __byte_perm(v, 0, 0x4140);
            a[m][hr] = aria::nibbles_bf16(p, 0, 0x43004300u);
            a[m][2 + hr] = aria::nibbles_bf16(p, 4, 0x43084308u);
          } else {  // bytes 16 ks + 2r, +1 and 16 ks + 2r + 8, +9
#pragma unroll
            for (int k8 = 0; k8 < 2; ++k8) {
              const uint32_t v = aria::lds16(row + sw128(wrow + 8 * hr, 16 * ks + 2 * r + 8 * k8));
              a[m][hr + 2 * k8] = s8_bf16(__byte_perm(v, 0, 0x4140));
            }
          }
        }
#pragma unroll
      for (int n = 0; n < NTT; ++n) {
        // token row q's x: int4, elements 8 ks + 2r, +1 of the low columns
        // (boxes 0, 1) and of the high ones (boxes 2, 3); int8, elements
        // 16 ks + 2r, +1 and + 8, +9 (boxes 0, 1)
        const uint32_t xb = xst + n * XB * XBOX;
        uint32_t b0, b1;
        if constexpr (W4) {
          const int col = 16 * (ks % 8) + 4 * r;
          b0 = lds32(xb + ks / 8 * XBOX + sw128(q, col));
          b1 = lds32(xb + (2 + ks / 8) * XBOX + sw128(q, col));
        } else {
          const int col = 32 * (ks % 4) + 4 * r;
          b0 = lds32(xb + ks / 4 * XBOX + sw128(q, col));
          b1 = lds32(xb + ks / 4 * XBOX + sw128(q, col + 16));
        }
        aria::mma_bf16(acc[0][n], a[0], b0, b1);
        aria::mma_bf16(acc[1][n], a[1], b0, b1);
      }
    }
    __syncwarp();
    if (lane == 0) aria::mbar_arrive(bars + 8 * (GU_STAGES + s));

    if (W4 && (c + 1) % spg == 0) {  // the end of D-group g: dot . sg, added in group order
      const int g = c / spg;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float sgv[2] = {sc_s[(g * 2 + m) * GU_I + wrow], sc_s[(g * 2 + m) * GU_I + wrow + 8]};
#pragma unroll
        for (int n = 0; n < NTT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float d = __fmul_rn(acc[m][n][i], sgv[i >> 1]);
            tot[m][n][i] = g == 0 ? d : __fadd_rn(tot[m][n][i], d);
            acc[m][n][i] = 0.f;
          }
      }
    }
  }

  // h = silu(gate) * up in f32, rounded to bf16, one row a pair
#pragma unroll
  for (int n = 0; n < NTT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tok = n * 8 + 2 * r + (i & 1), wr = wrow + 8 * (i >> 1);
      if (tok < rows && i0 + wr < I) {
        const float gt = W4 ? tot[0][n][i] : __fmul_rn(acc[0][n][i], sc_s[wr]);
        const float up = W4 ? tot[1][n][i] : __fmul_rn(acc[1][n][i], sc_s[GU_I + wr]);
        h[(size_t)(row0 + tok) * I + i0 + wr] = __float2bfloat16(silu_times(gt, up));
      }
    }
}

// s1: int4, w1sg bf16 [L, E, 8, 2I] (rows 0..ng-1 the D-groups' scales);
// int8, w1's s8 f32 [L, E, 8, 2I] (row 0 the scales)
template <bool W4>
__global__ void __launch_bounds__(THREADS, 2)
bf16x_gateup_kernel(const __grid_constant__ CUtensorMap w1_map,
                    const __grid_constant__ CUtensorMap x_map, const int* __restrict__ meta,
                    const int* __restrict__ work, const void* __restrict__ s1,
                    __nv_bfloat16* __restrict__ h, int D, int I, int E, int U, int ng, int layer) {
  using R = typename GateUp<W4>::R;
  constexpr int STAGE = GateUp<W4>::STAGE, XB = GateUp<W4>::XB;
  int e, row0, rows;
  if (!block_rows(meta, work, U, e, row0, rows)) return;
  const int i0 = blockIdx.x * GU_I;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + R::BAR;
  init_bars<GU_STAGES>(bars, CONSUMERS);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = (rows + 7) / 8;
  const int le = layer * E + e;
  const int gs = D / ng, gsp = gs / 2;
  const int nk = (W4 ? D / 2 : D) / BOXB;  // stages
  const int spg = W4 ? gsp / BOXB : nk;    // stages a D-group

  if (warp == CONSUMERS) {  // the producer: one thread starts every load
    if (lane == 0) {
      const uint32_t bytes = 2 * GU_WBOX + XB * nt * XBOX;
      for (int c = 0; c < nk; ++c) {
        const int s = c % GU_STAGES;
        const uint32_t st = base + s * STAGE, full = bars + 8 * s;
        if (c >= GU_STAGES) aria::mbar_wait(bars + 8 * (GU_STAGES + s), (c / GU_STAGES - 1) & 1);
        aria::mbar_expect_tx(full, bytes);
        aria::tma_load(st, &w1_map, full, c * BOXB, i0, le);
        aria::tma_load(st + GU_WBOX, &w1_map, full, c * BOXB, I + i0, le);
        // x's columns: box j of an n-tile starts at x0 + 64 (j & 1), plus
        // gs/2 for the high columns (int4, j >= 2)
        const int x0 = W4 ? c / spg * gs + c % spg * BOXB : c * BOXB;
        for (int b = 0; b < nt; ++b)
          for (int j = 0; j < XB; ++j)
            aria::tma_load(st + 2 * GU_WBOX + (b * XB + j) * XBOX, &x_map, full,
                           x0 + 64 * (j & 1) + gsp * (j >> 1), row0 + 8 * b);
      }
    }
    return;
  }

  float* sc_s = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) + R::SCALES);
  for (int i = threadIdx.x; i < (W4 ? ng : 1) * 2 * GU_I; i += 32 * CONSUMERS) {
    const int g = i / (2 * GU_I), m = i / GU_I % 2, row = min(i0 + i % GU_I, I - 1);
    const size_t at = ((size_t)le * 8 + g) * 2 * I + m * I + row;
    sc_s[i] = W4 ? aria::bf2f(static_cast<const __nv_bfloat16*>(s1)[at])
                 : static_cast<const float*>(s1)[at];
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(32 * CONSUMERS) : "memory");
  if (nt == 1)
    gateup_consume<W4, 1>(base, bars, sc_s, h, nk, spg, row0, rows, i0, I);
  else
    gateup_consume<W4, 2>(base, bars, sc_s, h, nk, spg, row0, rows, i0, I);
}

// The down consumers of a block whose chunk has NTT n-tiles: A fragments of
// the thread's four byte columns from each stage, h against them, the
// scaled partials at the end.
template <bool W4, int NTT>
__device__ __forceinline__ void down_consume(uint32_t base, uint32_t bars, const float* cs_s,
                                             const float* w_s, float* __restrict__ part, int nk,
                                             int row0, int rows, int j0, int D) {
  constexpr int LH = W4 ? 2 : 1;  // int4: low nibbles (column j), high ones (j + D/2)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 2, r = lane & 3;
  const int jb = 32 * warp + 4 * q;  // this thread's four byte columns jb..jb+3 of the block's
  float acc[LH][2][NTT][4];  // [lo, hi][m][n-tile]; m-tile m: rows q, q + 8 = columns jb + 2m, +1
#pragma unroll
  for (int lh = 0; lh < LH; ++lh)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NTT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[lh][m][n][i] = 0.f;

  for (int c = 0; c < nk; ++c) {
    const int s = c % DN_STAGES;
    const uint32_t st = base + s * DN_STAGE;
    aria::mbar_wait_loop(bars + 8 * s, (c / DN_STAGES) & 1);
#pragma unroll
    for (int ks = 0; ks < DN_K / 16; ++ks) {
      // rows 16 ks + 2r, +1 (k 2r, 2r+1) and 16 ks + 2r + 8, +9 (k 2r+8, 2r+9)
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = lds32(st + sw128(16 * ks + 2 * r + (i & 1) + 8 * (i >> 1), jb));
      uint32_t a[LH][2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int j = 2 * m + hr;  // column jb + j: byte j of each row's word
          const uint32_t sel = j | j << 4 | (4 + j) << 8 | (4 + j) << 12;
#pragma unroll
          for (int k8 = 0; k8 < 2; ++k8) {
            const uint32_t p = __byte_perm(w[2 * k8], w[2 * k8 + 1], sel);  // bytes 0, 2
            if constexpr (W4) {
              a[0][m][hr + 2 * k8] = aria::nibbles_bf16(p, 0, 0x43004300u);
              a[LH - 1][m][hr + 2 * k8] = aria::nibbles_bf16(p, 4, 0x43084308u);
            } else {
              a[0][m][hr + 2 * k8] = s8_bf16(p);
            }
          }
        }
#pragma unroll
      for (int n = 0; n < NTT; ++n) {
        // token row q's h, elements 16 ks + 2r, +1 and + 8, +9 of the stage's 128
        const uint32_t hb = st + DN_WBOX + (2 * n + ks / 4) * XBOX;
        const int col = 32 * (ks % 4) + 4 * r;
        const uint32_t b0 = lds32(hb + sw128(q, col)), b1 = lds32(hb + sw128(q, col + 16));
#pragma unroll
        for (int lh = 0; lh < LH; ++lh)
#pragma unroll
          for (int m = 0; m < 2; ++m) aria::mma_bf16(acc[lh][m][n], a[lh][m], b0, b1);
      }
    }
    __syncwarp();
    if (lane == 0) aria::mbar_arrive(bars + 8 * (DN_STAGES + s));
  }

  // the scales: c a column, w a pair (every consumer's loads are behind this barrier)
  asm volatile("bar.sync 1, %0;\n" :: "n"(32 * CONSUMERS) : "memory");
#pragma unroll
  for (int n = 0; n < NTT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tok = n * 8 + 2 * r + (i & 1);
      if (tok >= rows) continue;
      const float wp = w_s[tok];
#pragma unroll
      for (int lh = 0; lh < LH; ++lh)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int col = jb + 2 * m + (i >> 1);  // of the block's 128
          part[(size_t)(row0 + tok) * D + j0 + col + lh * (D / 2)] =
              __fmul_rn(wp, __fmul_rn(acc[lh][m][n][i], cs_s[lh * BOXB + col]));
        }
    }
}

// s2: int4, w2s8 bf16 [L, E, 8, D]; int8, w2's s8 f32 [L, E, 8, D]; row 0
// the column scales
template <bool W4>
__global__ void __launch_bounds__(THREADS, 2)
bf16x_down_kernel(const __grid_constant__ CUtensorMap w2_map,
                  const __grid_constant__ CUtensorMap h_map, const int* __restrict__ meta,
                  const int* __restrict__ work, const float* __restrict__ wsort,
                  const void* __restrict__ s2, float* __restrict__ part, int D, int I, int E,
                  int U, int layer) {
  int e, row0, rows;
  if (!block_rows(meta, work, U, e, row0, rows)) return;
  const int j0 = blockIdx.x * BOXB;  // the block's first byte column of w2
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + DNRing::BAR;
  init_bars<DN_STAGES>(bars, CONSUMERS);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = (rows + 7) / 8;
  const int le = layer * E + e;
  const int nk = (I + DN_K - 1) / DN_K;

  if (warp == CONSUMERS) {  // the producer
    if (lane == 0) {
      const uint32_t bytes = DN_WBOX + 2 * nt * XBOX;
      for (int c = 0; c < nk; ++c) {
        const int s = c % DN_STAGES;
        const uint32_t st = base + s * DN_STAGE, full = bars + 8 * s;
        if (c >= DN_STAGES) aria::mbar_wait(bars + 8 * (DN_STAGES + s), (c / DN_STAGES - 1) & 1);
        aria::mbar_expect_tx(full, bytes);
        aria::tma_load(st, &w2_map, full, j0, c * DN_K, le);  // rows past I load as zeros
        for (int b = 0; b < nt; ++b)
          for (int j = 0; j < 2; ++j)
            aria::tma_load(st + DN_WBOX + (2 * b + j) * XBOX, &h_map, full, c * DN_K + 64 * j,
                           row0 + 8 * b);
      }
    }
    return;
  }

  const size_t c8 = (size_t)le * 8 * D;  // row 0 of s8: the column scales
  float* cs_s = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) + DNRing::SCALES);
  float* w_s = cs_s + 2 * BOXB;
  for (int i = threadIdx.x; i < (W4 ? 2 : 1) * BOXB; i += 32 * CONSUMERS) {
    const size_t col = c8 + j0 + i % BOXB + i / BOXB * (D / 2);
    cs_s[i] = W4 ? aria::bf2f(static_cast<const __nv_bfloat16*>(s2)[col])
                 : static_cast<const float*>(s2)[col];
  }
  for (int i = threadIdx.x; i < rows; i += 32 * CONSUMERS) w_s[i] = wsort[row0 + i];
  if (nt == 1)
    down_consume<W4, 1>(base, bars, cs_s, w_s, part, nk, row0, rows, j0, D);
  else
    down_consume<W4, 2>(base, bars, cs_s, w_s, part, nk, row0, rows, j0, D);
}

// W4: w1 int8 [L, E, 2I, D/2] packed, s1 bf16 w1sg, w2 int8 [L, E, I, D/2]
// packed, s2 bf16 w2s8; else w1 int8 [L, E, 2I, D], s1 f32 [L, E, 8, 2I],
// w2 int8 [L, E, I, D], s2 f32 [L, E, 8, D]. The rest as the C entry points.
template <bool W4>
int moe_bf16x(const void* x, const void* ind, const void* wts, int w_bf16, const void* w1,
              const void* s1, const void* w2, const void* s2, void* xs, void* wsort, void* pos,
              void* meta, void* work, void* h, void* part, void* out, int T, int k, int D, int I,
              int L, int E, int U, int layer, void* stream) {
  const int Db = W4 ? D / 2 : D;  // bytes of a weight row
  const int ng = W4 ? aria::int4_group_count(D) : 1;
  if (T < 1 || T > 128 || k < 1 || U < 1 || D % 128 || Db % BOXB || I % 8 ||
      (W4 && D / ng / 2 % BOXB))
    return (int)cudaErrorInvalidValue;
  const int n = T * k, entries = U + (n + TOK - 1) / TOK;
  CUtensorMap w1m, xm, w2m, hm;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!map_rows(&w1m, w1, L * E, 2 * I, Db, BOXB, GU_I, sw) ||
      !map_rows(&xm, xs, 0, n, D, 64, 8, sw, bf16, 2) ||
      !map_rows(&w2m, w2, L * E, I, Db, BOXB, DN_K, sw) ||
      !map_rows(&hm, h, 0, n, I, 64, 8, sw, bf16, 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_prep<false>(x, ind, wts, w_bf16, xs, nullptr, wsort, pos, meta, work,
                                       T, k, D, ng, E, U, st);
  if (err != cudaSuccess) return err;
  using GR = typename GateUp<W4>::R;
  if ((err = aria::allow_smem(bf16x_gateup_kernel<W4>, GR::BYTES)) != cudaSuccess) return err;
  bf16x_gateup_kernel<W4><<<dim3((I + GU_I - 1) / GU_I, entries), THREADS, GR::BYTES, st>>>(
      w1m, xm, (const int*)meta, (const int*)work, s1, (__nv_bfloat16*)h, D, I, E, U, ng, layer);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = aria::allow_smem(bf16x_down_kernel<W4>, DNRing::BYTES)) != cudaSuccess) return err;
  bf16x_down_kernel<W4><<<dim3(Db / BOXB, entries), THREADS, DNRing::BYTES, st>>>(
      w2m, hm, (const int*)meta, (const int*)work, (const float*)wsort, s2, (float*)part, D, I,
      E, U, layer);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_combine(part, ind, pos, out, T, k, D, st);
}

}  // namespace

// x bf16 [T, D]; ind int32 [T, k]; wts [T, k] bf16 (w_bf16) or f32; the
// stacks w1q4 [L, E, 2I, D/2], w1sg [L, E, 8, 2I], w2q4 [L, E, I, D/2],
// w2s8 [L, E, 8, D]. Scratch, one row a pair (n = T*k): xs bf16 [n, D],
// wsort f32 [n], pos int32 [n], meta int32 [4, U], work int32 [U + ceil(n /
// 16)], h bf16 [n, I], part f32 [n, D]; out bf16 [T, D].
ARIA_EXPORT int aria_moe_bf16x_int4(const void* x, const void* ind, const void* wts, int w_bf16,
                                    const void* w1q4, const void* w1sg, const void* w2q4,
                                    const void* w2s8, void* xs, void* wsort, void* pos,
                                    void* meta, void* work, void* h, void* part, void* out, int T,
                                    int k, int D, int I, int L, int E, int U, int layer,
                                    void* stream) {
  return moe_bf16x<true>(x, ind, wts, w_bf16, w1q4, w1sg, w2q4, w2s8, xs, wsort, pos, meta, work,
                         h, part, out, T, k, D, I, L, E, U, layer, stream);
}

// the same with the int8 stacks w1q [L, E, 2I, D] and its s8 f32 [L, E, 8,
// 2I], w2q [L, E, I, D] and its s8 f32 [L, E, 8, D]
ARIA_EXPORT int aria_moe_bf16x_int8(const void* x, const void* ind, const void* wts, int w_bf16,
                                    const void* w1q, const void* s1, const void* w2q,
                                    const void* s2, void* xs, void* wsort, void* pos, void* meta,
                                    void* work, void* h, void* part, void* out, int T, int k,
                                    int D, int I, int L, int E, int U, int layer, void* stream) {
  return moe_bf16x<false>(x, ind, wts, w_bf16, w1q, s1, w2q, s2, xs, wsort, pos, meta, work, h,
                          part, out, T, k, D, I, L, E, U, layer, stream);
}
