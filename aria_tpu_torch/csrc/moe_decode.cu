// moe_decode_int4, W4A8 form: the fused GLU MoE FFN over the routed
// (token, expert) pairs, for T <= 128 token rows.
//
// Replaces aria_tpu/ops/moe_decode_kernel.py:450 moe_decode_int4 with
// act_int8=True (`_kernel_q4_a8` :288, `_ffn_q4_a8` :227), its
// act_quant_int8 (:215, in prep_kernel) and `_unique_meta` (:44). For each
// pair p = (token t, slot s) of the T*k routing slots, with e = indices[t, s]:
//
//   xq, sx  = int8 x per (token, D-group)                  prep_kernel
//   h[p]    = silu(sum_g (G_g . sx) . sg) * (the same for up) in f32,
//             G_g the exact int32 dot of D-group g          gateup_kernel
//   hq, sh  = int8 h per pair over the whole intermediate   hquant_kernel
//   part[p] = w[t, s] * ((P . sh) . c), P the exact int32
//             down dot                                      down_kernel
//   out[t]  = the sum of t's parts, cast to bf16            combine_kernel
//
// Only routed rows. The reference runs every token row through every
// active expert and multiplies the rows that did not pick it by a zero
// combine weight; at T = 32 that is 66 x 32 rows for 256 real pairs. Here
// prep_kernel (moe_pairs.cuh) lists the pairs sorted by expert and copies
// each token's int8 row and scales to its pairs' places, so an expert's rows
// are contiguous and come by TMA boxes. h, hq and the f32 partials are one
// row a pair, [T*k, .]. The combine adds a token's pairs in the reference's
// order from 0, so every output bit is the reference's (the only difference
// is a non-finite partial of an unrouted row, which the reference would
// spread; ROADMAP queue 3).
//
// Integer products on the tensor cores: mma.sync m16n8k32 s8 x s8 -> s32,
// weights the M side (16 rows of w1, or 16 packed columns of w2), token
// rows the N side in tiles of 8, 32 token rows a block. The nibbles are
// unpacked in registers to int8 times 16, exactly: with a biased-lo byte
// B = 16 hi + (lo + 8), B & 0xF0 is 16 hi as a signed byte, and
// ((B << 4) ^ 0x80) & 0xF0 is 16 lo (three bit operations a word of four
// bytes). So x.lo + x.hi over a group is one int32 sum of two products,
// 16 G, shifted right by 4 at the group's end: two products and one
// accumulator, where the TPU identity on the raw bytes (xa.B - xa.hi16 -
// 8 sum(xa) + (xb.hi16 >> 4)) needs three products or two accumulators and
// the bias. Each int32 group sum is then scaled and added in _ffn_q4_a8's
// order with __fmul_rn / __fadd_rn, so the kernel is bit-equal to
// moe_decode_int4_plain up to the last ulp of expf in the sigmoid.
//
// w1: within-group nibble pairing, so the 128 packed bytes of a stage feed
// the low nibbles against x's columns g*gs + j.. and the high ones against
// g*gs + gs/2 + j..; each thread takes 32 contiguous packed bytes of a row
// and the same 32 x bytes (the contraction's order within the 32 is free,
// as long as both operands share it). w2 pairs over the output axis (byte
// j of row i holds columns j and j + D/2) and its contraction axis is the
// rows: 4x4 byte transposes (prmt) turn four rows of four packed columns
// into the K-contiguous words the fragments take.
//
// Bound: the used experts' weights, 3*I*D/2 bytes each (6.4 MB at I =
// 1664, D = 2560), read once a call through a TMA ring (4 stages of 24 KB
// for gate/up, 4 of 20 KB for down, each weight row 128 bytes a box row)
// fed by one producer thread; blocks are 64 intermediate columns x 32 token
// rows of an expert for gate/up (26 a chunk of an expert) and 128 packed
// columns (256 outputs) x 32 token rows for down (10), so one stream's 8
// experts fill 208 and 80 blocks. The group scales and the epilogues'
// scales are loaded into shared memory while the ring fills. The int32
// sums are exact in any order and every float step runs in a fixed order,
// so the result does not depend on scheduling (no atomics).

#include "moe_pairs.cuh"

namespace {

constexpr int TOK = 32;                  // token rows a block takes
constexpr int NT = TOK / 8;              // n-tiles of 8 rows
constexpr int CONSUMERS = 4;             // consumer warps
constexpr int THREADS = 32 * (CONSUMERS + 1);  // and one producer warp
constexpr int XBOX = 8 * 128;            // a box of 8 int8 rows x 128 bytes
// gate/up: 64 intermediate columns a block (16 a warp), 64 gate rows and the
// 64 up rows of the same columns, 128 packed bytes (256 elements of D) a stage
constexpr int GU_I = 64;
constexpr int GU_PB = 128;
constexpr int GU_WBOX = GU_I * GU_PB;                 // 8 KB
constexpr int GU_STAGE = 2 * GU_WBOX + 2 * NT * XBOX;  // w1, x lo, x hi: 24 KB
constexpr int GU_STAGES = 4;
// down: 128 packed columns (256 outputs) a block, 128 rows of w2 a stage;
// warp w takes packed columns 32w..
constexpr int DN_J = 128;
constexpr int DN_K = 128;
constexpr int DN_WBOX = DN_K * DN_J;             // 16 KB
constexpr int DN_STAGE = DN_WBOX + NT * XBOX;    // w2, hq: 20 KB
constexpr int DN_STAGES = 4;
using GURing = Ring<GU_STAGE, GU_STAGES, (8 * 2 * GU_I + TOK * 8) * 4>;  // sg [8][2][64], sx [32][8]
using DNRing = Ring<DN_STAGE, DN_STAGES, (2 * DN_J + 2 * TOK) * 4>;      // c [128], sh, w [32]

using aria::hi16;
using aria::lo16;
using aria::mma_s8;

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

// the block's expert, its first sorted row for this chunk and the chunk's
// row count; false where the block has no rows (block-uniform)
__device__ __forceinline__ bool block_rows(const int* __restrict__ meta, int U, int u, int chunk,
                                           int& e, int& row0, int& rows) {
  if (!meta[U + u]) return false;
  const int cnt = meta[3 * U + u];
  if (chunk * TOK >= cnt) return false;
  e = meta[u];
  row0 = meta[2 * U + u] + chunk * TOK;
  rows = min(TOK, cnt - chunk * TOK);
  return true;
}

__global__ void __launch_bounds__(THREADS, 2)
gateup_kernel(const __grid_constant__ CUtensorMap w1_map, const __grid_constant__ CUtensorMap x_map,
              const int* __restrict__ meta, const float* __restrict__ sxs,
              const __nv_bfloat16* __restrict__ w1sg, float* __restrict__ h, int D, int I, int E,
              int U, int ng, int layer, int chunks) {
  const int chunk = blockIdx.x % chunks, i0 = blockIdx.x / chunks * GU_I;
  int e, row0, rows;
  if (!block_rows(meta, U, blockIdx.y, chunk, e, row0, rows)) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + GURing::BAR;
  init_bars<GU_STAGES>(bars, CONSUMERS);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = (rows + 7) / 8;
  const int le = layer * E + e;
  const int gs = D / ng, gsp = gs / 2, nk = D / 2 / GU_PB, spg = gsp / GU_PB;

  if (warp == CONSUMERS) {  // the producer: one thread starts every load
    if (lane == 0) {
      const uint32_t bytes = 2 * GU_WBOX + 2 * nt * XBOX;
      for (int c = 0; c < nk; ++c) {
        const int s = c % GU_STAGES;
        const uint32_t st = base + s * GU_STAGE, full = bars + 8 * s;
        if (c >= GU_STAGES) aria::mbar_wait(bars + 8 * (GU_STAGES + s), (c / GU_STAGES - 1) & 1);
        aria::mbar_expect_tx(full, bytes);
        aria::tma_load(st, &w1_map, full, c * GU_PB, i0, le);
        aria::tma_load(st + GU_WBOX, &w1_map, full, c * GU_PB, I + i0, le);
        const int g = c / spg, xc = g * gs + (c - g * spg) * GU_PB;
        for (int b = 0; b < nt; ++b) {
          aria::tma_load(st + 2 * GU_WBOX + b * XBOX, &x_map, full, xc, row0 + 8 * b);
          aria::tma_load(st + 2 * GU_WBOX + (NT + b) * XBOX, &x_map, full, xc + gsp, row0 + 8 * b);
        }
      }
    }
    return;
  }

  float* sg_s = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) + GURing::SCALES);
  float* sx_s = sg_s + 8 * 2 * GU_I;
  for (int i = threadIdx.x; i < ng * 2 * GU_I; i += 32 * CONSUMERS) {
    const int g = i / (2 * GU_I), m = i / GU_I % 2, row = min(i0 + i % GU_I, I - 1);
    sg_s[i] = aria::bf2f(w1sg[((size_t)le * 8 + g) * 2 * I + m * I + row]);
  }
  for (int i = threadIdx.x; i < rows * 8; i += 32 * CONSUMERS) sx_s[i] = sxs[(size_t)row0 * 8 + i];
  asm volatile("bar.sync 1, %0;\n" :: "n"(32 * CONSUMERS) : "memory");
  const int q = lane >> 2, r = lane & 3;
  int acc[2][NT][4];      // [gate, up][n-tile]: 16 G of the current group
  float tot[2][NT][4];    // the scaled sum over the groups so far
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0, tot[m][n][i] = 0.f;
  const int wrow = warp * 16 + q;  // this thread's rows wrow and wrow + 8 of each box

  for (int c = 0; c < nk; ++c) {
    const int s = c % GU_STAGES;
    const uint32_t st = base + s * GU_STAGE;
    aria::mbar_wait(bars + 8 * s, (c / GU_STAGES) & 1);
    uint32_t w[2][2][8];  // [gate, up][row wrow, wrow + 8]: packed bytes 32r..32r+31
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const uint4 t4 = lds128(st + m * GU_WBOX + sw128(wrow + 8 * hr, 32 * r + 16 * v));
          w[m][hr][4 * v] = t4.x, w[m][hr][4 * v + 1] = t4.y;
          w[m][hr][4 * v + 2] = t4.z, w[m][hr][4 * v + 3] = t4.w;
        }
    // n-tile by n-tile: token row q's x bytes 32r..32r+31, low and high
    // columns, against the weights' k steps t: packed bytes 32r + 8t.. (a0,
    // a1) and 32r + 8t + 4.. (a2, a3), unpacked anew for each n-tile
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (n < nt) {
        uint32_t xl[8], xh[8];
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const uint4 a = lds128(st + 2 * GU_WBOX + n * XBOX + sw128(q, 32 * r + 16 * v));
          const uint4 b = lds128(st + 2 * GU_WBOX + (NT + n) * XBOX + sw128(q, 32 * r + 16 * v));
          xl[4 * v] = a.x, xl[4 * v + 1] = a.y, xl[4 * v + 2] = a.z, xl[4 * v + 3] = a.w;
          xh[4 * v] = b.x, xh[4 * v + 1] = b.y, xh[4 * v + 2] = b.z, xh[4 * v + 3] = b.w;
        }
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const uint32_t alo[4] = {lo16(w[m][0][2 * t]), lo16(w[m][1][2 * t]),
                                     lo16(w[m][0][2 * t + 1]), lo16(w[m][1][2 * t + 1])};
            const uint32_t ahi[4] = {hi16(w[m][0][2 * t]), hi16(w[m][1][2 * t]),
                                     hi16(w[m][0][2 * t + 1]), hi16(w[m][1][2 * t + 1])};
            mma_s8(acc[m][n], alo, xl[2 * t], xl[2 * t + 1]);
            mma_s8(acc[m][n], ahi, xh[2 * t], xh[2 * t + 1]);
          }
      }
    __syncwarp();
    if (lane == 0) aria::mbar_arrive(bars + 8 * (GU_STAGES + s));

    if ((c + 1) % spg == 0) {  // the end of D-group g: (G . sx) . sg, added in group order
      const int g = c / spg;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float sgv[2] = {sg_s[(g * 2 + m) * GU_I + wrow], sg_s[(g * 2 + m) * GU_I + wrow + 8]};
#pragma unroll
        for (int n = 0; n < NT; ++n)
          if (n < nt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int tok = min(n * 8 + 2 * r + (i & 1), rows - 1);
              const float sx = sx_s[tok * 8 + g];
              const float d = __fmul_rn(__fmul_rn((float)(acc[m][n][i] >> 4), sx), sgv[i >> 1]);
              tot[m][n][i] = g == 0 ? d : __fadd_rn(tot[m][n][i], d);
              acc[m][n][i] = 0;
            }
          }
      }
    }
  }

  // h = silu(gate) * up in f32, one row a pair
#pragma unroll
  for (int n = 0; n < NT; ++n)
    if (n < nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tok = n * 8 + 2 * r + (i & 1), col = i0 + wrow + 8 * (i >> 1);
        if (tok < rows && col < I) {
          const float gt = tot[0][n][i], up = tot[1][n][i];
          const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-gt)));
          h[(size_t)(row0 + tok) * I + col] = __fmul_rn(__fmul_rn(gt, sig), up);
        }
      }
    }
}

__global__ void hquant_kernel(const float* __restrict__ h, int8_t* __restrict__ hq,
                              float* __restrict__ sh, int I) {
  __shared__ float redf[32];
  const int p = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const float* hr = h + (size_t)p * I;
  float a = 0.f;
  for (int i = threadIdx.x; i < I; i += blockDim.x) a = fmaxf(a, fabsf(hr[i]));
  a = aria::warp_max(a);
  if (lane == 0) redf[warp] = a;
  __syncthreads();
  float amax = 0.f;
  for (int w = 0; w < nw; ++w) amax = fmaxf(amax, redf[w]);
  const float sc = fmaxf(amax * (1.f / 127.f), 1e-8f);
  for (int i = threadIdx.x; i < I; i += blockDim.x)
    hq[(size_t)p * I + i] = (int8_t)fminf(fmaxf(rintf(hr[i] / sc), -127.f), 127.f);
  if (threadIdx.x == 0) sh[p] = sc;
}

__global__ void __launch_bounds__(THREADS, 2)
down_kernel(const __grid_constant__ CUtensorMap w2_map, const __grid_constant__ CUtensorMap hq_map,
            const int* __restrict__ meta, const float* __restrict__ sh,
            const float* __restrict__ wsort, const __nv_bfloat16* __restrict__ w2s8,
            float* __restrict__ part, int D, int I, int E, int U, int layer, int chunks) {
  const int chunk = blockIdx.x % chunks, j0 = blockIdx.x / chunks * DN_J;
  int e, row0, rows;
  if (!block_rows(meta, U, blockIdx.y, chunk, e, row0, rows)) return;
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
      const uint32_t bytes = DN_WBOX + nt * XBOX;
      for (int c = 0; c < nk; ++c) {
        const int s = c % DN_STAGES;
        const uint32_t st = base + s * DN_STAGE, full = bars + 8 * s;
        if (c >= DN_STAGES) aria::mbar_wait(bars + 8 * (DN_STAGES + s), (c / DN_STAGES - 1) & 1);
        aria::mbar_expect_tx(full, bytes);
        aria::tma_load(st, &w2_map, full, j0, c * DN_K, le);  // rows past I load as zeros
        for (int b = 0; b < nt; ++b)
          aria::tma_load(st + DN_WBOX + b * XBOX, &hq_map, full, c * DN_K, row0 + 8 * b);
      }
    }
    return;
  }

  const size_t c8 = (size_t)le * 8 * D;  // row 0 of s8: the column scales c/7
  float* cs_s = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) + DNRing::SCALES);
  float* sh_s = cs_s + 2 * DN_J;
  float* w_s = sh_s + TOK;
  for (int i = threadIdx.x; i < 2 * DN_J; i += 32 * CONSUMERS)
    cs_s[i] = aria::bf2f(w2s8[c8 + j0 + i % DN_J + i / DN_J * (D / 2)]);
  for (int i = threadIdx.x; i < rows; i += 32 * CONSUMERS) sh_s[i] = sh[row0 + i], w_s[i] = wsort[row0 + i];
  const int q = lane >> 2, r = lane & 3;
  const int jb = 32 * warp;
  int acc[2][2][NT][4];  // [m][lo, hi][n-tile]: 16 P
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int lh = 0; lh < 2; ++lh)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][lh][n][i] = 0;

  for (int c = 0; c < nk; ++c) {
    const int s = c % DN_STAGES;
    const uint32_t st = base + s * DN_STAGE;
    aria::mbar_wait(bars + 8 * s, (c / DN_STAGES) & 1);
#pragma unroll
    for (int step = 0; step < DN_K / 32; ++step) {
      const int ib = 32 * step;
      uint32_t rw[8];  // rows ib + 4r + cc and ib + 16 + 4r + cc, packed columns jb + 4q..
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        rw[cc] = lds32(st + sw128(ib + 4 * r + cc, jb + 4 * q));
        rw[4 + cc] = lds32(st + sw128(ib + 16 + 4 * r + cc, jb + 4 * q));
      }
      uint32_t t1[4], t2[4];  // column jb + 4q + cc: rows ib + 4r.. and ib + 16 + 4r..
      transpose4(rw[0], rw[1], rw[2], rw[3], t1);
      transpose4(rw[4], rw[5], rw[6], rw[7], t2);
      uint32_t a[2][2][4];  // [m][lo, hi]: rows q, q + 8 = columns jb + 4q + 2m, + 1
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint32_t raw[4] = {t1[2 * m], t1[2 * m + 1], t2[2 * m], t2[2 * m + 1]};
#pragma unroll
        for (int i = 0; i < 4; ++i) a[m][0][i] = lo16(raw[i]), a[m][1][i] = hi16(raw[i]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
        if (n < nt) {
          const uint32_t hb = st + DN_WBOX + n * XBOX;
          const uint32_t b0 = lds32(hb + sw128(q, ib + 4 * r));
          const uint32_t b1 = lds32(hb + sw128(q, ib + 16 + 4 * r));
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int lh = 0; lh < 2; ++lh) mma_s8(acc[m][lh][n], a[m][lh], b0, b1);
        }
    }
    __syncwarp();
    if (lane == 0) aria::mbar_arrive(bars + 8 * (DN_STAGES + s));
  }

  // the scales: sh and w a pair, c a column (every consumer's loads are
  // behind this barrier)
  asm volatile("bar.sync 1, %0;\n" :: "n"(32 * CONSUMERS) : "memory");
#pragma unroll
  for (int n = 0; n < NT; ++n)
    if (n < nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tok = n * 8 + 2 * r + (i & 1);
        if (tok >= rows) continue;
        const float shp = sh_s[tok], wp = w_s[tok];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int lh = 0; lh < 2; ++lh) {
            const int P = acc[m][lh][n][i] >> 4;
            const int col = jb + 4 * q + 2 * m + (i >> 1);  // of the block's 128
            const float cs = cs_s[lh * DN_J + col];
            part[(size_t)(row0 + tok) * D + j0 + col + lh * (D / 2)] =
                __fmul_rn(wp, __fmul_rn(__fmul_rn((float)P, shp), cs));
          }
      }
    }
}

}  // namespace

// x bf16 [T, D]; ind int32 [T, k]; wts [T, k] bf16 (w_bf16) or f32; the
// stacks w1q4 [L, E, 2I, D/2], w1sg [L, E, 8, 2I], w2q4 [L, E, I, D/2],
// w2s8 [L, E, 8, D]. Scratch, one row a pair (n = T*k): xs int8 [n, D],
// sxs f32 [n, 8], wsort f32 [n], pos int32 [n], meta int32 [4, U], h f32
// [n, I], hq int8 [n, I], sh f32 [n], part f32 [n, D]; out bf16 [T, D].
ARIA_EXPORT int aria_moe_w4a8(const void* x, const void* ind, const void* wts, int w_bf16,
                              const void* w1q4, const void* w1sg, const void* w2q4,
                              const void* w2s8, void* xs, void* sxs, void* wsort, void* pos,
                              void* meta, void* h, void* hq, void* sh, void* part, void* out,
                              int T, int k, int D, int I, int L, int E, int U, int ng, int layer,
                              void* stream) {
  const int gsp = D / ng / 2;
  if (T < 1 || T > 128 || k < 1 || D % 256 || gsp % GU_PB || I % 16 || U < 1)
    return (int)cudaErrorInvalidValue;
  const int n = T * k;
  CUtensorMap w1m, xm, w2m, hm;
  if (!map_rows(&w1m, w1q4, L * E, 2 * I, D / 2, GU_PB, GU_I, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !map_rows(&xm, xs, 0, n, D, 128, 8, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !map_rows(&w2m, w2q4, L * E, I, D / 2, DN_J, DN_K, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !map_rows(&hm, hq, 0, n, I, 128, 8, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_prep<true>(x, ind, wts, w_bf16, xs, sxs, wsort, pos, meta, nullptr,
                                      T, k, D, ng, E, U, st);
  if (err != cudaSuccess) return err;
  const int chunks = (T + TOK - 1) / TOK;
  if ((err = aria::allow_smem(gateup_kernel, GURing::BYTES)) != cudaSuccess) return err;
  gateup_kernel<<<dim3((I + GU_I - 1) / GU_I * chunks, U), THREADS, GURing::BYTES, st>>>(
      w1m, xm, (const int*)meta, (const float*)sxs, (const __nv_bfloat16*)w1sg, (float*)h, D, I,
      E, U, ng, layer, chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  hquant_kernel<<<n, 256, 0, st>>>((const float*)h, (int8_t*)hq, (float*)sh, I);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t dn_smem = DNRing::BYTES;
  if ((err = aria::allow_smem(down_kernel, dn_smem)) != cudaSuccess) return err;
  down_kernel<<<dim3(D / 2 / DN_J * chunks, U), THREADS, dn_smem, st>>>(
      w2m, hm, (const int*)meta, (const float*)sh, (const float*)wsort,
      (const __nv_bfloat16*)w2s8, (float*)part, D, I, E, U, layer, chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_combine(part, ind, pos, out, T, k, D, st);
}
