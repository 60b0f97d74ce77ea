// moe_prefill: the segmented grouped GLU-FFN over packed int4 experts for
// prefill-sized token counts, in two kernels.
//
//   glu:  h[r, i] = silu(sum_g (x_g[r] . w1g_g[e, i]) sg_g[e, i])
//                   * (sum_g (x_g[r] . w1u_g[e, i]) su_g[e, i])      (bf16 out)
//   down: out[r, :] = (h[r] . w2[e]) * c[e]                          (f32 out)
//
// with e = tile_expert[r / 128] and the sums over the D-groups g in group
// order: rows are the routing slots sorted by expert into segments padded
// to 128 rows, so every 128-row tile belongs to one expert, and the first
// tile_rows[t] rows of tile t are routed. Only those are computed: a tile
// of n rows runs at a wgmma N of n rounded up to 16, 32, 48, 64, 96 or 128
// (a template argument: each block takes the instantiation its tile's
// count selects), and the rest of its 128 rows are written as zeros, the
// output of a zero row. A tile of 0 rows is skipped and left unwritten.
// Every output element is the same sum of the same products in the same
// order whatever N its block runs at, so a row's bits do not depend on the
// rows that share its tile.
//
// Replaces aria_tpu/ops/moe_prefill_kernel.py:120 moe_prefill_int4 (`_k1_glu`
// :52, `_k2_down` :91). The TPU kernels accumulate over the intermediate
// tile in the output block along a sequential grid axis and compute every
// row of a tile; here a block loops over the whole contraction itself and
// reads its own tile_expert and tile_rows entries in place of the scalar
// prefetch.
//
// Weights are the JAX package's bytes: w1q4 [L, E, 2I, D/2] (gate rows,
// then up rows; within-group nibble pairing over D: byte j of D-group g
// holds element g*gs + j in the biased low nibble and g*gs + gs/2 + j in
// the high one) with bf16 scales w1sg [L, E, 8, 2I] (row g = D-group g);
// w2q4 [L, E, I, D/2] whole-row paired over D (byte j holds columns j and
// j + D/2) with the column scale c in every row of w2s8 [L, E, 8, D].
//
// Design: both products are out^T = W . rows^T on wgmma, as dense_int4.cu
// computes: the packed weights are the M side, brought by TMA into a ring
// (64-byte swizzle) and unpacked in registers into bf16 A fragments, where
// -8..7 are exact (128 + n built in the mantissa, less 136); the tile's
// token rows are the N side, brought by TMA as K-major boxes of 16 rows
// with the 128-byte swizzle. 384 threads: two consumer warpgroups, and a
// producer warpgroup whose first thread keeps the ring full. The products
// are exact and the sums f32. A stage's products are one batch; the next
// stage is unpacked while they run, into a second set of A registers.
//
// - glu: a block takes 64 intermediate columns of one tile, 32 for each
//   consumer warpgroup, whose 64 M rows are the 32 gate rows (fragment rows
//   16w + q) and the matching up rows (16w + q + 8): each thread holds a
//   gate sum and its up sum, and forms silu(gate) . up itself. A D-group's
//   sum is its own accumulator set; at the group's end it is scaled and
//   added to the total in group order. The totals wait in shared memory: two
//   m64n128 sets and a stage's A fragments exceed the 168 registers a
//   384-thread block compiles to. At T = 4096 the unpacking takes ~12% of
//   the kernel's time, the loads ~3%, the groups' ends (5 a tile at the
//   flagship's D, each draining the tensor cores) ~9%; the rest runs at
//   ~57% of the bf16 peak, where a bare loop of these products reaches 98%
//   (tools/moe_prefill_probe.py).
// - down: a block takes 64 packed w2 columns of one tile. A packed byte
//   holds output columns j (low nibble) and j + D/2 (high), so consumer
//   warpgroup 0 computes the first and 1 the second from the same staged
//   bytes. K runs along w2's rows, so an A fragment's two k of one M row
//   lie in two rows of the stage: a thread's two fragment rows are adjacent
//   packed columns, one 16-bit load brings both rows' bytes at one k, and a
//   byte permute pairs each row's two k.
//
// ptxas serializes every product (each wgmma waits for the one before) when
// a non-wgmma instruction writes the sums between products (C7515: so the
// first product overwrites them instead of zeroing), when the ring's wait is
// a C++ loop (C7518: it is one PTX loop, mbar_wait_loop), and when a branch
// separates two batches. Serialized, the kernels ran at half their speed.
//
// Bound: at a 512-token prompt (6 routed + 2 shared experts per token) the
// 66 experts' 428 MB of packed weights, each read once; above ~1,000
// tokens the bf16 tensor cores (6 I D operations per routed row: 25.6 MFLOP
// at the flagship). The blocks of one expert's tiles run next to each other
// (the grid's row of tiles follows the segments), so a shared expert's
// repeated weights come from L2.

#include "hopper.cuh"

namespace {

constexpr int TM = 128;          // rows per expert tile
constexpr int PB = 64;           // packed weight bytes of a box row (64-byte swizzle)
constexpr int XROW = 128;        // bytes of an x or h box row: 64 bf16, 128-byte swizzle
constexpr int BOX = 16;          // rows of an x or h box: TN rows are TN / 16 boxes
constexpr int CONSUMERS = 256;   // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup

// glu: 64 intermediate columns (a gate box and an up box of 64 W rows
// each) of one tile a block, 64 packed bytes of a W row (128 elements of
// D) a stage
constexpr int G_COLS = 64;
constexpr int G_W = 2 * G_COLS * PB;
constexpr int G_X = TM * XROW;  // the low or the high nibbles' x, at most
constexpr int G_STAGE = G_W + 2 * G_X;
constexpr int G_STAGES = 4;
constexpr int G_BAR = G_STAGE * G_STAGES;
constexpr int G_TOT = G_BAR + 16 * G_STAGES;
constexpr int G_SMEM = G_TOT + CONSUMERS * TM / 2 * 4 + 1024;

// down: 64 packed columns (128 output columns) a block, 64 rows of w2 (K)
// a stage
constexpr int D_COLS = 64;
constexpr int D_KS = 64;
constexpr int D_W = D_KS * D_COLS;
constexpr int D_H = TM * XROW;
constexpr int D_STAGE = D_W + D_H;
constexpr int D_STAGES = 8;
constexpr int D_BAR = D_STAGE * D_STAGES;
constexpr int D_SMEM = D_BAR + 16 * D_STAGES + 1024;

using aria::lds16;
using aria::swz;

// fn<TN>(...) with TN the wgmma N of a tile of n routed rows (1..128): n
// rounded up to 16, 32, 48, 64, 96 or 128
#define BY_WIDTH(n, fn, ...)               \
  if ((n) <= 16) fn<16>(__VA_ARGS__);      \
  else if ((n) <= 32) fn<32>(__VA_ARGS__); \
  else if ((n) <= 48) fn<48>(__VA_ARGS__); \
  else if ((n) <= 64) fn<64>(__VA_ARGS__); \
  else if ((n) <= 96) fn<96>(__VA_ARGS__); \
  else fn<128>(__VA_ARGS__)

// the ring's barriers: full[s] (the producer's expected bytes) and empty[s]
// (one arrival a consumer warp)
__device__ __forceinline__ void init_ring(uint32_t bars, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      aria::mbar_init(bars + 8 * s, 1);
      aria::mbar_init(bars + 8 * (stages + s), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// one tile's h columns i0..i0+63 at wgmma N = TN
template <int TN>
__device__ __forceinline__ void glu_tile(const CUtensorMap* w_map, const CUtensorMap* x_map,
                                         const __nv_bfloat16* __restrict__ sg,
                                         __nv_bfloat16* __restrict__ h, uint32_t base,
                                         float* tot_s, int t0, int n, int we, int D, int I,
                                         int ng) {
  constexpr int NA = TN / 2;  // accumulator registers
  const uint32_t bars = base + G_BAR;
  const int i0 = blockIdx.x * G_COLS;
  const int gs = D / ng, gsp = gs / 2, spg = gsp / PB, nk = ng * spg;
  if (threadIdx.x >= CONSUMERS) {  // the producer: one thread starts every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMERS) {
      for (int c = 0; c < nk; ++c) {
        const int s = c % G_STAGES, g = c / spg, jg = (c % spg) * PB;
        const uint32_t st = base + s * G_STAGE, full = bars + 8 * s;
        if (c >= G_STAGES)
          aria::mbar_wait_loop(bars + 8 * (G_STAGES + s), (c / G_STAGES - 1) & 1);
        aria::mbar_expect_tx(full, G_W + 2 * TN * XROW);
        aria::tma_load(st, w_map, full, g * gsp + jg, i0, we);
        aria::tma_load(st + G_COLS * PB, w_map, full, g * gsp + jg, I + i0, we);
        for (int b = 0; b < TN / BOX; ++b) {
          const uint32_t xb = st + G_W + b * BOX * XROW;
          aria::tma_load(xb, x_map, full, g * gs + jg, t0 + b * BOX);
          aria::tma_load(xb + G_X, x_map, full, g * gs + gsp + jg, t0 + b * BOX);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int q = lane / 4, r = lane % 4;
  const int row = 32 * cw + 8 * warp + q;  // this thread's row of the gate box and of the up box
  const __nv_bfloat16* sgg = sg + (size_t)we * 8 * 2 * I + i0 + row;
  const __nv_bfloat16* sgu = sgg + I;

  // A D-group's first product overwrites the sums (zeroing them would make
  // ptxas serialize the products, C7515).
  float acc[NA];
  __nv_bfloat16 sa, sb;  // the group's gate and up scales

  // stage c's A fragments: k16 steps of 16 packed bytes, each feeding a
  // low- and a high-nibble product
  auto unpack = [&](int c, uint32_t (&alo)[PB / 16][4], uint32_t (&ahi)[PB / 16][4]) {
    const int s = c % G_STAGES;
    const uint32_t wg = base + s * G_STAGE, wu = wg + G_COLS * PB;
    aria::mbar_wait_loop(bars + 8 * s, (c / G_STAGES) & 1);
#pragma unroll
    for (int kk = 0; kk < PB / 16; ++kk) {
      // fragment row 16w + q: the gate row; 16w + q + 8: the up row
      aria::unpack2(lds16(wg + swz<PB>(row, 16 * kk + 2 * r)), alo[kk][0], ahi[kk][0]);
      aria::unpack2(lds16(wu + swz<PB>(row, 16 * kk + 2 * r)), alo[kk][1], ahi[kk][1]);
      aria::unpack2(lds16(wg + swz<PB>(row, 16 * kk + 8 + 2 * r)), alo[kk][2], ahi[kk][2]);
      aria::unpack2(lds16(wu + swz<PB>(row, 16 * kk + 8 + 2 * r)), alo[kk][3], ahi[kk][3]);
    }
    aria::fence_regs(alo);
    aria::fence_regs(ahi);
  };
  // stage c's products, one batch (and the scales of its group, read at
  // every stage: no branch)
  auto issue = [&](int c, uint32_t (&alo)[PB / 16][4], uint32_t (&ahi)[PB / 16][4]) {
    const uint32_t xl = base + c % G_STAGES * G_STAGE + G_W, xh = xl + G_X;
    sa = sgg[(size_t)(c / spg) * 2 * I], sb = sgu[(size_t)(c / spg) * 2 * I];
    aria::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PB / 16; ++kk) {
      aria::wgmma_rsn<TN>(acc, alo[kk], aria::sw128_desc(xl + kk * 32, 16, 1024), c % spg | kk);
      aria::wgmma_rsn<TN>(acc, ahi[kk], aria::sw128_desc(xh + kk * 32, 16, 1024));
    }
    aria::wgmma_commit();
  };
  // after stage c's batch is issued: the batch before waited for and its
  // stage given back
  auto settle = [&](int c) {
    aria::wgmma_wait<1>();
    if (c > 0 && lane == 0) aria::mbar_arrive(bars + 8 * (G_STAGES + (c - 1) % G_STAGES));
  };
  // at a D-group's end (after the next stage is unpacked): the group's sums
  // scaled and added to the total in group order
  auto close = [&](int c) {
    if (c % spg == spg - 1) {
      aria::wgmma_wait<0>();
      aria::fence_regs(acc);
      const float fa = aria::bf2f(sa), fb = aria::bf2f(sb);
#pragma unroll
      for (int j = 0; j < NA / 4; ++j) {  // acc[4j..4j+3]: gate, gate, up, up
        float4* ts = reinterpret_cast<float4*>(tot_s) + j * CONSUMERS + threadIdx.x;
        float4 t4 = c < spg ? make_float4(0.f, 0.f, 0.f, 0.f) : *ts;
        t4.x = __fmaf_rn(acc[4 * j], fa, t4.x);
        t4.y = __fmaf_rn(acc[4 * j + 1], fa, t4.y);
        t4.z = __fmaf_rn(acc[4 * j + 2], fb, t4.z);
        t4.w = __fmaf_rn(acc[4 * j + 3], fb, t4.w);
        *ts = t4;
      }
    }
  };
  // A stage is unpacked while the stage before's products run, into the
  // registers the products two stages back read. nk is even: a D-group is
  // an even number of stages.
  uint32_t alo0[PB / 16][4], ahi0[PB / 16][4], alo1[PB / 16][4], ahi1[PB / 16][4];
  unpack(0, alo0, ahi0);
  for (int c = 0; c < nk - 2; c += 2) {
    issue(c, alo0, ahi0);
    settle(c);
    unpack(c + 1, alo1, ahi1);
    close(c);
    issue(c + 1, alo1, ahi1);
    settle(c + 1);
    unpack(c + 2, alo0, ahi0);
    close(c + 1);
  }
  issue(nk - 2, alo0, ahi0);
  settle(nk - 2);
  unpack(nk - 1, alo1, ahi1);
  close(nk - 2);
  issue(nk - 1, alo1, ahi1);
  settle(nk - 1);
  close(nk - 1);

  // total j of the thread: tokens 8j + 2r and 8j + 2r + 1 of column i; the
  // rows past n are zeros
  const int i = i0 + row;
#pragma unroll 4
  for (int j = 0; j < NA / 4; ++j) {
    const float4 t4 = reinterpret_cast<const float4*>(tot_s)[j * CONSUMERS + threadIdx.x];
    const int tok = 8 * j + 2 * r;
    const float h0 = tok < n ? (t4.x * (1.f / (1.f + expf(-t4.x)))) * t4.z : 0.f;
    const float h1 = tok + 1 < n ? (t4.y * (1.f / (1.f + expf(-t4.y)))) * t4.w : 0.f;
    h[(size_t)(t0 + tok) * I + i] = __float2bfloat16_rn(h0);
    h[(size_t)(t0 + tok + 1) * I + i] = __float2bfloat16_rn(h1);
  }
  for (int k = threadIdx.x; k < (TM - TN) * G_COLS / 2; k += CONSUMERS) {
    const int tok = TN + k / (G_COLS / 2), col = i0 + 2 * (k % (G_COLS / 2));
    *reinterpret_cast<__nv_bfloat162*>(h + (size_t)(t0 + tok) * I + col) =
        __floats2bfloat162_rn(0.f, 0.f);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
prefill_glu(const __grid_constant__ CUtensorMap w_map, const __grid_constant__ CUtensorMap x_map,
            const int* __restrict__ tile_expert, const int* __restrict__ tile_rows,
            const __nv_bfloat16* __restrict__ sg, __nv_bfloat16* __restrict__ h, int D, int I,
            int E, int layer, int ng) {
  const int tile = blockIdx.y, n = min(tile_rows[tile], TM);
  if (n <= 0) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (aria::smem_u32(smem_raw) + 1023) & ~1023u;
  float* tot_s = reinterpret_cast<float*>(smem_raw + (base - aria::smem_u32(smem_raw)) + G_TOT);
  init_ring(base + G_BAR, G_STAGES);
  const int we = layer * E + tile_expert[tile], t0 = tile * TM;
  BY_WIDTH(n, glu_tile, &w_map, &x_map, sg, h, base, tot_s, t0, n, we, D, I, ng);
}

// one tile's output columns j0..j0+63 and j0 + D/2.. at wgmma N = TN
template <int TN>
__device__ __forceinline__ void down_tile(const CUtensorMap* w_map, const CUtensorMap* h_map,
                                          const __nv_bfloat16* __restrict__ w2s8,
                                          float* __restrict__ out, uint32_t base, int t0, int n,
                                          int we, int D, int I) {
  constexpr int NA = TN / 2;
  const uint32_t bars = base + D_BAR;
  const int j0 = blockIdx.x * D_COLS, nk = I / D_KS;
  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMERS) {
      for (int c = 0; c < nk; ++c) {
        const int s = c % D_STAGES;
        const uint32_t st = base + s * D_STAGE, full = bars + 8 * s;
        if (c >= D_STAGES)
          aria::mbar_wait_loop(bars + 8 * (D_STAGES + s), (c / D_STAGES - 1) & 1);
        aria::mbar_expect_tx(full, D_W + TN * XROW);
        aria::tma_load(st, w_map, full, j0, c * D_KS, we);
        for (int b = 0; b < TN / BOX; ++b)
          aria::tma_load(st + D_W + b * BOX * XROW, h_map, full, c * D_KS, t0 + b * BOX);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  // warpgroup 0 takes the low nibbles (output column j), 1 the high ones (j + D/2)
  const int cw = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int q = lane / 4, r = lane % 4;
  // the packed column of fragment row 16w + q; jj + 1: of row 16w + q + 8
  const int jj = 16 * warp + 2 * q;
  const int shift = 4 * cw;
  const uint32_t key = cw ? 0x43084308u : 0x43004300u;
  float acc[NA];  // the first product overwrites it: no zeroing, which would make
                 // ptxas serialize the products (C7515)

  // as in glu_tile: two stages in a row unpack into two sets of registers
  auto stage = [&](int c, uint32_t (&a)[D_KS / 16][4]) {
    const int s = c % D_STAGES;
    const uint32_t w = base + s * D_STAGE, hb = w + D_W;
    aria::mbar_wait_loop(bars + 8 * s, (c / D_STAGES) & 1);
#pragma unroll
    for (int kk = 0; kk < D_KS / 16; ++kk) {
      // rows k, k + 1 (a[0], a[1]) and k + 8, k + 9 (a[2], a[3]) of the
      // stage; byte 0 of each load is row 16w + q's, byte 1 row 16w + q + 8's
      const int k = 16 * kk + 2 * r;
      const uint32_t v0 = lds16(w + swz<PB>(k, jj)), v1 = lds16(w + swz<PB>(k + 1, jj));
      const uint32_t v8 = lds16(w + swz<PB>(k + 8, jj)), v9 = lds16(w + swz<PB>(k + 9, jj));
      a[kk][0] = aria::nibbles_bf16(__byte_perm(v0, v1, 0x0400), shift, key);
      a[kk][1] = aria::nibbles_bf16(__byte_perm(v0, v1, 0x0501), shift, key);
      a[kk][2] = aria::nibbles_bf16(__byte_perm(v8, v9, 0x0400), shift, key);
      a[kk][3] = aria::nibbles_bf16(__byte_perm(v8, v9, 0x0501), shift, key);
    }
    aria::fence_regs(a);
    aria::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D_KS / 16; ++kk)
      aria::wgmma_rsn<TN>(acc, a[kk], aria::sw128_desc(hb + kk * 32, 16, 1024), c | kk);
    aria::wgmma_commit();
    aria::wgmma_wait<1>();
    if (c > 0 && lane == 0) aria::mbar_arrive(bars + 8 * (D_STAGES + (c - 1) % D_STAGES));
  };
  uint32_t a0[D_KS / 16][4], a1[D_KS / 16][4];
  for (int c = 0; c < nk; c += 2) {  // nk is even: I is a multiple of 128
    stage(c, a0);
    stage(c + 1, a1);
  }
  aria::wgmma_wait<0>();
  aria::fence_regs(acc);

  // acc[4j..4j+3]: (column col, token 8j + 2r), (col, +1), (col + 1, 8j + 2r),
  // (col + 1, +1); the rows past n are zeros
  const int col = j0 + jj + cw * (D / 2);
  const __nv_bfloat16* c8 = w2s8 + (size_t)we * 8 * D;  // row 0
  const float c0 = aria::bf2f(c8[col]), c1 = aria::bf2f(c8[col + 1]);
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    const int tok = 8 * j + 2 * r;
    const bool ok0 = tok < n, ok1 = tok + 1 < n;
    *reinterpret_cast<float2*>(out + (size_t)(t0 + tok) * D + col) =
        make_float2(ok0 ? acc[4 * j] * c0 : 0.f, ok0 ? acc[4 * j + 2] * c1 : 0.f);
    *reinterpret_cast<float2*>(out + (size_t)(t0 + tok + 1) * D + col) =
        make_float2(ok1 ? acc[4 * j + 1] * c0 : 0.f, ok1 ? acc[4 * j + 3] * c1 : 0.f);
  }
  for (int k = threadIdx.x; k < (TM - TN) * D_COLS; k += CONSUMERS) {
    const int tok = TN + k / D_COLS, half = k % D_COLS / (D_COLS / 2);
    const int cc = j0 + 2 * (k % (D_COLS / 2)) + half * (D / 2);
    *reinterpret_cast<float2*>(out + (size_t)(t0 + tok) * D + cc) = make_float2(0.f, 0.f);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
prefill_down(const __grid_constant__ CUtensorMap w_map, const __grid_constant__ CUtensorMap h_map,
             const int* __restrict__ tile_expert, const int* __restrict__ tile_rows,
             const __nv_bfloat16* __restrict__ w2s8, float* __restrict__ out, int D, int I,
             int E, int layer) {
  const int tile = blockIdx.y, n = min(tile_rows[tile], TM);
  if (n <= 0) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (aria::smem_u32(smem_raw) + 1023) & ~1023u;
  init_ring(base + D_BAR, D_STAGES);
  const int we = layer * E + tile_expert[tile], t0 = tile * TM;
  BY_WIDTH(n, down_tile, &w_map, &h_map, w2s8, out, base, t0, n, we, D, I);
}

}  // namespace

// x_seg bf16 [R, D], tile_expert and tile_rows int32 [R / 128], w1q4 int8
// [L, E, 2I, D/2], w1sg bf16 [L, E, 8, 2I], h bf16 [R, I]
ARIA_EXPORT int aria_moe_prefill_glu(const void* x_seg, const void* tile_expert,
                                     const void* tile_rows, const void* w1q4, const void* w1sg,
                                     void* h, int R, int D, int I, int L, int E, int layer,
                                     void* stream) {
  const int ng = aria::int4_group_count(D);
  if (R % TM || (D / ng / 2) % (2 * PB) || I % G_COLS) return (int)cudaErrorInvalidValue;
  CUtensorMap wm, xm;
  const cuuint64_t wdims[3] = {(cuuint64_t)D / 2, 2 * (cuuint64_t)I, (cuuint64_t)L * E};
  const cuuint64_t wstrides[2] = {(cuuint64_t)D / 2, (cuuint64_t)I * D};
  const cuuint32_t wbox[3] = {PB, G_COLS, 1};
  const cuuint64_t xdims[2] = {(cuuint64_t)D, (cuuint64_t)R};
  const cuuint64_t xstrides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t xbox[2] = {64, BOX};
  if (!aria::make_map(&wm, w1q4, 3, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_64B,
                      CU_TENSOR_MAP_DATA_TYPE_UINT8) ||
      !aria::make_map(&xm, x_seg, 2, xdims, xstrides, xbox))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = aria::allow_smem(prefill_glu, G_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(I / G_COLS, R / TM);
  prefill_glu<<<grid, THREADS, G_SMEM, (cudaStream_t)stream>>>(
      wm, xm, (const int*)tile_expert, (const int*)tile_rows, (const __nv_bfloat16*)w1sg,
      (__nv_bfloat16*)h, D, I, E, layer, ng);
  return cudaGetLastError();
}

// h bf16 [R, I], w2q4 int8 [L, E, I, D/2], w2s8 bf16 [L, E, 8, D], out f32 [R, D]
ARIA_EXPORT int aria_moe_prefill_down(const void* h, const void* tile_expert,
                                      const void* tile_rows, const void* w2q4, const void* w2s8,
                                      void* out, int R, int D, int I, int L, int E, int layer,
                                      void* stream) {
  if (R % TM || (D / 2) % D_COLS || I % (2 * D_KS)) return (int)cudaErrorInvalidValue;
  CUtensorMap wm, hm;
  const cuuint64_t wdims[3] = {(cuuint64_t)D / 2, (cuuint64_t)I, (cuuint64_t)L * E};
  const cuuint64_t wstrides[2] = {(cuuint64_t)D / 2, (cuuint64_t)I * D / 2};
  const cuuint32_t wbox[3] = {D_COLS, D_KS, 1};
  const cuuint64_t hdims[2] = {(cuuint64_t)I, (cuuint64_t)R};
  const cuuint64_t hstrides[1] = {(cuuint64_t)I * 2};
  const cuuint32_t hbox[2] = {64, BOX};
  if (!aria::make_map(&wm, w2q4, 3, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_64B,
                      CU_TENSOR_MAP_DATA_TYPE_UINT8) ||
      !aria::make_map(&hm, h, 2, hdims, hstrides, hbox))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = aria::allow_smem(prefill_down, D_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(D / 2 / D_COLS, R / TM);
  prefill_down<<<grid, THREADS, D_SMEM, (cudaStream_t)stream>>>(
      wm, hm, (const int*)tile_expert, (const int*)tile_rows, (const __nv_bfloat16*)w2s8,
      (float*)out, D, I, E, layer);
  return cudaGetLastError();
}
