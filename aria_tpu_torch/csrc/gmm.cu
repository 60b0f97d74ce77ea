// gmm: megablox's ragged grouped matmul, forward and backward, and tgmm.
//
// Replaces the two `gmm` calls of aria_tpu/ops/moe.py:204 experts_ragged
// (jax.experimental.pallas.ops.tpu.megablox, :237 and :240) and their
// custom VJP (megablox/ops.py:63-106):
//
//   out[r, :] = lhs[r, :] . rhs[g(r)]^T   rhs [E, N, K], K contiguous (transpose_rhs)
//   out[r, :] = lhs[r, :] . rhs[g(r)]     rhs [E, K, N], N contiguous
//
// where lhs [M, K] holds rows sorted by group and g(r) is the group of row
// r: group_sizes [E] int32 stays on the device, and M is a multiple of 128
// whose rows the groups cover. The forward takes a bf16 lhs and gives an
// f32 out.
//
// The work is row tiles of 128 rows, at most M/128 + E - 1 of them; an
// empty group has none. Each block finds its own (group, tile) by a
// warp-parallel scan of group_sizes, so the grid is sized from M and E
// alone and nothing waits on the host; blocks past the last tile exit at
// once. The forward's tiles start at each group's first row: a group of n
// rows is ceil(n / 128) tiles, whose rows past the group are loaded (TMA
// boxes start at any row) and not stored, so each tile reads its expert's
// weights for rows of that expert only. The backward's tiles are the
// tensor's aligned 128-row tiles that a group touches, as megablox visits
// them (a tile that straddles a group boundary is computed once for each
// group and stores only that group's rows), because the split's flags are
// per aligned tile.
//
// The forward (gmm_fwd_kernel) is gmm_dlhs's kernel below with the lhs as
// its one plane: 128 x 256 tiles, a producer warpgroup whose one thread
// starts TMA loads into a 4-stage ring of 48 KB stages, two consumer
// warpgroups on wgmma m64n256k16, and an f32 epilogue that stores this
// group's rows as float2 pairs. A row's sums run over K in the same order
// (64 columns a stage, 16 a product) at every row count and at every
// position in its tile, so a row gets the same bits whatever M and the
// groups are.
//
// The backward. Both gradients take the f32 cotangent [M, N]: with an f32
// operand megablox computes in f32 (megablox/common.py:54-65). The split
// kernel turns it, once a backward, into bf16 planes hi = bf16(x) and lo =
// bf16(x - hi), and a flag per 128-row tile that is set where any lo there
// is non-zero; hi + lo is x exactly for values of at most 16 significant
// bits, which both of experts_ragged's cotangents are in bf16 training (a
// bf16 gradient, or one times a bf16 combine weight); any other f32 value
// loses at most 2^-17 of itself. Each product then sums hi . rhs and, only
// where the tile's flag is set, lo . rhs in f32. w1's cotangent is the f32
// upcast of a bf16 gradient (the backward of ops/moe.py's `.to(x.dtype)`),
// so every tile's lo is zero and every tile takes the one product; the
// result is bit-for-bit the sum over hi + lo either way. The flags stay on
// the device and are read block-uniformly.
//
// gmm_dlhs, the lhs gradient (megablox ops.py:80-88: gmm of the cotangent
// and rhs, transpose_rhs flipped, rounded once to bf16): the forward's
// (group, tile) walk, found by a warp-parallel scan of group_sizes, with
// 128 x 256 output tiles: one producer warpgroup (one thread starts the TMA
// loads) and two consumer warpgroups of 64 rows on wgmma m64n256k16 (A read
// once for all 256 columns; m64n128k16 where a tile's second half lies past
// N); setmaxnreg moves the producer's registers to the consumers. The contraction comes 64 columns a stage
// through a ring with full and empty mbarriers and the 128-byte swizzle: 3
// stages of hi, lo and rhs (64 KB) for a flagged tile, 4 of hi and rhs (48
// KB) otherwise. A is hi (and lo), K-major; B is rhs, K-major [E, N, K]
// (w2's backward) or MN-major [E, K, N] through wgmma's transpose bit
// (w1's). Blocks run the N tiles of a row tile next to each other, so
// neighbours share the lhs tile and the expert's rhs in L2.
//
// tgmm, the rhs gradient (megablox gmm.py:573, pallas_call :763):
// out[g] = lhs[rows of g]^T . grad[rows of g], [E, K, N] in bf16, for a
// bf16 lhs [M, K] and the split grad. One block per (128 x 256 tile of
// [K, N], group), the same three warpgroups; both operands are MN-major in
// memory (A = lhs^T, B = grad) and take both transpose bits. The group's
// rows come in chunks aligned to the whole tensor's rows, so that a chunk
// maps onto one tile's flag and its TMA box starts aligned: where no tile of
// the group is flagged, 4 stages of 64-row chunks of lhs and hi (48 KB),
// else 5 stages of 32-row chunks of lhs, hi and lo (40 KB), the lo plane
// brought and multiplied for the flagged chunks only. Only a group's first
// and last chunk hold rows of other groups: each consumer zeroes those rows
// of its half of the lhs chunk in shared memory (each row is one 128-byte
// line of its box under the swizzle) before its products. An empty group's
// slice is zeros, as megablox stores its zeroed accumulator.
//
// In both, each stage's products are one straight run from a fence to a
// commit (a branch between two products makes ptxas fence, and so
// serialise, every one of them: the lo product and the second 128 columns
// are template arguments), and one group of products stays in flight: a
// stage goes back to the producer once the next stage's products are
// issued.
//
// Bound: at 512 prompt tokens x 8 slots (M = 4,096) the w1 product reads
// the 66 experts' 1.12 GB once and does 70 GFLOP: bytes, 0.34 ms (with
// tiles aligned to the tensor, a group of ~60 rows that straddles two tiles
// would read its expert twice). In training at M = 98,304 every product is
// bound by operations (2 M N K at 989 TFLOP/s: 1.694 ms for w1, 0.847 for
// w2, twice that with the lo products); the split by bytes (one f32 read
// and two bf16 writes of the cotangent: 0.78 ms for w1's).

#include "hopper.cuh"

namespace {

using aria::pack_bf16;

constexpr int TM = 128;  // rows per tile

// ---- the split: f32 x [M, N] -> bf16 hi, lo [M, N], flags [ceil(M / 128)]
constexpr int SPLIT_THREADS = 256;

__global__ void __launch_bounds__(SPLIT_THREADS)
split_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ hi,
             __nv_bfloat16* __restrict__ lo, int* __restrict__ flags, int M, int N) {
  const int tile = blockIdx.x;  // one block per 128-row tile
  const size_t first = (size_t)tile * TM * N;
  const size_t n4 = (size_t)min(TM, M - tile * TM) * N / 4;
  const float4* src = reinterpret_cast<const float4*>(x + first);
  uint2* h = reinterpret_cast<uint2*>(hi + first);
  uint2* l = reinterpret_cast<uint2*>(lo + first);
  int any = 0;
#pragma unroll 4
  for (size_t i = threadIdx.x; i < n4; i += SPLIT_THREADS) {
    const float4 v = __ldcs(src + i);  // read once: stream past L1 and L2
    const float v4[4] = {v.x, v.y, v.z, v.w};
    float hf[4], lf[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      hf[j] = aria::bf16_round(v4[j]);
      lf[j] = v4[j] - hf[j];  // exact
      any |= lf[j] != 0.f;
    }
    h[i] = make_uint2(pack_bf16(hf[0], hf[1]), pack_bf16(hf[2], hf[3]));
    l[i] = make_uint2(pack_bf16(lf[0], lf[1]), pack_bf16(lf[2], lf[3]));
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) flags[tile] = any;
}

// ---- the wgmma kernels' common shape: a producer warpgroup and two
// consumer warpgroups of 64 output rows each
constexpr int WG_THREADS = 384;
constexpr int ROW_BYTES = 128;  // one swizzled row: 64 bf16
constexpr int BOX64 = 64 * ROW_BYTES;  // a box of 64 rows x 64 bf16: 8 KB

__device__ __forceinline__ void zero_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
}

// the m64n256 fragment's halves: each is the m64n128 fragment of 128 columns
__device__ __forceinline__ float (&half(float (&d)[128], int h))[64] {
  return *reinterpret_cast<float(*)[64]>(d + 64 * h);
}

// two neighbouring outputs as a bf16 pair or an f32 pair
__device__ __forceinline__ void put2(__nv_bfloat16* o, float a, float b) {
  *reinterpret_cast<uint32_t*>(o) = pack_bf16(a, b);
}
__device__ __forceinline__ void put2(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}

// a consumer's 64 x 128 accumulator (wgmma's fragment: this thread's rows
// ra and ra + 8, columns 8j + 2(lane % 4) and the next) into rows of `out`
// (row stride ld), the rows in [lo_row, hi_row) only
template <typename T>
__device__ __forceinline__ void store_rows(const float (&d)[64], T* out, size_t ld, int row0,
                                           int col0, int lo_row, int hi_row) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int ra = row0 + warp * 16 + lane / 4, c2 = 2 * (lane % 4);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = ra + 8 * hr;
    if (row < lo_row || row >= hi_row) continue;
    T* o = out + (size_t)row * ld + col0 + c2;
#pragma unroll
    for (int j = 0; j < 16; ++j) put2(o + 8 * j, d[4 * j + 2 * hr], d[4 * j + 2 * hr + 1]);
  }
}

// the w-th row tile of the groups' rows: its group e, first row row0 and
// the group's rows [gstart, gend); false past the last tile (block-uniform).
// ALIGNED: the tensor's 128-row tiles that each group touches, else
// ceil(n / 128) tiles from each group's first row. A warp-parallel scan of
// 32 groups at a time: each warp of the block finds the same answer in a
// few loads' time.
template <bool ALIGNED>
__device__ __forceinline__ bool group_tile_scan(const int* __restrict__ group_sizes, int E, int M,
                                                int w, int& e, int& row0, int& gstart,
                                                int& gend) {
  const int lane = threadIdx.x % 32;
  int rows = 0, tiles = 0;  // before this chunk of groups
  for (int base = 0; base < E; base += 32) {
    const int sz = base + lane < E ? group_sizes[base + lane] : 0;
    int incl = sz;  // inclusive scans of the rows and the tiles
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(aria::FULL_MASK, incl, o);
      if (lane >= o) incl += v;
    }
    const int start = rows + incl - sz;
    const int n = sz <= 0  ? 0
                  : ALIGNED ? (start + sz - 1) / TM - start / TM + 1
                            : (sz + TM - 1) / TM;
    int nincl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(aria::FULL_MASK, nincl, o);
      if (lane >= o) nincl += v;
    }
    const int seen = tiles + nincl - n;
    const unsigned hit = __ballot_sync(aria::FULL_MASK, w >= seen && w < seen + n);
    if (hit) {
      const int src = __ffs(hit) - 1;
      e = base + src;
      gstart = __shfl_sync(aria::FULL_MASK, start, src);
      gend = min(gstart + __shfl_sync(aria::FULL_MASK, sz, src), M);
      const int i = w - __shfl_sync(aria::FULL_MASK, seen, src);
      row0 = ALIGNED ? (gstart / TM + i) * TM : gstart + i * TM;
      return row0 < M;
    }
    rows += __shfl_sync(aria::FULL_MASK, incl, 31);
    tiles += __shfl_sync(aria::FULL_MASK, nincl, 31);
  }
  return false;
}

// ---- the forward and gmm_dlhs on wgmma
namespace dl {
constexpr int BM = 128, BN = 256, BKW = 64;
constexpr int A_BYTES = BM * ROW_BYTES;  // one plane's 128 x 64 tile: 16 KB
constexpr int B_BYTES = BN * ROW_BYTES;  // rhs 256 x 64: 32 KB
// the ring: with the lo plane 3 stages of hi, lo and rhs (64 KB), without
// it 4 of hi and rhs (48 KB)
template <bool TWO>
struct Ring {
  static constexpr int STAGES = TWO ? 3 : 4;
  static constexpr int STAGE_BYTES = (TWO ? 2 : 1) * A_BYTES + B_BYTES;
  static constexpr int BAR_OFF = STAGES * STAGE_BYTES;
};
constexpr int SMEM = 3 * (2 * A_BYTES + B_BYTES) + 16 * 4 + 1024;  // the larger + slack
}  // namespace dl

// the ring's full and empty mbarriers, one each a stage
template <int STAGES>
__device__ __forceinline__ void init_ring(uint32_t bars) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      aria::mbar_init(bars + 8 * s, 1);
      aria::mbar_init(bars + 8 * (STAGES + s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// the producer thread of the forward and gmm_dlhs: every load of the block.
// TWO brings gmm_dlhs's lo plane, HALF1 the rhs of the tile's second 128
// columns.
template <bool MN_RHS, bool TWO, bool HALF1>
__device__ __forceinline__ void ring_produce(const CUtensorMap* hi_map, const CUtensorMap* lo_map,
                                             const CUtensorMap* rhs_map, uint32_t base, int e,
                                             int row0, int n0, int nk) {
  using namespace dl;
  using R = Ring<TWO>;
  constexpr int boxes = HALF1 ? 4 : 2;  // MN-major rhs: none wholly past N
  constexpr int bytes = (TWO ? 2 : 1) * A_BYTES + (MN_RHS ? boxes * BOX64 : B_BYTES);
  for (int c = 0; c < nk; ++c) {
    const int s = c % R::STAGES, k0 = c * BKW;
    const uint32_t a = base + s * R::STAGE_BYTES, b = a + (TWO ? 2 : 1) * A_BYTES;
    const uint32_t full = base + R::BAR_OFF + 8 * s;
    if (c >= R::STAGES)
      aria::mbar_wait(base + R::BAR_OFF + 8 * (R::STAGES + s), ((c / R::STAGES) - 1) & 1);
    aria::mbar_expect_tx(full, bytes);
    aria::tma_load(a, hi_map, full, k0, row0);
    if constexpr (TWO) aria::tma_load(a + A_BYTES, lo_map, full, k0, row0);
    if constexpr (MN_RHS) {  // boxes of 64 columns x 64 k
      for (int j = 0; j < boxes; ++j)
        aria::tma_load(b + j * BOX64, rhs_map, full, n0 + 64 * j, k0, e);
    } else {  // one box of 256 rows x 64 k; rows past N load as zeros
      aria::tma_load(b, rhs_map, full, k0, n0, e);
    }
  }
}

// a consumer warpgroup of the forward or gmm_dlhs: rows cw * 64 .. + 64 of
// the tile, all 256 columns. Each stage's products are one straight run between a fence and a
// commit (a branch between two products makes ptxas fence, and so
// serialise, every one of them), and one group stays in flight: stage c - 1
// goes back to the producer once stage c's products are issued.
template <bool MN_RHS, bool TWO, bool HALF1>
__device__ __forceinline__ void ring_consume(float (&acc)[128], uint32_t base, int cw, int nk) {
  using namespace dl;
  using R = Ring<TWO>;
  const int lane = threadIdx.x % 32;
  for (int c = 0; c < nk; ++c) {
    const int s = c % R::STAGES;
    aria::mbar_wait(base + R::BAR_OFF + 8 * s, (c / R::STAGES) & 1);
    const uint32_t a = base + s * R::STAGE_BYTES + cw * 64 * ROW_BYTES;  // lo at + A_BYTES
    const uint32_t b = base + s * R::STAGE_BYTES + (TWO ? 2 : 1) * A_BYTES;
    aria::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKW / 16; ++kk) {
      // MN-major: 16 k rows a step, 64 columns a box at LBO; K-major: 16 k
      // a step, 32 bytes into each row
      const uint64_t db = MN_RHS ? aria::sw128_desc(b + kk * 16 * ROW_BYTES, BOX64, 1024)
                                 : aria::sw128_desc(b + kk * 32, 16, 1024);
#pragma unroll
      for (int p = 0; p < (TWO ? 2 : 1); ++p) {  // hi, then lo
        const uint64_t da = aria::sw128_desc(a + p * A_BYTES + kk * 32, 16, 1024);
        if constexpr (HALF1) aria::wgmma_ss256<0, MN_RHS>(acc, da, db, 1);
        else aria::wgmma_ss<0, MN_RHS>(half(acc, 0), da, db, 1);
      }
    }
    aria::wgmma_commit();
    aria::wgmma_wait<1>();
    if (c > 0 && lane == 0)
      aria::mbar_arrive(base + R::BAR_OFF + 8 * (R::STAGES + (c - 1) % R::STAGES));
  }
  aria::wgmma_wait<0>();
  aria::fence_regs(acc);
}

// the forward: lhs [M, K] as the one plane, out f32; MN_RHS: rhs [E, K, N]
// (B MN-major, w2), else [E, N, K] (w1, transpose_rhs)
template <bool MN_RHS>
__global__ void __launch_bounds__(WG_THREADS, 1)
gmm_fwd_kernel(const __grid_constant__ CUtensorMap lhs_map,
               const __grid_constant__ CUtensorMap rhs_map, const int* __restrict__ group_sizes,
               float* __restrict__ out, int M, int K, int N, int E) {
  using namespace dl;
  using R = Ring<false>;
  int e, row0, gstart, gend;
  if (!group_tile_scan<false>(group_sizes, E, M, blockIdx.y, e, row0, gstart, gend)) return;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (aria::smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle's alignment
  const int n0 = blockIdx.x * BN;
  const bool half1 = n0 + 128 < N;  // the tile's second 128 columns exist
  const int nk = (K + BKW - 1) / BKW;
  init_ring<R::STAGES>(base + R::BAR_OFF);
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread starts every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {  // the one plane: no lo map
      const CUtensorMap *lm = &lhs_map, *rm = &rhs_map;
      if (half1) ring_produce<MN_RHS, false, true>(lm, lm, rm, base, e, row0, n0, nk);
      else ring_produce<MN_RHS, false, false>(lm, lm, rm, base, e, row0, n0, nk);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = threadIdx.x / 128 - 1;
  float acc[128];
  zero_acc(acc);
  if (half1) ring_consume<MN_RHS, false, true>(acc, base, cw, nk);
  else ring_consume<MN_RHS, false, false>(acc, base, cw, nk);
  const int r0 = row0 + cw * 64;
  store_rows(half(acc, 0), out, N, r0, n0, gstart, gend);
  if (half1) store_rows(half(acc, 1), out, N, r0, n0 + 128, gstart, gend);
}

// MN_RHS: rhs [E, K, N] (B MN-major, w1's backward); else [E, N, K]
template <bool MN_RHS>
__global__ void __launch_bounds__(WG_THREADS, 1)
gmm_dlhs_kernel(const __grid_constant__ CUtensorMap hi_map,
                const __grid_constant__ CUtensorMap lo_map,
                const __grid_constant__ CUtensorMap rhs_map, const int* __restrict__ group_sizes,
                const int* __restrict__ flags, __nv_bfloat16* __restrict__ out, int M, int K,
                int N, int E) {
  using namespace dl;
  int e, row0, gstart, gend;
  if (!group_tile_scan<true>(group_sizes, E, M, blockIdx.y, e, row0, gstart, gend)) return;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (aria::smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle's alignment
  const int n0 = blockIdx.x * BN;
  const bool two = flags[row0 / TM] != 0;  // the lo product: block-uniform
  const bool half1 = n0 + 128 < N;    // the tile's second 128 columns exist
  const int nk = (K + BKW - 1) / BKW;
  if (two) init_ring<Ring<true>::STAGES>(base + Ring<true>::BAR_OFF);
  else init_ring<Ring<false>::STAGES>(base + Ring<false>::BAR_OFF);
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread starts every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      const CUtensorMap *hm = &hi_map, *lm = &lo_map, *rm = &rhs_map;
      if (two) {
        if (half1) ring_produce<MN_RHS, true, true>(hm, lm, rm, base, e, row0, n0, nk);
        else ring_produce<MN_RHS, true, false>(hm, lm, rm, base, e, row0, n0, nk);
      } else {
        if (half1) ring_produce<MN_RHS, false, true>(hm, lm, rm, base, e, row0, n0, nk);
        else ring_produce<MN_RHS, false, false>(hm, lm, rm, base, e, row0, n0, nk);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = threadIdx.x / 128 - 1;
  float acc[128];
  zero_acc(acc);
  if (two) {
    if (half1) ring_consume<MN_RHS, true, true>(acc, base, cw, nk);
    else ring_consume<MN_RHS, true, false>(acc, base, cw, nk);
  } else {
    if (half1) ring_consume<MN_RHS, false, true>(acc, base, cw, nk);
    else ring_consume<MN_RHS, false, false>(acc, base, cw, nk);
  }
  const int r0 = row0 + cw * 64;
  store_rows(half(acc, 0), out, N, r0, n0, gstart, gend);
  if (half1) store_rows(half(acc, 1), out, N, r0, n0 + 128, gstart, gend);
}

// ---- tgmm on wgmma
namespace tg {
constexpr int BKT = 128, BN = 256;  // the [K, N] tile
// the ring: where a tile of the group is flagged, 5 stages of 32-row
// chunks of lhs, hi and lo (40 KB), else 4 of 64-row chunks of lhs and hi
// (48 KB). A box is a chunk's rows x 64 bf16.
template <bool TWO>
struct Ring {
  static constexpr int CH = TWO ? 32 : 64;  // rows a chunk
  static constexpr int STAGES = TWO ? 5 : 4;
  static constexpr int BOX = CH * ROW_BYTES;
  static constexpr int A_BYTES = 2 * BOX;  // lhs: CH rows x 128 k
  static constexpr int B_BYTES = 4 * BOX;  // one plane: CH rows x 256 n
  static constexpr int STAGE_BYTES = A_BYTES + (TWO ? 2 : 1) * B_BYTES;
  static constexpr int BAR_OFF = STAGES * STAGE_BYTES;
};
constexpr int SMEM = 5 * 40 * 1024 + 16 * 5 + 1024;  // the larger ring + slack
}  // namespace tg

// one chunk's products of a tgmm consumer, a straight run from its fence to
// its commit: A is this warpgroup's 64 columns of the lhs chunk (MN-major),
// B the hi plane (and the lo plane with TWO), all 256 columns in one
// product (the first 128 where the second half lies past N)
template <typename R, bool TWO, bool HALF1>
__device__ __forceinline__ void tgmm_issue(float (&acc)[128], uint32_t a, uint32_t h) {
  aria::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < R::CH / 16; ++kk) {  // 16 rows a step
    const uint32_t off = kk * 16 * ROW_BYTES;
    const uint64_t da = aria::sw128_desc(a + off, R::BOX, 1024);
#pragma unroll
    for (int p = 0; p < (TWO ? 2 : 1); ++p) {  // hi, then lo; 64 columns a box at LBO
      const uint64_t db = aria::sw128_desc(h + p * R::B_BYTES + off, R::BOX, 1024);
      if constexpr (HALF1) aria::wgmma_ss256<1, 1>(acc, da, db, 1);
      else aria::wgmma_ss<1, 1>(half(acc, 0), da, db, 1);
    }
  }
  aria::wgmma_commit();
}

// tgmm's producer thread: every load of the block. ANY_TWO where some tile
// of the group is flagged: the lo plane is brought for the flagged chunks
// and the ring is shorter.
template <bool ANY_TWO, bool HALF1>
__device__ __forceinline__ void tgmm_produce(const CUtensorMap* lhs_map, const CUtensorMap* hi_map,
                                             const CUtensorMap* lo_map,
                                             const int* __restrict__ flags, uint32_t base,
                                             int gstart, int gend, int k0, int n0) {
  using R = tg::Ring<ANY_TWO>;
  constexpr int boxes = HALF1 ? 4 : 2;  // of 64 columns each, none wholly past N
  const int c0 = gstart / R::CH, nch = (gend + R::CH - 1) / R::CH - c0;
  for (int j = 0; j < nch; ++j) {
    const int s = j % R::STAGES, r0 = (c0 + j) * R::CH;
    const bool two = ANY_TWO && flags[r0 / TM] != 0;
    const uint32_t a = base + s * R::STAGE_BYTES, h = a + R::A_BYTES;  // lo at h + B_BYTES
    const uint32_t full = base + R::BAR_OFF + 8 * s;
    if (j >= R::STAGES)
      aria::mbar_wait(base + R::BAR_OFF + 8 * (R::STAGES + s), ((j / R::STAGES) - 1) & 1);
    aria::mbar_expect_tx(full, R::A_BYTES + (two ? 2 : 1) * boxes * R::BOX);
    aria::tma_load(a, lhs_map, full, k0, r0);
    aria::tma_load(a + R::BOX, lhs_map, full, k0 + 64, r0);
    for (int i = 0; i < boxes; ++i) {
      aria::tma_load(h + i * R::BOX, hi_map, full, n0 + 64 * i, r0);
      if (two) aria::tma_load(h + R::B_BYTES + i * R::BOX, lo_map, full, n0 + 64 * i, r0);
    }
  }
}

// a tgmm consumer warpgroup: rows cw * 64 .. + 64 of the [K, N] tile (its
// half of each lhs chunk's columns), all 256 columns
template <bool ANY_TWO, bool HALF1>
__device__ __forceinline__ void tgmm_consume(float (&acc)[128], const int* __restrict__ flags,
                                             uint32_t base, int cw, int gstart, int gend) {
  using R = tg::Ring<ANY_TWO>;
  const int lane = threadIdx.x % 32, t = threadIdx.x % 128;
  const int c0 = gstart / R::CH, nch = (gend + R::CH - 1) / R::CH - c0;
  for (int j = 0; j < nch; ++j) {
    const int s = j % R::STAGES, r0 = (c0 + j) * R::CH;
    aria::mbar_wait(base + R::BAR_OFF + 8 * s, (j / R::STAGES) & 1);
    const uint32_t a = base + s * R::STAGE_BYTES + cw * R::BOX;
    const uint32_t h = base + s * R::STAGE_BYTES + R::A_BYTES;
    if (r0 < gstart || r0 + R::CH > gend) {  // rows of other groups count zero
      for (int i = t; i < R::CH * 8; i += 128) {
        const int r = i / 8, row = r0 + r;
        if (row < gstart || row >= gend)
          asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n"
                       :: "r"(a + r * ROW_BYTES + (i % 8) * 16), "r"(0) : "memory");
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + cw) : "memory");
    }
    if (ANY_TWO && flags[r0 / TM] != 0) tgmm_issue<R, ANY_TWO, HALF1>(acc, a, h);
    else tgmm_issue<R, false, HALF1>(acc, a, h);
    aria::wgmma_wait<1>();  // chunk j - 1's products are done: its stage goes back
    if (j > 0 && lane == 0)
      aria::mbar_arrive(base + R::BAR_OFF + 8 * (R::STAGES + (j - 1) % R::STAGES));
  }
  aria::wgmma_wait<0>();
  aria::fence_regs(acc);
}

__global__ void __launch_bounds__(WG_THREADS, 1)
tgmm_kernel(const __grid_constant__ CUtensorMap lhs32, const __grid_constant__ CUtensorMap hi32,
            const __grid_constant__ CUtensorMap lo32, const __grid_constant__ CUtensorMap lhs64,
            const __grid_constant__ CUtensorMap hi64, const int* __restrict__ group_sizes,
            const int* __restrict__ flags, __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  using namespace tg;
  const int e = blockIdx.z, k0 = blockIdx.y * BKT, n0 = blockIdx.x * BN;
  int gstart = 0;  // a loop: a warp-parallel sum here measured slower (PERF.md)
  for (int gi = 0; gi < e; ++gi) gstart += group_sizes[gi];
  const int gend = min(gstart + group_sizes[e], M);
  int any = 0;  // a flagged tile among the group's
  for (int t = gstart / TM + (threadIdx.x % 32); gend > gstart && t * TM < gend; t += 32)
    any |= flags[t];
  any = __syncthreads_or(any);
  const bool half1 = n0 + 128 < N;  // the tile's second 128 columns exist
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (aria::smem_u32(smem_raw) + 1023) & ~1023u;
  if (any) init_ring<Ring<true>::STAGES>(base + Ring<true>::BAR_OFF);
  else init_ring<Ring<false>::STAGES>(base + Ring<false>::BAR_OFF);
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread starts every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0 && gend > gstart) {
      const CUtensorMap *a32 = &lhs32, *h32 = &hi32, *l32 = &lo32, *a64 = &lhs64, *h64 = &hi64;
      if (any) {
        if (half1) tgmm_produce<true, true>(a32, h32, l32, flags, base, gstart, gend, k0, n0);
        else tgmm_produce<true, false>(a32, h32, l32, flags, base, gstart, gend, k0, n0);
      } else {
        if (half1) tgmm_produce<false, true>(a64, h64, l32, flags, base, gstart, gend, k0, n0);
        else tgmm_produce<false, false>(a64, h64, l32, flags, base, gstart, gend, k0, n0);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = threadIdx.x / 128 - 1;
  float acc[128];
  zero_acc(acc);
  if (gend > gstart) {  // an empty group's slice stays zero
    if (any) {
      if (half1) tgmm_consume<true, true>(acc, flags, base, cw, gstart, gend);
      else tgmm_consume<true, false>(acc, flags, base, cw, gstart, gend);
    } else {
      if (half1) tgmm_consume<false, true>(acc, flags, base, cw, gstart, gend);
      else tgmm_consume<false, false>(acc, flags, base, cw, gstart, gend);
    }
  }
  __nv_bfloat16* out_e = out + (size_t)e * K * N;
  const int r0 = k0 + cw * 64;
  store_rows(half(acc, 0), out_e, N, r0, n0, 0, K);
  if (half1) store_rows(half(acc, 1), out_e, N, r0, n0 + 128, 0, K);
}

// [rows, cols] bf16 as a rank-2 map with boxes of 64 columns x box_rows
bool map2d(CUtensorMap* map, const void* t, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return aria::make_map(map, t, 2, dims, strides, box);
}

// [E, rows, cols] bf16 as a rank-3 map with boxes of 64 columns x box_rows x 1
bool map3d(CUtensorMap* map, const void* t, int E, int rows, int cols, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return aria::make_map(map, t, 3, dims, strides, box);
}

}  // namespace

// The forward: lhs bf16 [M, K], out f32 [M, N]; rhs_kmajor = 1: rhs
// [E, N, K] (megablox transpose_rhs=True); 0: [E, K, N]
ARIA_EXPORT int aria_gmm(const void* lhs, const void* rhs, const void* group_sizes, void* out,
                         int M, int K, int N, int E, int rhs_kmajor, void* stream) {
  if (M % TM || K % 32 || N % 128 || E < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap lm, rm;
  const bool ok = map2d(&lm, lhs, M, K, dl::BM) &&
                  (rhs_kmajor ? map3d(&rm, rhs, E, N, K, dl::BN) : map3d(&rm, rhs, E, K, N, 64));
  if (!ok) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + dl::BN - 1) / dl::BN, M / TM + E - 1);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (rhs_kmajor) {
    err = aria::allow_smem(gmm_fwd_kernel<false>, dl::SMEM);
    if (err != cudaSuccess) return (int)err;
    gmm_fwd_kernel<false><<<grid, WG_THREADS, dl::SMEM, st>>>(lm, rm, (const int*)group_sizes,
                                                             (float*)out, M, K, N, E);
  } else {
    err = aria::allow_smem(gmm_fwd_kernel<true>, dl::SMEM);
    if (err != cudaSuccess) return (int)err;
    gmm_fwd_kernel<true><<<grid, WG_THREADS, dl::SMEM, st>>>(lm, rm, (const int*)group_sizes,
                                                            (float*)out, M, K, N, E);
  }
  return (int)cudaGetLastError();
}

// x f32 [M, N] -> hi, lo bf16 [M, N] and flags int32 [ceil(M / 128)]
ARIA_EXPORT int aria_split_hi_lo(const void* x, void* hi, void* lo, void* flags, int M, int N,
                                 void* stream) {
  if (M < 1 || N % 4) return (int)cudaErrorInvalidValue;
  split_kernel<<<(M + TM - 1) / TM, SPLIT_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (__nv_bfloat16*)hi, (__nv_bfloat16*)lo, (int*)flags, M, N);
  return cudaGetLastError();
}

// The lhs gradient: the split cotangent hi, lo [M, K] with its flags, rhs
// [E, N, K] (rhs_kmajor = 1) or [E, K, N]; out bf16 [M, N]
ARIA_EXPORT int aria_gmm_dlhs(const void* hi, const void* lo, const void* flags, const void* rhs,
                              const void* group_sizes, void* out, int M, int K, int N, int E,
                              int rhs_kmajor, void* stream) {
  if (M % TM || K % 32 || N % 128 || E < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap hm, lm, rm;
  const bool ok = map2d(&hm, hi, M, K, dl::BM) && map2d(&lm, lo, M, K, dl::BM) &&
                  (rhs_kmajor ? map3d(&rm, rhs, E, N, K, dl::BN) : map3d(&rm, rhs, E, K, N, 64));
  if (!ok) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + dl::BN - 1) / dl::BN, M / TM + E - 1);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (rhs_kmajor) {
    err = aria::allow_smem(gmm_dlhs_kernel<false>, dl::SMEM);
    if (err != cudaSuccess) return (int)err;
    gmm_dlhs_kernel<false><<<grid, WG_THREADS, dl::SMEM, st>>>(
        hm, lm, rm, (const int*)group_sizes, (const int*)flags, (__nv_bfloat16*)out, M, K, N, E);
  } else {
    err = aria::allow_smem(gmm_dlhs_kernel<true>, dl::SMEM);
    if (err != cudaSuccess) return (int)err;
    gmm_dlhs_kernel<true><<<grid, WG_THREADS, dl::SMEM, st>>>(
        hm, lm, rm, (const int*)group_sizes, (const int*)flags, (__nv_bfloat16*)out, M, K, N, E);
  }
  return (int)cudaGetLastError();
}

// The rhs gradient: lhs bf16 [M, K], the split cotangent hi, lo [M, N]
// with its flags, group_sizes int32 [E] summing to M; out bf16 [E, K, N]
ARIA_EXPORT int aria_tgmm(const void* lhs, const void* hi, const void* lo, const void* flags,
                          const void* group_sizes, void* out, int M, int K, int N, int E,
                          void* stream) {
  if (M % 32 || K % tg::BKT || N % 128 || E < 1) return (int)cudaErrorInvalidValue;
  // boxes of a chunk's rows: 32 where a tile of the group is flagged, else 64
  CUtensorMap am, hm, lm, am64, hm64;
  if (!map2d(&am, lhs, M, K, 32) || !map2d(&hm, hi, M, N, 32) || !map2d(&lm, lo, M, N, 32) ||
      !map2d(&am64, lhs, M, K, 64) || !map2d(&hm64, hi, M, N, 64))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = aria::allow_smem(tgmm_kernel, tg::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + tg::BN - 1) / tg::BN, K / tg::BKT, E);
  tgmm_kernel<<<grid, WG_THREADS, tg::SMEM, (cudaStream_t)stream>>>(
      am, hm, lm, am64, hm64, (const int*)group_sizes, (const int*)flags, (__nv_bfloat16*)out, M,
      K, N);
  return (int)cudaGetLastError();
}
