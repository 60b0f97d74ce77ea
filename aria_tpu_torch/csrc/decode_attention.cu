// decode_attention: one query per (lane b, head h) over the stacked cache
// at a layer index, keys at positions < lengths[b]; bf16, int8 and
// packed-int4 caches, each in the normal form (bf16 output) and in the
// stats form of the reference (f32 acc, m, s). The same kernel body reads
// the paged cache (paged_decode_attention, below).
//
// Replaces aria_tpu/ops/decode_attention.py:208 decode_attention
// (`_attend_block` :26 for bf16 and int8 caches [L, B, H, S, 128],
// `_attend_block_p4` :80 for the head-pair packed int4 cache [L, B, H/2, S,
// 128] int8, the stats form of :221-226, :278-289, :311-313). The query
// comes pre-scaled by 1/sqrt(D) and cast to bf16 by the wrapper (the paged
// form scales it in the kernel, with the same two roundings). With an
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
// - Longest lanes first. Block row y takes the y-th longest lane (read
//   from `lengths` on the device: the grid does not change), so the long
//   lanes start first and the short ones fill the tail.
// - Split over positions. The grid is (H or H/2, B, P); the wrapper picks P
//   from (B, heads, S) and the card's SM count alone (ops/decode_attention.py
//   split_count), never from the lengths on the device. Split i takes the 64-position tiles
//   [i U / P, (i + 1) U / P) of U = ceil(S / 64), so the P chunks cover
//   [0, S) exactly and differ by at most one tile. The chunks that hold
//   positions below the lane's length are a prefix of them; a block past it
//   leaves at once (split 0 stays for a lane of length 0).
// - Loads staged in shared memory. A block (8 warps) walks its chunk in
//   tiles of 32 positions through a ring of 64 KB (4 stages of bf16 rows, 8
//   of int8 or int4, three blocks an SM; the paged form's int8 ring is 6
//   stages, four blocks an SM): a thread brings a tile's key
//   rows, value rows and scales with bulk copies (cp.async.bulk, contiguous
//   in the cache) completing on the stage's mbarrier, up to the end of the
//   chunk (the ring's first tiles one a thread, at once); rows past it keep
//   stale bytes that no result reads.
// - Compute. Warp w takes positions 4w..4w+3 of each tile, 8 lanes a
//   position, each lane 16 of the 128 dims (the query in registers), so the
//   8 lanes reading one row hit 8 distinct banks; the score is reduced over
//   the 8 lanes, and the warp keeps its own online softmax, then
//   accumulates p * v with each lane owning 4 dims. It takes two tiles an
//   iteration (their scores, one softmax update, their p * v), so each
//   warp has two positions' dependent chains in flight and the block syncs
//   once per two tiles. The 8 warps' (m, s, acc) merge at the end of the
//   block. Bytes become f32 by a byte permute into the mantissa of 2^23
//   and one subtraction (exact).
// - Merge. Where more than one chunk holds positions, each of those blocks
//   writes its partial (acc, m, s) to a workspace the wrapper keeps per
//   device; the block that finishes a (b, head) last (a __threadfence and
//   an atomic counter per (b, head), which it resets to 0) merges them in
//   split order with the exact online-softmax merge in f32,
//   parallel/cp_cache.py's arithmetic: m = max m_i, acc = sum acc_i exp(m_i
//   - m), s = sum s_i exp(m_i - m), every m_i and s_i brought into shared
//   memory at once. The empty chunks' partials would add exact zeros, so
//   leaving them out changes no bit; with one such chunk its block writes
//   the result itself. One launch per call.
//
// paged_decode_attention replaces aria_tpu/engine/paged.py:150 (`_kernel`
// :117 for bf16 pages, `_kernel_q` :132 for int8 pages with f32 scales, both
// on `_attend_block` of ops/decode_attention.py:26), the same arithmetic
// over a paged cache [L, NP, H, PS, 128] (scales [L, NP, H, PS]): logical
// position p of lane b lives in page table[b * MAXP + p / PS], slot p % PS.
// The kernel body is the one above, templated on where a tile's rows start
// (Paged below): a page's rows for one head are contiguous and a tile of 32
// positions never crosses a page (PS % 32 == 0, tiles start at multiples
// of 32), so a tile is one bulk copy of its key rows, one of its value rows
// and one of each scale array from the page the table names. A page id
// outside [0, NP) is read as masked and never copied from; a lane's length
// is capped at MAXP * PS (S here), so no table entry past the MAXP-th is
// read. The TPU grid visits all MAXP pages of every lane and masks; here
// the split's chunks (ops/paged_attention.py paged_split_count, from the
// shapes and the SM count alone) bound the longest block, and a block past
// its lane's length writes the empty partial at once.
//
// The normal form writes acc / s rounded to bf16 (0 for a lane of length 0);
// the stats form writes f32 acc [B, H, 128], m [B, H] and s [B, H]. A lane
// with no position leaves m at the finite NEG_INF and acc = s = 0, which a
// merge's exp(m - m_g) removes.

#include <tuple>

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

// Where a tile's rows start, in rows of the cache: the key and value rows
// of positions p0.. from `row`, the k and v scales (per head of a pair) from
// s0 and s1. The stacked cache [L, B, Hx, S, 128] with scales [L, B, H, S]:
// one plane per (lane, head or pair).
struct Stacked {
  static constexpr int RING = 64 * 1024;  // bytes of the ring: three blocks an SM
  static constexpr int MIN_BLOCKS = 3;
  size_t plane, sc0, sc1;
  __device__ Stacked(const int*, int B, int Hx, int NH, int S, int layer, int b, int hx, int,
                     int, int) {
    plane = (((size_t)layer * B + b) * Hx + hx) * S;
    sc0 = (((size_t)layer * B + b) * Hx * NH + hx) * S;  // head hx, and for int4 hx + H/2
    sc1 = sc0 + (size_t)Hx * S;
  }
  __host__ __device__ static int page_bytes(int, int) { return 0; }
  __device__ static void stage_pages(const int*, int*, int, int, int, int, int) {}
  __device__ bool ok(int) const { return true; }
  __device__ void rows(int p0, size_t& row, size_t& s0, size_t& s1) const {
    row = plane + p0, s0 = sc0 + p0, s1 = sc1 + p0;
  }
};

// The paged cache [L, NP, H, PS, 128] with scales [L, NP, H, PS], one head
// a block: position p of the lane in page table[b][p / PS], slot p % PS; a
// page id outside [0, NP) masks its positions (`ok` is false). The ids of
// the chunk's pages wait in shared memory (read by the block's threads at
// once, beside the lane's length), so no table read stands in a tile's way.
struct Paged {
  // a paged chunk is a few tiles: int8 pages in 6 stages leave room for four
  // blocks an SM (at 64 registers a thread); bf16 takes the least, 4
  static constexpr int RING = 48 * 1024;
  static constexpr int MIN_BLOCKS = 4;
  const int* pg;  // the ids of pages first.. (shared memory)
  size_t head;    // (layer * NP) * H + h: the first page's plane of head h, less the page
  int H, NP, PS, first;
  __device__ Paged(const int* pg_s, int, int H_, int, int, int layer, int, int h, int NP_,
                   int PS_, int c0)
      : pg(pg_s), head((size_t)layer * NP_ * H_ + h), H(H_), NP(NP_), PS(PS_),
        first(c0 / PS_) {}
  __host__ __device__ static int page_bytes(int S, int PS) { return (S / PS * 4 + 15) / 16 * 16; }
  // the ids of the pages of positions [c0, c1) of lane b into pg_s
  __device__ static void stage_pages(const int* table, int* pg_s, int b, int S, int PS, int c0,
                                     int c1) {
    const int* row = table + (size_t)b * (S / PS) + c0 / PS;
    for (int i = threadIdx.x; i <= (c1 - 1) / PS - c0 / PS; i += blockDim.x)
      pg_s[i] = __ldg(row + i);
  }
  __device__ int page(int p0) const { return pg[p0 / PS - first]; }
  __device__ bool ok(int p0) const {
    const int id = page(p0);
    return id >= 0 && id < NP;
  }
  __device__ void rows(int p0, size_t& row, size_t& s0, size_t& s1) const {
    row = (head + (size_t)page(p0) * H) * PS + p0 % PS;
    s0 = s1 = row;
  }
};

// the ring's stages: the source's bytes in stages of a tile's key and value
// rows, even (two tiles an iteration) and at least 4
template <int KIND, typename SRC>
__host__ __device__ constexpr int stages() {
  return SRC::RING / (Cfg<KIND>::T * 2 * Cfg<KIND>::ROW) < 4
             ? 4
             : SRC::RING / (Cfg<KIND>::T * 2 * Cfg<KIND>::ROW) & ~1;
}

// The lane that block row y runs: the y-th longest (lengths capped at S,
// ties by index). The card starts a grid's blocks in order, so the longest
// lanes start first and the short ones fill in behind them, where in lane
// order a long lane late in the batch would start last and set the time. A
// lane's result does not depend on which block computes it. `scratch`
// holds B ints (the ring's memory, before its first copy).
__device__ int longest_first(const int* lengths, int B, int y, int S, int* scratch) {
  __shared__ int pick;
  for (int i = threadIdx.x; i < B; i += blockDim.x) scratch[i] = min(lengths[i], S);
  __syncthreads();
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    const int li = scratch[i];
    int rank = 0;
    for (int j = 0; j < B; ++j) {
      const int lj = scratch[j];
      rank += lj > li || (lj == li && j < i);
    }
    if (rank == y) pick = i;
  }
  __syncthreads();
  return pick;
}

// SRC: Stacked (S the cache's positions) or Paged (S = MAXP * PS, `table`
// [B, MAXP], NP pages of PS positions); B lanes, Hx heads or head pairs
template <int KIND, typename SRC>
__global__ void __launch_bounds__(THREADS, SRC::MIN_BLOCKS)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k,
                        const uint8_t* __restrict__ v, const void* __restrict__ k_scale,
                        const void* __restrict__ v_scale, const int* __restrict__ table,
                        const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
                        float* __restrict__ acc_out, float* __restrict__ m_out,
                        float* __restrict__ s_out, float* __restrict__ ws,
                        unsigned* __restrict__ counters, int B, int Hx, int S, int layer, int NP,
                        int PS, float qscale) {
  using C = Cfg<KIND>;
  constexpr int NH = C::NH, T = C::T, LPP = C::LPP, PPW = C::PPW;
  constexpr int NST = stages<KIND, SRC>();
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float red_m[NH][WARPS], red_s[NH][WARPS];
  __shared__ unsigned last;
  __shared__ __align__(8) uint64_t full[NST];  // a stage's copies have landed

  const int hx = blockIdx.x, split = blockIdx.z, P = gridDim.z;
  const int b = B > 1 ? longest_first(lengths, B, blockIdx.y, S, reinterpret_cast<int*>(smem)) : 0;
  const int H = Hx * NH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, qd = lane % LPP;
  const int U = (S + ALIGN - 1) / ALIGN;
  const int len_b = lengths[b];
  const int c0 = ALIGN * (int)((long)split * U / P);
  const int cend = min(S, ALIGN * (int)((long)(split + 1) * U / P));  // the chunk's end
  int* pg_s = reinterpret_cast<int*>(smem + NST * C::STAGE);
  SRC::stage_pages(table, pg_s, b, S, PS, c0, cend);
  const int len = min(len_b, S);
  // the splits that hold positions, a prefix of them (the chunks ascend):
  // the others leave at once, and they alone merge; none (a lane of length
  // 0): split 0 writes the empty result
  int nreal = 0;
  for (int i = 0; i < P; ++i) nreal += ALIGN * (int)((long)i * U / P) < len;
  if (split >= max(nreal, 1)) return;
  const int c1 = min(cend, len);
  const int ntile = c1 > c0 ? (c1 - c0 + T - 1) / T : 0;
  const SRC src(pg_s, B, Hx, NH, S, layer, b, hx, NP, PS, c0);
  const int r = warp * PPW + lane / LPP;  // this lane's position in a tile

  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  if (threadIdx.x == 0) {
    for (int st = 0; st < NST; ++st) aria::mbar_init(aria::smem_u32(&full[st]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // a thread copies a tile's valid rows (and scales) with bulk copies (the
  // ring's first tiles one a thread, at once); rows past the chunk's end
  // keep stale bytes, which no result reads, and a tile on a page outside
  // the pool copies nothing (its stage completes on a plain arrival) and
  // is masked
  auto load = [&](int tile, bool mine) {
    if (mine && tile < ntile) {
      const int st = tile % NST, p0 = c0 + tile * T, n = min(T, c1 - p0);
      const uint32_t ks = sbase + st * C::STAGE, vs = ks + T * C::ROW;
      const uint32_t bar = aria::smem_u32(&full[st]);
      if (!src.ok(p0)) {
        aria::mbar_arrive(bar);
        return;
      }
      size_t row, s0, s1;
      src.rows(p0, row, s0, s1);
      const uint32_t rows = n * C::ROW, scb = (n * C::SCB + 15) / 16 * 16;
      aria::mbar_expect_tx(bar, 2 * rows + C::NSC * scb);
      aria::bulk_load(ks, k + row * C::ROW, rows, bar);
      aria::bulk_load(vs, v + row * C::ROW, rows, bar);
#pragma unroll
      for (int a = 0; a < C::NSC; ++a) {  // [k, v] per head, after the rows
        const uint8_t* base = static_cast<const uint8_t*>(a % 2 ? v_scale : k_scale);
        aria::bulk_load(vs + T * C::ROW + a * C::SC_BYTES, base + (a / 2 ? s1 : s0) * C::SCB,
                        scb, bar);
      }
    }
  };
  auto wait = [&](int tile) {
    aria::mbar_wait(aria::smem_u32(&full[tile % NST]), (tile / NST) & 1);
  };

  load(threadIdx.x, threadIdx.x < NST - 2);
  // the query's dims of this lane: key-row chunks qd + LPP * i, times
  // qscale in f32 and rounded to bf16 (the wrapper's scaling of a bf16
  // query, done here; 1 where the wrapper scaled, which leaves q as it is)
  float qr[NH][C::DPL];
#pragma unroll
  for (int t = 0; t < NH; ++t) {
    const __nv_bfloat16* qh = q + ((size_t)b * H + hx + t * Hx) * D;
#pragma unroll
    for (int i = 0; i < C::DPL; ++i)
      qr[t][i] = aria::bf16_round(
          aria::bf2f(qh[C::DPC * (qd + LPP * (i / C::DPC)) + i % C::DPC]) * qscale);
  }

  float m[NH], s[NH], acc[NH][4];
#pragma unroll
  for (int t = 0; t < NH; ++t) {
    m[t] = aria::NEG_INF;
    s[t] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  }

  // a tile's scores for this lane's position (summed over its LPP lanes
  // later), the position's k and v scales per head, and whether it counts
  auto score = [&](int tile, float (&sc)[NH], float (&scl)[NH][2], bool& valid) {
    const uint8_t* ks = smem + (tile % NST) * C::STAGE;
    const uint8_t* vs = ks + T * C::ROW;
    valid = src.ok(c0 + tile * T) && c0 + tile * T + r < c1;
#pragma unroll
    for (int t = 0; t < NH; ++t) {
      scl[t][0] = scl[t][1] = 1.f;
      if constexpr (KIND == INT8) {
        const float* sd = reinterpret_cast<const float*>(vs + T * C::ROW);
        scl[t][0] = sd[r];
        scl[t][1] = sd[T + r];
      } else if constexpr (KIND == INT4) {
        const __nv_bfloat16* sd = reinterpret_cast<const __nv_bfloat16*>(vs + T * C::ROW);
        scl[t][0] = aria::bf2f(sd[2 * t * T + r]);
        scl[t][1] = aria::bf2f(sd[(2 * t + 1) * T + r]);
      }
      sc[t] = 0.f;
    }
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
  };
  // p * v over the warp's positions of a tile, this lane's 4 dims, without
  // a branch: past the chunk (or on a masked page) p is 0, and the stale
  // bytes read there are finite as int8 or nibbles and zeroed as bf16
  auto pv = [&](int tile, const float (&pw)[NH]) {
    const uint8_t* vs = smem + (tile % NST) * C::STAGE + T * C::ROW;
    const bool tile_ok = src.ok(c0 + tile * T);  // block-uniform
#pragma unroll
    for (int j = 0; j < PPW; ++j) {
      const uint8_t* vr = vs + (warp * PPW + j) * C::ROW;
      float pj[NH];
#pragma unroll
      for (int t = 0; t < NH; ++t) pj[t] = __shfl_sync(aria::FULL_MASK, pw[t], LPP * j);
      if constexpr (KIND == BF16) {
        const bool live = tile_ok && c0 + tile * T + warp * PPW + j < c1;  // warp-uniform
        float f[4];
        aria::load4(reinterpret_cast<const __nv_bfloat16*>(vr) + 4 * lane, f);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][e] += pj[0] * (live ? f[e] : 0.f);
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
  };

  // two tiles an iteration (the last may be alone): both tiles' scores,
  // one online-softmax update, then their p * v, so each warp carries two
  // positions' chains at once and the block syncs once per two tiles; the
  // two stages of the iteration before are refilled first (the ring holds
  // NST - 2 tiles ahead)
  for (int tile = 0; tile < ntile; tile += 2) {
    load(tile + NST - 2 + threadIdx.x, threadIdx.x < 2);
    const bool two = tile + 1 < ntile;  // block-uniform
    float sc[2][NH], scl[2][NH][2];
    bool valid[2];
    wait(tile);
    score(tile, sc[0], scl[0], valid[0]);
    if (two) {
      wait(tile + 1);
      score(tile + 1, sc[1], scl[1], valid[1]);
    } else {
      valid[1] = false;
#pragma unroll
      for (int t = 0; t < NH; ++t) sc[1][t] = 0.f, scl[1][t][0] = scl[1][t][1] = 1.f;
    }
    float pw[2][NH];
#pragma unroll
    for (int t = 0; t < NH; ++t) {
#pragma unroll
      for (int x = 1; x < LPP; x <<= 1)
#pragma unroll
        for (int u = 0; u < 2; ++u) sc[u][t] += __shfl_xor_sync(aria::FULL_MASK, sc[u][t], x);
#pragma unroll
      for (int u = 0; u < 2; ++u) sc[u][t] = valid[u] ? sc[u][t] * scl[u][t][0] : aria::NEG_INF;
      // the LPP lanes of a position agree: xor LPP .. 16 spans the warp's
      float mx = fmaxf(sc[0][t], sc[1][t]);
#pragma unroll
      for (int x = LPP; x < 32; x <<= 1) mx = fmaxf(mx, __shfl_xor_sync(aria::FULL_MASK, mx, x));
      const float mn = fmaxf(m[t], mx);
      const float corr = expf(m[t] - mn);
      float pr[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) pr[u] = valid[u] ? expf(sc[u][t] - mn) : 0.f;
      float sum = pr[0] + pr[1];
#pragma unroll
      for (int x = LPP; x < 32; x <<= 1) sum += __shfl_xor_sync(aria::FULL_MASK, sum, x);
      s[t] = s[t] * corr + sum;
      m[t] = mn;
#pragma unroll
      for (int u = 0; u < 2; ++u)
        pw[u][t] = valid[u] ? aria::bf16_round(KIND == BF16 ? pr[u] : pr[u] * scl[u][t][1]) : 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] *= corr;
    }
    pv(tile, pw[0]);
    if (two) pv(tile + 1, pw[1]);
    __syncthreads();  // the stages are read before the next loads overwrite them
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
  if (nreal > 1) {  // else this block's result is the whole one
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
    if (threadIdx.x == 0) last = atomicAdd(&counters[bx], 1u) == (unsigned)(nreal - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
    // the real splits' m and s into shared memory at once (past the warps'
    // accumulators), then the merge in split order
    const size_t first = bx * P * NH;
    float* mrg = red_acc + NH * WARPS * D;  // m [nreal][NH], then s
    for (int i = threadIdx.x; i < nreal * NH; i += THREADS) {
      mrg[i] = __ldcg(ws_m + first + i);
      mrg[nreal * NH + i] = __ldcg(ws_s + first + i);
    }
    __syncthreads();
    if (active) {
      M = aria::NEG_INF;
      for (int i = 0; i < nreal; ++i) M = fmaxf(M, mrg[i * NH + sel]);
      tot = 0.f;
      a = 0.f;
#pragma unroll 4
      for (int i = 0; i < nreal; ++i) {
        const float e = expf(mrg[i * NH + sel] - M);
        tot += mrg[(nreal + i) * NH + sel] * e;
        a += __ldcg(ws + (first + i * NH + sel) * D + d) * e;
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

template <int KIND, typename SRC>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* table, const void* lengths, void* out, void* acc, void* m, void* s,
           void* ws, void* counters, int B, int Hx, int S, int layer, int NP, int PS, int P,
           float qscale, cudaStream_t stream) {
  const int smem = stages<KIND, SRC>() * Cfg<KIND>::STAGE + SRC::page_bytes(S, PS);
  const auto kernel = decode_attention_kernel<KIND, SRC>;
  const cudaError_t err = aria::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(Hx, B, P), THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const uint8_t*)k, (const uint8_t*)v, ks, vs, (const int*)table,
      (const int*)lengths, (__nv_bfloat16*)out, (float*)acc, (float*)m, (float*)s, (float*)ws,
      (unsigned*)counters, B, Hx, S, layer, NP, PS, qscale);
  return (int)cudaGetLastError();
}

}  // namespace

// kind: 0 bf16 cache, 1 int8 with f32 scales, 2 packed int4 with bf16 scales
// (Hx = H/2 head pairs, else Hx = H). q bf16 [B, H, 128], scaled in the
// kernel by qscale (f32, then rounded to bf16). With acc non-null, the stats form
// (acc, m, s; out null), else the normal form into out. P splits over
// positions; with P > 1, ws holds B * Hx * P * (H / Hx) * (128 + 2) f32 and
// counters B * Hx zeroed unsigned ints, which the kernel leaves zeroed.
ARIA_EXPORT int aria_decode_attention(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale,
                                      const void* lengths, void* out, void* acc, void* m,
                                      void* s, void* ws, void* counters, int B, int Hx, int S,
                                      int layer, int kind, int P, float qscale,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const auto args = std::make_tuple(q, k, v, k_scale, v_scale, (const void*)nullptr, lengths, out,
                                    acc, m, s, ws, counters, B, Hx, S, layer, 0, 0, P, qscale, st);
  switch (kind) {
    case BF16:
      return std::apply(launch<BF16, Stacked>, args);
    case INT8:
      return std::apply(launch<INT8, Stacked>, args);
    case INT4:
      return std::apply(launch<INT4, Stacked>, args);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The paged form: q bf16 [B, H, 128], scaled in the kernel by qscale (f32,
// then rounded to bf16), pages k, v [L, NP, H, PS, 128] bf16 or int8
// (quantized, with f32 scales [L, NP, H, PS]), table int32 [B, MAXP],
// lengths int32 [B], out bf16 [B, H, 128]. P splits over the MAXP * PS
// positions; with P > 1, ws holds B * H * P * 130 f32 and counters B * H
// zeroed unsigned ints, which the kernel leaves zeroed.
ARIA_EXPORT int aria_paged_decode_attention(const void* q, const void* k, const void* v,
                                            const void* k_scale, const void* v_scale,
                                            const void* table, const void* lengths, void* out,
                                            void* ws, void* counters, int B, int H, int NP,
                                            int PS, int MAXP, int layer, int quantized, int P,
                                            float qscale, void* stream) {
  const int S = MAXP * PS;
  if (PS % Cfg<BF16>::T != 0 || MAXP < 1 || P < 1 || P > (S + ALIGN - 1) / ALIGN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const auto args = std::make_tuple(q, k, v, k_scale, v_scale, table, lengths, out,
                                    (void*)nullptr, (void*)nullptr, (void*)nullptr, ws, counters,
                                    B, H, S, layer, NP, PS, P, qscale, st);
  return quantized ? std::apply(launch<INT8, Paged>, args) : std::apply(launch<BF16, Paged>, args);
}
