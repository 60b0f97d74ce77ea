// flash_segment_bwd: the backward of the ViT's segment attention
// (aria_flash_segment, csrc/vit_attention.cu): dq [B, Sq, H, D], dk and dv
// [B, Sk, H, D] (bf16) from q, k, v, the output o and its cotangent do
// (bf16, D 64 or 72), the forward's row statistics m and l (f32 [2, B, H,
// Sq]) and the segment masks q_valid [B, Sq] and kv_valid [B, Sk] (bool
// bytes, NULL: every position valid).
//
// Replaces the backward of the library Pallas TPU flash attention that
// aria_tpu/ops/flash.py:30 flash_sdpa calls with `SegmentIds` and
// causal=False (jax/experimental/pallas/ops/tpu/flash_attention.py:254-300):
// the dkv kernel (`_flash_attention_bwd_dkv`, :941) and the dq kernel
// (`_flash_attention_bwd_dq`, :1287). The arithmetic is the library's:
// di = rowsum(o * do) in f32; s = q.k in f32, times the scale in f32, plus
// -0.7 * FLT_MAX where the query's segment differs from the key's (-inf
// past Sk); p = exp(s - m) * (1 / l); dv += p^T do with p rounded to bf16,
// dp = do v^T; ds = (dp - di) * p * scale; dk += ds^T q and dq += ds k with
// ds rounded to bf16. Every product sums in f32 and each gradient is
// rounded once. The exponential is ex2.approx((s - m) * log2(e)) with
// subnormal results flushed to 0, a few ulps from expf.
//
// Bound: operations, 5 products of 2 * Sq * Sk * D FLOPs per (b, h) (s,
// dp, dv, dk, dq): 276.6 GFLOP at [1, 4900, 16, 72], 0.280 ms at the bf16
// peak. The design is flash_bwd.cu's (FlashAttention-3's backward on
// Hopper's pieces, hopper.cuh), one pass over the key tiles with five
// products on wgmma, adapted to the ViT's head dims and segments:
//
// - Two launches. A prep kernel packs each query row's (m, 1 / l, di,
//   segment) into a float4, one warp a row and one block a tile of 64
//   rows (rows past Sq get segment -1 and 1 / l = 0, so they add nothing),
//   and writes each query tile's flags: which segments its rows hold, and
//   whether a row has no key of its own segment (its m is the masked
//   -0.7 * FLT_MAX: a pad query when every key is valid, which the library
//   gives attention over every key).
// - The main kernel: a block takes one (b, h) and a tile of 128 keys, two
//   consumer warpgroups of 64 keys each, 256 threads, no producer warp
//   (flash_bwd.cu's register finding: a ninth warp caps a thread at 168
//   registers). Thread 0 starts the loads: K and V once, and Q and dO in
//   tiles of 64 queries with their 1 KB of row statistics through a
//   3-stage ring with a full mbarrier a stage, refilled once both
//   warpgroups are past the step that read it (the warpgroups meet at a
//   named barrier each step, before dQ reads both halves of dS^T).
// - D = 72 against the 128-byte swizzle (vit_attention.cu's layout): a
//   tile's columns 0-63 are one swizzled box, columns 64-71 an unswizzled
//   8-column tail box (16-byte rows, the core matrices of an unswizzled
//   wgmma operand). A box zero-filled to 128 columns would make TMA move
//   the zeros too (the forward measured 0.337 ms of loads against the
//   tail's 0.196). At D = 64 a tile is the box alone.
// - Per query tile, 5 products: S^T = K Q^T and dP^T = V dO^T (m64n64k16:
//   four k-steps in the box and, at D = 72, a fifth on the tails whose
//   columns 72-79 read 1 KB of zeros at LBO). K and V are the A operands:
//   each warp keeps its 16 keys of both in registers as wgmma A fragments
//   (ldmatrix once, 40 registers), so these products read only Q and dO
//   from shared memory (both operands from there would read 128 bytes a
//   clock at m64n64k16, the SM's shared-memory rate). P^T and dS^T are
//   made on the accumulators; dV += P^T dO and dK += dS^T Q take them as A
//   from registers (m64n64k16 on the box, m64n8k16 on the tail, B
//   MN-major through the transpose bit). dQ = dS K runs from dS^T staged
//   to shared memory as bf16 (two buffers, a named barrier between the two
//   warpgroups): warpgroup 0 takes dQ's columns 0-63 (m64n64k16 over the
//   box), warpgroup 1 the tail's 64-71 (m64n8k16; none at D = 64).
// - Segments. Each key's additive mask for a query of segment 0 and of
//   segment 1 stays in registers; a thread picks one by the query's
//   segment. A (query tile, key tile) pair whose query rows and keys are
//   all of one segment, with every key inside Sk and no row without a key
//   of its segment, skips the masks (the add of 0 they would make changes
//   no value). A pair in which no query shares a segment with any key, and
//   no query lacks a key of its own segment, is not visited at all: its p
//   is exactly 0 there (exp of a score 0.7 * FLT_MAX below the row's max,
//   flushed to zero), so every term it would add to dk, dv and dq is an
//   exact zero. The block's prologue scans kv_valid for which segments
//   each key tile of b holds and lists the query tiles its key tile visits.
// - dq. Each key tile's part of a query tile's dQ (warpgroup 0: 64 x 64
//   f32, warpgroup 1: 64 x 8) is added into an f32 scratch in a fixed order
//   of key tiles, so dq's bits repeat from run to run; no atomics in
//   arrival order. A warpgroup stages its part in shared memory at the end
//   of a step; in the next, while the tensor cores run S^T and dP^T, one of
//   its threads waits until the query tile's counter reads the parts of
//   every key tile before this one that visits it (acquire), and adds its
//   part with a bulk reduce-add (the first such key tile: a bulk store);
//   before that step's dV and dK products it waits for the copy and adds
//   one to the counter (release): counted there and not after the step's
//   dQ product, the next key tile waits less (tools/seg_bwd_probe.py).
//   The last key tile that visits a query tile loads the scratch, all of
//   it before any store (a store between two loads would wait out each
//   one's trip to L2, and that tile ran far longer than the others), adds
//   its own part and writes dq in bf16. Which key tiles visit a query tile follows
//   from the tile flags alone, so each block knows, without asking another,
//   how many parts come before its own and whether it is the last.
// - Order. Every key tile of a class visits the same query tiles, so the
//   counters make a wavefront: in a class, key tile j adds to a query tile
//   after key tile j - 1 has, and runs a fraction of a step behind it. The
//   order puts the key tiles with keys of segment 0 only first, then those
//   of segment 1 only, then those of both, each ascending: at a prefix
//   mask (a landscape crop) the padding's key tiles start at the first
//   query tile they visit instead of waiting until the valid key tiles
//   reach it (which left them idle most of their time). A block's place in
//   the order is blockIdx.x % nkt, the blocks of a head consecutive, and
//   blocks are dispatched in order of their index, so a block waits only
//   for blocks dispatched before it, which hold an SM or have finished: a
//   waiting block never holds an SM that a block it waits for needs. As
//   blocks finish one after another, the next head's blocks start one after
//   another, in the wavefront's order. (Two chains of key tiles into two
//   scratches, summed by the last, measured slower: the sum's second read
//   cost more than the shorter wavefront saved.)
//
// Rows past Sq or Sk load as zeros (TMA) and are masked and not stored, so
// any Sq and Sk work.

#include <float.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int KT = 128;         // keys per block: two warpgroups of 64
constexpr int QT = 64;          // queries per step
constexpr int STAGES = 3;       // the Q / dO ring
constexpr int THREADS = 256;    // two warpgroups
constexpr int ROW_BYTES = 128;  // one swizzled row: 64 bf16
constexpr int TAIL_ROW = 16;    // one unswizzled tail row: 8 bf16
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASK_VALUE = -0.7f * FLT_MAX;  // the library's DEFAULT_MASK_VALUE
// a row max below this is the masked value: the row has no key of its segment
constexpr float NO_KEY_M = -1e37f;

// a query tile's flags (the prep kernel) and a key tile's bits (the main
// kernel's prologue): rows or keys of segment 0, of segment 1; for a query
// tile, a row without a key of its own segment; for a key tile, keys past Sk
constexpr int SEG0 = 1, SEG1 = 2, NO_KEY = 4, PAST = 4;

template <int D>
struct Cfg {
  static constexpr bool TAIL = D > 64;
  static constexpr int NPARTS = TAIL ? 2 : 1;  // dq parts a key tile adds
  static constexpr int KS = TAIL ? 5 : 4;      // k-steps over d
  static constexpr int KV_BOX = KT * ROW_BYTES;
  static constexpr int KV_BYTES = KV_BOX + (TAIL ? KT * TAIL_ROW : 0);
  static constexpr int Q_BOX = QT * ROW_BYTES;
  static constexpr int Q_BYTES = Q_BOX + (TAIL ? QT * TAIL_ROW : 0);
  static constexpr int STAT_BYTES = QT * 16;      // a query tile's float4 rows
  static constexpr int DS_BYTES = KT * ROW_BYTES;  // dS^T: 128 keys x 64 queries bf16
  static constexpr int DQ0 = QT * 64 * 4;          // warpgroup 0's dQ part (f32)
  static constexpr int DQ1 = TAIL ? QT * 8 * 4 : 0;  // warpgroup 1's
  // shared memory from a 1024-byte aligned base (the swizzle's alignment)
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + KV_BYTES;
  static constexpr int Q_OFF = V_OFF + KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * Q_BYTES;
  static constexpr int DS_OFF = DO_OFF + STAGES * Q_BYTES;  // two buffers
  static constexpr int DQ_OFF = DS_OFF + 2 * DS_BYTES;
  static constexpr int ZERO_OFF = DQ_OFF + DQ0 + DQ1;       // columns 72-79 of 64 rows
  static constexpr int ST_OFF = ZERO_OFF + (TAIL ? QT * TAIL_ROW : 0);
  static constexpr int BAR_OFF = ST_OFF + STAGES * STAT_BYTES;  // kv, full[STAGES]
  static constexpr int INFO_OFF = BAR_OFF + 8 * (1 + STAGES);   // 8 ints, below
  static constexpr int LIST_OFF = INFO_OFF + 8 * 4;  // the visited query tiles, the key tiles' bits
  static constexpr int bytes(int nqt, int nkt) { return LIST_OFF + 4 * nqt + nkt + 1024; }
};
// info[]: the key tiles of b of each class (keys of segment 0 only, of
// segment 1 only, of both); this block's key tile, its class, its place in
// the class, its bits; the query tiles it visits
enum { N0 = 0, N1 = 1, N2 = 2, KTILE = 3, CLASS = 4, INDEX = 5, KBITS = 6, NSTEPS = 7 };

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return aria::sw128_desc(addr, lbo, 1024);
}

__device__ __forceinline__ void ldsm4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm2(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

// (m, 1 / l, di, segment) of each query row, [B, H, Sqp] (Sqp: Sq rounded up
// to 64), and each query tile's flags [B, H, Sqp / 64]; one block a tile, one
// warp a row
__global__ void __launch_bounds__(256)
seg_bwd_prep_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ stats, const uint8_t* __restrict__ q_valid,
                    float4* __restrict__ qs, int* __restrict__ qflags, int B, int Sq, int H,
                    int D) {
  const int nqt = (Sq + QT - 1) / QT, Sqp = nqt * QT;
  const int bh = blockIdx.x / nqt, qt = blockIdx.x % nqt, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int flags = 0;
  for (int i = 0; i < QT / 8; ++i) {
    const int s = qt * QT + warp * (QT / 8) + i;
    float4 r = make_float4(0.f, 0.f, 0.f, -1.f);
    if (s < Sq) {  // warp-uniform
      float v = 0.f;
      if (lane < D / 4) {
        const size_t at = (((size_t)b * Sq + s) * H + h) * D + 4 * lane;
        const uint2 ow = *reinterpret_cast<const uint2*>(o + at);
        const uint2 dw = *reinterpret_cast<const uint2*>(dout + at);
        v = aria::bf_lo(ow.x) * aria::bf_lo(dw.x) + aria::bf_hi(ow.x) * aria::bf_hi(dw.x) +
            aria::bf_lo(ow.y) * aria::bf_lo(dw.y) + aria::bf_hi(ow.y) * aria::bf_hi(dw.y);
      }
      v = aria::warp_sum(v);
      const size_t st = (size_t)bh * Sq + s;
      const float m = stats[st];
      const int seg = q_valid == nullptr ? 1 : (int)q_valid[(size_t)b * Sq + s];
      r = make_float4(m, 1.f / stats[(size_t)B * H * Sq + st], v, (float)seg);
      flags |= (seg ? SEG1 : SEG0) | (m < NO_KEY_M ? NO_KEY : 0);
    }
    if (lane == 0) qs[(size_t)bh * Sqp + s] = r;
  }
  const int any0 = __syncthreads_or(flags & SEG0), any1 = __syncthreads_or(flags & SEG1);
  const int none = __syncthreads_or(flags & NO_KEY);
  if (threadIdx.x == 0)
    qflags[blockIdx.x] = (any0 ? SEG0 : 0) | (any1 ? SEG1 : 0) | (none ? NO_KEY : 0);
}

// the maps of q, k, v and do: columns 0-63 (swizzled boxes) and the tails
struct Maps {
  CUtensorMap q, k, v, d, qt, kt, vt, dt;
};

// thread 0's loads of step t's query tile (list[t]) into stage t % STAGES
template <int D>
__device__ __forceinline__ void load_step(const Maps& maps, uint32_t base, const int* list, int t,
                                          const float4* qrow, int b, int h) {
  using C = Cfg<D>;
  const int st = t % STAGES, q0 = (list[t] & 0xFFFFFF) * QT;
  const uint32_t full = base + C::BAR_OFF + 8 * (1 + st);
  const uint32_t sq = base + C::Q_OFF + st * C::Q_BYTES, sd = base + C::DO_OFF + st * C::Q_BYTES;
  aria::mbar_expect_tx(full, 2 * C::Q_BYTES + C::STAT_BYTES);
  aria::tma_load(sq, &maps.q, full, 0, h, q0, b);
  aria::tma_load(sd, &maps.d, full, 0, h, q0, b);
  if constexpr (C::TAIL) {
    aria::tma_load(sq + C::Q_BOX, &maps.qt, full, 64, h, q0, b);
    aria::tma_load(sd + C::Q_BOX, &maps.dt, full, 64, h, q0, b);
  }
  aria::bulk_load(base + C::ST_OFF + st * C::STAT_BYTES, qrow + q0, C::STAT_BYTES, full);
}

// P^T and dS^T of one step on a thread's accumulators (keys ka: e < 2, kb:
// e >= 2; query 8n + c2 + e % 2), packed to bf16 as wgmma's A fragments as
// they are made: k-step u holds queries 16u..16u+15, the accumulator's
// column blocks 2u and 2u+1
template <bool MASKED>
__device__ __forceinline__ void scores(const float (&s)[32], const float (&dp)[32],
                                       const float4* stq, int c2, const float (&add0)[2],
                                       const float (&add1)[2], float scale, uint32_t (&pa)[16],
                                       uint32_t (&sa)[16]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float4 q0 = stq[8 * n + c2], q1 = stq[8 * n + c2 + 1];
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4& r = (e & 1) ? q1 : q0;  // (m, 1 / l, di, segment)
      float x = __fmul_rn(s[4 * n + e], scale);
      if (MASKED) x = __fadd_rn(x, r.w > 0.5f ? add1[e >> 1] : add0[e >> 1]);
      p[e] = __fmul_rn(ex2(__fmul_rn(x - r.x, LOG2E)), r.y);
      ds[e] = __fmul_rn(__fmul_rn(dp[4 * n + e] - r.z, p[e]), scale);
    }
    pa[2 * n] = aria::pack_bf16(p[0], p[1]);
    pa[2 * n + 1] = aria::pack_bf16(p[2], p[3]);
    sa[2 * n] = aria::pack_bf16(ds[0], ds[1]);
    sa[2 * n + 1] = aria::pack_bf16(ds[2], ds[3]);
  }
}

// warpgroup CW's keys: dK and dV in registers over the visited query tiles,
// and its part of dQ (warpgroup 0: columns 0-63; 1: 64-71 at D = 72)
template <int D, int CW>
__device__ __forceinline__ void consume(const Maps& maps, uint32_t base, uint8_t* gbase,
                                        const float4* qrow, const uint8_t* kv_valid,
                                        float* dq_acc, int* ctr, __nv_bfloat16* dq,
                                        __nv_bfloat16* dk, __nv_bfloat16* dv, int b, int h,
                                        int bh, int kt, int nqt, int Sq, int Sk, int H,
                                        float scale) {
  using C = Cfg<D>;
  constexpr bool TAIL = C::TAIL;
  constexpr bool PART = CW == 0 || TAIL;  // this warpgroup adds a part of dq
  const int* const info = reinterpret_cast<const int*>(gbase + C::INFO_OFF);
  const int* const list = reinterpret_cast<const int*>(gbase + C::LIST_OFF);
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, ct = threadIdx.x % 128;
  const int rw = warp * 16 + lane / 4;  // this thread's first fragment row (and rw + 8)
  const int c2 = 2 * (lane % 4);        // its first column in each 8-column block
  const int ka = kt * KT + CW * 64 + rw;  // its two keys: ka, ka + 8
  const uint32_t sk = base + C::K_OFF, sv = base + C::V_OFF, zero = base + C::ZERO_OFF;
  const uint32_t bar_kv = base + C::BAR_OFF;
  const int nsteps = info[NSTEPS], kbits = info[KBITS];
  const int n0 = info[N0], n1 = info[N1], n2 = info[N2], cls = info[CLASS], idx = info[INDEX];

  // each key's additive mask for a query of segment 0 and of segment 1
  float add0[2], add1[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = ka + 8 * hr;
    const int seg = key >= Sk ? -1 : kv_valid == nullptr ? 1 : (int)kv_valid[(size_t)b * Sk + key];
    add0[hr] = seg < 0 ? -INFINITY : seg == 0 ? 0.f : MASK_VALUE;
    add1[hr] = seg < 0 ? -INFINITY : seg == 1 ? 0.f : MASK_VALUE;
  }

  // this warp's 16 keys of K and V as A fragments: k-step kk holds columns
  // 16kk..16kk+15 (the fifth: the tail's 64-71, then zeros)
  aria::mbar_wait(bar_kv, 0);
  uint32_t kf[C::KS][4], vf[C::KS][4];
  {
    const int r0 = CW * 64 + warp * 16, mi = lane / 8;
    const int row = r0 + lane % 8 + 8 * (mi % 2);  // ldmatrix's matrix mi, row lane % 8
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t off = row * ROW_BYTES + (((2 * kk + mi / 2) ^ (row & 7)) << 4);
      ldsm4(sk + off, kf[kk]);
      ldsm4(sv + off, vf[kk]);
    }
    if constexpr (TAIL) {
      const uint32_t off = C::KV_BOX + (r0 + lane % 16) * TAIL_ROW;
      ldsm2(sk + off, kf[4]);
      ldsm2(sv + off, vf[4]);
      kf[4][2] = kf[4][3] = vf[4][2] = vf[4][3] = 0;
    }
  }

  float dkr[32], dvr[32], dkt[4], dvt[4];  // dK, dV: columns 0-63, and 64-71 (D = 72)
#pragma unroll
  for (int i = 0; i < 32; ++i) dkr[i] = dvr[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) dkt[i] = dvt[i] = 0.f;
  int staged = -1, staged_rank = 0;  // the query tile whose dQ part waits in shared memory
  int pending = -1;  // the query tile whose bulk add is in flight, not yet counted
  const uint32_t part_src = base + C::DQ_OFF + (CW ? C::DQ0 : 0);
  constexpr int PART_BYTES = CW ? C::DQ1 : C::DQ0;
  auto part_of = [&](int qt) {  // this warpgroup's part of query tile qt in the scratch
    return dq_acc + ((size_t)bh * nqt + qt) * (QT * D) + (CW ? QT * 64 : 0);
  };
  // the staged part, added after the parts of the key tiles before this one
  auto add_staged = [&]() {
    asm volatile("bar.sync %0, 128;\n" :: "r"(2 + CW) : "memory");  // it is staged
    if (ct == 0) {
      float* const part = part_of(staged);
      if (staged_rank == 0) {
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                     :: "l"(part), "r"(part_src), "r"(PART_BYTES) : "memory");
      } else {
        aria::wait_count(ctr + staged, C::NPARTS * staged_rank);
        asm volatile(
            "fence.proxy.async.global;\n"
            " cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
            :: "l"(part), "r"(part_src), "r"(PART_BYTES) : "memory");
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    pending = staged;
    staged = -1;
  };

  for (int t = 0; t < nsteps; ++t) {
    const int st = t % STAGES, qt = list[t] & 0xFFFFFF, f = list[t] >> 24;
    const uint32_t sq = base + C::Q_OFF + st * C::Q_BYTES, sd = base + C::DO_OFF + st * C::Q_BYTES;
    const uint32_t sds = base + C::DS_OFF + (t & 1) * C::DS_BYTES;
    const float4* const stq =
        reinterpret_cast<const float4*>(gbase + C::ST_OFF + st * C::STAT_BYTES);
    aria::mbar_wait_loop(bar_kv + 8 * (1 + st), (t / STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries, k-steps over d
    float s[32], dp[32];
    aria::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 16 columns a step, 32 bytes into the box's rows
      aria::wgmma_rs64<0>(s, kf[kk], desc(sq + kk * 32, 16), kk > 0);
    if constexpr (TAIL)  // columns 64-71 from the tail, 72-79 from the zeros at LBO
      aria::wgmma_rs64<0>(s, kf[4], aria::plain_desc(sq + C::Q_BOX, zero - (sq + C::Q_BOX), 128));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      aria::wgmma_rs64<0>(dp, vf[kk], desc(sd + kk * 32, 16), kk > 0);
    if constexpr (TAIL)
      aria::wgmma_rs64<0>(dp, vf[4], aria::plain_desc(sd + C::Q_BOX, zero - (sd + C::Q_BOX), 128));
    aria::wgmma_commit();
    if constexpr (PART)
      if (staged >= 0) add_staged();  // the last step's dQ part
    aria::wgmma_wait<0>();
    aria::fence_regs(s);
    aria::fence_regs(dp);

    // P^T and dS^T; the masks only where the pair is not all of one segment
    uint32_t pa[16], sa[16];
    if (f == (kbits & 7) && (f == SEG0 || f == SEG1))
      scores<false>(s, dp, stq, c2, add0, add1, scale, pa, sa);
    else
      scores<true>(s, dp, stq, c2, add0, add1, scale, pa, sa);
    // dS^T into this step's buffer: row = key (one swizzled 128-byte row of
    // 64 queries), the 16-byte chunk n at n ^ (row % 8)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = CW * 64 + rw + 8 * hr;
        asm volatile("st.shared.u32 [%0], %1;\n"
                     :: "r"(sds + row * ROW_BYTES + ((n ^ (row & 7)) << 4) + c2 * 2),
                        "r"(sa[2 * n + hr]) : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    // the add issued with this step's first products has landed by now:
    // counted here, before the products that follow, so that the next key
    // tile's add waits as little as it can
    if (PART && ct == 0 && pending >= 0) aria::release_count(ctr + pending);
    pending = -1;

    // dV += P^T dO and dK += dS^T Q: 16 queries a k-step; the box, then the tail
    aria::wgmma_fence();
#pragma unroll
    for (int u = 0; u < QT / 16; ++u) {
      aria::wgmma_rs64<1>(dvr, pa + 4 * u, desc(sd + u * 16 * ROW_BYTES, C::Q_BOX));
      if constexpr (TAIL)
        aria::wgmma_rs8<1>(dvt, pa + 4 * u,
                           aria::plain_desc(sd + C::Q_BOX + u * 16 * TAIL_ROW, 128, 256));
    }
#pragma unroll
    for (int u = 0; u < QT / 16; ++u) {
      aria::wgmma_rs64<1>(dkr, sa + 4 * u, desc(sq + u * 16 * ROW_BYTES, C::Q_BOX));
      if constexpr (TAIL)
        aria::wgmma_rs8<1>(dkt, sa + 4 * u,
                           aria::plain_desc(sq + C::Q_BOX + u * 16 * TAIL_ROW, 128, 256));
    }
    aria::wgmma_commit();

    // this step's bulk add has read its staging buffer, and both warpgroups'
    // dS^T are in; dQ = dS K over the tile's 128 keys, 16 a k-step: A is
    // dS^T (MN-major), B this warpgroup's columns of K (MN-major)
    if (PART && ct == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    float dqr[CW == 0 ? 32 : 4];
    if constexpr (CW == 0) {
      aria::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        aria::wgmma_ss64<1, 1>(dqr, desc(sds + kk * 16 * ROW_BYTES, C::DS_BYTES),
                               desc(sk + kk * 16 * ROW_BYTES, C::KV_BOX), kk > 0);
      aria::wgmma_commit();
    } else if constexpr (TAIL) {
      aria::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        aria::wgmma_ss8<1, 1>(dqr, desc(sds + kk * 16 * ROW_BYTES, C::DS_BYTES),
                              aria::plain_desc(sk + C::KV_BOX + kk * 16 * TAIL_ROW, 128, 256),
                              kk > 0);
      aria::wgmma_commit();
    }
    // both warpgroups are past step t - 1: its stage takes step t - 1 + STAGES
    if (CW == 0 && threadIdx.x == 0 && t > 0 && t - 1 + STAGES < nsteps)
      load_step<D>(maps, base, list, t - 1 + STAGES, qrow, b, h);
    aria::wgmma_wait<0>();
    aria::fence_regs(dvr);
    aria::fence_regs(dkr);
    aria::fence_regs(dvt);
    aria::fence_regs(dkt);
    if constexpr (PART) aria::fence_regs(dqr);

    if constexpr (PART) {
      // the key tiles that visit this query tile before and after this one,
      // in the order of classes
      const int v0 = (f & (SEG0 | NO_KEY)) ? n0 : 0, v1 = (f & (SEG1 | NO_KEY)) ? n1 : 0;
      const int rank = idx + (cls > 0 ? v0 : 0) + (cls > 1 ? v1 : 0);
      const int later = (cls == 0 ? v0 : cls == 1 ? v1 : n2) - 1 - idx + (cls < 1 ? v1 : 0) +
                        (cls < 2 ? n2 : 0);
      if (later > 0) {  // staged for a bulk add
        float* const stage = reinterpret_cast<float*>(gbase + C::DQ_OFF + (CW ? C::DQ0 : 0));
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          if constexpr (CW == 0) {
#pragma unroll
            for (int n = 0; n < 8; ++n)
              *reinterpret_cast<float2*>(stage + aria::dq_at(rw + 8 * hr, 8 * n + c2)) =
                  make_float2(dqr[4 * n + 2 * hr], dqr[4 * n + 2 * hr + 1]);
          } else {
            *reinterpret_cast<float2*>(stage + (rw + 8 * hr) * 8 + c2) =
                make_float2(dqr[2 * hr], dqr[2 * hr + 1]);
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to the copy
        staged = qt;
        staged_rank = rank;
      } else {  // the last key tile here: the scratch plus its part, as bf16
        const float* const part = part_of(qt);
        if (rank > 0) {  // every load first: a store between two would wait out each
          aria::wait_count(ctr + qt, C::NPARTS * rank);
          asm volatile("fence.proxy.async.global;\n" ::: "memory");
          float2 a[2][CW == 0 ? 8 : 1];
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
#pragma unroll
            for (int n = 0; n < (CW == 0 ? 8 : 1); ++n)
              a[hr][n] = __ldcg(reinterpret_cast<const float2*>(
                  part + (CW == 0 ? aria::dq_at(rw + 8 * hr, 8 * n + c2)
                                  : (rw + 8 * hr) * 8 + c2)));
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
#pragma unroll
            for (int n = 0; n < (CW == 0 ? 8 : 1); ++n) {
              dqr[4 * n + 2 * hr] = a[hr][n].x + dqr[4 * n + 2 * hr];
              dqr[4 * n + 2 * hr + 1] = a[hr][n].y + dqr[4 * n + 2 * hr + 1];
            }
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int qi = qt * QT + rw + 8 * hr;
          __nv_bfloat16* const o = dq + (((size_t)b * Sq + qi) * H + h) * D + CW * 64 + c2;
          if (qi < Sq)
#pragma unroll
            for (int n = 0; n < (CW == 0 ? 8 : 1); ++n)
              *reinterpret_cast<uint32_t*>(o + 8 * n) =
                  aria::pack_bf16(dqr[4 * n + 2 * hr], dqr[4 * n + 2 * hr + 1]);
        }
      }
    }
  }
  if constexpr (PART) {
    if (staged >= 0) {  // the last step's part
      add_staged();
      if (ct == 0) aria::release_count(ctr + pending);
    }
  }

  // dK and dV rows of this thread's two keys
  const size_t row_stride = (size_t)H * D;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = ka + 8 * hr;
    if (key >= Sk) continue;
    const size_t at = ((size_t)b * Sk + key) * row_stride + (size_t)h * D + c2;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * n) =
          aria::pack_bf16(dkr[4 * n + 2 * hr], dkr[4 * n + 2 * hr + 1]);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * n) =
          aria::pack_bf16(dvr[4 * n + 2 * hr], dvr[4 * n + 2 * hr + 1]);
    }
    if constexpr (TAIL) {
      *reinterpret_cast<uint32_t*>(dk + at + 64) = aria::pack_bf16(dkt[2 * hr], dkt[2 * hr + 1]);
      *reinterpret_cast<uint32_t*>(dv + at + 64) = aria::pack_bf16(dvt[2 * hr], dvt[2 * hr + 1]);
    }
  }
}

// one block: (b, h) = blockIdx.x / nkt and the (blockIdx.x % nkt)-th key
// tile of b in the order of classes (the launch order above)
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
seg_bwd_kernel(const __grid_constant__ Maps maps, const float4* __restrict__ qs,
               const int* __restrict__ qflags, const uint8_t* __restrict__ kv_valid,
               float* __restrict__ dq_acc, int* __restrict__ counters,
               __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
               __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H, float scale) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = aria::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle needs 1024-byte alignment
  uint8_t* const gbase = smem_raw + (base - raw);
  const int nkt = (Sk + KT - 1) / KT, nqt = (Sq + QT - 1) / QT;
  int* const info = reinterpret_cast<int*>(gbase + C::INFO_OFF);
  int* const list = reinterpret_cast<int*>(gbase + C::LIST_OFF);
  uint8_t* const tbits = gbase + C::LIST_OFF + 4 * nqt;  // each key tile's bits
  const int bh = blockIdx.x / nkt, pos = blockIdx.x % nkt, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t bar_kv = base + C::BAR_OFF;

  if (threadIdx.x == 0) {
    aria::mbar_init(bar_kv, 1);
    for (int st = 0; st < STAGES; ++st) aria::mbar_init(bar_kv + 8 * (1 + st), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x < 8) info[threadIdx.x] = 0;
  if (C::TAIL && threadIdx.x < QT) {  // columns 72-79 that the fifth k-step reads: zeros
    reinterpret_cast<uint4*>(gbase + C::ZERO_OFF)[threadIdx.x] = make_uint4(0, 0, 0, 0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // the segments each key tile of b holds, and how many tiles of each class
  for (int j = warp; j < nkt; j += THREADS / 32) {
    unsigned bits = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = j * KT + 4 * lane + i;
      bits |= key >= Sk ? PAST
              : kv_valid == nullptr || kv_valid[(size_t)b * Sk + key] ? SEG1 : SEG0;
    }
    bits = __reduce_or_sync(aria::FULL_MASK, bits);
    if (lane == 0) {
      tbits[j] = (uint8_t)bits;
      atomicAdd(&info[N0 + (bits & 3) - 1], 1);
    }
  }
  __syncthreads();
  // this block's key tile: the pos-th in the order of classes, ascending
  // within a class; then the query tiles it visits, in order: those with a
  // row of a segment it holds, or a row without a key of its own segment
  if (warp == 0) {
    const int n0 = info[N0], n1 = info[N1];
    const int cls = pos < n0 ? 0 : pos < n0 + n1 ? 1 : 2;
    const int idx = pos - (cls == 0 ? 0 : cls == 1 ? n0 : n0 + n1);
    int i = idx, kt = 0;
    for (int j0 = 0; j0 < nkt; j0 += 32) {
      const int j = j0 + lane;
      const unsigned m = __ballot_sync(aria::FULL_MASK, j < nkt && (tbits[j] & 3) == cls + 1);
      if (i < __popc(m)) {
        kt = j0 + __fns(m, 0, i + 1);
        break;
      }
      i -= __popc(m);
    }
    const int segs = tbits[kt] & 3;
    int n = 0;
    for (int c = 0; c < nqt; c += 32) {
      const int qt = c + lane;
      const int f = qt < nqt ? qflags[(size_t)bh * nqt + qt] : 0;
      const bool visit = qt < nqt && ((f & NO_KEY) || (f & segs));
      const unsigned m = __ballot_sync(aria::FULL_MASK, visit);
      if (visit) list[n + __popc(m & ((1u << lane) - 1))] = qt | f << 24;
      n += __popc(m);
    }
    if (lane == 0) {
      info[CLASS] = cls;
      info[INDEX] = idx;
      info[KTILE] = kt;
      info[KBITS] = tbits[kt];
      info[NSTEPS] = n;
    }
  }
  __syncthreads();

  const int kt = info[KTILE];
  const float4* const qrow = qs + (size_t)bh * nqt * QT;
  if (threadIdx.x == 0) {
    aria::mbar_expect_tx(bar_kv, 2 * C::KV_BYTES);
    const uint32_t sk = base + C::K_OFF, sv = base + C::V_OFF;
    aria::tma_load(sk, &maps.k, bar_kv, 0, h, kt * KT, b);
    aria::tma_load(sv, &maps.v, bar_kv, 0, h, kt * KT, b);
    if constexpr (C::TAIL) {
      aria::tma_load(sk + C::KV_BOX, &maps.kt, bar_kv, 64, h, kt * KT, b);
      aria::tma_load(sv + C::KV_BOX, &maps.vt, bar_kv, 64, h, kt * KT, b);
    }
    for (int t = 0; t < min(STAGES, info[NSTEPS]); ++t)
      load_step<D>(maps, base, list, t, qrow, b, h);
  }
  int* const ctr = counters + (size_t)bh * nqt;
  if (threadIdx.x < 128)
    consume<D, 0>(maps, base, gbase, qrow, kv_valid, dq_acc, ctr, dq, dk, dv, b, h, bh, kt, nqt,
                  Sq, Sk, H, scale);
  else
    consume<D, 1>(maps, base, gbase, qrow, kv_valid, dq_acc, ctr, dq, dk, dv, b, h, bh, kt, nqt,
                  Sq, Sk, H, scale);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* kv_valid,
           const float4* qs, const int* qflags, void* dq_acc, void* counters, void* dq, void* dk,
           void* dv, int B, int Sq, int Sk, int H, float scale, cudaStream_t st) {
  using C = Cfg<D>;
  Maps m{};  // the tail maps stay zero at D = 64, where the kernel reads none
  if (!aria::bshd_map(&m.q, q, B, Sq, H, QT, D) || !aria::bshd_map(&m.d, dout, B, Sq, H, QT, D) ||
      !aria::bshd_map(&m.k, k, B, Sk, H, KT, D) || !aria::bshd_map(&m.v, v, B, Sk, H, KT, D))
    return (int)cudaErrorInvalidValue;
  if (C::TAIL && (!aria::bshd_map(&m.qt, q, B, Sq, H, QT, D, D - 64) ||
                  !aria::bshd_map(&m.dt, dout, B, Sq, H, QT, D, D - 64) ||
                  !aria::bshd_map(&m.kt, k, B, Sk, H, KT, D, D - 64) ||
                  !aria::bshd_map(&m.vt, v, B, Sk, H, KT, D, D - 64)))
    return (int)cudaErrorInvalidValue;
  const int nkt = (Sk + KT - 1) / KT, nqt = (Sq + QT - 1) / QT, bytes = C::bytes(nqt, nkt);
  cudaError_t err = aria::allow_smem(seg_bwd_kernel<D>, bytes);
  if (err != cudaSuccess) return (int)err;
  seg_bwd_kernel<D><<<B * H * nkt, THREADS, bytes, st>>>(
      m, qs, qflags, (const uint8_t*)kv_valid, (float*)dq_acc, (int*)counters,
      (__nv_bfloat16*)dq, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, Sq, Sk, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, do, dq [B, Sq, H, D], k, v, dk, dv [B, Sk, H, D] bf16 (D 64 or 72);
// stats f32 [2, B, H, Sq] (the forward's m, then l); q_valid [B, Sq],
// kv_valid [B, Sk] bool bytes or NULL. Scratch (Sqp = Sq rounded up to 64):
// qs f32 [B, H, Sqp, 4], qflags int32 [B, H, Sqp / 64], dq_acc f32
// [B, H, Sqp, D], counters int32 [B, H, Sqp / 64] zeroed by the caller.
ARIA_EXPORT int aria_flash_segment_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const void* stats,
                                       const void* q_valid, const void* kv_valid, void* qs,
                                       void* qflags, void* dq_acc, void* counters, void* dq,
                                       void* dk, void* dv, int B, int Sq, int Sk, int H, int D,
                                       float scale, void* stream) {
  if ((D != 64 && D != 72) || B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nqt = (Sq + QT - 1) / QT;
  seg_bwd_prep_kernel<<<B * H * nqt, 256, 0, st>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, (const float*)stats,
      (const uint8_t*)q_valid, (float4*)qs, (int*)qflags, B, Sq, H, D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float4* const qsf = (const float4*)qs;
  const int* const qf = (const int*)qflags;
  return D == 64 ? launch<64>(q, k, v, dout, kv_valid, qsf, qf, dq_acc, counters, dq, dk, dv, B,
                              Sq, Sk, H, scale, st)
                 : launch<72>(q, k, v, dout, kv_valid, qsf, qf, dq_acc, counters, dq, dk, dv, B,
                              Sq, Sk, H, scale, st);
}
