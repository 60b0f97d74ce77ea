// The ViT's attention: non-causal attention over q [B, Sq, H, D], k / v
// [B, Sk, H, D] bf16 (D 64 or 72) with a mask of valid positions, output
// [B, Sq, H, D] bf16, in two forms of one kernel body:
//
// - vit (aria_vit_flash; Sq = Sk): replaces aria_tpu/ops/vit_flash.py:91
//   vit_flash (`_kernel` :50, pallas_call :127), the ViT's attention over
//   the 4,900 patches of a 980px crop (H = 16, D = 72). q is scaled by
//   1/sqrt(D) in f32 and rounded to bf16 before the product; keys that are
//   not valid (kv_valid, NULL: all) get an additive -1e30 on the f32
//   scores; the output is acc / max(l, 1e-30). Rows of padding queries are
//   garbage by contract.
// - segment (aria_flash_segment): replaces the library Pallas TPU
//   `flash_attention` that aria_tpu/ops/flash.py:30 flash_sdpa calls with
//   `SegmentIds` and causal=False (flash.py:61-101), the ViT's attention
//   when the JAX package's ARIA_TPU_VIT_FLASH=0 turns vit_flash off. Its
//   numerics are the library's (flash_attention.py:395-472): the unscaled
//   bf16 q.k with f32 sums, then s *= scale in f32, then -0.7 * FLT_MAX
//   where the query's segment (q_valid: 1, padding 0) differs from the
//   key's, so pad queries attend pad keys only; keys past Sk get -inf; the
//   output is acc * (l == 0 ? 1 : 1 / l), divided once at the end where the
//   library rescales at every key block (the same value up to f32
//   rounding).
//
// Both: the online softmax in f32, p rounded to bf16 for p.v while l sums
// the f32 p. The exponentials are ex2.approx((s - m) * log2(e)) with
// subnormal results flushed to 0, which moves p by a few ulps against expf;
// s - m is taken first so that a row whose scores so far are all masked
// (all -1e30, or all -0.7 * FLT_MAX) gets p = 1 as with expf.
//
// Bound: operations, 4 * Sq * Sk * D FLOPs per (b, h): 110.6 GFLOP at [1,
// 4900, 16, 72], 0.1119 ms at the bf16 peak. At D = 72 each score also
// costs one exponential against ~290 FLOPs of (padded) products, and the
// card's exponential rate is ~1/250 of its bf16 rate, so exponentials and
// products take about as long: run one after the other, a block cannot go
// below ~2x the products' time. The design is FlashAttention-3's forward
// on Hopper's pieces (hopper.cuh):
//
// - A block takes one (b, h) and 128 query rows: two consumer warpgroups
//   of 64 rows and a producer warpgroup; the blocks of a head's query tiles
//   are next to each other (the heads of a tile next to each other measured
//   the same).
// - Producer: warp 0 brings Q once and the K tiles of 128 keys by TMA into
//   a ring of 2 stages and writes each key's additive mask beside the tile
//   (one float a key; two in the segment form, one for each query segment)
//   with a flag that is set when every key of the tile is valid; a
//   warpgroup whose rows are all valid (the segment form: of segment 1)
//   skips the mask on such tiles. Warp 1 brings the V tiles into their own
//   ring, so K's slot is refilled as soon as both warpgroups are past its
//   softmax and V's once its product is done. 4,900 = 38 * 128 + 36: the
//   last tile is partial, TMA zero-fills its rows and the mask cuts them.
// - D = 72 against the 128-byte swizzle: a swizzled box holds at most 64
//   bf16 along its row. Columns 0-63 of a tile are one such box; columns
//   64-71 are a tail box of 8 columns without swizzle (16-byte rows, the
//   core matrices of an unswizzled wgmma operand). A second 64-column
//   swizzled box, zero-filled past column 72, kept one descriptor form but
//   made the loads alone take 0.337 ms where the tail takes 0.196 (H100 at
//   700 W, [1, 4900, 16, 72]): TMA pays for the zero-filled bytes as for
//   loaded ones. S = Q K^T takes 4 k-steps
//   of 16 columns in the boxes and a fifth from the tails, its columns
//   72-79 read at LBO from 2 KB of zeros; O += P V is m64n64k16 on the box
//   (V MN-major through the transpose bit) and m64n8k16 on the tail.
// - Q stays in shared memory (S = Q K^T reads both operands there), which
//   keeps 20 registers a thread for the overlap below. The vit form scales
//   it in place: each consumer warpgroup rescales its 64 rows once (f32,
//   rounded to bf16: the bits the TPU kernel's q takes) before its first
//   product.
// - The exponentials overlap the products two ways. The warpgroups take
//   turns at the tensor cores (named barriers, FlashAttention-3's
//   ping-pong): one issues its products while the other runs its softmax.
//   And inside a warpgroup, tile j's S = Q K^T is issued together with
//   tile j - 1's O += P V, and tile j's softmax runs while that P V still
//   does: a consumer thread holds S (64 f32), P of the tile before (32
//   bf16 pairs) and O (36 f32), 168 registers and no spills.
//
// Rows past Sq are computed on zeros and not stored, so any Sq and Sk work.

#include <float.h>

#include "hopper.cuh"

namespace {

constexpr int KT = 128;         // keys per tile
constexpr int ROWS = 128;       // query rows per block: two consumer warpgroups of 64
constexpr int KSTAGES = 2;      // the K ring (and the masks'); 3 measured the same
constexpr int VSTAGES = 2;      // the V ring
constexpr int ROW_BYTES = 128;  // one swizzled row: 64 bf16
constexpr int TAIL_ROW = 16;    // one unswizzled tail row: 8 bf16
constexpr int THREADS = 384;    // the producer warpgroup and two consumers
constexpr int MASK_FLOATS = 2 * KT + 4;  // a stage's additive masks, then its all-valid flag
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASK_VALUE = -0.7f * FLT_MAX;  // the library's DEFAULT_MASK_VALUE

enum Form { VIT = 0, SEGMENT = 1 };

// a Q, K or V tile of `rows`: columns 0-63 in one box with the 128-byte
// swizzle, columns 64-71 (D = 72) in an unswizzled tail box after it
template <int D, int rows>
struct Tile {
  static constexpr bool TAIL = D > 64;
  static constexpr int BOX = rows * ROW_BYTES;
  static constexpr int BYTES = BOX + (TAIL ? rows * TAIL_ROW : 0);  // a multiple of 1024
};

template <int D>
struct Layout {
  using Q = Tile<D, ROWS>;
  using KV = Tile<D, KT>;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + Q::BYTES;
  static constexpr int V_OFF = K_OFF + KSTAGES * KV::BYTES;
  static constexpr int ZERO_OFF = V_OFF + VSTAGES * KV::BYTES;  // columns 72-79: zeros
  static constexpr int MASK_OFF = ZERO_OFF + KT * TAIL_ROW;
  static constexpr int BAR_OFF = MASK_OFF + KSTAGES * MASK_FLOATS * 4;
  // q, full_k[KSTAGES], empty_k[KSTAGES], full_v[VSTAGES], empty_v[VSTAGES]
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * KSTAGES + 2 * VSTAGES) + 1024;  // + slack
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return aria::sw128_desc(addr, lbo, 1024);
}

// named barriers of `n` threads; predicated rather than branched, so that
// no branch sits among products in flight
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive_if(int id, int n, bool pred) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n @p bar.arrive %0, %1;\n}\n"
               :: "r"(id), "r"(n), "r"((int)pred) : "memory");
}
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %1, 0;\n"
               " @p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
               :: "r"(bar), "r"((int)pred) : "memory");
}

// One tile's softmax on a consumer thread's fragment: rows ra (s[4n + e])
// and rb (s[4n + 2 + e]) at keys 8n + c2 + e. The scores become p in f32;
// m, l (this thread's part) and alpha, the factor O takes before the
// tile's P V, are updated.
template <int FORM>
__device__ __forceinline__ void softmax(float (&s)[64], const float* mask_a, const float* mask_b,
                                        bool masked, float scale, int c2, float& ma, float& mb,
                                        float& la, float& lb, float& alpha_a, float& alpha_b) {
  if constexpr (FORM == SEGMENT) {
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = __fmul_rn(s[i], scale);
  }
  if (masked) {
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const float2 a = *reinterpret_cast<const float2*>(mask_a + 8 * n + c2);
      const float2 b = *reinterpret_cast<const float2*>(mask_b + 8 * n + c2);
      s[4 * n] = __fadd_rn(s[4 * n], a.x);
      s[4 * n + 1] = __fadd_rn(s[4 * n + 1], a.y);
      s[4 * n + 2] = __fadd_rn(s[4 * n + 2], b.x);
      s[4 * n + 3] = __fadd_rn(s[4 * n + 3], b.y);
    }
  }
  float mxa = ma, mxb = mb;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    mxa = fmaxf(mxa, fmaxf(s[4 * n], s[4 * n + 1]));
    mxb = fmaxf(mxb, fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {  // the four threads of a row
    mxa = fmaxf(mxa, __shfl_xor_sync(aria::FULL_MASK, mxa, x));
    mxb = fmaxf(mxb, __shfl_xor_sync(aria::FULL_MASK, mxb, x));
  }
  alpha_a = ex2((ma - mxa) * LOG2E);  // 0 on the first tile of the segment form (m = -inf)
  alpha_b = ex2((mb - mxb) * LOG2E);
  ma = mxa;
  mb = mxb;
  float suma = 0.f, sumb = 0.f;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * n + e] = ex2((s[4 * n + e] - mxa) * LOG2E);
      s[4 * n + 2 + e] = ex2((s[4 * n + 2 + e] - mxb) * LOG2E);
      suma += s[4 * n + e];
      sumb += s[4 * n + 2 + e];
    }
  }
  la = la * alpha_a + suma;
  lb = lb * alpha_b + sumb;
}

// p as wgmma's A fragment: k-step t holds keys 16t..16t+15, the
// accumulator's column blocks 2t and 2t+1
__device__ __forceinline__ void pack_p(const float (&s)[64], uint32_t (&pa)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) pa[i] = aria::pack_bf16(s[2 * i], s[2 * i + 1]);
}

// the maps of q, k and v: columns 0-63 (swizzled boxes) and the tail
struct Maps {
  CUtensorMap q, k, v, qt, kt, vt;
};

template <int D, int FORM>
__global__ void __launch_bounds__(THREADS, 1)
vit_attention_kernel(const __grid_constant__ Maps maps, const uint8_t* __restrict__ q_valid,
                     const uint8_t* __restrict__ kv_valid, __nv_bfloat16* __restrict__ out,
                     int Sq, int Sk, int H, float scale) {
  using L = Layout<D>;
  using QT = typename L::Q;
  using KV = typename L::KV;
  constexpr bool TAIL = KV::TAIL;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = aria::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle needs 1024-byte alignment
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t sq = base + L::Q_OFF, sk = base + L::K_OFF, sv = base + L::V_OFF;
  const uint32_t zero = base + L::ZERO_OFF;
  float* const masks = reinterpret_cast<float*>(gbase + L::MASK_OFF);
  const uint32_t bar = base + L::BAR_OFF;
  const uint32_t bar_q = bar;
  auto bar_k = [&](int st) { return bar + 8 * (1 + st); };
  auto bar_ek = [&](int st) { return bar + 8 * (1 + KSTAGES + st); };
  auto bar_v = [&](int st) { return bar + 8 * (1 + 2 * KSTAGES + st); };
  auto bar_ev = [&](int st) { return bar + 8 * (1 + 2 * KSTAGES + VSTAGES + st); };

  const int tile = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = tile * ROWS;
  const int n_kt = (Sk + KT - 1) / KT;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    aria::mbar_init(bar_q, 1);
    for (int st = 0; st < KSTAGES; ++st) {
      aria::mbar_init(bar_k(st), 33);  // the loads' expected bytes and the producer warp's masks
      aria::mbar_init(bar_ek(st), 8);  // one arrival per consumer warp
    }
    for (int st = 0; st < VSTAGES; ++st) {
      aria::mbar_init(bar_v(st), 1);
      aria::mbar_init(bar_ev(st), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // 128 rows of q, k or v from row0 into the slot at dst: the swizzled box,
  // then the tail
  static_assert(QT::BYTES == KV::BYTES, "one tile size");
  auto load = [&](uint32_t dst, const CUtensorMap* map, const CUtensorMap* tail, uint32_t full,
                  int row0) {
    aria::mbar_expect_tx(full, KV::BYTES);
    aria::tma_load(dst, map, full, 0, h, row0, b);
    if constexpr (TAIL) aria::tma_load(dst + KV::BOX, tail, full, 64, h, row0, b);
  };

  if (wg == 0) {  // the producer: warp 0 brings Q, K and the masks, warp 1 V
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp == 1 && lane == 0) {
      for (int j = 0; j < n_kt; ++j) {
        const int st = j % VSTAGES;
        if (j >= VSTAGES) aria::mbar_wait(bar_ev(st), ((j / VSTAGES) - 1) & 1);
        load(sv + st * KV::BYTES, &maps.v, &maps.vt, bar_v(st), j * KT);
      }
    }
    if (warp != 0) return;
    if (lane == 0) load(sq, &maps.q, &maps.qt, bar_q, q0);
    const uint8_t* valid = kv_valid == nullptr ? nullptr : kv_valid + (size_t)b * Sk;
    for (int j = 0; j < n_kt; ++j) {
      const int st = j % KSTAGES;
      bool ok[4];  // this lane's four keys, read before the slot is free
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = j * KT + 4 * lane + i;
        ok[i] = key < Sk && (valid == nullptr || valid[key]);
      }
      if (j >= KSTAGES) aria::mbar_wait(bar_ek(st), ((j / KSTAGES) - 1) & 1);  // K, masks free
      if (lane == 0) load(sk + st * KV::BYTES, &maps.k, &maps.kt, bar_k(st), j * KT);
      float* m = masks + st * MASK_FLOATS;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 4 * lane + i;
        if constexpr (FORM == VIT) {
          m[c] = ok[i] ? 0.f : aria::NEG_INF;
        } else {  // m[c]: for a query of segment 0; m[KT + c]: of segment 1
          const bool past = j * KT + c >= Sk;
          m[c] = past ? -INFINITY : ok[i] ? MASK_VALUE : 0.f;
          m[KT + c] = past ? -INFINITY : ok[i] ? 0.f : MASK_VALUE;
        }
      }
      const bool all = __all_sync(aria::FULL_MASK, ok[0] && ok[1] && ok[2] && ok[3]);
      if (lane == 0) reinterpret_cast<int*>(m)[2 * KT] = all;
      aria::mbar_arrive(bar_k(st));
    }
    return;
  }

  // a consumer warpgroup: 64 query rows
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int ct = threadIdx.x % 128;
  const int ra = q0 + cw * 64 + warp * 16 + lane / 4, rb = ra + 8;  // this thread's two rows
  const int c2 = 2 * (lane % 4);  // its first column in each 8-column block
  int sega = 1, segb = 1;         // the rows' segments (the segment form)
  if (FORM == SEGMENT && q_valid != nullptr) {
    sega = ra < Sq && q_valid[(size_t)b * Sq + ra];
    segb = rb < Sq && q_valid[(size_t)b * Sq + rb];
  }
  const uint32_t qa = sq + cw * 64 * ROW_BYTES;            // this warpgroup's rows of Q
  const uint32_t qta = sq + QT::BOX + cw * 64 * TAIL_ROW;  // and of its tail

  if constexpr (TAIL)  // columns 72-79, zeros, that the last k-step of Q K^T reads
    reinterpret_cast<uint4*>(gbase + L::ZERO_OFF)[ct] = make_uint4(0, 0, 0, 0);
  aria::mbar_wait(bar_q, 0);
  if constexpr (FORM == VIT) {
    // q * 1/sqrt(D) in f32, rounded to bf16, in place: this warpgroup's 64
    // rows of the box and of the tail, 16 bytes at a time (the swizzle does
    // not matter to an elementwise pass)
    constexpr int CHUNKS = 64 * ROW_BYTES / 16;
    for (int i = ct; i < CHUNKS + (TAIL ? 64 : 0); i += 128) {
      uint4* p = reinterpret_cast<uint4*>(
          i < CHUNKS ? gbase + L::Q_OFF + cw * 64 * ROW_BYTES + i * 16
                     : gbase + L::Q_OFF + QT::BOX + (cw * 64 + i - CHUNKS) * TAIL_ROW);
      uint4 w = *p;
      w.x = aria::pack_bf16(aria::bf_lo(w.x) * scale, aria::bf_hi(w.x) * scale);
      w.y = aria::pack_bf16(aria::bf_lo(w.y) * scale, aria::bf_hi(w.y) * scale);
      w.z = aria::pack_bf16(aria::bf_lo(w.z) * scale, aria::bf_hi(w.z) * scale);
      w.w = aria::pack_bf16(aria::bf_lo(w.w) * scale, aria::bf_hi(w.w) * scale);
      *p = w;
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  bar_sync(3 + cw, 128);
  const int turn = 1 + cw, other = 2 - cw;  // the named barriers of the two turns
  bar_arrive_if(1, 256, cw == 1);  // warpgroup 0 takes the first turn

  const float m0 = FORM == VIT ? aria::NEG_INF : -INFINITY;
  float ma = m0, mb = m0, la = 0.f, lb = 0.f, alpha_a = 1.f, alpha_b = 1.f;
  float o[32], ot[4];  // O: columns 0-63, and 64-71 (D = 72)
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) ot[i] = 0.f;
  float s[64];
  uint32_t pa[32];

  auto qk = [&](int st) {  // S = Q K^T of the tile in stage st
    const uint32_t kb = sk + st * KV::BYTES;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 16 columns a step, 32 bytes into the box's rows
      aria::wgmma_ss<0, 0>(s, desc(qa + kk * 32, 16), desc(kb + kk * 32, 16), kk > 0);
    if constexpr (TAIL) {  // columns 64-71 from the tails, 72-79 from the zeros at LBO
      const uint32_t kt = kb + KV::BOX;
      aria::wgmma_ss<0, 0>(s, aria::plain_desc(qta, zero - qta, 128),
                           aria::plain_desc(kt, zero - kt, 128), 1);
    }
    aria::wgmma_commit();
  };
  auto pv = [&](int st) {  // O += P V of the tile in stage st, 16 keys a step
    const uint32_t vb = sv + st * KV::BYTES;
#pragma unroll
    for (int t = 0; t < KT / 16; ++t) {
      aria::wgmma_rs64<1>(o, pa + 4 * t, desc(vb + t * 16 * ROW_BYTES, KV::BOX));
      if constexpr (TAIL)  // the next 8 keys at LBO
        aria::wgmma_rs8<1>(ot, pa + 4 * t,
                           aria::plain_desc(vb + KV::BOX + t * 16 * TAIL_ROW, 128, 256));
    }
    aria::wgmma_commit();
  };
  auto soft = [&](int st) {
    const float* m = masks + st * MASK_FLOATS;
    const bool all_valid = reinterpret_cast<const int*>(m)[2 * KT] != 0;
    const bool masked = !(all_valid && sega && segb);
    const float* mask_a = FORM == SEGMENT ? m + sega * KT : m;
    const float* mask_b = FORM == SEGMENT ? m + segb * KT : m;
    softmax<FORM>(s, mask_a, mask_b, masked, scale, c2, ma, mb, la, lb, alpha_a, alpha_b);
  };
  auto rescale_o = [&]() {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[4 * n] *= alpha_a;
      o[4 * n + 1] *= alpha_a;
      o[4 * n + 2] *= alpha_b;
      o[4 * n + 3] *= alpha_b;
    }
    ot[0] *= alpha_a;
    ot[1] *= alpha_a;
    ot[2] *= alpha_b;
    ot[3] *= alpha_b;
    aria::fence_regs(o);
    aria::fence_regs(ot);
  };

  // tile 0: S, its softmax, P
  aria::mbar_wait(bar_k(0), 0);
  bar_sync(turn, 256);
  aria::wgmma_fence();
  qk(0);
  bar_arrive_if(other, 256, !(cw == 1 && n_kt == 1));
  aria::wgmma_wait<0>();
  aria::fence_regs(s);
  soft(0);
  mbar_arrive_if(bar_ek(0), lane == 0);
  pack_p(s, pa);

  for (int j = 1; j < n_kt; ++j) {
    const int st = j % KSTAGES, sp = (j - 1) % VSTAGES;
    aria::mbar_wait(bar_k(st), (j / KSTAGES) & 1);
    aria::mbar_wait(bar_v(sp), ((j - 1) / VSTAGES) & 1);
    rescale_o();
    bar_sync(turn, 256);  // this warpgroup's turn at the tensor cores
    aria::wgmma_fence();
    qk(st);  // tile j's S
    pv(sp);  // tile j - 1's O += P V
    bar_arrive_if(other, 256, !(cw == 1 && j == n_kt - 1));
    aria::wgmma_wait<1>();  // S is done; P V runs on through the softmax
    aria::fence_regs(s);
    soft(st);
    mbar_arrive_if(bar_ek(st), lane == 0);
    aria::wgmma_wait<0>();
    aria::fence_regs(o);
    aria::fence_regs(ot);
    mbar_arrive_if(bar_ev(sp), lane == 0);
    pack_p(s, pa);
  }

  // the last tile's P V
  const int sl = (n_kt - 1) % VSTAGES;
  aria::mbar_wait(bar_v(sl), ((n_kt - 1) / VSTAGES) & 1);
  rescale_o();
  aria::wgmma_fence();
  pv(sl);
  aria::wgmma_wait<0>();
  aria::fence_regs(o);
  aria::fence_regs(ot);

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    la += __shfl_xor_sync(aria::FULL_MASK, la, x);
    lb += __shfl_xor_sync(aria::FULL_MASK, lb, x);
  }
  float ia, ib;
  if constexpr (FORM == VIT) {
    ia = 1.f / fmaxf(la, 1e-30f);
    ib = 1.f / fmaxf(lb, 1e-30f);
  } else {  // the library's l_next_inv_safe
    ia = la == 0.f ? 1.f : 1.f / la;
    ib = lb == 0.f ? 1.f : 1.f / lb;
  }
  const size_t row_stride = (size_t)H * D;
  __nv_bfloat16* oa = out + ((size_t)b * Sq + ra) * row_stride + (size_t)h * D;
  __nv_bfloat16* ob = oa + 8 * row_stride;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = 8 * n + c2;
    const float* f = n < 8 ? o + 4 * n : ot;
    if (ra < Sq) *reinterpret_cast<uint32_t*>(oa + d) = aria::pack_bf16(f[0] * ia, f[1] * ia);
    if (rb < Sq) *reinterpret_cast<uint32_t*>(ob + d) = aria::pack_bf16(f[2] * ib, f[3] * ib);
  }
}

// ---- host side
template <int D, int FORM>
int launch(const void* q, const void* k, const void* v, const void* q_valid,
           const void* kv_valid, void* out, int B, int Sq, int Sk, int H, float scale,
           cudaStream_t stream) {
  using L = Layout<D>;
  Maps m{};  // the tail maps stay zero at D = 64, where the kernel reads none
  if (!aria::bshd_map(&m.q, q, B, Sq, H, ROWS, D) || !aria::bshd_map(&m.k, k, B, Sk, H, KT, D) ||
      !aria::bshd_map(&m.v, v, B, Sk, H, KT, D))
    return (int)cudaErrorInvalidValue;
  if (D > 64 && (!aria::bshd_map(&m.qt, q, B, Sq, H, ROWS, D, D - 64) ||
                  !aria::bshd_map(&m.kt, k, B, Sk, H, KT, D, D - 64) ||
                  !aria::bshd_map(&m.vt, v, B, Sk, H, KT, D, D - 64)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = aria::allow_smem(vit_attention_kernel<D, FORM>, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (Sq + ROWS - 1) / ROWS;
  vit_attention_kernel<D, FORM><<<dim3(n_qt, B * H), THREADS, L::BYTES, stream>>>(
      m, (const uint8_t*)q_valid, (const uint8_t*)kv_valid, (__nv_bfloat16*)out, Sq, Sk, H,
      scale);
  return (int)cudaGetLastError();
}

template <int FORM>
int dispatch(const void* q, const void* k, const void* v, const void* q_valid,
             const void* kv_valid, void* out, int B, int Sq, int Sk, int H, int D, float scale,
             void* stream) {
  if ((D != 64 && D != 72) || B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return D == 64 ? launch<64, FORM>(q, k, v, q_valid, kv_valid, out, B, Sq, Sk, H, scale, st)
                 : launch<72, FORM>(q, k, v, q_valid, kv_valid, out, B, Sq, Sk, H, scale, st);
}

}  // namespace

// the vit form: q, k, v, out [B, S, H, D]; kv_valid [B, S] bool bytes or NULL
ARIA_EXPORT int aria_vit_flash(const void* q, const void* k, const void* v, const void* kv_valid,
                               void* out, int B, int S, int H, int D, float scale,
                               void* stream) {
  return dispatch<VIT>(q, k, v, nullptr, kv_valid, out, B, S, S, H, D, scale, stream);
}

// the segment form: q, out [B, Sq, H, D], k, v [B, Sk, H, D]; q_valid [B, Sq]
// and kv_valid [B, Sk] bool bytes or NULL (every position valid)
ARIA_EXPORT int aria_flash_segment(const void* q, const void* k, const void* v,
                                   const void* q_valid, const void* kv_valid, void* out, int B,
                                   int Sq, int Sk, int H, int D, float scale, void* stream) {
  return dispatch<SEGMENT>(q, k, v, q_valid, kv_valid, out, B, Sq, Sk, H, D, scale, stream);
}
