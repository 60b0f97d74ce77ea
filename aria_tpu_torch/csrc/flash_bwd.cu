// flash_causal_bwd: the backward of causal attention over q/k/v
// [B, S, H, 128] bf16: dq, dk, dv (bf16) from the output o, its cotangent
// do (bf16) and the forward's row log-sum-exp lse [B, H, S] (f32).
//
// Replaces the causal backward of the library Pallas TPU flash attention
// that aria_tpu/ops/flash.py:30 flash_sdpa calls
// (jax/experimental/pallas/ops/tpu/flash_attention.py:254-300): the dkv
// kernel (:941, pallas_call :1121) and the dq kernel (:1287, pallas_call
// :1456). The arithmetic is the library's: di = rowsum(o * do) in f32;
// p = exp(s * scale - lse) in f32 with s = q.k, masked to 0 above the
// diagonal; dv += p^T do and dp = do v^T; ds = p * (dp - di) * scale;
// dk += ds^T q and dq += ds k. p and ds enter their products rounded to
// bf16, every product sums in f32, and dq, dk, dv are rounded once. The
// exponentials are 2^(s * scale * log2(e) - lse * log2(e)) on ex2.approx
// (with subnormal results flushed to 0), which moves p by a few ulps
// against expf.
//
// Bound: operations, 5 products of 2 * S^2/2 * 128 FLOPs per (b, h) after
// the causal half (s recomputed, dp, dv, dk, dq); at [1, 2048, 20, 128]
// 53.7 GFLOP, 0.0543 ms at the bf16 peak. The design is FlashAttention-3's
// backward on Hopper's pieces (hopper.cuh), one pass over the key tiles:
//
// - A block takes one (b, h) and a tile of 128 keys: two warpgroups of 64
//   keys each, and no producer warp. A consumer thread holds dK, dV, S^T
//   and dP^T, 192 registers, and an SM's four sub-partitions hold 16,384
//   registers each: 8 warps may take 255 registers a thread, a ninth (a
//   producer warp: 3 warps on one sub-partition) caps them at 168, and a
//   producer warpgroup with setmaxnreg 24/240 still compiled to spills and
//   serialised wgmmas (ptxas C7512). So thread 0 also starts the loads: K
//   and V once (TMA, two boxes of 64 columns each with the 128-byte
//   swizzle), and Q and dO in tiles of 64 queries with their lse * log2(e)
//   and di rows (bulk copies) through a 3-stage ring with a full mbarrier a
//   stage, each refilled after the two warpgroups' barrier of the step
//   after the one that read it, two steps ahead of its use. The walk runs
//   from the last query tile down to the diagonal.
// - Per query tile, 5 products on wgmma: S^T = K Q^T and dP^T = V dO^T
//   (m64n64k16, both operands K-major from shared memory); P^T and dS^T on
//   the accumulators, masked on the diagonal tiles and at S only; dV +=
//   P^T dO and dK += dS^T Q (m64n128k16, A as bf16 from registers, B
//   MN-major through the transpose bit); dQ = dS K, with dS^T staged to
//   shared memory as bf16 (two buffers, a named barrier between the two
//   warpgroups) and both operands read through the transpose bits, each
//   warpgroup taking 64 of dQ's 128 columns (m64n64k16).
// - dq. Each key tile's dQ of a query tile is added into an f32 scratch
//   (S' = S rounded up to 64 rows: each warpgroup's 64 x 64 quarter of a
//   query tile is 16 KB in a row, its 16-byte chunks swizzled) in key-tile
//   order, so dq's bits repeat from run to run. A warpgroup stages its part
//   in shared memory at the end of a step; in the next, while the tensor
//   cores run S^T and dP^T, one of its threads waits until a counter per
//   (b, h, query tile) reads 2 j, the two warpgroups of each key tile
//   before (acquire), and adds the part with a bulk reduce-add (key tile 0:
//   a bulk store); once the copy is complete, after that step's dQ product
//   is issued, it adds one to the counter (release). The last key tile of
//   a query tile, the diagonal one, adds the scratch to its own part and
//   writes dq in bf16, so no pass after the kernel is needed.
// - Launch order. Key tile j waits only for key tiles 0..j-1 of its (b, h),
//   which come earlier in the launch order (blocks are dispatched in order
//   of their index), so a waiting block never holds an SM that an earlier
//   tile needs. The order runs over groups of about BH_GROUP heads (one
//   group of all the heads below 24) and, inside a group, key tile by key
//   tile, tile 0 (the most query tiles) first: the scratch of a group's
//   heads stays in L2. Walking the query tiles from the top down, a head's
//   key tiles reach each query tile in the order they add to it.
// - di and lse * log2(e) come from a small kernel first, one warp per row,
//   into [B, H, S'] rows padded with zeros. Rows past S load as zeros (TMA)
//   and are masked and not stored, so any S works.

#include "hopper.cuh"

namespace {

constexpr int D = 128;                       // head dim
constexpr int KT = 128;                      // keys per block: two warpgroups of 64
constexpr int QT = 64;                       // queries per step
constexpr int STAGES = 3;                    // the Q / dO ring
constexpr int ROW_BYTES = 128;               // one swizzled row: 64 bf16
constexpr int KV_BOX = KT * ROW_BYTES;       // 128 keys x 64 d: 16 KB
constexpr int KV_BYTES = 2 * KV_BOX;         // a K or V tile
constexpr int Q_BOX = QT * ROW_BYTES;        // 64 queries x 64 d: 8 KB
constexpr int Q_BYTES = 2 * Q_BOX;           // a Q or dO tile
constexpr int DS_BYTES = KT * ROW_BYTES;     // dS^T: 128 keys x 64 queries bf16
constexpr int STAT_BYTES = QT * 4;           // a query tile's lse * log2(e) or di
// shared memory from a 1024-byte aligned base (the swizzle's alignment)
constexpr int K_OFF = 0;
constexpr int V_OFF = K_OFF + KV_BYTES;
constexpr int Q_OFF = V_OFF + KV_BYTES;
constexpr int DO_OFF = Q_OFF + STAGES * Q_BYTES;
constexpr int DS_OFF = DO_OFF + STAGES * Q_BYTES;   // two buffers
constexpr int DQ_BYTES = 64 * 64 * 4;        // a warpgroup's dQ part: 64 queries x 64 d f32
constexpr int DQ_OFF = DS_OFF + 2 * DS_BYTES;       // one buffer a warpgroup
constexpr int ST_OFF = DQ_OFF + 2 * DQ_BYTES;       // per stage: lse * log2(e), then di
constexpr int BAR_OFF = ST_OFF + STAGES * 2 * STAT_BYTES;
// kv, full[STAGES]
constexpr int SMEM = BAR_OFF + 8 * (1 + STAGES) + 1024;
constexpr int THREADS = 256;                 // two warpgroups
constexpr int BH_GROUP = 16;                 // about this many heads a group in the launch order
constexpr float LOG2E = 1.4426950408889634f;

// di[b, h, s] = sum_d o[b, s, h, d] * do[b, s, h, d] and lse2[b, h, s] =
// lse[b, h, s] * log2(e), both [B, H, Sp] with zeros at s >= S; one warp
// per row
__global__ void __launch_bounds__(256)
flash_bwd_di_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ lse2,
                    float* __restrict__ di, int B, int S, int Sp, int H) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= B * Sp * H) return;  // warp-uniform
  const int h = row % H, s = (row / H) % Sp, b = row / (H * Sp);
  float v = 0.f, l = 0.f;
  if (s < S) {  // warp-uniform
    const size_t src = ((size_t)b * S + s) * H + h;
    const uint2 ow = reinterpret_cast<const uint2*>(o + src * D)[lane];
    const uint2 dw = reinterpret_cast<const uint2*>(dout + src * D)[lane];
    v = aria::bf_lo(ow.x) * aria::bf_lo(dw.x) + aria::bf_hi(ow.x) * aria::bf_hi(dw.x) +
        aria::bf_lo(ow.y) * aria::bf_lo(dw.y) + aria::bf_hi(ow.y) * aria::bf_hi(dw.y);
    v = aria::warp_sum(v);
    l = lse[((size_t)b * H + h) * S + s] * LOG2E;
  }
  if (lane == 0) {
    const size_t dst = ((size_t)b * H + h) * Sp + s;
    di[dst] = v;
    lse2[dst] = l;
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return aria::sw128_desc(addr, lbo, 1024);
}

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap,
                 const float* __restrict__ lse2, const float* __restrict__ di,
                 float* __restrict__ dq_acc, int* __restrict__ counters,
                 __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int B, int S, int H, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (aria::smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - aria::smem_u32(smem_raw));  // the same, generic
  const uint32_t sk = base + K_OFF, sv = base + V_OFF, bar = base + BAR_OFF;
  const uint32_t bar_kv = bar;
  auto bar_f = [&](int st) { return bar + 8 * (1 + st); };

  // this block's (b, h) and key tile (the launch order above)
  const int nkt = (S + KT - 1) / KT, nqt = (S + QT - 1) / QT, Sp = nqt * QT;
  const int BH = B * H, ngroups = max(1, (BH + BH_GROUP / 2) / BH_GROUP);
  const int G = (BH + ngroups - 1) / ngroups, group = blockIdx.x / (G * nkt);
  const int gsize = min(G, BH - group * G);
  const int r = blockIdx.x - group * G * nkt;
  const int kt = r / gsize, bh = group * G + r % gsize, b = bh / H, h = bh % H;
  const int key0 = kt * KT;
  const int nsteps = nqt - 2 * kt;  // query tiles nqt - 1 down to 2 kt

  const float* const l2 = lse2 + (size_t)bh * Sp;
  const float* const d2 = di + (size_t)bh * Sp;
  // thread 0's loads of step t's query tile into stage t % STAGES
  auto load_step = [&](int t) {
    const int st = t % STAGES, q0 = (nqt - 1 - t) * QT;
    const uint32_t sq = base + Q_OFF + st * Q_BYTES, sd = base + DO_OFF + st * Q_BYTES;
    const uint32_t ss = base + ST_OFF + st * 2 * STAT_BYTES;
    aria::mbar_expect_tx(bar_f(st), 2 * Q_BYTES + 2 * STAT_BYTES);
    for (int c = 0; c < 2; ++c) {
      aria::tma_load(sq + c * Q_BOX, &qmap, bar_f(st), 64 * c, h, q0, b);
      aria::tma_load(sd + c * Q_BOX, &dmap, bar_f(st), 64 * c, h, q0, b);
    }
    aria::bulk_load(ss, l2 + q0, STAT_BYTES, bar_f(st));
    aria::bulk_load(ss + STAT_BYTES, d2 + q0, STAT_BYTES, bar_f(st));
  };
  if (threadIdx.x == 0) {
    aria::mbar_init(bar_kv, 1);
    for (int st = 0; st < STAGES; ++st) aria::mbar_init(bar_f(st), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    aria::mbar_expect_tx(bar_kv, 2 * KV_BYTES);
    for (int c = 0; c < 2; ++c) {
      aria::tma_load(sk + c * KV_BOX, &kmap, bar_kv, 64 * c, h, key0, b);
      aria::tma_load(sv + c * KV_BOX, &vmap, bar_kv, 64 * c, h, key0, b);
    }
    for (int t = 0; t < min(STAGES, nsteps); ++t) load_step(t);
  }
  __syncthreads();

  // a consumer warpgroup: keys key0 + cw * 64 .. + 64
  const int cw = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int rw = warp * 16 + lane / 4;       // this thread's first fragment row (and rw + 8)
  const int c2 = 2 * (lane % 4);             // its first column in each 8-column block
  const int ka = key0 + cw * 64 + rw, kb = ka + 8;  // its two keys
  const float sl = scale * LOG2E;
  int* const ctr = counters + (size_t)bh * nqt;

  float dkr[64], dvr[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dkr[i] = dvr[i] = 0.f;
  int staged = -1;   // the query tile whose dQ part waits in shared memory
  int pending = -1;  // the query tile whose bulk add is in flight, not yet counted

  aria::mbar_wait(bar_kv, 0);
  uint32_t kb_s = sk, vb_s = sv;
  for (int t = 0; t < nsteps; ++t) {
    // K's and V's descriptors are made where they are used, not kept in
    // registers across the loop
    asm volatile("" : "+r"(kb_s), "+r"(vb_s));
    const int st = t % STAGES, qt = nqt - 1 - t, q0 = qt * QT;
    const uint32_t sq = base + Q_OFF + st * Q_BYTES, sd = base + DO_OFF + st * Q_BYTES;
    const uint32_t sds = base + DS_OFF + (t & 1) * DS_BYTES;
    const float* const lrow = reinterpret_cast<const float*>(gbase + ST_OFF + st * 2 * STAT_BYTES);
    const float* const drow = lrow + QT;
    aria::mbar_wait(bar_f(st), (t / STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries, 8 k-steps over d
    float s[32], dp[32];
    aria::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {  // 16 columns into a box's 64 a k-step
      const uint32_t a = (kk / 4) * KV_BOX + cw * 64 * ROW_BYTES + (kk % 4) * 32;
      const uint32_t q = (kk / 4) * Q_BOX + (kk % 4) * 32;
      aria::wgmma_ss64<0, 0>(s, desc(kb_s + a, 16), desc(sq + q, 16), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a = (kk / 4) * KV_BOX + cw * 64 * ROW_BYTES + (kk % 4) * 32;
      const uint32_t q = (kk / 4) * Q_BOX + (kk % 4) * 32;
      aria::wgmma_ss64<0, 0>(dp, desc(vb_s + a, 16), desc(sd + q, 16), kk > 0);
    }
    aria::wgmma_commit();
    if (staged >= 0) {  // the last step's dQ part, added in key-tile order
      asm volatile("bar.sync %0, 128;\n" :: "r"(2 + cw) : "memory");  // it is staged
      if (threadIdx.x % 128 == 0) {
        float* const part = dq_acc + ((size_t)(bh * nqt + staged) * 2 + cw) * (DQ_BYTES / 4);
        const uint32_t src = base + DQ_OFF + cw * DQ_BYTES;
        if (kt == 0) {
          asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                       :: "l"(part), "r"(src), "r"(DQ_BYTES) : "memory");
        } else {
          aria::wait_count(ctr + staged, 2 * kt);
          asm volatile(
              "fence.proxy.async.global;\n"
              " cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
              :: "l"(part), "r"(src), "r"(DQ_BYTES) : "memory");
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
      pending = staged;
      staged = -1;
    }
    aria::wgmma_wait<0>();
    aria::fence_regs(s);
    aria::fence_regs(dp);

    // P^T and dS^T, packed to bf16 as wgmma's A fragments as they are made:
    // k-step u holds queries 16u..16u+15, the accumulator's column blocks
    // 2u and 2u+1; masked on the diagonal tiles and at S only
    const bool edge = q0 < key0 + KT || q0 + QT > S;
    uint32_t pa[16], sa[16];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int qc = 8 * n + c2;  // the thread's first query column in block n
      const float2 l2 = *reinterpret_cast<const float2*>(lrow + qc);
      const float2 d2 = *reinterpret_cast<const float2*>(drow + qc);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lv = (e & 1) ? l2.y : l2.x, dd = (e & 1) ? d2.y : d2.x;
        float pv = ex2(fmaf(s[4 * n + e], sl, -lv));
        if (edge) {
          const int key = (e & 2) ? kb : ka, qi = q0 + qc + (e & 1);
          if (key > qi || qi >= S) pv = 0.f;
        }
        p[e] = pv;
        ds[e] = pv * (dp[4 * n + e] - dd) * scale;
      }
      pa[2 * n] = aria::pack_bf16(p[0], p[1]);
      pa[2 * n + 1] = aria::pack_bf16(p[2], p[3]);
      sa[2 * n] = aria::pack_bf16(ds[0], ds[1]);
      sa[2 * n + 1] = aria::pack_bf16(ds[2], ds[3]);
    }
    // dS^T into this step's buffer: row = key (one swizzled 128-byte row
    // of 64 queries), the 16-byte chunk n at n ^ (row % 8)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = cw * 64 + rw + 8 * hr;
        asm volatile("st.shared.u32 [%0], %1;\n"
                     :: "r"(sds + row * ROW_BYTES + ((n ^ (row & 7)) << 4) + c2 * 2),
                        "r"(sa[2 * n + hr]) : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma

    // dV += P^T dO and dK += dS^T Q: 16 queries a k-step, d's second 64
    // columns at LBO
    aria::wgmma_fence();
#pragma unroll
    for (int u = 0; u < QT / 16; ++u)
      aria::wgmma_rs<1>(dvr, pa + 4 * u, desc(sd + u * 16 * ROW_BYTES, Q_BOX));
#pragma unroll
    for (int u = 0; u < QT / 16; ++u)
      aria::wgmma_rs<1>(dkr, sa + 4 * u, desc(sq + u * 16 * ROW_BYTES, Q_BOX));
    aria::wgmma_commit();

    // this step's bulk add has read its staging buffer, and both warpgroups'
    // dS^T are in; dQ[:, cw * 64 .. + 64] = dS K: A is dS^T (MN-major), B
    // this warpgroup's box of K (MN-major), 16 keys a k-step
    if (threadIdx.x % 128 == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    float dqr[32];
    aria::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      aria::wgmma_ss64<1, 1>(dqr, desc(sds + kk * 16 * ROW_BYTES, DS_BYTES),
                             desc(kb_s + cw * KV_BOX + kk * 16 * ROW_BYTES, KV_BOX), kk > 0);
    aria::wgmma_commit();
    if (threadIdx.x % 128 == 0 && pending >= 0) aria::release_count(ctr + pending);
    pending = -1;
    // both warpgroups are past step t - 1: its stage takes step t - 1 + STAGES
    if (threadIdx.x == 0 && t > 0 && t - 1 + STAGES < nsteps) load_step(t - 1 + STAGES);
    aria::wgmma_wait<0>();
    aria::fence_regs(dvr);
    aria::fence_regs(dkr);
    aria::fence_regs(dqr);

    // this key tile's part of dq for the query tile, after key tiles 0..kt-1
    if (qt > 2 * kt + 1) {  // not the last key tile here: staged for a bulk add
      float* const stage = reinterpret_cast<float*>(gbase + DQ_OFF + cw * DQ_BYTES);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<float2*>(stage + aria::dq_at(rw + 8 * hr, 8 * n + c2)) =
              make_float2(dqr[4 * n + 2 * hr], dqr[4 * n + 2 * hr + 1]);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to the copy
      staged = qt;
    } else {  // the diagonal key tile is the last: the scratch plus its part, as bf16
      const float* const part = dq_acc + ((size_t)(bh * nqt + qt) * 2 + cw) * (DQ_BYTES / 4);
      if (kt > 0) {
        aria::wait_count(ctr + qt, 2 * kt);
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = rw + 8 * hr, qi = q0 + row;
        __nv_bfloat16* const o = dq + (((size_t)b * S + qi) * H + h) * D + cw * 64 + c2;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 a = kt > 0 ? __ldcg(reinterpret_cast<const float2*>(
                                        part + aria::dq_at(row, 8 * n + c2)))
                                  : make_float2(0.f, 0.f);
          if (qi < S)
            *reinterpret_cast<uint32_t*>(o + 8 * n) =
                aria::pack_bf16(a.x + dqr[4 * n + 2 * hr], a.y + dqr[4 * n + 2 * hr + 1]);
        }
      }
    }
  }

  // dK and dV rows of this thread's two keys
  const size_t row_stride = (size_t)H * D;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = hr ? kb : ka;
    if (key >= S) continue;
    const size_t at = ((size_t)b * S + key) * row_stride + (size_t)h * D + c2;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * n) =
          aria::pack_bf16(dkr[4 * n + 2 * hr], dkr[4 * n + 2 * hr + 1]);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * n) =
          aria::pack_bf16(dvr[4 * n + 2 * hr], dvr[4 * n + 2 * hr + 1]);
    }
  }
}

}  // namespace

// q, k, v, o, do, dq, dk, dv: bf16 [B, S, H, 128]; lse: f32 [B, H, S] from
// the forward. Scratch (Sp = S rounded up to 64): ws f32 [2, B, H, Sp] (lse
// * log2(e), then di), dq_acc f32 [B, H, Sp, 128], counters int32
// [B, H, Sp / 64] zeroed by the caller.
ARIA_EXPORT int aria_flash_causal_bwd(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const void* lse, void* ws, void* dq_acc,
                                      void* counters, void* dq, void* dk, void* dv, int B, int S,
                                      int H, float scale, void* stream) {
  if (S <= 0 || B <= 0 || H <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int Sp = (S + QT - 1) / QT * QT, rows = B * Sp * H;
  float* const lse2 = (float*)ws;
  float* const di = lse2 + (size_t)B * H * Sp;
  flash_bwd_di_kernel<<<(rows + 7) / 8, 256, 0, st>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, (const float*)lse, lse2, di, B, S, Sp,
      H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap qm, km, vm, dm;
  if (!aria::bshd_map(&qm, q, B, S, H, QT) || !aria::bshd_map(&km, k, B, S, H, KT) ||
      !aria::bshd_map(&vm, v, B, S, H, KT) || !aria::bshd_map(&dm, dout, B, S, H, QT))
    return (int)cudaErrorInvalidValue;
  if ((err = aria::allow_smem(flash_bwd_kernel, SMEM)) != cudaSuccess) return (int)err;
  const int blocks = B * H * ((S + KT - 1) / KT);
  flash_bwd_kernel<<<blocks, THREADS, SMEM, st>>>(
      qm, km, vm, dm, lse2, di, (float*)dq_acc, (int*)counters, (__nv_bfloat16*)dq,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, B, S, H, scale);
  return (int)cudaGetLastError();
}
