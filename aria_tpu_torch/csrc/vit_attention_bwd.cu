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
// peak. This first design is the library's own split, simple and
// deterministic, on warp-level tensor-core products (mma.sync m16n8k16,
// operands from shared memory by ldmatrix):
//
// - Three launches. A prep kernel packs each query row's (m, 1 / l, di,
//   segment) into a float4 (one warp a row; rows past Sq get segment -1,
//   which no key has, and 1 / l = 0, so they add nothing). The dkv kernel
//   takes a block of 64 keys of one (b, h) and walks every tile of 64
//   queries, keeping dk and dv in registers; the dq kernel takes 64
//   queries and walks every key tile. Neither adds across blocks, so the
//   bits repeat from run to run; s and dp are computed in both (7 products
//   where one pass takes 5).
// - A block is 4 warps, each owning 16 of its rows. The walked tiles come
//   through a 2-stage cp.async ring in shared memory, a row padded to D
//   rounded up to 16 (zeros: the k-steps of s and dp over d read them) plus
//   8 columns, so the 8 rows an ldmatrix reads fall on distinct banks. At
//   D = 72 a product over d takes 5 k-steps (columns 72-79 zero), one with
//   d as its output 9 n-tiles of 8.
// - p and ds stay in registers: the accumulator fragments of two n-tiles
//   are the A fragment of the next product's k-step (dv, dk over queries,
//   dq over keys).
//
// Rows past Sq or Sk load as zeros and are not stored, so any Sq and Sk
// work.

#include <float.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int ROWS = 64;     // a block's own rows: 4 warps of 16
constexpr int COLS = 64;     // rows of a walked tile
constexpr int THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASK_VALUE = -0.7f * FLT_MAX;  // the library's DEFAULT_MASK_VALUE

template <int D>
struct Dims {
  static constexpr int DP = (D + 15) / 16 * 16;  // d in whole k-steps, zeros past D
  static constexpr int STRIDE = DP + 8;          // a row in shared memory (elements)
  static constexpr int KS = DP / 16;             // k-steps over d
  static constexpr int NT = D / 8;               // n-tiles over d
  static constexpr int CHUNKS = D / 8;           // 16-byte chunks of a row in memory
  static constexpr int TILE = ROWS * STRIDE;     // elements of one tile (COLS == ROWS)
  // four tiles of rows (the block's two, the ring's two stages of two),
  // then two stages of 64 floats4 (the dkv kernel's query statistics, the
  // dq kernel's key segments)
  static constexpr int SMEM = 6 * TILE * 2 + 2 * COLS * 16;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ldmatrix: four (or two) 8 x 8 bf16 matrices, one row address a thread
__device__ __forceinline__ void ldsm4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm4t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm2t(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

// Byte offsets of this lane's ldmatrix row in a tile of STRIDE-element rows.
// A (16 x 16 at row r0, column c0, row-major) and B from [K][N] storage
// with .trans (k0 = r0, n0 = c0: two n-tiles): rows r0 + lane % 16, column
// c0 + 8 (lane / 16).
template <int D>
__device__ __forceinline__ uint32_t a_off(int r0, int c0, int lane) {
  return ((r0 + (lane & 15)) * Dims<D>::STRIDE + c0 + ((lane >> 4) << 3)) * 2;
}
// B from [N][K] storage (n0, k0: two n-tiles of 8): row n0 + lane % 8 + 8
// (lane / 16), column k0 + 8 ((lane / 8) % 2)
template <int D>
__device__ __forceinline__ uint32_t b_off(int n0, int k0, int lane) {
  const int row = n0 + (lane & 7) + ((lane >> 4) << 3);
  return (row * Dims<D>::STRIDE + k0 + (((lane >> 3) & 1) << 3)) * 2;
}

// rows row0 .. row0 + 63 of one head of x [B, S, H, D] into a tile: cp.async
// for rows inside S, zeros past it
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int b,
                                          int h, int row0, int S, int H) {
  using T = Dims<D>;
  for (int i = threadIdx.x; i < ROWS * T::CHUNKS; i += THREADS) {
    const int r = i / T::CHUNKS, c = i % T::CHUNKS, row = row0 + r;
    __nv_bfloat16* const d = dst + r * T::STRIDE + 8 * c;
    if (row < S)
      aria::cp_async16(d, src + (((size_t)b * S + row) * H + h) * D + 8 * c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// columns D .. DP - 1 of every row of the six tiles: zeros, never written again
template <int D>
__device__ __forceinline__ void zero_pad(__nv_bfloat16* tiles) {
  using T = Dims<D>;
  if constexpr (T::DP > D) {
    static_assert(T::DP - D == 8, "one 16-byte chunk of padding");
    for (int r = threadIdx.x; r < 6 * ROWS; r += THREADS)
      *reinterpret_cast<uint4*>(tiles + r * T::STRIDE + D) = make_uint4(0, 0, 0, 0);
  }
}

// the additive mask of a (query, key) pair: the key's segment -2 past Sk,
// the query's -1 past Sq
__device__ __forceinline__ float mask_add(int qseg, int kseg) {
  return kseg < 0 ? -INFINITY : qseg != kseg ? MASK_VALUE : 0.f;
}

// one score's p and ds from its q.k, its dp and the query's statistics
__device__ __forceinline__ void p_ds(float& s, float& dp, const float4& st, int kseg,
                                     float scale) {
  const float x = __fadd_rn(__fmul_rn(s, scale), mask_add((int)st.w, kseg));
  const float p = __fmul_rn(ex2(__fmul_rn(x - st.x, LOG2E)), st.y);
  dp = __fmul_rn(__fmul_rn(dp - st.z, p), scale);
  s = p;
}

// (m, 1 / l, di, segment) of each query row, [B, H, Sqp]; one warp a row
__global__ void __launch_bounds__(256)
seg_bwd_prep_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ stats, const uint8_t* __restrict__ q_valid,
                    float4* __restrict__ qs, int B, int Sq, int Sqp, int H, int D) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= B * H * Sqp) return;  // warp-uniform
  const int s = row % Sqp, bh = row / Sqp, b = bh / H, h = bh % H;
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
    r = make_float4(stats[st], 1.f / stats[(size_t)B * H * Sq + st], v,
                    q_valid == nullptr ? 1.f : (float)q_valid[(size_t)b * Sq + s]);
  }
  if (lane == 0) qs[row] = r;
}

// dk, dv of 64 keys: walks the query tiles
template <int D>
__global__ void __launch_bounds__(THREADS)
seg_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                   const float4* __restrict__ qs, const uint8_t* __restrict__ kv_valid,
                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq,
                   int Sk, int Sqp, int H, float scale) {
  using T = Dims<D>;
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* const sk = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const sv = sk + T::TILE;
  __nv_bfloat16* const sq = sv + T::TILE;      // [2] the walked query tiles
  __nv_bfloat16* const sd = sq + 2 * T::TILE;  // [2] their cotangents
  float4* const sst = reinterpret_cast<float4*>(sd + 2 * T::TILE);  // [2][COLS]
  const int bh = blockIdx.y, b = bh / H, h = bh % H, key0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;
  const int nq = Sqp / COLS;
  const float4* const qrow = qs + (size_t)bh * Sqp;

  zero_pad<D>(sk);
  load_rows<D>(sk, k, b, h, key0, Sk, H);
  load_rows<D>(sv, v, b, h, key0, Sk, H);
  auto load_stage = [&](int t) {
    const int st = t & 1;
    load_rows<D>(sq + st * T::TILE, q, b, h, t * COLS, Sq, H);
    load_rows<D>(sd + st * T::TILE, dout, b, h, t * COLS, Sq, H);
    if (threadIdx.x < COLS)
      aria::cp_async16(sst + st * COLS + threadIdx.x, qrow + t * COLS + threadIdx.x);
  };
  load_stage(0);
  aria::cp_async_commit();

  auto kseg_of = [&](int key) {
    return key >= Sk ? -2 : kv_valid == nullptr ? 1 : (int)kv_valid[(size_t)b * Sk + key];
  };
  const int sega = kseg_of(key0 + r0 + g), segb = kseg_of(key0 + r0 + g + 8);
  const uint32_t ska = aria::smem_u32(sk), sva = aria::smem_u32(sv);

  float dka[T::NT][4], dva[T::NT][4];
#pragma unroll
  for (int n = 0; n < T::NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int t = 0; t < nq; ++t) {
    if (t + 1 < nq) {
      load_stage(t + 1);
      aria::cp_async_commit();
      aria::cp_async_wait<1>();
    } else {
      aria::cp_async_wait<0>();
    }
    __syncthreads();
    const int st = t & 1;
    const uint32_t sqa = aria::smem_u32(sq + st * T::TILE), sda = aria::smem_u32(sd + st * T::TILE);
    const float4* const qst = sst + st * COLS;

    // s^T = K Q^T and dp^T = V dO^T: this warp's 16 keys x 64 queries
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < T::KS; ++kk) {
      uint32_t ak[4], av[4];
      ldsm4(ska + a_off<D>(r0, 16 * kk, lane), ak);
      ldsm4(sva + a_off<D>(r0, 16 * kk, lane), av);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bq[4], bd[4];
        ldsm4(sqa + b_off<D>(16 * j, 16 * kk, lane), bq);
        ldsm4(sda + b_off<D>(16 * j, 16 * kk, lane), bd);
        aria::mma_bf16(s[2 * j], ak, bq[0], bq[1]);
        aria::mma_bf16(s[2 * j + 1], ak, bq[2], bq[3]);
        aria::mma_bf16(dp[2 * j], av, bd[0], bd[1]);
        aria::mma_bf16(dp[2 * j + 1], av, bd[2], bd[3]);
      }
    }
    // p^T and ds^T, then as A fragments: k-step u holds queries 16u .. 16u + 15
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 q0v = qst[8 * j + 2 * t4], q1v = qst[8 * j + 2 * t4 + 1];
      p_ds(s[j][0], dp[j][0], q0v, sega, scale);
      p_ds(s[j][1], dp[j][1], q1v, sega, scale);
      p_ds(s[j][2], dp[j][2], q0v, segb, scale);
      p_ds(s[j][3], dp[j][3], q1v, segb, scale);
      const int u = j >> 1, hf = (j & 1) << 1;
      pa[u][hf] = aria::pack_bf16(s[j][0], s[j][1]);
      pa[u][hf + 1] = aria::pack_bf16(s[j][2], s[j][3]);
      sa[u][hf] = aria::pack_bf16(dp[j][0], dp[j][1]);
      sa[u][hf + 1] = aria::pack_bf16(dp[j][2], dp[j][3]);
    }
    // dV += P^T dO and dK += dS^T Q: B from [query][d] storage through .trans
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int jp = 0; jp < T::NT / 2; ++jp) {
        uint32_t bd[4], bq[4];
        ldsm4t(sda + a_off<D>(16 * u, 16 * jp, lane), bd);
        ldsm4t(sqa + a_off<D>(16 * u, 16 * jp, lane), bq);
        aria::mma_bf16(dva[2 * jp], pa[u], bd[0], bd[1]);
        aria::mma_bf16(dva[2 * jp + 1], pa[u], bd[2], bd[3]);
        aria::mma_bf16(dka[2 * jp], sa[u], bq[0], bq[1]);
        aria::mma_bf16(dka[2 * jp + 1], sa[u], bq[2], bq[3]);
      }
      if constexpr (T::NT % 2) {  // d's last 8 columns
        uint32_t bd[2], bq[2];
        ldsm2t(sda + a_off<D>(16 * u, 8 * (T::NT - 1), lane), bd);
        ldsm2t(sqa + a_off<D>(16 * u, 8 * (T::NT - 1), lane), bq);
        aria::mma_bf16(dva[T::NT - 1], pa[u], bd[0], bd[1]);
        aria::mma_bf16(dka[T::NT - 1], sa[u], bq[0], bq[1]);
      }
    }
    __syncthreads();  // the stage is free for the tile after next
  }

  const size_t row_stride = (size_t)H * D;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = key0 + r0 + g + 8 * hr;
    if (key >= Sk) continue;
    const size_t at = ((size_t)b * Sk + key) * row_stride + (size_t)h * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < T::NT; ++n) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * n) =
          aria::pack_bf16(dka[n][2 * hr], dka[n][2 * hr + 1]);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * n) =
          aria::pack_bf16(dva[n][2 * hr], dva[n][2 * hr + 1]);
    }
  }
}

// dq of 64 queries: walks the key tiles
template <int D>
__global__ void __launch_bounds__(THREADS)
seg_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                  const float4* __restrict__ qs, const uint8_t* __restrict__ kv_valid,
                  __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int Sqp, int H, float scale) {
  using T = Dims<D>;
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* const sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const sd = sq + T::TILE;
  __nv_bfloat16* const sk = sd + T::TILE;      // [2] the walked key tiles
  __nv_bfloat16* const sv = sk + 2 * T::TILE;  // [2] and their values
  int* const kseg = reinterpret_cast<int*>(sv + 2 * T::TILE);  // [2][COLS]
  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;
  const int nk = (Sk + COLS - 1) / COLS;

  zero_pad<D>(sq);
  load_rows<D>(sq, q, b, h, q0, Sq, H);
  load_rows<D>(sd, dout, b, h, q0, Sq, H);
  auto load_stage = [&](int t) {
    const int st = t & 1;
    load_rows<D>(sk + st * T::TILE, k, b, h, t * COLS, Sk, H);
    load_rows<D>(sv + st * T::TILE, v, b, h, t * COLS, Sk, H);
    if (threadIdx.x < COLS) {
      const int key = t * COLS + threadIdx.x;
      kseg[st * COLS + threadIdx.x] =
          key >= Sk ? -2 : kv_valid == nullptr ? 1 : (int)kv_valid[(size_t)b * Sk + key];
    }
  };
  load_stage(0);
  aria::cp_async_commit();

  // this thread's two query rows' statistics (rows past Sq: segment -1, 1 / l = 0)
  const float4 sta = qs[(size_t)bh * Sqp + q0 + r0 + g];
  const float4 stb = qs[(size_t)bh * Sqp + q0 + r0 + g + 8];
  const uint32_t sqa = aria::smem_u32(sq), sda = aria::smem_u32(sd);

  float dqa[T::NT][4];
#pragma unroll
  for (int n = 0; n < T::NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk) {
      load_stage(t + 1);
      aria::cp_async_commit();
      aria::cp_async_wait<1>();
    } else {
      aria::cp_async_wait<0>();
    }
    __syncthreads();
    const int st = t & 1;
    const uint32_t ska = aria::smem_u32(sk + st * T::TILE), sva = aria::smem_u32(sv + st * T::TILE);
    const int* const ks = kseg + st * COLS;

    // s = Q K^T and dp = dO V^T: this warp's 16 queries x 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < T::KS; ++kk) {
      uint32_t aq[4], ad[4];
      ldsm4(sqa + a_off<D>(r0, 16 * kk, lane), aq);
      ldsm4(sda + a_off<D>(r0, 16 * kk, lane), ad);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bk[4], bv[4];
        ldsm4(ska + b_off<D>(16 * j, 16 * kk, lane), bk);
        ldsm4(sva + b_off<D>(16 * j, 16 * kk, lane), bv);
        aria::mma_bf16(s[2 * j], aq, bk[0], bk[1]);
        aria::mma_bf16(s[2 * j + 1], aq, bk[2], bk[3]);
        aria::mma_bf16(dp[2 * j], ad, bv[0], bv[1]);
        aria::mma_bf16(dp[2 * j + 1], ad, bv[2], bv[3]);
      }
    }
    // ds as A fragments: k-step u holds keys 16u .. 16u + 15
    uint32_t sa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k0s = ks[8 * j + 2 * t4], k1s = ks[8 * j + 2 * t4 + 1];
      p_ds(s[j][0], dp[j][0], sta, k0s, scale);
      p_ds(s[j][1], dp[j][1], sta, k1s, scale);
      p_ds(s[j][2], dp[j][2], stb, k0s, scale);
      p_ds(s[j][3], dp[j][3], stb, k1s, scale);
      const int u = j >> 1, hf = (j & 1) << 1;
      sa[u][hf] = aria::pack_bf16(dp[j][0], dp[j][1]);
      sa[u][hf + 1] = aria::pack_bf16(dp[j][2], dp[j][3]);
    }
    // dQ += dS K: B from [key][d] storage through .trans
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int jp = 0; jp < T::NT / 2; ++jp) {
        uint32_t bk[4];
        ldsm4t(ska + a_off<D>(16 * u, 16 * jp, lane), bk);
        aria::mma_bf16(dqa[2 * jp], sa[u], bk[0], bk[1]);
        aria::mma_bf16(dqa[2 * jp + 1], sa[u], bk[2], bk[3]);
      }
      if constexpr (T::NT % 2) {
        uint32_t bk[2];
        ldsm2t(ska + a_off<D>(16 * u, 8 * (T::NT - 1), lane), bk);
        aria::mma_bf16(dqa[T::NT - 1], sa[u], bk[0], bk[1]);
      }
    }
    __syncthreads();
  }

  const size_t row_stride = (size_t)H * D;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + r0 + g + 8 * hr;
    if (row >= Sq) continue;
    const size_t at = ((size_t)b * Sq + row) * row_stride + (size_t)h * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < T::NT; ++n)
      *reinterpret_cast<uint32_t*>(dq + at + 8 * n) =
          aria::pack_bf16(dqa[n][2 * hr], dqa[n][2 * hr + 1]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* kv_valid,
           const float4* qs, void* dq, void* dk, void* dv, int B, int Sq, int Sk, int Sqp, int H,
           float scale, cudaStream_t st) {
  using T = Dims<D>;
  using bf = const __nv_bfloat16*;
  cudaError_t err = aria::allow_smem(seg_bwd_dkv_kernel<D>, T::SMEM);
  if (err == cudaSuccess) err = aria::allow_smem(seg_bwd_dq_kernel<D>, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  seg_bwd_dkv_kernel<D><<<dim3((Sk + ROWS - 1) / ROWS, B * H), THREADS, T::SMEM, st>>>(
      (bf)q, (bf)k, (bf)v, (bf)dout, qs, (const uint8_t*)kv_valid, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, Sq, Sk, Sqp, H, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  seg_bwd_dq_kernel<D><<<dim3(Sqp / ROWS, B * H), THREADS, T::SMEM, st>>>(
      (bf)q, (bf)k, (bf)v, (bf)dout, qs, (const uint8_t*)kv_valid, (__nv_bfloat16*)dq, Sq, Sk,
      Sqp, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, do, dq [B, Sq, H, D], k, v, dk, dv [B, Sk, H, D] bf16 (D 64 or 72);
// stats f32 [2, B, H, Sq] (the forward's m, then l); q_valid [B, Sq],
// kv_valid [B, Sk] bool bytes or NULL; scratch qs f32 [B, H, Sqp, 4], Sqp =
// Sq rounded up to 64.
ARIA_EXPORT int aria_flash_segment_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const void* stats,
                                       const void* q_valid, const void* kv_valid, void* qs,
                                       void* dq, void* dk, void* dv, int B, int Sq, int Sk,
                                       int H, int D, float scale, void* stream) {
  if ((D != 64 && D != 72) || B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int Sqp = (Sq + COLS - 1) / COLS * COLS, rows = B * H * Sqp;
  seg_bwd_prep_kernel<<<(rows + 7) / 8, 256, 0, st>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, (const float*)stats,
      (const uint8_t*)q_valid, (float4*)qs, B, Sq, Sqp, H, D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float4* const qsf = (const float4*)qs;
  return D == 64
             ? launch<64>(q, k, v, dout, kv_valid, qsf, dq, dk, dv, B, Sq, Sk, Sqp, H, scale, st)
             : launch<72>(q, k, v, dout, kv_valid, qsf, dq, dk, dv, B, Sq, Sk, Sqp, H, scale, st);
}
