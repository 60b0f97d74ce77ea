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
// f32 out. The backward's lhs gradient is the same product of the f32
// cotangent with rhs (transpose_rhs flipped), rounded once to bf16: with an
// f32 operand megablox computes in f32 (megablox/common.py:54-65), and
// here each f32 lhs value is split into bf16 hi + lo (hi = bf16(x), lo =
// bf16(x - hi)) as it is staged, and two bf16 products sum in f32. That is
// exact for values of at most 16 significant bits, which both of
// experts_ragged's cotangents are in bf16 training (a bf16 gradient, or
// one times a bf16 combine weight); any other f32 value loses at most
// 2^-17 of itself.
//
// The work is the groups' 128-row tiles in order, at most M/128 + E - 1 of
// them: a tile that straddles a group boundary is computed once for each
// group it touches and stores only that group's rows, as megablox visits
// it; an empty group has no tile. Each block finds its own (group, tile) by
// walking group_sizes, so the grid is sized from M alone and nothing waits
// on the host; blocks past the last tile exit at once.
//
// A block computes 128 rows x 128 columns with 8 warps (2 x 4, 64 x 32
// each) on mma.sync m16n8k16, bf16 operands and f32 sums, the K loop in
// steps of 32 through a 3-stage cp.async pipeline (the f32 lhs is loaded,
// split and stored by the threads); fragments come from shared memory by
// ldmatrix (with .trans for the N-contiguous rhs). A row's sums run over K
// in the same order whatever M and the groups are, so a row gets the same
// bits at every row count.
//
// tgmm, the rhs gradient (megablox gmm.py:573, pallas_call :763):
// out[g] = lhs[rows of g]^T . grad[rows of g], [E, K, N] in bf16, for a
// bf16 lhs [M, K] and an f32 grad [M, N] (split into hi + lo as above).
// One block per (128 x 128 tile of [K, N], group); it walks its group's
// rows 32 at a time, with rows of other groups zeroed as they are staged,
// so a group that starts or ends inside a tile takes only its own rows; an
// empty group's slice is zeros, as megablox stores its zeroed accumulator.
//
// Bound: at 512 prompt tokens x 8 slots (M = 4,096) the w1 product reads
// the 66 experts' 1.12 GB once and does 70 GFLOP: bytes, 0.34 ms. Tiles
// that straddle groups read their experts' weights again. In training at
// M = 98,304 every product is bound by operations (about 3.3 TFLOP per
// layer for the two forward products, 3.4 ms at the bf16 peak).

#include "common.cuh"

namespace {

using aria::cp_async16;
using aria::cp_async_commit;
using aria::cp_async_wait;
using aria::ldmatrix_x4;
using aria::ldmatrix_x4_trans;
using aria::mma_bf16;
using aria::pack_bf16;

constexpr int TM = 128;       // rows per tile
constexpr int TN = 128;       // columns per block
constexpr int BK = 32;        // contraction depth per pipeline stage
constexpr int STAGES = 3;
constexpr int THREADS = 256;  // 8 warps: 2 along rows x 4 along columns
constexpr int AS = BK + 8;    // bf16 per staged lhs row (and per rhs row, K contiguous)
constexpr int BSN = TN + 8;   // bf16 per staged rhs row, N contiguous
constexpr int A_ELEMS = TM * AS;
constexpr int B_ELEMS = TN * AS > BK * BSN ? TN * AS : BK * BSN;

// bf16 elements per pipeline stage: the lhs tile (twice, hi and lo, for an
// f32 lhs) and the rhs tile
template <bool F32LHS>
__host__ __device__ constexpr int stage_elems() { return (F32LHS ? 2 : 1) * A_ELEMS + B_ELEMS; }

// x as bf16 hi + lo: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x, float& hi, float& lo) {
  hi = aria::bf16_round(x);
  lo = x - hi;
}

// 4 consecutive f32 as bf16 hi and lo pairs into two shared-memory rows
__device__ __forceinline__ void store_split4(__nv_bfloat16* hi_dst, __nv_bfloat16* lo_dst,
                                             float4 v) {
  float h[4], l[4];
  split_bf16(v.x, h[0], l[0]);
  split_bf16(v.y, h[1], l[1]);
  split_bf16(v.z, h[2], l[2]);
  split_bf16(v.w, h[3], l[3]);
  *reinterpret_cast<uint2*>(hi_dst) = make_uint2(pack_bf16(h[0], h[1]), pack_bf16(h[2], h[3]));
  *reinterpret_cast<uint2*>(lo_dst) = make_uint2(pack_bf16(l[0], l[1]), pack_bf16(l[2], l[3]));
}

// F32LHS: lhs f32, out bf16 (the backward's lhs gradient); else lhs bf16,
// out f32 (the forward)
template <bool KMAJOR, bool F32LHS>
__global__ void __launch_bounds__(THREADS)
gmm_kernel(const void* __restrict__ lhs_raw, const __nv_bfloat16* __restrict__ rhs,
           const int* __restrict__ group_sizes, void* __restrict__ out_raw, int M, int K, int N,
           int E) {
  constexpr int STAGE = stage_elems<F32LHS>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  // this block's (group, tile): the blockIdx.y-th of the groups' tiles
  const int w = blockIdx.y;
  int e = -1, tile = 0, gstart = 0, gend = 0;
  for (int gi = 0, start = 0, seen = 0; gi < E; ++gi) {
    const int sz = group_sizes[gi];
    if (sz > 0) {
      const int first = start / TM, n = (start + sz - 1) / TM - first + 1;
      if (w < seen + n) {
        e = gi, tile = first + (w - seen), gstart = start, gend = start + sz;
        break;
      }
      seen += n;
    }
    start += sz;
  }
  if (e < 0 || tile * TM >= M) return;  // block-uniform
  gend = min(gend, M);
  const int row0 = tile * TM, n0 = blockIdx.x * TN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const __nv_bfloat16* rhs_e = rhs + (size_t)e * N * K;

  auto load = [&](int c, int s) {
    const int k0 = c * BK;
    __nv_bfloat16* as = smem + s * STAGE;
    __nv_bfloat16* bs = as + (F32LHS ? 2 : 1) * A_ELEMS;
    if constexpr (F32LHS) {  // loaded, split and stored by the threads
      const float* lhs = reinterpret_cast<const float*>(lhs_raw);
      for (int i = threadIdx.x; i < TM * (BK / 4); i += THREADS) {
        const int r = i / (BK / 4), q = i % (BK / 4);
        const float4 v =
            *reinterpret_cast<const float4*>(lhs + (size_t)(row0 + r) * K + k0 + q * 4);
        store_split4(as + r * AS + q * 4, as + A_ELEMS + r * AS + q * 4, v);
      }
    } else {
      const __nv_bfloat16* lhs = reinterpret_cast<const __nv_bfloat16*>(lhs_raw);
      for (int i = threadIdx.x; i < TM * (BK / 8); i += THREADS) {
        const int r = i / (BK / 8), q = i % (BK / 8);
        cp_async16(as + r * AS + q * 8, lhs + (size_t)(row0 + r) * K + k0 + q * 8);
      }
    }
    if constexpr (KMAJOR) {  // TN rows of rhs, BK of K each
      for (int i = threadIdx.x; i < TN * (BK / 8); i += THREADS) {
        const int r = i / (BK / 8), q = i % (BK / 8);
        cp_async16(bs + r * AS + q * 8, rhs_e + (size_t)(n0 + r) * K + k0 + q * 8);
      }
    } else {  // BK rows of rhs, TN of N each
      for (int i = threadIdx.x; i < BK * (TN / 8); i += THREADS) {
        const int r = i / (TN / 8), q = i % (TN / 8);
        cp_async16(bs + r * BSN + q * 8, rhs_e + (size_t)(k0 + r) * N + n0 + q * 8);
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][nj][i] = 0.f;

  const int nk = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c is in; chunk c - 1's stage is free to refill
    if (c + STAGES - 1 < nk) load(c + STAGES - 1, (c + STAGES - 1) % STAGES);
    cp_async_commit();
    const __nv_bfloat16* as = smem + (c % STAGES) * STAGE;
    const __nv_bfloat16* bs = as + (F32LHS ? 2 : 1) * A_ELEMS;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      // A: matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15)
      uint32_t a[4][4], alo[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int off = r * AS + ks * 16 + (lane >> 4) * 8;
        ldmatrix_x4(a[mi], as + off);
        if constexpr (F32LHS) ldmatrix_x4(alo[mi], as + A_ELEMS + off);
      }
      // B: per pair of n-tiles, matrices (n 0-7, k 0-7), (n 0-7, k 8-15),
      // (n 8-15, k 0-7), (n 8-15, k 8-15)
      uint32_t b[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t r[4];
        if constexpr (KMAJOR) {
          const int n = wn * 32 + p * 16 + (lane >> 4) * 8 + (lane & 7);
          ldmatrix_x4(r, bs + n * AS + ks * 16 + ((lane >> 3) & 1) * 8);
        } else {
          const int k = ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
          ldmatrix_x4_trans(r, bs + k * BSN + wn * 32 + p * 16 + (lane >> 4) * 8);
        }
        b[2 * p][0] = r[0], b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2], b[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          mma_bf16(acc[mi][nj], a[mi], b[nj][0], b[nj][1]);
          if constexpr (F32LHS) mma_bf16(acc[mi][nj], alo[mi], b[nj][0], b[nj][1]);
        }
    }
  }

  // store this group's rows only
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + wm * 64 + mi * 16 + g + 8 * hr;
      if (row < gstart || row >= gend) continue;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int col = n0 + wn * 32 + nj * 8 + 2 * t;
        const float v0 = acc[mi][nj][2 * hr], v1 = acc[mi][nj][2 * hr + 1];
        if constexpr (F32LHS) {
          *reinterpret_cast<uint32_t*>(reinterpret_cast<__nv_bfloat16*>(out_raw) +
                                       (size_t)row * N + col) = pack_bf16(v0, v1);
        } else {
          *reinterpret_cast<float2*>(reinterpret_cast<float*>(out_raw) + (size_t)row * N + col) =
              make_float2(v0, v1);
        }
      }
    }
  }
}

template <bool KMAJOR, bool F32LHS>
int launch(const void* lhs, const void* rhs, const void* group_sizes, void* out, int M, int K,
           int N, int E, cudaStream_t st) {
  const size_t smem = (size_t)STAGES * stage_elems<F32LHS>() * sizeof(__nv_bfloat16);
  cudaError_t err = aria::allow_smem(gmm_kernel<KMAJOR, F32LHS>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / TN, M / TM + E - 1);
  gmm_kernel<KMAJOR, F32LHS><<<grid, THREADS, smem, st>>>(
      lhs, (const __nv_bfloat16*)rhs, (const int*)group_sizes, out, M, K, N, E);
  return cudaGetLastError();
}

constexpr int TK = 128;     // tgmm: rows of the [K, N] output tile
constexpr int TS = 128 + 8;  // tgmm: bf16 per staged row

__global__ void __launch_bounds__(THREADS)
tgmm_kernel(const __nv_bfloat16* __restrict__ lhs, const float* __restrict__ grad,
            const int* __restrict__ group_sizes, __nv_bfloat16* __restrict__ out, int M, int K,
            int N) {
  __shared__ __align__(16) __nv_bfloat16 as[BK * TS];  // lhs rows x 128 of K
  __shared__ __align__(16) __nv_bfloat16 bh[BK * TS];  // grad rows x 128 of N, hi
  __shared__ __align__(16) __nv_bfloat16 bl[BK * TS];  // and lo
  const int e = blockIdx.z, k0 = blockIdx.y * TK, n0 = blockIdx.x * TN;
  int gstart = 0;
  for (int gi = 0; gi < e; ++gi) gstart += group_sizes[gi];
  const int gend = min(gstart + group_sizes[e], M);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][nj][i] = 0.f;

  for (int r0 = gstart / BK * BK; r0 < gend; r0 += BK) {
    __syncthreads();  // the previous rows are consumed
    for (int i = threadIdx.x; i < BK * (TK / 8); i += THREADS) {
      const int r = i / (TK / 8), c = (i % (TK / 8)) * 8, row = r0 + r;
      uint4 w = make_uint4(0, 0, 0, 0);  // rows of other groups count zero
      if (row >= gstart && row < gend)
        w = *reinterpret_cast<const uint4*>(lhs + (size_t)row * K + k0 + c);
      *reinterpret_cast<uint4*>(as + r * TS + c) = w;
    }
    for (int i = threadIdx.x; i < BK * (TN / 4); i += THREADS) {
      const int r = i / (TN / 4), c = (i % (TN / 4)) * 4, row = min(r0 + r, M - 1);
      const float4 v = *reinterpret_cast<const float4*>(grad + (size_t)row * N + n0 + c);
      store_split4(bh + r * TS + c, bl + r * TS + c, v);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      // A = lhs^T (rows k, contraction r) from the [r][k] tile by ldmatrix.trans
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = ks * 16 + (lane >> 4) * 8 + (lane & 7);
        ldmatrix_x4_trans(a[mi], as + r * TS + wm * 64 + mi * 16 + ((lane >> 3) & 1) * 8);
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t hi[4], lo[4];
        const int r = ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int c = wn * 32 + p * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(hi, bh + r * TS + c);
        ldmatrix_x4_trans(lo, bl + r * TS + c);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_bf16(acc[mi][2 * p], a[mi], hi[0], hi[1]);
          mma_bf16(acc[mi][2 * p], a[mi], lo[0], lo[1]);
          mma_bf16(acc[mi][2 * p + 1], a[mi], hi[2], hi[3]);
          mma_bf16(acc[mi][2 * p + 1], a[mi], lo[2], lo[3]);
        }
      }
    }
  }

  __nv_bfloat16* out_e = out + (size_t)e * K * N;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = k0 + wm * 64 + mi * 16 + g + 8 * hr;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int col = n0 + wn * 32 + nj * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(out_e + (size_t)row * N + col) =
            pack_bf16(acc[mi][nj][2 * hr], acc[mi][nj][2 * hr + 1]);
      }
    }
}

}  // namespace

// rhs_kmajor = 1: rhs [E, N, K] (megablox transpose_rhs=True); 0: [E, K, N].
// lhs_f32 = 0: lhs bf16, out f32; 1: lhs f32, out bf16
ARIA_EXPORT int aria_gmm(const void* lhs, const void* rhs, const void* group_sizes, void* out,
                         int M, int K, int N, int E, int rhs_kmajor, int lhs_f32, void* stream) {
  if (M % TM || K % BK || N % TN || E < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (lhs_f32)
    return rhs_kmajor ? launch<true, true>(lhs, rhs, group_sizes, out, M, K, N, E, st)
                      : launch<false, true>(lhs, rhs, group_sizes, out, M, K, N, E, st);
  return rhs_kmajor ? launch<true, false>(lhs, rhs, group_sizes, out, M, K, N, E, st)
                    : launch<false, false>(lhs, rhs, group_sizes, out, M, K, N, E, st);
}

// lhs bf16 [M, K], grad f32 [M, N], group_sizes int32 [E] summing to M;
// out bf16 [E, K, N]
ARIA_EXPORT int aria_tgmm(const void* lhs, const void* grad, const void* group_sizes, void* out,
                          int M, int K, int N, int E, void* stream) {
  if (M % BK || K % TK || N % TN || E < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(N / TN, K / TK, E);
  tgmm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)lhs, (const float*)grad, (const int*)group_sizes,
      (__nv_bfloat16*)out, M, K, N);
  return cudaGetLastError();
}
