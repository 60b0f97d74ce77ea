// gmm: the forward of megablox's ragged grouped matmul, bf16 in, f32 out.
//
// Replaces the two `gmm` calls of aria_tpu/ops/moe.py:204 experts_ragged
// (jax.experimental.pallas.ops.tpu.megablox, :237 and :240):
//
//   out[r, :] = lhs[r, :] . rhs[g(r)]^T   rhs [E, N, K], K contiguous (transpose_rhs)
//   out[r, :] = lhs[r, :] . rhs[g(r)]     rhs [E, K, N], N contiguous
//
// where lhs [M, K] holds rows sorted by group and g(r) is the group of row
// r: group_sizes [E] int32 stays on the device, and M is a multiple of 128
// whose rows the groups cover. The work is the groups' 128-row tiles in
// order, at most M/128 + E - 1 of them: a tile that straddles a group
// boundary is computed once for each group it touches and stores only that
// group's rows, as megablox visits it; an empty group has no tile. Each
// block finds its own (group, tile) by walking group_sizes, so the grid is
// sized from M alone and nothing waits on the host; blocks past the last
// tile exit at once.
//
// A block computes 128 rows x 128 columns with 8 warps (2 x 4, 64 x 32
// each) on mma.sync m16n8k16, bf16 operands and f32 sums, the K loop in
// steps of 32 through a 3-stage cp.async pipeline; fragments come from
// shared memory by ldmatrix (with .trans for the N-contiguous rhs). A
// row's sums run over K in the same order whatever M and the groups are,
// so a row gets the same bits at every row count.
//
// Bound: at 512 prompt tokens x 8 slots (M = 4,096) the w1 product reads
// the 66 experts' 1.12 GB once and does 70 GFLOP: bytes, 0.34 ms. Tiles
// that straddle groups read their experts' weights again.

#include "common.cuh"

namespace {

using aria::cp_async16;
using aria::cp_async_commit;
using aria::cp_async_wait;
using aria::ldmatrix_x4;
using aria::ldmatrix_x4_trans;
using aria::mma_bf16;

constexpr int TM = 128;       // rows per tile
constexpr int TN = 128;       // columns per block
constexpr int BK = 32;        // contraction depth per pipeline stage
constexpr int STAGES = 3;
constexpr int THREADS = 256;  // 8 warps: 2 along rows x 4 along columns
constexpr int AS = BK + 8;    // bf16 per staged lhs row (and per rhs row, K contiguous)
constexpr int BSN = TN + 8;   // bf16 per staged rhs row, N contiguous
constexpr int A_ELEMS = TM * AS;
constexpr int B_ELEMS = TN * AS > BK * BSN ? TN * AS : BK * BSN;
constexpr int STAGE = A_ELEMS + B_ELEMS;  // bf16 elements

template <bool KMAJOR>
__global__ void __launch_bounds__(THREADS)
gmm_kernel(const __nv_bfloat16* __restrict__ lhs, const __nv_bfloat16* __restrict__ rhs,
           const int* __restrict__ group_sizes, float* __restrict__ out, int M, int K, int N,
           int E) {
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
    __nv_bfloat16* bs = as + A_ELEMS;
    for (int i = threadIdx.x; i < TM * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), q = i % (BK / 8);
      cp_async16(as + r * AS + q * 8, lhs + (size_t)(row0 + r) * K + k0 + q * 8);
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
    const __nv_bfloat16* bs = as + A_ELEMS;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      // A: matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15)
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(a[mi], as + r * AS + ks * 16 + (lane >> 4) * 8);
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
        for (int nj = 0; nj < 4; ++nj) mma_bf16(acc[mi][nj], a[mi], b[nj][0], b[nj][1]);
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
        *reinterpret_cast<float2*>(out + (size_t)row * N + col) =
            make_float2(acc[mi][nj][2 * hr], acc[mi][nj][2 * hr + 1]);
      }
    }
  }
}

template <bool KMAJOR>
int launch(const void* lhs, const void* rhs, const void* group_sizes, void* out, int M, int K,
           int N, int E, cudaStream_t st) {
  const size_t smem = (size_t)STAGES * STAGE * sizeof(__nv_bfloat16);
  cudaError_t err = aria::allow_smem(gmm_kernel<KMAJOR>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / TN, M / TM + E - 1);
  gmm_kernel<KMAJOR><<<grid, THREADS, smem, st>>>(
      (const __nv_bfloat16*)lhs, (const __nv_bfloat16*)rhs, (const int*)group_sizes,
      (float*)out, M, K, N, E);
  return cudaGetLastError();
}

}  // namespace

// rhs_kmajor = 1: rhs [E, N, K] (megablox transpose_rhs=True); 0: [E, K, N]
ARIA_EXPORT int aria_gmm(const void* lhs, const void* rhs, const void* group_sizes, void* out,
                         int M, int K, int N, int E, int rhs_kmajor, void* stream) {
  if (M % TM || K % BK || N % TN || E < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return rhs_kmajor ? launch<true>(lhs, rhs, group_sizes, out, M, K, N, E, st)
                    : launch<false>(lhs, rhs, group_sizes, out, M, K, N, E, st);
}
