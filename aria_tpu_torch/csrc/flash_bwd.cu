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
// bf16, every product sums in f32, and dq, dk, dv are rounded once.
//
// Three kernels: di (one warp per row); dkv, one block per 64 keys of one
// (b, h), walking the query blocks from its diagonal block to S; dq, one
// block per 64 queries, walking the key blocks up to its diagonal. Each
// block has 4 warps of 16 rows (keys in dkv, queries in dq) and computes
// with mma.sync m16n8k16 (bf16 operands, f32 sums): the scores and dp come
// out as accumulator fragments, and p and ds are turned into the next
// product's A fragments in registers, as FlashAttention-2 does. Tiles
// stage in shared memory (row stride 136 bf16, free of ldmatrix bank
// conflicts); blocks above the diagonal are skipped. s and dp are
// recomputed in the dq kernel, 7 products per tile pair in all.
//
// Bound: operations, 4 * 2 * S^2/2 * 128 per (b, h) for the backward's
// four products after the causal half; at [1, 2048, 20, 128] that is 43
// GFLOP, 0.043 ms at the bf16 peak. No pipelining: speed is later work.

#include "common.cuh"

namespace {

using aria::cp_async16;
using aria::cp_async_commit;
using aria::cp_async_wait;
using aria::ldmatrix_x4;
using aria::ldmatrix_x4_trans;
using aria::mma_bf16;
using aria::pack_bf16;

constexpr int D = 128;       // head dim
constexpr int BR = 64;       // rows per block (queries or keys)
constexpr int WARPS = 4;     // 16 rows each
constexpr int THREADS = WARPS * 32;
constexpr int RS = D + 8;    // bf16 per staged row
constexpr int TILE = BR * RS;  // bf16 per staged tile

// rows r0.. r0+BR-1 of one (b, h) head of x [B, S, H, D] into smem (rows
// at or past S are zero)
__device__ __forceinline__ void stage(__nv_bfloat16* dst, const __nv_bfloat16* x, size_t base,
                                      size_t row_stride, int r0, int S) {
  for (int i = threadIdx.x; i < BR * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    if (r0 + r < S) {
      cp_async16(dst + r * RS + c, x + base + (size_t)(r0 + r) * row_stride + c);
    } else {
      *reinterpret_cast<uint4*>(dst + r * RS + c) = make_uint4(0, 0, 0, 0);
    }
  }
}

// acc[8][4] (16 rows x 64 cols) += A rows (16 x 128, this warp's, from a)
// . B^T where B is 64 rows x 128 in b: both tiles [row][d]
__device__ __forceinline__ void rows_dot_rows(float (*acc)[4], const __nv_bfloat16* a,
                                              const __nv_bfloat16* b, int warp, int lane) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t af[4];
    const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    ldmatrix_x4(af, a + r * RS + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int p = 0; p < BR / 16; ++p) {
      uint32_t bf[4];
      const int n = p * 16 + (lane >> 4) * 8 + (lane & 7);
      ldmatrix_x4(bf, b + n * RS + ks * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * p], af, bf[0], bf[1]);
      mma_bf16(acc[2 * p + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[16][4] (16 rows x 128) += P (16 x 64, as accumulator fragments p)
// . B where B is 64 rows x 128 in b ([row][d], rows the contraction)
__device__ __forceinline__ void frag_dot_tile(float (*acc)[4], float (*p)[4],
                                              const __nv_bfloat16* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < BR / 16; ++kk) {
    // accumulator tiles 2kk, 2kk+1 are the A fragment of contraction step kk
    uint32_t af[4];
    af[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    af[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    af[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    af[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t bf[4];
      const int k = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
      ldmatrix_x4_trans(bf, b + k * RS + np * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// rows of acc[16][4] (16 x 128) to out rows row0 + warp*16 .. as bf16
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, size_t base, size_t row_stride,
                                           float (*acc)[4], int row0, int S, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + g + 8 * hr;
    if (row >= S) continue;
#pragma unroll
    for (int nj = 0; nj < D / 8; ++nj) {
      *reinterpret_cast<uint32_t*>(out + base + (size_t)row * row_stride + nj * 8 + 2 * t) =
          pack_bf16(acc[nj][2 * hr], acc[nj][2 * hr + 1]);
    }
  }
}

// di[b, h, s] = sum_d o[b, s, h, d] * do[b, s, h, d], one warp per row
__global__ void __launch_bounds__(256)
flash_bwd_di_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                    float* __restrict__ di, int B, int S, int H) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= B * S * H) return;  // warp-uniform
  const int h = row % H, s = (row / H) % S, b = row / (H * S);
  const uint2 ow = reinterpret_cast<const uint2*>(o + (size_t)row * D)[lane];
  const uint2 dw = reinterpret_cast<const uint2*>(dout + (size_t)row * D)[lane];
  float v = aria::bf_lo(ow.x) * aria::bf_lo(dw.x) + aria::bf_hi(ow.x) * aria::bf_hi(dw.x) +
            aria::bf_lo(ow.y) * aria::bf_lo(dw.y) + aria::bf_hi(ow.y) * aria::bf_hi(dw.y);
  v = aria::warp_sum(v);
  if (lane == 0) di[((size_t)b * H + h) * S + s] = v;
}

// dk, dv for the 64 keys of block x of one (b, h)
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int H,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + TILE;
  __nv_bfloat16* qs = vs + TILE;
  __nv_bfloat16* dos = qs + TILE;
  float* lses = reinterpret_cast<float*>(dos + TILE);
  float* dis = lses + BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const size_t row_stride = (size_t)H * D;
  const size_t base = (size_t)b * S * row_stride + (size_t)h * D;
  const size_t stat = ((size_t)b * H + h) * S;

  stage(ks, k, base, row_stride, j0, S);
  stage(vs, v, base, row_stride, j0, S);
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero<D / 8>(dk_acc);
  zero<D / 8>(dv_acc);
  const int key0 = j0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8

  for (int i0 = j0; i0 < S; i0 += BR) {  // query blocks from the diagonal on
    __syncthreads();  // the previous query tile is consumed
    stage(qs, q, base, row_stride, i0, S);
    stage(dos, dout, base, row_stride, i0, S);
    cp_async_commit();
    for (int i = threadIdx.x; i < BR; i += THREADS) {
      lses[i] = i0 + i < S ? lse[stat + i0 + i] : 0.f;
      dis[i] = i0 + i < S ? di[stat + i0 + i] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();

    // s^T and dp^T: 16 keys x 64 queries per warp
    float st[BR / 8][4], dpt[BR / 8][4];
    zero<BR / 8>(st);
    zero<BR / 8>(dpt);
    rows_dot_rows(st, ks, qs, warp, lane);
    rows_dot_rows(dpt, vs, dos, warp, lane);
#pragma unroll
    for (int nj = 0; nj < BR / 8; ++nj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nj * 8 + 2 * t + (e & 1);  // query within the tile
        const int key = key0 + 8 * (e >> 1), qi = i0 + col;
        const float p = (key <= qi && qi < S) ? expf(st[nj][e] * scale - lses[col]) : 0.f;
        st[nj][e] = p;
        dpt[nj][e] = p * (dpt[nj][e] - dis[col]) * scale;  // ds^T
      }
    }
    frag_dot_tile(dv_acc, st, dos, lane);   // dv += p^T do
    frag_dot_tile(dk_acc, dpt, qs, lane);   // dk += ds^T q
  }
  store_rows(dk, base, row_stride, dk_acc, j0 + warp * 16, S, lane);
  store_rows(dv, base, row_stride, dv_acc, j0 + warp * 16, S, lane);
}

// dq for the 64 queries of block x of one (b, h)
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    __nv_bfloat16* __restrict__ dq, int S, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + TILE;
  __nv_bfloat16* ks = dos + TILE;
  __nv_bfloat16* vs = ks + TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const size_t row_stride = (size_t)H * D;
  const size_t base = (size_t)b * S * row_stride + (size_t)h * D;
  const size_t stat = ((size_t)b * H + h) * S;

  stage(qs, q, base, row_stride, i0, S);
  stage(dos, dout, base, row_stride, i0, S);
  const int q0 = i0 + warp * 16 + g;  // this thread's queries: q0, q0 + 8
  float row_lse[2], row_di[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + 8 * hr;
    row_lse[hr] = qi < S ? lse[stat + qi] : 0.f;
    row_di[hr] = qi < S ? di[stat + qi] : 0.f;
  }
  float dq_acc[D / 8][4];
  zero<D / 8>(dq_acc);

  for (int j0 = 0; j0 <= i0; j0 += BR) {  // key blocks up to the diagonal
    __syncthreads();  // the previous key tile is consumed
    stage(ks, k, base, row_stride, j0, S);
    stage(vs, v, base, row_stride, j0, S);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[BR / 8][4], dp[BR / 8][4];
    zero<BR / 8>(s);
    zero<BR / 8>(dp);
    rows_dot_rows(s, qs, ks, warp, lane);
    rows_dot_rows(dp, dos, vs, warp, lane);
#pragma unroll
    for (int nj = 0; nj < BR / 8; ++nj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + nj * 8 + 2 * t + (e & 1), hr = e >> 1;
        const int qi = q0 + 8 * hr;
        const float p = (key <= qi && qi < S) ? expf(s[nj][e] * scale - row_lse[hr]) : 0.f;
        dp[nj][e] = p * (dp[nj][e] - row_di[hr]) * scale;  // ds
      }
    }
    frag_dot_tile(dq_acc, dp, ks, lane);  // dq += ds k
  }
  store_rows(dq, base, row_stride, dq_acc, i0 + warp * 16, S, lane);
}

}  // namespace

// q, k, v, o, do, dq, dk, dv: bf16 [B, S, H, 128]; lse: f32 [B, H, S] from
// the forward; di: f32 [B, H, S] scratch
ARIA_EXPORT int aria_flash_causal_bwd(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const void* lse, void* di, void* dq,
                                      void* dk, void* dv, int B, int S, int H, float scale,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = B * S * H;
  flash_bwd_di_kernel<<<(rows + 7) / 8, 256, 0, st>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, (float*)di, B, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = 4 * TILE * sizeof(__nv_bfloat16) + 2 * BR * sizeof(float);
  const dim3 grid((S + BR - 1) / BR, H, B);
  if ((err = aria::allow_smem(flash_bwd_dkv_kernel, smem)) != cudaSuccess) return err;
  flash_bwd_dkv_kernel<<<grid, THREADS, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, (const float*)lse, (const float*)di, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, S, H, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem_q = 4 * TILE * sizeof(__nv_bfloat16);
  if ((err = aria::allow_smem(flash_bwd_dq_kernel, smem_q)) != cudaSuccess) return err;
  flash_bwd_dq_kernel<<<grid, THREADS, smem_q, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, (const float*)lse, (const float*)di, (__nv_bfloat16*)dq, S, H,
      scale);
  return cudaGetLastError();
}
