// flash_segment: non-causal attention over q [B, Sq, H, D], k / v [B, Sk,
// H, D] bf16 with segment ids: key j is admitted for query i iff
// seg_q[i] == seg_k[j], where seg = 1 for a valid position and 0 for
// padding (q_valid / kv_valid bool bytes; NULL: every position valid).
// Output [B, Sq, H, D] bf16.
//
// Replaces the library Pallas TPU `flash_attention` that
// aria_tpu/ops/flash.py:30 flash_sdpa calls with `SegmentIds` and
// causal=False (flash.py:61-101): the ViT's attention over the 4,900
// patches of a 980px crop (H = 16, D = 72) when the JAX package's
// ARIA_TPU_VIT_FLASH=0 turns vit_flash off (vit.py:170-175). Pad queries
// attend pad keys only.
//
// Numerics follow the library kernel (flash_attention.py:395-472): the
// scores are the unscaled bf16 q.k with f32 sums, then `s *= sm_scale` in
// f32, then an additive mask of -0.7 * FLT_MAX where the segments differ;
// the running max starts at -inf; p = exp(s - m) is rounded to v's dtype
// for p.v while the running sum keeps it in f32. The library rescales the
// accumulator by 1 / l at every key block; here it is divided once at the
// end (the same value up to f32 rounding). Keys past Sk in the last tile
// get -inf and so contribute nothing.
//
// Bound: tensor-core throughput, 4*Sq*Sk*D FLOPs per head (110.6 GFLOP at
// [1, 4900, 16, 72]). Block = 4 warps = 64 query rows of one (batch, head);
// each warp owns 16 rows. Key and value tiles of 64 positions are
// double-buffered in shared memory with cp.async (rows past Sk zero-filled),
// with each key's segment id beside them. Both products are warp-level
// mma.sync m16n8k16 (bf16 operands, f32 sums): S = Q K^T with K read by
// ldmatrix, O += P V with V read by ldmatrix.trans; P never leaves
// registers. D = 72 runs natively: shared rows are padded to DP =
// round_up(D, 16) (80) with zero columns, which change no product.

#include <float.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int BQ = WARPS * 16;  // query rows per block
constexpr int BK = 64;          // key positions per tile
constexpr float MASK_VALUE = -0.7f * FLT_MAX;  // the library's DEFAULT_MASK_VALUE

using aria::cp_async_commit;
using aria::cp_async_wait;
using aria::ldmatrix_x4;
using aria::ldmatrix_x4_trans;
using aria::mma_bf16;

// 16-byte global -> shared copy; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16z(void* smem, const void* gmem, int src_bytes) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(gmem), "r"(src_bytes));
}

template <int DP>
__global__ void __launch_bounds__(WARPS * 32)
flash_seg_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ q_valid,
                 const uint8_t* __restrict__ kv_valid, __nv_bfloat16* __restrict__ out,
                 int Sq, int Sk, int H, int D, float scale) {
  constexpr int STRIDE = DP + 8;  // shared row stride in elements
  constexpr int KD = DP / 16;     // k steps of Q K^T
  constexpr int ND = DP / 8;      // d n-tiles of P V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // ks[2][BK * STRIDE], vs[2][BK * STRIDE], seg_s[2][BK]
  __nv_bfloat16 (*ks)[BK * STRIDE] = reinterpret_cast<__nv_bfloat16 (*)[BK * STRIDE]>(smem_raw);
  __nv_bfloat16 (*vs)[BK * STRIDE] = ks + 2;
  int (*seg_s)[BK] = reinterpret_cast<int (*)[BK]>(vs + 2);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t row_stride = (size_t)H * D;
  const size_t qbase = (size_t)b * Sq * row_stride + (size_t)h * D;
  const size_t kbase = (size_t)b * Sk * row_stride + (size_t)h * D;
  const int qrow0 = blockIdx.x * BQ + warp * 16;

  // zero the padded columns D..STRIDE of every shared row (never copied)
  for (int i = threadIdx.x; i < 2 * BK * (STRIDE - D); i += blockDim.x) {
    const int buf = i / (BK * (STRIDE - D)), rem = i % (BK * (STRIDE - D));
    const int r = rem / (STRIDE - D), c = D + rem % (STRIDE - D);
    ks[buf][r * STRIDE + c] = __float2bfloat16(0.f);
    vs[buf][r * STRIDE + c] = __float2bfloat16(0.f);
  }

  // Q fragments as stored, bf16 (rows past Sq and columns past D are zero),
  // and the segment of each of the thread's two rows
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = qrow0 + g + ((i & 1) ? 8 : 0);
      const int c = kk * 16 + 2 * t + ((i & 2) ? 8 : 0);
      uint32_t pair = 0;
      if (r < Sq && c < D) pair = aria::lds32(q + qbase + (size_t)r * row_stride + c);
      qa[kk][i] = pair;
    }
  }
  int qseg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow0 + g + 8 * r;
    qseg[r] = (q_valid == nullptr || (row < Sq && q_valid[(size_t)b * Sq + row])) ? 1 : 0;
  }

  const int chunks = D / 8;  // 16-byte chunks per row
  auto load_tile = [&](int tile, int buf) {
    const int k0 = tile * BK;
    for (int i = threadIdx.x; i < BK * chunks; i += blockDim.x) {
      const int r = i / chunks, c = (i % chunks) * 8;
      const int j = k0 + r;
      const size_t off = kbase + (size_t)min(j, Sk - 1) * row_stride + c;
      const int bytes = j < Sk ? 16 : 0;
      cp_async16z(&ks[buf][r * STRIDE + c], k + off, bytes);
      cp_async16z(&vs[buf][r * STRIDE + c], v + off, bytes);
    }
    for (int r = threadIdx.x; r < BK; r += blockDim.x) {
      const int j = k0 + r;
      // -1: past Sk, matches no segment and gets -inf below
      seg_s[buf][r] = j >= Sk ? -1 : (kv_valid == nullptr || kv_valid[(size_t)b * Sk + j]) ? 1 : 0;
    }
    cp_async_commit();
  };

  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  const int ntiles = (Sk + BK - 1) / BK;
  load_tile(0, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      load_tile(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = ks[buf];
    const __nv_bfloat16* vt = vs[buf];

    // scores: 16 query rows x 64 keys = 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        // matrices: keys j*8+0..7 at d kk*16 (+8), keys (j+1)*8+0..7 at d kk*16 (+8)
        const int key = (j + (lane >> 4)) * 8 + (lane & 7);
        const int col = kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t r[4];
        ldmatrix_x4(r, kt + key * STRIDE + col);
        mma_bf16(s[j], qa[kk], r[0], r[1]);
        mma_bf16(s[j + 1], qa[kk], r[2], r[3]);
      }
    }

    // s *= scale, then the mask; online softmax (row g: s[.][0..1], row
    // g + 8: s[.][2..3])
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ks_ = seg_s[buf][j * 8 + 2 * t + (i & 1)];
        const float add = ks_ < 0 ? -INFINITY : (ks_ == qseg[i >> 1] ? 0.f : MASK_VALUE);
        s[j][i] = __fadd_rn(__fmul_rn(s[j][i], scale), add);
        mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(aria::FULL_MASK, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(aria::FULL_MASK, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - mn);  // exp(-inf) = 0 on the first tile
      m[r] = mn;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = expf(s[j][i] - m[i >> 1]);
        l[i >> 1] += s[j][i];
      }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V over 4 k steps of 16 keys, p rounded to bf16
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = aria::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = aria::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = aria::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = aria::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        // matrices: keys kk*16+0..7 / +8..15 at d n*8, then at d (n+1)*8
        const int key = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int col = (n + (lane >> 4)) * 8;
        uint32_t r[4];
        ldmatrix_x4_trans(r, vt + key * STRIDE + col);
        mma_bf16(acc[n], pa, r[0], r[1]);
        mma_bf16(acc[n + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(aria::FULL_MASK, l[r], 1);
    l[r] += __shfl_xor_sync(aria::FULL_MASK, l[r], 2);
    l[r] = l[r] == 0.f ? 1.f : 1.f / l[r];  // the library's l_next_inv_safe
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow0 + g + 8 * r;
    if (row >= Sq) continue;
    __nv_bfloat16* dst = out + qbase + (size_t)row * row_stride;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(dst + c) =
            __floats2bfloat162_rn(acc[n][2 * r] * l[r], acc[n][2 * r + 1] * l[r]);
    }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* q_valid,
                   const void* kv_valid, void* out, int B, int Sq, int Sk, int H, int D,
                   float scale, cudaStream_t stream) {
  const size_t smem = 4 * (size_t)BK * (DP + 8) * sizeof(__nv_bfloat16) + 2 * BK * sizeof(int);
  cudaError_t err = aria::allow_smem(flash_seg_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_seg_kernel<DP><<<grid, WARPS * 32, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const uint8_t*)q_valid, (const uint8_t*)kv_valid, (__nv_bfloat16*)out, Sq, Sk, H, D,
      scale);
  return cudaGetLastError();
}

}  // namespace

ARIA_EXPORT int aria_flash_segment(const void* q, const void* k, const void* v,
                                   const void* q_valid, const void* kv_valid, void* out, int B,
                                   int Sq, int Sk, int H, int D, float scale, void* stream) {
  // the ViT's head dims: 72 pads to 80 in shared memory, 64 needs no padding
  const cudaStream_t st = (cudaStream_t)stream;
  if ((D != 64 && D != 72) || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  return D == 64 ? launch<64>(q, k, v, q_valid, kv_valid, out, B, Sq, Sk, H, D, scale, st)
                 : launch<80>(q, k, v, q_valid, kv_valid, out, B, Sq, Sk, H, D, scale, st);
}
