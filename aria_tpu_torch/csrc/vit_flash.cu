// vit_flash: non-causal attention over q/k/v [B, S, H, D] bf16 with a
// key-padding mask kv_valid [B, S] (bool bytes, NULL = all valid); output
// [B, S, H, D] bf16. Rows of padding queries are garbage by contract.
//
// Replaces aria_tpu/ops/vit_flash.py:91 vit_flash (`_kernel` :50), the
// ViT's attention over the 4,900 patches of a 980px crop (H = 16, D = 72).
//
// Bound: tensor-core throughput, 4*S^2*D FLOPs per head (~3.0 TFLOP per
// crop over 27 layers). Block = 4 warps = 64 query rows of one (crop,
// head); each warp owns 16 rows. Key and value tiles of 64 positions are
// double-buffered in shared memory with cp.async (rows past S zero-filled).
// Both products are warp-level mma.sync m16n8k16 (bf16 operands, f32
// sums): S = Q K^T with K read by ldmatrix, O += P V with V read by
// ldmatrix.trans. P never leaves registers: the f32 score fragment of two
// key n-tiles is the A fragment of the next product after rounding to
// bf16.
//
// D = 72 is not a multiple of the 16-wide k step: shared-memory rows are
// padded to DP = round_up(D, 16) (80) with zero columns, plus 8 more
// elements of row stride against bank conflicts. The padded columns cost
// 11% of the MMA work at D = 72 and nothing else.
//
// Numerics follow the TPU kernel: q pre-scaled by 1/sqrt(D) in f32 and
// cast to bf16; f32 scores plus -1e30 on masked keys; online softmax with
// the running sum l in f32; p rounded to bf16 for p.v only; output
// acc / max(l, 1e-30). Each thread keeps a partial l over its own key
// columns; the four threads of a row add theirs at the end.

#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int BQ = WARPS * 16;  // query rows per block
constexpr int BK = 64;          // key positions per tile

using aria::ldmatrix_x4;
using aria::ldmatrix_x4_trans;
using aria::mma_bf16;
using aria::pack_bf16;

// 16-byte global -> shared copy; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(gmem), "r"(src_bytes));
}

using aria::cp_async_commit;
using aria::cp_async_wait;

template <int DP>
__global__ void __launch_bounds__(WARPS * 32)
vit_flash_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ kv_valid,
                 __nv_bfloat16* __restrict__ out, int S, int H, int D, float scale) {
  constexpr int STRIDE = DP + 8;  // shared row stride in elements
  constexpr int KD = DP / 16;     // k steps of Q K^T
  constexpr int ND = DP / 8;      // d n-tiles of P V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // ks[2][BK * STRIDE], vs[2][BK * STRIDE], mask_s[2][BK]
  __nv_bfloat16 (*ks)[BK * STRIDE] = reinterpret_cast<__nv_bfloat16 (*)[BK * STRIDE]>(smem_raw);
  __nv_bfloat16 (*vs)[BK * STRIDE] = ks + 2;
  float (*mask_s)[BK] = reinterpret_cast<float (*)[BK]>(vs + 2);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t row_stride = (size_t)H * D;
  const size_t base = (size_t)b * S * row_stride + (size_t)h * D;
  const int qrow0 = blockIdx.x * BQ + warp * 16;

  // zero the padded columns D..STRIDE of every shared row (never copied)
  for (int i = threadIdx.x; i < 2 * BK * (STRIDE - D); i += blockDim.x) {
    const int buf = i / (BK * (STRIDE - D)), rem = i % (BK * (STRIDE - D));
    const int r = rem / (STRIDE - D), c = D + rem % (STRIDE - D);
    ks[buf][r * STRIDE + c] = __float2bfloat16(0.f);
    vs[buf][r * STRIDE + c] = __float2bfloat16(0.f);
  }

  // Q fragments, pre-scaled in f32 and rounded to bf16 (rows past S and
  // columns past D are zero)
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = qrow0 + g + ((i & 1) ? 8 : 0);
      const int c = kk * 16 + 2 * t + ((i & 2) ? 8 : 0);
      float lo = 0.f, hi = 0.f;
      if (r < S && c < D) {
        const __nv_bfloat162 pair =
            *reinterpret_cast<const __nv_bfloat162*>(q + base + (size_t)r * row_stride + c);
        lo = __bfloat162float(pair.x) * scale;
        hi = __bfloat162float(pair.y) * scale;
      }
      qa[kk][i] = pack_bf16(lo, hi);
    }
  }

  const int chunks = D / 8;  // 16-byte chunks per row
  auto load_tile = [&](int tile, int buf) {
    const int k0 = tile * BK;
    for (int i = threadIdx.x; i < BK * chunks; i += blockDim.x) {
      const int r = i / chunks, c = (i % chunks) * 8;
      const int j = k0 + r;
      const size_t off = base + (size_t)min(j, S - 1) * row_stride + c;
      const int bytes = j < S ? 16 : 0;
      cp_async16(&ks[buf][r * STRIDE + c], k + off, bytes);
      cp_async16(&vs[buf][r * STRIDE + c], v + off, bytes);
    }
    for (int r = threadIdx.x; r < BK; r += blockDim.x) {
      const int j = k0 + r;
      const bool ok = j < S && (kv_valid == nullptr || kv_valid[(size_t)b * S + j]);
      mask_s[buf][r] = ok ? 0.f : aria::NEG_INF;
    }
    cp_async_commit();
  };

  float m[2] = {aria::NEG_INF, aria::NEG_INF};  // rows g and g + 8
  float l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  const int ntiles = (S + BK - 1) / BK;
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

    // online softmax; row g holds s[.][0..1], row g + 8 holds s[.][2..3]
    float mx[2] = {aria::NEG_INF, aria::NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float m0 = mask_s[buf][j * 8 + 2 * t], m1 = mask_s[buf][j * 8 + 2 * t + 1];
      s[j][0] += m0;
      s[j][1] += m1;
      s[j][2] += m0;
      s[j][3] += m1;
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(aria::FULL_MASK, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(aria::FULL_MASK, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - mn);
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

    // O += P V over 4 k steps of 16 keys
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
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
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow0 + g + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* dst = out + base + (size_t)row * row_stride;
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
cudaError_t launch(const void* q, const void* k, const void* v, const void* kv_valid, void* out,
                   int B, int S, int H, int D, float scale, cudaStream_t stream) {
  const size_t smem = 4 * (size_t)BK * (DP + 8) * sizeof(__nv_bfloat16) + 2 * BK * sizeof(float);
  cudaError_t err = aria::allow_smem(vit_flash_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  vit_flash_kernel<DP><<<grid, WARPS * 32, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const uint8_t*)kv_valid, (__nv_bfloat16*)out, S, H, D, scale);
  return cudaGetLastError();
}

}  // namespace

ARIA_EXPORT int aria_vit_flash(const void* q, const void* k, const void* v, const void* kv_valid,
                               void* out, int B, int S, int H, int D, float scale,
                               void* stream) {
  // the ViT's D = 72 pads to 80; D = 64 needs no padding
  const cudaStream_t st = (cudaStream_t)stream;
  if ((D != 64 && D != 72) || S <= 0) return (int)cudaErrorInvalidValue;
  return D == 64 ? launch<64>(q, k, v, kv_valid, out, B, S, H, D, scale, st)
                 : launch<80>(q, k, v, kv_valid, out, B, S, H, D, scale, st);
}
