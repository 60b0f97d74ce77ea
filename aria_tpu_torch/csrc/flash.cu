// flash_causal: causal attention forward over fresh q/k/v [B, S, H, 128]
// bf16 (query i attends keys j <= i), output bf16, online softmax in f32.
//
// Replaces the causal forward of aria_tpu/ops/flash.py:30 flash_sdpa, the
// library Pallas TPU flash kernel `_flash_attention_kernel_single_batch`
// (jax/experimental/pallas/ops/tpu/flash_attention.py:342-472), whose
// rounding points it keeps: unscaled bf16 q.k^T with f32 sums, then
// s *= scale in f32; p = exp(s - m) in f32, the denominator summing the f32
// p; p rounded to bf16 for p.v; one rounding of acc / l to bf16. The scale
// is not folded into q. The exponentials are exp2f(s * log2(e) - m *
// log2(e)), which moves p by a few ulps against expf.
//
// Bound: 4 * S(S+1)/2 * 128 FLOPs per (b, h) at 989 TFLOP/s (bf16 tensor
// cores); 26 GFLOP, 0.0217 ms, at [1, 2048, 20, 128]. The design is
// Hopper's: both products on wgmma (m64n128k16, bf16 -> f32), K and V
// brought by TMA.
//
// - A block takes one (b, h) and a tile of 128 query rows: two consumer
//   warpgroups of 64 rows each and one producer warpgroup, of which one
//   thread starts the TMA loads. setmaxnreg moves the producer's registers
//   to the consumers at run time, but ptxas compiles the consumers to the
//   launch's 168 registers: P is packed to bf16 as it is made, so that they
//   fit without spills or serialised wgmmas. Where B * H * ceil(S/128)
//   blocks would leave SMs idle, or S <= 64, the tile is 64 rows with one
//   consumer warpgroup; the choice is made from the shapes and the card's
//   SM count (an argument: ops/backend.py sm_count) alone.
// - Q is loaded once. K and V tiles of 128 keys go through a ring of 2
//   stages (32 KB + 32 KB each), each tile as two boxes of 64 columns with
//   the 128-byte swizzle, completion on an mbarrier per stage for K and for
//   V; an empty barrier per stage gives the slot back. The tensor maps are
//   rank 4 over (d, h, s, b), built on the host per call.
// - S = Q K^T: A (Q) and B (K, K-major as stored) from shared memory, 8
//   k-steps over d. The softmax runs on the accumulator fragment: each
//   thread holds 2 rows x 32 columns, the row max reduced over the 4
//   threads of a quad. P goes to bf16 in registers as the A operand of
//   O += P V, whose B (V, MN-major) is read through the descriptor's
//   transpose bit.
// - Keys are walked only up to the query tile's diagonal, and the mask is
//   applied on the diagonal tile and at S only. Query tiles run longest
//   (last) first. TMA zero-fills rows past S; keys >= S are masked and rows
//   >= S are not stored, so any S works.
//
// With a non-null `lse` the kernel also writes each query row's f32
// log-sum-exp of its scaled scores, lse [B, H, S] = m + log(l), which the
// backward (flash_bwd.cu) recomputes the probabilities from; the output
// is the same bits with or without it.

#include "hopper.cuh"

namespace {

constexpr int D = 128;
constexpr int KT = 128;                  // keys per tile
constexpr int STAGES = 2;
constexpr int ROW_BYTES = 128;           // one swizzled row: 64 bf16
constexpr int TILE_BYTES = KT * D * 2;   // one K or V tile: two boxes of 16 KB
constexpr int BOX_BYTES = KT * ROW_BYTES;
constexpr float LOG2E = 1.4426950408889634f;

template <int NWG>
struct Layout {
  static constexpr int ROWS = 64 * NWG;            // query rows per block
  static constexpr int Q_BYTES = ROWS * D * 2;     // two boxes of ROWS x 64
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * TILE_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * TILE_BYTES;
  // q, full_k[STAGES], full_v[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;  // + alignment slack
};

template <int NWG>
constexpr int threads() { return 128 * (NWG + 1); }  // the producer warpgroup and the consumers

template <int NWG>
__global__ void __launch_bounds__(threads<NWG>(), 1)
flash_causal_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse, int S, int H, float scale) {
  using L = Layout<NWG>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = aria::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle needs 1024-byte alignment
  const uint32_t sq = base, sk = base + L::K_OFF, sv = base + L::V_OFF;
  const uint32_t bar = base + L::BAR_OFF;
  const uint32_t bar_q = bar;
  auto bar_k = [&](int st) { return bar + 8 * (1 + st); };
  auto bar_v = [&](int st) { return bar + 8 * (1 + STAGES + st); };
  auto bar_e = [&](int st) { return bar + 8 * (1 + 2 * STAGES + st); };

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tile = gridDim.y - 1 - blockIdx.y;  // the longest tiles first
  const int q0 = tile * L::ROWS;
  const int n_kt = (min(S, q0 + L::ROWS) - 1) / KT + 1;  // key tiles up to the diagonal
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    aria::mbar_init(bar_q, 1);
    for (int st = 0; st < STAGES; ++st) {
      aria::mbar_init(bar_k(st), 1);
      aria::mbar_init(bar_v(st), 1);
      aria::mbar_init(bar_e(st), 4 * NWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // the producer: one thread starts every load
    if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      aria::mbar_expect_tx(bar_q, L::Q_BYTES);
      aria::tma_load(sq, &qmap, bar_q, 0, h, q0, b);
      aria::tma_load(sq + L::ROWS * ROW_BYTES, &qmap, bar_q, 64, h, q0, b);
      for (int j = 0; j < n_kt; ++j) {
        const int st = j % STAGES;
        if (j >= STAGES) aria::mbar_wait(bar_e(st), ((j / STAGES) - 1) & 1);
        const uint32_t kd = sk + st * TILE_BYTES, vd = sv + st * TILE_BYTES;
        aria::mbar_expect_tx(bar_k(st), TILE_BYTES);
        aria::tma_load(kd, &kmap, bar_k(st), 0, h, j * KT, b);
        aria::tma_load(kd + BOX_BYTES, &kmap, bar_k(st), 64, h, j * KT, b);
        aria::mbar_expect_tx(bar_v(st), TILE_BYTES);
        aria::tma_load(vd, &vmap, bar_v(st), 0, h, j * KT, b);
        aria::tma_load(vd + BOX_BYTES, &vmap, bar_v(st), 64, h, j * KT, b);
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows
  if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int row0 = q0 + cw * 64;            // the warpgroup's first row
  const int ra = row0 + warp * 16 + lane / 4, rb = ra + 8;  // this thread's two rows
  const int c2 = 2 * (lane % 4);            // its first column in each 8-column block

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float ma = aria::NEG_INF, mb = aria::NEG_INF, la = 0.f, lb = 0.f;  // l: this thread's part

  aria::mbar_wait(bar_q, 0);
  const uint32_t qa = sq + cw * 64 * ROW_BYTES;
  for (int j = 0; j < n_kt; ++j) {
    const int st = j % STAGES;
    const uint32_t ph = (j / STAGES) & 1;
    const uint32_t kb = sk + st * TILE_BYTES, vb = sv + st * TILE_BYTES;
    float s[64];
    aria::mbar_wait(bar_k(st), ph);
    aria::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 columns into the box's 64
      aria::wgmma_ss<0, 0>(s, aria::sw128_desc(qa + (kk / 4) * L::ROWS * ROW_BYTES + off, 16, 1024),
                           aria::sw128_desc(kb + (kk / 4) * BOX_BYTES + off, 16, 1024), kk > 0);
    }
    aria::wgmma_commit();
    aria::wgmma_wait<0>();
    aria::fence_regs(s);

    const int key0 = j * KT;
    const bool edge = key0 + KT - 1 > row0 || key0 + KT > S;  // the diagonal or the end
    float mxa = aria::NEG_INF, mxb = aria::NEG_INF;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& sa = s[4 * n + e];
        float& sb = s[4 * n + 2 + e];
        sa *= scale;
        sb *= scale;
        if (edge) {
          const int key = key0 + 8 * n + c2 + e;
          if (key > ra || key >= S) sa = aria::NEG_INF;
          if (key > rb || key >= S) sb = aria::NEG_INF;
        }
        mxa = fmaxf(mxa, sa);
        mxb = fmaxf(mxb, sb);
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mxa = fmaxf(mxa, __shfl_xor_sync(aria::FULL_MASK, mxa, x));
      mxb = fmaxf(mxb, __shfl_xor_sync(aria::FULL_MASK, mxb, x));
    }
    const float mna = fmaxf(ma, mxa), mnb = fmaxf(mb, mxb);
    const float corra = exp2f((ma - mna) * LOG2E), corrb = exp2f((mb - mnb) * LOG2E);
    const float mla = mna * LOG2E, mlb = mnb * LOG2E;
    // p, packed to bf16 as wgmma's A fragment as it is made: k-step t holds
    // keys 16t..16t+15, the accumulator's column blocks 2t and 2t+1 (the
    // scores die as they are packed, which keeps the registers down)
    float suma = 0.f, sumb = 0.f;
    uint32_t pa[32];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      float p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        p[i] = exp2f(fmaf(s[8 * t + i], LOG2E, (i & 2) ? -mlb : -mla));
      suma += p[0] + p[1] + p[4] + p[5];
      sumb += p[2] + p[3] + p[6] + p[7];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[4 * t + i] = aria::pack_bf16(p[2 * i], p[2 * i + 1]);
    }
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      o[4 * n] *= corra;
      o[4 * n + 1] *= corra;
      o[4 * n + 2] *= corrb;
      o[4 * n + 3] *= corrb;
    }
    la = la * corra + suma;
    lb = lb * corrb + sumb;
    ma = mna;
    mb = mnb;

    aria::mbar_wait(bar_v(st), ph);
    aria::fence_regs(o);
    aria::wgmma_fence();
#pragma unroll
    for (int t = 0; t < KT / 16; ++t)  // 16 keys a step; the second 64 columns at LBO
      aria::wgmma_rs<1>(o, pa + 4 * t,
                        aria::sw128_desc(vb + t * 16 * ROW_BYTES, BOX_BYTES, 1024));
    aria::wgmma_commit();
    aria::wgmma_wait<0>();
    aria::fence_regs(o);
    if (lane == 0) aria::mbar_arrive(bar_e(st));
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    la += __shfl_xor_sync(aria::FULL_MASK, la, x);
    lb += __shfl_xor_sync(aria::FULL_MASK, lb, x);
  }
  const size_t row_stride = (size_t)H * D;
  __nv_bfloat16* oa = out + ((size_t)b * S + ra) * row_stride + (size_t)h * D;
  __nv_bfloat16* ob = oa + 8 * row_stride;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int d = 8 * n + c2;
    if (ra < S)
      *reinterpret_cast<uint32_t*>(oa + d) = aria::pack_bf16(o[4 * n] / la, o[4 * n + 1] / la);
    if (rb < S)
      *reinterpret_cast<uint32_t*>(ob + d) =
          aria::pack_bf16(o[4 * n + 2] / lb, o[4 * n + 3] / lb);
  }
  if (lse != nullptr && lane % 4 == 0) {
    float* lrow = lse + ((size_t)b * H + h) * S;
    if (ra < S) lrow[ra] = ma + logf(la);
    if (rb < S) lrow[rb] = mb + logf(lb);
  }
}

// ---- host side
// [B, S, H, 128] bf16 as the rank-4 map (d, h, s, b), boxes of 64 x 1 x rows x 1
bool make_map(CUtensorMap* map, const void* t, int B, int S, int H, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return aria::make_map(map, t, 4, dims, strides, box);
}

template <int NWG>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int B, int S,
           int H, float scale, cudaStream_t stream) {
  using L = Layout<NWG>;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, B, S, H, L::ROWS) || !make_map(&km, k, B, S, H, KT) ||
      !make_map(&vm, v, B, S, H, KT))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = aria::allow_smem(flash_causal_kernel<NWG>, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + L::ROWS - 1) / L::ROWS);
  flash_causal_kernel<NWG><<<grid, threads<NWG>(), L::BYTES, stream>>>(
      qm, km, vm, (__nv_bfloat16*)out, (float*)lse, S, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// lse: f32 [B, H, S], or null (serving); sms: the card's SM count
ARIA_EXPORT int aria_flash_causal(const void* q, const void* k, const void* v, void* out,
                                  void* lse, int B, int S, int H, float scale, int sms,
                                  void* stream) {
  if (S <= 0 || B <= 0 || H <= 0) return (int)cudaSuccess;
  // 64-row tiles where 128-row ones would leave SMs idle, or wasted rows
  const bool small = S <= 64 || (long)B * H * ((S + 127) / 128) < sms;
  return small ? launch<1>(q, k, v, out, lse, B, S, H, scale, (cudaStream_t)stream)
               : launch<2>(q, k, v, out, lse, B, S, H, scale, (cudaStream_t)stream);
}
