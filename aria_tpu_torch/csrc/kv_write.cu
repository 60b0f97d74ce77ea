// kv_write: an in-place write of one fresh position per lane into the
// stacked cache [L, R, Hc, S, D], and of its scales [L, R, Hs, S], in one
// launch.
//
// Replaces aria_tpu/ops/kv_write.py:91 kv_cache_write (`_kernel` :79, the
// pallas_call at :136). The TPU kernel copies a whole (sublane-tiled)
// block per lane and overwrites one row of it, so two lanes in one block
// with different slots would lose a write; here each lane writes only its
// own rows, so no destination is read, and lanes that share a (row, slot)
// race only if their data differ (the engines repeat a lane verbatim, so
// the bytes agree). The TPU package writes the scale planes outside its
// kernel (moe_lm.py:509-527); this one folds them in, which saves two
// launches per layer of a decode step that the host bounds.
//
// Bound: bytes. Per lane it moves 2*Hc*D*esize bytes of k/v (10 KB for
// bf16 at 20 heads) plus 2*Hs scale elements, a few hundred KB for 32
// lanes: the launch itself outweighs the copy. One block per lane; each
// thread moves 16 bytes at a time, neighbouring threads on neighbouring
// bytes of one head row. A lane whose row or slot lies outside the cache
// writes nothing, as the reference's scatter drops an out-of-range index.
//
// rope_kv_write: the same write fused with everything that fed it, one
// launch a layer of a decode step or a from-zero prefill. It replaces the
// chain of eager ops around aria_tpu/ops/kv_write.py:91's kernel (the
// reference's moe_lm.py:371-380 cast and RoPE, :391-464 quantization and
// head-pair packing), 20-52 launches a layer in the port, with one. It
// reads a token's f32 qkv row, rounds it to bf16, rotates q and k,
// quantizes k and v in the cache's form, writes them (and their scales) at
// the token's (row, slot), and writes the rotated query (decode attention
// scales it in its own kernel), or the fresh q, k, v for causal flash. Bound: bytes, ~41 KB a token at 20 heads of 128 (the f32 qkv row
// 30 KB of it): 1.3 MB for 32 decode lanes, well under a launch's cost, so
// the design aims at one launch and correct bits, not a share of the bound.
//
// Bits: equal to the eager chain. Every product, sum and quotient is an
// explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn), so nvcc contracts nothing into an FMA that torch's separate
// elementwise kernels do not make; rintf rounds half to even as
// torch.round; constants are the f32 of torch's f64 scalars.
//
// One block a (token, head pair): 64 threads, warp w taking head g + w*H/2,
// lane l the four values 4l..4l+3 (two interleaved RoPE pairs) of q, k and
// v: coalesced 16-byte reads of the qkv row, the amax over the head by warp
// shuffles. The packed int4 cache holds head g in the low nibble and g +
// H/2 in the high one, so warp 1 hands its nibbles to warp 0 through shared
// memory. Whether a token writes is the same for its whole block.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
kv_write_kernel(uint8_t* __restrict__ k, uint8_t* __restrict__ v, uint8_t* __restrict__ ks,
                uint8_t* __restrict__ vs, const uint8_t* __restrict__ kn,
                const uint8_t* __restrict__ vn, const uint8_t* __restrict__ ksn,
                const uint8_t* __restrict__ vsn, const int* __restrict__ rows,
                const int* __restrict__ slots, int R, int Hc, int S, int row_bytes, int Hs,
                int scale_bytes, int layer) {
  const int b = blockIdx.x;
  const int row = rows[b], slot = slots[b];
  if (row < 0 || row >= R || slot < 0 || slot >= S) return;
  const int chunks = row_bytes / 16;  // 16-byte pieces of one head's row
  const int n = Hc * chunks;
  const size_t plane = ((size_t)layer * R + row) * Hc;  // (layer, row, head 0)
  for (int i = threadIdx.x; i < 2 * n; i += THREADS) {
    const int second = i >= n;  // 0: k, 1: v
    const int j = i - second * n;
    const int h = j / chunks, c = j - h * chunks;
    const size_t dst = ((plane + h) * S + slot) * row_bytes + (size_t)c * 16;
    const size_t src = ((size_t)b * Hc + h) * row_bytes + (size_t)c * 16;
    const uint4 val = *reinterpret_cast<const uint4*>((second ? vn : kn) + src);
    *reinterpret_cast<uint4*>((second ? v : k) + dst) = val;
  }
  if (ks != nullptr && threadIdx.x < 2 * Hs) {
    const int second = threadIdx.x >= Hs;
    const int h = threadIdx.x - second * Hs;
    const size_t dst = ((((size_t)layer * R + row) * Hs + h) * S + slot) * scale_bytes;
    const size_t src = ((size_t)b * Hs + h) * scale_bytes;
    const uint8_t* from = (second ? vsn : ksn) + src;
    uint8_t* to = (second ? vs : ks) + dst;
    if (scale_bytes == 4) {
      *reinterpret_cast<uint32_t*>(to) = *reinterpret_cast<const uint32_t*>(from);
    } else {
      *reinterpret_cast<uint16_t*>(to) = *reinterpret_cast<const uint16_t*>(from);
    }
  }
}

constexpr int RKV_THREADS = 64;  // two warps: heads g and g + H/2
// torch multiplies an f32 tensor by a Python scalar's f32 rounding
constexpr float INV127 = (float)(1.0 / 127.0);
constexpr float INV7 = (float)(1.0 / 7.0);

enum RkvMode { RKV_BF16 = 0, RKV_INT8 = 1, RKV_INT4 = 2 };

// Rotate two interleaved pairs (x0, x1), (x2, x3) by their cos/sin, as
// ops/rope.py: in f32 below LONG_SEQ tokens, else in bf16 with cos and sin
// rounded once and every product and difference rounded; the result
// rounded to bf16 either way.
__device__ __forceinline__ void rope4(float (&x)[4], float2 c, float2 s, bool low) {
  const float cs[2] = {c.x, c.y}, sn[2] = {s.x, s.y};
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const float xe = x[2 * p], xo = x[2 * p + 1];
    float ev, od;
    if (low) {
      const float cb = aria::bf16_round(cs[p]), sb = aria::bf16_round(sn[p]);
      ev = __fsub_rn(aria::bf16_round(__fmul_rn(xe, cb)), aria::bf16_round(__fmul_rn(xo, sb)));
      od = __fadd_rn(aria::bf16_round(__fmul_rn(xo, cb)), aria::bf16_round(__fmul_rn(xe, sb)));
    } else {
      ev = __fsub_rn(__fmul_rn(xe, cs[p]), __fmul_rn(xo, sn[p]));
      od = __fadd_rn(__fmul_rn(xo, cs[p]), __fmul_rn(xe, sn[p]));
    }
    x[2 * p] = aria::bf16_round(ev);
    x[2 * p + 1] = aria::bf16_round(od);
  }
}

// four f32 of a qkv row, rounded to bf16 (qkv.to(x.dtype))
__device__ __forceinline__ void load_bf4(const float* p, float (&x)[4]) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  x[0] = aria::bf16_round(w.x); x[1] = aria::bf16_round(w.y);
  x[2] = aria::bf16_round(w.z); x[3] = aria::bf16_round(w.w);
}

__device__ __forceinline__ void store_bf4(__nv_bfloat16* p, const float (&x)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]), b = __floats2bfloat162_rn(x[2], x[3]);
  uint2 w;
  w.x = *reinterpret_cast<const uint32_t*>(&a);
  w.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = w;
}

// the head's amax over D (|x| over the warp's 128 values), clamped at 1e-6
__device__ __forceinline__ float head_amax(const float (&x)[4]) {
  const float m = fmaxf(fmaxf(fabsf(x[0]), fabsf(x[1])), fmaxf(fabsf(x[2]), fabsf(x[3])));
  return fmaxf(aria::warp_max(m), 1e-6f);
}

// int8: round(x / (amax * (1/127))) in f32, four signed bytes in a word
__device__ __forceinline__ uint32_t quant8(const float (&x)[4], float sc) {
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w |= (uint32_t)(uint8_t)(int8_t)(int)rintf(__fdiv_rn(x[i], sc)) << (8 * i);
  return w;
}

// int4: round(bf16(x / sc)) clamped to [-8, 7], the nibbles at bit 8i
__device__ __forceinline__ uint32_t quant4(const float (&x)[4], float sc) {
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float r = fminf(fmaxf(rintf(aria::bf16_round(__fdiv_rn(x[i], sc))), -8.f), 7.f);
    w |= ((uint32_t)(int)r & 0xFu) << (8 * i);
  }
  return w;
}

template <int MODE>
__global__ void __launch_bounds__(RKV_THREADS)
rope_kv_write_kernel(const float* __restrict__ qkv, const float* __restrict__ cosv,
                     const float* __restrict__ sinv, uint8_t* __restrict__ kc,
                     uint8_t* __restrict__ vc, void* __restrict__ ks, void* __restrict__ vs,
                     const int* __restrict__ rows, const int* __restrict__ slots,
                     __nv_bfloat16* __restrict__ q_out, __nv_bfloat16* __restrict__ k_out,
                     __nv_bfloat16* __restrict__ v_out, int Tc, int H, int R, int S, int layer,
                     int low, int null_page) {
  constexpr int D = aria::HEAD_DIM;
  __shared__ uint32_t hi_words[2][32];  // int4: warp 1's k and v nibbles
  const int t = blockIdx.x, g = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = g + warp * (H >> 1), e = 4 * lane;
  const float* src = qkv + (size_t)t * 3 * H * D + (size_t)h * D + e;
  float q[4], k[4], v[4];
  load_bf4(src, q);
  load_bf4(src + (size_t)H * D, k);
  load_bf4(src + (size_t)2 * H * D, v);
  const size_t cs = (size_t)(t % Tc) * (D / 2) + 2 * lane;
  const float2 c = *reinterpret_cast<const float2*>(cosv + cs);
  const float2 s = *reinterpret_cast<const float2*>(sinv + cs);
  rope4(q, c, s, low);
  rope4(k, c, s, low);

  const size_t out = ((size_t)t * H + h) * D + e;
  store_bf4(q_out + out, q);
  if (k_out != nullptr) {  // from-zero prefill: the fresh k, v for causal flash
    store_bf4(k_out + out, k);
    store_bf4(v_out + out, v);
  }

  const int row = rows[t];
  int slot = slots[t];
  if (null_page && row == 0) slot = 0;
  if (row < 0 || row >= R || slot < 0 || slot >= S) return;  // the whole block
  const size_t plane = (size_t)layer * R + row;  // (layer, row)
  const size_t sc_at = (plane * H + h) * S + slot;
  if constexpr (MODE == RKV_BF16) {
    const size_t at = ((plane * H + h) * S + slot) * D + e;
    store_bf4(reinterpret_cast<__nv_bfloat16*>(kc) + at, k);
    store_bf4(reinterpret_cast<__nv_bfloat16*>(vc) + at, v);
  } else if constexpr (MODE == RKV_INT8) {
    const float ksc = __fmul_rn(head_amax(k), INV127), vsc = __fmul_rn(head_amax(v), INV127);
    const size_t at = ((plane * H + h) * S + slot) * D + e;
    *reinterpret_cast<uint32_t*>(kc + at) = quant8(k, ksc);
    *reinterpret_cast<uint32_t*>(vc + at) = quant8(v, vsc);
    if (lane == 0) {
      static_cast<float*>(ks)[sc_at] = ksc;
      static_cast<float*>(vs)[sc_at] = vsc;
    }
  } else {
    const __nv_bfloat16 kb = __float2bfloat16_rn(__fmul_rn(head_amax(k), INV7));
    const __nv_bfloat16 vb = __float2bfloat16_rn(__fmul_rn(head_amax(v), INV7));
    const uint32_t kn = quant4(k, aria::bf2f(kb)), vn = quant4(v, aria::bf2f(vb));
    if (lane == 0) {
      static_cast<__nv_bfloat16*>(ks)[sc_at] = kb;
      static_cast<__nv_bfloat16*>(vs)[sc_at] = vb;
    }
    if (warp == 1) {
      hi_words[0][lane] = kn << 4;
      hi_words[1][lane] = vn << 4;
    }
    __syncthreads();
    if (warp == 0) {  // biased-lo bytes: (lo + 8) & 0xF | hi << 4
      const size_t at = ((plane * (H >> 1) + g) * S + slot) * D + e;
      *reinterpret_cast<uint32_t*>(kc + at) = ((kn + 0x08080808u) & 0x0F0F0F0Fu) | hi_words[0][lane];
      *reinterpret_cast<uint32_t*>(vc + at) = ((vn + 0x08080808u) & 0x0F0F0F0Fu) | hi_words[1][lane];
    }
  }
}

}  // namespace

ARIA_EXPORT int aria_rope_kv_write(const void* qkv, const void* cosv, const void* sinv, void* k,
                                   void* v, void* k_scale, void* v_scale, const void* rows,
                                   const void* slots, void* q_out, void* k_out, void* v_out,
                                   int T, int Tc, int H, int R, int S, int layer, int mode,
                                   int low, int null_page, void* stream) {
  const dim3 grid(T, H / 2);
  auto launch = [&](auto kernel) {
    kernel<<<grid, RKV_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)qkv, (const float*)cosv, (const float*)sinv, (uint8_t*)k, (uint8_t*)v,
        k_scale, v_scale, (const int*)rows, (const int*)slots, (__nv_bfloat16*)q_out,
        (__nv_bfloat16*)k_out, (__nv_bfloat16*)v_out, Tc, H, R, S, layer, low, null_page);
  };
  if (mode == RKV_INT4) {
    launch(rope_kv_write_kernel<RKV_INT4>);
  } else if (mode == RKV_INT8) {
    launch(rope_kv_write_kernel<RKV_INT8>);
  } else {
    launch(rope_kv_write_kernel<RKV_BF16>);
  }
  return cudaGetLastError();
}

ARIA_EXPORT int aria_kv_write(void* k, void* v, void* k_scale, void* v_scale, const void* k_new,
                              const void* v_new, const void* ks_new, const void* vs_new,
                              const void* rows, const void* slots, int B, int R, int Hc, int S,
                              int row_bytes, int Hs, int scale_bytes, int layer, void* stream) {
  kv_write_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (uint8_t*)k, (uint8_t*)v, (uint8_t*)k_scale, (uint8_t*)v_scale, (const uint8_t*)k_new,
      (const uint8_t*)v_new, (const uint8_t*)ks_new, (const uint8_t*)vs_new, (const int*)rows,
      (const int*)slots, R, Hc, S, row_bytes, Hs, scale_bytes, layer);
  return cudaGetLastError();
}
