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

}  // namespace

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
