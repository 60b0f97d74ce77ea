"""In-place KV-cache write of one position per lane (counterpart of
aria_tpu/ops/kv_write.py).

Lane ``b`` writes ``k_new[b]`` and ``v_new[b]`` ([B, Hc, D]) at
``(layer, rows[b], :, slots[b], :)`` of the stacked cache [L, R, Hc, S, D],
and, when scales are given, ``ks_new[b]`` / ``vs_new[b]`` ([B, Hs]) at
``(layer, rows[b], :, slots[b])`` of the scale planes [L, R, Hs, S].
``rows`` and ``slots`` are int32 tensors on the cache's device, so the
write needs no host sync. The element type is any of 1, 2 or 4 bytes:
bf16, int8 and packed-int4 bytes (Hs = 2 * Hc) all go as bytes. A lane
whose row or slot lies outside the cache writes nothing, as the JAX
package's scatter drops an out-of-range index; lanes may repeat a
destination only with identical data.

Kernel: ``csrc/kv_write.cu``. It replaces ``kv_cache_write`` of
aria_tpu/ops/kv_write.py:91 (``_kernel`` :79) and, unlike it, writes the
scale planes in the same launch.
"""

from __future__ import annotations

from typing import Optional

import torch

from aria_tpu_torch.ops import backend
from aria_tpu_torch.ops._build import library


def kv_cache_write_plain(k_cache, v_cache, layer: int, rows, slots, k_new, v_new,
                         k_scale=None, v_scale=None, ks_new=None, vs_new=None) -> None:
    """Index assignment of the same rows; out-of-range lanes are left out."""
    R, S = k_cache.shape[1], k_cache.shape[3]
    r, s = rows.long(), slots.long()
    keep = (r >= 0) & (r < R) & (s >= 0) & (s < S)
    if not bool(keep.all()):
        r, s, k_new, v_new = r[keep], s[keep], k_new[keep], v_new[keep]
        if k_scale is not None:
            ks_new, vs_new = ks_new[keep], vs_new[keep]
    # non-adjacent index tensors put the lane axis first: [B, Hc, D]
    k_cache[layer][r, :, s] = k_new
    v_cache[layer][r, :, s] = v_new
    if k_scale is not None:
        k_scale[layer][r, :, s] = ks_new
        v_scale[layer][r, :, s] = vs_new


def kv_cache_write(
    k_cache: torch.Tensor,  # [L, R, Hc, S, D], written in place
    v_cache: torch.Tensor,
    layer: int,
    rows: torch.Tensor,  # [B] int32 destination row per lane
    slots: torch.Tensor,  # [B] int32 destination position per lane
    k_new: torch.Tensor,  # [B, Hc, D] in the cache's dtype
    v_new: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,  # [L, R, Hs, S], written in place
    v_scale: Optional[torch.Tensor] = None,
    ks_new: Optional[torch.Tensor] = None,  # [B, Hs] in the scales' dtype
    vs_new: Optional[torch.Tensor] = None,
) -> None:
    scaled = k_scale is not None
    extra = (k_scale, v_scale, ks_new, vs_new) if scaled else ()
    if not backend.on_cuda(k_cache, v_cache, rows, slots, k_new, v_new, *extra):
        kv_cache_write_plain(k_cache, v_cache, layer, rows, slots, k_new, v_new, *extra)
        return
    L, R, Hc, S, D = k_cache.shape
    B = k_new.shape[0]
    if not 0 <= layer < L:
        raise IndexError(f"kv_cache_write: layer {layer} of {L}")
    row_bytes = D * k_cache.element_size()
    if row_bytes % 16:
        raise ValueError(f"kv_cache_write: a head row of {row_bytes} bytes, not a multiple of 16")
    backend.require(v_cache, "v_cache", k_cache.dtype, k_cache.shape)
    backend.require(k_cache, "k_cache", k_cache.dtype)
    backend.require(k_new, "k_new", k_cache.dtype, (B, Hc, D))
    backend.require(v_new, "v_new", k_cache.dtype, (B, Hc, D))
    backend.require(rows, "rows", torch.int32, (B,))
    backend.require(slots, "slots", torch.int32, (B,))
    Hs, scale_bytes = 0, 0
    if scaled:
        Hs = k_scale.shape[2]
        if k_scale.element_size() not in (2, 4) or not 0 < Hs <= 128:
            raise ValueError(f"kv_cache_write: scales {k_scale.dtype} over {Hs} heads")
        scale_bytes = k_scale.element_size()
        backend.require(k_scale, "k_scale", k_scale.dtype, (L, R, Hs, S))
        backend.require(v_scale, "v_scale", k_scale.dtype, (L, R, Hs, S))
        backend.require(ks_new, "ks_new", k_scale.dtype, (B, Hs))
        backend.require(vs_new, "vs_new", k_scale.dtype, (B, Hs))
    if any(t.data_ptr() % 16 for t in (k_cache, v_cache, k_new, v_new)):
        raise ValueError("kv_cache_write: k/v storage must be 16-byte aligned")
    if B == 0:
        return
    p, null = backend.ptr, backend.ptr(None)
    err = library().aria_kv_write(
        p(k_cache), p(v_cache), p(k_scale) if scaled else null, p(v_scale) if scaled else null,
        p(k_new), p(v_new), p(ks_new) if scaled else null, p(vs_new) if scaled else null,
        p(rows), p(slots), B, R, Hc, S, row_bytes, Hs, scale_bytes, layer, backend.stream())
    backend.check(err, "kv_cache_write")
    kv_cache_write.launches += 1


kv_cache_write.launches = 0
