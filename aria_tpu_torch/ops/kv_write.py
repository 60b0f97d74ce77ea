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

``rope_kv_write`` is the same write fused with what feeds it: one launch a
layer takes the wqkv projection's f32 output, rounds it to the activation
dtype, rotates q and k (``apply_rope``), quantizes k and v in the cache's
form (``quantize_kv``), writes them at one (row, slot) a token, and hands
attention its rotated query (decode attention scales it in its kernel),
or the fresh q, k and v of a from-zero prefill for causal flash. The decode step (lanes or pages)
and the from-zero prefill take it; the serving mesh's writers, a per-lane
write of several positions and the paged chunk keep the chain of
``apply_rope``, ``quantize_kv`` and ``kv_cache_write``, which
``rope_kv_write_plain`` calls as they are.
"""

from __future__ import annotations

from typing import Optional

import torch

from aria_tpu_torch.ops import backend
from aria_tpu_torch.ops._build import library
from aria_tpu_torch.ops.decode_attention import HEAD_DIM
from aria_tpu_torch.ops.rope import LONG_SEQ, apply_rope


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


def quantize_kv(cache, k_t: torch.Tensor, v_t: torch.Tensor):
    """k/v [B, H, S, D] in the cache's form (moe_lm.py:435-471): returns
    (k, v, k_scale, v_scale), the scales None for a bf16 cache. ``cache``
    is a ``KVCache`` or a ``PagedKVCache``.

    int8 quantizes in f32; int4 takes the scale amax/7 to bf16 and then
    divides and rounds in bf16, as the JAX source does, and packs head
    pairs (``pack_heads``, moe_lm.py:460-463). The JAX source's division
    of the amax by a constant is a reciprocal multiply under jit."""
    if not cache.quantized:
        return k_t.to(cache.k.dtype), v_t.to(cache.v.dtype), None, None
    amax = [torch.clamp_min(t.float().abs().amax(dim=-1), 1e-6) for t in (k_t, v_t)]
    if not cache.packed4:
        scales = [a * (1.0 / 127.0) for a in amax]
        return (*(torch.round(t.float() / sc[..., None]).to(torch.int8)
                  for t, sc in zip((k_t, v_t), scales)), *scales)
    scales = [(a * (1.0 / 7.0)).to(torch.bfloat16) for a in amax]
    packed = []
    for t, sc in zip((k_t, v_t), scales):
        q = torch.round((t.to(torch.bfloat16) / sc[..., None]).float())
        q = torch.clamp(q, -8, 7).to(torch.int8)
        half = q.shape[1] // 2
        packed.append(((q[:, :half] + 8) & 0xF) | (q[:, half:] << 4))
    return (*packed, *scales)


def rope_kv_write_plain(qkv, cos, sin, cache, layer: int, rows, slots, heads: int,
                        dtype=torch.bfloat16, *, fresh: bool, null_page: bool = False):
    """The chain the kernel fuses, called as it is: ``qkv.to(dtype)``,
    ``apply_rope`` on q and k, ``quantize_kv``, ``kv_cache_write_plain``
    over the tokens (a paged null page's writes to slot 0 first, as
    ``paged_write``)."""
    B, S, _ = qkv.shape
    D = qkv.shape[-1] // (3 * heads)
    x = qkv.to(dtype)
    q, k, v = (x[..., i * heads * D:(i + 1) * heads * D].reshape(B, S, heads, D)
               for i in range(3))
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    kq, vq, ks, vs = quantize_kv(cache, k.transpose(1, 2), v.transpose(1, 2))  # [B, H, S, ...]
    if null_page:
        slots = torch.where(rows == 0, torch.zeros_like(slots), slots)
    # token-major: [B * S, Hc, D] rows, [B * S, Hs] scales
    kq, vq = kq.transpose(1, 2).flatten(0, 1), vq.transpose(1, 2).flatten(0, 1)
    scales = ()
    if cache.quantized:
        scales = (cache.k_scale, cache.v_scale, ks.transpose(1, 2).flatten(0, 1),
                  vs.transpose(1, 2).flatten(0, 1))
    kv_cache_write_plain(cache.k, cache.v, layer, rows, slots, kq, vq, *scales)
    if fresh:
        return q, k, v.contiguous()
    return q, None, None


def rope_kv_write(
    qkv: torch.Tensor,  # [B, S, 3 * heads * D] f32: the wqkv projection (+ any LoRA delta)
    cos: torch.Tensor,  # [S, D/2] or [B, S, D/2] f32 (precompute_rope)
    sin: torch.Tensor,
    cache,  # KVCache or PagedKVCache, written in place
    layer: int,
    rows: torch.Tensor,  # [B * S] int32 destination row (lane or page) per token
    slots: torch.Tensor,  # [B * S] int32 destination position per token
    heads: int,
    dtype: torch.dtype = torch.bfloat16,  # the activations' dtype
    *,
    fresh: bool,
    null_page: bool = False,
):
    """Returns (q, k, v), each [B, S, heads, D] in ``dtype``: with
    ``fresh`` the rotated q and k and v (causal flash's inputs); else the
    rotated q and k = v = None. ``null_page``: a token whose row
    is page 0 writes slot 0 (``paged_write``). A token whose row or slot
    lies outside the cache writes nothing. CPU tensors take the plain
    version, CUDA tensors the kernel."""
    scales = (cache.k_scale, cache.v_scale) if cache.quantized else ()
    if not backend.on_cuda(qkv, cos, sin, cache.k, cache.v, rows, slots, *scales):
        return rope_kv_write_plain(qkv, cos, sin, cache, layer, rows, slots, heads, dtype,
                                   fresh=fresh, null_page=null_page)
    B, S, W = qkv.shape
    T = B * S
    L, R, Hc, Smax, D = cache.k.shape
    packed = cache.packed4
    if D != HEAD_DIM:
        raise ValueError(f"rope_kv_write: head dim {D}, the kernel takes {HEAD_DIM}")
    if heads % 2 or W != 3 * heads * D or Hc != (heads // 2 if packed else heads):
        raise ValueError(f"rope_kv_write: qkv width {W} for {heads} heads over {Hc} cache "
                         "planes (MHA, an even head count: a block takes heads h and h + H/2)")
    if dtype != torch.bfloat16:
        raise TypeError(f"rope_kv_write: activations {dtype}, the kernel takes bf16")
    if not 0 <= layer < L:
        raise IndexError(f"rope_kv_write: layer {layer} of {L}")
    if tuple(cos.shape[:-1]) not in ((S,), (B, S)):
        raise ValueError(f"rope_kv_write: cos {tuple(cos.shape)} for [{B}, {S}] tokens")
    backend.require(qkv, "qkv", torch.float32, (B, S, W))
    backend.require(cos, "cos", torch.float32, (*cos.shape[:-1], D // 2))
    backend.require(sin, "sin", torch.float32, tuple(cos.shape))
    cache_dtype = torch.int8 if cache.quantized else torch.bfloat16
    backend.require(cache.k, "k_cache", cache_dtype, (L, R, Hc, Smax, D))
    backend.require(cache.v, "v_cache", cache_dtype, (L, R, Hc, Smax, D))
    if cache.quantized:
        sdt = torch.bfloat16 if packed else torch.float32
        backend.require(cache.k_scale, "k_scale", sdt, (L, R, heads, Smax))
        backend.require(cache.v_scale, "v_scale", sdt, (L, R, heads, Smax))
    backend.require(rows, "rows", torch.int32, (T,))
    backend.require(slots, "slots", torch.int32, (T,))
    if any(t.data_ptr() % 16 for t in (qkv, cache.k, cache.v)) or any(
            t.data_ptr() % 8 for t in (cos, sin)):
        raise ValueError("rope_kv_write: qkv and the cache must be 16-byte aligned, cos and "
                         "sin 8-byte")
    q = torch.empty((B, S, heads, D), dtype=torch.bfloat16, device=qkv.device)
    k = v = None
    if fresh:
        k, v = torch.empty_like(q), torch.empty_like(q)
    if T == 0:
        return q, k, v
    p, null = backend.ptr, backend.ptr(None)
    mode = 2 if packed else int(cache.quantized)
    err = library().aria_rope_kv_write(
        p(qkv), p(cos), p(sin), p(cache.k), p(cache.v), p(cache.k_scale) if scales else null,
        p(cache.v_scale) if scales else null, p(rows), p(slots), p(q), p(k), p(v), T,
        cos.numel() // (D // 2), heads, R, Smax, layer, mode, int(S >= LONG_SEQ),
        int(null_page), backend.stream())
    backend.check(err, "rope_kv_write")
    rope_kv_write.launches += 1
    return q, k, v


rope_kv_write.launches = 0
