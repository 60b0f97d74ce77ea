"""Decode attention over the stacked KV cache (counterpart of
aria_tpu/ops/decode_attention.py).

One query per (lane, head) attends the keys at positions < lengths[lane]
of layer ``layer`` of a [L, B, H, S, D] cache, bf16 or int8 with f32
per-(head, position) scales [L, B, H, S]; or of a packed-int4 cache
[L, B, H/2, S, D] int8 with bf16 scales [L, B, H, S], taken when the
scales have twice the cache's head planes (decode_attention.py:234-236).
Its bytes hold head h in the low nibble as (value + 8) and head h + H/2
in the high nibble (``unpack_heads``).

Kernel: ``csrc/decode_attention.cu``. It replaces ``decode_attention`` of
aria_tpu/ops/decode_attention.py:208 (``_make_kernel`` :154,
``_attend_block`` :26) for bf16 and int8 caches. It reads 2*len*D bytes
per head (int8) against about 4 FLOPs per byte, so it is bound by the
cache read; one block per (head, lane) runs an online softmax over tiles
of 32 positions and skips every position at or past the lane's length.

The packed-int4 cache has a kernel of its own in the same source
(``decode_attention_p4_kernel``), replacing ``_attend_block_p4``
(decode_attention.py:80): one block per (head pair, lane) reads each byte
once for both heads and unpacks the nibbles in registers.

``decode_attention_stats`` (``return_stats=True``, decode_attention.py:
221-226) runs either kernel in its stats form: the unnormalised f32
accumulator with the running max and the denominator, which
context-parallel decode merges across the ranks' blocks of positions
(``parallel/cp_cache.py``). It counts its launches apart from the normal
form's.

Numerics as in the JAX kernel: q is scaled by 1/sqrt(D) in f32 and cast
to bf16 (to q's dtype for a bf16 cache); a quantized cache multiplies the
scores by k_scale and the probabilities by v_scale, the denominator sums
the probabilities before v_scale; the output is bf16 for a quantized
cache. With int4, p * v_scale rounds to bf16 before it multiplies v.
"""

from __future__ import annotations

from typing import Optional

import torch

from aria_tpu_torch.ops import backend
from aria_tpu_torch.ops._build import library

NEG_INF = -1e30
HEAD_DIM = 128  # the kernel's head width


def _scaled_query(q: torch.Tensor, quantized: bool) -> torch.Tensor:
    scale = 1.0 / (q.shape[-1] ** 0.5)
    return (q.float() * scale).to(torch.bfloat16 if quantized else q.dtype)


def unpack_heads(packed: torch.Tensor) -> torch.Tensor:
    """[..., H/2, S, D] biased-lo bytes -> [..., H, S, D] int8 values in
    [-8, 7] (moe_lm.py:625-629): the low nibble less 8, then the high
    nibble by an arithmetic shift of the signed byte."""
    lo = (packed & 0xF) - 8
    hi = packed >> 4
    return torch.cat([lo, hi], dim=-3).to(torch.int8)


def is_packed4(k_cache: torch.Tensor, k_scale: Optional[torch.Tensor]) -> bool:
    return k_scale is not None and k_scale.shape[2] == 2 * k_cache.shape[2]


def decode_attention_plain(
    q: torch.Tensor,  # [B, H, D]
    k_cache: torch.Tensor,  # [L, B, H, S, D]
    v_cache: torch.Tensor,
    layer: int,
    lengths: torch.Tensor,  # [B] int32
    k_scale: Optional[torch.Tensor] = None,  # [L, B, H, S]: f32 int8, bf16 int4
    v_scale: Optional[torch.Tensor] = None,
    return_stats: bool = False,
):
    """[B, H, D]; with ``return_stats``, the unnormalised accumulator
    (acc [B, H, D] f32, m [B, H] f32, s [B, H] f32) that
    ``parallel/cp_cache.py`` merges: acc / s is the output before its
    rounding. A lane of length 0 gives m = NEG_INF and acc = s = 0."""
    quantized = k_scale is not None
    cdt = torch.bfloat16 if quantized else q.dtype
    qs = _scaled_query(q, quantized)
    k, v = k_cache[layer], v_cache[layer]
    if is_packed4(k_cache, k_scale):
        k, v = unpack_heads(k), unpack_heads(v)
    k, v = k.to(cdt).float(), v.to(cdt).float()  # [B, H, S, D]
    scores = torch.einsum("bhd,bhsd->bhs", qs.float(), k)
    if quantized:
        scores = scores * k_scale[layer].float()
    pos = torch.arange(k.shape[2], device=q.device)
    valid = pos[None, None, :] < lengths[:, None, None]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    if return_stats:  # an empty lane sums nothing (the kernels skip it)
        p = torch.where(valid, p, torch.zeros_like(p))
    denom = p.sum(dim=-1, keepdim=True)
    pv = (p * v_scale[layer].float() if quantized else p).to(cdt).float()
    acc = torch.einsum("bhs,bhsd->bhd", pv, v)
    if return_stats:
        return acc, m[..., 0], denom[..., 0]
    return (acc / denom).to(torch.bfloat16 if quantized else q.dtype)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    layer: int,
    lengths: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    return_stats: bool = False,
):
    """Returns [B, H, D]: bf16 for a quantized cache, q's dtype for a bf16
    one. With ``return_stats``, (acc, m, s) through
    ``decode_attention_stats``."""
    if return_stats:
        return decode_attention_stats(q, k_cache, v_cache, layer, lengths, k_scale, v_scale)
    quantized = k_scale is not None
    extra = (k_scale, v_scale) if quantized else ()
    if not backend.on_cuda(q, k_cache, v_cache, lengths, *extra):
        return decode_attention_plain(q, k_cache, v_cache, layer, lengths, k_scale, v_scale)
    if is_packed4(k_cache, k_scale):
        return decode_attention_int4(q, k_cache, v_cache, layer, lengths, k_scale, v_scale)
    out = _launch(q, k_cache, v_cache, layer, lengths, k_scale, v_scale, stats=False)
    decode_attention.launches += 1
    return out


def decode_attention_int4(q, k_cache, v_cache, layer, lengths, k_scale, v_scale):
    """The packed-int4 kernel (``decode_attention`` takes it for such a
    cache); it counts its own launches."""
    if not backend.on_cuda(q, k_cache, v_cache, lengths, k_scale, v_scale):
        return decode_attention_plain(q, k_cache, v_cache, layer, lengths, k_scale, v_scale)
    out = _launch(q, k_cache, v_cache, layer, lengths, k_scale, v_scale, stats=False)
    decode_attention_int4.launches += 1
    return out


def decode_attention_stats(q, k_cache, v_cache, layer, lengths, k_scale=None, v_scale=None):
    """The stats form (decode_attention.py:221-226) for a bf16, int8 or
    packed-int4 cache: (acc [B, H, D] f32 unnormalised, m [B, H] f32, s
    [B, H] f32), acc / s being the attention output before its rounding.
    A lane of length 0 gives m = NEG_INF (finite) and acc = s = 0. It
    counts its own launches, whatever the cache's form."""
    extra = (k_scale, v_scale) if k_scale is not None else ()
    if not backend.on_cuda(q, k_cache, v_cache, lengths, *extra):
        return decode_attention_plain(q, k_cache, v_cache, layer, lengths, k_scale, v_scale,
                                      return_stats=True)
    out = _launch(q, k_cache, v_cache, layer, lengths, k_scale, v_scale, stats=True)
    decode_attention_stats.launches += 1
    return out


def _launch(q, k_cache, v_cache, layer, lengths, k_scale, v_scale, stats: bool):
    """Check the arguments and launch the kernel of the cache's form: the
    bf16 / int8 kernel or the packed-int4 one, normal or stats."""
    quantized = k_scale is not None
    packed = is_packed4(k_cache, k_scale)
    B, H, D = q.shape
    L, _, Hc, S, _ = k_cache.shape
    if D != HEAD_DIM:
        raise ValueError(f"decode_attention: head dim {D}, the kernel takes {HEAD_DIM}")
    if packed and H != 2 * Hc:
        raise ValueError(f"decode_attention: {H} query heads over {Hc} packed head pairs")
    if not 0 <= layer < L:
        raise IndexError(f"decode_attention: layer {layer} of {L}")
    cache_dtype = torch.int8 if quantized else torch.bfloat16
    backend.require(k_cache, "k_cache", cache_dtype, (L, B, H // 2 if packed else H, S, D))
    backend.require(v_cache, "v_cache", cache_dtype, (L, B, H // 2 if packed else H, S, D))
    backend.require(lengths, "lengths", torch.int32, (B,))
    if quantized:
        sdt = torch.bfloat16 if packed else torch.float32
        backend.require(k_scale, "k_scale", sdt, (L, B, H, S))
        backend.require(v_scale, "v_scale", sdt, (L, B, H, S))
    qs = _scaled_query(q, quantized).contiguous()
    backend.require(qs, "q", torch.bfloat16, (B, H, D))
    p, null = backend.ptr, backend.ptr(None)
    if stats:
        acc = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
        m = torch.empty((B, H), dtype=torch.float32, device=q.device)
        s = torch.empty((B, H), dtype=torch.float32, device=q.device)
        out, res = None, (acc, m, s)
    else:
        out = torch.empty((B, H, D), dtype=torch.bfloat16, device=q.device)
        acc = m = s = None
        res = out
    outs = (p(out), p(acc), p(m), p(s))
    if packed:
        err = library().aria_decode_attention_p4(
            p(qs), p(k_cache), p(v_cache), p(k_scale), p(v_scale), p(lengths), *outs,
            B, Hc, S, layer, backend.stream())
    else:
        err = library().aria_decode_attention(
            p(qs), p(k_cache), p(v_cache), p(k_scale) if quantized else null,
            p(v_scale) if quantized else null, p(lengths), *outs, B, H, S, layer,
            int(quantized), backend.stream())
    backend.check(err, "decode_attention" + (" (int4)" if packed else "")
                  + (" stats" if stats else ""))
    return res


decode_attention.launches = 0
decode_attention_int4.launches = 0
decode_attention_stats.launches = 0
