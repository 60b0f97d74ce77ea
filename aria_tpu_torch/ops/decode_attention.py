"""Decode attention over the stacked KV cache (counterpart of
aria_tpu/ops/decode_attention.py).

One query per (lane, head) attends the keys at positions < lengths[lane]
of layer ``layer`` of a [L, B, H, S, D] cache, bf16 or int8 with f32
per-(head, position) scales [L, B, H, S]; or of a packed-int4 cache
[L, B, H/2, S, D] int8 with bf16 scales [L, B, H, S], taken when the
scales have twice the cache's head planes (decode_attention.py:234-236).
Its bytes hold head h in the low nibble as (value + 8) and head h + H/2
in the high nibble (``unpack_heads``).

Kernel: ``csrc/decode_attention.cu``, one CUDA kernel in three forms of
cache (bf16, int8, packed int4) and two of output (normal, stats). It
replaces ``decode_attention`` of aria_tpu/ops/decode_attention.py:208
(``_attend_block`` :26, ``_attend_block_p4`` :80, the stats form of
:221-226). It is bound by the cache read, so the grid is split over
positions as well as heads and lanes: ``split_count(B, heads, S, sms)``
splits (from the shapes and the card's SM count alone; ``lengths`` lies on
the device and is never read on the host), each block staging its chunk's key and value rows in shared
memory with bulk copies, and the block that finishes a (lane, head) last
merging the partials (acc, m, s) exactly, in the same launch. Block row y
takes the y-th longest lane (read on the device), so the long lanes start
first and a lane's bits do not depend on which block computes it. The packed
int4 cache is read once for both heads of a pair (one block per pair).

``decode_attention_stats`` (``return_stats=True``, decode_attention.py:
221-226) is the stats form: the unnormalised f32 accumulator with the
running max and the denominator, which context-parallel decode merges
across the ranks' blocks of positions (``parallel/cp_cache.py``). It
counts its launches apart from the normal form's. Each wrapper counts one
launch per call, whatever the split.

``decode_attention_split_plain`` renders the split in plain torch: the
stats form over each chunk, merged as cp_cache.py merges the ranks'
blocks. The tests hold it against the JAX kernel.

Numerics as in the JAX kernel: q is scaled by 1/sqrt(D) in f32 and cast
to bf16 (to q's dtype for a bf16 cache); a quantized cache multiplies the
scores by k_scale and the probabilities by v_scale, the denominator sums
the probabilities before v_scale; the output is bf16 for a quantized
cache. With an int8 or int4 cache p * v_scale rounds to bf16 before it
multiplies v; the plain version (like the JAX kernel) also rounds p for a
bf16 cache, which the kernel keeps in f32 (its source says why).
"""

from __future__ import annotations

from typing import Optional

import torch

from aria_tpu_torch.ops import backend
from aria_tpu_torch.ops._build import library

NEG_INF = -1e30
HEAD_DIM = 128  # the kernel's head width
SPLIT_UNIT = 256  # positions: at most ceil(S / SPLIT_UNIT) splits
SPLIT_ALIGN = 64  # positions: the chunks' boundaries (the kernel's tile)


def split_count(B: int, heads: int, S: int, sms: int) -> int:
    """P, the kernel's splits over positions, from the lanes ``B``, the
    blocks per lane ``heads`` (heads, or head pairs of an int4 cache), the
    cache capacity ``S`` and the card's SM count ``sms`` (132 on an H100
    SXM): enough blocks for two on every SM, at least ``SPLIT_UNIT``
    positions a split."""
    units = -(-S // SPLIT_UNIT)
    return max(1, min(units, -(-2 * sms // (B * heads))))


def split_bounds(S: int, P: int) -> list[tuple[int, int]]:
    """The positions [start, end) of each of the P splits: split i takes the
    tiles [i U / P, (i + 1) U / P) of U = ceil(S / SPLIT_ALIGN), so the
    chunks differ by at most one tile and together cover [0, S) exactly."""
    if not 1 <= P <= -(-S // SPLIT_UNIT):
        raise ValueError(f"decode_attention: {P} splits of a {S}-position cache")
    return chunk_bounds(S, P)


def chunk_bounds(S: int, P: int) -> list[tuple[int, int]]:
    """The kernel's chunks for any P up to one per SPLIT_ALIGN positions
    (``split_bounds`` without its floor of SPLIT_UNIT positions a split;
    the paged form's plan, ``paged_attention.paged_split_count``, takes
    smaller chunks)."""
    tiles = -(-S // SPLIT_ALIGN)
    if not 1 <= P <= tiles:
        raise ValueError(f"decode_attention: {P} chunks of {S} positions")
    return [(SPLIT_ALIGN * (i * tiles // P), min(S, SPLIT_ALIGN * ((i + 1) * tiles // P)))
            for i in range(P)]


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


def cached_attention_plain(
    q: torch.Tensor,  # [B, S, H, D]: S new tokens a lane
    k_cache: torch.Tensor,  # [L, B, H, S_max, D] (H/2 packed int4)
    v_cache: torch.Tensor,
    layer: int,
    mask: torch.Tensor,  # [B, 1, S, S_max] bool: token i of lane b attends these positions
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Several new tokens a lane over the written cache, in plain torch (no
    kernel: the JAX package attends them in XLA, moe_lm.py:617-642): [B, S,
    H, D]. Each query row takes ``decode_attention_plain``'s roundings (q
    scaled and cast, the scores times k_scale, the probabilities times
    v_scale cast before p.v, a bf16 output for a quantized cache), so the
    speculative verify step over k + 1 tokens computes what k + 1 decode
    steps compute, up to the order of the sums."""
    quantized = k_scale is not None
    cdt = torch.bfloat16 if quantized else q.dtype
    qs = _scaled_query(q, quantized)
    k, v = k_cache[layer], v_cache[layer]
    if is_packed4(k_cache, k_scale):
        k, v = unpack_heads(k), unpack_heads(v)
    k, v = k.to(cdt).float(), v.to(cdt).float()  # [B, H, S_max, D]
    scores = torch.einsum("bshd,bhtd->bhst", qs.float(), k)
    if quantized:
        scores = scores * k_scale[layer].float()[:, :, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1)  # [B, H, S]
    pv = (p * v_scale[layer].float()[:, :, None, :] if quantized else p).to(cdt).float()
    acc = torch.einsum("bhst,bhtd->bshd", pv, v)
    return (acc / denom.transpose(1, 2)[..., None]).to(torch.bfloat16 if quantized else q.dtype)


def merge_partials(parts):
    """The exact merge of partial (acc, m, s) over disjoint blocks of
    positions, as ``parallel/cp_cache.py`` merges the ranks': m = max m_i,
    acc = sum acc_i exp(m_i - m), s = sum s_i exp(m_i - m), in f32."""
    m = torch.stack([p[1] for p in parts]).amax(0)
    corr = [torch.exp(p[1] - m) for p in parts]
    acc = sum(p[0] * c[..., None] for p, c in zip(parts, corr))
    s = sum(p[2] * c for p, c in zip(parts, corr))
    return acc, m, s


def split_partials(q, k_cache, v_cache, layer, lengths, k_scale=None, v_scale=None,
                   splits: int = 1, bounds=None):
    """The kernel's partials in plain torch: ``decode_attention_plain``'s
    stats form over each chunk of ``split_bounds(S, splits)`` (or of
    ``bounds``), at the lengths clipped to the chunk."""
    parts = []
    for start, end in bounds or split_bounds(k_cache.shape[3], splits):
        local = [None if t is None else t[:, :, :, start:end]
                 for t in (k_cache, v_cache, k_scale, v_scale)]
        len_loc = torch.clamp(lengths - start, 0, end - start).to(lengths.dtype)
        parts.append(decode_attention_plain(q, local[0], local[1], layer, len_loc, local[2],
                                            local[3], return_stats=True))
    return parts


def decode_attention_split_plain(q, k_cache, v_cache, layer, lengths, k_scale=None,
                                 v_scale=None, splits: int = 1, return_stats: bool = False):
    """The kernel's split in plain torch: ``split_partials`` merged by
    ``merge_partials``. The normal form is acc / s rounded to the output
    dtype, 0 for a lane of length 0."""
    acc, m, s = merge_partials(split_partials(q, k_cache, v_cache, layer, lengths, k_scale,
                                              v_scale, splits))
    if return_stats:
        return acc, m, s
    out = torch.where(s[..., None] > 0, acc / torch.clamp_min(s, 1e-30)[..., None], 0.0)
    return out.to(torch.bfloat16 if k_scale is not None else q.dtype)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    layer: int,
    lengths: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    return_stats: bool = False,
    *,
    splits: Optional[int] = None,
):
    """Returns [B, H, D]: bf16 for a quantized cache, q's dtype for a bf16
    one. With ``return_stats``, (acc, m, s) through
    ``decode_attention_stats``. ``splits`` forces the kernel's split over
    positions (tests and ``chip_smoke.py``); None takes ``split_count``."""
    if return_stats:
        return decode_attention_stats(q, k_cache, v_cache, layer, lengths, k_scale, v_scale,
                                      splits=splits)
    quantized = k_scale is not None
    extra = (k_scale, v_scale) if quantized else ()
    if not backend.on_cuda(q, k_cache, v_cache, lengths, *extra):
        return decode_attention_plain(q, k_cache, v_cache, layer, lengths, k_scale, v_scale)
    if is_packed4(k_cache, k_scale):
        return decode_attention_int4(q, k_cache, v_cache, layer, lengths, k_scale, v_scale,
                                     splits=splits)
    out = _launch(q, k_cache, v_cache, layer, lengths, k_scale, v_scale, False, splits)
    decode_attention.launches += 1
    return out


def decode_attention_int4(q, k_cache, v_cache, layer, lengths, k_scale, v_scale, *,
                          splits: Optional[int] = None):
    """The packed-int4 form (``decode_attention`` takes it for such a
    cache); it counts its own launches."""
    if not backend.on_cuda(q, k_cache, v_cache, lengths, k_scale, v_scale):
        return decode_attention_plain(q, k_cache, v_cache, layer, lengths, k_scale, v_scale)
    out = _launch(q, k_cache, v_cache, layer, lengths, k_scale, v_scale, False, splits)
    decode_attention_int4.launches += 1
    return out


def decode_attention_stats(q, k_cache, v_cache, layer, lengths, k_scale=None, v_scale=None, *,
                           splits: Optional[int] = None):
    """The stats form (decode_attention.py:221-226) for a bf16, int8 or
    packed-int4 cache: (acc [B, H, D] f32 unnormalised, m [B, H] f32, s
    [B, H] f32), acc / s being the attention output before its rounding.
    A lane of length 0 gives m = NEG_INF (finite) and acc = s = 0. It
    counts its own launches, whatever the cache's form."""
    extra = (k_scale, v_scale) if k_scale is not None else ()
    if not backend.on_cuda(q, k_cache, v_cache, lengths, *extra):
        return decode_attention_plain(q, k_cache, v_cache, layer, lengths, k_scale, v_scale,
                                      return_stats=True)
    out = _launch(q, k_cache, v_cache, layer, lengths, k_scale, v_scale, True, splits)
    decode_attention_stats.launches += 1
    return out


def _launch(q, k_cache, v_cache, layer, lengths, k_scale, v_scale, stats: bool,
            splits: Optional[int]):
    """Check the arguments and launch the kernel in the cache's form (bf16,
    int8 or packed int4), normal or stats, split over positions."""
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
    if quantized and S % 8:
        raise ValueError(f"decode_attention: a quantized cache of {S} positions; the kernel "
                         "stages the scales in 16-byte copies and takes S % 8 == 0")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache), ("k_scale", k_scale),
                    ("v_scale", v_scale)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} is not 16-byte aligned")
    # a bf16 query is scaled in the kernel, by the same f32 product and bf16
    # rounding as _scaled_query (three elementwise launches fewer a call)
    qs, qscale = q.contiguous(), 1.0 / D**0.5
    if q.dtype != torch.bfloat16:
        qs, qscale = _scaled_query(q, quantized).contiguous(), 1.0
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
    P = split_count(B, Hc, S, backend.sm_count(q.device)) if splits is None else splits
    if not 1 <= P <= -(-S // SPLIT_UNIT):
        raise ValueError(f"decode_attention: {P} splits of a {S}-position cache")
    ws = cnt = None
    if P > 1:
        ws, cnt = backend.workspace(q.device, B * Hc * P * (H // Hc) * (D + 2), B * Hc)
    kind = 2 if packed else int(quantized)
    err = library().aria_decode_attention(
        p(qs), p(k_cache), p(v_cache), p(k_scale) if quantized else null,
        p(v_scale) if quantized else null, p(lengths), p(out), p(acc), p(m), p(s), p(ws),
        p(cnt), B, Hc, S, layer, kind, P, qscale, backend.stream())
    backend.check(err, "decode_attention" + (" (int4)" if packed else "")
                  + (" stats" if stats else ""))
    return res


decode_attention.launches = 0
decode_attention_int4.launches = 0
decode_attention_stats.launches = 0
