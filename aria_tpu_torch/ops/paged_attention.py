"""The paged KV cache and decode attention through a page table
(counterpart of aria_tpu/engine/paged.py:1-227; the page allocator is
``engine/paged.py``).

Lanes draw fixed-size pages from one shared pool instead of owning a
contiguous [S_max] stripe, so device memory scales with the tokens in
flight, not with lanes x max_seq_len.

Layout: ``[L, NP, H, PS, D]``, bf16 (or f32 on the CPU) or int8 with f32
scales ``[L, NP, H, PS]`` (amax/127 over D at write time). A lane's page
table row ``[MAXP]`` lists its pages in logical order; page 0 is the
reserved null page that unallocated entries point at, and positions at or
past a lane's length are masked, so nothing read from it counts.

A decode step writes one position per lane through the fused prologue
``rope_kv_write`` (``ops/kv_write.py``) with rows = page ids; a prefill
chunk writes C positions per lane by an indexed write. A position past
the table (a lane can run past S inside a decode chunk) resolves to page
-1 and is dropped, as the JAX package's scatter drops its out-of-range
index.

Kernel: ``csrc/decode_attention.cu`` (``aria_paged_decode_attention``),
the decode-attention kernel body read through the page table. It replaces
``paged_decode_attention`` of aria_tpu/engine/paged.py:150 (``_kernel``
:117, ``_kernel_q`` :132, on ``_attend_block`` of
ops/decode_attention.py:26). The grid is (heads, lanes, P), split over the
MAXP * PS positions by ``paged_split_count`` (from the shapes and the
card's SM count alone: never from ``lengths``, which lies on the device,
so the grid is fixed for a given batch), block row y taking the y-th
longest lane; each block brings its chunk's
32-position tiles from the pages the table names with bulk copies into a
shared-memory ring, a block past its lane's length writes the empty
partial at once, and the last block of a (lane, head) merges the P
partials in split order, so a lane's bits do not depend on the other
lanes. A page id outside the pool is read as masked rather than followed;
a lane's length is capped at MAXP * PS; a lane of length 0 gives 0.
Numerics as the TPU kernel: q scaled by 1/sqrt(D) in f32 and cast to bf16
(int8 pages) or q's dtype (a bf16 query in the kernel), scores times
k_scale, the denominator summing p before v_scale, ``p * v_scale`` rounded
to the compute dtype before it multiplies v; bf16 output for int8 pages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from aria_tpu_torch.config import TextConfig
from aria_tpu_torch.ops import backend
from aria_tpu_torch.ops._build import library
from aria_tpu_torch.ops.decode_attention import (HEAD_DIM, SPLIT_ALIGN, _scaled_query,
                                                 chunk_bounds, decode_attention_plain,
                                                 merge_partials, split_partials)
from aria_tpu_torch.ops.kv_write import kv_cache_write

TILE = 32  # positions per tile of the kernel: a page holds whole tiles
PAGED_CHUNK = 128  # positions: the shortest chunk of the split


@dataclasses.dataclass
class PagedKVCache:
    k: torch.Tensor  # [L, NP, H, PS, D]
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None  # f32 [L, NP, H, PS] for int8 pages
    v_scale: Optional[torch.Tensor] = None

    @staticmethod
    def init(cfg: TextConfig, num_pages: int, page_size: int, dtype=torch.bfloat16,
             device="cuda") -> "PagedKVCache":
        """On the card unless ``device`` names another. The JAX package has
        no int4 pages (its paged write never packs), so ``"int4"`` raises."""
        if dtype == "int4":
            raise NotImplementedError("int4 pages: the paged cache is bf16 or int8")
        device = backend.device(device)
        shape = (cfg.num_layers, num_pages, cfg.num_kv_heads, page_size, cfg.head_dim)
        k = torch.zeros(shape, dtype=dtype, device=device)
        v = torch.zeros(shape, dtype=dtype, device=device)
        if dtype == torch.int8:
            return PagedKVCache(k, v, torch.ones(shape[:-1], device=device),
                                torch.ones(shape[:-1], device=device))
        return PagedKVCache(k, v)

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    packed4 = False  # ``quantize_kv`` asks; pages are never int4

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]


def write_index(page_table: torch.Tensor, pos: torch.Tensor, S: int, page_size: int):
    """Where S consecutive positions from ``pos[b]`` go: (pages, slots),
    int32 [B, S]; a position past the table gets page -1."""
    maxp = page_table.shape[1]
    logical = pos.long()[:, None] + torch.arange(S, device=pos.device)[None, :]
    blk = logical // page_size
    pages = torch.gather(page_table, 1, blk.clamp(max=maxp - 1))
    pages = torch.where(blk < maxp, pages, torch.full_like(pages, -1))
    return pages.to(torch.int32), (logical % page_size).to(torch.int32)


def paged_write(cache: PagedKVCache, layer: int, pages: torch.Tensor, slots: torch.Tensor,
                k_t: torch.Tensor, v_t: torch.Tensor, k_sc: Optional[torch.Tensor] = None,
                v_sc: Optional[torch.Tensor] = None) -> None:
    """Write k/v [B, H, S, D] (in the cache's dtype; scales [B, H, S]) in
    place at ``write_index``'s pages and slots (paged.py:68-114).

    S == 1 goes through ``kv_cache_write`` with rows = page ids, scales in
    the same launch. Idle lanes' zeroed tables resolve to the null page 0
    at their frozen, differing positions; those writes go to slot 0
    (paged.py:99-100), and page 0 is never read. No serving path writes
    one position this way: the decode step takes the fused prologue
    ``rope_kv_write``, and this branch is the chain it replaced. S > 1 is
    an indexed write of the positions inside the table."""
    B, H, S, D = k_t.shape
    if S == 1:
        rows = pages[:, 0].contiguous()
        slot = torch.where(rows == 0, torch.zeros_like(rows), slots[:, 0]).contiguous()
        scales = (cache.k_scale, cache.v_scale, k_sc[:, :, 0].contiguous(),
                  v_sc[:, :, 0].contiguous()) if cache.quantized else ()
        kv_cache_write(cache.k, cache.v, layer, rows, slot, k_t[:, :, 0].contiguous(),
                       v_t[:, :, 0].contiguous(), *scales)
        return
    b, s = torch.nonzero(pages >= 0, as_tuple=True)
    p, sl = pages[b, s].long()[:, None], slots[b, s].long()[:, None]
    h = torch.arange(H, device=k_t.device)[None, :]
    cache.k[layer, p, h, sl] = k_t[b, :, s]  # [n, H, D]
    cache.v[layer, p, h, sl] = v_t[b, :, s]
    if cache.quantized:
        cache.k_scale[layer, p, h, sl] = k_sc[b, :, s]
        cache.v_scale[layer, p, h, sl] = v_sc[b, :, s]


def _lane_rows(t: torch.Tensor, layer: int, page_table: torch.Tensor) -> torch.Tensor:
    """[L, NP, H, PS, ...] -> each lane's logical [B, H, MAXP*PS, ...]."""
    x = t[layer][page_table.long()]  # [B, MAXP, H, PS, ...]
    B, maxp, H, PS = x.shape[:4]
    return x.transpose(1, 2).reshape(B, H, maxp * PS, *x.shape[4:])


def gather_lane_kv(cache: PagedKVCache, layer: int, page_table: torch.Tensor):
    """Each lane's logical k/v [B, H, MAXP*PS, D], dequantized to f32 for
    int8 pages (paged.py:210-227): the prefill chunk's read path."""
    k, v = _lane_rows(cache.k, layer, page_table), _lane_rows(cache.v, layer, page_table)
    if cache.quantized:
        k = k.float() * _lane_rows(cache.k_scale, layer, page_table)[..., None]
        v = v.float() * _lane_rows(cache.v_scale, layer, page_table)[..., None]
    return k, v


def paged_decode_attention_plain(q: torch.Tensor, cache: PagedKVCache, layer: int,
                                 page_table: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The lanes' pages gathered into a one-layer contiguous cache, then
    ``decode_attention_plain``'s masked f32 softmax with the same casts."""
    k, v = _lane_rows(cache.k, layer, page_table), _lane_rows(cache.v, layer, page_table)
    scales = ()
    if cache.quantized:
        scales = (_lane_rows(cache.k_scale, layer, page_table)[None],
                  _lane_rows(cache.v_scale, layer, page_table)[None])
    return decode_attention_plain(q, k[None], v[None], 0, lengths, *scales)


def paged_split_count(B: int, heads: int, maxp: int, page_size: int, sms: int) -> int:
    """P, the kernel's splits over a lane's ``maxp * page_size`` positions,
    from the shapes and the card's SM count alone (132 on an H100 SXM),
    never from the lengths: enough blocks for two on every SM, as
    ``decode_attention.split_count`` aims, with chunks of at least
    ``PAGED_CHUNK`` positions. The kernel starts the longest lanes first, so
    where the lanes alone fill the card (the paged path's 32 lanes x 20
    heads) one block a lane's head measured fastest; at a few lanes (4 x
    20) the split takes chunks of 128 (PERF.md §6)."""
    S = maxp * page_size
    return max(1, min(-(-S // PAGED_CHUNK), -(-2 * sms // (B * heads))))


def paged_split_bounds(maxp: int, page_size: int, P: int) -> list[tuple[int, int]]:
    """The positions [start, end) of each of the P splits of a lane's
    ``maxp * page_size`` positions: the decode kernel's chunks, boundaries
    at multiples of ``SPLIT_ALIGN``, covering them exactly."""
    return chunk_bounds(maxp * page_size, P)


def paged_decode_attention_split_plain(q, cache: PagedKVCache, layer: int, page_table,
                                       lengths, splits: int = 1) -> torch.Tensor:
    """The kernel's split in plain torch: the lanes' pages gathered, the
    stats form over each chunk of ``paged_split_bounds``, merged as the
    kernel's last block merges; 0 for a lane of length 0."""
    k, v = _lane_rows(cache.k, layer, page_table), _lane_rows(cache.v, layer, page_table)
    scales = (None, None)
    if cache.quantized:
        scales = (_lane_rows(cache.k_scale, layer, page_table)[None],
                  _lane_rows(cache.v_scale, layer, page_table)[None])
    maxp, PS = page_table.shape[1], cache.page_size
    lengths = torch.clamp(lengths, max=maxp * PS).to(lengths.dtype)
    acc, m, s = merge_partials(split_partials(q, k[None], v[None], 0, lengths, *scales,
                                              bounds=paged_split_bounds(maxp, PS, splits)))
    out = torch.where(s[..., None] > 0, acc / torch.clamp_min(s, 1e-30)[..., None], 0.0)
    return out.to(torch.bfloat16 if cache.quantized else q.dtype)


def paged_decode_attention(q: torch.Tensor, cache: PagedKVCache, layer: int,
                           page_table: torch.Tensor, lengths: torch.Tensor, *,
                           splits: Optional[int] = None) -> torch.Tensor:
    """q [B, H, D] (unscaled) over each lane's pages up to lengths[b]:
    [B, H, D], bf16 for int8 pages, q's dtype for bf16 ones. ``splits``
    forces the kernel's split over positions (tests and ``chip_smoke.py``);
    None takes ``paged_split_count``."""
    extra = (cache.k_scale, cache.v_scale) if cache.quantized else ()
    if not backend.on_cuda(q, cache.k, cache.v, page_table, lengths, *extra):
        return paged_decode_attention_plain(q, cache, layer, page_table, lengths)
    out = _launch(q, cache, layer, page_table, lengths, splits)
    paged_decode_attention.launches += 1
    return out


def _launch(q, cache: PagedKVCache, layer: int, page_table, lengths, splits: Optional[int]):
    """Check the arguments, choose the split and launch the kernel."""
    quantized = cache.quantized
    B, H, D = q.shape
    L, NP, Hc, PS, _ = cache.k.shape
    maxp = page_table.shape[1]
    if D != HEAD_DIM:
        raise ValueError(f"paged_decode_attention: head dim {D}, the kernel takes {HEAD_DIM}")
    if Hc != H:
        raise ValueError(f"paged_decode_attention: {H} query heads over {Hc} cache heads (MHA only)")
    if PS % TILE:
        raise ValueError(f"paged_decode_attention: page size {PS}, not a multiple of {TILE}")
    if not 0 <= layer < L:
        raise IndexError(f"paged_decode_attention: layer {layer} of {L}")
    page_dtype = torch.int8 if quantized else torch.bfloat16
    backend.require(cache.k, "k pages", page_dtype, (L, NP, H, PS, D))
    backend.require(cache.v, "v pages", page_dtype, (L, NP, H, PS, D))
    backend.require(page_table, "page_table", torch.int32, (B, maxp))
    backend.require(lengths, "lengths", torch.int32, (B,))
    if quantized:
        backend.require(cache.k_scale, "k_scale", torch.float32, (L, NP, H, PS))
        backend.require(cache.v_scale, "v_scale", torch.float32, (L, NP, H, PS))
    for name, t in (("k pages", cache.k), ("v pages", cache.v), ("k_scale", cache.k_scale),
                    ("v_scale", cache.v_scale)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"paged_decode_attention: {name} is not 16-byte aligned")
    # a bf16 query is scaled in the kernel, by the same f32 product and bf16
    # rounding as _scaled_query (three elementwise launches fewer a call)
    qscale = 1.0 / D**0.5
    if q.dtype == torch.bfloat16:
        qs = q.contiguous()
    else:
        qs, qscale = _scaled_query(q, quantized).contiguous(), 1.0
    backend.require(qs, "q", torch.bfloat16, (B, H, D))
    out = torch.empty((B, H, D), dtype=torch.bfloat16, device=q.device)
    P = paged_split_count(B, H, maxp, PS, backend.sm_count(q.device)) if splits is None else splits
    if not 1 <= P <= -(-maxp * PS // SPLIT_ALIGN):
        raise ValueError(f"paged_decode_attention: {P} splits of {maxp * PS} positions")
    ws = cnt = None
    if P > 1:
        ws, cnt = backend.workspace(q.device, B * H * P * (D + 2), B * H)
    p, null = backend.ptr, backend.ptr(None)
    err = library().aria_paged_decode_attention(
        p(qs), p(cache.k), p(cache.v), p(cache.k_scale) if quantized else null,
        p(cache.v_scale) if quantized else null, p(page_table), p(lengths), p(out), p(ws),
        p(cnt), B, H, NP, PS, maxp, layer, int(quantized), P, qscale, backend.stream())
    backend.check(err, "paged_decode_attention")
    return out


paged_decode_attention.launches = 0
