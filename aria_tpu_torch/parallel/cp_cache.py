"""Context parallelism over the KV cache (counterpart of
aria_tpu/parallel/cp_cache.py): the 64K serving scenario, where one card
cannot hold the cache.

Each rank holds one block of the stacked cache: positions [c * S_loc,
(c + 1) * S_loc) for its coordinate c on the ``context`` axis, and, when
the ``model`` axis is above 1, heads [t * H/tp, (t + 1) * H/tp) for its
coordinate t there; a packed-int4 cache keeps every head on every rank, as
its bytes pair head h with head h + H/2 (cp_cache.py:65-71). The query is
replicated, as every rank computes the same activations.

- **decode** (one token): each rank runs the decode-attention kernel in its
  stats form (``decode_attention_stats``) over its block at the local
  lengths clip(len - c * S_loc, 0, S_loc), and the partial (acc, m, s) merge
  exactly: one MAX all-reduce of m over the ``context`` group, then one SUM
  all-reduce of acc * corr and s * corr in one buffer, corr = exp(m - m_g).
  A block with no position has the finite m = -1e30 and corr = 0.
- **cached prefill** (S > 1): blockwise f32 attention of the query chunk
  against the rank's block, with the same merge (the MAX before the
  exponentials, as cp_cache.py:136-210 computes it in XLA), head by head
  in groups that keep the [B, h, S, S_loc] logits under
  ``PREFILL_LOGITS_BYTES``.

Heads computed on a ``model`` shard are gathered over the ``model`` group
at the end. The collectives take the tensors where they lie: gloo moves a
CUDA tensor through the host itself.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from aria_tpu_torch.ops.decode_attention import decode_attention, unpack_heads
from aria_tpu_torch.parallel.mesh import Mesh

_NEG = -1e30
PREFILL_LOGITS_BYTES = 1 << 30  # f32 logits of one head group of a cached prefill


def _head_block(mesh: Mesh, H: int, packed4: bool) -> tuple[int, int]:
    """(first head, heads) of this rank's head shard."""
    if packed4 or mesh.shape["model"] == 1:
        return 0, H
    return mesh.block("model", H)


def _max_over(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The merge's MAX of the running maxima over the ``context`` group."""
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.groups["context"])
    return t


def _sum_partials(buf: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The merge's SUM over the ``context`` group of the ranks' partials,
    [..., D + 1]: the weighted accumulators with the denominators beside
    them."""
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.groups["context"])
    return buf


def _gather_heads(out: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """Concatenate the ``model`` shards' heads along ``dim``, in model
    order."""
    out = out.contiguous()
    parts = [torch.empty_like(out) for _ in range(mesh.shape["model"])]
    dist.all_gather(parts, out, group=mesh.groups["model"])
    return torch.cat(parts, dim=dim)


def mesh_decode_attention(
    q: torch.Tensor,  # [B, H, D] the token's queries, replicated
    cache,  # KVCache: this rank's block [L, B, H/tp (H/2 packed), S_loc, D]
    layer: int,
    lengths: torch.Tensor,  # [B] int32, global: attend positions < length
    mesh: Mesh,
) -> torch.Tensor:
    """Decode attention under a serving mesh (cp_cache.py:41-111): the
    normal kernel on this rank's heads with ``context`` = 1, else the stats
    kernel on this rank's block and the exact merge; heads gathered over
    ``model``. Returns [B, H, D]: the kernel's dtype with ``context`` = 1,
    q's after a merge."""
    cp_n = mesh.shape["context"]
    h0, Hl = _head_block(mesh, q.shape[1], cache.packed4)
    q_l = q[:, h0:h0 + Hl]
    if cp_n == 1:
        out = decode_attention(q_l, cache.k, cache.v, layer, lengths, cache.k_scale,
                               cache.v_scale)
    else:
        S_loc = cache.k.shape[3]
        start = mesh.coords["context"] * S_loc
        len_loc = torch.clamp(lengths - start, 0, S_loc).to(torch.int32)
        acc, m, s = decode_attention(q_l, cache.k, cache.v, layer, len_loc, cache.k_scale,
                                     cache.v_scale, return_stats=True)
        m_g = _max_over(m.clone(), mesh)
        corr = torch.exp(m - m_g)
        buf = _sum_partials(torch.cat([acc * corr[..., None], (s * corr)[..., None]], dim=-1),
                            mesh)
        D = acc.shape[-1]
        out = (buf[..., :D] / torch.clamp_min(buf[..., D:], 1e-30)).to(q.dtype)
    if Hl != q.shape[1]:
        out = _gather_heads(out, mesh, 1)
    return out


def _dequant_plane(k_l, v_l, ks_l, vs_l, layer: int, packed4: bool):
    """This layer's local cache plane [B, h, S_loc, D], dequantized to f32
    for a quantized cache (cp_cache.py:114-133)."""
    k_att, v_att = k_l[layer], v_l[layer]
    if ks_l is None:
        return k_att, v_att
    if packed4:
        k_att, v_att = unpack_heads(k_att), unpack_heads(v_att)
    return (k_att.float() * ks_l[layer].float()[..., None],
            v_att.float() * vs_l[layer].float()[..., None])


def cp_cached_prefill_attention(
    q: torch.Tensor,  # [B, S, H, D] the query chunk, replicated
    cache,  # KVCache: this rank's block, already written
    layer: int,
    mask: torch.Tensor,  # bool, broadcastable to [B, H, S, Smax]; True = attend
    mesh: Mesh,
) -> torch.Tensor:
    """Blockwise cached-prefill attention with the cache's positions
    sharded over ``context`` (cp_cache.py:136-210): each rank attends the
    whole query chunk against its block, the partials merge with one MAX
    and one SUM all-reduce per group of heads. Returns [B, S, H, D] in q's
    dtype."""
    B, S, H, D = q.shape
    cp_n = mesh.shape["context"]
    S_loc = cache.k.shape[3]
    start = mesh.coords["context"] * S_loc
    h0, Hl = _head_block(mesh, H, cache.packed4)
    mask = mask.expand(*mask.shape[:-1], S_loc * cp_n)[..., start:start + S_loc]
    if mask.dim() == 4 and mask.shape[1] == H:
        mask = mask[:, h0:h0 + Hl]
    k_att, v_att = _dequant_plane(cache.k, cache.v, cache.k_scale, cache.v_scale, layer,
                                  cache.packed4)
    qs = q[:, :, h0:h0 + Hl].float() * D ** -0.5
    group = max(1, min(Hl, PREFILL_LOGITS_BYTES // max(1, B * S * S_loc * 4)))
    outs = []
    for g0 in range(0, Hl, group):
        hs = slice(g0, min(Hl, g0 + group))
        m_h = mask[:, hs] if mask.dim() == 4 and mask.shape[1] == Hl else mask
        logits = torch.einsum("bshd,bhkd->bhsk", qs[:, :, hs], k_att[:, hs].float())
        logits = torch.where(m_h, logits, torch.full_like(logits, _NEG))
        m_g = logits.amax(dim=-1)
        if cp_n > 1:
            m_g = _max_over(m_g, mesh)
        p = torch.exp(logits - m_g[..., None])
        del logits
        p = torch.where(m_h, p, torch.zeros_like(p))
        buf = torch.cat([torch.einsum("bhsk,bhkd->bhsd", p, v_att[:, hs].float()),
                         p.sum(dim=-1)[..., None]], dim=-1)
        del p
        if cp_n > 1:
            buf = _sum_partials(buf, mesh)
        outs.append(buf[..., :D] / torch.clamp_min(buf[..., D:], 1e-30))
    out = torch.cat(outs, dim=1).transpose(1, 2).to(q.dtype)  # [B, S, Hl, D]
    if Hl != H:
        out = _gather_heads(out, mesh, 2)
    return out


def local_cache_shape(shape: tuple, mesh: Optional[Mesh], packed4: bool) -> tuple:
    """This rank's block of a [L, B, H, S, ...] cache or scale stack: the
    heads split over ``model`` (unless packed4) and the positions over
    ``context``, as generate.py:131-148 shards them."""
    if mesh is None:
        return tuple(shape)
    L, B, H, S = shape[:4]
    if not packed4:
        H = mesh.block("model", H)[1]
    return (L, B, H, mesh.block("context", S)[1]) + tuple(shape[4:])
