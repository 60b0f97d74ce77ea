"""The MoE FFN over packed int4 experts for prefill-sized token counts
(counterpart of aria_tpu/ops/moe_prefill_kernel.py).

Routing slots are sorted by expert into segments padded to 128 rows
(``segment_dispatch``), so every 128-row tile belongs to one expert and
holds that expert's routed rows first; the grouped GLU-FFN runs tile by
tile (``moe_prefill_int4``), and the slots are gathered back and combined
in f32 (``experts_segmented_int4``). The segment buffer has the static
worst-case row count R = ceil((T*k + E*127)/128)*128, and each tile's
count of routed rows is computed on the device, so nothing waits on the
host.

Kernel: ``csrc/moe_prefill.cu`` (glu, then down). It replaces
``moe_prefill_int4`` of aria_tpu/ops/moe_prefill_kernel.py:120 (``_k1_glu``
:52, ``_k2_down`` :91). Both products run on wgmma with the packed
weights as the M side, unpacked into bf16 in registers, and the tile's
token rows as the N side, brought by TMA: a tile of n routed rows runs at
N = n rounded up to 16, 32, 48, 64, 96 or 128, its other rows are written
as zeros (a zero row's output), and a tile of no routed row is skipped. At
a 512-token prompt it is bound by the used experts' weight bytes, above
~1,000 tokens by the bf16 tensor cores (6 I D operations a routed row).

Numerics: the products are exact (int4 values are exact in bf16), with
f32 sums and the D-group scales applied per group in group order, and h
is rounded to x's dtype between the two products. A row's bits do not
depend on how many rows share its tile. The TPU kernels instead compute
xa.B + (xb/16 - xa).hi16 - 8 sum(xa) and round (xb/16 - xa) to bf16,
which puts them ~2.7e-2 (relative) from the int4 GLU-FFN at bf16; that
rounding is not reproduced.
"""

from __future__ import annotations

import torch

from aria_tpu_torch.ops import backend
from aria_tpu_torch.ops._build import library
from aria_tpu_torch.ops.quant import dequantize_w1_int4, dequantize_w2_int4, int4_group_count

TM = 128  # rows per expert tile


def segment_dispatch(indices: torch.Tensor, num_experts: int):
    """Padded-segment scatter for sorted-by-expert dispatch, bit-equal to
    the JAX function (moe_prefill_kernel.py:196-224).

    Returns (dest_row int32 [T*k], tile_expert int32 [R // 128], R,
    tile_rows int32 [R // 128]): slot i goes to row ``dest_row[i]`` of the
    [R, D] segment buffer, and the first ``tile_rows[t]`` rows of tile t
    are routed slots (its others, and the tiles of 0, hold padding)."""
    T, k = indices.shape
    dev = indices.device
    flat_e = indices.reshape(-1).long()
    counts = torch.zeros(num_experts, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    padded = (counts + TM - 1) // TM * TM
    pstarts = torch.cumsum(padded, 0) - padded
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    sorted_starts = torch.cumsum(counts, 0) - counts
    ranks = torch.arange(T * k, device=dev) - sorted_starts[sorted_e]
    dest_sorted = pstarts[sorted_e] + ranks
    dest_row = torch.empty_like(dest_sorted).scatter_(0, order, dest_sorted)
    R = -(-(T * k + num_experts * (TM - 1)) // TM) * TM
    tile_starts = torch.arange(R // TM, device=dev) * TM
    tile_expert = torch.clamp(
        torch.searchsorted(pstarts, tile_starts, right=True) - 1, 0, num_experts - 1)
    # the tile's expert's rows that reach past the tile's start, at most 128
    tile_rows = torch.clamp(pstarts[tile_expert] + counts[tile_expert] - tile_starts, 0, TM)
    return (dest_row.to(torch.int32), tile_expert.to(torch.int32), R,
            tile_rows.to(torch.int32))


def moe_prefill_int4_plain(x_seg, tile_expert, w1q4, w1sg, w2q4, w2s8, layer: int,
                           tile_rows: torch.Tensor) -> torch.Tensor:
    """The same FFN on each expert's weights dequantized to f32; h is
    rounded to x's dtype between the products, as the kernel does. Every
    row of every tile is computed (``tile_rows`` only lets the kernel
    skip)."""
    R, D = x_seg.shape
    I = w1q4.shape[2] // 2
    out = torch.zeros((R, D), dtype=torch.float32, device=x_seg.device)
    row_expert = tile_expert.repeat_interleave(TM)
    for e in torch.unique(tile_expert).tolist():
        rows = torch.nonzero(row_expert == e).squeeze(1)
        xe = x_seg[rows].float()
        w1 = dequantize_w1_int4({"q4": w1q4[layer, e], "sg": w1sg[layer, e]}, torch.float32)
        gate, up = xe @ w1[:I].T, xe @ w1[I:].T
        h = ((gate * torch.sigmoid(gate)) * up).to(x_seg.dtype)
        w2 = dequantize_w2_int4({"q4": w2q4[layer, e], "s8": w2s8[layer, e]}, torch.float32)
        out[rows] = h.float() @ w2
    return out


def moe_prefill_int4(
    x_seg: torch.Tensor,  # [R, D] tokens scattered into padded expert segments
    tile_expert: torch.Tensor,  # int32 [R // 128] expert id per row tile
    w1q4: torch.Tensor,  # int8 [L, E, 2I, D/2]
    w1sg: torch.Tensor,  # bf16 [L, E, 8, 2I]
    w2q4: torch.Tensor,  # int8 [L, E, I, D/2]
    w2s8: torch.Tensor,  # bf16 [L, E, 8, D]
    layer: int,
    tile_rows: torch.Tensor,  # int32 [R // 128] routed rows per tile, from segment_dispatch
) -> torch.Tensor:
    """Segmented grouped GLU-FFN over the packed int4 stacks; returns
    [R, D] f32. Only each tile's first ``tile_rows`` rows are computed: its
    other rows are zeros, and the rows of a tile of 0 are left unwritten."""
    tensors = (x_seg, tile_expert, w1q4, w1sg, w2q4, w2s8)
    if not backend.on_cuda(*tensors, tile_rows):
        return moe_prefill_int4_plain(*tensors, layer, tile_rows)
    R, D = x_seg.shape
    L, E, I2, Dp = w1q4.shape
    I = I2 // 2
    gs = D // int4_group_count(D)
    if R % TM or D != 2 * Dp or (gs // 2) % 128 or Dp % 64 or I % 128:
        raise ValueError(f"moe_prefill_int4: unsupported R={R}, D={D}, I={I}")
    if not 0 <= layer < L:
        raise IndexError(f"moe_prefill_int4: layer {layer} of {L}")
    backend.require(x_seg, "x_seg", torch.bfloat16, (R, D))
    backend.require(tile_expert, "tile_expert", torch.int32, (R // TM,))
    backend.require(w1q4, "w1q4", torch.int8)
    backend.require(w1sg, "w1sg", torch.bfloat16, (L, E, 8, I2))
    backend.require(w2q4, "w2q4", torch.int8, (L, E, I, Dp))
    backend.require(w2s8, "w2s8", torch.bfloat16, (L, E, 8, D))
    backend.require(tile_rows, "tile_rows", torch.int32, (R // TM,))
    h = torch.empty((R, I), dtype=torch.bfloat16, device=x_seg.device)
    out = torch.empty((R, D), dtype=torch.float32, device=x_seg.device)
    lib, p, st = library(), backend.ptr, backend.stream()
    err = lib.aria_moe_prefill_glu(p(x_seg), p(tile_expert), p(tile_rows), p(w1q4), p(w1sg),
                                   p(h), R, D, I, L, E, layer, st)
    backend.check(err, "moe_prefill_int4 (glu)")
    err = lib.aria_moe_prefill_down(p(h), p(tile_expert), p(tile_rows), p(w2q4), p(w2s8),
                                    p(out), R, D, I, L, E, layer, st)
    backend.check(err, "moe_prefill_int4 (down)")
    moe_prefill_int4.launches += 1
    return out


moe_prefill_int4.launches = 0


def expert_slots(
    x: torch.Tensor,  # [T, D]
    indices: torch.Tensor,  # [T, k] int32 expert ids (shared experts included)
    w1q4: torch.Tensor,
    w1sg: torch.Tensor,
    w2q4: torch.Tensor,
    w2s8: torch.Tensor,
    layer: int,
) -> torch.Tensor:
    """Each routing slot's expert output [T, k, D] f32: the tokens
    scattered into padded expert segments, the grouped GLU-FFN, and the
    rows gathered back."""
    T, D = x.shape
    k = indices.shape[1]
    dest_row, tile_expert, R, tile_rows = segment_dispatch(indices, w1q4.shape[1])
    dest = dest_row.long()
    x_seg = torch.zeros((R, D), dtype=x.dtype, device=x.device)
    x_seg[dest] = x.repeat_interleave(k, dim=0)
    out_seg = moe_prefill_int4(x_seg, tile_expert, w1q4, w1sg, w2q4, w2s8, layer, tile_rows)
    return out_seg[dest].reshape(T, k, D)


def experts_segmented_int4(
    x: torch.Tensor,  # [T, D]
    indices: torch.Tensor,  # [T, k] int32 expert ids (shared experts included)
    weights: torch.Tensor,  # [T, k] combine weights
    w1q4: torch.Tensor,
    w1sg: torch.Tensor,
    w2q4: torch.Tensor,
    w2s8: torch.Tensor,
    layer: int,
) -> torch.Tensor:
    """The MoE FFN for prefill-sized T; returns [T, D] in x's dtype
    (moe_prefill_kernel.py:227-254)."""
    per_slot = expert_slots(x, indices, w1q4, w1sg, w2q4, w2s8, layer)
    combined = torch.einsum("tkd,tk->td", per_slot, weights.float())
    return combined.to(x.dtype)
