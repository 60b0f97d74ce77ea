"""One block of experts of a quantized expert stack, dequantized in one pass
(the port's counterpart of ``_pin_default_layout``, aria_tpu/models/moe_lm.py:655).

The expert-LoRA path over a quantized base (``_experts_lora_blocked`` in
``models/moe_lm.py``) needs float expert weights, one block of experts at a
time. On the TPU each block is first copied by a Pallas identity kernel, so
that XLA's layout propagation stops at the block, and then dequantized by
XLA. A block ``[e0, e0 + eb)`` of a contiguous ``[E, ...]`` stack is
already a plain view in torch, so the copy alone would be pure overhead:
the kernel here reads the block's packed bytes and scales in place and
writes its float weights, which is what the copy feeds.

Forms, as ``ops/quant.py`` stores them:

- int4 w1 ``{"q4": int8 [E, 2I, D/2], "sg": bf16 [E, 8, 2I]}``: nibbles
  paired within each of the ng groups of D, a scale per (row, group);
- int4 w2 ``{"q4": int8 [E, I, D/2], "s8": bf16 [E, 8, D]}``: whole-row
  pairing, a scale per column (row 0 of ``s8``);
- int8 w1 ``{"q": int8 [E, 2I, D], "s": f32 [E, 2I]}`` (a scale per row)
  and w2 ``{"q": int8 [E, I, D], "s": f32 [E, D]}`` (per column).

The arithmetic is the plain version's: an int4 value times its bf16 scale
is exact in f32, rounded once to the output dtype (``_deq_compute_dtype``),
and an int8 value times its f32 scale is rounded once, so the kernel is
bit-equal to the plain version in bf16 and in f32.

Kernel: ``csrc/expert_dequant.cu``.
"""

from __future__ import annotations

import torch

from aria_tpu_torch.ops import backend
from aria_tpu_torch.ops._build import library
from aria_tpu_torch.ops.quant import (
    dequantize_w1_int4,
    dequantize_w2_int4,
    dequantize_weight,
    int4_group_count,
    is_quantized,
    is_quantized_int4,
)

# scale modes of csrc/expert_dequant.cu
_INT4_ROW_GROUP, _INT4_COL, _INT8_ROW, _INT8_COL = 0, 1, 2, 3


def _leaves(w: dict, kind: str) -> tuple:
    """(values, scales, mode) of one weight of a layer's stack."""
    if kind not in ("w1", "w2"):
        raise ValueError(f"expert_block_dequant: kind {kind!r}, not 'w1' or 'w2'")
    if is_quantized_int4(w):
        return ((w["q4"], w["sg"], _INT4_ROW_GROUP) if kind == "w1"
                else (w["q4"], w["s8"], _INT4_COL))
    if is_quantized(w):
        return w["q"], w["s"], _INT8_ROW if kind == "w1" else _INT8_COL
    raise TypeError("expert_block_dequant: an int4 or int8 expert stack")


def expert_block_dequant_plain(w: dict, kind: str, e0: int, eb: int,
                               dtype=torch.bfloat16) -> torch.Tensor:
    """The block's slice, then ``dequantize_expert_weights``'s dequantize of
    that weight (quant.py:179-185): int4 unpacked and scaled, int8 w1 over
    D, int8 w2 over I."""
    blk = {k: v[e0:e0 + eb] for k, v in w.items()}
    if is_quantized_int4(w):
        return dequantize_w1_int4(blk, dtype) if kind == "w1" else dequantize_w2_int4(blk, dtype)
    return dequantize_weight(blk, input_axis=-1 if kind == "w1" else -2, dtype=dtype)


def expert_block_dequant(
    w: dict,  # one layer's quantized stack of w1 or w2, leaves [E, ...]
    kind: str,  # "w1" [E, 2I, D] out-major, or "w2" [E, I, D]
    e0: int,
    eb: int,
    dtype=torch.bfloat16,
) -> torch.Tensor:
    """Experts ``e0 .. e0 + eb - 1`` of ``w`` as float weights [eb, R, D] in
    ``dtype`` (bf16 or f32)."""
    q, s, mode = _leaves(w, kind)
    if not backend.on_cuda(q, s):
        return expert_block_dequant_plain(w, kind, e0, eb, dtype)
    E, R = q.shape[0], q.shape[1]
    if not (0 <= e0 and eb > 0 and e0 + eb <= E):
        raise IndexError(f"expert_block_dequant: block [{e0}, {e0 + eb}) of {E} experts")
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"expert_block_dequant: out dtype {dtype}, not bf16 or f32")
    int4 = mode in (_INT4_ROW_GROUP, _INT4_COL)
    D = 2 * q.shape[2] if int4 else q.shape[2]
    group = D // int4_group_count(D) if mode == _INT4_ROW_GROUP else D
    if D % 32 or group % 32:
        raise ValueError(f"expert_block_dequant: D {D} and group {group} must be multiples of 32")
    backend.require(q, "values", torch.int8, (E, R, D // 2 if int4 else D))
    if mode == _INT4_ROW_GROUP:
        backend.require(s, "sg", torch.bfloat16, (E, 8, R))
    elif mode == _INT4_COL:
        backend.require(s, "s8", torch.bfloat16, (E, 8, D))
    else:
        backend.require(s, "s", torch.float32, (E, R) if mode == _INT8_ROW else (E, D))
    qb, sb = q[e0:e0 + eb], s[e0:e0 + eb]  # views: read in place
    if qb.data_ptr() % 16 or sb.data_ptr() % 16:
        raise ValueError("expert_block_dequant: the block must start 16-byte aligned")
    out = torch.empty((eb, R, D), dtype=dtype, device=q.device)
    p = backend.ptr
    err = library().aria_expert_dequant(p(qb), p(sb), p(out), eb, R, D, group, mode,
                                        int(dtype == torch.float32), backend.stream())
    backend.check(err, "expert_block_dequant")
    expert_block_dequant.launches += 1
    return out


expert_block_dequant.launches = 0
