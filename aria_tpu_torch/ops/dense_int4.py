"""Packed-int4 dense matmul for the attention projections wqkv and wo
(counterpart of aria_tpu/ops/dense_int4.py).

Kernels: ``csrc/dense_int4.cu``, in the JAX function's two forms.
``dense_int4`` replaces its bf16-activation kernel (aria_tpu/ops/
dense_int4.py:124, ``_kernel`` :68): one wgmma kernel for every T, the
packed weights the M side with their nibbles unpacked in registers to
bf16, the token rows the N side. At decode (T <= 32) it is bound by the
F*D/2 bytes of packed weights (up to 8 rows it splits K over the D-groups,
through the split workspace of ``backend.workspace``); at prefill by the
bf16 tensor cores.
``dense_int4_a8`` replaces the W4A8 kernel (``_kernel_a8`` :97, the
``act_int8=True`` branch): x quantized to int8 per (token, D-group) with
``act_quant_int8``'s arithmetic, exact int32 dots with the int4 values on
the int8 tensor cores (``mma.sync`` m16n8k32, the nibbles unpacked in
registers), then per group ``(G * sx) * sg`` summed over the groups in
ascending order, as the TPU kernel does: bit-equal to the plain version.
Up to 8 rows it splits K over the D-groups like ``dense_int4`` and each
block quantizes its group of x itself (one launch); above, the
``act_quant_int8`` launch (in the same source) comes first. The model
takes it for the attention projections of a step of at most 32 rows when
``models/moe_lm.py``'s ``DENSE_A8`` is set.

The weight format is the JAX package's, byte for byte: out-major
``q4t`` int8 [L, F, D/2] with within-group nibble pairing over D and bf16
scales ``sg`` [L, 8, F] (row g = D-group g). The whole layer stack is
passed with a layer index, so no per-layer slice is copied.
"""

from __future__ import annotations

import torch

from aria_tpu_torch.ops import backend
from aria_tpu_torch.ops._build import library
from aria_tpu_torch.ops.moe_decode_kernel import act_quant_int8
from aria_tpu_torch.ops.quant import dequantize_dense_int4, int4_group_count, unpack_int4


# up to this many rows both kernels split K over the D-groups (the most
# they take): a block's work is then too short to hide a load's latency
SPLIT_MAX_TOKENS = 8


def dense_int4_plain(x: torch.Tensor, w: dict, layer: int) -> torch.Tensor:
    """x [T, D] @ dequantized W[layer] [D, F] in f32."""
    wl = {"q4t": w["q4t"][layer], "sg": w["sg"][layer]}
    return x.float() @ dequantize_dense_int4(wl, dtype=torch.float32)


def dense_int4_a8_plain(x: torch.Tensor, w: dict, layer: int) -> torch.Tensor:
    """The W4A8 product in plain torch (``_kernel_a8``): the integer dots
    run in float64, where every product and sum of int8 x int4 values at
    these widths is exact, so they equal the kernel's int32 sums; then
    ``(G * sx) * sg`` per D-group, summed over the groups in ascending
    order in f32."""
    T, D = x.shape
    ng = int4_group_count(D)
    gs = D // ng
    xq, sx = act_quant_int8(x, ng)
    vals = unpack_int4(w["q4t"][layer], gs, torch.float64)  # [F, D]
    sg = w["sg"][layer].float()
    acc = None
    for g in range(ng):
        cols = slice(g * gs, (g + 1) * gs)
        G = (xq[:, cols].double() @ vals[:, cols].T).float()  # exact integers
        d = G * sx[:, g:g + 1] * sg[g]
        acc = d if acc is None else acc + d
    return acc


def _check(x: torch.Tensor, w: dict, layer: int, name: str):
    q4t, sg = w["q4t"], w["sg"]
    T, D = x.shape
    L, F, Dp = q4t.shape
    gs = D // int4_group_count(D)
    if D != 2 * Dp or D % 32 or (gs // 2) % 16:
        raise ValueError(f"{name}: unsupported D={D} (packed {Dp}, group {gs})")
    if not 0 <= layer < L:
        raise IndexError(f"{name}: layer {layer} of {L}")
    backend.require(x, "x", torch.bfloat16, (T, D))
    backend.require(q4t, "q4t", torch.int8)
    backend.require(sg, "sg", torch.bfloat16, (L, 8, F))
    return T, D, F


def dense_int4_a8(x: torch.Tensor, w: dict, layer: int) -> torch.Tensor:
    """The W4A8 form of ``dense_int4``: x quantized to int8 per (token,
    D-group), exact integer dots; returns [T, F] f32."""
    q4t, sg = w["q4t"], w["sg"]
    if not backend.on_cuda(x, q4t, sg):
        return dense_int4_a8_plain(x, w, layer)
    T, D, F = _check(x, w, layer, "dense_int4_a8")
    if x.data_ptr() % 16:
        raise ValueError("dense_int4_a8: x is not 16-byte aligned")
    ng = int4_group_count(D)
    out = torch.empty((T, F), dtype=torch.float32, device=x.device)
    lib, p, st = library(), backend.ptr, backend.stream()
    xq = sx = ws = cnt = None
    if T <= SPLIT_MAX_TOKENS:  # the kernel quantizes x itself
        ws, cnt = backend.workspace(x.device, ng * T * F, -(-F // 64))
    else:
        xq = torch.empty((T, D), dtype=torch.int8, device=x.device)
        sx = torch.empty((T, 8), dtype=torch.float32, device=x.device)
        backend.check(lib.aria_act_quant_int8(p(x), p(xq), p(sx), T, D, ng, st), "act_quant_int8")
    err = lib.aria_dense_int4_a8(p(x), p(xq), p(sx), p(q4t), p(sg), p(out), p(ws), p(cnt), T, D,
                                 F, q4t.shape[0], layer, st)
    backend.check(err, "dense_int4_a8")
    dense_int4_a8.launches += 1
    return out


def dense_int4(x: torch.Tensor, w: dict, layer: int, act_int8: bool = False) -> torch.Tensor:
    """x [T, D] @ W[layer] over the packed stack; returns [T, F] f32 (the
    caller casts, as moe_lm.py:340 does below 8192 tokens). ``act_int8``
    takes the W4A8 form (``dense_int4_a8``)."""
    if act_int8:
        return dense_int4_a8(x, w, layer)
    q4t, sg = w["q4t"], w["sg"]
    if not backend.on_cuda(x, q4t, sg):
        return dense_int4_plain(x, w, layer)
    T, D, F = _check(x, w, layer, "dense_int4")
    out = torch.empty((T, F), dtype=torch.float32, device=x.device)
    ws = cnt = None
    if T <= SPLIT_MAX_TOKENS:
        ws, cnt = backend.workspace(x.device, int4_group_count(D) * T * F, -(-F // 64))
    p = backend.ptr
    err = library().aria_dense_int4(p(x), p(q4t), p(sg), p(out), p(ws), p(cnt), T, D, F,
                                    q4t.shape[0], layer, backend.stream())
    backend.check(err, "dense_int4")
    dense_int4.launches += 1
    return out


dense_int4.launches = 0
dense_int4_a8.launches = 0
