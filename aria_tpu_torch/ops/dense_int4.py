"""Packed-int4 dense matmul for the attention projections wqkv and wo
(counterpart of aria_tpu/ops/dense_int4.py).

Kernel: ``csrc/dense_int4.cu``. It replaces the bf16-activation
``dense_int4`` of aria_tpu/ops/dense_int4.py:124 (``_kernel`` :68). At
decode (T = 1) it is a matvec over F*D/2 bytes of packed weights, 2 FLOPs
per weight, so it is bound by the weight read from device memory; the
kernel reads each packed row once per block of 8 token rows and unpacks
the nibbles in registers.

The weight format is the JAX package's, byte for byte: out-major
``q4t`` int8 [L, F, D/2] with within-group nibble pairing over D and bf16
scales ``sg`` [L, 8, F] (row g = D-group g). The whole layer stack is
passed with a layer index, so no per-layer slice is copied.
"""

from __future__ import annotations

import torch

from aria_tpu_torch.ops import backend
from aria_tpu_torch.ops._build import library
from aria_tpu_torch.ops.quant import dequantize_dense_int4, int4_group_count


def dense_int4_plain(x: torch.Tensor, w: dict, layer: int) -> torch.Tensor:
    """x [T, D] @ dequantized W[layer] [D, F] in f32."""
    wl = {"q4t": w["q4t"][layer], "sg": w["sg"][layer]}
    return x.float() @ dequantize_dense_int4(wl, dtype=torch.float32)


def dense_int4(x: torch.Tensor, w: dict, layer: int) -> torch.Tensor:
    """x [T, D] @ W[layer] over the packed stack; returns [T, F] f32 (the
    caller casts, as moe_lm.py:340 does below 8192 tokens)."""
    q4t, sg = w["q4t"], w["sg"]
    if not backend.on_cuda(x, q4t, sg):
        return dense_int4_plain(x, w, layer)
    T, D = x.shape
    L, F, Dp = q4t.shape
    gs = D // int4_group_count(D)
    if D != 2 * Dp or D % 32 or (gs // 2) % 16:
        raise ValueError(f"dense_int4: unsupported D={D} (packed {Dp}, group {gs})")
    if not 0 <= layer < L:
        raise IndexError(f"dense_int4: layer {layer} of {L}")
    backend.require(x, "x", torch.bfloat16, (T, D))
    backend.require(q4t, "q4t", torch.int8)
    backend.require(sg, "sg", torch.bfloat16, (L, 8, F))
    out = torch.empty((T, F), dtype=torch.float32, device=x.device)
    err = library().aria_dense_int4(
        backend.ptr(x), backend.ptr(q4t), backend.ptr(sg), backend.ptr(out),
        T, D, F, layer, backend.stream())
    backend.check(err, "dense_int4")
    dense_int4.launches += 1
    return out


dense_int4.launches = 0
