"""Non-causal ViT attention with a key-padding mask (counterpart of
aria_tpu/ops/vit_flash.py).

q, k, v are [B, S, H, D]; ``kv_valid`` [B, S] marks the real patches.
Every query attends every valid key. Rows of padding queries are garbage
by contract: callers read valid rows only.

Kernel: ``csrc/vit_attention.cu`` (its vit form). It replaces ``vit_flash``
of aria_tpu/ops/vit_flash.py:91 (``_kernel`` :50). Its work is 4*S^2*D
FLOPs per head: at the 980px crop (S = 4,900, H = 16, D = 72) that is
~3.0 TFLOP over the 27 layers, so it is bound by tensor-core throughput,
with one exponential a score costing about as much. One block takes 128
query rows of one (crop, head): producer warps bring K and V tiles of
128 keys by TMA into a ring of shared memory, with each key's mask beside
them, and two warpgroups run both products on wgmma, taking turns at the
tensor cores so that one's softmax runs while the other's products do.
D = 72 rides in a 64-column swizzled box and an 8-column tail. The TPU
kernel's transposed [B*H, Dp, Sp] layout existed only to put D on the
TPU's sublanes and is not carried over. ``flash_segment`` (ops/flash.py)
is the same kernel body in the library's numerics.

Numerics as in the TPU kernel: q is scaled by 1/sqrt(D) in f32 and cast
to bf16; scores are f32 with an additive -1e30 on masked keys; p is
rounded to bf16 for p.v while the running sum keeps it in f32; the output
is acc / max(l, 1e-30) in bf16. The kernel's exponentials are base 2 with
log2(e) folded in, a few ulps from exp.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from aria_tpu_torch.ops import backend
from aria_tpu_torch.ops._build import library
from aria_tpu_torch.ops.attention import sdpa

HEAD_DIMS = (64, 72)  # 72: a 64-column swizzled box and an 8-column tail


def vit_flash_plain(q, k, v, kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The port's sdpa with the key mask, on q pre-scaled in f32 and cast
    back as the kernel does."""
    qs = (q.float() * (1.0 / q.shape[-1] ** 0.5)).to(q.dtype)
    mask = None if kv_valid is None else kv_valid[:, None, None, :]
    return sdpa(qs, k, v, mask, scale=1.0)


def vit_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Returns [B, S, H, D] in q's dtype."""
    tensors = (q, k, v) if kv_valid is None else (q, k, v, kv_valid)
    if not backend.on_cuda(*tensors):
        return vit_flash_plain(q, k, v, kv_valid)
    B, S, H, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"vit_flash: head dim {D}; the kernel takes {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        backend.require(t, name, torch.bfloat16, (B, S, H, D))
    if kv_valid is not None:
        backend.require(kv_valid, "kv_valid", torch.bool, (B, S))
    out = torch.empty_like(q)
    err = library().aria_vit_flash(
        backend.ptr(q), backend.ptr(k), backend.ptr(v), backend.ptr(kv_valid),
        backend.ptr(out), B, S, H, D, ctypes.c_float(1.0 / D**0.5), backend.stream())
    backend.check(err, "vit_flash")
    vit_flash.launches += 1
    return out


vit_flash.launches = 0
