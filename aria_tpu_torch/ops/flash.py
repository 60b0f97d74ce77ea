"""Causal flash attention for the prefill (counterpart of the causal
forward of aria_tpu/ops/flash.py).

The prefill attends the fresh k/v of the whole prompt bucket (query i sees
keys j <= i); the cache is written but not read (moe_lm.py:560-566).

Kernel: ``csrc/flash.cu``. It replaces the causal forward of
``flash_sdpa`` at aria_tpu/ops/flash.py:30, which calls the library Pallas
TPU flash kernel (:61-101). Its work is 2*S^2*D FLOPs per head after the
causal half; at the prompt buckets of this path (S <= 128) the kernel is
bound by latency, not by FLOPs or bytes. One block takes 8 query rows of
one (lane, head), stages key and value tiles of 32 positions in shared
memory and keeps the online softmax in f32; any S works.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from aria_tpu_torch.ops import backend
from aria_tpu_torch.ops._build import library
from aria_tpu_torch.ops.attention import causal_mask, sdpa

HEAD_DIM = 128  # the kernel's head width


def flash_causal_plain(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """Masked causal attention over [B, S, H, D] q/k/v, as the JAX package
    runs ``flash_sdpa(causal=True)`` off the TPU (flash.py:47-59)."""
    S = q.shape[1]
    return sdpa(q, k, v, causal_mask(S, S, device=q.device), scale=scale)


def flash_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Causal self-attention of [B, S, H, D] q/k/v; returns [B, S, H, D]."""
    if not backend.on_cuda(q, k, v):
        return flash_causal_plain(q, k, v, scale)
    B, S, H, D = q.shape
    if D != HEAD_DIM:
        raise ValueError(f"flash_causal: head dim {D}, the kernel takes {HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        backend.require(t, name, torch.bfloat16, (B, S, H, D))
    if scale is None:
        scale = 1.0 / (D**0.5)
    out = torch.empty_like(q)
    err = library().aria_flash_causal(
        backend.ptr(q), backend.ptr(k), backend.ptr(v), backend.ptr(out),
        B, S, H, ctypes.c_float(scale), backend.stream())
    backend.check(err, "flash_causal")
    flash_causal.launches += 1
    return out


flash_causal.launches = 0
