"""Causal flash attention, forward and backward (counterpart of the causal
branch of aria_tpu/ops/flash.py:30-103).

A from-zero prefill attends the fresh k/v of the whole prompt bucket
(query i sees keys j <= i); the cache is written but not read
(moe_lm.py:560-566). Training runs the same attention and differentiates
it.

Kernels: ``csrc/flash.cu`` replaces the forward of ``flash_sdpa``'s
library Pallas TPU flash kernel (:61-101): one block takes 8 query rows of
one (lane, head), stages key and value tiles of 32 positions in shared
memory and keeps the online softmax in f32 (scalar FMA; any S works). In
training it also writes each row's f32 log-sum-exp, and
``csrc/flash_bwd.cu`` replaces the library's backward
(flash_attention.py:254-300, the dkv and dq kernels) on tensor cores;
their notes give the designs. Serving calls the forward without the
statistics, as it did before training existed.

Off the card the plain version runs: masked sdpa, and its autograd
gradient, as the JAX package runs ``flash_sdpa(causal=True)`` off the TPU
(flash.py:47-59).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from aria_tpu_torch.ops import backend
from aria_tpu_torch.ops._build import library
from aria_tpu_torch.ops.attention import causal_mask, sdpa

HEAD_DIM = 128  # the kernels' head width


def flash_causal_plain(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """Masked causal attention over [B, S, H, D] q/k/v, as the JAX package
    runs ``flash_sdpa(causal=True)`` off the TPU (flash.py:47-59)."""
    S = q.shape[1]
    return sdpa(q, k, v, causal_mask(S, S, device=q.device), scale=scale)


def flash_causal_bwd_plain(q, k, v, dout, scale: Optional[float] = None):
    """(dq, dk, dv): autograd of ``flash_causal_plain`` with cotangent
    ``dout``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_causal_plain(*leaves, scale)
        return torch.autograd.grad(out, leaves, dout)


def _check(q, k, v) -> float:
    B, S, H, D = q.shape
    if D != HEAD_DIM:
        raise ValueError(f"flash_causal: head dim {D}, the kernels take {HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        backend.require(t, name, torch.bfloat16, (B, S, H, D))
    return 1.0 / (D**0.5)


def _forward(q, k, v, scale: float, lse: Optional[torch.Tensor]) -> torch.Tensor:
    B, S, H, _ = q.shape
    out = torch.empty_like(q)
    err = library().aria_flash_causal(
        backend.ptr(q), backend.ptr(k), backend.ptr(v), backend.ptr(out), backend.ptr(lse),
        B, S, H, ctypes.c_float(scale), backend.stream())
    backend.check(err, "flash_causal")
    flash_causal.launches += 1
    return out


def flash_causal_bwd(q, k, v, out, dout, lse, scale: Optional[float] = None):
    """(dq, dk, dv) of causal attention from the forward's output ``out``
    and row log-sum-exp ``lse`` [B, H, S] f32, on the card."""
    s = _check(q, k, v)
    scale = s if scale is None else scale
    B, S, H, D = q.shape
    for name, t in (("out", out), ("dout", dout)):
        backend.require(t, name, torch.bfloat16, (B, S, H, D))
    backend.require(lse, "lse", torch.float32, (B, H, S))
    di = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    p = backend.ptr
    err = library().aria_flash_causal_bwd(
        p(q), p(k), p(v), p(out), p(dout), p(lse), p(di), p(dq), p(dk), p(dv), B, S, H,
        ctypes.c_float(scale), backend.stream())
    backend.check(err, "flash_causal_bwd")
    flash_causal_bwd.launches += 1
    return dq, dk, dv


class _FlashCausal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        B, S, H, _ = q.shape
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        out = _forward(q, k, v, scale, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_causal_bwd(q, k, v, out, dout.contiguous(), lse, ctx.scale)
        return dq, dk, dv, None


def flash_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Causal self-attention of [B, S, H, D] q/k/v; returns [B, S, H, D].
    Differentiable: on the card a forward that autograd records keeps the
    row statistics for ``flash_causal_bwd``."""
    if not backend.on_cuda(q, k, v):
        return flash_causal_plain(q, k, v, scale)
    s = _check(q, k, v)
    scale = s if scale is None else scale
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashCausal.apply(q, k, v, scale)
    return _forward(q, k, v, scale, None)


flash_causal.launches = 0
flash_causal_bwd.launches = 0
