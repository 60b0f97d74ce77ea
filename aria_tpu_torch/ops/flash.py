"""Flash attention (counterpart of aria_tpu/ops/flash.py:30-103): the causal
forward and backward, and the non-causal form with segment ids.

A from-zero prefill attends the fresh k/v of the whole prompt bucket
(query i sees keys j <= i); the cache is written but not read
(moe_lm.py:560-566). Training runs the same attention and differentiates
it.

Kernels: ``csrc/flash.cu`` replaces the forward of ``flash_sdpa``'s
library Pallas TPU flash kernel (:61-101): one block takes 128 query rows
of one (lane, head) (64 where that would leave SMs idle), two warpgroups
run both products on wgmma from K and V tiles that a producer brings by
TMA into a ring of shared memory, and the online softmax stays in f32 on
the accumulators (any S works). In training it also writes each row's f32
log-sum-exp, and
``csrc/flash_bwd.cu`` replaces the library's backward
(flash_attention.py:254-300, the dkv and dq kernels) with one wgmma + TMA
pass over key tiles of 128 keys, which adds each key tile's part of dq
into an f32 scratch in key-tile order (so dq's bits repeat); their notes
give the designs. Serving calls the forward without the statistics, as it
did before training existed.

Off the card the plain version runs: masked sdpa, and its autograd
gradient, as the JAX package runs ``flash_sdpa(causal=True)`` off the TPU
(flash.py:47-59).

``flash_segment`` is the non-causal form: the library kernel called with
``SegmentIds`` (valid positions segment 1, padding 0) and causal=False,
which is the ViT's attention when ``models/vit.py``'s ``VIT_FLASH`` is off
(the JAX package's ``ARIA_TPU_VIT_FLASH=0``). Query i attends key j iff
their segments are equal, so pad queries attend pad keys only. Kernel
``csrc/vit_attention.cu`` (its segment form; ``vit_flash``'s kernel body,
whose notes give the design); it follows the library's numerics
(flash_attention.py:395-472): unscaled bf16 q.k with f32 sums, then the
scale in f32, an additive -0.7 * FLT_MAX where the segments differ, p
rounded to v's dtype for p.v. At [1, 4900, 16, 72] it does 110.6 GFLOP,
so it is bound by tensor-core throughput. ``flash_sdpa`` takes the JAX
signature and picks the form.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from aria_tpu_torch.ops import backend
from aria_tpu_torch.ops._build import library
from aria_tpu_torch.ops.attention import NEG_INF, causal_mask, sdpa

HEAD_DIM = 128  # the causal kernels' head width
SEGMENT_HEAD_DIMS = (64, 72)  # the ViT configs'


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
        B, S, H, ctypes.c_float(scale), backend.sm_count(q.device), backend.stream())
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
    # scratch over S rounded up to the kernel's 64-query tiles: lse * log2(e)
    # and di, dq's f32 sums, and a zeroed counter per query tile
    nqt = -(-S // 64)
    ws = torch.empty((2, B, H, nqt * 64), dtype=torch.float32, device=q.device)
    dq_acc = torch.empty((B, H, nqt * 64, D), dtype=torch.float32, device=q.device)
    counters = torch.zeros((B, H, nqt), dtype=torch.int32, device=q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    p = backend.ptr
    err = library().aria_flash_causal_bwd(
        p(q), p(k), p(v), p(out), p(dout), p(lse), p(ws), p(dq_acc), p(counters), p(dq), p(dk),
        p(dv), B, S, H, ctypes.c_float(scale), backend.stream())
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


def flash_sdpa_plain(q, k, v, q_valid: Optional[torch.Tensor] = None,
                     kv_valid: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Non-causal attention with segment ids in plain torch, in the
    library kernel's order: f32 scores of q.k times ``scale``, plus
    -0.7 * FLT_MAX where the query's segment differs from the key's, p =
    exp(s - max) rounded to v's dtype for p.v, divided by its f32 sum."""
    B, Sq, H, D = q.shape
    scale = 1.0 / (D**0.5) if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if q_valid is not None or kv_valid is not None:
        seg_q = torch.ones((B, Sq), dtype=torch.bool, device=q.device) if q_valid is None \
            else q_valid
        seg_k = torch.ones((B, k.shape[1]), dtype=torch.bool, device=q.device) \
            if kv_valid is None else kv_valid
        same = seg_q[:, None, :, None] == seg_k[:, None, None, :]
        s = s + torch.where(same, 0.0, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return (out / p.sum(dim=-1).transpose(1, 2)[..., None]).to(q.dtype)


def flash_segment(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_valid: Optional[torch.Tensor] = None,
                  kv_valid: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Non-causal attention of q [B, Sq, H, D] over k, v [B, Sk, H, D] with
    segment ids from ``q_valid`` [B, Sq] and ``kv_valid`` [B, Sk] (None:
    every position valid); returns [B, Sq, H, D] in q's dtype."""
    tensors = [t for t in (q, k, v, q_valid, kv_valid) if t is not None]
    if not backend.on_cuda(*tensors):
        return flash_sdpa_plain(q, k, v, q_valid, kv_valid, scale)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if D not in SEGMENT_HEAD_DIMS:
        raise ValueError(f"flash_segment: head dim {D}; the kernel takes {SEGMENT_HEAD_DIMS}")
    backend.require(q, "q", torch.bfloat16, (B, Sq, H, D))
    for name, t in (("k", k), ("v", v)):
        backend.require(t, name, torch.bfloat16, (B, Sk, H, D))
    for name, t, S in (("q_valid", q_valid, Sq), ("kv_valid", kv_valid, Sk)):
        if t is not None:
            backend.require(t, name, torch.bool, (B, S))
    scale = 1.0 / (D**0.5) if scale is None else scale
    out = torch.empty_like(q)
    p = backend.ptr
    err = library().aria_flash_segment(p(q), p(k), p(v), p(q_valid), p(kv_valid), p(out),
                                       B, Sq, Sk, H, D, ctypes.c_float(scale), backend.stream())
    backend.check(err, "flash_segment")
    flash_segment.launches += 1
    return out


flash_segment.launches = 0


def flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False,
               q_valid: Optional[torch.Tensor] = None,
               kv_valid: Optional[torch.Tensor] = None,
               scale: Optional[float] = None) -> torch.Tensor:
    """The JAX signature (flash.py:30): causal attention from position 0
    through ``flash_causal``, non-causal attention with segment ids through
    ``flash_segment``. Returns [B, Sq, H, D]."""
    if not causal:
        return flash_segment(q, k, v, q_valid, kv_valid, scale)
    if q_valid is not None or kv_valid is not None:
        raise NotImplementedError("flash_sdpa: causal attention with padding masks is on no "
                                  "path of the port")
    return flash_causal(q, k, v, scale)
