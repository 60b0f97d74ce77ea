"""Plain masked attention (counterpart of aria_tpu/ops/attention.py).

Used by the kernels' plain versions, by the tests, and on the card by the
paged server's prefill chunk (``models/moe_lm.py``), which attends the
lanes' gathered pages as the JAX package attends them in XLA; the other
paths attend through the flash and decode-attention kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def sdpa(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, H, D]
    v: torch.Tensor,  # [B, Sk, H, D]
    mask: Optional[torch.Tensor] = None,  # broadcastable to [B, H, Sq, Sk]; True = attend
    scale: Optional[float] = None,
) -> torch.Tensor:
    """f32 softmax with NEG_INF masking; returns [B, Sq, H, D] in q's dtype.
    Multi-head only (the port's attention kernels take no GQA)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def causal_mask(sq: int, sk: int, device=None) -> torch.Tensor:
    """[1, 1, sq, sk] boolean mask; query i attends key j iff j <= i."""
    qi = torch.arange(sq, device=device)[:, None]
    kj = torch.arange(sk, device=device)[None, :]
    return (kj <= qi)[None, None]
