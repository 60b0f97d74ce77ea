"""Sampling on the device, with no host round trip (counterpart of
aria_tpu/engine/sampling.py:20-142).

Temperature, then top-k, top-p and min-p on the scaled logits (vLLM's
order), then a Gumbel-argmax draw from an explicit ``torch.Generator``.
Top-k is exact ``torch.topk`` where the JAX package takes the TPU's
``approx_max_k``. Penalties are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
TOP_P_SHORTLIST = 256  # sorted head on which the nucleus cutoff is found


def filter_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keep the top-k logits of each row, set the rest to NEG_INF."""
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def filter_top_p(logits: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Nucleus filter with per-row ``top_p`` [B]: keep the smallest prefix of
    the descending distribution whose mass reaches top_p, found on a sorted
    top-256 head (rows whose head never reaches top_p pass)."""
    p = top_p.float()[:, None]
    head = torch.topk(logits, min(TOP_P_SHORTLIST, logits.shape[-1]), dim=-1).values
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    probs = torch.exp(head - lse)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < p
    cutoff = torch.where(keep, head, torch.full_like(head, float("inf"))).amin(dim=-1, keepdim=True)
    cutoff = torch.where(p >= cum[..., -1:], torch.full_like(cutoff, float("-inf")), cutoff)
    return torch.where(logits < cutoff, torch.full_like(logits, NEG_INF), logits)


def filter_min_p(logits: torch.Tensor, min_p: torch.Tensor) -> torch.Tensor:
    """Keep tokens with probability >= min_p * max probability (per-row
    [B]; rows with min_p <= 0 pass)."""
    mp = min_p.float()[:, None]
    cutoff = logits.amax(dim=-1, keepdim=True) + torch.log(torch.clamp_min(mp, 1e-30))
    drop = (mp > 0.0) & (logits < cutoff)
    return torch.where(drop, torch.full_like(logits, NEG_INF), logits)


def sample(
    generator: torch.Generator,
    logits: torch.Tensor,  # [B, V]
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[torch.Tensor] = None,
    min_p: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Returns [B] int32 token ids; temperature <= 0 means greedy, whatever
    the filters (as in the JAX package). One temperature for every row: the
    per-row form serves the batched engine, which is not ported yet."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.float() / max(float(temperature), 1e-5)
    if top_k is not None:
        scaled = filter_top_k(scaled, top_k)
    if top_p is not None:
        scaled = filter_top_p(scaled, top_p)
    if min_p is not None:
        scaled = filter_min_p(scaled, min_p)
    u = torch.rand(scaled.shape, generator=generator, device=logits.device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1).to(torch.int32)
