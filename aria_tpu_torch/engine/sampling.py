"""Sampling on the device, with no host round trip (counterpart of
aria_tpu/engine/sampling.py:20-142).

Temperature, then top-k, top-p and min-p on the scaled logits (vLLM's
order), then a Gumbel-argmax draw from an explicit ``torch.Generator``.
Top-k is exact ``torch.topk`` where the JAX package takes the TPU's
``approx_max_k``. The batched engine gives per-row temperatures and
applies the presence, frequency and repetition penalties first.
``token_logprobs`` reports a token's log-probability and the top k
alternatives under the raw logits.
"""

from __future__ import annotations

from typing import Optional, Union

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


def apply_penalties(
    logits: torch.Tensor,  # [B, V] f32
    counts: torch.Tensor,  # [B, V] output-token counts
    prompt_mask: torch.Tensor,  # [B, V] bool: token appeared in the prompt
    presence: torch.Tensor,  # [B]
    frequency: torch.Tensor,  # [B]
    repetition: torch.Tensor,  # [B] (1.0 = off)
) -> torch.Tensor:
    """OpenAI/vLLM penalties per row (sampling.py:74-98): repetition
    divides positive and multiplies negative raw logits of tokens seen in
    the prompt or the output, then presence (once) and frequency (per
    occurrence) subtract for tokens seen in the output."""
    c = counts.float()
    out_seen = c > 0.0
    rep = torch.clamp_min(repetition.float(), 1e-6)[:, None]
    penalized = torch.where(logits > 0.0, logits / rep, logits * rep)
    logits = torch.where(out_seen | prompt_mask, penalized, logits)
    return logits - presence.float()[:, None] * out_seen - frequency.float()[:, None] * c


def update_counts(counts: torch.Tensor, toks: torch.Tensor,
                  active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Add 1 at each row's sampled token, rows where ``active`` is False
    left alone (sampling.py:101-109). In place; returns ``counts``."""
    one = torch.ones((counts.shape[0], 1), dtype=counts.dtype, device=counts.device)
    if active is not None:
        one = one * active.to(counts.dtype)[:, None]
    return counts.scatter_add_(1, toks.long()[:, None], one)


def sample(
    generator: torch.Generator,
    logits: torch.Tensor,  # [B, V]
    temperature: Union[float, torch.Tensor] = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[torch.Tensor] = None,
    min_p: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Returns [B] int32 token ids; temperature <= 0 means greedy, whatever
    the filters (as in the JAX package). ``temperature`` is one float, or a
    [B] tensor of per-row temperatures (sampling.py:126-142), where rows at
    <= 0 take the argmax of the raw logits and the rest are drawn."""
    per_row = isinstance(temperature, torch.Tensor)
    if per_row:
        scaled = logits.float() / torch.clamp_min(temperature.float(), 1e-5)[:, None]
    elif temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    else:
        scaled = logits.float() / max(float(temperature), 1e-5)
    if top_k is not None:
        scaled = filter_top_k(scaled, top_k)
    if top_p is not None:
        scaled = filter_top_p(scaled, top_p)
    if min_p is not None:
        scaled = filter_min_p(scaled, min_p)
    u = torch.rand(scaled.shape, generator=generator, device=logits.device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    sampled = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    if per_row:
        sampled = torch.where(temperature <= 0.0, torch.argmax(logits, dim=-1), sampled)
    return sampled.to(torch.int32)


def token_logprobs(logits: torch.Tensor, toks: torch.Tensor, k: int = 5):
    """Natural-log probabilities for OpenAI-style ``logprobs``
    (sampling.py:145-158): (chosen [B], top_ids [B, k] int32, top_lps [B,
    k]) under the raw, pre-temperature log-softmax in f32. The top k are
    exact ``torch.topk`` where the JAX package takes ``approx_max_k``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    chosen = logp.gather(-1, toks.long()[:, None])[:, 0]
    top_lps, top_ids = torch.topk(logp, k, dim=-1)
    return chosen, top_ids.to(torch.int32), top_lps
