"""Prompt-lookup speculative decoding (counterpart of
aria_tpu/engine/speculative.py): draft k tokens from the stream's own
history by n-gram lookup, then verify them in one forward of k + 1 tokens.

The matcher, the acceptance and the history stay on the device as torch
ops on [B, ...] tensors, so the engine runs a chunk of verify steps with
one read-back (``engine/generate.py``). The JAX package runs them in XLA;
they are no kernel here either. The verify forward is the decoder's own:
``dense_int4`` and the decode MoE at T = k + 1 rows, ``rope_kv_write`` at
one slot a token, and attention over the written cache (``sdpa`` on the
dequantized plane, models/moe_lm.py).

Rejected draft positions need no rollback: their cache rows lie past the
accepted length, every later mask stops before them, and they are written
again when those positions are reached.

Correctness:
- greedy (temperature <= 0): a draft token is accepted only where it is
  the argmax, so the stream is plain greedy decode's, token for token, in
  exact or CPU f32 arithmetic. On the card the verify step's plain
  attention over k + 1 rows is not bit-equal to the decode kernel over
  one, so a near tie may go the other way (ROADMAP queue 3 (b)).
- sampled: accept draft d with probability p(d) under the engine's filtered
  distribution; on a rejection, draw from p with d removed. The marginal
  at each position is p: p(d) 1[x = d] + (1 - p(d)) p(x) 1[x != d] / (1 -
  p(d)) = p(x).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from aria_tpu_torch.engine.sampling import NEG_INF, filter_min_p, filter_top_k, filter_top_p


@dataclasses.dataclass(frozen=True)
class SpeculativeConfig:
    k: int = 7  # drafted tokens per verify step (verify feeds k+1)
    ngram: int = 2  # suffix length the prompt-lookup matcher keys on
    steps_per_chunk: int = 8  # verify steps per read-back


def ngram_draft(hist: torch.Tensor, hist_len: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """Draft ``k`` continuation tokens by prompt lookup (speculative.py:55-83).

    ``hist`` [B, S] holds prompt + produced tokens; ``hist_len`` [B] counts
    the valid prefix (``hist[:, hist_len - 1]`` is the token about to be
    fed). Finds the latest earlier occurrence of the trailing ``n``-gram
    and proposes the k tokens that followed it; with no match, the tokens
    at the tail. A draft moves only the speed, never the output. Returns
    [B, k] int32."""
    B, S = hist.shape
    dev = hist.device
    win = hist.unfold(1, n, 1)  # [B, S - n + 1, n]: win[b, i] = hist[b, i:i+n]
    hl = hist_len.long()
    tgt = hist.gather(1, (hl - n)[:, None] + torch.arange(n, device=dev)[None, :])
    idx = torch.arange(S - n + 1, device=dev)
    m = (win == tgt[:, None, :]).all(dim=-1)
    m &= idx[None, :] < (hl - n)[:, None]  # strictly before the suffix
    best = torch.where(m, idx[None, :], torch.full_like(m, -1, dtype=torch.long)).amax(dim=-1)
    start = torch.where(best >= 0, best + n, hl)
    start = start.clamp(0, S - k)  # as dynamic_slice clamps its start
    return hist.gather(1, start[:, None] + torch.arange(k, device=dev)[None, :]).to(torch.int32)


def verify_greedy(logits: torch.Tensor, draft: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy acceptance (speculative.py:86-100). ``logits`` [B, k+1, V]
    (position i conditions on the prefix and draft[:i]), ``draft`` [B, k].
    Returns (produced [B, k+1] int32, n_prod [B] int32): the argmax tokens,
    correct wherever the draft prefix matched, and one bonus token at the
    first mismatch."""
    tgt = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, k+1]
    match = (draft == tgt[:, :-1]).to(torch.int32)
    n_acc = torch.cumprod(match, dim=1).sum(dim=1)  # leading matches
    return tgt, (n_acc + 1).to(torch.int32)


def verify_sampled(
    generator: torch.Generator,
    logits: torch.Tensor,  # [B, k+1, V]
    draft: torch.Tensor,  # [B, k]
    temperature: float,
    top_k: Optional[int],
    top_p: Optional[torch.Tensor] = None,  # [B]
    min_p: Optional[torch.Tensor] = None,  # [B]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rejection-sampled acceptance that keeps the target distribution
    (speculative.py:103-144), drawing from ``generator``: (produced [B,
    k+1] int32, n_prod [B] int32)."""
    B, K1, V = logits.shape
    k = K1 - 1
    dev = logits.device
    scaled = logits.reshape(B * K1, V).float() / max(float(temperature), 1e-5)
    if top_k is not None:
        scaled = filter_top_k(scaled, top_k)
    if top_p is not None:
        scaled = filter_top_p(scaled, top_p.repeat_interleave(K1))
    if min_p is not None:
        scaled = filter_min_p(scaled, min_p.repeat_interleave(K1))
    logp = torch.log_softmax(scaled, dim=-1).reshape(B, K1, V)

    p_draft = logp[:, :k].exp().gather(-1, draft.long()[..., None])[..., 0]  # [B, k]
    u = torch.rand((B, k), generator=generator, device=dev)
    accept = u < p_draft
    n_acc = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)  # [B]

    # the bonus draw at position n_acc: the residual (the target without
    # the rejected draft token) on a rejection, the plain target at k
    la = logp.gather(1, n_acc[:, None, None].expand(B, 1, V))[:, 0]  # [B, V]
    dpad = torch.cat([draft, draft[:, -1:]], dim=1).long()
    d_a = dpad.gather(1, n_acc[:, None])  # [B, 1]
    rejected = (n_acc < k)[:, None]
    vocab = torch.arange(V, device=dev)[None, :]
    la = torch.where(rejected & (vocab == d_a), torch.full_like(la, NEG_INF), la)
    g = torch.rand(la.shape, generator=generator, device=dev)
    g = torch.clamp_min(g, torch.finfo(torch.float32).tiny)
    bonus = torch.argmax(la - torch.log(-torch.log(g)), dim=-1).to(torch.int32)

    prod = torch.cat([draft.to(torch.int32), torch.zeros((B, 1), dtype=torch.int32,
                                                         device=dev)], dim=1)
    onehot = torch.arange(K1, device=dev)[None, :] == n_acc[:, None]
    prod = torch.where(onehot, bonus[:, None], prod)
    return prod, (n_acc + 1).to(torch.int32)
