"""Top-k routing and the GLU (counterpart of aria_tpu/ops/moe.py:44-86).

Softmax is taken over the top-k logits only, in f32, and cast back to the
activation dtype. Only the eval-mode router is ported: the slice serves and
does not train, so the z and aux losses are not computed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class RouterOutput(NamedTuple):
    weights: torch.Tensor  # [T, k] combine weights
    indices: torch.Tensor  # [T, k] int32 expert ids


def route_topk(x: torch.Tensor, gate_weight: torch.Tensor, topk: int) -> RouterOutput:
    """x [T, D], gate_weight [E, D] (f32); logits in f32."""
    logits = x.float() @ gate_weight.float().T
    top_logits, top_indices = torch.topk(logits, topk, dim=-1)
    scores = torch.softmax(top_logits, dim=-1)
    return RouterOutput(scores.to(x.dtype), top_indices.to(torch.int32))


def glu(x: torch.Tensor) -> torch.Tensor:
    gate, up = x.chunk(2, dim=-1)
    return F.silu(gate) * up
