"""RMSNorm, computed in f32 and cast back (counterpart of aria_tpu/ops/norms.py)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = (xf * torch.reciprocal(torch.sqrt(var + eps))).to(x.dtype)
    return normed * weight
