"""RMSNorm and LayerNorm, computed in f32 and cast back (counterpart of
aria_tpu/ops/norms.py)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = (xf * torch.reciprocal(torch.sqrt(var + eps))).to(x.dtype)
    return normed * weight


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Normalize in f32, cast to x's dtype, then ``* weight + bias``."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    normed = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps))
    return normed.to(x.dtype) * weight + bias
