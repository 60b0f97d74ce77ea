"""The tanh-approximate GELU of the projector FFN and the ViT MLP, in f32
and cast back (counterpart of aria_tpu/ops/activations.py:15-18)."""

from __future__ import annotations

import torch

_SQRT_2_OVER_PI = 0.7978845608028654


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    out = 0.5 * xf * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (xf + 0.044715 * xf**3)))
    return out.to(x.dtype)
