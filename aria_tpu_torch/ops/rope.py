"""Interleaved rotary position embeddings (counterpart of aria_tpu/ops/rope.py).

Frequencies ``base**(-2i/d)``, angles in f32, rotation of the interleaved
pairs ``(x[..., 0::2], x[..., 1::2])``, result cast back to the input dtype.
Below 8,192 tokens the rotation runs in f32; from 8,192 tokens on it runs
in the input dtype, with cos and sin rounded to it once (rope.py:38), as the
JAX package does to keep a long prefill's f32 temporaries out of memory.
"""

from __future__ import annotations

import torch

LONG_SEQ = 8192  # from this many tokens on, rotate in the input dtype


def precompute_rope(positions: torch.Tensor, head_dim: int, base: float):
    """Return (cos, sin), each [..., head_dim // 2], f32, for positions
    [S] or [B, S]."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    freqs = 1.0 / (torch.tensor(base, dtype=torch.float32, device=positions.device) ** exps)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; cos/sin: [S, D/2], or [B, S, D/2] for per-lane
    positions (rope.py:27-54)."""
    cdt = torch.float32 if x.shape[1] < LONG_SEQ else x.dtype
    xf, cos, sin = x.to(cdt), cos.to(cdt), sin.to(cdt)
    x_even, x_odd = xf[..., 0::2], xf[..., 1::2]
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out_even = x_even * cos - x_odd * sin
    out_odd = x_odd * cos + x_even * sin
    return torch.stack([out_even, out_odd], dim=-1).reshape(x.shape).to(x.dtype)
