"""Perceiver-style cross-attention resampler, "the projector" (counterpart
of aria_tpu/models/projector.py).

A learned query bank (256 queries for a 980px crop) cross-attends over the
ViT's patch features, then an FFN maps to the LM width. Keys, queries and
values are projected twice, as the reference's CrossAttention around
``nn.MultiheadAttention`` does: the module's own q/k/v projections, then
the packed in-projection's column slices. Attention is the plain masked
``sdpa`` over the ViT's ``kv_ignore_mask``: the JAX package has no kernel
here either.
"""

from __future__ import annotations

from typing import Optional

import torch

from aria_tpu_torch.config import ProjectorConfig
from aria_tpu_torch.ops import backend
from aria_tpu_torch.ops.activations import gelu_tanh
from aria_tpu_torch.ops.attention import sdpa
from aria_tpu_torch.ops.norms import layer_norm
from aria_tpu_torch.ops.quant import linear


def init_projector_params(cfg: ProjectorConfig, generator: torch.Generator, *, device="cuda",
                          dtype=torch.bfloat16) -> dict:
    """Random init with the structure of projector.py:29-56, on the card
    unless ``device`` names another."""
    device = backend.device(device)
    E, KV = cfg.embed_dim, cfg.kv_dim

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * fan_in**-0.5).to(dtype)

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "query": dense((cfg.max_queries, E), E),
        "ln_q_w": const((E,), 1.0), "ln_q_b": const((E,), 0.0),
        "ln_kv_w": const((KV,), 1.0), "ln_kv_b": const((KV,), 0.0),
        "q_proj": dense((E, E), E),
        "k_proj": dense((KV, E), KV),
        "v_proj": dense((KV, E), KV),
        "attn_in_w": dense((E, 3 * E), E), "attn_in_b": const((3 * E,), 0.0),
        "attn_out_w": dense((E, E), E), "attn_out_b": const((E,), 0.0),
        "linear_w": dense((E, E), E), "linear_b": const((E,), 0.0),
        "ln_ffn_w": const((E,), 1.0), "ln_ffn_b": const((E,), 0.0),
        "ffn_in": dense((E, cfg.ff_dim), E),
        "ffn_out": dense((cfg.ff_dim, cfg.output_dim), cfg.ff_dim),
    }


def projector_forward(
    params: dict,
    cfg: ProjectorConfig,
    x: torch.Tensor,  # [N, P, KV] patch features
    kv_ignore_mask: Optional[torch.Tensor] = None,  # [N, P] bool, True = ignore key
) -> torch.Tensor:
    """Returns [N, Q, output_dim] image features in x's dtype."""
    N, P, _ = x.shape
    Q = cfg.query_count(P)
    E, H, Dh = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    queries = params["query"][None, :Q, :].expand(N, Q, E).to(x.dtype)

    q_in = layer_norm(queries, params["ln_q_w"], params["ln_q_b"], cfg.layer_norm_eps)
    q1 = linear(q_in, params["q_proj"]).to(x.dtype)
    kv_in = layer_norm(x, params["ln_kv_w"], params["ln_kv_b"], cfg.layer_norm_eps)
    k1 = linear(kv_in, params["k_proj"]).to(x.dtype)
    v1 = linear(kv_in, params["v_proj"]).to(x.dtype)

    in_w, in_b = params["attn_in_w"], params["attn_in_b"]
    q2 = torch.einsum("nqe,ef->nqf", q1, in_w[:, :E]) + in_b[:E]
    k2 = torch.einsum("npe,ef->npf", k1, in_w[:, E:2 * E]) + in_b[E:2 * E]
    v2 = torch.einsum("npe,ef->npf", v1, in_w[:, 2 * E:]) + in_b[2 * E:]

    attend = None if kv_ignore_mask is None else torch.logical_not(kv_ignore_mask)[:, None, None, :]
    att = sdpa(q2.reshape(N, Q, H, Dh), k2.reshape(N, P, H, Dh), v2.reshape(N, P, H, Dh),
               attend).reshape(N, Q, E)
    att = (linear(att, params["attn_out_w"]) + params["attn_out_b"]).to(x.dtype)
    att = (linear(att, params["linear_w"]) + params["linear_b"]).to(x.dtype)

    h = layer_norm(att, params["ln_ffn_w"], params["ln_ffn_b"], cfg.layer_norm_eps)
    h = gelu_tanh(linear(h, params["ffn_in"])).to(x.dtype)
    return linear(h, params["ffn_out"]).to(x.dtype)
