"""Weight quantizers and their inverses (counterpart of aria_tpu/ops/quant.py
and the quantizer half of aria_tpu/ops/dense_int4.py).

Formats, byte for byte the JAX package's:

- int8 per-output-channel: ``{"q": int8, "s": f32 [..., out]}``.
- int4 experts: w1 ``{"q4": int8 [..., 2I, D/2], "sg": bf16 [..., 8, 2I]}``
  with within-group nibble pairing over D (rows 0..ng-1 of ``sg`` are the
  D-group scales, the rank-1 row factor of w2 folded into the up half);
  w2 ``{"q4": int8 [..., I, D/2], "s8": bf16 [..., 8, D]}`` with whole-row
  pairing over D and the column scale c/7 in every row of ``s8``.
- dense int4: ``{"q4t": int8 [L, F, D/2], "sg": bf16 [L, 8, F]}``.

A packed byte is B = 16*hi + (lo + 8) ("biased-lo"); ``hi`` comes back with
an arithmetic shift of the signed byte.
"""

from __future__ import annotations

from typing import Any

import torch

INT4_GROUP_LANES = 256


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def is_quantized_int4(w: Any) -> bool:
    return isinstance(w, dict) and "q4" in w


def is_dense_int4(w: Any) -> bool:
    return isinstance(w, dict) and "q4t" in w


def int4_group_count(D: int) -> int:
    """Largest ng in 2..8 with D % ng == 0 and (D // ng) % 256 == 0, else 1."""
    for ng in range(8, 1, -1):
        if D % ng == 0 and (D // ng) % INT4_GROUP_LANES == 0:
            return ng
    return 1


def quantize_weight(w: torch.Tensor, input_axis: int = -2) -> dict:
    """Symmetric per-output-channel int8: amax over the input axis."""
    wf = w.float()
    amax = torch.amax(torch.abs(wf), dim=input_axis, keepdim=True)
    scale = torch.clamp_min(amax * (1.0 / 127.0), 1e-12)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q.contiguous(), "s": scale.squeeze(input_axis).float().contiguous()}


def dequantize_weight(w: dict, input_axis: int = -2, dtype=torch.bfloat16) -> torch.Tensor:
    s = w["s"].unsqueeze(input_axis)
    return (w["q"].float() * s).to(dtype)


VIT_QUANT_KEYS = ("wq", "wk", "wv", "wo", "fc1_w", "fc2_w")
PROJECTOR_QUANT_KEYS = (
    "q_proj", "k_proj", "v_proj", "attn_out_w", "linear_w", "ffn_in", "ffn_out",
)


def quantize_vit_params(vit_params: dict) -> dict:
    """int8 vision tower: the patch embedding and the per-layer projections
    (weights [L, in, out], scale over out); norms, biases and the position
    table stay float (quant.py:151-164)."""
    out = dict(vit_params)
    out["patch_embed_w"] = quantize_weight(vit_params["patch_embed_w"], input_axis=-2)
    layers = dict(vit_params["layers"])
    for key in VIT_QUANT_KEYS:
        layers[key] = quantize_weight(layers[key], input_axis=-2)
    out["layers"] = layers
    return out


def quantize_projector_params(proj_params: dict) -> dict:
    """int8 projector; ``attn_in_w`` stays float, as it is column-sliced into
    the three packed MultiheadAttention projections (quant.py:167-176)."""
    out = dict(proj_params)
    for key in PROJECTOR_QUANT_KEYS:
        out[key] = quantize_weight(proj_params[key], input_axis=-2)
    return out


def linear(x: torch.Tensor, w, spec: str) -> torch.Tensor:
    """einsum(spec, x, w) returning f32; a quantized weight's scale runs over
    the spec's last output axis. The products are torch.matmul, as the JAX
    package leaves them to XLA: on the card a bf16 x gives a bf16 product
    (f32 accumulation, rounded once) before the f32 scale."""
    if is_quantized(w):
        return torch.einsum(spec, x, w["q"].to(x.dtype)).float() * w["s"]
    return torch.einsum(spec, x, w).float()


def pack_int4(q: torch.Tensor, group: int) -> torch.Tensor:
    """Pack int4 values (int8 storage, [-8, 7]) two per byte with
    within-group pairing along the last axis: column j of a group rides the
    low nibble (biased by +8), column j + group/2 the high nibble."""
    *lead, A = q.shape
    if A % group or group % 2:
        raise ValueError(f"pack_int4: axis {A} and group {group}")
    qr = q.to(torch.int8).reshape(*lead, A // group, 2, group // 2)
    lo = (qr[..., 0, :] + 8) & 0xF
    hi = qr[..., 1, :] << 4
    return (lo | hi).to(torch.int8).reshape(*lead, A // 2).contiguous()


def unpack_int4(p: torch.Tensor, group: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of pack_int4."""
    *lead, Ap = p.shape
    gp = group // 2
    pr = p.reshape(*lead, Ap // gp, gp)
    lo = ((pr & 0xF) - 8).to(dtype)
    hi = (pr >> 4).to(dtype)
    return torch.stack([lo, hi], dim=-2).reshape(*lead, 2 * Ap)


def _pad8(s: torch.Tensor) -> torch.Tensor:
    """[..., R, ng] -> [..., 8, R]: rows 0..ng-1 are the groups, then zeros."""
    s = s.transpose(-1, -2)
    pad = torch.zeros(*s.shape[:-2], 8 - s.shape[-2], s.shape[-1], dtype=s.dtype, device=s.device)
    return torch.cat([s, pad], dim=-2).contiguous()


def quantize_expert_int4(w1: torch.Tensor, w2: torch.Tensor) -> tuple:
    """w1: [..., 2I, D] out-major; w2: [..., I, D]. Returns (w1_dict, w2_dict)."""
    *lead, R, D = w1.shape
    I = R // 2
    ng = int4_group_count(D)
    gs = D // ng

    w1f = w1.float().reshape(*lead, R, ng, gs)
    amax1 = torch.amax(torch.abs(w1f), dim=-1)
    sg = torch.clamp_min(amax1 * (1.0 / 7.0), 1e-8)
    q1 = torch.clamp(torch.round(w1f / sg[..., None]), -8, 7).to(torch.int8).reshape(*lead, R, D)

    # rank-1 scale fit for w2: r per input row, c per output column
    w2f = w2.float()
    a2 = torch.abs(w2f)
    r = torch.clamp_min(torch.amax(a2, dim=-1), 1e-8)
    c = torch.clamp_min(torch.amax(a2 / r[..., None], dim=-2), 1e-8)
    s2_elem = r[..., :, None] * c[..., None, :] * (1.0 / 7.0)
    q2 = torch.clamp(torch.round(w2f / s2_elem), -8, 7).to(torch.int8)

    # fold r into the up-half group scales
    sg = torch.cat([sg[..., :I, :], sg[..., I:, :] * r[..., None]], dim=-2)

    w1_dict = {"q4": pack_int4(q1, gs), "sg": _pad8(sg).to(torch.bfloat16)}
    c8 = (c * (1.0 / 7.0))[..., None, :].expand(*c.shape[:-1], 8, D)
    w2_dict = {"q4": pack_int4(q2, D), "s8": c8.to(torch.bfloat16).contiguous()}
    return w1_dict, w2_dict


def _deq_compute_dtype(dtype):
    # int4 values and the stored bf16 scales are exact in bf16: a bf16
    # unpack-and-scale rounds once, like computing in f32 and casting
    return dtype if dtype == torch.bfloat16 else torch.float32


def dequantize_w1_int4(w1: dict, dtype=torch.bfloat16) -> torch.Tensor:
    q4, sg = w1["q4"], w1["sg"]
    *lead, R, Dp = q4.shape
    D = 2 * Dp
    ng = int4_group_count(D)
    gs = D // ng
    cd = _deq_compute_dtype(dtype)
    vals = unpack_int4(q4, gs, cd).reshape(*lead, R, ng, gs)
    s = sg[..., :ng, :].transpose(-1, -2)
    return (vals * s[..., None].to(cd)).reshape(*lead, R, D).to(dtype)


def dequantize_w2_int4(w2: dict, dtype=torch.bfloat16) -> torch.Tensor:
    q4, s8 = w2["q4"], w2["s8"]
    D = 2 * q4.shape[-1]
    cd = _deq_compute_dtype(dtype)
    vals = unpack_int4(q4, D, cd)
    return (vals * s8[..., 0:1, :].to(cd)).to(dtype)


def quantize_dense_int4(w: torch.Tensor) -> dict:
    """[L, D_in, F_out] (right-multiply layout) -> {"q4t": int8 [L, F, D/2],
    "sg": bf16 [L, 8, F]} with groupwise scales over D."""
    wt = w.transpose(-1, -2)
    *lead, F, D = wt.shape
    ng = int4_group_count(D)
    gs = D // ng
    wf = wt.float().reshape(*lead, F, ng, gs)
    amax = torch.amax(torch.abs(wf), dim=-1)
    sg = torch.clamp_min(amax * (1.0 / 7.0), 1e-8)
    q = torch.clamp(torch.round(wf / sg[..., None]), -8, 7).to(torch.int8).reshape(*lead, F, D)
    return {"q4t": pack_int4(q, gs), "sg": _pad8(sg).to(torch.bfloat16)}


def dequantize_dense_int4(w: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse transform back to the [L, D, F] right-multiply layout."""
    q4t, sg = w["q4t"], w["sg"]
    *lead, F, Dp = q4t.shape
    D = 2 * Dp
    ng = int4_group_count(D)
    gs = D // ng
    vals = unpack_int4(q4t, gs, torch.float32).reshape(*lead, F, ng, gs)
    s = sg[..., :ng, :].transpose(-1, -2).float()
    wt = (vals * s[..., None]).reshape(*lead, F, D)
    return wt.transpose(-1, -2).to(dtype)
