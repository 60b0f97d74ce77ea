"""Weight quantizers and their inverses (counterpart of aria_tpu/ops/quant.py
and the quantizer half of aria_tpu/ops/dense_int4.py).

Formats, byte for byte the JAX package's:

- int8 per-output-channel: ``{"q": int8, "s": f32 [..., out]}``; int8
  experts add ``"s8"``, the scale broadcast to [..., 8, out] (w1 [L, E,
  2I, D] scaled per row of 2I, w2 [L, E, I, D] per column of D).
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
    """q * s in f32, rounded once to ``dtype``: one pass, the f32 product
    never stored (a layer's int8 experts are 843M weights at flagship)."""
    q = w["q"]
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    return torch.mul(q, w["s"].unsqueeze(input_axis), out=out)


def with_s8(qw: dict) -> dict:
    """Attach the scale broadcast to [..., 8, out], as the expert kernels
    read it (quant.py:59-64)."""
    s = qw["s"]
    return {**qw, "s8": s[..., None, :].expand(*s.shape[:-1], 8, s.shape[-1]).contiguous()}


# the decoder's weights that the int8 form quantizes (quant.py:26), the
# largest first, each with its input axis and whether it carries ``s8``
# (w1 [L, E, 2I, D] over D, w2 [L, E, I, D] over I, the rest per output
# channel); norms, the router gate and embed stay float
LM_QUANT_KEYS = {"w1": (-1, True), "w2": (-2, True), "wqkv": (-2, False), "wo": (-2, False),
                 "shared_w1": (-2, False), "shared_w2": (-2, False)}
# experts quantized at a time: bounds the f32 temporaries of an expert stack
# (``quantize_weight`` of a whole flagship w1 would take a 61 GB f32 copy)
QUANT_SLAB = 16


def _quantize_stack(w: torch.Tensor, input_axis: int) -> dict:
    """``quantize_weight(w, input_axis)`` of an [L, ...] stack, one layer
    (of expert stacks [L, E, R, D], ``QUANT_SLAB`` experts) at a time into
    preallocated int8 values and f32 scales. Each scale covers one row or
    column inside an expert, so the bits are those of the whole stack's."""
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    sshape = list(w.shape)
    del sshape[input_axis]
    s = torch.empty(sshape, dtype=torch.float32, device=w.device)
    for layer in range(w.shape[0]):
        parts = range(0, w.shape[1], QUANT_SLAB) if w.dim() == 4 else (None,)
        for e0 in parts:
            at = (layer,) if e0 is None else (layer, slice(e0, e0 + QUANT_SLAB))
            part = quantize_weight(w[at], input_axis)
            q[at], s[at] = part["q"], part["s"]
    return {"q": q, "s": s}


def _quantize_layers(layers: dict) -> dict:
    """Replace ``layers``' ``LM_QUANT_KEYS`` stacks by their int8 forms, in
    place, and return it; each float stack is let go as soon as its int8
    form is whole (shared_w1/w2 are gone after fuse_shared_experts)."""
    for key, (axis, s8) in LM_QUANT_KEYS.items():
        if key in layers:
            qw = _quantize_stack(layers[key], axis)
            layers[key] = with_s8(qw) if s8 else qw
    return layers


def quantize_lm_layers(layers: dict) -> dict:
    """The int8 form of a decoder's [L, ...] layer stacks (any L), in a new
    dict; norms and the gate unchanged."""
    return _quantize_layers(dict(layers))


def quantize_lm_params(lm_params: dict) -> dict:
    """The int8 serving form of the decoder (quant.py:123-141): w1 is
    out-major [L, E, 2I, D] and quantized over D (a scale per row of 2I),
    w2 [L, E, I, D] over I (a scale per column of D), both with ``s8``;
    every other weight is [..., in, out] with a scale per output; lm_head
    int8, embed unchanged."""
    return {**lm_params, "layers": quantize_lm_layers(lm_params["layers"]),
            "lm_head": quantize_weight(lm_params["lm_head"], input_axis=-2)}


def quantize_params(params: dict) -> dict:
    """Quantize the decoder; the ViT and projector stay as they are
    (quant.py:144-148)."""
    return {**params, "lm": quantize_lm_params(params["lm"])}


def quantize_params_by_layer(params: dict) -> dict:
    """``quantize_params`` (the JAX package's QLoRA base, loop.py:132-140)
    made in place, a layer (an expert slab) at a time, bit for bit the
    whole-tree quantization: each float leaf leaves ``params`` as soon as
    its int8 form is whole, so the float base and its int8 form are never
    both whole. ``params`` is consumed (updated and returned); the caller
    holds no other reference to its float leaves. The tree keeps the JAX
    QLoRA form: w1, w2 with ``s8``; wqkv, wo, the unfused shared experts and
    lm_head int8; embed, norms and the gate float; the ViT and projector
    unchanged."""
    lm = params["lm"]
    _quantize_layers(lm["layers"])
    lm["lm_head"] = quantize_weight(lm["lm_head"], input_axis=-2)
    return params


def fuse_shared_experts(params: dict, num_shared: int = 2) -> dict:
    """Append the shared MLP to the expert stacks as ``num_shared`` always-on
    virtual experts (quant.py:67-120): its GLU is elementwise over the
    intermediate axis, so slice j of it is an expert of width I. Returns
    w1 [L, E+ns, 2I, D] and w2 [L, E+ns, I, D] with shared_w1/shared_w2
    removed, for a bf16 or an int8 tree (after ``quantize_params``): an
    int8 shared MLP is dequantized to bf16 and each virtual expert
    quantized like the routed ones, as the JAX function does."""
    lm = params["lm"]
    layers = dict(lm["layers"])
    w1, w2 = layers["w1"], layers["w2"]
    if is_quantized_int4(w1):
        raise NotImplementedError("fuse_shared_experts: the int4 form is built fused "
                                  "(init_lm_params_serving_int4)")
    quant = is_quantized(w1)
    L, E, I2, D = (w1["q"] if quant else w1).shape
    I = I2 // 2
    sw1, sw2 = layers.pop("shared_w1"), layers.pop("shared_w2")  # [L, D, 2Is], [L, Is, D]
    if is_quantized(sw1):
        sw1 = dequantize_weight(sw1, input_axis=-2)
        sw2 = dequantize_weight(sw2, input_axis=-2)
    Is = sw2.shape[1]
    if Is != num_shared * I:
        raise ValueError(f"fuse_shared_experts: shared width {Is} is not {num_shared} x {I}")
    # virtual expert j: rows j*I:(j+1)*I of the intermediate axis, out-major
    g = sw1[:, :, :Is].reshape(L, D, num_shared, I).permute(0, 2, 3, 1)  # [L, ns, I, D]
    u = sw1[:, :, Is:].reshape(L, D, num_shared, I).permute(0, 2, 3, 1)
    v_w1 = torch.cat([g, u], dim=2)  # [L, ns, 2I, D]
    v_w2 = sw2.reshape(L, num_shared, I, D)
    if quant:
        qv1 = with_s8(quantize_weight(v_w1, input_axis=-1))
        qv2 = with_s8(quantize_weight(v_w2, input_axis=-2))
        layers["w1"] = {k: torch.cat([w1[k], qv1[k]], dim=1) for k in w1}
        layers["w2"] = {k: torch.cat([w2[k], qv2[k]], dim=1) for k in w2}
    else:
        layers["w1"] = torch.cat([w1, v_w1.to(w1.dtype)], dim=1)
        layers["w2"] = torch.cat([w2, v_w2.to(w2.dtype)], dim=1)
    return {**params, "lm": {**lm, "layers": layers}}


def dequantize_expert_weights(w1, w2, dtype=torch.bfloat16):
    """One layer's experts as float stacks for the ragged path
    (quant.py:179-185): int8 ones dequantized (w1 over D, w2 over I), int4
    ones unpacked, bf16 ones returned as they are."""
    if is_quantized_int4(w1):
        return dequantize_w1_int4(w1, dtype), dequantize_w2_int4(w2, dtype)
    w1d = dequantize_weight(w1, input_axis=-1, dtype=dtype) if is_quantized(w1) else w1
    w2d = dequantize_weight(w2, input_axis=-2, dtype=dtype) if is_quantized(w2) else w2
    return w1d, w2d


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


class _MatmulF32(torch.autograd.Function):
    """a [M, K] @ b [K, N], or a [E, M, K] @ b [E, K, N], of two bf16 CUDA
    tensors with an f32 product: the card's bf16 tensor-core product with
    f32 sums and output (``out_dtype=torch.float32``). The gradients are
    f32 products of the f32 cotangent with the other operand, cast to each
    operand's dtype, as JAX transposes a dot with an f32
    ``preferred_element_type``."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        mm = torch.mm if a.dim() == 2 else torch.bmm
        return mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = (g @ b.float().transpose(-1, -2)).to(a.dtype) if ctx.needs_input_grad[0] else None
        db = (a.float().transpose(-1, -2) @ g).to(b.dtype) if ctx.needs_input_grad[1] else None
        return da, db


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., K] @ b [K, N], or a batched a [E, M, K] @ b [E, K, N], in
    f32, as ``jnp.einsum(..., preferred_element_type=jnp.float32)``: the
    product is never rounded to bf16. Two bf16 operands on the card take
    the tensor cores with an f32 output; anything else is an f32 product
    of the operands upcast (exact), which the card runs in full f32 (TF32
    is off by default)."""
    if b.dim() == 3:
        if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
            return _MatmulF32.apply(a, b)
        return a.float() @ b.float()
    lead, K = a.shape[:-1], a.shape[-1]
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        out = _MatmulF32.apply(a.reshape(-1, K), b)
    else:
        out = a.reshape(-1, K).float() @ b.float()
    return out.reshape(*lead, b.shape[-1])


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., in] @ w [in, out] returning f32, the JAX package's
    ``linear(x, w, spec)`` for its one form of spec ("...k,kn->...n"); a
    quantized weight's scale runs over the output axis. The product is f32
    from bf16 operands (``matmul_f32``), as the JAX package asks XLA for
    with ``preferred_element_type=jnp.float32`` (quant.py:50-56)."""
    if is_quantized(w):
        return matmul_f32(x, w["q"].to(x.dtype)) * w["s"]
    return matmul_f32(x, w)


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


def quantize_lm_params_int4(lm_params: dict) -> dict:
    """The int4 serving transform of the decoder (quant.py:332-350): the
    expert stacks int4, wqkv / wo dense int4, an unfused shared MLP, embed
    and lm_head int8 (embed dequantized per lookup). Apply after
    ``fuse_shared_experts`` (or before: then the shared MLP stays int8).
    The streamed HF import's oracle."""
    layers = dict(lm_params["layers"])
    for key in ("wqkv", "wo"):
        layers[key] = quantize_dense_int4(layers[key])
    for key in ("shared_w1", "shared_w2"):
        if key in layers:
            layers[key] = quantize_weight(layers[key], input_axis=-2)
    layers["w1"], layers["w2"] = quantize_expert_int4(layers["w1"], layers["w2"])
    return {**lm_params, "layers": layers,
            "embed": quantize_weight(lm_params["embed"], input_axis=-2),
            "lm_head": quantize_weight(lm_params["lm_head"], input_axis=-2)}
