"""Fused MoE FFN over packed int4 experts with int8 activations (W4A8),
for at most 128 token rows (counterpart of the ``act_int8=True`` form of
``moe_decode_int4`` in aria_tpu/ops/moe_decode_kernel.py).

    out[t] = sum over slots s of wd[t, s] * (silu(x[t] . w1g[e]) * (x[t] . w1u[e])) . w2[e]

with x quantized to int8 per (token, D-group), int8 x int4 dots accumulated
exactly in int32, and h re-quantized to int8 per row over the whole
intermediate before the down projection (moe_decode_kernel.py:215-285 with
ft = I). The FFN runs once per UNIQUE active expert for all T rows; the
combine goes through a dense [E, T] weight table (``unique_meta``, the
counterpart of ``_unique_meta`` :44-78).

Kernel: ``csrc/moe_decode.cu`` (act_quant_int8, gate/up, h re-quantize,
down projection and combine). It replaces ``moe_decode_int4`` at
aria_tpu/ops/moe_decode_kernel.py:450 with ``_kernel_q4_a8`` :288 and
``_ffn_q4_a8`` :227. A decode step streams 3*I*D/2 bytes per active
expert (6.4 MB at I = 1664, D = 2560) against about 4 integer operations
per byte per row, so it is bound by the expert-weight read; each expert's
packed rows are read once for all T rows and unpacked in registers, with
``__dp4a`` on the masked raw bytes.
"""

from __future__ import annotations

import torch

from aria_tpu_torch.ops import backend
from aria_tpu_torch.ops._build import library
from aria_tpu_torch.ops.quant import int4_group_count, unpack_int4

DECODE_KERNEL_MAX_TOKENS = 128
_MAX_PACKED_D = 2048  # D/2 bytes a gate/up warp holds in registers


def unique_meta(indices: torch.Tensor, weights: torch.Tensor, E: int):
    """Unique active experts with a static count U = min(T*k, E), without a
    host sync.

    Returns (ids int32 [U], valid int32 [U], wd f32 [E, T]): with T == 1
    the ids are the token's slots in order (top-k slots are distinct);
    otherwise the present experts in ascending order, then absent ones
    flagged invalid. ``wd[e, t]`` is token t's combine weight for expert e.
    """
    T, k = indices.shape
    U = min(T * k, E)
    dev = indices.device
    flat = indices.reshape(-1).long()
    # a token takes an expert at most once, so each (e, t) cell gets one
    # write: a plain scatter, in the same order on every run
    wd = torch.zeros((E, T), dtype=torch.float32, device=dev)
    if T == 1:
        wd.scatter_(0, flat[:, None], weights.reshape(-1, 1).float())
        return flat.to(torch.int32), torch.ones(U, dtype=torch.int32, device=dev), wd
    tok = torch.arange(T, device=dev).repeat_interleave(k)
    wd.view(-1).scatter_(0, flat * T + tok, weights.reshape(-1).float())
    present = torch.zeros(E, dtype=torch.int8, device=dev).scatter_(0, flat, 1)
    order = torch.argsort(1 - present, stable=True)[:U]
    return order.to(torch.int32), present[order].to(torch.int32), wd


def act_quant_int8(x: torch.Tensor, ng: int):
    """Per-(token, D-group) symmetric int8 (moe_decode_kernel.py:215-224).
    Returns (xq int8 [T, D], sx f32 [T, 8] with columns 0..ng-1 used).

    The JAX source divides by 127.0; under jit XLA turns that division by
    a constant into a multiply by its reciprocal, so the port multiplies
    (here, for h below, in the kernel and in the KV-cache quantize)."""
    T, D = x.shape
    xg = x.float().reshape(T, ng, D // ng)
    sx = torch.clamp_min(xg.abs().amax(dim=-1) * (1.0 / 127.0), 1e-8)
    xq = torch.clamp(torch.round(xg / sx[..., None]), -127, 127).to(torch.int8)
    pad = torch.zeros((T, 8 - ng), dtype=torch.float32, device=x.device)
    return xq.reshape(T, D), torch.cat([sx, pad], dim=1)


def moe_decode_int4_plain(x, indices, weights, w1q4, w1sg, w2q4, w2s8, layer: int):
    """The same FFN in plain torch. Integer dots run in float64, where
    every product and sum of int8 x int4 values at these widths is exact,
    so they equal the kernel's int32 sums; the float steps follow
    _ffn_q4_a8's order."""
    T, D = x.shape
    E, I2 = w1q4.shape[1], w1q4.shape[2]
    I = I2 // 2
    ng = int4_group_count(D)
    gs = D // ng
    ids, valid, wd = unique_meta(indices, weights, E)
    xq, sx = act_quant_int8(x, ng)
    xg = xq.double().reshape(T, ng, gs)
    out = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for e, ok in zip(ids.tolist(), valid.tolist()):
        if not ok:
            continue
        w1 = unpack_int4(w1q4[layer, e], gs, torch.float64).reshape(I2, ng, gs)
        G = torch.einsum("tgc,rgc->tgr", xg, w1).float()  # exact int sums
        d = G * sx[:, :ng, None] * w1sg[layer, e, :ng].float()[None]
        acc = d[:, 0]
        for g in range(1, ng):
            acc = acc + d[:, g]
        gate, up = acc[:, :I], acc[:, I:]
        h = gate * torch.sigmoid(gate) * up
        sh = torch.clamp_min(h.abs().amax(dim=1, keepdim=True) * (1.0 / 127.0), 1e-8)
        hq = torch.clamp(torch.round(h / sh), -127, 127)
        w2 = unpack_int4(w2q4[layer, e], D, torch.float64)  # [I, D]
        partial = (hq.double() @ w2).float() * sh * w2s8[layer, e, 0].float()
        out = out + wd[e][:, None] * partial
    return out.to(x.dtype)


def moe_decode_int4(
    x: torch.Tensor,  # [T, D]
    indices: torch.Tensor,  # [T, k] int32 expert ids (shared experts included)
    weights: torch.Tensor,  # [T, k] combine weights
    w1q4: torch.Tensor,  # int8 [L, E, 2I, D/2], gate rows then up rows
    w1sg: torch.Tensor,  # bf16 [L, E, 8, 2I], rows 0..ng-1 = D-group scales
    w2q4: torch.Tensor,  # int8 [L, E, I, D/2], whole-row nibble pairs
    w2s8: torch.Tensor,  # bf16 [L, E, 8, D], column scale c/7
    layer: int,
) -> torch.Tensor:
    """Returns [T, D] in x's dtype."""
    tensors = (x, indices, weights, w1q4, w1sg, w2q4, w2s8)
    if not backend.on_cuda(*tensors):
        return moe_decode_int4_plain(*tensors, layer)
    T, D = x.shape
    L, E, I2, Dp = w1q4.shape
    I = I2 // 2
    ng = int4_group_count(D)
    gs = D // ng
    if T > DECODE_KERNEL_MAX_TOKENS:
        raise ValueError(f"moe_decode_int4: {T} rows, at most {DECODE_KERNEL_MAX_TOKENS}")
    if D != 2 * Dp or Dp % 128 or Dp > _MAX_PACKED_D or (gs // 2) % 16 or I % 16:
        raise ValueError(f"moe_decode_int4: unsupported D={D}, I={I}")
    if not 0 <= layer < L:
        raise IndexError(f"moe_decode_int4: layer {layer} of {L}")
    backend.require(x, "x", torch.bfloat16, (T, D))
    backend.require(w1q4, "w1q4", torch.int8)
    backend.require(w1sg, "w1sg", torch.bfloat16, (L, E, 8, I2))
    backend.require(w2q4, "w2q4", torch.int8, (L, E, I, Dp))
    backend.require(w2s8, "w2s8", torch.bfloat16, (L, E, 8, D))
    ids, valid, wd = unique_meta(indices, weights, E)
    U = ids.shape[0]
    dev = x.device
    xq = torch.empty((T, D), dtype=torch.int8, device=dev)
    sx = torch.empty((T, 8), dtype=torch.float32, device=dev)
    h = torch.empty((U, T, I), dtype=torch.float32, device=dev)
    hq = torch.empty((U, T, I), dtype=torch.int8, device=dev)
    sh = torch.empty((U, T), dtype=torch.float32, device=dev)
    hsum = torch.empty((U, T), dtype=torch.int32, device=dev)
    part = torch.empty((U, T, D), dtype=torch.float32, device=dev)
    out = torch.empty((T, D), dtype=torch.bfloat16, device=dev)
    lib, p, st = library(), backend.ptr, backend.stream()
    err = lib.aria_act_quant_int8(p(x), p(xq), p(sx), T, D, ng, st)
    backend.check(err, "act_quant_int8")
    err = lib.aria_moe_w4a8(
        p(xq), p(sx), p(ids), p(valid), p(wd), p(w1q4), p(w1sg), p(w2q4), p(w2s8),
        p(h), p(hq), p(sh), p(hsum), p(part), p(out), T, D, I, E, U, ng, layer, st)
    backend.check(err, "moe_decode_int4")
    moe_decode_int4.launches += 1
    return out


moe_decode_int4.launches = 0
