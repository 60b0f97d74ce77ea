"""The fused MoE FFN of a decode step, for at most 128 token rows, over the
unique active experts (counterpart of aria_tpu/ops/moe_decode_kernel.py),
in the serving forms:

- ``moe_decode_int4``: packed int4 experts, in the JAX function's two
  forms, chosen by its ``act_int8`` keyword (False by default, as at
  moe_decode_kernel.py:462; the model passes ``models/moe_lm.py``'s
  ``MOE_A8``, True unless switched, as the JAX package reads
  ``ARIA_TPU_A8``). Both compute

      out[t] = sum over slots s of wd[t, s] * (silu(x[t] . w1g[e]) * (x[t] . w1u[e])) . w2[e]

  with gate and up the sums over D-groups of each group's dot times its
  scale, and the down projection over w2 packed along the output axis,
  times its column scale, in one intermediate tile (ft = I). A decode
  step streams 3*I*D/2 bytes per active expert (6.4 MB at I = 1664, D =
  2560), so both are bound by the expert-weight read; each expert's packed
  rows are read once for all T rows and unpacked in registers.

  * W4A8 (``act_int8=True``; ``_kernel_q4_a8`` :288, ``_ffn_q4_a8`` :227):
    x quantized to int8 per (token, D-group), int8 x int4 dots accumulated
    exactly in int32, and h re-quantized to int8 per row over the whole
    intermediate before the down projection (:215-285). Kernel
    ``csrc/moe_decode.cu``: the routed (token, expert) pairs only, listed
    by expert as ``routed_rows`` lists them, the products on int8 tensor
    cores (mma.sync s8) with the nibbles unpacked in registers, in five
    launches (the lists with act_quant_int8, gate/up, h re-quantize, down
    projection, combine).
  * bf16 activations (``act_int8=False``, ``moe_decode_int4_bf16``;
    ``_kernel_q4`` :307, ``_ffn_q4`` :154): gate and up are f32 sums of
    bf16 x times the int4 values, h = silu(gate) * up in f32 is rounded
    to x's dtype, and the down product is over the int4 values of w2.
    Kernel ``csrc/moe_decode_bf16x.cu``: the routed pairs only, on the W4A8
    form's pair lists, with the nibbles unpacked into bf16 in registers
    (exact) and both products on ``mma.sync`` with f32 sums, in four
    launches (the lists and the bf16 rows by expert, gate/up, down,
    combine). Here the port departs from ``_ffn_q4``: that function
    evaluates xa.B + (xb/16 - xa).hi16 - 8 sum(xa) and rounds (xb/16 - xa)
    to bf16, which its docstring calls exact and which is not (ROADMAP
    queue 3, fault (d)); the port computes the exact products, as it does
    in ``moe_prefill_int4``.
- ``moe_decode`` (bf16 experts, :389) and ``moe_decode_quant`` (int8
  experts with f32 per-output-channel scales, :503), both ``_ffn`` :81:
  gate and up are f32 dots of x with the weights in x's dtype (an int8
  weight is exact in bf16; its scale comes after the dot), h = silu(gate)
  * up in f32 is rounded to x's dtype, and the down dot (times its scale)
  is added to the output with the token's combine weight, expert by
  expert in ascending order (the JAX grid's order with one intermediate
  tile). ``moe_decode``'s kernel is ``csrc/moe_decode_fp.cu``: tensor-core
  products that stream each active expert's 25.6 MB of weights (flagship
  width) once for all T rows, padded to 16-128. ``moe_decode_quant``'s is
  ``csrc/moe_decode_bf16x.cu``'s int8 form: the routed pairs only, 12.8 MB
  an expert, the int8 values converted to bf16 in registers (exact).

``moe_decode`` runs the FFN once per UNIQUE active expert for all T rows
and combines through a dense [E, T] weight table (``unique_meta``, the
counterpart of ``_unique_meta`` :44-78); the other forms run each expert
on the rows that picked it (``routed_rows``) and add each token's pairs in
``unique_meta``'s order. The added terms are the same but for the 0 *
partial of a row that did not pick an expert, so in plain torch the two
give the same bits (``*_routed_plain`` against ``*_plain``).
"""

from __future__ import annotations

import torch

from aria_tpu_torch.ops import backend
from aria_tpu_torch.ops._build import library
from aria_tpu_torch.ops.quant import int4_group_count, unpack_int4

DECODE_KERNEL_MAX_TOKENS = 128


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


def routed_rows(indices: torch.Tensor, E: int):
    """The (token, slot) pairs listed by expert, with static sizes and no
    host sync: what ``csrc/moe_decode.cu``'s first launch computes.

    Returns (order, pos, ids, valid, first, count), int64: ``order`` [T*k]
    the pairs p = t*k + s sorted by expert id, stable (ascending token
    within an expert), ``pos`` [T*k] each pair's place in that list;
    ``ids`` and ``valid`` [U] are ``unique_meta``'s, and unique expert u's
    pairs are ``order[first[u] : first[u] + count[u]]`` (count 0 where
    invalid). A shared expert, which every token takes, lists every token."""
    T, k = indices.shape
    U = min(T * k, E)
    flat = indices.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    pos = torch.empty_like(order).scatter_(0, order, torch.arange(T * k, device=flat.device))
    cnt = torch.bincount(flat, minlength=E)
    below = torch.cumsum(cnt, 0) - cnt
    if T == 1:
        ids = flat
        valid = torch.ones(U, dtype=torch.int64, device=flat.device)
    else:
        ids = torch.argsort((cnt == 0).long(), stable=True)[:U]
        valid = (cnt[ids] > 0).long()
    return order, pos, ids, valid, below[ids] * valid + T * k * (1 - valid), cnt[ids]


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


def _ffn_a8(xq, sx, w1q4, w1sg, w2q4, w2s8, layer: int, e: int) -> torch.Tensor:
    """``_ffn_q4_a8`` of expert e on the int8 rows xq [R, D] with their
    group scales sx [R, 8]: the partial [R, D] f32 before the combine
    weight. Integer dots run in float64, where every product and sum of
    int8 x int4 values at these widths is exact, so they equal the
    kernel's int32 sums; the float steps follow _ffn_q4_a8's order."""
    R, D = xq.shape
    I2 = w1q4.shape[2]
    I = I2 // 2
    ng = int4_group_count(D)
    gs = D // ng
    w1 = unpack_int4(w1q4[layer, e], gs, torch.float64).reshape(I2, ng, gs)
    G = torch.einsum("tgc,rgc->tgr", xq.double().reshape(R, ng, gs), w1).float()  # exact
    d = G * sx[:, :ng, None] * w1sg[layer, e, :ng].float()[None]
    acc = d[:, 0]
    for g in range(1, ng):
        acc = acc + d[:, g]
    gate, up = acc[:, :I], acc[:, I:]
    h = gate * torch.sigmoid(gate) * up
    sh = torch.clamp_min(h.abs().amax(dim=1, keepdim=True) * (1.0 / 127.0), 1e-8)
    hq = torch.clamp(torch.round(h / sh), -127, 127)
    w2 = unpack_int4(w2q4[layer, e], D, torch.float64)  # [I, D]
    return (hq.double() @ w2).float() * sh * w2s8[layer, e, 0].float()


def moe_decode_int4_plain(x, indices, weights, w1q4, w1sg, w2q4, w2s8, layer: int):
    """The same FFN in plain torch, as the TPU kernel runs it: every token
    row through every unique active expert, added with its combine weight
    (zero for a row that did not pick the expert) in ``unique_meta``'s
    order."""
    T, D = x.shape
    ids, valid, wd = unique_meta(indices, weights, w1q4.shape[1])
    xq, sx = act_quant_int8(x, int4_group_count(D))
    out = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for e, ok in zip(ids.tolist(), valid.tolist()):
        if ok:
            out = out + wd[e][:, None] * _ffn_a8(xq, sx, w1q4, w1sg, w2q4, w2s8, layer, e)
    return out.to(x.dtype)


def _routed(x, indices, weights, E: int, partial) -> torch.Tensor:
    """The routed pairs' FFN and combine, as the routed kernels compute
    them: ``partial(e, tokens)`` gives expert e's partial rows of those
    tokens [n, D] f32, before the combine weight; each pair's row times its
    combine weight is listed by expert as ``routed_rows`` lists the pairs,
    and each token's pairs are added from 0 in ``unique_meta``'s order."""
    T, D = x.shape
    k = indices.shape[1]
    order, pos, ids, valid, first, count = routed_rows(indices, E)
    w = weights.reshape(-1).float()
    part = torch.empty((T * k, D), dtype=torch.float32, device=x.device)
    for e, ok, a, n in zip(*(v.tolist() for v in (ids, valid, first, count))):
        if ok:
            pairs = order[a:a + n]
            part[a:a + n] = w[pairs, None] * partial(e, pairs // k)
    rank = torch.argsort(indices.long(), dim=1) if T > 1 else torch.arange(k)[None].expand(T, k)
    out = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for j in range(k):
        out = out + part[pos.reshape(T, k).gather(1, rank[:, j:j + 1].to(x.device))[:, 0]]
    return out.to(x.dtype)


def moe_decode_int4_routed_plain(x, indices, weights, w1q4, w1sg, w2q4, w2s8,
                                 layer: int) -> torch.Tensor:
    """The W4A8 FFN over the routed pairs only, in plain torch, as
    ``csrc/moe_decode.cu`` computes it: each expert on the rows of the
    tokens that picked it. The bits equal ``moe_decode_int4_plain``'s: the
    integer dots are exact, and the terms it adds beyond these are 0 * a
    finite partial."""
    xq, sx = act_quant_int8(x, int4_group_count(x.shape[1]))
    return _routed(x, indices, weights, w1q4.shape[1],
                   lambda e, tok: _ffn_a8(xq[tok], sx[tok], w1q4, w1sg, w2q4, w2s8, layer, e))


def _check_int4(name, x, w1q4, w1sg, w2q4, w2s8, layer: int, bad) -> tuple:
    """Check what an int4 decode kernel takes; ``bad(D, I, gs)`` names the
    widths it refuses. Returns (T, D, I, E, ng)."""
    T, D = x.shape
    L, E, I2, Dp = w1q4.shape
    I = I2 // 2
    ng = int4_group_count(D)
    if T > DECODE_KERNEL_MAX_TOKENS:
        raise ValueError(f"{name}: {T} rows, at most {DECODE_KERNEL_MAX_TOKENS}")
    if D != 2 * Dp or bad(D, I, D // ng):
        raise ValueError(f"{name}: unsupported D={D}, I={I}")
    if not 0 <= layer < L:
        raise IndexError(f"{name}: layer {layer} of {L}")
    backend.require(x, "x", torch.bfloat16, (T, D))
    backend.require(w1q4, "w1q4", torch.int8)
    backend.require(w1sg, "w1sg", torch.bfloat16, (L, E, 8, I2))
    backend.require(w2q4, "w2q4", torch.int8, (L, E, I, Dp))
    backend.require(w2s8, "w2s8", torch.bfloat16, (L, E, 8, D))
    return T, D, I, E, ng


def _pair_args(indices, weights, T: int, k: int):
    """The routing as the pair-list kernels take it: int32 indices, bf16 or
    f32 weights (converted only where the caller's are neither)."""
    if indices.dtype != torch.int32:
        indices = indices.to(torch.int32)
    if weights.dtype not in (torch.bfloat16, torch.float32):
        weights = weights.float()
    backend.require(indices, "indices", torch.int32, (T, k))
    backend.require(weights, "weights", weights.dtype, (T, k))
    return indices, weights


def moe_decode_int4(
    x: torch.Tensor,  # [T, D]
    indices: torch.Tensor,  # [T, k] int32 expert ids (shared experts included)
    weights: torch.Tensor,  # [T, k] combine weights
    w1q4: torch.Tensor,  # int8 [L, E, 2I, D/2], gate rows then up rows
    w1sg: torch.Tensor,  # bf16 [L, E, 8, 2I], rows 0..ng-1 = D-group scales
    w2q4: torch.Tensor,  # int8 [L, E, I, D/2], whole-row nibble pairs
    w2s8: torch.Tensor,  # bf16 [L, E, 8, D], column scale c/7
    layer: int,
    *,
    act_int8: bool = False,
) -> torch.Tensor:
    """Returns [T, D] in x's dtype: the W4A8 form with ``act_int8``, else
    the bf16-activation form (``moe_decode_int4_bf16``)."""
    tensors = (x, indices, weights, w1q4, w1sg, w2q4, w2s8)
    if not act_int8:
        return moe_decode_int4_bf16(*tensors, layer)
    if not backend.on_cuda(*tensors):
        return moe_decode_int4_plain(*tensors, layer)
    return _w4a8(x, indices, weights, w1q4, w1sg, w2q4, w2s8, layer)["out"]


def _w4a8(x, indices, weights, w1q4, w1sg, w2q4, w2s8, layer: int) -> dict:
    """Launch ``csrc/moe_decode.cu`` on CUDA tensors; returns its output
    and scratch by name ("out"; the pair lists "pos" and "meta" [ids,
    valid, first, count] that ``routed_rows`` specifies; ...)."""
    T, D, I, E, ng = _check_int4(
        "moe_decode_int4", x, w1q4, w1sg, w2q4, w2s8, layer,
        lambda D, I, gs: (D // 2) % 128 or (gs // 2) % 16 or I % 16)
    L, k = w1q4.shape[0], indices.shape[1]
    indices, weights = _pair_args(indices, weights, T, k)
    n, U, dev = T * k, min(T * k, E), x.device
    buf = {"xs": torch.empty((n, D), dtype=torch.int8, device=dev),
           "sxs": torch.empty((n, 8), dtype=torch.float32, device=dev),
           "wsort": torch.empty(n, dtype=torch.float32, device=dev),
           "pos": torch.empty(n, dtype=torch.int32, device=dev),
           "meta": torch.empty((4, U), dtype=torch.int32, device=dev),
           "h": torch.empty((n, I), dtype=torch.float32, device=dev),
           "hq": torch.empty((n, I), dtype=torch.int8, device=dev),
           "sh": torch.empty(n, dtype=torch.float32, device=dev),
           "part": torch.empty((n, D), dtype=torch.float32, device=dev),
           "out": torch.empty((T, D), dtype=torch.bfloat16, device=dev)}
    p = backend.ptr
    err = library().aria_moe_w4a8(
        p(x), p(indices), p(weights), int(weights.dtype == torch.bfloat16), p(w1q4), p(w1sg),
        p(w2q4), p(w2s8), *(p(buf[name]) for name in (
            "xs", "sxs", "wsort", "pos", "meta", "h", "hq", "sh", "part", "out")),
        T, k, D, I, L, E, U, ng, layer, backend.stream())
    backend.check(err, "moe_decode_int4")
    moe_decode_int4.launches += 1
    return buf


moe_decode_int4.launches = 0

PAIR_CHUNK = 16  # the rows of a work-list entry of the bf16-activation kernels


def _bf16x(name, x, indices, weights, w1, s1, w2, s2, layer: int, int4: bool) -> dict:
    """Launch ``csrc/moe_decode_bf16x.cu`` on CUDA tensors, the int4 form
    (w1q4, w1sg, w2q4, w2s8) or the int8 one (w1q, its s8, w2q, its s8);
    returns its output and scratch by name ("out"; the pair lists "pos"
    and "meta" as in ``_w4a8``; "work", an entry u | chunk << 16 for each
    PAIR_CHUNK rows of unique expert u, then -1; ...)."""
    T, D = x.shape
    if int4:
        T, D, I, E, _ = _check_int4(name, x, w1, s1, w2, s2, layer,
                                    lambda D, I, gs: (gs // 2) % 128 or (D // 2) % 128 or I % 8)
    else:
        L, E, I2, _ = w1.shape
        I = I2 // 2
        if T > DECODE_KERNEL_MAX_TOKENS:
            raise ValueError(f"{name}: {T} rows, at most {DECODE_KERNEL_MAX_TOKENS}")
        if D % 128 or I % 8:
            raise ValueError(f"{name}: unsupported D={D}, I={I}")
        if not 0 <= layer < L:
            raise IndexError(f"{name}: layer {layer} of {L}")
        backend.require(x, "x", torch.bfloat16, (T, D))
        backend.require(w1, "w1q", torch.int8, (L, E, I2, D))
        backend.require(s1, "w1 s8", torch.float32, (L, E, 8, I2))
        backend.require(w2, "w2q", torch.int8, (L, E, I, D))
        backend.require(s2, "w2 s8", torch.float32, (L, E, 8, D))
    L, k = w1.shape[0], indices.shape[1]
    indices, weights = _pair_args(indices, weights, T, k)
    n, U, dev = T * k, min(T * k, E), x.device
    buf = {"xs": torch.empty((n, D), dtype=torch.bfloat16, device=dev),
           "wsort": torch.empty(n, dtype=torch.float32, device=dev),
           "pos": torch.empty(n, dtype=torch.int32, device=dev),
           "meta": torch.empty((4, U), dtype=torch.int32, device=dev),
           "work": torch.empty(U + -(-n // PAIR_CHUNK), dtype=torch.int32, device=dev),
           "h": torch.empty((n, I), dtype=torch.bfloat16, device=dev),
           "part": torch.empty((n, D), dtype=torch.float32, device=dev),
           "out": torch.empty((T, D), dtype=torch.bfloat16, device=dev)}
    lib, p = library(), backend.ptr
    launch = lib.aria_moe_bf16x_int4 if int4 else lib.aria_moe_bf16x_int8
    err = launch(
        p(x), p(indices), p(weights), int(weights.dtype == torch.bfloat16), p(w1), p(s1), p(w2),
        p(s2), *(p(buf[name]) for name in ("xs", "wsort", "pos", "meta", "work", "h", "part",
                                           "out")),
        T, k, D, I, L, E, U, layer, backend.stream())
    backend.check(err, name)
    return buf


def _ffn_q4_bf16(x, w1q4, w1sg, w2q4, w2s8, layer: int, e: int) -> torch.Tensor:
    """Expert e's bf16-activation int4 FFN of the rows x [T, D], with exact
    products: per D-group the f32 dot of x with the int4 values times the
    group's scale, summed over the groups in ascending order; h rounded to
    x's dtype; the down dot with the int4 values times the column scale.
    The partial [T, D] f32, before the combine weight."""
    T, D = x.shape
    I2 = w1q4.shape[2]
    I = I2 // 2
    ng = int4_group_count(D)
    gs = D // ng
    w1 = unpack_int4(w1q4[layer, e], gs, torch.float32).reshape(I2, ng, gs)
    xg = x.float().reshape(T, ng, gs)
    d = torch.einsum("tgc,rgc->tgr", xg, w1) * w1sg[layer, e, :ng].float()[None]
    acc = d[:, 0]
    for g in range(1, ng):
        acc = acc + d[:, g]
    gate, up = acc[:, :I], acc[:, I:]
    h = (gate * torch.sigmoid(gate) * up).to(x.dtype).float()
    w2 = unpack_int4(w2q4[layer, e], D, torch.float32)  # [I, D]
    return (h @ w2) * w2s8[layer, e, 0].float()


def moe_decode_int4_bf16_plain(x, indices, weights, w1q4, w1sg, w2q4, w2s8,
                               layer: int) -> torch.Tensor:
    """The bf16-activation int4 FFN in plain torch (``moe_decode_int4``
    with act_int8=False): every token row through every unique active
    expert (``_ffn_q4_bf16``), added with its combine weight (zero for a
    row that did not pick the expert) in ``unique_meta``'s order."""
    T, D = x.shape
    ids, valid, wd = unique_meta(indices, weights, w1q4.shape[1])
    out = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for e, ok in zip(ids.tolist(), valid.tolist()):
        if ok:
            out = out + wd[e][:, None] * _ffn_q4_bf16(x, w1q4, w1sg, w2q4, w2s8, layer, e)
    return out.to(x.dtype)


def moe_decode_int4_bf16_routed_plain(x, indices, weights, w1q4, w1sg, w2q4, w2s8,
                                      layer: int) -> torch.Tensor:
    """The bf16-activation int4 FFN over the routed pairs only, in plain
    torch, as ``csrc/moe_decode_bf16x.cu`` computes it: each pair's partial
    row of its expert times its combine weight, each token's pairs added
    from 0 in ``unique_meta``'s order. An expert's products run over all T
    rows and the routed ones are kept: a CPU matmul's bits depend on its
    row count, and these are ``moe_decode_int4_bf16_plain``'s, so the two
    are bit-equal (the terms it adds beyond these are 0 * a finite
    partial)."""
    return _routed(x, indices, weights, w1q4.shape[1],
                   lambda e, tok: _ffn_q4_bf16(x, w1q4, w1sg, w2q4, w2s8, layer, e)[tok])


def moe_decode_int4_bf16(
    x: torch.Tensor,  # [T, D]
    indices: torch.Tensor,  # [T, k] int32
    weights: torch.Tensor,  # [T, k]
    w1q4: torch.Tensor,  # int8 [L, E, 2I, D/2]
    w1sg: torch.Tensor,  # bf16 [L, E, 8, 2I]
    w2q4: torch.Tensor,  # int8 [L, E, I, D/2]
    w2s8: torch.Tensor,  # bf16 [L, E, 8, D]
    layer: int,
) -> torch.Tensor:
    """The bf16-activation form of ``moe_decode_int4``; returns [T, D] in
    x's dtype."""
    tensors = (x, indices, weights, w1q4, w1sg, w2q4, w2s8)
    if not backend.on_cuda(*tensors):
        return moe_decode_int4_bf16_plain(*tensors, layer)
    out = _bf16x("moe_decode_int4_bf16", *tensors, layer, int4=True)["out"]
    moe_decode_int4_bf16.launches += 1
    return out


moe_decode_int4_bf16.launches = 0


def decode_rows(T: int) -> int:
    """The token rows ``moe_decode``'s kernel computes: T rounded up to 16,
    32, 64 or 128 (the rows past T are zeros)."""
    return next(r for r in (16, 32, 64, 128) if T <= r)


def _ffn_fp(xf, w1, w2, layer: int, e: int, dtype, s1=None, s2=None) -> torch.Tensor:
    """``_ffn`` (moe_decode_kernel.py:81-99) of expert e on the f32 rows xf
    [T, D]: f32 dots with the weights cast to ``dtype`` (x's); for int8
    weights the scales ``s1`` (w1's s8) and ``s2`` (w2's s8) after each
    dot; h rounded to ``dtype`` before the down dot. The partial [T, D]
    f32, before the combine weight."""
    I = w1.shape[2] // 2
    w = w1[layer, e].to(dtype).float()
    gate, up = xf @ w[:I].T, xf @ w[I:].T
    if s1 is not None:
        gate = gate * s1[layer, e, 0, :I]
        up = up * s1[layer, e, 0, I:]
    h = (gate * torch.sigmoid(gate)) * up
    partial = h.to(dtype).float() @ w2[layer, e].to(dtype).float()
    if s2 is not None:
        partial = partial * s2[layer, e, 0]
    return partial


def moe_decode_plain(x, indices, weights, w1, w2, layer: int, s1=None, s2=None):
    """``_ffn`` over the unique experts in ascending order, in plain torch
    (``_ffn_fp``), each added with its combine weight (zero for a row that
    did not pick the expert); the result cast to x's dtype."""
    T, D = x.shape
    ids, valid, wd = unique_meta(indices, weights, w1.shape[1])
    xf = x.float()
    out = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for e, ok in zip(ids.tolist(), valid.tolist()):
        if ok:
            out = out + wd[e][:, None] * _ffn_fp(xf, w1, w2, layer, e, x.dtype, s1, s2)
    return out.to(x.dtype)


def moe_decode_quant_routed_plain(x, indices, weights, w1q, w1s8, w2q, w2s8,
                                  layer: int) -> torch.Tensor:
    """``moe_decode_quant`` over the routed pairs only, in plain torch, as
    ``csrc/moe_decode_bf16x.cu`` computes it (see
    ``moe_decode_int4_bf16_routed_plain``): bit-equal to
    ``moe_decode_plain`` with the int8 stacks."""
    xf = x.float()
    return _routed(x, indices, weights, w1q.shape[1],
                   lambda e, tok: _ffn_fp(xf, w1q, w2q, layer, e, x.dtype, w1s8, w2s8)[tok])


def moe_decode(
    x: torch.Tensor,  # [T, D]
    indices: torch.Tensor,  # [T, k] int32 expert ids (shared experts included)
    weights: torch.Tensor,  # [T, k] combine weights
    w1: torch.Tensor,  # bf16 [L, E, 2I, D] out-major, gate rows then up rows
    w2: torch.Tensor,  # bf16 [L, E, I, D]
    layer: int,
) -> torch.Tensor:
    """bf16 experts; returns [T, D] in x's dtype. On CUDA tensors, launches
    ``csrc/moe_decode_fp.cu``."""
    if not backend.on_cuda(x, indices, weights, w1, w2):
        return moe_decode_plain(x, indices, weights, w1, w2, layer)
    T, D = x.shape
    L, E, I2, _ = w1.shape
    I = I2 // 2
    if T > DECODE_KERNEL_MAX_TOKENS:
        raise ValueError(f"moe_decode: {T} rows, at most {DECODE_KERNEL_MAX_TOKENS}")
    if D % 64 or I % 64:
        raise ValueError(f"moe_decode: unsupported D={D}, I={I}")
    if not 0 <= layer < L:
        raise IndexError(f"moe_decode: layer {layer} of {L}")
    backend.require(x, "x", torch.bfloat16, (T, D))
    backend.require(w1, "w1", torch.bfloat16, (L, E, I2, D))
    backend.require(w2, "w2", torch.bfloat16, (L, E, I, D))
    ids, valid, wd = unique_meta(indices, weights, E)
    U = ids.shape[0]
    dev = x.device
    h = torch.empty((U, decode_rows(T), I), dtype=torch.bfloat16, device=dev)
    part = torch.empty((U, T, D), dtype=torch.float32, device=dev)
    out = torch.empty((T, D), dtype=torch.bfloat16, device=dev)
    p = backend.ptr
    err = library().aria_moe_decode_bf16(p(x), p(ids), p(valid), p(wd), p(w1), p(w2), p(h),
                                         p(part), p(out), T, D, I, E, U, layer, backend.stream())
    backend.check(err, "moe_decode")
    moe_decode.launches += 1
    return out


def moe_decode_quant(
    x: torch.Tensor,  # [T, D]
    indices: torch.Tensor,  # [T, k] int32
    weights: torch.Tensor,  # [T, k]
    w1q: torch.Tensor,  # int8 [L, E, 2I, D], a scale per row of 2I
    w1s8: torch.Tensor,  # f32 [L, E, 8, 2I], every row the scale
    w2q: torch.Tensor,  # int8 [L, E, I, D], a scale per column of D
    w2s8: torch.Tensor,  # f32 [L, E, 8, D]
    layer: int,
) -> torch.Tensor:
    """int8 experts; returns [T, D] in x's dtype."""
    tensors = (x, indices, weights, w1q, w1s8, w2q, w2s8)
    if not backend.on_cuda(*tensors):
        return moe_decode_plain(x, indices, weights, w1q, w2q, layer, w1s8, w2s8)
    out = _bf16x("moe_decode_quant", *tensors, layer, int4=False)["out"]
    moe_decode_quant.launches += 1
    return out


moe_decode.launches = 0
moe_decode_quant.launches = 0
