"""Top-k routing with the MoE losses, the GLU, and the three expert paths:
per-token gather, capacity dispatch and the dropless ragged path
(counterpart of aria_tpu/ops/moe.py).

Softmax is taken over the top-k logits only, in f32, and cast back to the
activation dtype. In training the router also gives the z loss (over the
log-sum-exp of all the logits) and the switch load-balancing loss (over the
full softmax), moe.py:44-79.

``experts_gather`` (at most 32 tokens) and ``experts_grouped`` (the
capacity path, with single-adapter expert LoRA inside the GLU) are torch
products with f32 outputs, as the JAX package leaves them to XLA.
``experts_ragged`` sorts the routing slots by expert and runs both expert
products as ragged grouped matmuls with the group sizes on the device, and
differentiates them as megablox's custom VJP does (megablox/ops.py:63-106):
the lhs gradient is ``gmm`` of the cotangent with the rhs, transpose_rhs
flipped, in the lhs dtype (``gmm_dlhs``), and the rhs gradient is ``tgmm``
of the lhs and the cotangent, in the rhs dtype (transposed back for w1).
On the card the f32 cotangent is split once a backward into bf16 hi and lo
planes with a flag per 128-row tile where lo is not zero (``split_hi_lo``),
and both gradients take the split. Kernels: ``csrc/gmm.cu`` (``aria_gmm``
forward, ``aria_split_hi_lo``, ``aria_gmm_dlhs``, ``aria_tgmm``); its notes
give the tiling and the split.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from aria_tpu_torch.ops import backend
from aria_tpu_torch.ops._build import library
from aria_tpu_torch.ops.quant import matmul_f32

GMM_ROWS = 128  # gmm's row tile: the ragged path pads the sorted rows to it


class RouterOutput(NamedTuple):
    weights: torch.Tensor  # [T, k] combine weights
    indices: torch.Tensor  # [T, k] int32 expert ids
    z_loss: torch.Tensor  # f32 scalar (0 unless training)
    aux_loss: torch.Tensor  # f32 scalar (0 unless training)


def router_logits(x: torch.Tensor, gate_weight: torch.Tensor, training: bool) -> torch.Tensor:
    """x [T, D] . gate_weight [E, D]^T as f32 [T, E]: in f64 when serving
    on the card (see ``route_topk``), else in f32."""
    if x.is_cuda and not training:
        return (x.double() @ gate_weight.double().T).float()
    return x.float() @ gate_weight.float().T


def route_topk(x: torch.Tensor, gate_weight: torch.Tensor, topk: int, *,
               z_loss_coeff: float = 0.0, aux_loss_coeff: float = 0.0,
               training: bool = False) -> RouterOutput:
    """x [T, D], gate_weight [E, D] (f32); logits in f32. On the card the
    f32 product picks its algorithm by the row count, so a row would get
    other bits beside other rows (a cached prefix page would differ from a
    recomputed one): serving takes the product in f64, rounded once to
    f32, which leaves each row's logits as they are at any row count."""
    logits = router_logits(x, gate_weight, training)
    top_logits, top_indices = torch.topk(logits, topk, dim=-1)
    scores = torch.softmax(top_logits, dim=-1)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    z_loss = aux_loss = zero
    if training:
        E = gate_weight.shape[0]
        z = torch.logsumexp(logits, dim=-1)
        z_loss = torch.mean(torch.square(z)) * z_loss_coeff
        tokens_per_expert = torch.zeros(E, dtype=torch.int32, device=x.device).scatter_add_(
            0, top_indices.reshape(-1), torch.ones(top_indices.numel(), dtype=torch.int32,
                                                   device=x.device))
        probs = torch.softmax(logits, dim=-1)
        aux_loss = torch.sum(torch.mean(probs, dim=0) * tokens_per_expert) * (
            E / (logits.shape[0] * topk) * aux_loss_coeff)
    return RouterOutput(scores.to(x.dtype), top_indices.to(torch.int32), z_loss, aux_loss)


def glu(x: torch.Tensor) -> torch.Tensor:
    gate, up = x.chunk(2, dim=-1)
    return F.silu(gate) * up


def experts_gather(x, indices, weights, w1, w2) -> torch.Tensor:
    """The few-token path (moe.py:86-101): each token's experts' weights
    gathered, products in f32 from the upcast operands."""
    w1_g = w1[indices.long()].float()  # [T, k, 2I, D]
    w2_g = w2[indices.long()].float()  # [T, k, I, D]
    h = glu(torch.einsum("td,tkfd->tkf", x.float(), w1_g).to(x.dtype))
    out = torch.einsum("tkf,tkfd->tkd", h.float(), w2_g)
    return torch.einsum("tkd,tk->td", out, weights.float()).to(x.dtype)


def _dispatch_indices(indices: torch.Tensor, num_experts: int, capacity: int):
    """Per routing slot, its row in the [E*C] buffer (moe.py:104-124):
    returns (slot_dest [T*k], token_ids [T*k]), slots past an expert's
    capacity sent to the trash row E*C. So is a slot whose id is E, the
    blocked expert-LoRA path's mark of an expert outside the block: the JAX
    function drops it by its out-of-range scatter, here it is counted in a
    bin of its own and sent to the trash row explicitly."""
    T, k = indices.shape
    flat_e = indices.reshape(-1).long()
    order = torch.argsort(flat_e, stable=True)
    counts = torch.zeros(num_experts + 1, dtype=torch.long, device=indices.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    ranks = torch.arange(T * k, device=indices.device) - starts[flat_e[order]]
    pos_in_expert = torch.empty_like(ranks).index_copy_(0, order, ranks)
    keep = (pos_in_expert < capacity) & (flat_e < num_experts)
    slot_dest = torch.where(keep, flat_e * capacity + pos_in_expert, num_experts * capacity)
    token_ids = torch.arange(T, device=indices.device).repeat_interleave(k)
    return slot_dest, token_ids


def experts_grouped(
    x: torch.Tensor,  # [T, D]
    indices: torch.Tensor,  # [T, k]
    weights: torch.Tensor,  # [T, k]
    w1: torch.Tensor,  # [E, 2I, D]
    w2: torch.Tensor,  # [E, I, D]
    capacity: Optional[int] = None,
    lora_w1: Optional[dict] = None,  # {"a": [E, D, r], "b": [E, r, 2I]}; multi: [A, E, ...]
    lora_w2: Optional[dict] = None,  # {"a": [E, I, r], "b": [E, r, D]}; multi: [A, E, ...]
    lora_scale: float = 0.0,
    lora_onehot: Optional[torch.Tensor] = None,  # [A, T] per-token adapter selector
) -> torch.Tensor:
    """The capacity path (moe.py:127-201): tokens scattered into an [E, C,
    D] buffer (C = T by default: dropless), batched products in f32 with
    the per-expert LoRA deltas inside the GLU (fc1 before it, fc2 after
    it), the gather back and the combine over k in f32. Returns [T, D] in
    x's dtype. With stacked factors ([A, E, ...]) and ``lora_onehot``,
    every adapter's delta is computed over all buffers and each buffer row
    takes its token's adapter: the selector is scattered into the buffers
    with the tokens (moe.py:161-190). The LoRA products are f32."""
    T, D = x.shape
    E, k = w1.shape[0], indices.shape[1]
    C = T if capacity is None else capacity
    slot_dest, token_ids = _dispatch_indices(indices, E, C)
    buf = x.new_zeros((E * C + 1, D)).index_put((slot_dest,), x[token_ids])
    buf = buf[:E * C].reshape(E, C, D)
    factors = lora_w1 or lora_w2
    multi = lora_onehot is not None and factors is not None and factors["a"].dim() == 4
    if multi:  # [E, C, A]: rows from different requests share an expert's buffer
        A = lora_onehot.shape[0]
        mhot = lora_onehot.new_zeros((E * C + 1, A)).float().index_put(
            (slot_dest,), lora_onehot.T.float()[token_ids])
        mhot = mhot[:E * C].reshape(E, C, A)
    h = matmul_f32(buf, w1.transpose(1, 2))
    if lora_w1 is not None:
        if multi:
            hr = torch.einsum("ecd,aedr->aecr", buf.float(), lora_w1["a"].float())
            hd = torch.einsum("aecr,aerf->aecf", hr, lora_w1["b"].float())
            h = h + lora_scale * torch.einsum("aecf,eca->ecf", hd, mhot)
        else:
            hr = torch.einsum("ecd,edr->ecr", buf.float(), lora_w1["a"].float())
            h = h + lora_scale * torch.einsum("ecr,erf->ecf", hr, lora_w1["b"].float())
    h = glu(h.to(x.dtype))
    out = matmul_f32(h, w2)
    if lora_w2 is not None:
        if multi:
            outr = torch.einsum("ecf,aefr->aecr", h.float(), lora_w2["a"].float())
            outd = torch.einsum("aecr,aerd->aecd", outr, lora_w2["b"].float())
            out = out + lora_scale * torch.einsum("aecd,eca->ecd", outd, mhot)
        else:
            outr = torch.einsum("ecf,efr->ecr", h.float(), lora_w2["a"].float())
            out = out + lora_scale * torch.einsum("ecr,erd->ecd", outr, lora_w2["b"].float())
    out = torch.cat([out.to(x.dtype).reshape(E * C, D), x.new_zeros((1, D))])
    per_slot = out[slot_dest].reshape(T, k, D)
    combined = torch.einsum("tkd,tk->td", per_slot.float(), weights.float())
    return combined.to(x.dtype)


def gmm_plain(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
              transpose_rhs: bool = False) -> torch.Tensor:
    """The grouped matmul in plain torch, group by group in f32 (reads the
    group sizes on the host). Rows past the groups stay zero."""
    M = lhs.shape[0]
    N = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    out = torch.zeros((M, N), dtype=torch.float32, device=lhs.device)
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        if n:
            w = rhs[e].float()
            out[start:start + n] = lhs[start:start + n].float() @ (w.T if transpose_rhs else w)
        start += n
    return out


def tgmm_plain(lhs: torch.Tensor, grad: torch.Tensor, group_sizes: torch.Tensor,
               out_dtype=torch.float32) -> torch.Tensor:
    """out[g] = lhs[rows of g]^T . grad[rows of g] in f32, [E, K, N] in
    ``out_dtype``; an empty group's slice is zero."""
    E, K, N = group_sizes.shape[0], lhs.shape[1], grad.shape[1]
    out = torch.zeros((E, K, N), dtype=torch.float32, device=lhs.device)
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        if n:
            out[e] = lhs[start:start + n].float().T @ grad[start:start + n].float()
        start += n
    return out.to(out_dtype)


SPLIT_ROWS = 128  # rows per flag of split_hi_lo: gmm_dlhs's row tile, two tgmm chunks


def split_hi_lo_plain(x: torch.Tensor):
    """f32 x [M, N] as bf16 hi = bf16(x) and lo = bf16(x - hi), and int32
    flags [ceil(M / 128)], 1 where a 128-row tile has a non-zero lo.
    hi + lo is x exactly for values of at most 16 significant bits."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    M = x.shape[0]
    nz = (lo != 0).any(dim=1)
    nz = F.pad(nz, (0, -M % SPLIT_ROWS)).reshape(-1, SPLIT_ROWS)
    return hi, lo, nz.any(dim=1).to(torch.int32)


def split_hi_lo(x: torch.Tensor):
    """The cotangent split that gmm_dlhs and tgmm take on the card (one
    launch): (hi, lo, flags), as ``split_hi_lo_plain``."""
    if not backend.on_cuda(x):
        return split_hi_lo_plain(x)
    M, N = x.shape
    backend.require(x, "x", torch.float32, (M, N))
    if N % 4:
        raise ValueError(f"split_hi_lo: unsupported N={N}")
    hi = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    lo = torch.empty_like(hi)
    flags = torch.empty((-(-M // SPLIT_ROWS),), dtype=torch.int32, device=x.device)
    p = backend.ptr
    err = library().aria_split_hi_lo(p(x), p(hi), p(lo), p(flags), M, N, backend.stream())
    backend.check(err, "split_hi_lo")
    split_hi_lo.launches += 1
    return hi, lo, flags


def _require_split(split, M: int, N: int) -> None:
    hi, lo, flags = split
    backend.require(hi, "hi", torch.bfloat16, (M, N))
    backend.require(lo, "lo", torch.bfloat16, (M, N))
    backend.require(flags, "flags", torch.int32, (-(-M // SPLIT_ROWS),))


def gmm(
    lhs: torch.Tensor,  # [M, K] bf16, rows sorted by group
    rhs: torch.Tensor,  # [E, N, K] with transpose_rhs, else [E, K, N]
    group_sizes: torch.Tensor,  # int32 [E], summing to M
    transpose_rhs: bool = False,
) -> torch.Tensor:
    """out[r] = lhs[r] . rhs[group of r] (transposed with ``transpose_rhs``),
    [M, N] f32, as megablox's ``gmm`` with ``preferred_element_type=f32``."""
    if not backend.on_cuda(lhs, rhs, group_sizes):
        return gmm_plain(lhs, rhs, group_sizes, transpose_rhs)
    M, K = lhs.shape
    E = rhs.shape[0]
    N = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    if M % GMM_ROWS or K % 32 or N % 128:
        raise ValueError(f"gmm: unsupported M={M}, K={K}, N={N}")
    backend.require(lhs, "lhs", torch.bfloat16, (M, K))
    backend.require(rhs, "rhs", torch.bfloat16, (E, N, K) if transpose_rhs else (E, K, N))
    backend.require(group_sizes, "group_sizes", torch.int32, (E,))
    out = torch.empty((M, N), dtype=torch.float32, device=lhs.device)
    p = backend.ptr
    err = library().aria_gmm(p(lhs), p(rhs), p(group_sizes), p(out), M, K, N, E,
                             int(transpose_rhs), backend.stream())
    backend.check(err, "gmm")
    gmm.launches += 1
    return out


def gmm_dlhs(grad: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
             transpose_rhs: bool, out_dtype=torch.bfloat16, split=None) -> torch.Tensor:
    """The lhs gradient of ``gmm``: grad [M, K] f32 . rhs (``transpose_rhs``
    as the forward's flipped), [M, N] in ``out_dtype``, summed in f32
    (megablox ops.py:80-88). On the card: grad f32, out bf16, through
    ``split_hi_lo(grad)``, or the ``split`` given (hi, lo, flags)."""
    if not backend.on_cuda(grad, rhs, group_sizes):
        return gmm_plain(grad, rhs, group_sizes, transpose_rhs).to(out_dtype)
    if out_dtype != torch.bfloat16:
        raise TypeError(f"gmm_dlhs: the kernel gives bf16, not {out_dtype}")
    M, K = grad.shape
    E = rhs.shape[0]
    N = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    if M % GMM_ROWS or K % 32 or N % 128:
        raise ValueError(f"gmm_dlhs: unsupported M={M}, K={K}, N={N}")
    backend.require(grad, "grad", torch.float32, (M, K))
    backend.require(rhs, "rhs", torch.bfloat16, (E, N, K) if transpose_rhs else (E, K, N))
    backend.require(group_sizes, "group_sizes", torch.int32, (E,))
    split = split_hi_lo(grad) if split is None else split
    _require_split(split, M, K)
    hi, lo, flags = split
    out = torch.empty((M, N), dtype=torch.bfloat16, device=grad.device)
    p = backend.ptr
    err = library().aria_gmm_dlhs(p(hi), p(lo), p(flags), p(rhs), p(group_sizes), p(out), M, K,
                                  N, E, int(transpose_rhs), backend.stream())
    backend.check(err, "gmm_dlhs")
    gmm_dlhs.launches += 1
    return out


def tgmm(lhs: torch.Tensor, grad: torch.Tensor, group_sizes: torch.Tensor,
         out_dtype=torch.bfloat16, split=None) -> torch.Tensor:
    """The rhs gradient of ``gmm`` (megablox ``tgmm``, ops.py:89-97):
    out[g] = lhs[rows of g]^T . grad[rows of g], [E, K, N] in
    ``out_dtype``. On the card: lhs bf16, grad f32, out bf16, through
    ``split_hi_lo(grad)``, or the ``split`` given (hi, lo, flags)."""
    if not backend.on_cuda(lhs, grad, group_sizes):
        return tgmm_plain(lhs, grad, group_sizes, out_dtype)
    M, K = lhs.shape
    E, N = group_sizes.shape[0], grad.shape[1]
    if out_dtype != torch.bfloat16:
        raise TypeError(f"tgmm: the kernel gives bf16, not {out_dtype}")
    if M % 32 or K % 128 or N % 128:
        raise ValueError(f"tgmm: unsupported M={M}, K={K}, N={N}")
    backend.require(lhs, "lhs", torch.bfloat16, (M, K))
    backend.require(grad, "grad", torch.float32, (M, N))
    backend.require(group_sizes, "group_sizes", torch.int32, (E,))
    split = split_hi_lo(grad) if split is None else split
    _require_split(split, M, N)
    hi, lo, flags = split
    out = torch.empty((E, K, N), dtype=torch.bfloat16, device=lhs.device)
    p = backend.ptr
    err = library().aria_tgmm(p(lhs), p(hi), p(lo), p(flags), p(group_sizes), p(out), M, K, N,
                              E, backend.stream())
    backend.check(err, "tgmm")
    tgmm.launches += 1
    return out


gmm.launches = 0
split_hi_lo.launches = 0
gmm_dlhs.launches = 0
tgmm.launches = 0


class _Gmm(torch.autograd.Function):
    """``gmm`` with megablox's custom VJP (ops.py:63-106)."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, transpose_rhs):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        ctx.transpose_rhs = transpose_rhs
        return gmm(lhs, rhs, group_sizes, transpose_rhs)

    @staticmethod
    def backward(ctx, grad):
        lhs, rhs, group_sizes = ctx.saved_tensors
        grad = grad.contiguous()
        dlhs = drhs = None
        # on the card both gradients take one split of the cotangent
        split = split_hi_lo(grad) if backend.on_cuda(grad) and any(
            ctx.needs_input_grad[:2]) else None
        if ctx.needs_input_grad[0]:
            dlhs = gmm_dlhs(grad, rhs, group_sizes, not ctx.transpose_rhs, lhs.dtype, split)
        if ctx.needs_input_grad[1]:
            drhs = tgmm(lhs, grad, group_sizes, rhs.dtype, split)
            if ctx.transpose_rhs:
                drhs = drhs.transpose(1, 2)
        return dlhs, drhs, None, None


def experts_ragged(
    x: torch.Tensor,  # [T, D]
    indices: torch.Tensor,  # [T, k] expert ids (shared experts included)
    weights: torch.Tensor,  # [T, k] combine weights
    w1: torch.Tensor,  # [E, 2I, D] out-major, gate rows then up rows
    w2: torch.Tensor,  # [E, I, D]
) -> torch.Tensor:
    """The dropless ragged MoE FFN (moe.py:204-248): slots sorted by expert,
    padded to a multiple of 128 rows with the pad rows on the last group,
    two grouped matmuls with the GLU in x's dtype between them, the inverse
    permutation and the combine over k in f32. Returns [T, D] in x's dtype.
    Nothing waits on the host. Differentiable in x, the weights, w1 and w2."""
    T, D = x.shape
    E = w1.shape[0]
    k = indices.shape[1]
    flat_e = indices.reshape(-1).long()
    order = torch.argsort(flat_e, stable=True)  # routing slots by expert
    sorted_tokens = x[order // k]
    group_sizes = torch.zeros(E, dtype=torch.int32, device=x.device)
    group_sizes.scatter_add_(0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))
    M = T * k
    M_pad = -(-M // GMM_ROWS) * GMM_ROWS
    if M_pad != M:
        sorted_tokens = F.pad(sorted_tokens, (0, 0, 0, M_pad - M))
        group_sizes[E - 1] += M_pad - M
    h = glu(_Gmm.apply(sorted_tokens, w1, group_sizes, True).to(x.dtype))
    out = _Gmm.apply(h, w2, group_sizes, False)[:M]
    unsorted = torch.empty_like(out).index_copy_(0, order, out)  # the inverse permutation
    combined = torch.einsum("tkd,tk->td", unsorted.reshape(T, k, D), weights.float())
    return combined.to(x.dtype)
