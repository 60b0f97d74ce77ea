"""Top-k routing, the GLU, and the dropless ragged expert path
(counterpart of aria_tpu/ops/moe.py:44-86 and :204-248).

Softmax is taken over the top-k logits only, in f32, and cast back to the
activation dtype. Only the eval-mode router is ported: the slice serves and
does not train, so the z and aux losses are not computed.

``experts_ragged`` sorts the routing slots by expert and runs both expert
products as ragged grouped matmuls (``gmm``, the forward of megablox's
``gmm``) with the group sizes on the device; everything around the two
products is torch ops, as the JAX package leaves it to XLA. Kernel:
``csrc/gmm.cu``, bf16 in and f32 out, for rhs [E, N, K] (w1,
``transpose_rhs``) and [E, K, N] (w2); its notes give the tiling. The
backward (megablox's custom VJP, ``tgmm``) belongs to training and is not
ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from aria_tpu_torch.ops import backend
from aria_tpu_torch.ops._build import library

GMM_ROWS = 128  # gmm's row tile: the ragged path pads the sorted rows to it


class RouterOutput(NamedTuple):
    weights: torch.Tensor  # [T, k] combine weights
    indices: torch.Tensor  # [T, k] int32 expert ids


def route_topk(x: torch.Tensor, gate_weight: torch.Tensor, topk: int) -> RouterOutput:
    """x [T, D], gate_weight [E, D] (f32); logits in f32."""
    logits = x.float() @ gate_weight.float().T
    top_logits, top_indices = torch.topk(logits, topk, dim=-1)
    scores = torch.softmax(top_logits, dim=-1)
    return RouterOutput(scores.to(x.dtype), top_indices.to(torch.int32))


def glu(x: torch.Tensor) -> torch.Tensor:
    gate, up = x.chunk(2, dim=-1)
    return F.silu(gate) * up


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


def gmm(
    lhs: torch.Tensor,  # [M, K], rows sorted by group
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


gmm.launches = 0


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
    Nothing waits on the host."""
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
    h = glu(gmm(sorted_tokens, w1, group_sizes, transpose_rhs=True).to(x.dtype))
    out = gmm(h, w2, group_sizes)[:M]
    unsorted = torch.empty_like(out).index_copy_(0, order, out)  # the inverse permutation
    combined = torch.einsum("tkd,tk->td", unsorted.reshape(T, k, D), weights.float())
    return combined.to(x.dtype)
