"""Expert parallelism: the tokens of an MoE call travel to their experts'
owners and back over the ``expert`` axis (counterpart of
aria_tpu/parallel/ep.py).

Each rank of an expert group owns E/n experts (its shard of the stacks,
``[E/n, ...]`` a layer or ``[L, E/n, ...]`` whole) and holds the same
tokens x [T, D] as the other ranks of its group: attention runs on every
rank alike. Only tokens move; the expert stacks are never gathered.

One call, on every rank of the group:

1. the router over all T tokens (f32 logits, top-k, softmax over the top
   logits in f32), and in training the z and aux losses;
2. this rank's block of T/n tokens, its routing slots sent to the owner of
   each slot's expert (``_dispatch_to_devices``: slots in order per
   destination, past the capacity dropped), with the local expert id;
3. the owner computes the received rows, one expert each at weight 1,
   rounded to x's dtype (the bf16 return that makes EP differ from one
   chip, tests/test_mesh_kernels.py:127-139), and sends them back;
4. each slot's row combined with its routing weight in f32, and the
   blocks gathered so that every rank holds all T outputs.

Dropless (``capacity_factor=None``, what the decoder passes) the rows sent
are only the real ones, after the ranks exchange their counts: the JAX body
sends [n, C] buffers padded with zero rows (to local expert 0) instead,
and every real row's result is the same either way. With ``layer_idx`` the
stacks are whole and the decode-MoE kernel of their form indexes (layer,
expert) itself (``_local_expert_rows``); that path keeps the JAX buffers
[n, C], so every rank launches its kernel at every call. A finite
``capacity_factor`` drops slots by the JAX rule, capacity ``max(1,
int(T/n * k * cf / n))`` per destination.

Autograd: the block of step 2 is ``SplitRows`` (its backward gathers the
blocks' gradients), the exchanges are ``AllToAll`` (backward: the reverse
exchange) and step 4's gather is ``GatherRows`` (backward: this rank's
block). So everything outside the call, the router included, has the same
whole gradient on every rank of the group, and no gradient is summed over
``expert``. The losses are computed on every rank from all T tokens, which
gives what the JAX body's psum/pmean over ``expert`` gives (ep.py:127-138).
In training over a batch group (data x fsdp > 1) the tokens are this
rank's rows of the global batch, the counts of the aux loss are summed
over the group, and the returned losses are this rank's share: their sum
over the batch group is the global z and aux loss.
"""

from __future__ import annotations

from typing import Optional

import torch

from aria_tpu_torch.ops.expert_dequant import expert_block_dequant
from aria_tpu_torch.ops.moe import experts_ragged, router_logits
from aria_tpu_torch.ops.moe_decode_kernel import (
    DECODE_KERNEL_MAX_TOKENS,
    moe_decode,
    moe_decode_int4,
    moe_decode_quant,
)
from aria_tpu_torch.ops.quant import is_quantized, is_quantized_int4
from aria_tpu_torch.parallel import distributed as dd


def _dispatch_to_devices(dest: torch.Tensor, n: int, capacity: int) -> torch.Tensor:
    """Per routing slot, its row in the [n * C] send buffer (row n * C is
    the trash of slots past the capacity): ep.py:33-46, the arithmetic of
    ``ops/moe._dispatch_indices`` with devices in place of experts."""
    S = dest.shape[0]
    dest = dest.long()
    order = torch.argsort(dest, stable=True)
    counts = torch.zeros(n, dtype=torch.long, device=dest.device).scatter_add_(
        0, dest, torch.ones_like(dest))
    starts = torch.cumsum(counts, 0) - counts
    ranks = torch.arange(S, device=dest.device) - starts[dest[order]]
    pos = torch.empty_like(ranks).index_copy_(0, order, ranks)
    return torch.where(pos < capacity, dest * capacity + pos, n * capacity)


def _stack(w):
    """The tensor that carries a stack's expert axis."""
    if is_quantized_int4(w):
        return w["q4"]
    return w["q"] if is_quantized(w) else w


def _decode_kernel(x, e, w1, w2, layer: int, act_int8: bool) -> torch.Tensor:
    """One expert a row at weight 1 through the decode-MoE kernel of the
    stacks' form, at most DECODE_KERNEL_MAX_TOKENS rows a launch."""
    outs = []
    for i in range(0, x.shape[0], DECODE_KERNEL_MAX_TOKENS):
        xc = x[i:i + DECODE_KERNEL_MAX_TOKENS]
        ec = e[i:i + DECODE_KERNEL_MAX_TOKENS, None].to(torch.int32).contiguous()
        ones = torch.ones(ec.shape, dtype=torch.float32, device=x.device)
        if is_quantized_int4(w1):
            out = moe_decode_int4(xc, ec, ones, w1["q4"], w1["sg"], w2["q4"], w2["s8"], layer,
                                  act_int8=act_int8)
        elif is_quantized(w1):
            out = moe_decode_quant(xc, ec, ones, w1["q"], w1["s8"], w2["q"], w2["s8"], layer)
        else:
            out = moe_decode(xc, ec, ones, w1, w2, layer)
        outs.append(out.to(x.dtype))
    return torch.cat(outs) if outs else x.new_zeros(x.shape)


def _local_expert_rows(x_recv: torch.Tensor, e_recv: torch.Tensor, w1, w2,
                       layer_idx: Optional[int], act_int8: bool) -> torch.Tensor:
    """The received rows through this rank's experts (ep.py:48-106): with
    ``layer_idx`` the whole stacks [L, E/n, ...] through the decode-MoE
    kernel of their form where the JAX package has a tile for I; else the
    layer's [E/n, ...] experts (quantized ones dequantized by
    ``expert_block_dequant``) through ``experts_ragged``, the ``gmm``
    kernels and their backward. Rows come back in x's dtype."""
    from aria_tpu_torch.models.moe_lm import decode_kernel_tile

    I = _stack(w2).shape[-2]
    if layer_idx is not None and decode_kernel_tile(I) == I:
        return _decode_kernel(x_recv, e_recv, w1, w2, layer_idx, act_int8)
    if layer_idx is not None:
        w1 = {k: v[layer_idx] for k, v in w1.items()} if isinstance(w1, dict) else w1[layer_idx]
        w2 = {k: v[layer_idx] for k, v in w2.items()} if isinstance(w2, dict) else w2[layer_idx]
    E_loc = _stack(w1).shape[0]
    if isinstance(w1, dict):
        w1 = expert_block_dequant(w1, "w1", 0, E_loc, x_recv.dtype)
        w2 = expert_block_dequant(w2, "w2", 0, E_loc, x_recv.dtype)
    if x_recv.shape[0] == 0:
        # nothing routed here: the rows and the weights stay in the graph, so
        # that this rank's backward runs the collectives its peers run
        return x_recv * 0 + 0 * (w1.sum() + w2.sum()).to(x_recv.dtype)
    ones = torch.ones((x_recv.shape[0], 1), dtype=x_recv.dtype, device=x_recv.device)
    return experts_ragged(x_recv, e_recv[:, None].to(torch.int32), ones, w1, w2)


def router_losses(logits: torch.Tensor, indices: torch.Tensor, z_loss_coeff: float,
                  aux_loss_coeff: float, mesh) -> tuple:
    """The router's z and switch losses of ``route_topk`` (moe.py:44-79)
    taken over the global batch: ``logits`` [T, E] f32 and ``indices`` [T,
    k] of this rank's rows, the expert counts summed over the batch group,
    the means over its T x (data x fsdp) tokens. Returns this rank's share
    of each; their sum over the batch group is the global value."""
    T, E = logits.shape
    k = indices.shape[1]
    parts = mesh.batch_size if mesh is not None else 1
    t_glob = T * parts
    z = torch.logsumexp(logits, dim=-1)
    z_loss = torch.sum(torch.square(z)) / t_glob * z_loss_coeff
    counts = torch.zeros(E, dtype=torch.float32, device=logits.device).scatter_add_(
        0, indices.reshape(-1).long(), torch.ones(indices.numel(), device=logits.device))
    if parts > 1:
        counts = dd.all_reduce(counts, mesh.group("batch"))
    probs = torch.softmax(logits, dim=-1)
    aux_loss = torch.sum(probs.sum(0) / t_glob * counts) * (E / (t_glob * k) * aux_loss_coeff)
    return z_loss, aux_loss


def experts_ep(
    x: torch.Tensor,  # [T, D], the same on every rank of the expert group
    gate: torch.Tensor,  # [E, D] f32, all experts
    topk: int,
    w1,  # this rank's [E/n, 2I, D] (or [L, E/n, ...] with layer_idx), float or quantized
    w2,  # this rank's [E/n, I, D] (or [L, E/n, ...])
    mesh,
    *,
    capacity_factor: Optional[float] = None,
    z_loss_coeff: float = 0.0,
    aux_loss_coeff: float = 0.0,
    training: bool = False,
    layer_idx: Optional[int] = None,
    act_int8: bool = True,
):
    """The expert-parallel MoE FFN (ep.py:141-229). Returns (out [T, D] in
    x's dtype on every rank, z_loss, aux_loss); ``act_int8`` picks the W4A8
    int4 decode kernel, as the JAX package's ARIA_TPU_A8 does."""
    if layer_idx is not None and training:
        raise ValueError("full-stack EP (layer_idx) is a serving path")
    group = mesh.group("expert")
    n, me = mesh.shape["expert"], mesh.coords["expert"]
    T, D = x.shape
    E = gate.shape[0]
    if T % n or E % n:
        raise ValueError(f"tokens {T} and experts {E} must divide expert={n}")
    E_loc = E // n
    got = _stack(w1).shape[0 if layer_idx is None else 1]
    if got != E_loc:
        raise ValueError(f"expert stack of {got} experts on this rank, {E_loc} expected "
                         f"({E} over expert={n})")
    T_loc, k = T // n, topk
    C = T_loc * k if capacity_factor is None else max(1, int(T_loc * k * capacity_factor / n))
    padded = layer_idx is not None

    logits = router_logits(x, gate, training)
    top_logits, indices = torch.topk(logits, k, dim=-1)
    weights = torch.softmax(top_logits, dim=-1)  # f32: the JAX body combines in f32
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    z_loss = aux_loss = zero
    if training:
        z_loss, aux_loss = router_losses(logits, indices, z_loss_coeff, aux_loss_coeff, mesh)

    # this rank's block of tokens and their slots
    x_loc = dd.SplitRows.apply(x, group)
    w_loc = dd.SplitRows.apply(weights, group)
    idx_loc = indices[me * T_loc:(me + 1) * T_loc].reshape(-1)
    dest, local_e = idx_loc // E_loc, idx_loc % E_loc
    send_row = _dispatch_to_devices(dest, n, C)
    token_of_slot = torch.arange(T_loc * k, device=x.device) // k
    if padded:
        x_send = x.new_zeros((n * C + 1, D)).index_put((send_row,), x_loc[token_of_slot])[:n * C]
        e_send = torch.zeros(n * C + 1, dtype=torch.long, device=x.device).index_put(
            (send_row,), local_e)[:n * C]
        send_counts = recv_counts = [C] * n
        slot_row = send_row  # trash n * C reads the zero row below
    else:
        rows, perm = torch.sort(send_row, stable=True)  # by destination, then place
        kept = int((send_row < n * C).sum())
        perm = perm[:kept]
        x_send, e_send = x_loc[token_of_slot[perm]], local_e[perm]
        counts_out = torch.bincount(dest[perm], minlength=n)
        send_counts = counts_out.tolist()
        recv_counts = dd.exchange_counts(counts_out, group)
        slot_row = torch.full_like(send_row, kept).index_put_(
            (perm,), torch.arange(kept, device=x.device))
    x_recv = dd.AllToAll.apply(x_send, send_counts, recv_counts, group)
    e_recv = dd.all_to_all(e_send, send_counts, recv_counts, group)
    out_rows = _local_expert_rows(x_recv, e_recv, w1, w2, layer_idx, act_int8)
    back = dd.AllToAll.apply(out_rows.to(x.dtype), recv_counts, send_counts, group)
    back = torch.cat([back, back.new_zeros((1, D))])
    per_slot = back[slot_row].reshape(T_loc, k, D)  # dropped slots read zeros
    combined = torch.einsum("tkd,tk->td", per_slot.float(), w_loc).to(x.dtype)
    return dd.GatherRows.apply(combined, group), z_loss, aux_loss
