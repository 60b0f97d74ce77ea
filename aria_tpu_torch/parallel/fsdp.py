"""Sharded training over the ``fsdp`` and ``data`` axes (what the JAX
package gets from GSPMD annotations on ``aria_param_specs``, mesh.py:61-139).

Each rank stores 1/fsdp of every leaf whose spec names ``fsdp`` (and 1/n
of the expert stacks over ``expert``), and the optimizer's moments of that
shard (``mesh.shard_params``). In a training step:

- a decoder layer's whole weights are gathered over ``fsdp`` just before
  the layer runs (``gather_layer``, an autograd function whose backward
  reduce-scatters the gradient back to the shards); under remat the layer
  is recomputed, the gather included, so no layer's whole weights outlive
  its use;
- the leaves outside the layer stack (lm_head, final_norm, the projector
  and a trained ViT) are gathered whole at the start of the step as fresh
  leaves (``whole_leaves``), and their gradients reduce-scattered after the
  backward (``reduce_grads``): a rank whose rows hold no image then still
  takes part in the projector's collectives. The embedding is gathered
  inside autograd for its lookup alone (``gathered``: the lookup's backward
  needs no weight, so the whole table is freed at once), and a frozen ViT
  for the encode alone (``train/step.loss_fn``);
- gradients are summed over the batch group: the ``fsdp`` part by the
  reduce-scatter, the ``data`` part by an all-reduce, a leaf that
  ``fsdp`` does not shard by one all-reduce over both. Nothing is summed
  over ``expert``: every rank of an expert group computes the same
  function of the same rows (``parallel/ep.py``).

``data`` replicates the parameters. The global norm counts each element
once however many ranks hold it (``global_norm_sq``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from aria_tpu_torch.parallel import distributed as dd
from aria_tpu_torch.parallel.mesh import AXES, P, aria_param_specs, leaf_specs, local_dims


def specs_by_path(tree: Any, specs: Any = None) -> Dict[str, P]:
    """Path ('/'-joined keys) -> spec of every leaf of a training tree."""
    out: Dict[str, P] = {}

    def walk(t, s, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, s[k] if isinstance(s, dict) else s, f"{prefix}{k}/")
        else:
            out[prefix[:-1]] = s

    walk(tree, leaf_specs(tree, aria_param_specs() if specs is None else specs), "")
    return out


def _fsdp_dim(spec: P, mesh) -> int:
    """The dimension ``spec`` puts on ``fsdp`` on this mesh, or -1."""
    return next((d for d, a in local_dims(spec, mesh).items() if a == "fsdp"), -1)


class _GatherShard(torch.autograd.Function):
    """All-gather over ``fsdp`` along ``dim``; the backward reduce-scatters
    (sums) the whole gradient back to this rank's shard."""

    @staticmethod
    def forward(ctx, shard, group, dim):
        ctx.group, ctx.dim = group, dim
        return dd.all_gather(shard, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return dd.reduce_scatter(grad, ctx.group, ctx.dim), None, None


def gathered(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """A leaf whole over ``fsdp`` inside autograd (its gradient is
    reduce-scattered back to the shard in the backward)."""
    d = _fsdp_dim(spec, mesh)
    return _GatherShard.apply(t, mesh.group("fsdp"), d) if d >= 0 else t


def gather_layer(layers: dict, layer: int, mesh, specs: Dict[str, P]) -> dict:
    """Layer ``layer`` of the stacked decoder shards with every leaf whole
    over ``fsdp``, as a tree of [1, ...] stacks (the expert stacks keep
    this rank's experts). ``specs``: path under ``lm/layers/`` -> spec."""
    group = mesh.group("fsdp")

    def walk(t, prefix):
        if isinstance(t, dict):
            return {k: walk(v, f"{prefix}/{k}") for k, v in t.items()}
        piece = t[layer]
        d = _fsdp_dim(specs[prefix], mesh)
        if d > 0:
            piece = _GatherShard.apply(piece, group, d - 1)  # the layer axis is gone
        return piece.unsqueeze(0)

    return {k: walk(v, f"lm/layers/{k}") for k, v in layers.items()}


def whole_leaves(params: Any, mesh, specs: Dict[str, P], trainable: Dict[str, bool],
                 skip: tuple = ("lm/layers/",)) -> Any:
    """The tree with every leaf outside the ``skip`` prefixes gathered
    whole over ``fsdp`` as a new leaf (outside autograd), asking for a
    gradient where ``trainable`` says; the leaves under ``skip`` are passed
    through."""
    group = mesh.group("fsdp")

    def walk(t, prefix):
        if isinstance(t, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in t.items()}
        path = prefix[:-1]
        if path.startswith(skip):
            return t
        d = _fsdp_dim(specs[path], mesh)
        whole = dd.all_gather(t.detach(), group, d) if d >= 0 else t.detach()
        return whole.requires_grad_(trainable.get(path, False))

    return walk(params, "")


def reduce_grads(grads: Dict[str, torch.Tensor], mesh, specs: Dict[str, P],
                 scattered: tuple = ("lm/layers/",)) -> Dict[str, torch.Tensor]:
    """Each gradient summed over the batch group, on this rank's shard: a
    whole gradient of an ``fsdp``-sharded leaf reduce-scattered (one under
    the ``scattered`` prefixes came so from its gather's backward:
    ``gather_layer``, ``gathered``), then all-reduced over ``data``; a leaf
    that ``fsdp`` does not shard all-reduced over data x fsdp. Paths in
    sorted order, the same on every rank."""
    out = {}
    for path in sorted(grads):
        g = grads[path]
        d = _fsdp_dim(specs[path], mesh)
        if d >= 0:
            if not path.startswith(scattered):
                g = dd.reduce_scatter(g, mesh.group("fsdp"), d)
            if mesh.shape["data"] > 1:
                g = dd.all_reduce(g.contiguous(), mesh.group("data"))
        elif mesh.batch_size > 1:
            g = dd.all_reduce(g.contiguous(), mesh.group("batch"))
        out[path] = g
    return out


def replication(spec: P, mesh) -> int:
    """How many ranks hold the same shard of a leaf of ``spec``."""
    split = 1
    for axis in local_dims(spec, mesh).values():
        split *= mesh.shape[axis]
    return mesh.config.num_devices // split


def global_norm_sq(grads: Dict[str, torch.Tensor], mesh, specs: Dict[str, P]) -> torch.Tensor:
    """The squared global norm of sharded gradients: each leaf's sum of
    squares over its replication, summed over every rank (each element
    counted once)."""
    dev = next(iter(grads.values())).device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for path in sorted(grads):
        g = grads[path]
        total = total + torch.sum(g.float() * g.float()) / replication(specs[path], mesh)
    if mesh.config.num_devices > 1:
        total = dd.all_reduce(total.reshape(1), None).reshape(())
    return total


def whole_on_first(t: torch.Tensor, spec: P, mesh) -> Optional[torch.Tensor]:
    """A leaf's shards put together whole on rank 0, on the CPU (None on
    the other ranks): each block sent once to rank 0, by the rank at
    coordinate 0 of every axis the spec does not shard (``send_to_first``),
    and placed by its coordinates. A leaf the spec leaves whole is rank 0's
    own."""
    dims = local_dims(spec, mesh)
    if not dims:
        return t.detach().cpu() if mesh.rank == 0 else None
    blocks = np.indices([mesh.shape[a] for a in dims.values()]).reshape(len(dims), -1).T
    shape = list(t.shape)
    for d, axis in dims.items():
        shape[d] *= mesh.shape[axis]
    whole = torch.empty(shape, dtype=t.dtype) if mesh.rank == 0 else None
    for block in blocks:
        coords = [0] * len(AXES)
        for (d, axis), c in zip(dims.items(), block):
            coords[AXES.index(axis)] = int(c)
        owner = int(np.ravel_multi_index(coords, mesh.config.shape))
        part = dd.send_to_first(t, owner)
        if whole is not None:
            index = [slice(None)] * t.dim()
            for (d, _), c in zip(dims.items(), block):
                index[d] = slice(int(c) * t.shape[d], (int(c) + 1) * t.shape[d])
            whole[tuple(index)] = part
    return whole


def gather_whole(tree: Any, mesh, specs: Dict[str, P], prefix: str = "") -> Any:
    """A sharded tree whole again on every rank (each leaf all-gathered over
    ``fsdp`` and ``expert`` along the dimensions its spec shards); ``specs``
    by path, looked up under ``prefix`` + the leaf's path."""
    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}{k}/") for k, v in t.items()}
        if not isinstance(t, torch.Tensor):
            return t
        spec = specs.get(path[:-1], P())
        t = t.detach()
        for d, axis in sorted(local_dims(spec, mesh).items()):
            t = dd.all_gather(t, mesh.group(axis), d)
        return t

    with torch.no_grad():
        return walk(tree, prefix)
