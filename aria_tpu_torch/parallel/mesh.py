"""The device mesh over a process group, and the parameters' spec trees
(counterpart of aria_tpu/parallel/mesh.py).

The JAX mesh is a grid of devices with six named axes, and GSPMD places
each array's shards from a PartitionSpec. Here the grid is laid over the
ranks of the current ``torch.distributed`` group in the same order (JAX
reshapes its device list to ``MeshConfig.shape``, so rank r sits at
``unravel_index(r, shape)``), and each rank holds its own shard. A
``Mesh`` carries the axis sizes (``.shape[name]``, ``.axis_names``, as
JAX's), this rank's coordinate on each axis, and one process group per
line of each axis above 1 (the ranks that differ only on that axis), plus
the batch group: the ranks that differ only in ``data`` and ``fsdp``,
over which a training batch is split by rows.

What each axis shards here:

- ``expert``: the expert stacks (dim E), and the tokens of an MoE call
  while they visit their experts (``parallel/ep.py``);
- ``fsdp``: every parameter whose spec names it, stored as 1/fsdp shards
  and gathered a layer at a time (``parallel/fsdp.py``), and the batch;
- ``data``: the batch; parameters stay whole;
- ``model`` and ``context``: the serving KV cache, by head and by position
  (``parallel/cp_cache.py``). A spec on ``model`` leaves its leaf whole:
  weight tensor parallelism is not ported (ROADMAP queue 1 item 11);
- ``pipe``: not ported, and refused.

The spec trees are the JAX package's, leaf for leaf, with ``P`` a tuple of
axis names or None per dimension as JAX's PartitionSpec is.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "fsdp", "expert", "model", "context", "pipe")
GROUPED = ("data", "fsdp", "expert", "model", "context")  # the axes that get groups
SHARDED_PARAMS = ("fsdp", "expert")  # the axes a parameter's shard follows


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    fsdp: int = 1
    expert: int = 1
    model: int = 1
    context: int = 1
    pipe: int = 1

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.data, self.fsdp, self.expert, self.model, self.context, self.pipe)

    @property
    def num_devices(self) -> int:
        return int(np.prod(self.shape))


class P(tuple):
    """A PartitionSpec: per dimension, the axis it is sharded over or None
    (``P("pipe", None, "fsdp")``); trailing dimensions not named are whole."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


class Mesh:
    """This rank's view of the mesh: ``shape`` and ``coords`` by axis name,
    and ``groups``: the process group of its line along each axis above 1
    (None where the axis has size 1) and ``"batch"``, the ranks that share
    its ``expert``, ``model``, ``context`` and ``pipe`` coordinates (None
    when data x fsdp is 1)."""

    axis_names = AXES

    def __init__(self, cfg: MeshConfig, rank: int, groups: dict):
        self.config = cfg
        self.rank = rank
        self.shape = dict(zip(AXES, cfg.shape))
        self.coords = {a: int(c) for a, c in zip(AXES, np.unravel_index(rank, cfg.shape))}
        self.groups = groups

    def group(self, name: str) -> Optional[dist.ProcessGroup]:
        return self.groups.get(name)

    @property
    def batch_size(self) -> int:
        """Ranks the batch is split over: data x fsdp."""
        return self.shape["data"] * self.shape["fsdp"]

    @property
    def batch_index(self) -> int:
        """This rank's place among them (data-major, as ``P(("data",
        "fsdp"))`` lays the rows out)."""
        return self.coords["data"] * self.shape["fsdp"] + self.coords["fsdp"]

    def block(self, axis: str, n: int) -> tuple[int, int]:
        """(start, size) of this rank's block of a dimension of ``n``
        entries sharded evenly over ``axis``."""
        size = self.shape[axis]
        if n % size:
            raise ValueError(f"{n} entries do not shard evenly over {axis}={size}")
        return self.coords[axis] * (n // size), n // size


def _lines(ranks: np.ndarray, axes: tuple[int, ...]) -> np.ndarray:
    """The rank lists that differ only on ``axes``: [groups, members]."""
    rest = [a for a in range(ranks.ndim) if a not in axes]
    moved = np.transpose(ranks, rest + list(axes))
    return moved.reshape(-1, int(np.prod([ranks.shape[a] for a in axes])))


def make_mesh(cfg: MeshConfig) -> Mesh:
    """The mesh of ``cfg`` over the current process group, whose size must
    be ``cfg.num_devices`` (one rank needs no group). Every rank must call
    it, in the same order as its other group calls: each line's process
    group is created by all ranks together."""
    if cfg.pipe > 1:
        raise NotImplementedError(
            f"MeshConfig(pipe={cfg.pipe}): pipeline parallelism is not ported (ROADMAP queue 1 "
            "item 11)")
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if world != cfg.num_devices:
        raise ValueError(f"Mesh {cfg.shape} needs {cfg.num_devices} ranks, the process group "
                         f"has {world}")
    groups: dict[str, Optional[dist.ProcessGroup]] = {a: None for a in GROUPED + ("batch",)}
    ranks = np.arange(world).reshape(cfg.shape)
    wanted = [(axis, (AXES.index(axis),)) for axis in GROUPED]
    wanted.append(("batch", (AXES.index("data"), AXES.index("fsdp"))))
    for name, axes in wanted:
        if int(np.prod([cfg.shape[a] for a in axes])) == 1:
            continue
        for line in _lines(ranks, axes):  # every rank creates every line's group, in order
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[name] = group
    return Mesh(cfg, rank, groups)


# ------------------------------------------------------------------ specs

def lm_param_specs() -> dict:
    """The decoder's training tree (layers have a leading L axis): experts
    over ``expert``, attention and FFN hidden over ``model``, and a
    non-contracting axis of everything over ``fsdp`` (mesh.py:61-84)."""
    return {
        "embed": P("model", "fsdp"),
        "layers": {
            "attn_norm": P("pipe", None),
            "ffn_norm": P("pipe", None),
            "wqkv": P("pipe", "fsdp", "model"),
            "wo": P("pipe", "model", "fsdp"),
            "gate": P("pipe", None, "fsdp"),
            "w1": P("pipe", "expert", "model", "fsdp"),
            "w2": P("pipe", "expert", "model", "fsdp"),
            "shared_w1": P("pipe", "fsdp", "model"),
            "shared_w2": P("pipe", "model", "fsdp"),
        },
        "final_norm": P(None),
        "lm_head": P("fsdp", "model"),
    }


def vit_param_specs() -> dict:
    return {
        "patch_embed_w": P(None, "fsdp"),
        "patch_embed_b": P(None),
        "pos_embed": P(None, "fsdp"),
        "layers": {
            "ln1_w": P(None, None),
            "ln1_b": P(None, None),
            "ln2_w": P(None, None),
            "ln2_b": P(None, None),
            "wq": P(None, "fsdp", "model"),
            "bq": P(None, "model"),
            "wk": P(None, "fsdp", "model"),
            "bk": P(None, "model"),
            "wv": P(None, "fsdp", "model"),
            "bv": P(None, "model"),
            "wo": P(None, "model", "fsdp"),
            "bo": P(None, None),
            "fc1_w": P(None, "fsdp", "model"),
            "fc1_b": P(None, "model"),
            "fc2_w": P(None, "model", "fsdp"),
            "fc2_b": P(None, None),
        },
    }


def projector_param_specs() -> dict:
    return {
        "query": P(None, "fsdp"),
        "ln_q_w": P(None),
        "ln_q_b": P(None),
        "ln_kv_w": P(None),
        "ln_kv_b": P(None),
        "q_proj": P("fsdp", "model"),
        "k_proj": P("fsdp", "model"),
        "v_proj": P("fsdp", "model"),
        "attn_in_w": P("fsdp", "model"),
        "attn_in_b": P("model"),
        "attn_out_w": P("model", "fsdp"),
        "attn_out_b": P(None),
        "linear_w": P("fsdp", "model"),
        "linear_b": P("model"),
        "ln_ffn_w": P(None),
        "ln_ffn_b": P(None),
        "ffn_in": P("fsdp", "model"),
        "ffn_out": P("model", "fsdp"),
    }


def aria_param_specs() -> dict:
    return {
        "vision": vit_param_specs(),
        "projector": projector_param_specs(),
        "lm": lm_param_specs(),
    }


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def serving_param_specs(params: dict) -> dict:
    """Spec tree of a serving form (mesh.py:142-170): every leaf of the
    expert stacks over ``expert`` on dim 1 (of [L, E, ...]), everything
    else replicated."""
    out = {}
    for k, v in params.items():
        if k == "lm":
            out[k] = serving_param_specs(v)
        elif k == "layers":
            out[k] = {k2: _map_leaves(lambda _: P(None, "expert") if k2 in ("w1", "w2") else P(),
                                      v2)
                      for k2, v2 in v.items()}
        else:
            out[k] = _map_leaves(lambda _: P(), v)
    return out


def is_serving_quantized(params: dict) -> bool:
    """True when the decoder tree is in a quantized serving form (dict leaves)."""
    lm = params.get("lm", params)
    layers = lm.get("layers", {})
    return isinstance(layers.get("w1"), dict) or isinstance(layers.get("wqkv"), dict)


def align_specs(tree, specs):
    """A spec over a quantized leaf group ({"q"/"q4", scales...}) spread to
    its leaves (mesh.py:173-188): a leaf of the spec's rank keeps it, a
    lower-rank scale plane is replicated; subtrees the specs do not name
    are left out."""
    if isinstance(specs, P):
        if isinstance(tree, dict):
            return {k: (specs if getattr(v, "ndim", None) == len(specs) else P())
                    for k, v in tree.items()}
        return specs
    if isinstance(specs, dict) and isinstance(tree, dict):
        return {k: align_specs(tree.get(k), v) for k, v in specs.items() if k in tree}
    return specs


def local_dims(spec: P, mesh: Mesh, axes: tuple = SHARDED_PARAMS) -> dict:
    """{dim: axis} of the dimensions this port shards a leaf of ``spec``
    over on ``mesh``: ``fsdp`` and ``expert`` (or those of ``axes``) above 1."""
    return {d: a for d, a in enumerate(spec) if a in axes and mesh.shape[a] > 1}


def shard_leaf(t: torch.Tensor, spec: P, mesh: Mesh,
               axes: tuple = SHARDED_PARAMS) -> torch.Tensor:
    """This rank's block of a whole leaf: each dimension that ``spec`` puts
    on ``fsdp`` or ``expert`` (those of ``axes``) sliced to its
    coordinate's block (evenly; a dimension that does not divide raises).
    ``model`` leaves it whole."""
    dims = local_dims(spec, mesh, axes)
    for d, axis in dims.items():
        start, size = mesh.block(axis, t.shape[d])
        t = t.narrow(d, start, size)
    return t.contiguous() if dims else t


def shard_params(tree: Any, specs: Any, mesh: Mesh, axes: tuple = SHARDED_PARAMS) -> Any:
    """The counterpart of ``shard_tree`` (mesh.py:191-210): this rank's
    slice of every leaf of a whole tree, for the axes ported here
    (``fsdp`` and ``expert``; see ``shard_leaf``). A spec on ``model``
    leaves the leaf replicated until weight tensor parallelism is ported.
    A copy is made only where a leaf is sliced; the whole leaf is freed
    when the caller drops the tree it gave."""
    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        return shard_leaf(t, s, mesh, axes)

    return walk(tree, leaf_specs(tree, specs))


def serving_shard(params: dict, num_experts: int, mesh: Optional[Mesh]) -> dict:
    """The serving engines' parameters on an expert mesh: this rank's
    experts of a whole tree (a quantized form by ``serving_param_specs``, a
    float tree by ``aria_param_specs``, over ``expert`` only: the engines
    keep every other leaf whole); a tree already holding E/n experts a
    rank is returned as it is. A fused stack raises: the JAX engine
    serves it by gathering the stacks, which the port does not do."""
    if mesh is None or mesh.shape["expert"] == 1:
        return params
    n = mesh.shape["expert"]
    layers = params["lm"]["layers"]
    if "shared_w1" not in layers:
        raise ValueError("a fused expert stack on an expert mesh: build the tree with the "
                         "shared experts unfused (fuse_shared=False)")
    w1 = layers["w1"]
    stack = w1.get("q4", w1.get("q")) if isinstance(w1, dict) else w1
    if stack.shape[1] * n == num_experts:
        return params
    specs = serving_param_specs(params) if is_serving_quantized(params) else aria_param_specs()
    return shard_params(params, specs, mesh, axes=("expert",))


def leaf_specs(tree: Any, specs: Any) -> Any:
    """The spec of every leaf of ``tree`` (after ``align_specs``), P() where
    the spec tree names none."""
    specs = align_specs(tree, specs)

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s.get(k, P()) if isinstance(s, dict) else s)
                    for k, v in t.items()}
        return s if isinstance(s, P) else P()

    return walk(tree, specs)
