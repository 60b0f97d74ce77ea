"""The serving mesh over a process group (counterpart of
aria_tpu/parallel/mesh.py:24-58).

The JAX mesh is a grid of devices with six named axes, and GSPMD places
each array's shards from a PartitionSpec. Here the grid is laid over the
ranks of the current ``torch.distributed`` group in the same order (JAX
reshapes its device list to ``MeshConfig.shape``, so rank r sits at
``unravel_index(r, shape)``), and each rank holds its own shard. A
``Mesh`` carries the axis sizes (``.shape[name]``, ``.axis_names``, as
JAX's), this rank's coordinate on each axis, and one process group per
line of the ``model`` and of the ``context`` axis: the ranks that differ
only on that axis.

Parameters are replicated on every rank. That is the JAX layout of the
int4 serving form (``serving_param_specs``, mesh.py:142-170), whose only
sharded leaves are the expert stacks over ``expert``; the engines shard
just the KV cache, by head over ``model`` and by position over
``context`` (``parallel/cp_cache.py``). Meshes with ``expert``, ``data``,
``fsdp`` or ``pipe`` above 1 are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch.distributed as dist

AXES = ("data", "fsdp", "expert", "model", "context", "pipe")
SHARDED = ("model", "context")  # the axes the port shards over


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


class Mesh:
    """This rank's view of the mesh: ``shape`` and ``coords`` by axis name,
    and the process group of its line along each sharded axis (None where
    the axis has size 1)."""

    axis_names = AXES

    def __init__(self, cfg: MeshConfig, rank: int, groups: dict):
        self.config = cfg
        self.rank = rank
        self.shape = dict(zip(AXES, cfg.shape))
        self.coords = {a: int(c) for a, c in zip(AXES, np.unravel_index(rank, cfg.shape))}
        self.groups = groups

    def block(self, axis: str, n: int) -> tuple[int, int]:
        """(start, size) of this rank's block of a dimension of ``n``
        entries sharded evenly over ``axis``."""
        size = self.shape[axis]
        if n % size:
            raise ValueError(f"{n} entries do not shard evenly over {axis}={size}")
        return self.coords[axis] * (n // size), n // size


def make_mesh(cfg: MeshConfig) -> Mesh:
    """The mesh of ``cfg`` over the current process group, whose size must
    be ``cfg.num_devices`` (one rank needs no group). Every rank must call
    it, in the same order as its other group calls: each line's process
    group is created by all ranks together."""
    for axis in AXES:
        if axis not in SHARDED and getattr(cfg, axis) > 1:
            raise NotImplementedError(
                f"MeshConfig({axis}={getattr(cfg, axis)}): only the serving mesh's model and "
                "context axes are ported (ROADMAP queue 1 item 11: expert, data, fsdp and pipe "
                "parallelism)")
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if world != cfg.num_devices:
        raise ValueError(f"Mesh {cfg.shape} needs {cfg.num_devices} ranks, the process group "
                         f"has {world}")
    groups: dict[str, Optional[dist.ProcessGroup]] = {a: None for a in SHARDED}
    ranks = np.arange(world).reshape(cfg.shape)
    for axis in SHARDED:
        ax = AXES.index(axis)
        if cfg.shape[ax] == 1:
            continue
        lines = np.moveaxis(ranks, ax, -1).reshape(-1, cfg.shape[ax])
        for line in lines:  # every rank creates every line's group, in order
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = group
    return Mesh(cfg, rank, groups)
