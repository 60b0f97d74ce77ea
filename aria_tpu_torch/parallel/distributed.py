"""Process groups for the serving mesh (counterpart of
aria_tpu/parallel/distributed.py).

JAX sees every device of a host in one process and compiles the
collectives from sharding annotations. Here each device of the mesh is a
rank of a ``torch.distributed`` process group, and the collectives are
called by hand (``parallel/cp_cache.py``). :func:`initialize` joins a group
from explicit arguments: the JAX version reads ``ARIA_TPU_*`` environment
variables, and no module of the port but the build reads the environment.
:func:`run_ranks` starts the ranks of one host as processes and is the
counterpart of one JAX process holding all its devices.

The backend is the caller's to name: ``gloo`` for CPU tensors and for
ranks that share one card (NCCL refuses two ranks on one device), ``nccl``
only when every rank has a card of its own.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("gloo", "nccl")
TIMEOUT = datetime.timedelta(seconds=600)  # a collective that waits longer raises


def initialize(
    init_method: Optional[str] = None,
    *,
    store: Optional[dist.Store] = None,
    world_size: int,
    rank: int,
    backend: str,
) -> int:
    """Join the process group of ``world_size`` ranks as ``rank``; returns
    the rank. Give either ``init_method`` (``tcp://host:port`` or
    ``file://path``) or a ``store``. A no-op for one rank, and when this
    process has joined already."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} of {world_size}")
    if world_size == 1 or dist.is_initialized():
        return rank
    if (init_method is None) == (store is None):
        raise ValueError("give exactly one of init_method and store")
    dist.init_process_group(backend, init_method=init_method, store=store,
                            world_size=world_size, rank=rank, timeout=TIMEOUT)
    return rank


def _rank_main(r: int, world: int, backend: str, store_path: str, results, fn, args):
    try:
        store = dist.FileStore(store_path, world)
        initialize(store=store, world_size=world, rank=r, backend=backend)
        out = fn(r, *args)
        results.put((r, True, out))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        results.put((r, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable[..., Any], world_size: int, *args, backend: str = "gloo",
              store_dir: Optional[str] = None, timeout_s: float = 900.0) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` spawned processes joined in
    one process group over a ``FileStore`` in ``store_dir`` (a fresh
    temporary directory if none is given); returns the ranks' return values
    in rank order. ``fn`` must be importable (a module-level function) and
    its arguments and result picklable. A rank that raises, dies or
    outlasts ``timeout_s`` makes this raise, after the other ranks are
    stopped."""
    if store_dir is None:
        store_dir = tempfile.mkdtemp(prefix="aria_ranks_")
    store_path = os.path.join(store_dir, f"store_{os.getpid()}_{id(fn)}")
    if os.path.exists(store_path):
        os.remove(store_path)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, backend, store_path, results, fn, args),
                         daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    out: dict = {}
    failure = None
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < world_size and failure is None:
            try:
                r, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in out]
                if dead:
                    failure = f"rank {dead[0]} died with exit code {procs[dead[0]].exitcode}"
                elif time.monotonic() > deadline:
                    failure = f"ranks still running after {timeout_s:.0f} s"
                continue
            if ok:
                out[r] = payload
            else:
                failure = f"rank {r} raised:\n{payload}"
        if failure is None:
            for p in procs:
                p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        if os.path.exists(store_path):
            os.remove(store_path)
    if failure is not None:
        raise RuntimeError(f"run_ranks({getattr(fn, '__name__', fn)}): {failure}")
    return [out[r] for r in range(world_size)]
