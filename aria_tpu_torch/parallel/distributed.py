"""Process groups, the collectives and the ranks of one host
(counterpart of aria_tpu/parallel/distributed.py).

JAX sees every device of a host in one process and compiles the
collectives from sharding annotations. Here each device of the mesh is a
rank of a ``torch.distributed`` process group, and the collectives are
called by hand (``parallel/cp_cache.py``, ``parallel/ep.py``,
``parallel/fsdp.py``). :func:`initialize` joins a group from explicit
arguments: the JAX version reads ``ARIA_TPU_*`` environment variables, and
no module of the port but the build reads the environment. :func:`run_ranks`
starts the ranks of one host as processes and is the counterpart of one JAX
process holding all its devices; :func:`local_batch_rows` is this rank's
share of a global batch.

The backend is the caller's to name: ``gloo`` for CPU tensors and for
ranks that share one card (NCCL refuses two ranks on one device), ``nccl``
only when every rank has a card of its own (:func:`default_backend`).

The helpers :func:`all_to_all`, :func:`all_gather`, :func:`reduce_scatter`
and :func:`all_reduce` are each one collective over a group,
:func:`send_to_first` one send to rank 0. They take tensors where they
lie: gloo moves a CUDA tensor through host memory itself, nccl keeps it on
the card. With ``LOG`` set to a list, each call appends (name, bytes this
rank sent, seconds until the call returned, its start on
``time.perf_counter``), which is how a run shows that only token buffers
travel and what share of a step the collectives take.
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
LOG: Optional[list] = None  # (collective, bytes sent, seconds, start) per call when a list


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


def default_backend(world_size: int, device: str) -> str:
    """``nccl`` when the ranks are on the card and each has one of its own,
    else ``gloo`` (CPU ranks, or ranks sharing a card)."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def rank_device(device: str, rank: int, backend: str) -> torch.device:
    """The device of ``rank``: its own card under nccl, the one card the
    ranks share under gloo, or the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and backend == "nccl":
        return torch.device("cuda", rank)
    return dev


CONTEXT_SLACK = 256 * 2**20  # a rank's share kept back for the kernels its context loads later


def share_card(device: torch.device) -> int:
    """For ranks that share one card: cap this rank's caching allocator at
    an equal share of the memory free once every rank has made its context
    (less ``CONTEXT_SLACK``). A rank that reaches its share frees the blocks
    it has cached, those gloo's copies leave on its own streams too, before
    it asks for more, so that one rank's cache cannot starve another. Every
    rank of the default group calls it before it allocates; returns the
    share in bytes."""
    torch.zeros(1, device=device)  # this rank's context
    dist.barrier()
    free, total = torch.cuda.mem_get_info(device)
    dist.barrier()  # every rank has read before any allocates
    share = free / dist.get_world_size() - CONTEXT_SLACK
    torch.cuda.set_per_process_memory_fraction(share / total, device)
    return int(share)


def local_batch_rows(rows, batch_size: int, parts: int, index: int):
    """Part ``index`` of ``parts`` of one global batch's rows, contiguous
    (distributed.py:68-82, with the batch group's size and place in place
    of the process count and index): the global batch must divide."""
    if parts == 1:
        return rows
    if batch_size % parts:
        raise ValueError(f"global batch {batch_size} must divide over {parts} ranks")
    per = batch_size // parts
    return rows[index * per:(index + 1) * per]


# ------------------------------------------------------------ collectives

def _log(name: str, nbytes: int, t0: float) -> None:
    if LOG is not None:
        LOG.append((name, int(nbytes), time.perf_counter() - t0, t0))


def all_to_all(x: torch.Tensor, send_counts: list, recv_counts: list, group) -> torch.Tensor:
    """Rows of ``x`` [sum(send_counts), ...] sent in blocks, block i to the
    group's rank i; returns the received blocks [sum(recv_counts), ...] in
    rank order (``all_to_all_single`` with uneven splits)."""
    t0 = time.perf_counter()
    x = x.contiguous()
    out = x.new_empty((sum(recv_counts),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x, [int(c) for c in recv_counts],
                           [int(c) for c in send_counts], group=group)
    _log("all_to_all", x.numel() * x.element_size(), t0)
    return out


def exchange_counts(counts: torch.Tensor, group) -> list:
    """Each rank's int64 [n] send counts in, the counts each rank sends to
    this one out (a list): the sizes an uneven all-to-all needs."""
    t0 = time.perf_counter()
    src = counts.long().contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    _log("exchange_counts", src.numel() * 8, t0)
    return out.tolist()


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` in rank order
    (contiguous)."""
    t0 = time.perf_counter()
    n = dist.get_world_size(group)
    moved = x.movedim(dim, 0).contiguous()
    out = moved.new_empty((n * moved.shape[0],) + tuple(moved.shape[1:]))
    dist.all_gather_into_tensor(out, moved, group=group)
    _log("all_gather", moved.numel() * moved.element_size(), t0)
    return out.movedim(0, dim).contiguous() if dim else out


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum of ``x`` over the group, this rank's block of it along
    ``dim`` (the blocks in rank order; contiguous)."""
    t0 = time.perf_counter()
    n = dist.get_world_size(group)
    moved = x.movedim(dim, 0).contiguous()
    if moved.shape[0] % n:
        raise ValueError(f"reduce_scatter: {moved.shape[0]} rows over {n} ranks")
    out = moved.new_empty((moved.shape[0] // n,) + tuple(moved.shape[1:]))
    dist.reduce_scatter_tensor(out, moved, op=dist.ReduceOp.SUM, group=group)
    _log("reduce_scatter", moved.numel() * moved.element_size(), t0)
    return out.movedim(0, dim).contiguous() if dim else out


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group, in place; returns ``x``."""
    t0 = time.perf_counter()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    _log("all_reduce", x.numel() * x.element_size(), t0)
    return x


def send_to_first(x: torch.Tensor, owner: int) -> Optional[torch.Tensor]:
    """Rank ``owner``'s ``x`` on rank 0 of the default group, on the CPU
    (point to point; ``owner`` 0 keeps its own); None on the other ranks.
    Every rank calls it with the same ``owner``."""
    rank = dist.get_rank()
    if rank not in (0, owner):
        return None
    t0 = time.perf_counter()
    buf = x.detach().contiguous().cpu()
    if owner != 0:
        if rank == owner:
            dist.send(buf, dst=0)
            _log("send", buf.numel() * buf.element_size(), t0)
            return None
        dist.recv(buf, src=owner)
    return buf


class AllToAll(torch.autograd.Function):
    """``all_to_all`` whose backward is the reverse all-to-all: each
    received row's gradient goes back to the rank and place it came from."""

    @staticmethod
    def forward(ctx, x, send_counts, recv_counts, group):
        ctx.counts, ctx.group = (send_counts, recv_counts), group
        return all_to_all(x, send_counts, recv_counts, group)

    @staticmethod
    def backward(ctx, grad):
        send_counts, recv_counts = ctx.counts
        return all_to_all(grad, recv_counts, send_counts, ctx.group), None, None, None


class SplitRows(torch.autograd.Function):
    """This rank's block of rows of a tensor every rank of the group holds
    whole. The backward gathers the blocks' gradients, so each rank gets the
    whole gradient: the computation after the split runs on a block, the
    one before it on every rank alike."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n, r = dist.get_world_size(group), dist.get_rank(group)
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not split over {n} ranks")
        size = x.shape[0] // n
        return x[r * size:(r + 1) * size].clone()

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.group), None


class GatherRows(torch.autograd.Function):
    """Every rank's block of rows, concatenated in rank order. The backward
    takes this rank's block of the gradient, which every rank holds whole:
    summing it over the group would count it once per rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        size = grad.shape[0] // n
        return grad[r * size:(r + 1) * size].contiguous(), None
