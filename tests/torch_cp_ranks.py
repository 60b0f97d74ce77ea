"""Rank bodies for tests/test_torch_cp_cache.py.

Each function runs in a process that ``run_ranks`` spawns, joined to its
siblings over gloo on the CPU. This module imports nothing of JAX, so the
children start with torch alone; the JAX references are computed once in
the test process and only their inputs come here. ``run`` builds the mesh
once and runs a list of jobs on it, each returning plain data (numpy
arrays, lists).
"""

from __future__ import annotations

import numpy as np
import torch

from aria_tpu_torch.parallel import cp_cache
from aria_tpu_torch.parallel.mesh import MeshConfig, make_mesh


def _cache(cls, arrays: dict, mesh):
    """This rank's block of a global cache given as numpy arrays {k, v,
    k_scale, v_scale} [L, B, H(/2), S(, D)]: heads over model (unless
    packed), positions over context."""
    k = torch.from_numpy(arrays["k"])
    scales = arrays.get("k_scale")
    packed4 = scales is not None and scales.shape[2] == 2 * k.shape[2]

    def local(a, bf16=False):
        t = torch.from_numpy(a)
        if bf16:
            t = t.to(torch.bfloat16)
        h0, hn = (0, t.shape[2]) if packed4 else mesh.block("model", t.shape[2])
        s0, sn = mesh.block("context", t.shape[3])
        return t[:, :, h0:h0 + hn, s0:s0 + sn].contiguous()

    if scales is None:
        return cls(local(arrays["k"]), local(arrays["v"]))
    return cls(local(arrays["k"]), local(arrays["v"]), local(arrays["k_scale"], packed4),
               local(arrays["v_scale"], packed4))


class _Counter:
    """Counts the calls of cp_cache's decode attention, by form."""

    def __init__(self):
        self.real = cp_cache.decode_attention
        self.stats = self.normal = 0

    def __call__(self, *args, return_stats=False, **kwargs):
        if return_stats:
            self.stats += 1
        else:
            self.normal += 1
        return self.real(*args, return_stats=return_stats, **kwargs)

    def reset(self):
        self.stats = self.normal = 0


def run(rank: int, mesh_kw: dict, jobs: list) -> list:
    """The results of ``jobs`` ([(name of a function below, arguments)]) on
    the mesh of ``mesh_kw``, in order."""
    torch.set_num_threads(1)
    mesh = make_mesh(MeshConfig(**mesh_kw))
    return [globals()[name](mesh, *args) for name, args in jobs]


def ops(mesh, cases: dict) -> dict:
    """mesh_decode_attention and cp_cached_prefill_attention over each
    cache of ``cases`` ({name: (cache arrays, q_dec, lengths, q_pre,
    mask)}); returns {name: (decode out, prefill out)} as f32 numpy."""
    from aria_tpu_torch.models.moe_lm import KVCache

    out = {}
    for name, (arrays, q_dec, lengths, q_pre, mask) in cases.items():
        cache = _cache(KVCache, arrays, mesh)
        dec = cp_cache.mesh_decode_attention(torch.from_numpy(q_dec), cache, 1,
                                             torch.from_numpy(lengths), mesh)
        pre = cp_cache.cp_cached_prefill_attention(torch.from_numpy(q_pre), cache, 1,
                                                   torch.from_numpy(mask), mesh)
        out[name] = (dec.float().numpy(), pre.float().numpy())
    return out


def engines(mesh, runs: list) -> list:
    """Greedy streams of ``Engine(mesh=)`` for each run (params as CPU
    tensors, port config, cache dtype, prompt, new tokens, decode chunk),
    with the calls of each form of decode attention during it."""
    from aria_tpu_torch.engine.generate import Engine, GenerationConfig

    counter = _Counter()
    cp_cache.decode_attention = counter
    out = []
    try:
        for params, cfg, cache_dtype, prompt, n_new, chunk in runs:
            gen = GenerationConfig(max_new_tokens=n_new, temperature=0.0, top_k=None,
                                   decode_chunk=chunk)
            engine = Engine(params, cfg, max_seq_len=256, cache_dtype=cache_dtype, mesh=mesh)
            counter.reset()
            tokens = engine.generate(prompt, gen).tokens
            out.append((tokens, counter.stats, counter.normal))
    finally:
        cp_cache.decode_attention = counter.real
    return out


def batched(mesh, params, cfg, cache_dtype, prompts: list, n_new: int):
    """Greedy streams of ``BatchedEngine(mesh=)`` (2 lanes, decode chunk 3)
    and the shape of its cache on this rank."""
    from aria_tpu_torch.engine.server import BatchedEngine

    srv = BatchedEngine(params, cfg, max_lanes=2, max_seq_len=128, decode_chunk=3,
                        cache_dtype=cache_dtype, mesh=mesh)
    uids = [srv.submit(p, max_new_tokens=n_new) for p in prompts]
    fin = {r.uid: r for r in srv.run_until_complete()}
    return [fin[u].generated for u in uids], np.asarray(srv.cache.k.shape)
