"""Rank bodies for tests/test_torch_ep.py and tests/test_torch_mesh_train.py.

Each function runs in a process that ``run_ranks`` spawns, joined to its
siblings over gloo on the CPU. This module imports nothing of JAX, so the
children start with torch alone; the JAX references are computed in the
test process and only their inputs come here. ``run`` builds every mesh
of the job list once (all ranks together, in order) and runs the jobs on
them, each returning plain data (numpy arrays, lists, numbers).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from aria_tpu_torch.parallel import distributed as dd
from aria_tpu_torch.parallel.mesh import MeshConfig, make_mesh


def run(rank: int, meshes: dict, jobs: list) -> list:
    """The results of ``jobs`` ([(name of a function below, mesh name,
    arguments)]) in order, each mesh of ``meshes`` ({name: MeshConfig
    kwargs}) built once over this process group."""
    torch.set_num_threads(1)
    built = {name: make_mesh(MeshConfig(**kw)) for name, kw in meshes.items()}
    return [globals()[fn](built[mesh], *args) for fn, mesh, args in jobs]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _local(w, mesh, axis_dim: int):
    """This rank's experts of a whole stack given as numpy (a dict of
    leaves for the quantized forms), cut on ``axis_dim``."""
    if isinstance(w, dict):
        return {k: _local(v, mesh, axis_dim) for k, v in w.items()}
    from aria_tpu_torch.checkpoint.from_jax import to_tensor

    start, size = mesh.block("expert", w.shape[axis_dim])
    return to_tensor(np.take(w, np.arange(start, start + size), axis=axis_dim), "cpu")


# ------------------------------------------------------------ expert parallelism

def groups(mesh) -> dict:
    """The global ranks of each of this rank's groups, by name."""
    return {name: (None if g is None else dist.get_process_group_ranks(g))
            for name, g in mesh.groups.items()}


def experts_ep(mesh, x, gate, k, w1, w2, kw: dict, layer_idx=None) -> dict:
    """``experts_ep`` on whole numpy stacks (this rank keeps its experts):
    the output, the losses, and each collective's bytes."""
    from aria_tpu_torch.checkpoint.from_jax import to_tensor
    from aria_tpu_torch.parallel.ep import experts_ep as ep

    axis = 0 if layer_idx is None else 1
    dd.LOG = []
    try:
        out, z, aux = ep(to_tensor(x, "cpu"), torch.from_numpy(gate), k, _local(w1, mesh, axis),
                         _local(w2, mesh, axis), mesh, layer_idx=layer_idx, **kw)
        log = [(name, nbytes) for name, nbytes, _, _ in dd.LOG]
    finally:
        dd.LOG = None
    return {"out": _np(out), "z": float(z), "aux": float(aux), "log": log}


def engines(mesh, params, cfg, runs: list) -> list:
    """Greedy streams of ``Engine(mesh=)`` for each run (cache dtype,
    prompt, new tokens, decode chunk, the W4A8 decode MoE on or off), and
    the expert stack's experts on this rank. ``params`` as numpy leaves are
    converted a shard at a time (``from_jax(mesh=)``); as tensors, whole,
    for the engine to cut."""
    from aria_tpu_torch.checkpoint.from_jax import from_jax
    from aria_tpu_torch.engine.generate import Engine, GenerationConfig
    from aria_tpu_torch.models import moe_lm

    if isinstance(params["lm"]["final_norm"], np.ndarray):
        params = {"lm": from_jax(params["lm"], "cpu", mesh=mesh)}
    out = []
    for cache_dtype, prompt, n_new, chunk, a8 in runs:
        saved, moe_lm.MOE_A8 = moe_lm.MOE_A8, a8
        try:
            engine = Engine(params, cfg, max_seq_len=256, cache_dtype=cache_dtype, mesh=mesh)
            gen = GenerationConfig(max_new_tokens=n_new, temperature=0.0, top_k=None,
                                   decode_chunk=chunk)
            tokens = engine.generate(prompt, gen).tokens
        finally:
            moe_lm.MOE_A8 = saved
        w1 = engine.params["lm"]["layers"]["w1"]
        out.append((tokens, int((w1["q4"] if isinstance(w1, dict) else w1).shape[1])))
    return out


def batched(mesh, params, cfg, prompts: list, n_new: int):
    """Greedy streams of ``BatchedEngine(mesh=)`` (2 lanes, decode chunk
    3, an f32 cache)."""
    from aria_tpu_torch.engine.server import BatchedEngine

    srv = BatchedEngine(params, cfg, max_lanes=2, max_seq_len=128, decode_chunk=3,
                        cache_dtype=torch.float32, mesh=mesh)
    uids = [srv.submit(p, max_new_tokens=n_new) for p in prompts]
    fin = {r.uid: r for r in srv.run_until_complete()}
    return [fin[u].generated for u in uids]


def refusals(mesh, params, cfg) -> dict:
    """What an expert mesh refuses: a fused stack (the JAX engine would
    gather it), and expert LoRA; the messages."""
    from aria_tpu_torch.engine.generate import Engine
    from aria_tpu_torch.models.moe_lm import lm_forward

    out = {}
    try:
        Engine(params, cfg, max_seq_len=256, mesh=mesh)
    except ValueError as e:
        out["fused"] = str(e)
    return out | {"lm_forward": _raises(lambda: lm_forward(
        params["lm"], cfg.text, torch.zeros((1, 4), dtype=torch.long), mesh=mesh))}


def _raises(fn) -> str:
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return str(e)
    return ""


# ------------------------------------------------------------ training

def _step_setup(mesh, params, cfg, tokens, labels, tc_kw: dict, shard: bool = True):
    from aria_tpu_torch.parallel.mesh import aria_param_specs, shard_params
    from aria_tpu_torch.train.step import TrainConfig, TrainState, make_optimizer

    from aria_tpu_torch.checkpoint.from_jax import from_jax

    whole = from_jax(params, "cpu")
    sp = shard_params(whole, aria_param_specs(), mesh) if shard else whole
    tc = TrainConfig(**tc_kw)
    opt = make_optimizer(tc, sp, mesh=mesh)
    per = tokens.shape[0] // mesh.batch_size
    i = mesh.batch_index
    batch = {"input_ids": torch.from_numpy(tokens[i * per:(i + 1) * per]).long(),
             "labels": torch.from_numpy(labels[i * per:(i + 1) * per]).long()}
    return TrainState(sp, opt.init(sp), 0), batch, tc, opt


def train_step(mesh, params, cfg, tokens, labels, tc_kw: dict, steps: int = 1) -> dict:
    """``steps`` micro steps of ``train_step(mesh=)`` from the whole numpy
    tree (each rank cut to its shard): each step's metrics, the whole
    trainable leaves after them, this rank's resident bytes by leaf, and
    the first step's gradients (whole) with the witness of a sum over
    ``expert``."""
    from aria_tpu_torch.parallel import fsdp
    from aria_tpu_torch.train import step as tstep

    state, batch, tc, opt = _step_setup(mesh, params, cfg, tokens, labels, tc_kw)
    resident = {p: int(t.numel() * t.element_size()) for p, t in tstep.leaves(state.params)}
    named = opt.trainable(state.params)
    for _, t in named:
        t.requires_grad_(True)
    with torch.enable_grad():
        _, grads = tstep._step_grads(state.params, named, opt, lambda tree: tstep.loss_fn(
            tree, cfg, batch, tc.gradient_checkpointing, mesh=mesh))
    # the witness: each gradient further summed over expert, as a port that
    # forgot that the loss is replicated there would do
    wrong = {p: (dd.all_reduce(g.clone(), mesh.group("expert"))
                 if mesh.shape["expert"] > 1 else g) for p, g in grads.items()}
    grads_whole = {p: _np(t) for p, t in fsdp.gather_whole(grads, mesh, opt.specs).items()}
    wrong_whole = {p: _np(t) for p, t in fsdp.gather_whole(wrong, mesh, opt.specs).items()}
    metrics = []
    for _ in range(steps):
        state, m = tstep.train_step(state, batch, cfg, tc, opt, mesh=mesh)
        metrics.append({k: float(v) for k, v in m.items()})
    whole = fsdp.gather_whole(state.params, mesh, opt.specs)
    trained = {p: _np(t) for p, t in tstep.leaves(whole) if opt.mask[p]}
    return {"metrics": metrics, "params": trained, "resident": resident,
            "grads": grads_whole, "wrong": wrong_whole}


def lora_step(mesh, params, lora, cfg, tokens, labels, scale: float, tc_kw: dict) -> dict:
    """One ``lora_train_step(mesh=)`` over the sharded base: metrics and
    the adapters after it."""
    from aria_tpu_torch.checkpoint.from_jax import from_jax
    from aria_tpu_torch.parallel.mesh import aria_param_specs, shard_params
    from aria_tpu_torch.train import step as tstep

    base = shard_params(from_jax(params, "cpu"), aria_param_specs(), mesh)
    ad = from_jax(lora, "cpu")
    tc = tstep.TrainConfig(**tc_kw)
    opt = tstep.make_lora_optimizer(tc, 1, mesh, ad, base)
    state = tstep.TrainState(ad, opt.init(ad), 0)
    per = tokens.shape[0] // mesh.batch_size
    i = mesh.batch_index
    batch = {"input_ids": torch.from_numpy(tokens[i * per:(i + 1) * per]).long(),
             "labels": torch.from_numpy(labels[i * per:(i + 1) * per]).long()}
    state, m = tstep.lora_train_step(state, batch, base, cfg, scale, opt, mesh=mesh)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "lora": {p: _np(t) for p, t in tstep.leaves(state.params)}}
