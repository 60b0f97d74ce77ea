"""The training loop: recipe -> mesh -> data -> steps -> checkpoints
(counterpart of aria_tpu/train/loop.py).

Full fine-tuning or LoRA as the recipe says, gradient accumulation by the
optimizer's ``MultiSteps`` (the whole loss, aux terms included, is
averaged), checkpoints at the end of each epoch (and every
``save_every_steps``) with resume, and JSONL metrics.

The recipe's ``mesh_data``, ``mesh_fsdp`` and ``mesh_expert`` lay a mesh
over the ranks of the process group (``parallel/mesh.py``): each rank
builds its shard of the parameters (``init_aria_params(mesh=)``; an
imported or loaded tree is cut by ``aria_param_specs``), collates its rows
of each global batch (``local_batch_rows``: the batch is the recipe's
``per_device_train_batch_size`` rows, as the JAX loop builds it, split over
data x fsdp) and runs ``train_step(mesh=)``. Rank 0 alone writes the
metrics and the checkpoints; a checkpoint is gathered whole, in the one-
device format, so one rank resumes what a mesh saved and a mesh resumes
(each rank cutting its shard) what one rank saved. ``mesh_model`` and
``mesh_context`` must be 1 (ROADMAP queue 1 item 11). The ranks are the
caller's: ``cli/train.py`` spawns them, or ``train_on_ranks``. With
``use_peft``,
``quantize_base`` (QLoRA) quantizes the built base to the int8 tree of
``quantize_params`` before the adapters are made, one decoder layer at a
time (``quantize_params_by_layer``), as loop.py:131-140 does; the adapters
then train over it through the blocked dequantize.
"""

from __future__ import annotations

import dataclasses
import os
import random
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from aria_tpu_torch.checkpoint.io import (
    import_hf_checkpoint,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
from aria_tpu_torch.config import AriaConfig
from aria_tpu_torch.data.collate import collate_fn
from aria_tpu_torch.data.datasets import iter_batches, mix_datasets
from aria_tpu_torch.data.tokenizer import ByteTokenizer, load_tokenizer
from aria_tpu_torch.data.vision_processor import AriaVisionProcessor
from aria_tpu_torch.models.aria import init_aria_params
from aria_tpu_torch.ops import backend
from aria_tpu_torch.ops.quant import quantize_params_by_layer
from aria_tpu_torch.parallel.distributed import (
    default_backend,
    local_batch_rows,
    rank_device,
    run_ranks,
    share_card,
)
from aria_tpu_torch.parallel.fsdp import specs_by_path
from aria_tpu_torch.parallel.mesh import MeshConfig, P, make_mesh, shard_leaf
from aria_tpu_torch.train.lora import LoraConfig, init_lora_params
from aria_tpu_torch.train.recipe import Recipe
from aria_tpu_torch.train.step import (
    TrainConfig,
    TrainState,
    lora_train_step,
    make_lora_optimizer,
    make_optimizer,
    train_step,
)
from aria_tpu_torch.utils.metrics import MetricsLogger, StepTimer

UNPORTED_MESH_FIELDS = ("mesh_model", "mesh_context")  # ROADMAP queue 1 item 11


def recipe_mesh(r: Recipe) -> Optional[MeshConfig]:
    """The recipe's mesh (None for one rank); ``mesh_model`` or
    ``mesh_context`` above 1 raises."""
    bad = [f for f in UNPORTED_MESH_FIELDS if getattr(r, f) != 1]
    if bad:
        raise NotImplementedError(
            f"{', '.join(bad)} != 1: weight tensor parallelism and context parallelism in "
            "training are ROADMAP queue 1 item 11")
    mc = MeshConfig(data=r.mesh_data, fsdp=r.mesh_fsdp, expert=r.mesh_expert)
    return None if mc.num_devices == 1 else mc


def _pad_batch(batch: dict, seq_len: int, pad_id: int) -> dict:
    """Pad the token arrays to the recipe's length (loop.py:50-61)."""
    ids = batch["input_ids"]
    B, S = ids.shape
    if S < seq_len:
        pad = seq_len - S
        batch = dict(batch)
        batch["input_ids"] = np.pad(ids, ((0, 0), (0, pad)), constant_values=pad_id)
        batch["labels"] = np.pad(batch["labels"], ((0, 0), (0, pad)), constant_values=-100)
        batch["attention_mask"] = np.pad(batch["attention_mask"], ((0, 0), (0, pad)))
    return batch


def _to_train_config(r: Recipe, total_steps: int) -> TrainConfig:
    return TrainConfig(
        learning_rate=r.learning_rate,
        weight_decay=r.weight_decay,
        grad_clip_norm=r.grad_clip_norm,
        b1=r.adam_beta1,
        b2=r.adam_beta2,
        warmup_steps=int(r.warmup_ratio * total_steps),
        total_steps=max(total_steps, 2),
        freeze_vit=r.freeze_vit,
        freeze_projector=r.freeze_projector,
        freeze_llm=r.freeze_llm,
        freeze_llm_layers=tuple(r.freeze_llm_layers or ()),
        grad_accum_steps=r.gradient_accumulation_steps,
        gradient_checkpointing=r.gradient_checkpointing,
    )


def build_tokenizer(r: Recipe):
    if r.tokenizer_path:
        return load_tokenizer(r.tokenizer_path)
    return ByteTokenizer()


def build_params(r: Recipe, cfg: AriaConfig, dtype, device, mesh=None):
    """The training tree from the recipe's ``model_path`` or its seed; on a
    mesh, this rank's shard of it, read on the CPU (a checkpoint mapped, an
    HF import a layer at a time) and cut there before it reaches
    ``device``: no rank holds leaves it does not own."""
    if r.model_path and os.path.isdir(r.model_path):
        if any(f.endswith(".safetensors") for f in os.listdir(r.model_path)):
            return import_hf_checkpoint(r.model_path, cfg, dtype, device=device, mesh=mesh)
        step = latest_step(r.model_path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint found at {r.model_path}")
        if mesh is None:
            return load_checkpoint(r.model_path, step, device)[0]
        whole = load_checkpoint(r.model_path, step, "cpu", mmap=True)[0]
        return _shard_to(whole, mesh, specs_by_path(whole), device)
    gen = torch.Generator(device=device).manual_seed(r.seed)
    return init_aria_params(cfg, gen, device=device, dtype=dtype, mesh=mesh)


def _device_batch(batch: dict, device) -> dict:
    out = {"input_ids": torch.as_tensor(batch["input_ids"], device=device).long(),
           "labels": torch.as_tensor(batch["labels"], device=device).long()}
    if "pixel_values" in batch:
        out["pixel_values"] = torch.as_tensor(batch["pixel_values"], device=device)
        out["pixel_mask"] = torch.as_tensor(batch["pixel_mask"], device=device)
    return out


def _state_tree(state: TrainState) -> dict:
    return {"params": state.params, "opt_state": state.opt_state, "step": state.step}


def _opt_paths(opt_state: dict) -> dict:
    """The optimizer state's trees keyed by parameter path."""
    return {k: v for k, v in opt_state.items() if isinstance(v, dict)}


def _whole_state(state: TrainState, mesh, specs: dict) -> Optional[dict]:
    """The state in the one-device format, put together whole on rank 0
    leaf by leaf (``fsdp.whole_on_first``; every rank takes part): rank 0
    gets it with its tensors on the CPU, the others None."""
    from aria_tpu_torch.parallel.fsdp import whole_on_first

    def whole(t, path):
        if not isinstance(t, torch.Tensor):
            return t
        return whole_on_first(t, specs.get(path, P()), mesh)

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in tree.items()}
        return whole(tree, prefix[:-1])

    params = walk(state.params)
    opt = {k: v for k, v in state.opt_state.items() if not isinstance(v, dict)}
    for k, tree in _opt_paths(state.opt_state).items():
        opt[k] = {path: whole(t, path) for path, t in tree.items()}
    if mesh.rank != 0:
        return None
    return {"params": params, "opt_state": opt, "step": state.step}


def _shard_to(tree, mesh, specs: dict, device, prefix: str = ""):
    """This rank's shards of a whole tree (``specs``: path -> spec) on
    ``device``, each cut before it is moved."""
    if isinstance(tree, dict):
        return {k: _shard_to(v, mesh, specs, device, f"{prefix}{k}/") for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    return shard_leaf(tree, specs.get(prefix[:-1], P()), mesh).to(device)


def _shard_state(restored: dict, mesh, specs: dict, device) -> TrainState:
    """A one-device checkpoint's state cut to this rank's shards on
    ``device``."""
    opt = dict(restored["opt_state"])
    for k, tree in _opt_paths(opt).items():
        opt[k] = {path: _shard_to(t, mesh, specs, device, f"{path}/")
                  for path, t in tree.items()}
    return TrainState(_shard_to(restored["params"], mesh, specs, device), opt, restored["step"])


def train_on_ranks(r: Recipe, cfg: Optional[AriaConfig] = None,
                   max_steps: Optional[int] = None, *, device="cuda",
                   timeout_s: float = 3600.0) -> list:
    """``train`` on the ranks the recipe's mesh needs, spawned on this host
    (``run_ranks``): over nccl when each rank has a card of its own, else
    over gloo (CPU ranks, or ranks sharing the card). Returns each rank's
    summary (``_rank_summary``)."""
    mc = recipe_mesh(r)
    world = 1 if mc is None else mc.num_devices
    backend_name = default_backend(world, str(device))
    return run_ranks(_train_rank, world, r, cfg, max_steps, str(device), backend_name,
                     backend=backend_name, timeout_s=timeout_s)


def _rank_summary(state: TrainState, device) -> dict:
    """What a spawned rank hands back: its resident parameter and optimizer
    bytes and, on the card, its peak device memory."""
    from aria_tpu_torch.train.step import leaves

    nbytes = lambda tree: sum(t.numel() * t.element_size() for _, t in leaves(tree)  # noqa: E731
                              if isinstance(t, torch.Tensor))
    opt = sum(nbytes(v) for v in _opt_paths(state.opt_state).values())
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    return {"param_bytes": nbytes(state.params), "opt_bytes": opt, "peak_bytes": peak,
            "step": state.step}


def _train_rank(rank: int, r: Recipe, cfg, max_steps, device: str, backend_name: str) -> dict:
    dev = rank_device(device, rank, backend_name)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend_name == "gloo" and dist.get_world_size() > 1:  # the ranks share the card
            share_card(dev)
    else:
        torch.set_num_threads(1)
    return _rank_summary(train(r, cfg, max_steps, device=dev), dev)


def train(r: Recipe, cfg: Optional[AriaConfig] = None, max_steps: Optional[int] = None, *,
          device="cuda") -> TrainState:
    """Run the recipe (loop.py:102-231) on the card unless ``device`` names
    another; returns the final state (on a mesh, this rank's shards). A
    recipe whose mesh needs several ranks must run on each rank of a process
    group of that size (``train_on_ranks``)."""
    mc = recipe_mesh(r)
    mesh = None
    if mc is not None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != mc.num_devices:
            raise RuntimeError(
                f"the recipe's mesh {mc.shape} needs {mc.num_devices} ranks and this process "
                f"group has {world}: run it with train_on_ranks or cli/train.py")
        mesh = make_mesh(mc)
    device = backend.device(device)
    cfg = cfg or AriaConfig.aria_25b()
    cfg = cfg.replace(text=dataclasses.replace(
        cfg.text, moe_z_loss_coeff=r.moe_z_loss_coeff, moe_aux_loss_coeff=r.moe_aux_loss_coeff))
    dtype = torch.bfloat16 if r.dtype == "bfloat16" else torch.float32

    tokenizer = build_tokenizer(r)
    image_processor = AriaVisionProcessor(max_image_size=r.max_image_size)
    data = mix_datasets(r.dataset_mixer, seed=r.seed) if r.dataset_mixer else {"train": []}
    rows = data["train"]
    if not rows:
        raise ValueError("empty training set: check dataset_mixer paths")
    steps_per_epoch = max(len(rows) // r.per_device_train_batch_size, 1)
    total_steps = steps_per_epoch * r.num_train_epochs
    if max_steps:
        total_steps = min(total_steps, max_steps)
    accum = max(r.gradient_accumulation_steps, 1)
    tc = _to_train_config(r, total_steps // accum)

    if mesh is not None and r.use_peft and r.quantize_base:
        raise NotImplementedError("QLoRA over a mesh: the layer-at-a-time quantization of the "
                                  "base is not ported for sharded trees")
    params = build_params(r, cfg, dtype, device, mesh)
    if r.use_peft and r.quantize_base:
        # QLoRA: the frozen base in int8, the adapters trained over it
        params = quantize_params_by_layer(params)
    main = mesh is None or mesh.rank == 0
    logger = MetricsLogger(r.output_dir, enabled=r.report_to != "none" and main)
    timer = StepTimer()
    tokens_per_batch = r.per_device_train_batch_size * r.max_seq_length

    if r.use_peft:
        lc = LoraConfig(rank=r.lora_r, alpha=r.lora_alpha, dropout=r.lora_dropout,
                        freeze_llm=r.freeze_llm)
        gen = torch.Generator(device=device).manual_seed(r.seed + 1)
        lora = init_lora_params(cfg, lc, gen, device=device)
        optimizer = make_lora_optimizer(tc, accum, mesh, lora, params)
        state = TrainState(lora, optimizer.init(lora), 0)

        def step_fn(state, batch):
            return lora_train_step(state, batch, params, cfg, lc.scale, optimizer,
                                   tc.gradient_checkpointing, mesh=mesh)
    else:
        optimizer = make_optimizer(tc, params, accum, mesh)
        state = TrainState(params, optimizer.init(params), 0)

        def step_fn(state, batch):
            return train_step(state, batch, cfg, tc, optimizer, mesh=mesh)

    def save(step: int) -> None:
        tree = _state_tree(state) if mesh is None else _whole_state(state, mesh, optimizer.specs)
        if main:
            save_checkpoint(ckpt_dir, tree, cfg, step=step)
        if mesh is not None:
            dist.barrier()  # the others wait until rank 0 has written it

    start_step = 0
    ckpt_dir = os.path.join(r.output_dir, "checkpoints")
    if r.resume_from_checkpoint:
        last = latest_step(ckpt_dir)
        if last is not None:
            if mesh is None:
                restored, _ = load_checkpoint(ckpt_dir, last, device)
                state = TrainState(restored["params"], restored["opt_state"], restored["step"])
            else:
                restored, _ = load_checkpoint(ckpt_dir, last, "cpu", mmap=True)
                state = _shard_state(restored, mesh, optimizer.specs, device)
                del restored
            start_step = last
            if main:
                print(f"resumed from step {last}")

    step = start_step
    done = False
    for epoch in range(r.num_train_epochs):
        if done:
            break
        epoch_rows = list(rows)
        random.Random(r.seed + epoch).shuffle(epoch_rows)  # per-epoch reshuffle
        for bi, batch_rows in enumerate(iter_batches(epoch_rows, r.per_device_train_batch_size)):
            if epoch * steps_per_epoch + bi < start_step:
                continue  # resume: skip batches already consumed
            if step >= total_steps:
                done = True
                break
            if mesh is not None:  # this rank's rows of the global batch
                batch_rows = local_batch_rows(batch_rows, r.per_device_train_batch_size,
                                              mesh.batch_size, mesh.batch_index)
            batch = collate_fn(batch_rows, tokenizer, image_processor,
                               max_length=r.max_seq_length, max_image_size=r.max_image_size,
                               split_image=r.split_image)
            batch = _pad_batch(batch, r.max_seq_length, tokenizer.pad_token_id)
            state, metrics = step_fn(state, _device_batch(batch, device))
            step += 1
            if step % r.logging_steps == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                metrics.update(timer.lap(tokens_per_batch))
                logger.log(step, metrics)
            if r.save_every_steps and step % r.save_every_steps == 0:
                save(step)
        save(step)
    logger.close()
    return state
