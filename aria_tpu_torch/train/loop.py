"""The training loop: recipe -> data -> steps -> checkpoints (counterpart
of aria_tpu/train/loop.py, on one device).

Full fine-tuning or LoRA as the recipe says, gradient accumulation by the
optimizer's ``MultiSteps`` (the whole loss, aux terms included, is
averaged), checkpoints at the end of each epoch (and every
``save_every_steps``) with resume, and JSONL metrics. The recipe's mesh
fields must be 1: meshes are ROADMAP queue 1 item 11. With ``use_peft``,
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

MESH_FIELDS = ("mesh_data", "mesh_fsdp", "mesh_expert", "mesh_model", "mesh_context")


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


def build_params(r: Recipe, cfg: AriaConfig, dtype, device):
    if r.model_path and os.path.isdir(r.model_path):
        if any(f.endswith(".safetensors") for f in os.listdir(r.model_path)):
            return import_hf_checkpoint(r.model_path, cfg, dtype, device=device)
        step = latest_step(r.model_path)
        if step is not None:
            return load_checkpoint(r.model_path, step, device)[0]
        raise FileNotFoundError(f"no checkpoint found at {r.model_path}")
    gen = torch.Generator(device=device).manual_seed(r.seed)
    return init_aria_params(cfg, gen, device=device, dtype=dtype)


def _device_batch(batch: dict, device) -> dict:
    out = {"input_ids": torch.as_tensor(batch["input_ids"], device=device).long(),
           "labels": torch.as_tensor(batch["labels"], device=device).long()}
    if "pixel_values" in batch:
        out["pixel_values"] = torch.as_tensor(batch["pixel_values"], device=device)
        out["pixel_mask"] = torch.as_tensor(batch["pixel_mask"], device=device)
    return out


def _state_tree(state: TrainState) -> dict:
    return {"params": state.params, "opt_state": state.opt_state, "step": state.step}


def train(r: Recipe, cfg: Optional[AriaConfig] = None, max_steps: Optional[int] = None, *,
          device="cuda") -> TrainState:
    """Run the recipe (loop.py:102-231) on the card unless ``device`` names
    another; returns the final state."""
    bad = [f for f in MESH_FIELDS if getattr(r, f) != 1]
    if bad:
        raise NotImplementedError(f"{', '.join(bad)} != 1: meshes are ROADMAP queue 1 item 11")
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

    params = build_params(r, cfg, dtype, device)
    if r.use_peft and r.quantize_base:
        # QLoRA: the frozen base in int8, the adapters trained over it
        params = quantize_params_by_layer(params)
    logger = MetricsLogger(r.output_dir, enabled=r.report_to != "none")
    timer = StepTimer()
    tokens_per_batch = r.per_device_train_batch_size * r.max_seq_length

    if r.use_peft:
        lc = LoraConfig(rank=r.lora_r, alpha=r.lora_alpha, dropout=r.lora_dropout,
                        freeze_llm=r.freeze_llm)
        gen = torch.Generator(device=device).manual_seed(r.seed + 1)
        lora = init_lora_params(cfg, lc, gen, device=device)
        optimizer = make_lora_optimizer(tc, accum)
        state = TrainState(lora, optimizer.init(lora), 0)

        def step_fn(state, batch):
            return lora_train_step(state, batch, params, cfg, lc.scale, optimizer,
                                   tc.gradient_checkpointing)
    else:
        optimizer = make_optimizer(tc, params, accum)
        state = TrainState(params, optimizer.init(params), 0)

        def step_fn(state, batch):
            return train_step(state, batch, cfg, tc, optimizer)

    start_step = 0
    ckpt_dir = os.path.join(r.output_dir, "checkpoints")
    if r.resume_from_checkpoint:
        last = latest_step(ckpt_dir)
        if last is not None:
            restored, _ = load_checkpoint(ckpt_dir, last, device)
            state = TrainState(restored["params"], restored["opt_state"], restored["step"])
            start_step = last
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
                save_checkpoint(ckpt_dir, _state_tree(state), cfg, step=step)
        save_checkpoint(ckpt_dir, _state_tree(state), cfg, step=step)
    logger.close()
    return state
