"""The training recipe: one flat dataclass loaded from YAML, any key
overridable on the command line as ``--key value`` (the port's own copy of
aria_tpu/train/recipe.py, held to it field for field by
tests/test_torch_data.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import yaml


@dataclass
class Recipe:
    # model / checkpoint
    model_path: Optional[str] = None  # HF safetensors dir or native ckpt dir
    tokenizer_path: Optional[str] = None
    output_dir: str = "out/run"
    resume_from_checkpoint: bool = False

    # dataset
    dataset_mixer: Dict[str, float] = field(default_factory=dict)
    max_seq_length: int = 2048
    max_image_size: int = 980
    split_image: bool = False

    # optimization
    per_device_train_batch_size: int = 8
    gradient_accumulation_steps: int = 1
    num_train_epochs: int = 1
    learning_rate: float = 5e-6
    weight_decay: float = 0.1
    adam_beta1: float = 0.9
    adam_beta2: float = 0.95
    warmup_ratio: float = 0.01
    grad_clip_norm: float = 1.0
    seed: int = 42
    gradient_checkpointing: bool = True
    dtype: str = "bfloat16"

    # moe
    moe_z_loss_coeff: float = 1e-5
    moe_aux_loss_coeff: float = 1e-3

    # freezing
    freeze_vit: bool = True
    freeze_projector: bool = True
    freeze_llm: bool = False
    freeze_llm_layers: Tuple[int, ...] = ()

    # lora
    use_peft: bool = False
    lora_r: int = 8
    lora_alpha: float = 32.0
    lora_dropout: float = 0.05
    quantize_base: bool = False  # QLoRA-style: int8-quantize the frozen base

    # mesh (replaces recipes/accelerate_configs/*.yaml)
    mesh_data: int = 1
    mesh_fsdp: int = 1
    mesh_expert: int = 1
    mesh_model: int = 1
    mesh_context: int = 1

    # logging / saving
    logging_steps: int = 1
    save_every_steps: int = 0  # 0 = epoch-end only
    report_to: str = "jsonl"  # jsonl | none


def load_recipe(path: Optional[str] = None, overrides: Optional[Dict[str, str]] = None) -> Recipe:
    data: Dict = {}
    if path:
        with open(path) as f:
            data = yaml.safe_load(f) or {}
    fields = {f.name: f for f in dataclasses.fields(Recipe)}
    defaults = Recipe()
    kwargs = {}
    unknown = []
    for k, v in data.items():
        if k in fields:
            # PyYAML parses "5e-5" (no dot) as a string; coerce to field types.
            cur = getattr(defaults, k)
            if isinstance(v, str) and isinstance(cur, (int, float, bool)) and not isinstance(cur, bool):
                v = type(cur)(float(v)) if isinstance(cur, int) else float(v)
            kwargs[k] = v
        else:
            unknown.append(k)
    if overrides:
        for k, v in overrides.items():
            if k not in fields:
                raise KeyError(f"unknown recipe key --{k}")
            typ = fields[k].type
            kwargs[k] = _coerce(v, kwargs.get(k, getattr(Recipe, k, None)))
    if unknown:
        import warnings

        warnings.warn(f"ignoring unknown recipe keys: {unknown}")
    if "freeze_llm_layers" in kwargs and kwargs["freeze_llm_layers"] is not None:
        kwargs["freeze_llm_layers"] = tuple(kwargs["freeze_llm_layers"])
    return Recipe(**kwargs)


def _coerce(value: str, current):
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, (dict, list, tuple)):
        import json

        return json.loads(value)  # e.g. --dataset_mixer '{"path": 1.0}'
    return value
