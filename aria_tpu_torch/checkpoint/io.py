"""Trainer checkpoints (the port's counterpart of save_checkpoint,
load_checkpoint and latest_step in aria_tpu/checkpoint/io.py).

The JAX package writes orbax step directories; the port writes its own
format: ``{path}/step_{N}/state.pt`` (``torch.save`` of the tree: nested
dicts of tensors and ints) and ``{path}/config.json`` (the model config,
as ``dataclasses.asdict``). The HF safetensors import is not ported
(ROADMAP queue 1 item 9).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import torch

from aria_tpu_torch.config import AriaConfig, config_from_dict
from aria_tpu_torch.ops import backend


def save_checkpoint(path: str, tree: Any, cfg: Optional[AriaConfig] = None, step: int = 0
                    ) -> None:
    step_dir = os.path.join(os.path.abspath(path), f"step_{step}")
    os.makedirs(step_dir, exist_ok=True)
    tmp = os.path.join(step_dir, "state.pt.tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(step_dir, "state.pt"))
    if cfg is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2)


def load_checkpoint(path: str, step: int = 0, device="cuda"
                    ) -> tuple[Any, Optional[AriaConfig]]:
    """(tree, config or None), the tensors on ``device``: the card unless
    the caller names another (``backend.device``: no card raises)."""
    tree = torch.load(os.path.join(os.path.abspath(path), f"step_{step}", "state.pt"),
                      map_location=backend.device(device), weights_only=True)
    cfg = None
    cfg_file = os.path.join(path, "config.json")
    if os.path.exists(cfg_file):
        with open(cfg_file) as f:
            cfg = config_from_dict(json.load(f))
    return tree, cfg


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(path)
             if d.startswith("step_") and d.split("_", 1)[1].isdigit()
             and os.path.exists(os.path.join(path, d, "state.pt"))]
    return max(steps) if steps else None
