"""LoRA adapters, per-expert (grouped) LoRA for the MoE weights included
(counterpart of aria_tpu/train/lora.py).

Adapters are a tree of their own that mirrors the stacked layers:

    lora["lm"]["layers"]["wqkv"] = {"a": [L, D, r], "b": [L, r, out]}
    lora["lm"]["layers"]["w1"]   = {"a": [L, E, D, r], "b": [L, E, r, 2I]}

The expert deltas apply inside the expert GLU (fc1 before it, fc2 after
it), as the reference's grouped-GEMM LoRA layer does; ``merge_lora`` folds
the adapters into the base weights for serving.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from aria_tpu_torch.config import AriaConfig
from aria_tpu_torch.ops import backend

# the decoder's weights that take adapters
_LM_TARGETS = ("wqkv", "wo", "w1", "w2", "shared_w1", "shared_w2")


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    dropout: float = 0.0  # reserved; the recipes' dropout is not applied
    target_modules: tuple[str, ...] = _LM_TARGETS
    freeze_vit: bool = True
    freeze_projector: bool = True
    freeze_llm: bool = False

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def get_lora_target_modules(cfg: LoraConfig) -> tuple[str, ...]:
    """The modules to adapt: none with a frozen decoder (lora.py:49-59)."""
    if cfg.freeze_llm:
        return ()
    return tuple(m for m in cfg.target_modules if m in _LM_TARGETS)


def init_lora_params(cfg: AriaConfig, lc: LoraConfig, generator: torch.Generator, *,
                     device="cuda", dtype=torch.float32) -> Dict[str, Any]:
    """A ~ N(0, 1/fan_in), B zero, so every delta starts at 0 (lora.py:62-95),
    on the card unless ``device`` names another."""
    device = backend.device(device)
    tc = cfg.text
    L, D, E = tc.num_layers, tc.hidden_size, tc.num_experts
    I, Is, r = tc.moe_intermediate_size, tc.shared_intermediate_size, lc.rank
    qkv_out = (tc.num_heads + 2 * tc.num_kv_heads) * tc.head_dim
    shapes = {
        "wqkv": ((L, D, r), (L, r, qkv_out)),
        "wo": ((L, tc.q_size, r), (L, r, D)),
        "w1": ((L, E, D, r), (L, E, r, 2 * I)),
        "w2": ((L, E, I, r), (L, E, r, D)),
        "shared_w1": ((L, D, r), (L, r, 2 * Is)),
        "shared_w2": ((L, Is, r), (L, r, D)),
    }
    out: Dict[str, Any] = {}
    for name in get_lora_target_modules(lc):
        a_shape, b_shape = shapes[name]
        a = torch.randn(a_shape, generator=generator, device=device, dtype=torch.float32)
        out[name] = {"a": (a * a_shape[-2] ** -0.5).to(dtype),
                     "b": torch.zeros(b_shape, dtype=dtype, device=device)}
    return {"lm": {"layers": out}}


def merge_lora(params: Dict[str, Any], lora: Dict[str, Any], lc: LoraConfig) -> Dict[str, Any]:
    """Fold the adapters into the base weights (lora.py:106-127): wqkv, wo
    and the shared MLP [L, in, out] take a @ b; w1, out-major [L, E, 2I,
    D], takes it transposed; w2 [L, E, I, D] takes it as it is. The sum
    is in f32, rounded once to the base dtype."""
    layers = dict(params["lm"]["layers"])
    for name, ab in lora["lm"]["layers"].items():
        a, b = ab["a"].float(), ab["b"].float()
        if name == "w1":
            delta = torch.einsum("ledr,lerf->lefd", a, b)
        elif name == "w2":
            delta = torch.einsum("ledr,lerf->ledf", a, b)
        else:
            delta = torch.einsum("ldr,lrf->ldf", a, b)
        base = layers[name]
        layers[name] = (base.float() + lc.scale * delta).to(base.dtype)
    return {**params, "lm": {**params["lm"], "layers": layers}}
