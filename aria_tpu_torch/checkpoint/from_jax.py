"""Weight interchange: the JAX package's param tree, given as numpy
leaves, into the port's tensors, leaf for leaf.

Every leaf keeps its dtype and its bytes: int8 ``{"q", "s"}`` /
``{"q", "s8"}`` (aria_tpu/ops/quant.py:33-65), int4 experts
``{"q4", "sg"}`` / ``{"q4", "s8"}`` (quant.py:263-300) and dense int4
``{"q4t", "sg"}`` (dense_int4.py:33-50) come across byte for byte, as do
the training tree (``init_aria_params``: float weights, the shared experts
unfused; its ViT too, trained with ``freeze_vit=False``), the QLoRA base
of ``quantize_params`` and a LoRA tree (``init_lora_params``). bf16
leaves (numpy's ``bfloat16`` extension dtype) are carried as their 16-bit
patterns. Nothing here imports jax: convert a JAX tree first with
``jax.tree.map(numpy.asarray, tree)``. The tensors land on the card
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from aria_tpu_torch.ops import backend


def to_tensor(a: np.ndarray, device="cuda") -> torch.Tensor:
    """One numpy leaf as a tensor with the same dtype and bytes."""
    device = backend.device(device)
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def from_jax(tree: Any, device="cuda") -> Any:
    """Map a nested dict of numpy arrays to tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return to_tensor(tree, device)
    raise TypeError(f"from_jax: unsupported leaf {type(tree).__name__}")

