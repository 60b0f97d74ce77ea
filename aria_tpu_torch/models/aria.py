"""Token embeddings for the composite model (counterpart of the text-only
part of aria_tpu/models/aria.py:76-98). The vision tower and projector are
not ported yet, so image inputs raise."""

from __future__ import annotations

from typing import Optional

import torch

from aria_tpu.config import AriaConfig
from aria_tpu_torch.models.moe_lm import embed_tokens


def prepare_embeddings(
    params: dict,
    cfg: AriaConfig,
    tokens: torch.Tensor,  # [B, S]
    pixel_values: Optional[torch.Tensor] = None,
    pixel_mask: Optional[torch.Tensor] = None,
    image_features: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Token embeddings of a text-only prompt (bf16 from an int8 table, as
    aria.py:93 gives them)."""
    if pixel_values is not None or pixel_mask is not None or image_features is not None:
        raise NotImplementedError(
            "image inputs need the vision tower, projector and vit_flash kernel, "
            "which are not ported yet")
    return embed_tokens(params["lm"]["embed"], tokens)
