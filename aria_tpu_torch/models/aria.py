"""The composite model's front: vision tower -> projector -> image features
scattered into the ``<|img|>`` token embeddings (counterpart of
aria_tpu/models/aria.py:33-98)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from aria_tpu_torch.config import AriaConfig
from aria_tpu_torch.models.moe_lm import embed_tokens
from aria_tpu_torch.models.projector import projector_forward
from aria_tpu_torch.models.vit import vit_forward

# 1/255 as the f32 constant of the jitted JAX normalize
_INV_255 = float(np.float32(1.0 / 255.0))


def normalize_pixels(pixel_values: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> (x/255 - 0.5)/0.5 in f32, as the jitted JAX encode
    computes it: XLA turns the division into a multiply by the f32
    reciprocal fused with the subtraction, fma(x, 1/255, -0.5) * 2. The
    f64 product of a byte and that constant is exact, so one rounding of
    ``x * c - 0.5`` to f32 is the fused result."""
    return ((pixel_values.double() * _INV_255) - 0.5).float() * 2.0


def encode_images(params: dict, cfg: AriaConfig, pixel_values: torch.Tensor,
                  pixel_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N, C, S, S] images -> [N, Q, D_lm] projected image features.

    uint8 pixels are normalized on the device; ``pixel_mask=None`` means
    every pixel is valid."""
    if pixel_values.dtype == torch.uint8:
        pixel_values = normalize_pixels(pixel_values)
    if pixel_mask is None:
        N, _, H, W = pixel_values.shape
        pixel_mask = torch.ones((N, H, W), dtype=torch.bool, device=pixel_values.device)
    vis = vit_forward(params["vision"], cfg.vision, pixel_values, pixel_mask)
    return projector_forward(params["projector"], cfg.projector, vis.features,
                             vis.kv_ignore_mask)


def scatter_image_features(embeds: torch.Tensor, tokens: torch.Tensor,
                           image_features: torch.Tensor, image_token_id: int) -> torch.Tensor:
    """masked_scatter semantics: the i-th image feature goes to the i-th
    image-token position, as a cumulative-count gather (aria.py:59-73)."""
    B, S, D = embeds.shape
    flat_feats = image_features.reshape(-1, D).to(embeds.dtype)
    is_img = tokens == image_token_id
    feat_idx = torch.cumsum(is_img.reshape(-1).to(torch.int32), 0) - 1
    feat_idx = torch.clamp(feat_idx, 0, flat_feats.shape[0] - 1)
    gathered = flat_feats[feat_idx.long()].reshape(B, S, D)
    return torch.where(is_img[..., None], gathered, embeds)


def prepare_embeddings(
    params: dict,
    cfg: AriaConfig,
    tokens: torch.Tensor,  # [B, S]
    pixel_values: Optional[torch.Tensor] = None,
    pixel_mask: Optional[torch.Tensor] = None,
    image_features: Optional[torch.Tensor] = None,  # an encode_images output
) -> torch.Tensor:
    """Token embeddings (bf16 from an int8 table, as aria.py:93 gives them)
    with image features scattered into the ``<|img|>`` slots."""
    embeds = embed_tokens(params["lm"]["embed"], tokens)
    if image_features is None and pixel_values is not None:
        image_features = encode_images(params, cfg, pixel_values, pixel_mask)
    if image_features is not None:
        embeds = scatter_image_features(embeds, tokens, image_features, cfg.image_token_id)
    return embeds
