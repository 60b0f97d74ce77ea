"""The composite model: vision tower -> projector -> image features
scattered into the ``<|img|>`` token embeddings -> the MoE decoder, and the
training loss (counterpart of aria_tpu/models/aria.py).

The vision tower records a graph only where autograd is on and one of its
leaves asks for a gradient (``freeze_vit=False``); its attention then
takes ``flash_segment``'s differentiable form (``models/vit.py``). A
frozen tower, and serving, run it under ``torch.no_grad()``. The projector
is differentiated when its weights ask for gradients.
"""

from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from aria_tpu_torch.config import AriaConfig
from aria_tpu_torch.models.moe_lm import LMOutput, embed_tokens, init_lm_params, lm_forward
from aria_tpu_torch.models.projector import init_projector_params, projector_forward
from aria_tpu_torch.models.vit import init_vit_params, vit_forward

# 1/255 as the f32 constant of the jitted JAX normalize
_INV_255 = float(np.float32(1.0 / 255.0))


def normalize_pixels(pixel_values: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> (x/255 - 0.5)/0.5 in f32, as the jitted JAX encode
    computes it: XLA turns the division into a multiply by the f32
    reciprocal fused with the subtraction, fma(x, 1/255, -0.5) * 2. The
    f64 product of a byte and that constant is exact, so one rounding of
    ``x * c - 0.5`` to f32 is the fused result."""
    return ((pixel_values.double() * _INV_255) - 0.5).float() * 2.0


def init_aria_params(cfg: AriaConfig, generator: torch.Generator, *, device="cuda",
                     dtype=torch.bfloat16) -> dict:
    """The whole model's training tree (aria.py:24-31): ViT, projector and
    the decoder's ``init_lm_params``, on the card unless ``device`` names
    another."""
    return {"vision": init_vit_params(cfg.vision, generator, device=device, dtype=dtype),
            "projector": init_projector_params(cfg.projector, generator, device=device,
                                               dtype=dtype),
            "lm": init_lm_params(cfg.text, generator, device=device, dtype=dtype)}


def _asks_grad(tree: Any) -> bool:
    if isinstance(tree, dict):
        return any(_asks_grad(v) for v in tree.values())
    return isinstance(tree, torch.Tensor) and tree.requires_grad


def encode_images(params: dict, cfg: AriaConfig, pixel_values: torch.Tensor,
                  pixel_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N, C, S, S] images -> [N, Q, D_lm] projected image features.

    uint8 pixels are normalized on the device; ``pixel_mask=None`` means
    every pixel is valid. The ViT records a graph when autograd is on and a
    vision leaf requires a gradient; the projector whenever autograd is
    on."""
    if pixel_values.dtype == torch.uint8:
        pixel_values = normalize_pixels(pixel_values)
    if pixel_mask is None:
        N, _, H, W = pixel_values.shape
        pixel_mask = torch.ones((N, H, W), dtype=torch.bool, device=pixel_values.device)
    train_vit = torch.is_grad_enabled() and _asks_grad(params["vision"])
    with contextlib.nullcontext() if train_vit else torch.no_grad():
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


def aria_forward(
    params: dict,
    cfg: AriaConfig,
    tokens: torch.Tensor,  # [B, S]
    pixel_values: Optional[torch.Tensor] = None,  # [N, C, S_img, S_img]
    pixel_mask: Optional[torch.Tensor] = None,  # [N, S_img, S_img] bool
    *,
    mask: Optional[torch.Tensor] = None,  # broadcastable to [B, H, S, S]; True = attend
    training: bool = False,
    lora: Optional[dict] = None,  # {"lm": {"layers": {...}}}
    lora_scale: float = 0.0,
    remat: bool = False,
) -> LMOutput:
    """Embeddings with the image features scattered in, then the decoder
    over the whole sequence with causal attention, or where ``mask`` says
    (aria.py:101-126)."""
    embeds = prepare_embeddings(params, cfg, tokens, pixel_values, pixel_mask)
    return lm_forward(params["lm"], cfg.text, inputs_embeds=embeds, mask=mask,
                      training=training, lora=lora["lm"] if lora is not None else None,
                      lora_scale=lora_scale, remat=remat)


class LossOutput(NamedTuple):
    loss: torch.Tensor
    ce_loss: torch.Tensor
    z_loss: torch.Tensor
    aux_loss: torch.Tensor


def causal_lm_loss(out: LMOutput, labels: torch.Tensor, *, include_aux: bool = True
                   ) -> LossOutput:
    """Shifted cross-entropy in f32 over the positions whose label is not
    -100, plus the MoE z and aux losses (aria.py:136-148)."""
    logits = out.logits[:, :-1].float()
    targets = labels[:, 1:].long()
    valid = targets != -100
    logp = torch.log_softmax(logits, dim=-1)
    tok_logp = torch.gather(logp, -1, torch.where(valid, targets, 0)[..., None])[..., 0]
    ce = -torch.sum(torch.where(valid, tok_logp, 0.0)) / torch.clamp_min(valid.sum(), 1)
    loss = ce + (out.z_loss + out.aux_loss if include_aux else 0.0)
    return LossOutput(loss, ce, out.z_loss, out.aux_loss)
