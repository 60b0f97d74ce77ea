"""SigLIP-style vision transformer with NaViT patch masks (counterpart of
aria_tpu/models/vit.py).

Images arrive as [N, C, S, S] with a pixel mask [N, S, S] marking real
content (top-left rectangles). The patch embedding is a reshape and one
matmul (a stride-14 valid conv); fractional position ids are bucketized
in f32 as the JAX package does; the layer loop is a Python loop over the
stacked [L, ...] leaves. Attention goes through the ``vit_flash`` kernel
wrapper at 256 patches or more, and through the plain masked ``sdpa``
below that (vit.py:142); with ``VIT_FLASH`` off (the JAX package's
``ARIA_TPU_VIT_FLASH=0``, vit.py:157-177) the 256 patches or more go
through ``flash_sdpa`` with the padding as segment ids, so pad patches
attend each other only. ``vit_flash`` serves: it has no backward, as in
the JAX package, so a ViT that records a graph (``freeze_vit=False``) at
256 patches or more takes ``flash_sdpa``'s segment form whatever
``VIT_FLASH`` says, the JAX package's differentiable path under
``ARIA_TPU_VIT_FLASH=0``; its autograd function runs the segment backward
kernel on the card. No post-layernorm.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from aria_tpu_torch.config import VisionConfig
from aria_tpu_torch.ops import backend
from aria_tpu_torch.ops.activations import gelu_tanh
from aria_tpu_torch.ops.attention import sdpa
from aria_tpu_torch.ops.flash import flash_sdpa
from aria_tpu_torch.ops.norms import layer_norm
from aria_tpu_torch.ops.quant import is_quantized, linear
from aria_tpu_torch.ops.vit_flash import vit_flash

FLASH_MIN_PATCHES = 256
VIT_FLASH = True  # the JAX package's ARIA_TPU_VIT_FLASH (default "1"), read at call time


class VisionOutput(NamedTuple):
    features: torch.Tensor  # [N, P, D] patch features (no post-layernorm)
    patch_mask: torch.Tensor  # [N, P] bool, True = real patch
    kv_ignore_mask: torch.Tensor  # [N, P] bool, True = padding (for the projector)


def init_vit_params(cfg: VisionConfig, generator: torch.Generator, *, device="cuda",
                    dtype=torch.bfloat16) -> dict:
    """Random init with the structure of vit.py:37-68 (normal / sqrt(fan_in)
    weights, zero biases, unit norm scales), on the card unless ``device``
    names another."""
    device = backend.device(device)
    L, D, F = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    patch_dim = cfg.num_channels * cfg.patch_size * cfg.patch_size
    P = cfg.patches_per_side**2

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * fan_in**-0.5).to(dtype)

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "patch_embed_w": dense((patch_dim, D), patch_dim),
        "patch_embed_b": const((D,), 0.0),
        "pos_embed": dense((P, D), D),
        "layers": {
            "ln1_w": const((L, D), 1.0), "ln1_b": const((L, D), 0.0),
            "ln2_w": const((L, D), 1.0), "ln2_b": const((L, D), 0.0),
            "wq": dense((L, D, D), D), "bq": const((L, D), 0.0),
            "wk": dense((L, D, D), D), "bk": const((L, D), 0.0),
            "wv": dense((L, D, D), D), "bv": const((L, D), 0.0),
            "wo": dense((L, D, D), D), "bo": const((L, D), 0.0),
            "fc1_w": dense((L, D, F), D), "fc1_b": const((L, F), 0.0),
            "fc2_w": dense((L, F, D), F), "fc2_b": const((L, D), 0.0),
        },
    }


def patch_attention_mask(pixel_mask: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[N, H, W] bool pixel mask -> [N, nh, nw] bool: a patch is real iff
    any of its pixels is."""
    N, H, W = pixel_mask.shape
    nh, nw = H // patch_size, W // patch_size
    grid = pixel_mask.reshape(N, nh, patch_size, nw, patch_size)
    return grid.sum(dim=(2, 4)) > 0


def _position_ids(patch_mask_2d: torch.Tensor, patches_per_side: int) -> torch.Tensor:
    """NaViT bucketized position ids (vit.py:83-107): the valid rows and
    columns are read from the mask's first column and row, their fractional
    coordinates bucketized in f32 into ``patches_per_side`` buckets with the
    same (1 - 1e-6) factor; padding patches get id 0."""
    N, nh, nw = patch_mask_2d.shape
    n = patches_per_side
    dev = patch_mask_2d.device
    nb_h = patch_mask_2d[:, :, 0].to(torch.int32).sum(dim=1)
    nb_w = patch_mask_2d[:, 0, :].to(torch.int32).sum(dim=1)
    rows = torch.arange(nh, dtype=torch.float32, device=dev)
    cols = torch.arange(nw, dtype=torch.float32, device=dev)
    frac_h = rows[None, :] / torch.clamp_min(nb_h[:, None], 1).float() * (1 - 1e-6)
    frac_w = cols[None, :] / torch.clamp_min(nb_w[:, None], 1).float() * (1 - 1e-6)
    bucket_h = torch.floor(frac_h * n).to(torch.int64)
    bucket_w = torch.floor(frac_w * n).to(torch.int64)
    pos = bucket_h[:, :, None] * n + bucket_w[:, None, :]
    pos = torch.where(patch_mask_2d, pos, torch.zeros_like(pos))
    return pos.reshape(N, nh * nw)


def _extract_patches(pixel_values: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[N, C, H, W] -> [N, nh*nw, C*ps*ps], flattened in torch-conv weight order."""
    N, C, H, W = pixel_values.shape
    nh, nw = H // patch_size, W // patch_size
    x = pixel_values.reshape(N, C, nh, patch_size, nw, patch_size)
    x = x.permute(0, 2, 4, 1, 3, 5)
    return x.reshape(N, nh * nw, C * patch_size * patch_size)


def vit_forward(params: dict, cfg: VisionConfig, pixel_values: torch.Tensor,
                pixel_mask: torch.Tensor) -> VisionOutput:
    """pixel_values [N, C, S, S] float; pixel_mask [N, S, S] bool."""
    pm2d = patch_attention_mask(pixel_mask, cfg.patch_size)
    pos_ids = _position_ids(pm2d, cfg.patches_per_side)
    pmask = pm2d.reshape(pm2d.shape[0], -1)

    patches = _extract_patches(pixel_values, cfg.patch_size)
    pw = params["patch_embed_w"]
    # an int8 patch embedding makes the product bf16; the bias add then
    # promotes to the biases' dtype (vit.py:126-134)
    dtype = torch.bfloat16 if is_quantized(pw) else pw.dtype
    x = linear(patches.to(dtype), pw).to(dtype) + params["patch_embed_b"]
    x = x + params["pos_embed"][pos_ids].to(dtype)

    N, P, D = x.shape
    H, Dh = cfg.num_heads, cfg.head_dim
    flash = P >= FLASH_MIN_PATCHES
    attn_mask = pmask[:, None, None, :]
    layers = params["layers"]

    def lin(t, name, bias, layer):
        w = layers[name]
        w = {k: v[layer] for k, v in w.items()} if is_quantized(w) else w[layer]
        return (linear(t, w) + layers[bias][layer]).to(x.dtype)

    for layer in range(cfg.num_layers):
        normed = layer_norm(x, layers["ln1_w"][layer], layers["ln1_b"][layer],
                            cfg.layer_norm_eps)
        q, k, v = (lin(normed, w, b, layer).reshape(N, P, H, Dh)
                   for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
        if flash and VIT_FLASH and not (torch.is_grad_enabled() and q.requires_grad):
            att = vit_flash(q, k, v, pmask)
        elif flash:
            att = flash_sdpa(q, k, v, q_valid=pmask, kv_valid=pmask)
        else:
            att = sdpa(q, k, v, attn_mask)
        x = x + lin(att.reshape(N, P, D), "wo", "bo", layer)
        normed = layer_norm(x, layers["ln2_w"][layer], layers["ln2_b"][layer],
                            cfg.layer_norm_eps)
        mlp = gelu_tanh(lin(normed, "fc1_w", "fc1_b", layer))
        x = x + lin(mlp, "fc2_w", "fc2_b", layer)
    return VisionOutput(x, pmask, torch.logical_not(pmask))
