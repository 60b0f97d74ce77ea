"""One training step: loss, gradients and the optimizer (counterpart of
aria_tpu/train/step.py).

The loss is the shifted cross-entropy plus the MoE z and aux losses, one
scalar that autograd differentiates. The optimizer is optax's, written as
torch ops in optax 0.2.6's order and dtypes, because ``torch.optim.AdamW``
and ``clip_grad_norm_`` differ from it (eps and the clip threshold):

- ``clip_by_global_norm``: the norm is the square root of the sum, leaf by
  leaf in the tree's sorted order, of each leaf's sum of squares in its
  own dtype; at or above ``grad_clip_norm`` every leaf becomes (g / norm)
  * max_norm;
- ``adamw``: mu = (1 - b1) g + b1 mu and nu = (1 - b2) g^2 + b2 nu in the
  parameter dtype, bias-corrected by 1 - b^count at the incremented
  count, u = mu_hat / (sqrt(nu_hat) + eps) (eps outside the root,
  eps_root 0), plus weight_decay * p, times -lr in the parameter dtype;
- the learning rate is ``cosine_decay_schedule`` or, with warm-up steps,
  ``warmup_cosine_decay_schedule`` (0 -> lr linearly, then cosine to 0),
  in f32 at the count before the update;
- ``masked``: only the trainable leaves (``trainable_mask``) are clipped,
  have moments and move. optax passes a masked-out leaf's gradient
  through as its update; the port runs the frozen towers without
  autograd, so they have no gradient and stay as they are (on text rows
  the JAX package's gradient there is exactly 0 too);
- ``MultiSteps(k)``: the gradients' running mean acc + (g - acc) / (n + 1)
  over k micro steps, the update applied at the k-th, and the schedule's
  count advancing once per k.

Parameters, moments and the accumulator are updated in place to save
device memory (the full recipe's 2.3 G trainable weights take 4.6 GB per
copy in bf16).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from aria_tpu_torch.config import AriaConfig
from aria_tpu_torch.models.aria import aria_forward, causal_lm_loss


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 0.0
    grad_clip_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    warmup_steps: int = 0
    total_steps: int = 10_000
    freeze_vit: bool = True
    freeze_projector: bool = True
    freeze_llm: bool = False
    freeze_llm_layers: tuple[int, ...] = ()
    grad_accum_steps: int = 1
    gradient_checkpointing: bool = False


class TrainState(NamedTuple):
    params: Any  # the model's tree (full fine-tuning) or the adapters' (LoRA)
    opt_state: Dict[str, Any]
    step: int  # micro steps taken


def leaves(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of a nested dict, keys sorted at every level as
    ``jax.tree.leaves`` orders them; paths join keys with '/'."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def trainable_mask(params: Any, tc: TrainConfig) -> Dict[str, bool]:
    """Path -> trainable (step.py:51-67): the ViT and the projector as their
    freeze flags say, the decoder unless ``freeze_llm``; single decoder
    layers are frozen by zeroing their gradients instead."""
    keep = {"vision": not tc.freeze_vit, "projector": not tc.freeze_projector}
    return {path: keep.get(path.split("/")[0], not tc.freeze_llm)
            for path, _ in leaves(params)}


def _zero_frozen_layer_grads(grads: Dict[str, torch.Tensor], tc: TrainConfig) -> None:
    """Zero the gradients of the frozen decoder layers (the leading L axis of
    every lm/layers leaf), multiplying by a 0/1 mask as step.py:70-81."""
    if not tc.freeze_llm_layers:
        return
    for path, g in grads.items():
        if path.startswith("lm/layers/"):
            keep = torch.ones(g.shape[0], dtype=g.dtype, device=g.device)
            keep[list(tc.freeze_llm_layers)] = 0
            g.mul_(keep.reshape((-1,) + (1,) * (g.ndim - 1)))


def make_schedule(tc: TrainConfig) -> Callable[[int], torch.Tensor]:
    """The learning rate at an optimizer count, an f32 scalar (step.py:84-89,
    optax's schedules)."""
    total = max(tc.total_steps, 2)
    f32 = torch.float32

    def cosine(count, init: float, decay_steps: int) -> torch.Tensor:
        if decay_steps <= 0:
            raise ValueError(f"cosine decay over {decay_steps} steps")
        c = torch.minimum(count, torch.tensor(float(decay_steps), dtype=f32))
        return init * (0.5 * (1 + torch.cos(math.pi * c / float(decay_steps))))

    def schedule(count: int) -> torch.Tensor:
        c = torch.tensor(float(count), dtype=f32)
        if tc.warmup_steps <= 0:
            return cosine(c, tc.learning_rate, total)
        if count < tc.warmup_steps:
            frac = 1 - torch.clamp(c, 0, tc.warmup_steps) / tc.warmup_steps
            return (0.0 - tc.learning_rate) * frac + tc.learning_rate
        return cosine(c - tc.warmup_steps, tc.learning_rate, total - tc.warmup_steps)

    return schedule


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum over leaves (sorted order) of each
    leaf's sum of squares in the leaf's dtype."""
    return torch.sqrt(sum(torch.sum(g * g) for _, g in sorted(grads.items())))


class Optimizer:
    """``optax.masked(chain(clip_by_global_norm, adamw(schedule)), mask)``
    (``make_optimizer``; ``mask=None`` is ``make_lora_optimizer``), inside
    ``optax.MultiSteps(every_k)`` when ``every_k`` > 1. ``init`` gives the
    state (a dict of counts and of path -> tensor trees); ``update``
    applies one micro step's gradients to the parameters in place."""

    def __init__(self, tc: TrainConfig, mask: Optional[Dict[str, bool]] = None,
                 every_k: int = 1):
        self.tc, self.mask, self.every_k = tc, mask, max(every_k, 1)
        self.schedule = make_schedule(tc)

    def trainable(self, params: Any) -> List[Tuple[str, torch.Tensor]]:
        return [(p, t) for p, t in leaves(params) if self.mask is None or self.mask[p]]

    def init(self, params: Any) -> Dict[str, Any]:
        zeros = lambda: {p: torch.zeros_like(t) for p, t in self.trainable(params)}  # noqa: E731
        state = {"count": 0, "mu": zeros(), "nu": zeros()}
        if self.every_k > 1:
            state.update(mini_step=0, gradient_step=0, acc=zeros())
        return state

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: Dict[str, Any], params: Any) -> None:
        """grads: path -> gradient for every trainable leaf."""
        if self.every_k > 1:
            n = state["mini_step"]
            for p, acc in state["acc"].items():
                acc.add_((grads[p] - acc) / (n + 1))
            state["mini_step"] = (n + 1) % self.every_k
            if n < self.every_k - 1:
                return
            grads = state["acc"]
            state["gradient_step"] += 1
        self._adamw(grads, state, params)
        if self.every_k > 1:
            for acc in state["acc"].values():
                acc.zero_()

    def _adamw(self, grads, state, params) -> None:
        tc = self.tc
        norm = global_norm(grads)
        clip = not bool(norm < tc.grad_clip_norm)
        lr = self.schedule(state["count"])
        state["count"] += 1
        count = torch.tensor(state["count"], dtype=torch.int32)
        bc1 = 1 - torch.tensor(tc.b1, dtype=torch.float32) ** count
        bc2 = 1 - torch.tensor(tc.b2, dtype=torch.float32) ** count
        for path, p in self.trainable(params):
            g = grads[path]
            if clip:
                g = (g / norm.to(g.dtype)) * tc.grad_clip_norm
            mu, nu = state["mu"][path], state["nu"][path]
            mu.mul_(tc.b1).add_((1 - tc.b1) * g)
            nu.mul_(tc.b2).add_((1 - tc.b2) * (g * g))
            dt, dev = p.dtype, p.device
            u = (mu / bc1.to(dev, dt)) / (torch.sqrt(nu / bc2.to(dev, dt)) + 1e-8)
            u = u + tc.weight_decay * p
            p.add_((-lr).to(dev, dt) * u)


def _batch_to(batch: dict, device) -> dict:
    return {k: (torch.as_tensor(v).to(device) if v is not None else None)
            for k, v in batch.items()}


def loss_fn(params, cfg: AriaConfig, batch: dict, remat: bool = False, lora=None,
            lora_scale: float = 0.0):
    """(loss, LossOutput) of one batch {input_ids, labels, pixel_values?,
    pixel_mask?, attn_mask?} in training mode (step.py:102-115). Attention
    is causal, or where ``attn_mask`` (broadcastable to [B, H, S, S], True =
    attend) says; padding is excluded by -100 labels."""
    out = aria_forward(params, cfg, batch["input_ids"], batch.get("pixel_values"),
                       batch.get("pixel_mask"), mask=batch.get("attn_mask"), training=True,
                       lora=lora, lora_scale=lora_scale, remat=remat)
    losses = causal_lm_loss(out, batch["labels"])
    return losses.loss, losses


def _grads(loss: torch.Tensor, named: List[Tuple[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """d loss / d leaf for each named leaf (zeros where the loss does not
    reach it, as jax.grad gives)."""
    got = torch.autograd.grad(loss, [t for _, t in named], allow_unused=True)
    return {p: torch.zeros_like(t) if g is None else g for (p, t), g in zip(named, got)}


def _metrics(losses, grads) -> Dict[str, torch.Tensor]:
    return {"loss": losses.loss.detach(), "ce_loss": losses.ce_loss.detach(),
            "z_loss": losses.z_loss.detach(), "aux_loss": losses.aux_loss.detach(),
            "grad_norm": global_norm(grads)}


def train_step(state: TrainState, batch: dict, cfg: AriaConfig, tc: TrainConfig,
               optimizer: Optimizer) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One micro step of full fine-tuning (step.py:118-134): the trainable
    leaves' gradients (the ViT's too with ``freeze_vit=False``), frozen
    layers zeroed, then the optimizer, in place."""
    named = optimizer.trainable(state.params)
    for _, t in named:
        t.requires_grad_(True)
    with torch.enable_grad():
        loss, losses = loss_fn(state.params, cfg, batch, tc.gradient_checkpointing)
        grads = _grads(loss, named)
    _zero_frozen_layer_grads(grads, tc)
    metrics = _metrics(losses, grads)
    optimizer.update(grads, state.opt_state, state.params)
    return TrainState(state.params, state.opt_state, state.step + 1), metrics


def lora_train_step(state: TrainState, batch: dict, base_params: Any, cfg: AriaConfig,
                    lora_scale: float, optimizer: Optimizer, remat: bool = False
                    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One LoRA micro step (step.py:155-177): gradients reach only the
    adapter tree; the base stays frozen."""
    named = optimizer.trainable(state.params)
    for _, t in named:
        t.requires_grad_(True)
    with torch.enable_grad():
        loss, losses = loss_fn(base_params, cfg, batch, remat, lora=state.params,
                               lora_scale=lora_scale)
        grads = _grads(loss, named)
    metrics = _metrics(losses, grads)
    optimizer.update(grads, state.opt_state, state.params)
    return TrainState(state.params, state.opt_state, state.step + 1), metrics


def make_optimizer(tc: TrainConfig, params: Any, every_k: int = 1) -> Optimizer:
    return Optimizer(tc, trainable_mask(params, tc), every_k)


def make_lora_optimizer(tc: TrainConfig, every_k: int = 1) -> Optimizer:
    return Optimizer(tc, None, every_k)
