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

Over a mesh of ``data``, ``fsdp`` and ``expert`` (``mesh=``; the JAX
package jits the same step under GSPMD) each rank holds its shard of the
parameters and of the optimizer's state (``parallel/fsdp.py``) and the
batch's rows of its place in the batch group. The step computes what one
device computes on the whole batch: the cross-entropy is divided by the
global count of valid labels, the MoE losses are the global formulas
(``parallel/ep.py``), each gradient is summed over the batch group and
never over ``expert``, the clip takes the global norm with each element
counted once, and the metrics are the global ones.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from aria_tpu_torch.config import AriaConfig
from aria_tpu_torch.models.aria import chunked_lm_loss, prepare_embeddings
from aria_tpu_torch.models.moe_lm import lm_forward
from aria_tpu_torch.parallel.mesh import lm_param_specs


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
                 every_k: int = 1, mesh=None, specs: Optional[Dict[str, Any]] = None):
        self.tc, self.mask, self.every_k = tc, mask, max(every_k, 1)
        self.schedule = make_schedule(tc)
        # on a mesh: the spec of each leaf's path, for the sharded global norm
        self.mesh, self.specs = mesh, specs

    def norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of the gradients (of this rank's shards on a
        mesh, each element counted once)."""
        if self.mesh is None:
            return global_norm(grads)
        from aria_tpu_torch.parallel.fsdp import global_norm_sq

        return torch.sqrt(global_norm_sq(grads, self.mesh, self.specs))

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
        norm = self.norm(grads)
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
            lora_scale: float = 0.0, mesh=None):
    """(loss, LossOutput) of one batch {input_ids, labels, pixel_values?,
    pixel_mask?, attn_mask?} in training mode (step.py:102-115). Attention
    is causal, or where ``attn_mask`` (broadcastable to [B, H, S, S], True =
    attend) says; padding is excluded by -100 labels. The head and the
    cross-entropy run a chunk of positions at a time (``chunked_lm_loss``).
    On a mesh the batch is this rank's rows and the loss its share of the
    global loss: the cross-entropy over the global count of valid labels,
    the MoE losses their share (summed over the batch group, each is the
    global value); the embedding and a frozen ViT are gathered whole for
    the lookup and the encode alone."""
    num_valid = (batch["labels"][:, 1:] != -100).sum().float().reshape(1)
    embed_params = params
    if mesh is not None:
        from aria_tpu_torch.parallel import distributed as dd
        from aria_tpu_torch.parallel import fsdp

        if mesh.batch_size > 1:
            num_valid = dd.all_reduce(num_valid, mesh.group("batch"))
        # the embedding and a frozen ViT stay in shards until here (``_step_grads``):
        # whole for the lookup and the encode only, on every rank (collectives),
        # and freed before the decoder runs
        lm = {**params["lm"], "embed": fsdp.gathered(params["lm"]["embed"],
                                                     lm_param_specs()["embed"], mesh)}
        embed_params = {**params, "lm": lm}
        if mesh.shape["fsdp"] > 1 and not any(t.requires_grad
                                              for _, t in leaves(params["vision"])):
            vision = {"vision": params["vision"]}
            embed_params.update(fsdp.gather_whole(vision, mesh, fsdp.specs_by_path(vision)))
    embeds = prepare_embeddings(embed_params, cfg, batch["input_ids"], batch.get("pixel_values"),
                                batch.get("pixel_mask"))
    del embed_params
    out = lm_forward(params["lm"], cfg.text, inputs_embeds=embeds, mask=batch.get("attn_mask"),
                     training=True, lora=lora["lm"] if lora is not None else None,
                     lora_scale=lora_scale, remat=remat, mesh=mesh, head=False)
    losses = chunked_lm_loss(out.hidden, params["lm"]["lm_head"], batch["labels"], out.z_loss,
                             out.aux_loss, num_valid)
    return losses.loss, losses


def _grads(loss: torch.Tensor, named: List[Tuple[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """d loss / d leaf for each named leaf (zeros where the loss does not
    reach it, as jax.grad gives)."""
    got = torch.autograd.grad(loss, [t for _, t in named], allow_unused=True)
    return {p: torch.zeros_like(t) if g is None else g for (p, t), g in zip(named, got)}


def _metrics(losses, grads, optimizer: Optimizer) -> Dict[str, torch.Tensor]:
    vals = torch.stack([losses.loss.detach(), losses.ce_loss.detach(),
                        losses.z_loss.detach(), losses.aux_loss.detach()]).float()
    mesh = optimizer.mesh
    if mesh is not None and mesh.batch_size > 1:  # each rank's share -> the global values
        from aria_tpu_torch.parallel import distributed as dd

        vals = dd.all_reduce(vals, mesh.group("batch"))
    loss, ce, z, aux = vals.unbind()
    return {"loss": loss, "ce_loss": ce, "z_loss": z, "aux_loss": aux,
            "grad_norm": optimizer.norm(grads)}


def _step_grads(params: Any, named, optimizer: Optimizer, run) -> tuple:
    """``run(forward tree)`` -> (loss, losses), and the trainable leaves'
    gradients. Over a mesh the leaves outside the decoder's layer stack are
    gathered whole for the step (``fsdp.whole_leaves``), the layer stack's
    shards a layer at a time inside the forward, and the gradients are
    those of this rank's shards, summed over the batch group."""
    mesh, specs = optimizer.mesh, optimizer.specs
    if mesh is None:
        loss, losses = run(params)
        return losses, _grads(loss, named)
    from aria_tpu_torch.parallel import fsdp

    trainable = {p: True for p, _ in named}
    frozen_vit = not any(p.startswith("vision/") for p in trainable)
    inside = ("lm/layers/", "lm/embed")  # gathered inside autograd by the forward
    tree = fsdp.whole_leaves(params, mesh, specs, trainable,
                             skip=inside + (("vision/",) if frozen_vit else ()))
    by_path = dict(leaves(tree))
    loss, losses = run(tree)
    grads = _grads(loss, [(p, by_path[p]) for p, _ in named])
    return losses, fsdp.reduce_grads(grads, mesh, specs, scattered=inside)


def train_step(state: TrainState, batch: dict, cfg: AriaConfig, tc: TrainConfig,
               optimizer: Optimizer, mesh=None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One micro step of full fine-tuning (step.py:118-134): the trainable
    leaves' gradients (the ViT's too with ``freeze_vit=False``), frozen
    layers zeroed, then the optimizer, in place. Over a ``mesh`` the
    parameters and the optimizer are this rank's shards (``make_optimizer(
    mesh=)``) and ``batch`` this rank's rows."""
    named = optimizer.trainable(state.params)
    for _, t in named:
        t.requires_grad_(True)
    with torch.enable_grad():
        losses, grads = _step_grads(state.params, named, optimizer, lambda tree: loss_fn(
            tree, cfg, batch, tc.gradient_checkpointing, mesh=mesh))
    _zero_frozen_layer_grads(grads, tc)
    metrics = _metrics(losses, grads, optimizer)
    optimizer.update(grads, state.opt_state, state.params)
    return TrainState(state.params, state.opt_state, state.step + 1), metrics


def lora_train_step(state: TrainState, batch: dict, base_params: Any, cfg: AriaConfig,
                    lora_scale: float, optimizer: Optimizer, remat: bool = False, mesh=None
                    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One LoRA micro step (step.py:155-177): gradients reach only the
    adapter tree; the base stays frozen. Over a ``mesh`` the base is this
    rank's shards and the adapters are replicated."""
    named = optimizer.trainable(state.params)
    for _, t in named:
        t.requires_grad_(True)
    base = base_params
    if mesh is not None:
        from aria_tpu_torch.parallel import fsdp

        base = fsdp.whole_leaves(base_params, mesh, optimizer.base_specs, {},
                                 skip=("lm/layers/", "lm/embed", "vision/"))
    with torch.enable_grad():
        losses, grads = _step_grads(state.params, named, optimizer, lambda lora: loss_fn(
            base, cfg, batch, remat, lora=lora, lora_scale=lora_scale, mesh=mesh))
    metrics = _metrics(losses, grads, optimizer)
    optimizer.update(grads, state.opt_state, state.params)
    return TrainState(state.params, state.opt_state, state.step + 1), metrics


def make_optimizer(tc: TrainConfig, params: Any, every_k: int = 1, mesh=None) -> Optimizer:
    """The full fine-tuning optimizer; over a ``mesh``, of the shards of
    ``params`` (specs from ``aria_param_specs``)."""
    specs = None
    if mesh is not None:
        from aria_tpu_torch.parallel.fsdp import specs_by_path

        specs = specs_by_path(params)
    return Optimizer(tc, trainable_mask(params, tc), every_k, mesh, specs)


def make_lora_optimizer(tc: TrainConfig, every_k: int = 1, mesh=None, lora: Any = None,
                        base_params: Any = None) -> Optimizer:
    """The LoRA optimizer; over a ``mesh`` it needs the adapter tree
    (replicated) and the sharded base (``aria_param_specs``)."""
    if mesh is None:
        return Optimizer(tc, None, every_k)
    from aria_tpu_torch.parallel.fsdp import specs_by_path
    from aria_tpu_torch.parallel.mesh import P

    opt = Optimizer(tc, None, every_k, mesh, {p: P() for p, _ in leaves(lora)})
    opt.base_specs = specs_by_path(base_params)
    return opt
