"""QLoRA in the port against the JAX package, on the CPU: the int8 base of
``quantize_params`` built a layer at a time (bit for bit), ``linear``'s
int8 branch under autograd, the adapters' loss and gradients over the int8
base (the blocked expert-LoRA dequantize, with and without interpret mode
on the JAX side, so that its ``_pin_default_layout`` ``pallas_call`` runs
and does not, remat on and off, an image row, one and two expert blocks),
the dispatch without expert adapters, three ``lora_train_step`` updates,
the backward keeping no float copy of the frozen experts, ``train()`` with
``quantize_base`` end to end and the CLI reaching it.

``AriaConfig.tiny()`` in f32 (8 routed experts, top-2): the int8 values
and scales are bit-equal on the two sides, the dequantized weights too (an
int8 value times an f32 scale, rounded once), and the products differ
only in their order of summation, so losses and gradients agree to 1e-4
relative (1e-5 absolute where a gradient is near 0), as
tests/test_torch_train.py holds the float base.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aria_tpu.config import AriaConfig
from aria_tpu.models import aria as jaria
from aria_tpu.ops import backend as jbackend
from aria_tpu.ops import quant as jquant
from aria_tpu.train import lora as jlora
from aria_tpu.train import step as jstep
from aria_tpu_torch.checkpoint.from_jax import from_jax
from aria_tpu_torch.config import config_from_dict
from aria_tpu_torch.models import aria as taria
from aria_tpu_torch.models import moe_lm as tm
from aria_tpu_torch.ops import quant as tquant
from aria_tpu_torch.train import step as tstep
from aria_tpu_torch.train.loop import train
from aria_tpu_torch.train.recipe import Recipe

torch.set_num_threads(1)
CFG = AriaConfig.tiny()
T_CFG = config_from_dict(dataclasses.asdict(CFG))
RTOL, ATOL = 1e-4, 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def kernels(request):
    """ARIA_TPU_KERNELS for the JAX side: "interpret" runs its Pallas calls
    in interpret mode (``_pin_default_layout`` among them), "xla" none."""
    old = os.environ.get("ARIA_TPU_KERNELS")
    os.environ["ARIA_TPU_KERNELS"] = request.param
    jbackend.kernel_backend.cache_clear()
    jax.clear_caches()
    yield request.param
    if old is None:
        os.environ.pop("ARIA_TPU_KERNELS", None)
    else:
        os.environ["ARIA_TPU_KERNELS"] = old
    jbackend.kernel_backend.cache_clear()
    jax.clear_caches()


@pytest.fixture
def eblock(request, monkeypatch):
    """Experts per block of the blocked expert-LoRA path on both sides (0:
    the default, one block of all 8 experts)."""
    monkeypatch.setenv("ARIA_TPU_LORA_EBLOCK", str(request.param))
    monkeypatch.setattr(tm, "LORA_EBLOCK", request.param)
    jax.clear_caches()
    yield request.param
    jax.clear_caches()


@pytest.fixture(scope="module")
def model():
    """(JAX float params, its quantize_params tree as numpy, the port's
    int8 tree from it, a JAX LoRA tree with B away from 0, the port's)."""
    params = jaria.init_aria_params(jax.random.PRNGKey(0), CFG, dtype=jnp.float32)
    qparams = jax.tree.map(np.asarray, jquant.quantize_params(params))
    lora = jlora.init_lora_params(jax.random.PRNGKey(1), CFG, jlora.LoraConfig(rank=4, alpha=8.0))
    rng = np.random.RandomState(4)
    lora = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32),
                        lora)
    return params, qparams, from_jax(qparams, device="cpu"), lora, from_jax(lora, device="cpu")


def _close(got, want, name="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=name)


def _batch(seed, image=False, B=2, S=40):
    """Token rows with -100 labels at the start; with ``image`` row 0
    carries a 98px image's 8 tokens (the tiny projector's 49 patches)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(20, CFG.text.vocab_size, (B, S)).astype(np.int32)
    if image:
        ids[0, 4:12] = CFG.image_token_id
    labels = np.where(ids == CFG.image_token_id, -100, ids).astype(np.int32)
    labels[:, :3] = -100
    batch = {"input_ids": ids, "labels": labels}
    if image:
        batch["pixel_values"] = rng.uniform(-1, 1, (1, 3, 98, 98)).astype(np.float32)
    return batch


def _tbatch(b):
    return {k: torch.as_tensor(v).long() if v.dtype == np.int32 else torch.as_tensor(v)
            for k, v in b.items()}


def _leaves_equal(got: dict, want: dict):
    want = dict(tstep.leaves(want))
    got = tstep.leaves(got)
    assert [p for p, _ in got] == sorted(want)
    for path, t in got:
        w = want[path]
        assert t.dtype == {np.dtype("int8"): torch.int8, np.dtype("float32"): torch.float32}[
            w.dtype], path
        np.testing.assert_array_equal(t.numpy(), w, err_msg=path)


# ------------------------------------------------------------ the int8 base


@pytest.mark.parametrize("slab", [3, 16])
def test_quantize_by_layer_is_quantize_params_bit_for_bit(model, slab, monkeypatch):
    """The in-place build (expert slabs of 3: 8 experts in 3, 3, 2, or of
    16) equals the JAX ``quantize_params`` and the port's ``quantize_params``
    at the default slab on every leaf, and drops the float leaves it
    replaced."""
    params, qparams, _, _, _ = model
    tparams = from_jax(jax.tree.map(np.asarray, params), device="cpu")
    whole = tquant.quantize_params(from_jax(jax.tree.map(np.asarray, params), device="cpu"))
    layers = tparams["lm"]["layers"]
    w1 = layers["w1"]
    monkeypatch.setattr(tquant, "QUANT_SLAB", slab)
    built = tquant.quantize_params_by_layer(tparams)
    assert built is tparams and layers["w1"] is not w1  # consumed, in place
    _leaves_equal(built, qparams)
    _leaves_equal(built, jax.tree.map(lambda t: t.numpy(), whole))
    assert set(built["lm"]["layers"]["w1"]) == {"q", "s", "s8"}
    assert set(built["lm"]["layers"]["shared_w1"]) == {"q", "s"}
    assert built["lm"]["embed"].dtype == torch.float32  # embed stays float


def test_linear_int8_carries_the_gradient_to_x():
    """``linear`` over an int8 weight under autograd: the output and x's
    gradient against JAX's ``linear`` and ``jax.grad``."""
    rng = np.random.RandomState(2)
    x = rng.randn(3, 5, 64).astype(np.float32)
    w = jquant.quantize_weight(jnp.asarray(rng.randn(64, 48).astype(np.float32)))
    g = rng.randn(3, 5, 48).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jquant.linear(a, w, "bsd,df->bsf"), jnp.asarray(x))
    tx = torch.as_tensor(x).requires_grad_()
    got = tquant.linear(tx, from_jax(jax.tree.map(np.asarray, w), device="cpu"))
    (dx,) = torch.autograd.grad(got, tx, torch.as_tensor(g))
    _close(got, want, "linear")
    _close(dx, vjp(jnp.asarray(g))[0], "dx")


# ------------------------------------------------------------ loss and gradients


def _jlora_grads(qparams, jl, batch, remat):
    def loss(lo):
        out = jaria.aria_forward(qparams, CFG, jnp.asarray(batch["input_ids"]),
                                 None if "pixel_values" not in batch else
                                 jnp.asarray(batch["pixel_values"]), training=True, lora=lo,
                                 lora_scale=2.0, remat=remat)
        losses = jaria.causal_lm_loss(out, jnp.asarray(batch["labels"]))
        return losses.loss, losses

    jq = jax.tree.map(jnp.asarray, qparams)
    (_, losses), g = jax.value_and_grad(loss, has_aux=True)(jax.tree.map(jnp.asarray, jl))
    return losses, dict(tstep.leaves(jax.tree.map(np.asarray, g))), jq


def _tlora_grads(tq, tl, batch, remat):
    named = tstep.leaves(tl)
    for _, t in named:
        t.requires_grad_(True)
    try:
        b = _tbatch(batch)
        out = taria.aria_forward(tq, T_CFG, b["input_ids"], b.get("pixel_values"),
                                 training=True, lora=tl, lora_scale=2.0, remat=remat)
        losses = taria.causal_lm_loss(out, b["labels"])
        grads = torch.autograd.grad(losses.loss, [t for _, t in named])
    finally:
        for _, t in named:
            t.requires_grad_(False)
    return losses, dict(zip((p for p, _ in named), grads))


@pytest.mark.parametrize("kernels,remat,image,eblock", [
    ("interpret", False, False, 0),
    ("xla", False, False, 0),
    ("interpret", True, True, 0),
    ("xla", True, True, 4),
    ("interpret", False, True, 4),
], indirect=["kernels", "eblock"])
def test_qlora_loss_and_adapter_grads_match_jax(model, kernels, remat, image, eblock):
    """The adapters' loss and gradients over the int8 base: 80 tokens (one
    row with an image's 8 tokens), through the blocked expert-LoRA path in
    one block or two blocks of 4 experts."""
    _, qparams, tq, jl, tl = model
    batch = _batch(5, image=image)
    jlosses, want, _ = _jlora_grads(qparams, jl, batch, remat)
    losses, got = _tlora_grads(tq, tl, batch, remat)
    for name in ("loss", "ce_loss", "z_loss", "aux_loss"):
        _close(getattr(losses, name), getattr(jlosses, name), name)
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        _close(g, want[path], path)


def test_qlora_without_expert_adapters_matches_jax(model):
    """Adapters on attention and the shared MLP only: the int8 experts are
    dequantized for the training dispatch (the JAX package's
    ``dequantize_expert_weights`` path), under the recomputing checkpoint."""
    _, qparams, tq, jl, tl = model
    drop = ("w1", "w2")
    jl = {"lm": {"layers": {k: v for k, v in jl["lm"]["layers"].items() if k not in drop}}}
    tl = {"lm": {"layers": {k: v for k, v in tl["lm"]["layers"].items() if k not in drop}}}
    batch = _batch(6)
    jlosses, want, _ = _jlora_grads(qparams, jl, batch, False)
    losses, got = _tlora_grads(tq, tl, batch, False)
    _close(losses.loss, jlosses.loss, "loss")
    for path, g in got.items():
        _close(g, want[path], path)


@pytest.mark.parametrize("eblock", [0, 4], indirect=True)
def test_qlora_backward_keeps_no_float_experts(model, eblock):
    """Nothing autograd saves for the backward has the shape of a
    dequantized expert block or layer: the blocks are dequantized again in
    the backward (``_frozen_base``)."""
    _, _, tq, _, tl = model
    E, I, D = CFG.text.num_experts, CFG.text.moe_intermediate_size, CFG.text.hidden_size
    eb = eblock or E
    shapes = {(n, r, D) for n in (eb, E) for r in (2 * I, I)}
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.dtype))
        return t

    named = tstep.leaves(tl)
    for _, t in named:
        t.requires_grad_(True)
    try:
        b = _tbatch(_batch(7))
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = taria.aria_forward(tq, T_CFG, b["input_ids"], training=True, lora=tl,
                                     lora_scale=2.0)
            loss = taria.causal_lm_loss(out, b["labels"]).loss
        grads = torch.autograd.grad(loss, [t for _, t in named])
    finally:
        for _, t in named:
            t.requires_grad_(False)
    assert saved and all(torch.isfinite(g).all() for g in grads)
    kept = [s for s in saved if s[0] in shapes and s[1].is_floating_point]
    assert not kept, kept


@pytest.mark.parametrize("kernels", ["interpret"], indirect=True)
def test_qlora_train_step_updates_match_optax(model, kernels):
    """Three ``lora_train_step`` micro steps over the int8 base (remat on,
    a clip norm the gradients exceed) against ``jstep.lora_train_step``:
    the metrics, and each adapter's change to 2e-3 of its norm (Adam's
    steps amplify f32 rounding where a gradient is near 0)."""
    _, qparams, tq, jl, tl = model
    kw = dict(learning_rate=2e-2, weight_decay=0.1, grad_clip_norm=0.05, b2=0.95, total_steps=3)
    jtc, tc = jstep.TrainConfig(**kw), tstep.TrainConfig(**kw)
    jopt = jstep.make_lora_optimizer(jtc)
    jparams = jax.tree.map(jnp.asarray, jl)
    jstate = jstep.TrainState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32))
    tl = jax.tree.map(lambda t: t.clone(), tl)
    topt = tstep.make_lora_optimizer(tc)
    tstate = tstep.TrainState(tl, topt.init(tl), 0)
    jq = jax.tree.map(jnp.asarray, qparams)
    for seed in (11, 12, 13):
        b = _batch(seed, image=seed == 12)
        jstate, jm = jstep.lora_train_step(jstate, jax.tree.map(jnp.asarray, b), jq, CFG, 2.0,
                                           jopt, True)
        tstate, tm_ = tstep.lora_train_step(tstate, _tbatch(b), tq, T_CFG, 2.0, topt, True)
        for name in ("loss", "ce_loss", "z_loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(float(tm_[name]), float(jm[name]), rtol=1e-5,
                                       err_msg=name)
    want = dict(tstep.leaves(jax.tree.map(np.asarray, jstate.params)))
    init = dict(tstep.leaves(jl))
    for path, t in tstep.leaves(tstate.params):
        step = want[path] - init[path]
        err = np.linalg.norm(t.detach().numpy() - want[path])
        assert err <= 2e-3 * np.linalg.norm(step) + 1e-12, (path, err)


# ------------------------------------------------------------ train() and the CLI


def _dataset(tmp_path, n=8):
    d = tmp_path / "ds"
    d.mkdir(parents=True, exist_ok=True)
    with open(d / "train.jsonl", "w") as f:
        for i in range(n):
            f.write(json.dumps({"messages": [
                {"role": "user", "content": [{"type": "text", "text": f"question {i}?"}]},
                {"role": "assistant", "content": [{"type": "text", "text": f"answer {i}!"}]}],
                "images": None, "video": None}) + "\n")
    return str(d)


def test_train_qlora_runs_and_the_loss_falls(tmp_path):
    """``train()`` with ``use_peft`` and ``quantize_base`` on the CPU: four
    steps, finite losses that fall (tests/test_train_loop.py:71-82 for the
    JAX loop), the adapters trained, the int8 base never saved."""
    r = Recipe(output_dir=str(tmp_path / "out"), dataset_mixer={_dataset(tmp_path): 1.0},
               per_device_train_batch_size=2, gradient_accumulation_steps=1, num_train_epochs=1,
               max_seq_length=64, learning_rate=1e-2, gradient_checkpointing=True,
               dtype="float32", logging_steps=1, use_peft=True, lora_r=4, lora_alpha=8,
               quantize_base=True)
    state = train(r, cfg=T_CFG, max_steps=4, device="cpu")
    assert state.step == 4
    lines = [json.loads(line) for line in open(os.path.join(r.output_dir, "metrics.jsonl"))]
    assert len(lines) == 4 and all(np.isfinite(line["loss"]) for line in lines)
    assert lines[-1]["loss"] < lines[0]["loss"]
    assert set(state.params["lm"]["layers"]) >= {"w1", "w2", "wqkv"}


def test_cli_takes_quantize_base_and_freeze_vit(monkeypatch):
    """``--quantize_base true`` and ``--freeze_vit false`` reach ``train()``
    through the recipe's overrides, with no path of their own."""
    import aria_tpu_torch.train.loop as loop
    from aria_tpu_torch.cli.train import main

    seen = {}
    monkeypatch.setattr(loop, "train", lambda r, **kw: seen.update(recipe=r, **kw))
    main(["--config", os.path.join(ROOT, "recipes", "config_lora.yaml"), "--tiny", "--cpu",
          "--quantize_base", "true", "--freeze_vit", "false"])
    r = seen["recipe"]
    assert r.quantize_base is True and r.freeze_vit is False and r.use_peft is True
    assert seen["device"] == "cpu"
