"""Training the ViT, and attention masks in training, in the port against
the JAX package, on the CPU: the gradient of ``flash_segment``'s plain
version against ``jax.grad`` of ``flash_sdpa(q_valid=, kv_valid=)``; the
ViT's training route (a graph at 256 patches or more takes
``flash_segment``'s differentiable form whatever ``VIT_FLASH`` says);
full fine-tuning with ``freeze_vit=False`` (the loss and the gradients of
the ViT, the projector and the decoder, and three ``train_step``
updates); the loss and gradients under an ``attn_mask``; and ``train()``
with ``freeze_vit: false`` end to end.

The ViT is 2 layers of 2 heads of 72 at hidden 144 over a 224px image
(256 patches, the flash threshold), the decoder ``AriaConfig.tiny()``'s,
everything f32. The JAX side runs without kernels (``ARIA_TPU_KERNELS``
xla): its ViT then attends through ``sdpa`` with the padding as a key
mask, the differentiable path of ``ARIA_TPU_VIT_FLASH=0`` off the TPU.
Pad queries attend the valid keys there and pad keys in the port (the
library kernel's segment semantics): pad rows' outputs differ by design,
and every gradient agrees wherever the cotangent on pad rows is zero,
which the projector (it ignores pad patches) makes so inside the model;
the kernel-level tests feed zero cotangents on pad rows for that reason.
Products are f32 on both sides in another order of summation: 1e-4
relative, 1e-5 absolute.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax  # noqa: F401  (the JAX train_step's optimizer)
import pytest
import torch
from PIL import Image

from aria_tpu.config import AriaConfig, ProjectorConfig, VisionConfig
from aria_tpu.models import aria as jaria
from aria_tpu.ops import backend as jbackend
from aria_tpu.ops.flash import flash_sdpa as j_flash_sdpa
from aria_tpu.train import step as jstep
from aria_tpu_torch.checkpoint.from_jax import from_jax
from aria_tpu_torch.config import config_from_dict
from aria_tpu_torch.data.tokenizer import ByteTokenizer
from aria_tpu_torch.models import aria as taria
from aria_tpu_torch.models import vit as tvit
from aria_tpu_torch.ops import flash as tfl
from aria_tpu_torch.train import step as tstep
from aria_tpu_torch.train.loop import train
from aria_tpu_torch.train.recipe import Recipe

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-5
VISION = VisionConfig(hidden_size=144, num_layers=2, num_heads=2, intermediate_size=288,
                      patch_size=14, image_size=224)
PROJ = ProjectorConfig(patch_to_query=((256, 16),), embed_dim=144, num_heads=2, kv_dim=144,
                       ff_dim=288, output_dim=64)
CFG = AriaConfig.tiny().replace(vision=VISION, projector=PROJ)
T_CFG = config_from_dict(dataclasses.asdict(CFG))
N_IMG = 16  # image tokens of a 224px image


@pytest.fixture(scope="module", autouse=True)
def xla():
    old = os.environ.get("ARIA_TPU_KERNELS")
    os.environ["ARIA_TPU_KERNELS"] = "xla"
    jbackend.kernel_backend.cache_clear()
    yield
    if old is None:
        os.environ.pop("ARIA_TPU_KERNELS", None)
    else:
        os.environ["ARIA_TPU_KERNELS"] = old
    jbackend.kernel_backend.cache_clear()


def _close(got, want, name="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=name)


# ------------------------------------------------------------ flash_segment


def _segment_masks(B, S, valid):
    """(Sk, q_valid, kv_valid) as numpy bools: None (every position valid),
    a prefix of each length, "crop" (a 980 x 630 crop's patches on the
    square grid: each grid row's first 10 of 16 valid at S = 256, padding
    inside every tile), or ("kv", Sk, q lengths, kv lengths) for Sk != S."""
    if valid == "crop":
        side = int(S**0.5)
        grid = np.zeros((side, side), bool)
        grid[:, :side * 630 // 980] = True
        mask = np.broadcast_to(grid.reshape(1, S), (B, S)).copy()
        return S, mask, mask
    Sk, q_lens, kv_lens = (valid[1], valid[2], valid[3]) if valid and valid[0] == "kv" \
        else (S, valid, valid)

    def prefix(n, lens):
        m = np.ones((B, n), bool)
        for b, ln in enumerate(lens or ()):
            m[b, ln:] = False
        return m

    return Sk, prefix(S, q_lens), prefix(Sk, kv_lens)


@pytest.mark.parametrize("B,S,H,D,valid", [(1, 256, 2, 64, None), (2, 300, 2, 72, (300, 137)),
                                           (1, 256, 4, 72, None), (2, 260, 2, 64, (200, 256)),
                                           (1, 256, 2, 72, "crop"),
                                           (2, 129, 2, 72, ("kv", 300, (129, 60), (300, 137)))])
def test_flash_segment_plain_grads_match_jax(B, S, H, D, valid):
    """(dq, dk, dv) of the port's segment attention against ``jax.grad`` of
    the JAX ``flash_sdpa(q_valid, kv_valid)``, the cotangent zero on pad
    rows; and ``flash_segment`` on the CPU records the same graph. The
    masks are the ViT's: a prefix (a landscape crop), the interleaved mask
    of a portrait crop, and queries over keys of another length."""
    rng = np.random.RandomState(S + D)
    Sk, qmask, kvmask = _segment_masks(B, S, valid)
    q, k, v, do = (rng.randn(B, n, H, D).astype(np.float32) for n in (S, Sk, Sk, S))
    do = do * qmask[:, :, None, None]
    jq, jkv = jnp.asarray(qmask), jnp.asarray(kvmask)
    _, vjp = jax.vjp(lambda a, b, c: j_flash_sdpa(a, b, c, q_valid=jq, kv_valid=jkv),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tkv = torch.as_tensor(qmask), torch.as_tensor(kvmask)
    got = tfl.flash_segment_bwd_plain(*map(torch.as_tensor, (q, k, v)), torch.as_tensor(do), tq,
                                      tkv)
    for n, a, w in zip("qkv", got, want):
        _close(a, w, f"d{n}")
    leaves = [torch.as_tensor(t).requires_grad_() for t in (q, k, v)]
    out = tfl.flash_segment(*leaves, tq, tkv)
    for a, b in zip(torch.autograd.grad(out, leaves, torch.as_tensor(do)), got):
        torch.testing.assert_close(a, b)


# ------------------------------------------------------------ the ViT's route


def _image(seed, valid_cols=224, n=1):
    rng = np.random.RandomState(seed)
    pixels = rng.uniform(-1, 1, (n, 3, 224, 224)).astype(np.float32)
    mask = np.zeros((n, 224, 224), bool)
    mask[:, :, :valid_cols] = True
    return pixels, mask


@pytest.fixture(scope="module")
def model():
    params = jaria.init_aria_params(jax.random.PRNGKey(0), CFG, dtype=jnp.float32)
    np_params = jax.tree.map(np.asarray, params)
    return np_params, from_jax(np_params, device="cpu")


def test_vit_training_route_takes_flash_segment(model, monkeypatch):
    """With autograd on and a vision leaf asking for a gradient, 256
    patches and ``VIT_FLASH`` on, every layer's attention goes through
    ``flash_segment``'s differentiable form and none through ``vit_flash``;
    without autograd (serving) the same call takes ``vit_flash``."""
    _, tparams = model
    calls = {"segment": 0, "vit_flash": 0}
    segment, vit_flash = tfl.flash_segment, tvit.vit_flash

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tfl, "flash_segment", count("segment", segment))
    monkeypatch.setattr(tvit, "vit_flash", count("vit_flash", vit_flash))
    monkeypatch.setattr(tvit, "VIT_FLASH", True)
    pixels, mask = (torch.as_tensor(a) for a in _image(1, 140))
    wq = tparams["vision"]["layers"]["wq"]
    wq.requires_grad_(True)
    try:
        feats = taria.encode_images(tparams, T_CFG, pixels, mask)
        assert feats.requires_grad
        (g,) = torch.autograd.grad(feats.sum(), wq)
        assert torch.isfinite(g).all() and float(g.abs().sum()) > 0
    finally:
        wq.requires_grad_(False)
    assert calls == {"segment": VISION.num_layers, "vit_flash": 0}
    with torch.inference_mode():
        taria.encode_images(tparams, T_CFG, pixels, mask)
    assert calls == {"segment": VISION.num_layers, "vit_flash": VISION.num_layers}


# ------------------------------------------------------------ full fine-tuning with the ViT


def _batch(seed, B=2, S=40, valid_cols=140):
    """Row 0 carries the image's 16 tokens; its last columns are padding."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(20, CFG.text.vocab_size, (B, S)).astype(np.int32)
    ids[0, 3:3 + N_IMG] = CFG.image_token_id
    labels = np.where(ids == CFG.image_token_id, -100, ids).astype(np.int32)
    labels[:, :2] = -100
    pixels, mask = _image(seed, valid_cols)
    return {"input_ids": ids, "labels": labels, "pixel_values": pixels, "pixel_mask": mask}


def _tbatch(b):
    return {k: torch.as_tensor(v).long() if v.dtype == np.int32 else torch.as_tensor(v)
            for k, v in b.items()}


@pytest.mark.parametrize("valid_cols", [224, 140])
def test_full_finetune_with_the_vit_matches_jax(model, valid_cols):
    """``loss_fn``'s loss and the gradients of every leaf (ViT, projector,
    decoder) against ``jax.value_and_grad`` of the JAX ``loss_fn``, with the
    image whole and with its last 6 patch columns padding."""
    jparams, tparams = model
    batch = _batch(3, valid_cols=valid_cols)
    (jl, jlosses), jg = jax.value_and_grad(jstep.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, jparams), CFG, jax.tree.map(jnp.asarray, batch))
    named = tstep.leaves(tparams)
    for _, t in named:
        t.requires_grad_(True)
    try:
        loss, losses = tstep.loss_fn(tparams, T_CFG, _tbatch(batch))
        grads = torch.autograd.grad(loss, [t for _, t in named])
    finally:
        for _, t in named:
            t.requires_grad_(False)
    for name in ("loss", "ce_loss", "z_loss", "aux_loss"):
        _close(getattr(losses, name), getattr(jlosses, name), name)
    want = dict(tstep.leaves(jax.tree.map(np.asarray, jg)))
    vision = 0
    for (path, _), g in zip(named, grads):
        _close(g, want[path], path)
        vision += path.startswith("vision/") and float(g.abs().sum()) > 0
    assert vision > 10  # the ViT's gradients are not all zero


# The ViT's key bias adds q . bk to every score of a query row, which the
# softmax cancels: its gradient is 0 but for rounding (~1e-9 here), and
# Adam's g / (sqrt(v) + eps) turns that rounding into steps of either sign
# on either side. Its update is held to three of Adam's steps instead.
SHIFT_INVARIANT = ("vision/layers/bk",)


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_with_the_vit_matches_optax(model, remat):
    """Three ``train_step`` micro steps with ``freeze_vit=False`` and the
    projector trained (no frozen tower gets a gradient: the JAX package
    would move one by its raw gradient), images in every batch, against
    the JAX ``train_step``: the metrics, and each leaf's change to 2e-3 of
    its norm (Adam amplifies f32 rounding where a gradient is near 0)."""
    jparams, _ = model
    kw = dict(learning_rate=1e-3, weight_decay=0.1, grad_clip_norm=0.5, b2=0.95, total_steps=4,
              freeze_vit=False, freeze_projector=False, gradient_checkpointing=remat)
    jtc, tc = jstep.TrainConfig(**kw), tstep.TrainConfig(**kw)
    params = jax.tree.map(jnp.asarray, jparams)
    jstate, jopt = jstep.init_train_state(params, jtc)
    tparams = from_jax(jparams, device="cpu")
    topt = tstep.make_optimizer(tc, tparams)
    assert all(topt.mask[p] for p, _ in tstep.leaves(tparams) if p.startswith("vision/"))
    tstate = tstep.TrainState(tparams, topt.init(tparams), 0)
    for seed in (21, 22, 23):
        b = _batch(seed, valid_cols=140 if seed % 2 else 224)
        jstate, jm = jstep.train_step(jstate, jax.tree.map(jnp.asarray, b), CFG, jtc, jopt)
        tstate, tm_ = tstep.train_step(tstate, _tbatch(b), T_CFG, tc, topt)
        for name in ("loss", "ce_loss", "z_loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(float(tm_[name]), float(jm[name]), rtol=1e-5,
                                       err_msg=name)
    want = dict(tstep.leaves(jax.tree.map(np.asarray, jstate.params)))
    init = dict(tstep.leaves(jparams))
    moved = 0
    for path, t in tstep.leaves(tstate.params):
        step = want[path] - init[path]
        if path in SHIFT_INVARIANT:
            assert np.abs(t.detach().numpy() - init[path]).max() <= 3 * 2 * kw["learning_rate"]
            continue
        err = np.linalg.norm(t.detach().numpy() - want[path])
        assert err <= 2e-3 * np.linalg.norm(step) + 1e-12, (path, err, np.linalg.norm(step))
        moved += path.startswith("vision/") and np.linalg.norm(step) > 0
    assert moved > 10


# ------------------------------------------------------------ attention masks


def _attn_mask(B, S, starts):
    """[B, 1, S, S]: causal, and the keys before each row's start (its left
    padding) masked."""
    causal = np.tril(np.ones((S, S), bool))
    keys = np.arange(S)[None, :] >= np.asarray(starts)[:, None]
    return causal[None, None] & keys[:, None, None, :]


@pytest.mark.parametrize("starts", [(0, 0), (0, 13)])
def test_loss_and_grads_under_an_attn_mask_match_jax(model, starts):
    """``loss_fn`` with ``batch["attn_mask"]`` (causal, and causal with a
    left-padded row) against the JAX ``loss_fn``: the loss and the
    decoder's gradients; the plain masked attention replaces the causal
    flash path."""
    jparams, tparams = model
    B, S = 2, 40
    rng = np.random.RandomState(31)
    ids = rng.randint(20, CFG.text.vocab_size, (B, S)).astype(np.int32)
    labels = ids.copy()
    labels[1, :starts[1]] = -100
    batch = {"input_ids": ids, "labels": labels, "attn_mask": _attn_mask(B, S, starts)}
    (jl, jlosses), jg = jax.value_and_grad(
        lambda lm: jstep.loss_fn({**jax.tree.map(jnp.asarray, jparams), "lm": lm}, CFG,
                                 jax.tree.map(jnp.asarray, batch)), has_aux=True)(
        jax.tree.map(jnp.asarray, jparams["lm"]))
    named = tstep.leaves(tparams["lm"])
    for _, t in named:
        t.requires_grad_(True)
    try:
        tb = {"input_ids": torch.as_tensor(ids).long(), "labels": torch.as_tensor(labels).long(),
              "attn_mask": torch.as_tensor(batch["attn_mask"])}
        loss, losses = tstep.loss_fn(tparams, T_CFG, tb)
        grads = torch.autograd.grad(loss, [t for _, t in named])
    finally:
        for _, t in named:
            t.requires_grad_(False)
    _close(losses.loss, jlosses.loss, "loss")
    want = dict(tstep.leaves(jax.tree.map(np.asarray, jg)))
    for (path, _), g in zip(named, grads):
        _close(g, want[path], path)
    if starts[1]:  # the mask is not the causal one: the loss moves
        tb["attn_mask"] = None
        assert abs(float(tstep.loss_fn(tparams, T_CFG, tb)[0]) - float(loss.detach())) > 1e-4


# ------------------------------------------------------------ train()


def test_train_with_freeze_vit_false_runs_and_the_loss_falls(tmp_path, monkeypatch):
    """``train()`` of the full recipe's settings with ``freeze_vit: false``
    on 490px image rows (a 2-layer ViT of hidden 32 over 1,225 patches,
    128 image tokens): four steps, finite losses that fall, the ViT moved,
    its attention through ``flash_segment``."""
    d = tmp_path / "ds"
    d.mkdir()
    rng = np.random.RandomState(5)
    with open(d / "train.jsonl", "w") as f:
        for i in range(8):
            Image.fromarray(rng.randint(0, 256, (300, 400, 3), dtype=np.uint8)).save(
                d / f"im{i}.png")
            f.write(json.dumps({"messages": [
                {"role": "user", "content": [{"type": "image"},
                                             {"type": "text", "text": f"what is {i}?"}]},
                {"role": "assistant", "content": [{"type": "text", "text": f"it is {i}."}]}],
                "images": [f"im{i}.png"], "video": None}) + "\n")
    tiny = AriaConfig.tiny()
    cfg = config_from_dict(dataclasses.asdict(tiny.replace(
        vision=dataclasses.replace(tiny.vision, image_size=490),
        projector=dataclasses.replace(tiny.projector, patch_to_query=((1225, 128),)),
        image_token_id=ByteTokenizer().image_token_id)))
    calls = []
    segment = tfl.flash_segment
    monkeypatch.setattr(tfl, "flash_segment", lambda *a, **kw: calls.append(1) or segment(*a, **kw))
    r = Recipe(output_dir=str(tmp_path / "out"), dataset_mixer={str(d): 1.0},
               per_device_train_batch_size=2, gradient_accumulation_steps=1, num_train_epochs=1,
               max_seq_length=192, max_image_size=490, learning_rate=1e-3,
               gradient_checkpointing=True, dtype="float32", logging_steps=1, freeze_vit=False,
               freeze_projector=False)
    before = {p: t.clone() for p, t in tstep.leaves(
        taria.init_aria_params(cfg, torch.Generator().manual_seed(r.seed), device="cpu",
                               dtype=torch.float32)["vision"])}
    state = train(r, cfg=cfg, max_steps=4, device="cpu")
    assert state.step == 4 and len(calls) == 4 * cfg.vision.num_layers
    lines = [json.loads(line) for line in open(os.path.join(r.output_dir, "metrics.jsonl"))]
    assert len(lines) == 4 and all(np.isfinite(line["loss"]) for line in lines)
    assert lines[-1]["loss"] < lines[0]["loss"]
    after = dict(tstep.leaves(state.params["vision"]))
    assert sum(not torch.equal(after[p], t) for p, t in before.items()) > 10
