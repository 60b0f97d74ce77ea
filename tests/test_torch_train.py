"""The port's training pieces against the JAX package, on the CPU: the
causal flash attention's gradients, the router's losses, the capacity path
with expert LoRA, ``experts_ragged``'s gradients (megablox ``gmm`` and
``tgmm`` in interpret mode on the JAX side, the port's plain ``gmm_dlhs``
and ``tgmm`` here), the whole model's training loss and gradients (full
and LoRA, with and without remat), and the two repairs that came with
training: ``linear``'s f32 product and RoPE at 8,192 tokens.

Inputs are made with numpy from a seed. The model is ``AriaConfig.tiny()``
in f32 (hidden 64, 4 heads x 16, 8 + 2 experts top-2): products are f32
on both sides and differ only in their order of summation, so values and
gradients agree to 1e-4 relative (2e-5 absolute where a gradient is near
0).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aria_tpu.config import AriaConfig
from aria_tpu.models import aria as jaria
from aria_tpu.ops import backend as jbackend
from aria_tpu.ops import moe as jmoe
from aria_tpu.ops.flash import flash_sdpa
from aria_tpu.ops.rope import apply_rope as j_apply_rope
from aria_tpu.ops.rope import precompute_rope as j_precompute_rope
from aria_tpu.train import lora as jlora
from aria_tpu_torch.checkpoint.from_jax import from_jax, to_tensor
from aria_tpu_torch.config import config_from_dict
from aria_tpu_torch.models import aria as taria
from aria_tpu_torch.ops import flash as tfl
from aria_tpu_torch.ops import moe as tmoe
from aria_tpu_torch.ops import quant as tquant
from aria_tpu_torch.ops.rope import apply_rope, precompute_rope
from aria_tpu_torch.train import lora as tlora
from aria_tpu_torch.train.step import leaves

torch.set_num_threads(1)
CFG = AriaConfig.tiny()
T_CFG = config_from_dict(dataclasses.asdict(CFG))
RTOL, ATOL = 1e-4, 2e-5


@pytest.fixture(scope="module")
def interpret():
    old = os.environ.get("ARIA_TPU_KERNELS")
    os.environ["ARIA_TPU_KERNELS"] = "interpret"
    jbackend.kernel_backend.cache_clear()
    yield
    if old is None:
        os.environ.pop("ARIA_TPU_KERNELS", None)
    else:
        os.environ["ARIA_TPU_KERNELS"] = old
    jbackend.kernel_backend.cache_clear()


def _t(a, grad=False) -> torch.Tensor:
    t = to_tensor(np.asarray(a), device="cpu")
    return t.requires_grad_() if grad else t


def _close(got: torch.Tensor, want, name="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=name)


def _routing(rng, T, E, k, used):
    """[T, k] distinct expert ids drawn from ``used`` and softmax weights."""
    ids = np.stack([rng.choice(used, k, replace=False) for _ in range(T)]).astype(np.int32)
    w = rng.rand(T, k).astype(np.float32) + 0.1
    return ids, w / w.sum(1, keepdims=True)


# ------------------------------------------------------------ causal flash


@pytest.mark.parametrize("S", [16, 75])
def test_flash_causal_grads_match_jax(S):
    """Value and q/k/v gradients of the causal attention against jax.grad
    of flash_sdpa(causal=True) (its XLA path off the TPU)."""
    rng = np.random.RandomState(S)
    q, k, v, g = (rng.randn(2, S, 3, 16).astype(np.float32) for _ in range(4))

    def jloss(q, k, v):
        return jnp.sum(flash_sdpa(q, k, v, causal=True) * g)

    jout = flash_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = tfl.flash_causal(tq, tk, tv)
    _close(out, jout, "out")
    grads = torch.autograd.grad(out, (tq, tk, tv), _t(g))
    for name, got, want in zip("qkv", grads, jgrads):
        _close(got, want, f"d{name}")
    plain = tfl.flash_causal_bwd_plain(_t(q), _t(k), _t(v), _t(g))
    for got, want in zip(plain, grads):
        torch.testing.assert_close(got, want)


# ------------------------------------------------------------ router and experts


def test_route_topk_losses_and_grads_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(40, 32).astype(np.float32)
    gate = rng.randn(8, 32).astype(np.float32) * 0.3
    kw = dict(z_loss_coeff=1e-3, aux_loss_coeff=1e-2, training=True)

    def jloss(x, gate):
        r = jmoe.route_topk(x, gate, 2, **kw)
        return r.z_loss + r.aux_loss + jnp.sum(r.weights * jnp.arange(2.0)), r

    (jl, jr), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(x, gate)
    tx, tg = _t(x, True), _t(gate, True)
    r = tmoe.route_topk(tx, tg, 2, **kw)
    _close(r.z_loss, jr.z_loss, "z_loss")
    _close(r.aux_loss, jr.aux_loss, "aux_loss")
    np.testing.assert_array_equal(r.indices.numpy(), np.asarray(jr.indices))
    loss = r.z_loss + r.aux_loss + torch.sum(r.weights * torch.arange(2.0))
    for got, want, name in zip(torch.autograd.grad(loss, (tx, tg)), jg, ("dx", "dgate")):
        _close(got, want, name)
    ev = tmoe.route_topk(tx, tg, 2)
    assert float(ev.z_loss) == 0.0 and float(ev.aux_loss) == 0.0


@pytest.mark.parametrize("lora", [False, True])
def test_experts_grouped_and_grads_match_jax(lora):
    """The capacity path, with the per-expert LoRA factors inside the GLU."""
    rng = np.random.RandomState(1)
    T, D, I, E, k, r = 24, 32, 16, 6, 2, 4
    x = rng.randn(T, D).astype(np.float32)
    ids, w = _routing(rng, T, E, k, np.arange(E))
    w1 = rng.randn(E, 2 * I, D).astype(np.float32) * D**-0.5
    w2 = rng.randn(E, I, D).astype(np.float32) * I**-0.5
    lw = {"w1": {"a": rng.randn(E, D, r), "b": rng.randn(E, r, 2 * I) * 0.1},
          "w2": {"a": rng.randn(E, I, r), "b": rng.randn(E, r, D) * 0.1}} if lora else {}
    lw = jax.tree.map(lambda a: np.asarray(a, np.float32), lw)
    g = rng.randn(T, D).astype(np.float32)

    def jf(x, w1, w2, lw):
        out = jmoe.experts_grouped(x, jnp.asarray(ids), w, w1, w2, lora_w1=lw.get("w1"),
                                   lora_w2=lw.get("w2"), lora_scale=2.0)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(jf, argnums=(0, 1, 2, 3), has_aux=True)(x, w1, w2, lw)
    tx, tw1, tw2 = _t(x, True), _t(w1, True), _t(w2, True)
    tlw = jax.tree.map(lambda a: _t(a, True), lw)
    out = tmoe.experts_grouped(tx, torch.as_tensor(ids), _t(w), tw1, tw2,
                               lora_w1=tlw.get("w1"), lora_w2=tlw.get("w2"), lora_scale=2.0)
    _close(out, jout, "out")
    named = [("x", tx), ("w1", tw1), ("w2", tw2)] + leaves(tlw)
    got = torch.autograd.grad(out, [t for _, t in named], _t(g))
    want = [jgrads[0], jgrads[1], jgrads[2]] + [a for _, a in leaves(jgrads[3])]
    for (name, _), a, b in zip(named, got, want):
        _close(a, b, name)


def test_experts_gather_and_grads_match_jax():
    """The few-token path (at most 32 tokens in training)."""
    rng = np.random.RandomState(9)
    T, D, I, E, k = 12, 32, 16, 6, 2
    x = rng.randn(T, D).astype(np.float32)
    ids, w = _routing(rng, T, E, k, np.arange(E))
    w1 = rng.randn(E, 2 * I, D).astype(np.float32) * D**-0.5
    w2 = rng.randn(E, I, D).astype(np.float32) * I**-0.5
    g = rng.randn(T, D).astype(np.float32)

    def jf(x, w, w1, w2):
        out = jmoe.experts_gather(x, jnp.asarray(ids), w, w1, w2)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(jf, argnums=(0, 1, 2, 3), has_aux=True)(x, w, w1, w2)
    args = [_t(a, True) for a in (x, w, w1, w2)]
    out = tmoe.experts_gather(args[0], torch.as_tensor(ids), *args[1:])
    _close(out, jout, "out")
    for name, got, want in zip(("x", "weights", "w1", "w2"),
                               torch.autograd.grad(out, args, _t(g)), jgrads):
        _close(got, want, name)


def test_experts_ragged_grads_match_megablox():
    """experts_ragged's value and its gradients in x, the combine weights, w1
    and w2: the JAX side's megablox gmm and tgmm interpreted, the port's
    gmm_dlhs and tgmm plain versions; two experts get no rows and the
    sorted rows are padded to 128 (T k = 60)."""
    rng = np.random.RandomState(2)
    T, D, I, E, k = 30, 32, 16, 8, 2
    x = rng.randn(T, D).astype(np.float32)
    ids, w = _routing(rng, T, E, k, np.array([0, 2, 3, 4, 6, 7]))
    w1 = rng.randn(E, 2 * I, D).astype(np.float32) * D**-0.5
    w2 = rng.randn(E, I, D).astype(np.float32) * I**-0.5
    g = rng.randn(T, D).astype(np.float32)

    def jf(x, w, w1, w2):
        out = jmoe.experts_ragged(x, jnp.asarray(ids), w, w1, w2, interpret=True)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(jf, argnums=(0, 1, 2, 3), has_aux=True)(x, w, w1, w2)
    args = [_t(a, True) for a in (x, w, w1, w2)]
    out = tmoe.experts_ragged(args[0], torch.as_tensor(ids), args[1], args[2], args[3])
    _close(out, jout, "out")
    for name, got, want in zip(("x", "weights", "w1", "w2"),
                               torch.autograd.grad(out, args, _t(g)), jgrads):
        _close(got, want, name)
    assert not args[2].grad_fn  # leaves
    np.testing.assert_array_equal(np.asarray(jgrads[2])[[1, 5]], 0)


def test_tgmm_plain_gives_zero_slices_for_empty_groups():
    rng = np.random.RandomState(3)
    lhs, grad = _t(rng.randn(12, 4).astype(np.float32)), _t(rng.randn(12, 5).astype(np.float32))
    sizes = torch.tensor([0, 5, 0, 7], dtype=torch.int32)
    out = tmoe.tgmm_plain(lhs, grad, sizes)
    assert out.shape == (4, 4, 5)
    assert torch.equal(out[0], torch.zeros(4, 5)) and torch.equal(out[2], torch.zeros(4, 5))
    torch.testing.assert_close(out[3], lhs[5:].T @ grad[5:])


# ------------------------------------------------------------ the whole model


def _batch(seed, B=2, S=40):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, CFG.text.vocab_size, (B, S)).astype(np.int32)
    labels = ids.copy()
    labels[:, :5] = -100
    labels[1, -7:] = -100
    return {"input_ids": ids, "labels": labels}


@pytest.fixture(scope="module")
def model(interpret):
    """(JAX params f32, the port's from them, JAX LoRA tree with nonzero B,
    the port's)."""
    params = jaria.init_aria_params(jax.random.PRNGKey(0), CFG, dtype=jnp.float32)
    lc = jlora.LoraConfig(rank=4, alpha=8.0)
    lora = jlora.init_lora_params(jax.random.PRNGKey(1), CFG, lc)
    rng = np.random.RandomState(4)
    lora = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32),
                        lora)
    np_params = jax.tree.map(np.asarray, params)
    return np_params, from_jax(np_params, device="cpu"), lora, from_jax(lora, device="cpu")


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("peft", [False, True])
def test_training_loss_and_grads_match_jax(model, peft, remat):
    """aria_forward(training=True) + causal_lm_loss and its gradients: the
    decoder's in full fine-tuning (the ragged MoE at 80 tokens), the
    adapters' in LoRA (the capacity path with expert LoRA)."""
    jparams, tparams, jl, tl = model
    batch = _batch(5)
    scale = 2.0

    def jloss(trainable):
        p, lo = (jparams, trainable) if peft else ({**jparams, "lm": trainable}, None)
        out = jaria.aria_forward(p, CFG, jnp.asarray(batch["input_ids"]), training=True,
                                 lora=lo, lora_scale=scale, remat=remat)
        losses = jaria.causal_lm_loss(out, jnp.asarray(batch["labels"]))
        return losses.loss, losses

    (jloss_v, jlosses), jg = jax.value_and_grad(jloss, has_aux=True)(jl if peft else
                                                                     jparams["lm"])
    trainable = tl if peft else tparams["lm"]
    named = leaves(trainable)
    for _, t in named:
        t.requires_grad_(True)
    try:
        out = taria.aria_forward(tparams, T_CFG, torch.as_tensor(batch["input_ids"]).long(),
                                 training=True, lora=tl if peft else None, lora_scale=scale,
                                 remat=remat)
        losses = taria.causal_lm_loss(out, torch.as_tensor(batch["labels"]).long())
        grads = torch.autograd.grad(losses.loss, [t for _, t in named])
    finally:
        for _, t in named:
            t.requires_grad_(False)
    for name in ("loss", "ce_loss", "z_loss", "aux_loss"):
        _close(getattr(losses, name), getattr(jlosses, name), name)
    assert float(losses.z_loss) > 0 and float(losses.aux_loss) > 0
    want = dict(leaves(jax.tree.map(np.asarray, jg)))
    for (path, _), got in zip(named, grads):
        _close(got, want[path], path, atol=1e-5)


def test_lora_zero_b_is_the_base_and_merge_folds_it(model):
    """B = 0 adapters change nothing; merged adapters give the runtime ones'
    logits (tests/test_lora.py:38-68)."""
    jparams, tparams, _, tl = model
    toks = torch.as_tensor(_batch(6)["input_ids"]).long()
    lc = tlora.LoraConfig(rank=4, alpha=8.0)
    zero = {"lm": {"layers": {n: {"a": ab["a"], "b": torch.zeros_like(ab["b"])}
                              for n, ab in tl["lm"]["layers"].items()}}}
    base = taria.aria_forward(tparams, T_CFG, toks, training=True).logits
    torch.testing.assert_close(taria.aria_forward(tparams, T_CFG, toks, training=True, lora=zero,
                                                  lora_scale=lc.scale).logits, base)
    runtime = taria.aria_forward(tparams, T_CFG, toks, training=True, lora=tl,
                                 lora_scale=lc.scale).logits
    merged = tlora.merge_lora(tparams, tl, lc)
    folded = taria.aria_forward(merged, T_CFG, toks, training=True).logits
    torch.testing.assert_close(folded, runtime, rtol=1e-4, atol=1e-4)
    jmerged = jlora.merge_lora(jparams, jax.tree.map(jnp.asarray, model[2]),
                               jlora.LoraConfig(rank=4, alpha=8.0))
    for path, t in leaves(merged["lm"]):
        _close(t, dict(leaves(jax.tree.map(np.asarray, jmerged["lm"])))[path], path)


def test_init_trees_have_the_jax_structure():
    gen = torch.Generator().manual_seed(0)
    got = taria.init_aria_params(T_CFG, gen, device="cpu", dtype=torch.float32)
    want = jax.tree.map(np.asarray, jaria.init_aria_params(jax.random.PRNGKey(0), CFG,
                                                           dtype=jnp.float32))
    assert [(p, tuple(t.shape), t.dtype) for p, t in leaves(got)] == \
        [(p, a.shape, torch.float32) for p, a in leaves(want)]
    lgot = tlora.init_lora_params(T_CFG, tlora.LoraConfig(rank=4), gen, device="cpu")
    lwant = jlora.init_lora_params(jax.random.PRNGKey(1), CFG, jlora.LoraConfig(rank=4))
    assert [(p, tuple(t.shape)) for p, t in leaves(lgot)] == \
        [(p, a.shape) for p, a in leaves(jax.tree.map(np.asarray, lwant))]
    assert all(float(t.abs().sum()) == 0 for p, t in leaves(lgot) if p.endswith("/b"))
    assert tlora.get_lora_target_modules(tlora.LoraConfig(freeze_llm=True)) == ()


def test_from_jax_carries_training_and_lora_trees(model):
    jparams, tparams, jl, tl = model
    for want, got in ((jparams, tparams), (jl, tl)):
        w = dict(leaves(want))
        for path, t in leaves(got):
            np.testing.assert_array_equal(t.numpy(), w[path], err_msg=path)


# ------------------------------------------------------------ the repairs


def test_linear_products_are_f32_from_bf16_operands():
    """(f): bf16 operands give the f32 product (exact products, f32 sums),
    not one rounded to bf16, as preferred_element_type=jnp.float32 asks."""
    rng = np.random.RandomState(7)
    x = torch.as_tensor(rng.randn(3, 5, 256).astype(np.float32)).bfloat16()
    w = torch.as_tensor(rng.randn(256, 96).astype(np.float32)).bfloat16()
    want = torch.einsum("bsd,df->bsf", x.double(), w.double()).float()
    got = tquant.linear(x, w)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)
    q = tquant.quantize_weight(w.float())
    want_q = torch.einsum("bsd,df->bsf", x.double(), q["q"].double()).float() * q["s"]
    torch.testing.assert_close(tquant.linear(x, q), want_q, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("S", [8191, 8192])
def test_rope_long_sequences_rotate_in_the_input_dtype(S):
    """(g): from 8,192 tokens on the rotation runs in bf16 as rope.py:38
    does, bit for bit with the JAX function; below, in f32 and rounded
    once (XLA may fuse a product into the subtraction: one bf16 ulp)."""
    rng = np.random.RandomState(S)
    x = jnp.asarray(rng.randn(1, S, 2, 32).astype(np.float32), jnp.bfloat16)
    cos, sin = j_precompute_rope(jnp.arange(S), 32, CFG.text.rope_base)
    want = np.asarray(j_apply_rope(x, cos, sin))
    tcos, tsin = precompute_rope(torch.arange(S), 32, CFG.text.rope_base)
    got = apply_rope(_t(np.asarray(x)), tcos, tsin)
    assert got.dtype == torch.bfloat16
    if S < 8192:
        np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), rtol=2**-8,
                                   atol=1e-5)
    else:
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


@pytest.mark.parametrize("peft", [False, True])
def test_training_with_an_image_matches_jax(model, peft):
    """A 98px image through the frozen ViT and the projector into 8 image
    tokens: the loss, and the gradients of the adapters (LoRA) or of the
    decoder and the projector (full fine-tuning; the ViT is frozen and its
    gradients are not compared)."""
    jparams, tparams, jl, tl = model
    rng = np.random.RandomState(8)
    pixels = rng.uniform(-1, 1, (1, 3, 98, 98)).astype(np.float32)
    ids = rng.randint(20, CFG.text.vocab_size, (1, 24)).astype(np.int32)
    ids[0, 4:12] = CFG.image_token_id
    labels = np.where(ids == CFG.image_token_id, -100, ids).astype(np.int32)

    def jloss(trainable):
        if peft:
            p, lo = jparams, trainable
        else:
            p, lo = {**jparams, "lm": trainable["lm"], "projector": trainable["projector"]}, None
        out = jaria.aria_forward(p, CFG, jnp.asarray(ids), jnp.asarray(pixels), training=True,
                                 lora=lo, lora_scale=2.0)
        return jaria.causal_lm_loss(out, jnp.asarray(labels)).loss

    jtrain = jl if peft else {"lm": jparams["lm"], "projector": jparams["projector"]}
    jv, jg = jax.value_and_grad(jloss)(jtrain)
    ttrain = tl if peft else {"lm": tparams["lm"], "projector": tparams["projector"]}
    named = leaves(ttrain)
    for _, t in named:
        t.requires_grad_(True)
    try:
        out = taria.aria_forward(tparams, T_CFG, torch.as_tensor(ids).long(), _t(pixels),
                                 training=True, lora=tl if peft else None, lora_scale=2.0)
        loss = taria.causal_lm_loss(out, torch.as_tensor(labels).long()).loss
        grads = torch.autograd.grad(loss, [t for _, t in named])
    finally:
        for _, t in named:
            t.requires_grad_(False)
    _close(loss, jv, "loss")
    want = dict(leaves(jax.tree.map(np.asarray, jg)))
    for (path, _), got in zip(named, grads):
        _close(got, want[path], path, atol=1e-5)
