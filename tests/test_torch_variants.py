"""The JAX package's kernel-variant switches in the port, against the JAX
package on the CPU.

The JAX package reads three off-by-default A/B switches from the
environment at trace time; the port reads module constants that hold the
same defaults:

- ``ARIA_TPU_DENSE_A8=1`` / ``models.moe_lm.DENSE_A8``: W4A8 wqkv and wo
  (``dense_int4(act_int8=True)``) for a step of at most 32 rows;
- ``ARIA_TPU_A8=0`` / ``models.moe_lm.MOE_A8 = False``: the int4 decode MoE
  with bf16 activations (``moe_decode_int4(act_int8=False)``);
- ``ARIA_TPU_VIT_FLASH=0`` / ``models.vit.VIT_FLASH = False``: the ViT's
  attention through ``flash_sdpa`` with the padding as segment ids.

The ``variants`` fixture turns all three on, each side its own way, and
clears the JAX caches around the test (the switches are read at trace
time). The JAX side runs with ``ARIA_TPU_KERNELS=interpret``, where its
``flash_sdpa`` takes the masked-sdpa path (flash.py:44-59), so it is
compared on valid rows only; the port runs its plain versions. The small
configs are test_torch_image.py's (the text side's I = 128, a multiple of
128, so the JAX model takes its decode-MoE kernel).
"""

import dataclasses
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aria_tpu.config import AriaConfig, ProjectorConfig, TextConfig, VisionConfig
from aria_tpu.engine.generate import Engine as JEngine
from aria_tpu.engine.generate import GenerationConfig as JGen
from aria_tpu.engine.server import BatchedEngine as JBatchedEngine
from aria_tpu.models import aria as jaria
from aria_tpu.models import moe_lm as jm
from aria_tpu.models import projector as jproj
from aria_tpu.models import vit as jvit
from aria_tpu.ops import backend as jbackend
from aria_tpu.ops import quant as jquant
from aria_tpu.ops.dense_int4 import dense_int4 as j_dense_int4
from aria_tpu.ops.dense_int4 import quantize_dense_int4 as j_quantize_dense_int4
from aria_tpu.ops.flash import flash_sdpa as j_flash_sdpa
from aria_tpu.ops.moe_decode_kernel import act_quant_int8 as j_act_quant_int8
from aria_tpu.ops.moe_decode_kernel import moe_decode_int4 as j_moe_decode_int4
from aria_tpu.ops.quant import dequantize_w1_int4 as j_dequantize_w1_int4
from aria_tpu.ops.quant import dequantize_w2_int4 as j_dequantize_w2_int4
from aria_tpu.ops.quant import quantize_expert_int4 as j_quantize_expert_int4
from aria_tpu.ops.vit_flash import vit_flash_enabled
from aria_tpu_torch.checkpoint.from_jax import from_jax
from aria_tpu_torch.config import config_from_dict
from aria_tpu_torch.engine.generate import Engine, GenerationConfig
from aria_tpu_torch.engine.server import BatchedEngine
from aria_tpu_torch.models import aria as taria
from aria_tpu_torch.models import moe_lm as tm
from aria_tpu_torch.models import vit as tvit
from aria_tpu_torch.ops import dense_int4 as di
from aria_tpu_torch.ops import flash as tfl
from aria_tpu_torch.ops import moe_decode_kernel as mk

torch.set_num_threads(1)

VISION = VisionConfig(hidden_size=144, num_layers=2, num_heads=2, intermediate_size=288,
                      patch_size=14, image_size=224)
PROJ = ProjectorConfig(patch_to_query=((256, 128),), embed_dim=144, num_heads=2, kv_dim=144,
                       ff_dim=288, output_dim=256)
TEXT = TextConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2,
                  num_kv_heads=2, head_dim=128, num_experts=8, moe_topk=2,
                  moe_intermediate_size=128, num_shared_experts=2, max_seq_len=512)
CFG = AriaConfig(vision=VISION, projector=PROJ, text=TEXT)
T_CFG = config_from_dict(dataclasses.asdict(CFG))  # the port's own config, field for field
T_VISION, T_TEXT = T_CFG.vision, T_CFG.text
PROMPT = [11] * 8 + [CFG.image_token_id] * 128 + [13] * 8
SWITCHES = {"ARIA_TPU_DENSE_A8": "1", "ARIA_TPU_A8": "0", "ARIA_TPU_VIT_FLASH": "0"}


def _t(a) -> torch.Tensor:
    return from_jax(np.asarray(a), device="cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


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


@pytest.fixture
def variants(monkeypatch, interpret):
    """All three switches on: the JAX variables for the JAX side, the
    module constants for the port. Returns the calls the port's model made
    to the three dispatch points, by kind."""
    for name, value in SWITCHES.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(tm, "DENSE_A8", True)
    monkeypatch.setattr(tm, "MOE_A8", False)
    monkeypatch.setattr(tvit, "VIT_FLASH", False)
    seen = {"dense": [], "moe": [], "vit": 0}

    def dense(x, w, layer, act_int8=False):
        seen["dense"].append((x.shape[0], act_int8))
        return di.dense_int4(x, w, layer, act_int8=act_int8)

    def moe(*args, act_int8=False):
        seen["moe"].append((args[0].shape[0], act_int8))
        return mk.moe_decode_int4(*args, act_int8=act_int8)

    def flash(*args, **kw):
        seen["vit"] += 1
        return tfl.flash_sdpa(*args, **kw)

    monkeypatch.setattr(tm, "dense_int4", dense)
    monkeypatch.setattr(tm, "moe_decode_int4", moe)
    monkeypatch.setattr(tvit, "flash_sdpa", flash)
    monkeypatch.setattr(tvit, "vit_flash", None)  # must not be reached
    jbackend.kernel_backend.cache_clear()
    jax.clear_caches()
    yield seen
    jax.clear_caches()


@pytest.fixture(scope="module")
def lm_params(interpret):
    """The int4 serving LM at f32 with a float embedding table, as
    test_torch_slice.py builds it."""
    lm = jm.init_lm_params_serving_int4(jax.random.PRNGKey(3), TEXT, dtype=jnp.float32)
    lm["embed"] = jquant.dequantize_weight(lm["embed"], dtype=jnp.float32)
    return lm, from_jax(_np(lm), device="cpu")


@pytest.fixture(scope="module")
def vision_f32(interpret):
    vis = jvit.init_vit_params(jax.random.PRNGKey(1), VISION, jnp.float32)
    proj = jproj.init_projector_params(jax.random.PRNGKey(2), PROJ, jnp.float32)
    return {"vision": vis, "projector": proj}, from_jax(_np({"vision": vis, "projector": proj}),
                                                        device="cpu")


@pytest.fixture(scope="module")
def served(lm_params):
    """bench.py's image serving form: int8 ViT and projector from a bf16
    init beside the f32 int4 LM."""
    lm, tlm = lm_params
    vis = jquant.quantize_vit_params(jvit.init_vit_params(jax.random.PRNGKey(1), VISION))
    proj = jquant.quantize_projector_params(
        jproj.init_projector_params(jax.random.PRNGKey(2), PROJ))
    tvis = from_jax(_np({"vision": vis, "projector": proj}), device="cpu")
    return {"vision": vis, "projector": proj, "lm": lm}, {**tvis, "lm": tlm}


def _pixels(seed, n=1):
    return np.random.RandomState(seed).randint(0, 256, (n, 3, 224, 224), dtype=np.uint8)


# ------------------------------------------------------------ the switches


def test_switches_hold_the_jax_defaults(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    # the JAX package's reads with nothing set (moe_lm.py:334, :967, vit_flash.py:43)
    assert tm.DENSE_A8 is (os.environ.get("ARIA_TPU_DENSE_A8", "0") == "1") is False
    assert tm.MOE_A8 is (os.environ.get("ARIA_TPU_A8", "1") != "0") is True
    assert tvit.VIT_FLASH is vit_flash_enabled() is True
    # the wrappers' keywords and their defaults are the JAX functions'
    for port, jax_fn, name in ((mk.moe_decode_int4, j_moe_decode_int4, "act_int8"),
                               (di.dense_int4, j_dense_int4, "act_int8"),
                               (tfl.flash_sdpa, j_flash_sdpa, "causal"),
                               (tfl.flash_sdpa, j_flash_sdpa, "q_valid"),
                               (tfl.flash_sdpa, j_flash_sdpa, "kv_valid"),
                               (tfl.flash_sdpa, j_flash_sdpa, "scale")):
        want = inspect.signature(jax_fn).parameters[name].default
        assert inspect.signature(port).parameters[name].default == want, (port, name)


# ------------------------------------------------------------ W4A8 dense_int4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 5, 32])
def test_act_quant_int8_matches_jax_bits(T, dtype):
    rng = np.random.RandomState(T)
    x = rng.randn(T, 1280).astype(np.float32) * rng.uniform(0.1, 4, (T, 1))
    ng = 5  # int4_group_count(1280)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    ref_q, ref_s = jax.jit(j_act_quant_int8, static_argnums=1)(xj, ng)
    got_q, got_s = mk.act_quant_int8(torch.from_numpy(np.array(xj.astype(jnp.float32)))
                                     .to(getattr(torch, dtype)), ng)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))


@pytest.fixture(scope="module")
def dense_case():
    rng = np.random.RandomState(4)
    D, F = 1280, 512  # 5 D-groups of 256, as at flagship width; F whole 256-column tiles
    w = jnp.asarray((rng.randn(2, D, F) * D**-0.5).astype(np.float32))
    wq = j_quantize_dense_int4(w)
    return rng, D, wq, {k: _t(v) for k, v in wq.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 5, 32])
def test_dense_int4_a8_matches_jax(dense_case, T, dtype):
    rng, D, wq, tw = dense_case
    x = jnp.asarray(rng.randn(T, D).astype(np.float32), getattr(jnp, dtype))
    ref = np.asarray(j_dense_int4(x, wq, jnp.int32(1), tn=256, interpret=True, act_int8=True))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, dtype))
    got = di.dense_int4(xt, tw, 1, act_int8=True)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), di.dense_int4_a8_plain(xt, tw, 1).numpy())
    # the integer dots are exact on both sides and the f32 steps ((G * sx)
    # * sg, summed over the groups in ascending order) are the same: at
    # most the last f32 ulp of a step that XLA fuses
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    # the switch matters: int8 activations against bf16 ones, ~1% apart
    bf = di.dense_int4(xt, tw, 1).numpy()
    assert 1e-4 < _rel(got.numpy(), bf) < 2e-2


def test_dense_a8_takes_steps_of_at_most_32_rows(dense_case, monkeypatch):
    """The model's projections are W4A8 only under DENSE_A8 and only for a
    step of at most 32 rows (moe_lm.py:334): bit for bit the A8 product at
    32 rows, the bf16 one at 33 and with the switch off."""
    rng, D, _, tw = dense_case
    for on, T, a8 in ((True, 32, True), (True, 33, False), (False, 1, False)):
        monkeypatch.setattr(tm, "DENSE_A8", on)
        x = torch.from_numpy(rng.randn(T, D).astype(np.float32)).to(torch.bfloat16)
        want = di.dense_int4_a8_plain(x, tw, 1) if a8 else di.dense_int4(x, tw, 1)
        np.testing.assert_array_equal(tm._project(x, tw, 1).numpy(), want.numpy())


# ------------------------------------------------------------ bf16-activation MoE


@pytest.fixture(scope="module")
def moe_case():
    rng = np.random.RandomState(1)
    L, D, E, I = 2, 1280, 10, 128  # 5 D-groups of 256, as at flagship width
    w1 = (rng.randn(L, E, 2 * I, D) * D**-0.5).astype(np.float32)
    w2 = (rng.randn(L, E, I, D) * I**-0.5).astype(np.float32)
    q1, q2 = j_quantize_expert_int4(jnp.asarray(w1), jnp.asarray(w2))
    experts = (_t(q1["q4"]), _t(q1["sg"]), _t(q2["q4"]), _t(q2["s8"]))
    return rng, D, E, (q1["q4"], q1["sg"], q2["q4"], q2["s8"]), experts


def _routing(rng, T, E, ns=2, k=2):
    """top-k of E - ns routed experts plus ns always-on shared experts."""
    logits = rng.randn(T, E - ns)
    idx = np.argsort(-logits, axis=1)[:, :k]
    shared = np.broadcast_to(np.arange(E - ns, E), (T, ns))
    w = np.concatenate([rng.dirichlet(np.ones(k), T), np.ones((T, ns))], axis=1)
    return np.concatenate([idx, shared], 1).astype(np.int32), w.astype(np.float32)


@pytest.mark.parametrize("T", [1, 8, 32])
def test_moe_decode_int4_bf16_matches_jax(moe_case, T):
    rng, D, E, experts_j, experts = moe_case
    x = rng.randn(T, D).astype(np.float32)
    ind, w = _routing(rng, T, E)
    ref = np.asarray(j_moe_decode_int4(jnp.asarray(x), jnp.asarray(ind), jnp.asarray(w),
                                       *experts_j, jnp.int32(1), ft=128, interpret=True,
                                       act_int8=False))
    args = (torch.from_numpy(x), torch.from_numpy(ind), torch.from_numpy(w), *experts, 1)
    got = mk.moe_decode_int4(*args, act_int8=False)
    np.testing.assert_array_equal(got.numpy(), mk.moe_decode_int4_bf16_plain(*args).numpy())
    # JAX's own tolerance for the kernel against the dequantized gather
    # (tests/test_kernels.py:63-78); at f32 the JAX identity's (xb/16 - xa)
    # is all but exact, so the two agree far inside it
    np.testing.assert_allclose(got.numpy(), ref, rtol=5e-3, atol=5e-3)
    assert np.abs(got.numpy() - ref).max() < 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("T", [1, 5, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_decode_int4_bf16_routed_plain_is_the_plain_version(moe_case, T, dtype):
    """The routed-pair statement of the bf16-activation int4 FFN (what
    csrc/moe_decode_bf16x.cu computes) gives the bits of the plain version
    over every unique expert."""
    rng, D, E, _, experts = moe_case
    ind, w = _routing(rng, T, E)
    args = (torch.from_numpy(rng.randn(T, D).astype(np.float32)).to(dtype),
            torch.from_numpy(ind), torch.from_numpy(w).to(dtype), *experts, 1)
    got = mk.moe_decode_int4_bf16_routed_plain(*args)
    ref = mk.moe_decode_int4_bf16_plain(*args)
    assert got.dtype == ref.dtype == dtype
    assert torch.equal(got, ref)


@pytest.mark.parametrize("T", [1, 8, 32])
def test_moe_decode_int4_bf16_is_the_int4_ffn(moe_case, T):
    """At bf16 the port computes the GLU-FFN over the int4 weights: held to
    exact dequantized math (f64, h rounded to bf16 as the kernel does). The
    JAX kernel's bf16 rounding of (xb/16 - xa) is a fault of the reference
    (ROADMAP queue 3, (d)) and is not pinned: its gap is reported beside
    the bound."""
    rng, D, E, experts_j, experts = moe_case
    layer = 1
    ind, w = _routing(rng, T, E)
    xb = torch.from_numpy(rng.randn(T, D).astype(np.float32)).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    got = mk.moe_decode_int4(xb, torch.from_numpy(ind), wb, *experts, layer)
    assert got.dtype == torch.bfloat16
    q1 = {"q4": experts_j[0][layer], "sg": experts_j[1][layer]}
    q2 = {"q4": experts_j[2][layer], "s8": experts_j[3][layer]}
    w1 = np.asarray(j_dequantize_w1_int4(q1, jnp.float32), np.float64)  # [E, 2I, D]
    w2 = np.asarray(j_dequantize_w2_int4(q2, jnp.float32), np.float64)  # [E, I, D]
    I = w2.shape[1]
    x64, w64 = xb.double().numpy(), wb.double().numpy()
    exact = np.zeros((T, D))
    for t in range(T):
        for s, e in enumerate(ind[t]):
            gate, up = w1[e, :I] @ x64[t], w1[e, I:] @ x64[t]
            h = torch.tensor(gate / (1 + np.exp(-gate)) * up).to(torch.bfloat16).double().numpy()
            exact[t] += w64[t, s] * (h @ w2[e])
    ref_j = np.asarray(j_moe_decode_int4(
        jnp.asarray(xb.float().numpy(), jnp.bfloat16), jnp.asarray(ind),
        jnp.asarray(wb.float().numpy(), jnp.bfloat16), *experts_j, jnp.int32(layer), ft=128,
        interpret=True, act_int8=False), np.float64)
    rel = _rel(got.double().numpy(), exact)
    witness = _rel(ref_j, exact)
    # the bf16 output rounding (2^-9 relative per element) and rare one-ulp
    # flips of h where f32 and f64 sums straddle a bf16 rounding edge
    print(f"relative error to exact int4 math: port {rel:.3e}, JAX kernel {witness:.3e}")
    assert rel < 3e-3, f"port {rel:.3e} (JAX kernel's gap: {witness:.3e})"


# ------------------------------------------------------------ flash with segment ids


def test_flash_sdpa_matches_jax_on_valid_rows():
    rng = np.random.RandomState(1)
    B, S, H, D = 2, 300, 2, 72
    q, k, v = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    lens = [300, 137]
    valid = np.arange(S)[None, :] < np.array(lens)[:, None]
    ref = np.asarray(j_flash_sdpa(*(jnp.asarray(a) for a in (q, k, v)),
                                  q_valid=jnp.asarray(valid), kv_valid=jnp.asarray(valid)))
    tq, tk, tv, tvalid = (torch.from_numpy(a) for a in (q, k, v, valid))
    got = tfl.flash_sdpa(tq, tk, tv, q_valid=tvalid, kv_valid=tvalid).numpy()
    np.testing.assert_array_equal(got, tfl.flash_sdpa_plain(tq, tk, tv, tvalid, tvalid).numpy())
    # f32: summation order only
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got[b, :n], ref[b, :n], rtol=2e-5, atol=2e-5)
    # pad queries (segment 0) attend pad keys only
    n = lens[1]
    s = np.einsum("qhd,khd->hqk", q[1, n:], k[1, n:]) / np.sqrt(D)
    p = np.exp(s - s.max(-1, keepdims=True))
    pad = np.einsum("hqk,khd->qhd", p / p.sum(-1, keepdims=True), v[1, n:])
    np.testing.assert_allclose(got[1, n:], pad, rtol=2e-5, atol=2e-5)


def test_flash_sdpa_forms():
    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rng.randn(1, 40, 2, 128).astype(np.float32)) for _ in range(3))
    # causal from position 0 is flash_causal's
    torch.testing.assert_close(tfl.flash_sdpa(q, k, v, causal=True),
                               tfl.flash_causal_plain(q, k, v), rtol=0, atol=0)
    with pytest.raises(NotImplementedError):
        tfl.flash_sdpa(q, k, v, causal=True, kv_valid=torch.ones((1, 40), dtype=torch.bool))
    # without masks every key is admitted: the plain softmax
    want = np.asarray(j_flash_sdpa(*(jnp.asarray(t.numpy()) for t in (q, k, v))))
    np.testing.assert_allclose(tfl.flash_sdpa(q, k, v).numpy(), want, rtol=2e-5, atol=2e-5)
    # one segment's queries see nothing of the other's keys: moving a pad
    # key moves no valid row
    valid = torch.arange(40)[None] < 25
    a = tfl.flash_sdpa(q, k, v, q_valid=valid, kv_valid=valid)
    k2 = k.clone()
    k2[:, 30] += 5.0
    b = tfl.flash_sdpa(q, k2, v, q_valid=valid, kv_valid=valid)
    assert torch.equal(a[:, :25], b[:, :25]) and not torch.equal(a[:, 25:], b[:, 25:])


# ------------------------------------------------------------ the model with the variants on


@pytest.mark.parametrize("ragged", [False, True])
def test_vit_with_segment_flash_matches_jax(vision_f32, variants, ragged):
    params, tparams = vision_f32
    rng = np.random.RandomState(4)
    pv = rng.randn(2, 3, 224, 224).astype(np.float32)
    pm = np.ones((2, 224, 224), bool)
    if ragged:
        pm[1, :, 126:] = False  # a 224 x 126 image padded right: 144 real patches
    ref = jvit.vit_forward(params["vision"], VISION, jnp.asarray(pv), jnp.asarray(pm))
    got = tvit.vit_forward(tparams["vision"], T_VISION, torch.from_numpy(pv),
                           torch.from_numpy(pm))
    assert variants["vit"] == VISION.num_layers
    valid = np.asarray(ref.patch_mask)
    np.testing.assert_array_equal(got.patch_mask.numpy(), valid)
    # f32 throughout; padding patches attend each other in the port and the
    # valid keys in the JAX fallback, and are compared nowhere
    np.testing.assert_allclose(got.features.numpy()[valid], np.asarray(ref.features)[valid],
                               rtol=1e-4, atol=1e-4)


def test_encode_images_with_the_variants_matches_jax(vision_f32, variants):
    params, tparams = vision_f32
    pixels = _pixels(6, n=2)
    ref = jax.jit(lambda p, pv: jaria.encode_images(p, CFG, pv))(params, jnp.asarray(pixels))
    got = taria.encode_images(tparams, T_CFG, torch.from_numpy(pixels))
    assert variants["vit"] == VISION.num_layers
    assert got.shape == ref.shape == (2, 128, PROJ.output_dim)
    # f32 (the projector's output): summation order only
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_lm_prefill_and_decode_with_the_variants_match_jax(lm_params, variants):
    """A 2-lane prefill of 32 tokens (64 rows: bf16 wqkv / wo, the
    bf16-activation MoE), then two decode steps (2 rows: W4A8 wqkv / wo,
    the bf16-activation MoE), on an f32 cache."""
    lm, tlm = lm_params
    rng = np.random.RandomState(5)
    toks = rng.randint(1, 512, (2, 32)).astype(np.int32)
    new = rng.randint(1, 512, (2, 2)).astype(np.int32)
    cache = jm.KVCache.init(TEXT, 2, 128, jnp.float32)
    out = jm.lm_forward(lm, TEXT, jnp.asarray(toks), positions=jnp.arange(32), cache=cache,
                        cache_pos=jnp.int32(0), causal_flash=True)
    refs = [np.asarray(out.logits)]
    cache = out.cache
    for i in range(2):
        out = jm.lm_forward(lm, TEXT, jnp.asarray(new[:, i:i + 1]),
                            positions=jnp.asarray([32 + i]), cache=cache,
                            cache_pos=jnp.int32(32 + i))
        refs.append(np.asarray(out.logits))
        cache = out.cache
    gots = []
    with torch.inference_mode():
        tcache = tm.KVCache.init(T_TEXT, 2, 128, torch.float32, device="cpu")
        gots.append(tm.lm_forward(tlm, T_TEXT, torch.from_numpy(toks).long(),
                                  positions=torch.arange(32), cache=tcache, cache_pos=0,
                                  causal_flash=True).logits.numpy())
        for i in range(2):
            gots.append(tm.lm_forward(tlm, T_TEXT, torch.from_numpy(new[:, i:i + 1]).long(),
                                      positions=torch.tensor([32 + i]), cache=tcache,
                                      cache_pos=32 + i).logits.numpy())
    L = TEXT.num_layers
    assert variants["dense"] == [(64, False)] * 2 * L + [(2, True)] * 2 * L * 2
    assert variants["moe"] == [(64, False)] * L + [(2, False)] * L * 2
    # f32, the MoE's products exact on both sides: the prefill (bf16
    # projections) agrees to f32 rounding, seen 1.2e-5 relative
    assert gots[0].shape == refs[0].shape
    assert _rel(gots[0], refs[0]) < 1e-4
    # W4A8 rounds the decode step's projection inputs to int8, and a value
    # on a rounding edge flips by one step on one side only (~1e-6
    # upstream differences): a lane with a flip was seen at 1e-3 to 4.6e-3
    # relative (over six prompt seeds), one without at 5e-6 to 9e-6, and a
    # wrong scale or layout is O(1). Each step: the whole within 1e-2, and
    # a lane without a flip at f32 level.
    for got, ref in zip(gots[1:], refs[1:]):
        assert got.shape == ref.shape
        lanes = [_rel(got[b], ref[b]) for b in range(2)]
        assert _rel(got, ref) < 1e-2 and min(lanes) < 1e-4, lanes


def test_image_greedy_stream_with_the_variants_matches_jax(served, variants):
    params, tparams = served
    pixels = _pixels(9)
    jr = JEngine(params, CFG, max_seq_len=512, cache_dtype=jnp.int8).generate(
        PROMPT, JGen(max_new_tokens=12, temperature=0.0, decode_chunk=6), pixel_values=pixels)
    tr = Engine(tparams, T_CFG, max_seq_len=512, cache_dtype=torch.int8).generate(
        PROMPT, GenerationConfig(max_new_tokens=12, temperature=0.0, decode_chunk=6),
        pixel_values=pixels)
    assert variants["vit"] == VISION.num_layers
    assert any(a8 for _, a8 in variants["dense"]) and not any(a8 for _, a8 in variants["moe"])
    assert len(tr.tokens) == 12
    assert tr.tokens == jr.tokens


def test_batched_greedy_streams_with_the_variants_match_jax(lm_params, variants):
    lm, tlm = lm_params
    rng = np.random.RandomState(6)
    prompts = [rng.randint(1, 512, n).tolist() for n in (5, 14, 40, 9)]

    def serve(engine):
        uids = [engine.submit(p, max_new_tokens=8) for p in prompts]
        fin = {r.uid: r for r in engine.run_until_complete()}
        return [fin[u].generated for u in uids]

    want = serve(JBatchedEngine({"lm": lm}, CFG, max_lanes=3, max_seq_len=128, decode_chunk=3,
                                cache_dtype=jnp.int8))
    got = serve(BatchedEngine({"lm": tlm}, T_CFG, max_lanes=3, max_seq_len=128, decode_chunk=3,
                              cache_dtype=torch.int8))
    assert any(a8 for _, a8 in variants["dense"]) and not any(a8 for _, a8 in variants["moe"])
    assert all(len(g) == 8 for g in got)
    assert got == want
