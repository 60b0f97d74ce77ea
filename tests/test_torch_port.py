"""The PyTorch port (aria_tpu_torch) against the JAX package: imports,
quantizer bytes, weight interchange and the small ops, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aria_tpu.config import TextConfig
from aria_tpu.engine import generate as jgenerate
from aria_tpu.engine import sampling as jsampling
from aria_tpu.models import moe_lm as jm
from aria_tpu.ops import attention as jattn
from aria_tpu.ops import dense_int4 as jdense
from aria_tpu.ops import moe as jmoe
from aria_tpu.ops import norms as jnorms
from aria_tpu.ops import quant as jquant
from aria_tpu.ops import rope as jrope
from aria_tpu_torch import config as tconfig
from aria_tpu_torch.checkpoint.from_jax import from_jax, to_tensor
from aria_tpu_torch.engine import generate as tgenerate
from aria_tpu_torch.engine import sampling as tsampling
from aria_tpu_torch.models import moe_lm as tm
from aria_tpu_torch.ops import attention as tattn
from aria_tpu_torch.ops import moe as tmoe
from aria_tpu_torch.ops import norms as tnorms
from aria_tpu_torch.ops import quant as tquant
from aria_tpu_torch.ops import rope as trope

torch.set_num_threads(1)
PKG = Path(__file__).resolve().parent.parent / "aria_tpu_torch"


def _np(x):
    return np.asarray(x)


def _t(x):
    return to_tensor(np.asarray(x), device="cpu")


def _bytes_equal(t: torch.Tensor, j) -> bool:
    """Same dtype and the same bytes (bf16 compared as its bit pattern)."""
    ref = to_tensor(np.asarray(j), device="cpu")
    if t.dtype != ref.dtype or t.shape != ref.shape:
        return False
    if t.dtype == torch.bfloat16:
        return torch.equal(t.view(torch.int16), ref.view(torch.int16))
    return torch.equal(t, ref)


# ------------------------------------------------------------ jax-free import


def test_import_pulls_in_no_jax():
    code = (
        "import sys, importlib, pkgutil, aria_tpu_torch\n"
        "for m in pkgutil.walk_packages(aria_tpu_torch.__path__, 'aria_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=PKG.parent)


def test_no_module_imports_jax():
    for path in PKG.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            assert not (words[:2] == ["import", "jax"] or words[:2] == ["from", "jax"]
                        or (words[:1] == ["from"] and len(words) > 1
                            and words[1].startswith("jax."))), f"{path}: {line}"


# ------------------------------------------------------------ quantizers


@pytest.mark.parametrize("group", [2, 16, 256, 512])
def test_pack_int4_bytes_match_jax(group):
    q = np.random.RandomState(0).randint(-8, 8, (3, 4, 1024)).astype(np.int8)
    packed = tquant.pack_int4(torch.from_numpy(q), group)
    assert _bytes_equal(packed, jquant.pack_int4(jnp.asarray(q), group))
    assert torch.equal(tquant.unpack_int4(packed, group, torch.float32),
                       torch.from_numpy(q.astype(np.float32)))


@pytest.mark.parametrize("input_axis", [-2, -1])
def test_quantize_weight_matches_jax(input_axis):
    w = np.random.RandomState(1).randn(3, 96, 80).astype(np.float32)
    got = tquant.quantize_weight(torch.from_numpy(w), input_axis=input_axis)
    ref = jquant.quantize_weight(jnp.asarray(w), input_axis=input_axis)
    assert _bytes_equal(got["q"], ref["q"]) and _bytes_equal(got["s"], ref["s"])
    deq = tquant.dequantize_weight(got, input_axis=input_axis, dtype=torch.float32)
    np.testing.assert_array_equal(
        deq.numpy(), _np(jquant.dequantize_weight(ref, input_axis=input_axis,
                                                  dtype=jnp.float32)))
    assert got["q"].is_contiguous() and got["s"].is_contiguous()


@pytest.mark.parametrize("D", [256, 512, 2560])
def test_quantize_expert_int4_matches_jax(D):
    rng = np.random.RandomState(2)
    I = 64
    w1 = (rng.randn(2, 3, 2 * I, D) * D**-0.5).astype(np.float32)
    w2 = (rng.randn(2, 3, I, D) * I**-0.5).astype(np.float32)
    g1, g2 = tquant.quantize_expert_int4(torch.from_numpy(w1), torch.from_numpy(w2))
    r1, r2 = jquant.quantize_expert_int4(jnp.asarray(w1), jnp.asarray(w2))
    for got, ref in ((g1, r1), (g2, r2)):
        assert set(got) == set(ref)
        for leaf in got:
            assert _bytes_equal(got[leaf], ref[leaf]), leaf
            assert got[leaf].is_contiguous(), leaf
    for dtype_t, dtype_j in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        assert _bytes_equal(tquant.dequantize_w1_int4(g1, dtype_t),
                            jquant.dequantize_w1_int4(r1, dtype_j))
        assert _bytes_equal(tquant.dequantize_w2_int4(g2, dtype_t),
                            jquant.dequantize_w2_int4(r2, dtype_j))


@pytest.mark.parametrize("D,F", [(256, 768), (2560, 512)])
def test_quantize_dense_int4_matches_jax(D, F):
    w = (np.random.RandomState(3).randn(2, D, F) * D**-0.5).astype(np.float32)
    got = tquant.quantize_dense_int4(torch.from_numpy(w))
    ref = jdense.quantize_dense_int4(jnp.asarray(w))
    for leaf in ("q4t", "sg"):
        assert _bytes_equal(got[leaf], ref[leaf]), leaf
        assert got[leaf].is_contiguous(), leaf
    assert _bytes_equal(tquant.dequantize_dense_int4(got, torch.float32),
                        jdense.dequantize_dense_int4(ref, jnp.float32))


def test_int4_group_count_matches_jax():
    for D in (64, 256, 512, 768, 1152, 2560, 4096, 5120):
        assert tquant.int4_group_count(D) == jquant.int4_group_count(D)


def test_linear_matches_jax():
    rng = np.random.RandomState(4)
    x, w = rng.randn(2, 5, 64).astype(np.float32), rng.randn(64, 48).astype(np.float32)
    qw = jquant.quantize_weight(jnp.asarray(w))
    ref = jquant.linear(jnp.asarray(x), qw, "bsd,dv->bsv")
    got = tquant.linear(torch.from_numpy(x), from_jax(jax.tree.map(_np, qw), device="cpu"))
    # f32 products of exact int8 values; only the summation order differs
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ interchange


def test_from_jax_keeps_every_leaf_byte_for_byte():
    cfg = TextConfig(vocab_size=64, hidden_size=256, num_layers=2, num_heads=2,
                     num_kv_heads=2, head_dim=128, num_experts=4, moe_topk=2,
                     moe_intermediate_size=128, num_shared_experts=2)
    tree = jax.tree.map(_np, jm.init_lm_params_serving_int4(jax.random.PRNGKey(0), cfg))
    got = from_jax(tree, device="cpu")
    flat_ref, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat_ref:
        t = got
        for key in path:
            t = t[key.key]
        assert _bytes_equal(t, leaf), jax.tree_util.keystr(path)
    assert got["layers"]["wqkv"]["sg"].dtype == torch.bfloat16
    assert got["layers"]["w1"]["q4"].dtype == torch.int8


def test_torch_init_has_the_jax_serving_structure():
    cfg = TextConfig(vocab_size=64, hidden_size=256, num_layers=2, num_heads=2,
                     num_kv_heads=2, head_dim=128, num_experts=4, moe_topk=2,
                     moe_intermediate_size=128, num_shared_experts=2)
    ref = jax.eval_shape(lambda k: jm.init_lm_params_serving_int4(k, cfg),
                         jax.random.PRNGKey(0))
    tcfg = tconfig.TextConfig(**dataclasses.asdict(cfg))  # the port's own copy
    got = tm.init_lm_params_serving_int4(tcfg, torch.Generator().manual_seed(0), device="cpu")
    flat_ref, _ = jax.tree_util.tree_flatten_with_path(ref)
    n = 0
    for path, leaf in flat_ref:
        t = got
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == tuple(leaf.shape), jax.tree_util.keystr(path)
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), jax.tree_util.keystr(path)
        n += 1
    assert n == len(jax.tree.leaves(got))


# ------------------------------------------------------------ small ops


def test_rms_norm_matches_jax():
    rng = np.random.RandomState(5)
    x, w = rng.randn(2, 7, 64).astype(np.float32), rng.randn(64).astype(np.float32)
    np.testing.assert_allclose(
        tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        _np(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)), rtol=1e-6, atol=1e-6)


def test_rope_matches_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 9, 3, 128).astype(np.float32)
    pos = rng.randint(0, 4000, (9,))
    cj, sj = jrope.precompute_rope(jnp.asarray(pos), 128, 5e6)
    ct, st = trope.precompute_rope(torch.from_numpy(pos), 128, 5e6)
    # f32 angles up to 4000 rad: pow and cos of two libraries differ in the
    # last ulp of the angle (~5e-4 rad at 4000 would be 1 ulp of position
    # times freq), seen as ~2e-6 in cos
    np.testing.assert_allclose(ct.numpy(), _np(cj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(st.numpy(), _np(sj), rtol=0, atol=1e-5)
    got = trope.apply_rope(torch.from_numpy(x), _t(cj), _t(sj))
    ref = jrope.apply_rope(jnp.asarray(x), cj, sj)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-6, atol=1e-6)


def test_sdpa_matches_jax():
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(2, 6, 2, 32).astype(np.float32) for _ in range(3))
    mask = np.tril(np.ones((6, 6), bool))[None, None]
    got = tattn.sdpa(*map(torch.from_numpy, (q, k, v)), torch.from_numpy(mask))
    ref = jattn.sdpa(*map(jnp.asarray, (q, k, v)), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-5, atol=1e-5)


def test_route_topk_and_glu_match_jax():
    rng = np.random.RandomState(8)
    x, gate = rng.randn(11, 64).astype(np.float32), rng.randn(8, 64).astype(np.float32)
    got = tmoe.route_topk(torch.from_numpy(x), torch.from_numpy(gate), 3)
    ref = jmoe.route_topk(jnp.asarray(x), jnp.asarray(gate), 3)
    np.testing.assert_array_equal(got.indices.numpy(), _np(ref.indices))
    np.testing.assert_allclose(got.weights.numpy(), _np(ref.weights), rtol=1e-6, atol=1e-6)
    h = rng.randn(5, 16).astype(np.float32)
    np.testing.assert_allclose(tmoe.glu(torch.from_numpy(h)).numpy(),
                               _np(jmoe.glu(jnp.asarray(h))), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ sampling


def test_sampling_filters_match_jax():
    rng = np.random.RandomState(9)
    logits = (rng.randn(3, 300) * 3).astype(np.float32)
    lt, lj = torch.from_numpy(logits), jnp.asarray(logits)
    np.testing.assert_array_equal(tsampling.filter_top_k(lt, 20).numpy(),
                                  _np(jsampling.filter_top_k(lj, 20, exact=True)))
    p = np.array([0.5, 0.9, 1.0], np.float32)
    np.testing.assert_array_equal(tsampling.filter_top_p(lt, torch.from_numpy(p)).numpy(),
                                  _np(jsampling.filter_top_p(lj, jnp.asarray(p))))
    mp = np.array([0.0, 0.05, 0.3], np.float32)
    np.testing.assert_array_equal(tsampling.filter_min_p(lt, torch.from_numpy(mp)).numpy(),
                                  _np(jsampling.filter_min_p(lj, jnp.asarray(mp))))


@pytest.mark.parametrize("n", [1, 32, 33, 48, 100, 128])
def test_prompt_bucket_matches_jax(n):
    assert tgenerate._bucket(n) == jgenerate._bucket(n)


def test_greedy_sample_is_argmax():
    logits = torch.from_numpy(np.random.RandomState(10).randn(4, 50).astype(np.float32))
    got = tsampling.sample(torch.Generator().manual_seed(0), logits, 0.0)
    assert got.dtype == torch.int32
    assert torch.equal(got, logits.argmax(-1).to(torch.int32))


def test_sampled_distribution_matches_jax():
    """threefry and Philox give different streams, so the two samplers are
    held to the same distribution: the filtered softmax. 6000 draws put the
    total-variation distance of each empirical histogram to it at ~0.03
    (sqrt(k / n) scale); 0.06 is the bound."""
    V, n, temp, k = 40, 6000, 0.8, 8
    logits = (np.random.RandomState(11).randn(1, V) * 2).astype(np.float32)
    scaled = logits[0] / temp
    kth = np.sort(scaled)[-k]
    probs = np.where(scaled >= kth, np.exp(scaled - scaled.max()), 0.0)
    probs /= probs.sum()

    gen = torch.Generator().manual_seed(0)
    lt = torch.from_numpy(np.repeat(logits, n, axis=0))
    got = tsampling.sample(gen, lt, temp, top_k=k).numpy()
    ref = _np(jsampling.sample(jax.random.PRNGKey(0), jnp.asarray(np.repeat(logits, n, 0)),
                               temp, top_k=k))
    for draws in (got, ref):
        hist = np.bincount(draws, minlength=V) / n
        assert set(np.nonzero(hist)[0]) <= set(np.nonzero(probs)[0])
        assert 0.5 * np.abs(hist - probs).sum() < 0.06
