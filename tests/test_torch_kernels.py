"""The port's four kernel modules against the JAX kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
its Pallas kernel in interpret mode, as tests/test_kernels.py does, in f32
at shapes where the kernels engage (D a multiple of 256, I = 128). The
CUDA kernels against their plain versions are in test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aria_tpu.ops.decode_attention import decode_attention as j_decode_attention
from aria_tpu.ops.dense_int4 import dense_int4 as j_dense_int4
from aria_tpu.ops.dense_int4 import quantize_dense_int4 as j_quantize_dense_int4
from aria_tpu.ops.flash import flash_sdpa as j_flash_sdpa
from aria_tpu.ops.moe_decode_kernel import _unique_meta as j_unique_meta
from aria_tpu.ops.moe_decode_kernel import act_quant_int8 as j_act_quant_int8
from aria_tpu.ops.moe_decode_kernel import moe_decode_int4 as j_moe_decode_int4
from aria_tpu.ops.quant import quantize_expert_int4 as j_quantize_expert_int4
from aria_tpu_torch.checkpoint.from_jax import to_tensor
from aria_tpu_torch.ops import decode_attention as da
from aria_tpu_torch.ops import dense_int4 as di
from aria_tpu_torch.ops import flash as fl
from aria_tpu_torch.ops import moe_decode_kernel as mk

torch.set_num_threads(1)


def _t(x):
    return to_tensor(np.asarray(x))


# ------------------------------------------------------------ dense_int4


@pytest.fixture(scope="module")
def dense_case():
    rng = np.random.RandomState(0)
    D, F = 512, 768
    w = (rng.randn(2, D, F) * D**-0.5).astype(np.float32)
    return rng, D, j_quantize_dense_int4(jnp.asarray(w))


@pytest.mark.parametrize("T,layer", [(1, 0), (5, 1), (64, 1)])
def test_dense_int4_matches_jax(dense_case, T, layer):
    rng, D, wj = dense_case
    x = rng.randn(T, D).astype(np.float32)
    ref = j_dense_int4(jnp.asarray(x), wj, jnp.int32(layer), tn=256, interpret=True)
    got = di.dense_int4(torch.from_numpy(x), {k: _t(v) for k, v in wj.items()}, layer)
    assert got.dtype == torch.float32 and got.shape == (T, wj["q4t"].shape[1])
    # f32 sums over D = 512 of exact products; the JAX kernel's biased-lo
    # split sums raw bytes and 16*hi, terms up to 16x the result's, so its
    # f32 rounding is that much coarser (seen: 3e-5 on values near 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ moe_decode_int4


@pytest.fixture(scope="module")
def moe_case():
    rng = np.random.RandomState(1)
    L, D, E, I = 2, 512, 10, 128
    w1 = (rng.randn(L, E, 2 * I, D) * D**-0.5).astype(np.float32)
    w2 = (rng.randn(L, E, I, D) * I**-0.5).astype(np.float32)
    q1, q2 = j_quantize_expert_int4(jnp.asarray(w1), jnp.asarray(w2))
    return rng, D, E, q1, q2


def _routing(rng, T, E, ns=2, k=2):
    """top-k of E - ns routed experts plus ns always-on shared experts."""
    logits = rng.randn(T, E - ns)
    idx = np.argsort(-logits, axis=1)[:, :k]
    shared = np.broadcast_to(np.arange(E - ns, E), (T, ns))
    w = np.concatenate([rng.dirichlet(np.ones(k), T), np.ones((T, ns))], axis=1)
    return np.concatenate([idx, shared], 1).astype(np.int32), w.astype(np.float32)


@pytest.mark.parametrize("T", [1, 5])
def test_moe_decode_int4_a8_matches_jax(moe_case, T):
    rng, D, E, q1, q2 = moe_case
    x = rng.randn(T, D).astype(np.float32)
    ind, w = _routing(rng, T, E)
    ref = j_moe_decode_int4(jnp.asarray(x), jnp.asarray(ind), jnp.asarray(w),
                            q1["q4"], q1["sg"], q2["q4"], q2["s8"], jnp.int32(1),
                            ft=128, interpret=True, act_int8=True)
    got = mk.moe_decode_int4(torch.from_numpy(x), torch.from_numpy(ind), torch.from_numpy(w),
                             _t(q1["q4"]), _t(q1["sg"]), _t(q2["q4"]), _t(q2["s8"]), 1)
    # the integer dots are exact on both sides and the f32 steps run in the
    # same order; what is left is the last ulp of sigmoid and of the sums
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T", [1, 7])
def test_unique_meta_matches_jax(T):
    rng = np.random.RandomState(2)
    E = 10
    ind, w = _routing(rng, T, E, k=3)
    meta, wd_j, U = j_unique_meta(jnp.asarray(ind), jnp.asarray(w), jnp.int32(0), E)
    ids, valid, wd = mk.unique_meta(torch.from_numpy(ind), torch.from_numpy(w), E)
    meta = np.asarray(meta)
    assert ids.shape == (U,)
    np.testing.assert_array_equal(valid.numpy(), meta[U:2 * U])
    ok = meta[U:2 * U] == 1
    np.testing.assert_array_equal(ids.numpy()[ok], meta[:U][ok])
    dense = np.asarray(wd_j)[..., 0]  # [U or E, T]
    if T == 1:  # the JAX table is indexed by slot; the port's by expert id
        np.testing.assert_array_equal(wd.numpy()[ids.numpy(), 0], dense[:, 0])
    else:
        np.testing.assert_array_equal(wd.numpy(), dense)


def test_act_quant_int8_matches_jax():
    x = np.random.RandomState(3).randn(6, 2560).astype(np.float32)
    xq_j, sx_j = jax.jit(j_act_quant_int8, static_argnums=1)(jnp.asarray(x), 5)
    xq, sx = mk.act_quant_int8(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(xq_j))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(sx_j))


# ------------------------------------------------------------ decode_attention


@pytest.fixture(scope="module")
def cache_case():
    rng = np.random.RandomState(4)
    L, B, H, S, D = 2, 3, 2, 384, 128
    k = rng.randn(L, B, H, S, D).astype(np.float32)
    v = rng.randn(L, B, H, S, D).astype(np.float32)
    ks = np.maximum(np.abs(k).max(-1), 1e-6) / 127.0
    vs = np.maximum(np.abs(v).max(-1), 1e-6) / 127.0
    kq = np.round(k / ks[..., None]).astype(np.int8)
    vq = np.round(v / vs[..., None]).astype(np.int8)
    q = rng.randn(B, H, D).astype(np.float32)
    lengths = np.array([384, 1, 200], np.int32)  # ragged, one full, one of 1
    return q, k, v, kq, vq, ks.astype(np.float32), vs.astype(np.float32), lengths


def test_decode_attention_int8_cache_matches_jax(cache_case):
    q, _, _, kq, vq, ks, vs, lengths = cache_case
    ref = j_decode_attention(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.int32(1),
                             jnp.asarray(lengths), jnp.asarray(ks), jnp.asarray(vs),
                             interpret=True, block_s=128)
    got = da.decode_attention(*map(torch.from_numpy, (q, kq, vq)), 1,
                              torch.from_numpy(lengths), torch.from_numpy(ks),
                              torch.from_numpy(vs))
    assert got.dtype == torch.bfloat16
    # bf16 output (2^-8 relative); the JAX kernel's 128-position blocks and
    # the plain full softmax sum in another order, so a bf16 rounding of q,
    # p*v_scale or the output can land one ulp apart
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_float_cache_matches_jax(cache_case, dtype):
    q, k, v, _, _, _, _, lengths = cache_case
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    ref = j_decode_attention(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
                             jnp.int32(0), jnp.asarray(lengths), interpret=True, block_s=128)
    got = da.decode_attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)), 0,
                              torch.from_numpy(lengths))
    assert got.dtype == td
    # f32: online vs one-pass softmax, ~1e-6; bf16: one ulp of the output
    tol = 2e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


# ------------------------------------------------------------ flash


@pytest.mark.parametrize("S", [64, 37])
def test_flash_causal_matches_jax(S):
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(2, S, 2, 128).astype(np.float32) for _ in range(3))
    ref = j_flash_sdpa(*map(jnp.asarray, (q, k, v)), causal=True)
    got = fl.flash_causal(*map(torch.from_numpy, (q, k, v)))
    # both are the masked f32 softmax; einsum summation order differs
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
