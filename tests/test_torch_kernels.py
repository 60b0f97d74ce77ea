"""The port's kernel modules against the JAX kernels.

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
from aria_tpu.ops.moe_prefill_kernel import experts_segmented_int4 as j_experts_segmented_int4
from aria_tpu.ops.moe_prefill_kernel import moe_prefill_int4 as j_moe_prefill_int4
from aria_tpu.ops.moe_prefill_kernel import segment_dispatch as j_segment_dispatch
from aria_tpu.ops.quant import dequantize_w1_int4 as j_dequantize_w1_int4
from aria_tpu.ops.quant import dequantize_w2_int4 as j_dequantize_w2_int4
from aria_tpu.ops.quant import quantize_expert_int4 as j_quantize_expert_int4
from aria_tpu.ops.vit_flash import vit_flash as j_vit_flash
from aria_tpu_torch.checkpoint.from_jax import to_tensor
from aria_tpu_torch.ops import decode_attention as da
from aria_tpu_torch.ops import dense_int4 as di
from aria_tpu_torch.ops import flash as fl
from aria_tpu_torch.ops import moe_decode_kernel as mk
from aria_tpu_torch.ops import moe_prefill_kernel as mp
from aria_tpu_torch.ops import vit_flash as vf

torch.set_num_threads(1)


def _t(x):
    return to_tensor(np.asarray(x), device="cpu")


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


@pytest.mark.parametrize("T", [1, 5, 32])
def test_moe_decode_int4_a8_matches_jax(moe_case, T):
    rng, D, E, q1, q2 = moe_case
    x = rng.randn(T, D).astype(np.float32)
    ind, w = _routing(rng, T, E)
    ref = j_moe_decode_int4(jnp.asarray(x), jnp.asarray(ind), jnp.asarray(w),
                            q1["q4"], q1["sg"], q2["q4"], q2["s8"], jnp.int32(1),
                            ft=128, interpret=True, act_int8=True)
    got = mk.moe_decode_int4(torch.from_numpy(x), torch.from_numpy(ind), torch.from_numpy(w),
                             _t(q1["q4"]), _t(q1["sg"]), _t(q2["q4"]), _t(q2["s8"]), 1,
                             act_int8=True)
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


# ------------------------------------------------------------ vit_flash


@pytest.mark.parametrize("B,S,H,D,valid,block", [(1, 512, 2, 72, None, 256),
                                                  (2, 300, 2, 72, (300, 137), 128),
                                                  (1, 300, 1, 64, (300,), 128)])
def test_vit_flash_matches_jax(B, S, H, D, valid, block):
    rng = np.random.RandomState(6)
    q, k, v = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    mask = np.ones((B, S), bool)
    for b, n in enumerate(valid or ()):
        mask[b, n:] = False
    kv = None if valid is None else mask
    ref = np.asarray(j_vit_flash(*map(jnp.asarray, (q, k, v)),
                                 None if kv is None else jnp.asarray(kv),
                                 bq=block, bk=block, interpret=True))
    got = vf.vit_flash(*map(torch.from_numpy, (q, k, v)),
                       None if kv is None else torch.from_numpy(kv)).numpy()
    # valid query rows only (padding rows are garbage by contract); f32,
    # the JAX kernel's blocked online softmax against one pass: as the JAX
    # package's own test bounds it against its sdpa (test_kernels.py:521)
    for b in range(B):
        n = int(mask[b].sum())
        np.testing.assert_allclose(got[b, :n], ref[b, :n], rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------ moe_prefill_int4


@pytest.fixture(scope="module")
def prefill_case():
    rng = np.random.RandomState(7)
    L, D, E, I = 2, 512, 10, 128
    w1 = (rng.randn(L, E, 2 * I, D) * D**-0.5).astype(np.float32)
    w2 = (rng.randn(L, E, I, D) * I**-0.5).astype(np.float32)
    q1, q2 = j_quantize_expert_int4(jnp.asarray(w1), jnp.asarray(w2))
    experts_j = (q1["q4"], q1["sg"], q2["q4"], q2["s8"])
    return D, E, experts_j, tuple(_t(a) for a in experts_j)


def _prefill_routing(seed, T, E, k=4):
    rng = np.random.RandomState(seed)
    ind = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(np.int32)
    return ind, rng.rand(T, k).astype(np.float32), rng


@pytest.mark.parametrize("T,k", [(129, 4), (300, 3), (7, 2)])
def test_segment_dispatch_matches_jax(T, k):
    E = 10
    ind, _, _ = _prefill_routing(T, T, E, k)
    dest_j, tile_j, R_j = j_segment_dispatch(jnp.asarray(ind), E)
    dest, tile, R, tile_rows = mp.segment_dispatch(torch.from_numpy(ind), E)
    assert R == R_j and dest.dtype == tile.dtype == tile_rows.dtype == torch.int32
    np.testing.assert_array_equal(dest.numpy(), np.asarray(dest_j))
    np.testing.assert_array_equal(tile.numpy(), np.asarray(tile_j))
    # each tile's routed rows, from where the JAX function sends the slots
    implied = np.bincount(np.asarray(dest_j) // mp.TM, minlength=R // mp.TM)
    np.testing.assert_array_equal(tile_rows.numpy(), implied)


@pytest.mark.parametrize("counts", [(0, 128, 129, 1, 127, 0), (256, 0, 0, 5), (1, 1, 1, 300)])
def test_segment_dispatch_tile_rows_at_the_tile_edges(counts):
    """Experts no slot picks, of exactly 128 and of 129 routed slots (and 1,
    127, 256, 300), against the counts the JAX function's dest_row and
    tile_expert imply: a tile's routed rows are its first ones, all of its
    expert's, and the tiles with rows come first."""
    E = len(counts)
    rng = np.random.RandomState(sum(counts))
    ind = rng.permutation(np.repeat(np.arange(E), counts)).astype(np.int32)[:, None]
    dest_j, tile_j, R = j_segment_dispatch(jnp.asarray(ind), E)
    _, tile, _, tile_rows = mp.segment_dispatch(torch.from_numpy(ind), E)
    dest_j, tile_j = np.asarray(dest_j), np.asarray(tile_j)
    implied = np.bincount(dest_j // mp.TM, minlength=R // mp.TM)
    np.testing.assert_array_equal(tile_rows.numpy(), implied)
    expected = [r for c in counts for r in [mp.TM] * (c // mp.TM) + [c % mp.TM] * (c % mp.TM > 0)]
    assert implied.tolist() == expected + [0] * (R // mp.TM - len(expected))
    for t, n in enumerate(implied):
        rows = np.sort(dest_j[dest_j // mp.TM == t]) - t * mp.TM
        np.testing.assert_array_equal(rows, np.arange(n))
        assert (ind[dest_j // mp.TM == t, 0] == tile_j[t]).all()


def test_moe_prefill_int4_plain_computes_every_row(prefill_case):
    """On the CPU the wrapper runs the plain version, which takes the tiles'
    routed-row counts and computes every row of every tile all the same:
    the counts only let the kernel skip."""
    D, E, _, experts = prefill_case
    ind, _, rng = _prefill_routing(17, 150, E)
    x = torch.from_numpy(rng.randn(150, D).astype(np.float32))
    dest, tile_e, R, tile_rows = mp.segment_dispatch(torch.from_numpy(ind), E)
    x_seg = torch.zeros((R, D))
    x_seg[dest.long()] = x.repeat_interleave(ind.shape[1], dim=0)
    x_seg[R - 1] = 1.0  # a padding row past every count
    got = mp.moe_prefill_int4(x_seg, tile_e, *experts, 0, tile_rows)
    full = mp.moe_prefill_int4(x_seg, tile_e, *experts, 0, torch.full_like(tile_rows, mp.TM))
    assert torch.equal(got, full)
    assert got[R - 1].abs().max() > 0


@pytest.mark.parametrize("T,layer", [(129, 0), (160, 1)])
def test_experts_segmented_int4_matches_jax_f32(prefill_case, T, layer):
    D, E, experts_j, experts = prefill_case
    ind, w, rng = _prefill_routing(T + 1, T, E)
    x = rng.randn(T, D).astype(np.float32)
    ref = np.asarray(j_experts_segmented_int4(jnp.asarray(x), jnp.asarray(ind), jnp.asarray(w),
                                              *experts_j, jnp.int32(layer), ft=128,
                                              interpret=True))
    got = mp.experts_segmented_int4(torch.from_numpy(x), torch.from_numpy(ind),
                                    torch.from_numpy(w), *experts, layer).numpy()
    # f32: exact dequantized weights against the JAX kernel's biased-lo
    # identity, whose f32 rounding of (xb/16 - xa) is ~1e-6 relative (seen
    # 5.7e-6 on the whole output)
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < 2e-5, rel
    assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max()


def test_moe_prefill_int4_matches_jax_f32(prefill_case):
    D, E, experts_j, experts = prefill_case
    T = 200
    ind, _, rng = _prefill_routing(11, T, E)
    x = rng.randn(T, D).astype(np.float32)
    dest, tile_e, R = j_segment_dispatch(jnp.asarray(ind), E)
    x_seg = jnp.zeros((R, D), jnp.float32).at[dest].set(jnp.asarray(x)[jnp.arange(T * 4) // 4])
    ref = np.asarray(j_moe_prefill_int4(x_seg, tile_e, *experts_j, jnp.int32(1), ft=128,
                                        interpret=True))
    _, _, _, tile_rows = mp.segment_dispatch(torch.from_numpy(ind), E)
    got = mp.moe_prefill_int4(torch.from_numpy(np.asarray(x_seg)),
                              torch.from_numpy(np.asarray(tile_e)), *experts, 1,
                              tile_rows).numpy()
    assert got.shape == (R, D) and got.dtype == np.float32
    # every row, padding rows included (zeros in, zeros out on both sides)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_experts_segmented_int4_bf16_is_the_int4_ffn(prefill_case):
    """At bf16 the port computes the GLU-FFN over the int4 weights: held to
    exact dequantized math (f64, h rounded to bf16 as both kernels do). The
    JAX kernel's bf16 rounding of (xb/16 - xa) is a fault of the reference
    and is not pinned: its gap is reported beside the bound as a witness."""
    D, E, experts_j, experts = prefill_case
    T, layer = 160, 1
    ind, w, rng = _prefill_routing(13, T, E)
    xb = torch.from_numpy(rng.randn(T, D).astype(np.float32)).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    got = mp.experts_segmented_int4(xb, torch.from_numpy(ind), wb, *experts, layer)
    assert got.dtype == torch.bfloat16
    x64, w64 = xb.double().numpy(), wb.double().numpy()
    q1 = {"q4": experts_j[0][layer], "sg": experts_j[1][layer]}
    q2 = {"q4": experts_j[2][layer], "s8": experts_j[3][layer]}
    w1 = np.asarray(j_dequantize_w1_int4(q1, jnp.float32), np.float64)  # [E, 2I, D]
    w2 = np.asarray(j_dequantize_w2_int4(q2, jnp.float32), np.float64)  # [E, I, D]
    I = w2.shape[1]
    exact = np.zeros((T, D))
    for t in range(T):
        for s, e in enumerate(ind[t]):
            gate, up = w1[e, :I] @ x64[t], w1[e, I:] @ x64[t]
            h = torch.tensor(gate / (1 + np.exp(-gate)) * up).to(torch.bfloat16).double().numpy()
            exact[t] += w64[t, s] * (h @ w2[e])
    ref_j = np.asarray(j_experts_segmented_int4(
        jnp.asarray(xb.float().numpy(), jnp.bfloat16), jnp.asarray(ind),
        jnp.asarray(wb.float().numpy(), jnp.bfloat16), *experts_j, jnp.int32(layer), ft=128,
        interpret=True), np.float64)
    rel = np.linalg.norm(got.double().numpy() - exact) / np.linalg.norm(exact)
    witness = np.linalg.norm(ref_j - exact) / np.linalg.norm(exact)
    # the bf16 output rounding (2^-9 relative per element) and rare one-ulp
    # flips of h where f32 and f64 sums straddle a bf16 rounding edge
    print(f"relative error to exact int4 math: port {rel:.3e}, JAX kernel {witness:.3e}")
    assert rel < 3e-3, f"port {rel:.3e} (JAX kernel's gap: {witness:.3e})"
