"""The MoE backward's cotangent split, on the CPU, and the context-parallel
witness tool.

- ``split_hi_lo_plain``: hi + lo is the f32 value exactly for products of
  two bf16 values, and a 128-row tile's flag is clear exactly where every
  value of the tile is bf16-exact.
- ``experts_ragged``'s backward hands the w1 product's ``_Gmm`` a cotangent
  that is bf16-exact (the backward of ``.to(x.dtype)``: ops/moe.py, as
  ``h.astype(x.dtype)`` at aria_tpu/ops/moe.py:239) and the w2 product's
  one that is not (a bf16 gradient times a bf16 combine weight): the fact
  that lets the kernels skip w1's lo product.
- The cancellation witness of ``chip_smoke.py`` through the plain
  ``gmm_dlhs`` and ``tgmm``: exact against f64, and the hi plane alone
  reads 0 there.
- ``tools/cp_witness.py`` at a narrow 2-layer configuration.
"""

import os

import jax
import numpy as np
import pytest
import torch

from aria_tpu_torch.ops import moe as tmoe

EPS = 2.0**-12  # the witness's cancellation: 1 + EPS is not a bf16 value


def _bf16(rng, *shape) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16().float()


@pytest.mark.parametrize("M", [32, 300, 512])
def test_split_hi_lo_is_exact_and_flags_the_inexact_tiles(M):
    rng = np.random.default_rng(M)
    N = 64
    x = _bf16(rng, M, N) * _bf16(rng, M, 1)  # 16 significant bits
    exact_tiles = [t for t in range(-(-M // 128)) if t % 2 == 0]
    for t in exact_tiles:  # these tiles hold bf16 values only
        x[t * 128:(t + 1) * 128] = _bf16(rng, min(128, M - t * 128), N)
    hi, lo, flags = tmoe.split_hi_lo_plain(x)
    assert hi.dtype == lo.dtype == torch.bfloat16 and flags.dtype == torch.int32
    assert torch.equal(hi.float() + lo.float(), x)
    assert torch.equal(hi, x.bfloat16())
    want = [0 if t in exact_tiles else 1 for t in range(-(-M // 128))]
    assert flags.tolist() == want
    # one inexact value sets its tile's flag, and only that one
    y = _bf16(rng, M, N)
    y[M - 1, 3] *= 1 + EPS
    assert tmoe.split_hi_lo_plain(y)[2].tolist() == [0] * (len(want) - 1) + [1]
    assert tmoe.split_hi_lo(y)[2].tolist() == tmoe.split_hi_lo_plain(y)[2].tolist()


def test_experts_ragged_hands_w1_a_bf16_exact_cotangent(monkeypatch):
    """Captures the cotangent each ``_Gmm`` backward passes to gmm_dlhs: w1's
    (transpose_rhs flipped to False) is bf16-exact everywhere, w2's is not."""
    rng = np.random.default_rng(5)
    T, D, I, E, k = 96, 128, 64, 8, 2
    x = _bf16(rng, T, D).bfloat16().requires_grad_()
    ids = torch.from_numpy(np.argsort(rng.random((T, E)), 1)[:, :k].astype(np.int32))
    w = torch.softmax(torch.from_numpy(rng.standard_normal((T, k)).astype(np.float32)), 1)
    w = w.bfloat16().requires_grad_()
    w1 = (_bf16(rng, E, 2 * I, D) * D**-0.5).bfloat16().requires_grad_()
    w2 = (_bf16(rng, E, I, D) * I**-0.5).bfloat16().requires_grad_()
    seen = {}
    real = tmoe.gmm_dlhs

    def capture(grad, rhs, group_sizes, transpose_rhs, *args, **kwargs):
        seen["w1" if not transpose_rhs else "w2"] = grad.clone()
        return real(grad, rhs, group_sizes, transpose_rhs, *args, **kwargs)

    monkeypatch.setattr(tmoe, "gmm_dlhs", capture)
    out = tmoe.experts_ragged(x, ids, w, w1, w2)
    out.backward(_bf16(rng, T, D).bfloat16())
    assert set(seen) == {"w1", "w2"}
    assert all(g.dtype == torch.float32 for g in seen.values())
    assert torch.equal(seen["w1"], seen["w1"].bfloat16().float())
    assert not torch.equal(seen["w2"], seen["w2"].bfloat16().float())
    flags = {name: tmoe.split_hi_lo_plain(g)[2] for name, g in seen.items()}
    assert int(flags["w1"].sum()) == 0 and int(flags["w2"].sum()) > 0


@pytest.mark.parametrize("transpose_rhs", [True, False])
def test_cancellation_witness_through_the_plain_versions(transpose_rhs):
    """The witness inputs of chip_smoke.py at a small shape: gmm_dlhs's row
    of cotangent (1 + 2^-12, -1) against two equal rhs rows, tgmm's group of
    two equal lhs rows with cotangents (1 + 2^-12) v and -v. The exact
    results are 2^-12 times the shared values; the plain versions give them
    to 1e-2 of their own size, and the hi plane alone gives 0."""
    rng = np.random.default_rng(7)
    E, K, N, M = 4, 128, 256, 256
    sizes = torch.tensor([100, 2, 0, 154], dtype=torch.int32)
    lhs = _bf16(rng, M, K).bfloat16()
    grad = _bf16(rng, M, N) * _bf16(rng, M, 1)
    r1, r3, c1, c2 = 100, 102, 3, 200  # group 1's two rows; group 3's first row
    lhs[r1 + 1] = lhs[r1]
    v = grad[r1].bfloat16().float()
    grad[r1], grad[r1 + 1] = v * (1 + EPS), -v
    grad[r3] = 0
    grad[r3, c1], grad[r3, c2] = 1 + EPS, -1.0
    # gmm_dlhs's rhs with contraction rows (or columns) c1 and c2 equal
    rhs = _bf16(rng, E, K, N).bfloat16() if transpose_rhs else _bf16(rng, E, N, K).bfloat16()
    if transpose_rhs:  # rhs [E, out, contraction]
        rhs[3, :, c2] = rhs[3, :, c1]
        b = rhs[3, :, c1]
    else:
        rhs[3, c2] = rhs[3, c1]
        b = rhs[3, c1]
    want_d = b.double() * EPS
    want_t = torch.outer(lhs[r1].double(), v.double()) * EPS

    def rel(got, want):
        return ((got.double() - want).abs().max() / want.abs().max()).item()

    d = tmoe.gmm_dlhs(grad, rhs, sizes, transpose_rhs)
    t = tmoe.tgmm(lhs, grad, sizes)
    assert rel(d[r3], want_d) <= 1e-2
    assert rel(t[1], want_t) <= 1e-2
    assert torch.equal(t[2], torch.zeros_like(t[2]))  # the empty group
    hi = tmoe.split_hi_lo_plain(grad)[0].float()  # the lo product skipped
    assert rel(tmoe.gmm_dlhs(hi, rhs, sizes, transpose_rhs)[r3], want_d) > 0.5
    assert rel(tmoe.tgmm(lhs, hi, sizes)[1], want_t) > 0.5


def test_cp_witness_runs_at_a_tiny_configuration():
    from tools import cp_witness as tool  # importable by name: its ranks are spawned

    assert len(jax.devices()) >= 2
    out = tool.witness([0], tiny=True, log=lambda *a, **k: None)
    assert out["seeds"] == [0] and out["sizes"] == tool.TINY
    for name in ("jax", "port"):
        assert len(out[name]) == 1 and 0.0 < out[name][0] < 0.2, (name, out[name])
    assert os.environ.get("ARIA_TPU_KERNELS") != "interpret"  # restored
