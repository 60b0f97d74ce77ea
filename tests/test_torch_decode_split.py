"""The decode-attention kernel's split over positions, on the CPU.

``csrc/decode_attention.cu`` runs a grid of (heads or head pairs, lanes,
P) blocks, P from ``split_count(B, heads, S, sms)``, each over one chunk of
``split_bounds(S, P)``, and merges the partials exactly in the launch.

- The split heuristic: a pure function of (B, heads, S) and the card's SM
  count (132 on an H100 SXM), P = 1 at 32 lanes x 10 int4 head pairs, the
  chunks cover [0, S) exactly, and the wrapper
  chooses P and launches without reading ``lengths`` (a tensor on the
  device: a read would synchronise the decode step).
- ``decode_attention_split_plain``, the plain rendering of the split (the
  stats form over each chunk, merged as parallel/cp_cache.py merges), held
  against the JAX ``decode_attention`` in interpret mode, normal and
  ``return_stats``, for bf16, int8 and packed-int4 caches at P in {1, 2,
  7}, with a lane of length 0 and a lane shorter than one chunk.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aria_tpu.ops.decode_attention import decode_attention as j_decode_attention
from aria_tpu_torch.ops import backend
from aria_tpu_torch.ops import decode_attention as da

NEG_INF = -1e30
L, B, H, S, D = 2, 4, 2, 1920, 128  # 8 units of 256 positions: P up to 8
LENGTHS = [0, 100, 1000, S]  # empty, shorter than one chunk, ragged, full
# stats: m and s are f32 sums in another order (1e-5); acc sums p (times
# v_scale) rounded to bf16, against the JAX kernel's running max per
# 128-block and the port's per chunk: one bf16 rounding apart, 2^-8 of
# max |acc|. Normal form: bf16 output, one ulp.
STATS_RTOL = 1e-5
STATS_ACC_RTOL = 2.0**-8
OUT_TOL = 1e-2
H100_SMS = 132  # an H100 SXM's SMs


# ------------------------------------------------------------ the heuristic

@pytest.mark.parametrize("b, heads, s, want", [
    (32, 10, 384, 1),     # the lanes path: 320 blocks without a split
    (1, 20, 1024, 4),     # one lane over 1,024 int8 positions: 80 blocks
    (1, 20, 4352, 14),    # one cp rank's block: 280 blocks
    (1, 10, 32896, 27),   # bench.py's ctx child, int4 pairs
    (1, 20, 200, 1),      # below one unit
    (2, 20, 2048, 7),
])
def test_split_count(b, heads, s, want):
    assert da.split_count(b, heads, s, H100_SMS) == want


def test_split_count_is_a_function_of_the_shapes():
    assert list(inspect.signature(da.split_count).parameters) == ["B", "heads", "S", "sms"]
    for b in (1, 3, 32):
        for heads in (10, 20):
            for s in (1, 255, 256, 257, 4352, 32896):
                P = da.split_count(b, heads, s, H100_SMS)
                assert 1 <= P <= -(-s // da.SPLIT_UNIT)
                assert P == da.split_count(b, heads, s, H100_SMS)


@pytest.mark.parametrize("s", [1, 255, 256, 257, 1920, 4352, 32896])
def test_split_bounds_cover_the_cache(s):
    units = -(-s // da.SPLIT_UNIT)
    for P in range(1, units + 1):
        bounds = da.split_bounds(s, P)
        assert len(bounds) == P and bounds[0][0] == 0 and bounds[-1][1] == s
        for (a0, a1), (b0, _) in zip(bounds, bounds[1:]):
            assert a1 == b0
        assert all(a0 < a1 and a0 % da.SPLIT_ALIGN == 0 for a0, a1 in bounds)
    with pytest.raises(ValueError):
        da.split_bounds(s, units + 1)


@pytest.mark.parametrize("cache", ["int8", "int4"])
def test_launch_chooses_the_split_without_reading_lengths(monkeypatch, cache):
    """``_launch`` with ``lengths`` on the meta device (any read of its
    values raises) and a stand-in library: the split is chosen and the
    kernel called with P = split_count, one call."""
    calls = []

    class Lib:
        def aria_decode_attention(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(da, "library", lambda: Lib())
    monkeypatch.setattr(backend, "stream", lambda: None)
    monkeypatch.setattr(backend, "sm_count", lambda dev: H100_SMS)
    Sx, Hc = 1024, H // 2 if cache == "int4" else H
    k = torch.zeros((L, 1, Hc, Sx, D), dtype=torch.int8)
    sdt = torch.bfloat16 if cache == "int4" else torch.float32
    scales = [torch.zeros((L, 1, H, Sx), dtype=sdt) for _ in range(2)]
    lengths = torch.zeros((1,), dtype=torch.int32, device="meta")
    q = torch.zeros((1, H, D), dtype=torch.bfloat16)
    da._launch(q, k, k, 1, lengths, *scales, stats=False, splits=None)
    assert len(calls) == 1
    kind, P = calls[0][16], calls[0][17]
    assert kind == (2 if cache == "int4" else 1) and P == da.split_count(1, Hc, Sx, H100_SMS) > 1


# ------------------------------------------------------------ the split against JAX

def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.fixture(scope="module")
def cases():
    """{cache: (torch args, JAX normal output, JAX stats)} at LENGTHS."""
    rng = np.random.RandomState(21)
    q = rng.randn(B, H, D).astype(np.float32)
    kf = rng.randn(L, B, H, S, D).astype(np.float32)
    vf = rng.randn(L, B, H, S, D).astype(np.float32)
    ks, vs = (np.abs(t).max(-1) / 127.0 for t in (kf, vf))
    lengths = np.asarray(LENGTHS, np.int32)
    arrays = {
        "bf16": (_bf16(q), _bf16(kf), _bf16(vf), None, None),
        "int8": (q, np.round(kf / ks[..., None]).astype(np.int8),
                 np.round(vf / vs[..., None]).astype(np.int8), ks.astype(np.float32),
                 vs.astype(np.float32)),
        "int4": (q, rng.randint(-128, 128, (L, B, H // 2, S, D)).astype(np.int8),
                 rng.randint(-128, 128, (L, B, H // 2, S, D)).astype(np.int8),
                 _bf16(rng.uniform(0.01, 0.1, (L, B, H, S)).astype(np.float32)),
                 _bf16(rng.uniform(0.01, 0.1, (L, B, H, S)).astype(np.float32))),
    }
    out = {}
    for name, (qa, ka, va, ksa, vsa) in arrays.items():
        fdt = jnp.bfloat16 if name == "bf16" else None
        sdt = jnp.bfloat16 if name == "int4" else jnp.float32
        jargs = (jnp.asarray(qa, fdt), jnp.asarray(ka, fdt), jnp.asarray(va, fdt), jnp.int32(1),
                 jnp.asarray(lengths))
        jsc = {} if ksa is None else {"k_scale": jnp.asarray(ksa, sdt),
                                      "v_scale": jnp.asarray(vsa, sdt)}
        j_out = np.asarray(j_decode_attention(*jargs, **jsc, block_s=128, interpret=True),
                           np.float32)
        j_stats = tuple(np.asarray(a, np.float32) for a in j_decode_attention(
            *jargs, **jsc, block_s=128, interpret=True, return_stats=True))
        tdt = torch.bfloat16 if name == "bf16" else None

        def t(a, dt=None):
            x = torch.from_numpy(a)
            return x.to(dt) if dt is not None else x

        targs = (t(qa, tdt), t(ka, tdt), t(va, tdt), 1, torch.from_numpy(lengths),
                 None if ksa is None else t(ksa, torch.bfloat16 if name == "int4" else None),
                 None if vsa is None else t(vsa, torch.bfloat16 if name == "int4" else None))
        out[name] = (targs, j_out, j_stats)
    return out


def _rel(got, ref) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float64) - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("P", [1, 2, 7])
@pytest.mark.parametrize("cache", ["bf16", "int8", "int4"])
def test_split_plain_matches_jax_normal(cases, cache, P):
    targs, j_out, _ = cases[cache]
    got = da.decode_attention_split_plain(*targs, splits=P)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    full = np.asarray(LENGTHS) > 0
    # an empty lane is 0 in the port, where the JAX kernel leaves the mean
    # of its last block's values
    assert np.all(got[~full] == 0)
    np.testing.assert_allclose(got[full], j_out[full], rtol=OUT_TOL, atol=OUT_TOL)


@pytest.mark.parametrize("P", [1, 2, 7])
@pytest.mark.parametrize("cache", ["bf16", "int8", "int4"])
def test_split_plain_matches_jax_stats(cases, cache, P):
    targs, _, (acc_j, m_j, s_j) = cases[cache]
    acc, m, s = (a.numpy() for a in da.decode_attention_split_plain(
        *targs, splits=P, return_stats=True))
    full = np.asarray(LENGTHS) > 0
    # empty lanes: the finite sentinel in both, nothing summed in the port
    assert np.all(m[~full] == NEG_INF) and np.all(m_j[~full] == np.float32(NEG_INF))
    assert np.all(acc[~full] == 0) and np.all(s[~full] == 0)
    assert _rel(acc[full], acc_j[full]) < STATS_ACC_RTOL
    assert _rel(m[full], m_j[full]) < STATS_RTOL
    np.testing.assert_allclose(s[full], s_j[full], rtol=STATS_RTOL, atol=0)
