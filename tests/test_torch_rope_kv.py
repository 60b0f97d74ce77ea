"""The fused decode and prefill prologue ``rope_kv_write``
(``aria_tpu_torch/ops/kv_write.py``, kernel ``csrc/kv_write.cu``).

On the CPU its plain version, the chain of ``apply_rope``,
``quantize_kv`` and the cache write, is held against the
JAX package's ``_attention`` under jit (aria_tpu/models/moe_lm.py:379-380
RoPE, :394-395 the int8 scales, :460-464 ``pack_heads``, :486-507
``kv_cache_write``, in interpret mode) with real angles, in the three cache
forms; and ``lm_forward`` through the prologue against the same forward
through the chain it replaces, bit for bit. The ``cuda``-marked tests hold
the kernel bit-equal to its plain version on a card; JAX is imported only
inside the CPU tests' fixture, so on a machine without it they run as
``python -m pytest --noconftest tests/test_torch_rope_kv.py -m cuda``.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from aria_tpu_torch import config as tconfig
from aria_tpu_torch.checkpoint.from_jax import to_tensor
from aria_tpu_torch.models import moe_lm as tm
from aria_tpu_torch.ops import decode_attention as da
from aria_tpu_torch.ops import kv_write as kw
from aria_tpu_torch.ops.paged_attention import PagedKVCache, write_index
from aria_tpu_torch.ops.rope import LONG_SEQ, apply_rope, precompute_rope

D = 128
BASE = 5e6
FORMS = ("bf16", "int8", "int4")
# name: (lanes, tokens a lane, heads, positions: an int, or per lane)
CASES = {
    "decode B=1": (1, 1, 4, 57),
    "decode B=3": (3, 1, 4, [7, 119, 40]),
    "prefill 8": (2, 8, 4, 0),
    "prefill past LONG_SEQ": (1, LONG_SEQ + 8, 2, 0),
}


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported here so the card's tests need none of it."""
    jax = pytest.importorskip("jax")
    from aria_tpu import config as jconfig
    from aria_tpu.models import moe_lm as jm
    from aria_tpu.ops import backend as jbackend
    from aria_tpu.ops.rope import apply_rope as j_apply_rope
    from aria_tpu.ops.rope import precompute_rope as j_precompute_rope

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, jconfig=jconfig, jm=jm,
                                 jbackend=jbackend, apply_rope=j_apply_rope,
                                 precompute_rope=j_precompute_rope)


@pytest.fixture
def interpret(jx, monkeypatch):
    """The JAX package's kernels in interpret mode for one test (its
    backend is read once and cached)."""
    monkeypatch.setenv("ARIA_TPU_KERNELS", "interpret")
    jx.jbackend.kernel_backend.cache_clear()
    yield
    monkeypatch.undo()
    jx.jbackend.kernel_backend.cache_clear()


def _text(jx, H):
    return jx.jconfig.TextConfig(vocab_size=64, hidden_size=3 * H * D, num_layers=2,
                                 num_heads=H, num_kv_heads=H, head_dim=D, num_experts=4,
                                 moe_topk=2, moe_intermediate_size=128, num_shared_experts=0)


def _port_cache(text, B, max_seq, form, device="cpu"):
    cfg = tconfig.config_from_dict({"text": dataclasses.asdict(text)}).text
    dtype = {"bf16": torch.bfloat16, "int8": torch.int8, "int4": "int4"}[form]
    return tm.KVCache.init(cfg, B, max_seq, dtype, device=device)


def _dest(B, S, pos, device="cpu"):
    """(rows, slots) of each token, as ``lm_forward`` gives them."""
    if isinstance(pos, list):
        return (torch.arange(B, dtype=torch.int32, device=device),
                torch.tensor(pos, dtype=torch.int32, device=device))
    rows = torch.arange(B, dtype=torch.int32, device=device).repeat_interleave(S)
    return rows, (pos + torch.arange(S, dtype=torch.int32, device=device)).repeat(B)


def _values(cache, name):
    """A cache plane as values: bf16 as f32, int8 as ints, packed int4
    unpacked to its heads."""
    t = getattr(cache, name)
    if name in ("k", "v") and cache.packed4:
        return da.unpack_heads(t).float()
    return t.float()


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("case", list(CASES))
def test_rope_kv_write_matches_jax_attention(jx, interpret, form, case):
    """The JAX ``_attention`` with an identity wqkv, so its q, k and v are
    the input's thirds, rounded to bf16 exactly; cos and sin from real
    positions, the same f32 arrays on both sides. Tolerance: where the
    port's rotated k of a (token, head) equals the JAX package's
    ``apply_rope``'s, the cache's bytes and scales are equal; elsewhere
    (XLA may fuse the rotation's products and differences without their
    bf16 roundings, as past LONG_SEQ) a value moves by at most one
    quantization step (one bf16 rounding for a bf16 cache) and a scale by
    one bf16 rounding. v is not rotated: always equal. q within one bf16
    rounding of its head's largest value."""
    jnp = jx.jnp
    B, S, H, pos = CASES[case]
    text = _text(jx, H)
    q_size, fresh = H * D, S > 1
    max_seq = 128 if S < 128 else S + 120
    rng = np.random.RandomState(3)
    x = (rng.randn(B, S, 3 * q_size) * rng.uniform(0.05, 4, (B, S, 3 * q_size))).astype(np.float32)
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    per_lane = isinstance(pos, list)
    positions = (np.asarray(pos, np.int32)[:, None] if per_lane
                 else pos + np.arange(S, dtype=np.int32))
    cos, sin = (np.array(a, np.float32)
                for a in jx.precompute_rope(jnp.asarray(positions), D, BASE))
    layer = {"wqkv": jnp.eye(3 * q_size, dtype=jnp.float32),
             "wo": jnp.zeros((q_size, text.hidden_size), jnp.float32)}
    jdt = {"bf16": jnp.bfloat16, "int8": jnp.int8, "int4": "int4"}[form]

    @jx.jax.jit
    def run(x, cos, sin, cache):
        _, new = jx.jm._attention(layer, text, x, cos, sin, None, cache,
                                  jnp.asarray(pos, jnp.int32), layer_idx=jnp.int32(1),
                                  use_flash=fresh)
        return new

    @jx.jax.jit
    def rotated(x, cos, sin):  # _attention's q and k (moe_lm.py:371-380)
        q, k = (x[..., i * q_size:(i + 1) * q_size].reshape(B, S, H, D) for i in range(2))
        return jx.apply_rope(q, cos, sin), jx.apply_rope(k, cos, sin)

    xj = jnp.asarray(x, jnp.bfloat16)
    jc = tm.KVCache(*(None if a is None else to_tensor(np.asarray(a), device="cpu")
                      for a in run(xj, cos, sin, jx.jm.KVCache.init(text, B, max_seq, jdt))))
    jq, jk = (np.asarray(a.astype(jnp.float32)) for a in rotated(xj, cos, sin))

    tc = _port_cache(text, B, max_seq, form)
    q, k, v = kw.rope_kv_write(torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin),
                               tc, 1, *_dest(B, S, pos), H, torch.bfloat16, fresh=fresh)
    assert q.dtype == torch.bfloat16 and q.shape == (B, S, H, D)
    qf = q.float().numpy()
    assert (np.abs(qf - jq) <= 2**-7 * np.abs(jq).max(-1, keepdims=True)).all()
    xt = torch.from_numpy(x).to(torch.bfloat16)
    kp = apply_rope(xt[..., q_size:2 * q_size].reshape(B, S, H, D), torch.from_numpy(cos),
                    torch.from_numpy(sin))
    if fresh:
        assert torch.equal(k, kp) and torch.equal(v, xt[..., 2 * q_size:].reshape(B, S, H, D))
    # which written (lane, head, position) of layer 1 holds a k that agrees
    agree = torch.ones(tc.k_scale.shape[1:] if tc.quantized else (B, H, max_seq), dtype=torch.bool)
    same = torch.from_numpy((kp.float().numpy() == jk).all(-1))  # [B, S, H]
    rows, slots = _dest(B, S, pos)
    agree[rows.long(), :, slots.long()] = same.reshape(B * S, H)
    step = 2**-7 if form == "bf16" else 0.0  # relative: one bf16 rounding
    for name in ("k", "v", "k_scale", "v_scale"):
        if name.endswith("scale") and not tc.quantized:
            continue
        got, want = _values(tc, name)[1], _values(jc, name)[1]
        ok = agree if name.startswith("k") else torch.ones_like(agree)
        ok = ok[..., None] if got.dim() == 4 else ok
        assert torch.equal(torch.where(ok, got, 0), torch.where(ok, want, 0)), name
        diff = (got - want).abs()
        if name.endswith("scale"):
            assert (diff <= 2**-7 * want.abs()).all(), name
        else:
            assert (diff <= (step * want.abs() if form == "bf16" else 1.0)).all(), name


@pytest.mark.parametrize("form", FORMS)
def test_rope_kv_write_out_of_range_lanes_write_nothing(form):
    """A lane whose row or slot lies outside the cache leaves it as it
    was; its query is computed all the same."""
    text = tconfig.TextConfig(vocab_size=64, hidden_size=512, num_layers=2, num_heads=2,
                              num_kv_heads=2, head_dim=D, num_experts=4, moe_topk=2,
                              moe_intermediate_size=128, num_shared_experts=0)
    dtype = {"bf16": torch.bfloat16, "int8": torch.int8, "int4": "int4"}[form]
    cache = tm.KVCache.init(text, 3, 64, dtype, device="cpu")
    g = torch.Generator().manual_seed(1)
    qkv = torch.randn((5, 1, 3 * 2 * D), generator=g)
    cos, sin = precompute_rope(torch.tensor([[3], [9], [0], [63], [64]]), D, BASE)
    rows = torch.tensor([0, -1, 3, 2, 1], dtype=torch.int32)
    slots = torch.tensor([3, 9, 0, 63, 64], dtype=torch.int32)  # lanes 1, 2, 4 lie outside
    before = [None if t is None else t.clone() for t in dataclasses.astuple(cache)]
    q, _, _ = kw.rope_kv_write(qkv, cos, sin, cache, 1, rows, slots, 2, fresh=False)
    for got, old in zip(dataclasses.astuple(cache), before):
        if got is None:
            continue
        g, o = got[1].clone(), old[1].clone()  # layer 1: [R, heads, S, ...]
        for r, s in ((0, 3), (2, 63)):  # the two lanes inside
            assert not torch.equal(g[r, :, s], o[r, :, s])
            g[r, :, s] = o[r, :, s] = 0
        assert torch.equal(g, o) and torch.equal(got[0], old[0])
    for b in range(5):  # each lane's query alone equals its part of the call
        alone = kw.rope_kv_write(qkv[b:b + 1], cos[b:b + 1], sin[b:b + 1],
                                 tm.KVCache.init(text, 3, 64, dtype, device="cpu"), 1,
                                 torch.zeros(1, dtype=torch.int32), slots[:1], 2, fresh=False)[0]
        assert torch.equal(alone[0], q[b])


@pytest.mark.parametrize("form", ["bf16", "int8"])
def test_rope_kv_write_paged_null_page_goes_to_slot_0(form):
    """An idle lane's zeroed table names the null page 0: its write goes to
    slot 0 of page 0 (paged.py:99-100), not to its frozen position; a lane
    past its table (page -1) writes nothing."""
    text = tconfig.TextConfig(vocab_size=64, hidden_size=512, num_layers=2, num_heads=2,
                              num_kv_heads=2, head_dim=D, num_experts=4, moe_topk=2,
                              moe_intermediate_size=128, num_shared_experts=0)
    cache = PagedKVCache.init(text, 5, 32, torch.bfloat16 if form == "bf16" else torch.int8,
                              device="cpu")
    table = torch.tensor([[3, 1], [0, 0], [2, 4]], dtype=torch.int32)
    pos = torch.tensor([40, 21, 64], dtype=torch.int32)  # lane 2 lies past its two pages
    pages, slots = write_index(table, pos, 1, cache.page_size)
    assert pages[:, 0].tolist() == [1, 0, -1]
    g = torch.Generator().manual_seed(2)
    qkv = torch.randn((3, 1, 3 * 2 * D), generator=g)
    cos, sin = precompute_rope(pos[:, None], D, BASE)
    before = [None if t is None else t.clone() for t in dataclasses.astuple(cache)]
    kw.rope_kv_write(qkv, cos, sin, cache, 1, pages.reshape(-1), slots.reshape(-1), 2,
                     fresh=False, null_page=True)
    changed = {(p, s) for p in range(5) for s in range(32)
               if not torch.equal(cache.k[1, p, :, s], before[0][1, p, :, s])}
    assert changed == {(1, 8), (0, 0)}
    for got, old in zip(dataclasses.astuple(cache), before):
        if got is not None:
            assert torch.equal(got[0], old[0])


# ------------------------------------------------------------ lm_forward


def _small(device="cpu"):
    text = tconfig.TextConfig(vocab_size=128, hidden_size=256, num_layers=2, num_heads=2,
                              num_kv_heads=2, head_dim=D, num_experts=4, moe_topk=2,
                              moe_intermediate_size=128, num_shared_experts=2)
    lm = tm.init_lm_params_serving_int4(text, torch.Generator(device=device).manual_seed(0),
                                        device=device, dtype=torch.bfloat16)
    return text, lm


PATHS = ("decode, per lane", "decode, one position", "prefill", "paged decode")


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("path", PATHS)
def test_lm_forward_through_the_prologue_is_the_chain(monkeypatch, form, path):
    """``lm_forward`` takes ``rope_kv_write`` on the decode step (lanes,
    one position, pages) and the from-zero prefill; the same forward with
    the prologue off (the chain that every path took before it) gives the
    same logits and cache, bit for bit."""
    if path == "paged decode" and form == "int4":
        pytest.skip("pages are bf16 or int8: the JAX package has no int4 pages")
    text, lm = _small()
    dtype = {"bf16": torch.bfloat16, "int8": torch.int8, "int4": "int4"}[form]
    rng = np.random.RandomState(4)
    B = 3

    def forward(cache, **kw):
        if path == "prefill":
            toks = torch.from_numpy(rng.randint(0, 128, (B, 12)))
            return tm.lm_forward(lm, text, toks, cache=cache, cache_pos=0, causal_flash=True,
                                 **kw)
        toks = torch.from_numpy(rng.randint(0, 128, (B, 1)))
        if path == "decode, one position":
            return tm.lm_forward(lm, text, toks, positions=torch.full((1,), 17), cache=cache,
                                 cache_pos=17, **kw)
        pos = torch.tensor([5, 30, 17], dtype=torch.int32)
        return tm.lm_forward(lm, text, toks, positions=pos[:, None], cache=cache,
                             cache_pos=pos, **kw)

    def run():
        rng.seed(4)
        if path == "paged decode":
            cache = PagedKVCache.init(text, 8, 32, dtype, device="cpu")
            table = torch.tensor([[1, 2], [0, 0], [3, 4]], dtype=torch.int32)
            out = forward(cache, page_table=table)
        else:
            cache = tm.KVCache.init(text, B, 64, dtype, device="cpu")
            out = forward(cache)
        return out.logits, cache

    calls = []
    real = kw.rope_kv_write
    monkeypatch.setattr(tm, "rope_kv_write", lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.inference_mode():
        fused, fused_cache = run()
        assert len(calls) == text.num_layers
        monkeypatch.setattr(tm, "_prologue_dest", lambda *a: None)
        chain, chain_cache = run()
    assert len(calls) == text.num_layers
    assert torch.equal(fused, chain)
    for a, b in zip(dataclasses.astuple(fused_cache), dataclasses.astuple(chain_cache)):
        assert (a is None and b is None) or torch.equal(a, b)


# ------------------------------------------------------------ the kernel, on a card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand kernels run only on the card")
    return torch.device("cuda")


# name: (lanes, tokens a lane, paged); 20 heads of 128, the flagship's
CARD_CASES = {"decode B=1": (1, 1, False), "decode B=4": (4, 1, False),
              "decode B=32": (32, 1, False), "paged B=32": (32, 1, True),
              "prefill 512": (1, 512, False), "prefill 8192 (bf16 rotation)": (1, LONG_SEQ, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_rope_kv_write_kernel_is_bit_equal_to_plain(cuda, form, case):
    """The q bits (q, k and v at prefill), the cache's
    bytes and its scales, equal to the plain chain's on the same inputs.
    Paged: int8 or bf16 pages, an idle lane on the null page and a lane
    past its table; page 0, which lanes share, is left out."""
    B, S, paged = CARD_CASES[case]
    if paged and form == "int4":
        pytest.skip("pages are bf16 or int8")
    cfg = tconfig.TextConfig()
    H = cfg.num_heads
    g = torch.Generator(device=cuda).manual_seed(5)
    qkv = torch.randn((B, S, 3 * H * D), generator=g, device=cuda) * torch.rand(
        (B, S, 3 * H * D), generator=g, device=cuda) * 4
    dtype = {"bf16": torch.bfloat16, "int8": torch.int8, "int4": "int4"}[form]
    if paged:
        caches = [PagedKVCache.init(cfg, 1 + 2 * B, 256, dtype, device=cuda) for _ in range(2)]
        table = (torch.randperm(2 * B, generator=g, device=cuda) + 1).to(torch.int32).reshape(B, 2)
        table[B - 2] = 0  # idle: the null page
        pos = torch.randint(0, 512, (B,), generator=g, device=cuda, dtype=torch.int32)
        pos[B - 1] = 512  # past its table
        pages, slots = write_index(table, pos, 1, 256)
        rows, slots = pages.reshape(-1), slots.reshape(-1)
        cos, sin = precompute_rope(pos[:, None], D, cfg.rope_base)
    else:
        caches = [tm.KVCache.init(cfg, max(B, 2), max(384, S), dtype, device=cuda)
                  for _ in range(2)]
        pos = (torch.randint(0, 384, (B,), generator=g, device=cuda, dtype=torch.int32)
               if S == 1 else 0)
        rows, slots = _dest(B, S, pos.tolist() if S == 1 else 0, device=cuda)
        positions = pos[:, None] if S == 1 else torch.arange(S, device=cuda)
        cos, sin = precompute_rope(positions, D, cfg.rope_base)
    args = (qkv, cos, sin)
    launches = kw.rope_kv_write.launches
    got = kw.rope_kv_write(*args, caches[0], 1, rows, slots, H, fresh=S > 1, null_page=paged)
    torch.cuda.synchronize()
    assert kw.rope_kv_write.launches == launches + 1
    want = kw.rope_kv_write_plain(*args, caches[1], 1, rows, slots, H, fresh=S > 1,
                                  null_page=paged)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)
    for a, b in zip(dataclasses.astuple(caches[0]), dataclasses.astuple(caches[1])):
        if a is not None:
            assert torch.equal(a[:, 1:], b[:, 1:]) if paged else torch.equal(a, b)


@pytest.mark.cuda
def test_rope_kv_write_refuses_what_the_kernel_does_not_take(cuda):
    """Head dim 64 and f32 activations raise: there is no fallback."""
    cfg = tconfig.TextConfig(head_dim=64)
    cache = tm.KVCache.init(cfg, 1, 64, torch.int8, device=cuda)
    qkv = torch.zeros((1, 1, 3 * cfg.num_heads * 64), device=cuda)
    cos, sin = precompute_rope(torch.zeros((1, 1), device=cuda), 64, cfg.rope_base)
    dest = _dest(1, 1, [0], device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        kw.rope_kv_write(qkv, cos, sin, cache, 0, *dest, cfg.num_heads, fresh=False)
    cfg = tconfig.TextConfig()
    cache = tm.KVCache.init(cfg, 1, 64, torch.int8, device=cuda)
    qkv = torch.zeros((1, 1, 3 * cfg.num_heads * D), device=cuda)
    cos, sin = precompute_rope(torch.zeros((1, 1), device=cuda), D, cfg.rope_base)
    with pytest.raises(TypeError, match="bf16"):
        kw.rope_kv_write(qkv, cos, sin, cache, 0, *dest, cfg.num_heads, torch.float32,
                         fresh=False)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ("int8", "int4"))
def test_decode_attention_scales_a_bf16_query_as_the_wrapper_does(cuda, form):
    """Decode attention (and, for int8 pages, paged decode attention) over
    the prologue's bf16 query, which the kernel scales, equals the same
    kernel over that query in f32, which the wrapper scales with
    ``_scaled_query``: bit for bit."""
    cfg = tconfig.TextConfig(num_layers=2)
    H, B, S = cfg.num_heads, 4, 384
    g = torch.Generator(device=cuda).manual_seed(6)
    dtype = {"int8": torch.int8, "int4": "int4"}[form]

    def fill(cache):
        for name in ("k", "v"):
            getattr(cache, name).copy_(torch.randint(-128, 128, cache.k.shape, generator=g,
                                                     device=cuda))
        for t in (cache.k_scale, cache.v_scale):
            t.copy_(torch.rand(t.shape, generator=g, device=cuda) * 0.1)
        return cache

    q = torch.randn((B, H, D), generator=g, device=cuda).to(torch.bfloat16)
    lengths = torch.randint(1, S + 1, (B,), generator=g, device=cuda, dtype=torch.int32)
    c = fill(tm.KVCache.init(cfg, B, S, dtype, device=cuda))
    assert torch.equal(da.decode_attention(q, c.k, c.v, 1, lengths, c.k_scale, c.v_scale),
                       da.decode_attention(q.float(), c.k, c.v, 1, lengths, c.k_scale,
                                           c.v_scale))
    if form == "int4":
        return
    from aria_tpu_torch.ops import paged_attention as pg

    pages = fill(PagedKVCache.init(cfg, 1 + 2 * B, 256, dtype, device=cuda))
    table = (torch.randperm(2 * B, generator=g, device=cuda) + 1).to(torch.int32).reshape(B, 2)
    lengths = torch.randint(1, 513, (B,), generator=g, device=cuda, dtype=torch.int32)
    assert torch.equal(pg.paged_decode_attention(q, pages, 1, table, lengths),
                       pg.paged_decode_attention(q.float(), pages, 1, table, lengths))
