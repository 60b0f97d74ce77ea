"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and skips without one. The file
imports nothing of jax, so on a GPU machine without jax it runs as
``python -m pytest --noconftest tests/test_torch_cuda.py``. Shapes are the
flagship widths the serving path gives each kernel.
"""

import numpy as np
import pytest
import torch

from aria_tpu_torch.config import AriaConfig, TextConfig
from aria_tpu_torch.engine.server import BatchedEngine, PagedBatchedEngine
from aria_tpu_torch.models.moe_lm import init_lm_params_serving_int4
from aria_tpu_torch.ops import decode_attention as da
from aria_tpu_torch.ops import dense_int4 as di
from aria_tpu_torch.ops import expert_dequant as ed
from aria_tpu_torch.ops import flash as fl
from aria_tpu_torch.ops import kv_write as kw
from aria_tpu_torch.ops import moe as tmoe
from aria_tpu_torch.ops import moe_decode_kernel as mk
from aria_tpu_torch.ops import moe_prefill_kernel as mp
from aria_tpu_torch.ops import paged_attention as pg
from aria_tpu_torch.ops import vit_flash as vf
from aria_tpu_torch.ops.quant import (
    linear,
    quantize_dense_int4,
    quantize_expert_int4,
    quantize_weight,
    with_s8,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand kernels run only on the card")
    return torch.device("cuda")


def _randn(gen, *shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)


# wqkv, wo, and two widths of one D-group: whole 64-byte stages, and a
# group of 80 packed bytes whose last stage is partly past its end
@pytest.mark.parametrize("D,F", [(2560, 7680), (2560, 2560), (256, 384), (160, 200)])
def test_dense_int4_kernel_matches_plain(cuda, D, F):
    g = torch.Generator(device=cuda).manual_seed(0)
    w = quantize_dense_int4(_randn(g, 2, D, F, scale=D**-0.5))
    before = di.dense_int4.launches
    for T in (1, 7, 12, 32, 33, 129, 512, 4096):  # every tile form of the kernel
        x = _randn(g, T, D)
        got = di.dense_int4(x, w, 1)
        # both are f32 sums of exact products; only the order differs
        torch.testing.assert_close(got, di.dense_int4_plain(x, w, 1), rtol=1e-4, atol=1e-4)
        assert torch.equal(got, di.dense_int4(x, w, 1))  # the split's sum order is fixed
    assert di.dense_int4.launches == before + 16


def test_dense_int4_row_gets_the_same_bits_at_every_row_count(cuda):
    """A row's output does not depend on the rows beside it, through every
    tile form (the split over D-groups at few rows included): a cached
    prefix page must equal a recomputed one."""
    g = torch.Generator(device=cuda).manual_seed(3)
    w = quantize_dense_int4(_randn(g, 1, 2560, 7680, scale=2560**-0.5))
    row = _randn(g, 1, 2560)
    ref = di.dense_int4(row, w, 0)
    for T in (2, 7, 9, 12, 32, 33, 64, 65, 129, 300):
        x = _randn(g, T, 2560)
        for at in (0, T - 1):
            x[at] = row[0]
            assert torch.equal(di.dense_int4(x, w, 0)[at], ref[0]), (T, at)


def _w4a8_stack(g, E, I=1664, D=2560):
    return quantize_expert_int4(_randn(g, 1, E, 2 * I, D, scale=D**-0.5),
                                _randn(g, 1, E, I, D, scale=I**-0.5))


def _w4a8_routing(rng, cuda, T, E, k, skip=()):
    """top-k of the routed experts but ``skip`` plus the 2 shared ones."""
    routed = np.array([e for e in range(E - 2) if e not in skip])
    idx = routed[np.argsort(-rng.randn(T, len(routed)), axis=1)[:, :k]]
    ind = np.concatenate([idx, np.broadcast_to([E - 2, E - 1], (T, 2))], 1)
    wts = np.concatenate([rng.dirichlet(np.ones(k), T), np.ones((T, 2))], 1)
    return (torch.tensor(ind, dtype=torch.int32, device=cuda),
            torch.tensor(wts, dtype=torch.bfloat16, device=cuda))


@pytest.mark.parametrize("E,k", [(10, 2), (66, 6)])
def test_moe_decode_int4_kernel_matches_plain(cuda, E, k):
    g = torch.Generator(device=cuda).manual_seed(0)
    w1, w2 = _w4a8_stack(g, E)
    rng = np.random.RandomState(E)
    before = mk.moe_decode_int4.launches
    for T in (1, 5, 32, 64, 128):
        args = (_randn(g, T, 2560), *_w4a8_routing(rng, cuda, T, E, k),
                w1["q4"], w1["sg"], w2["q4"], w2["s8"], 0)
        got, ref = mk.moe_decode_int4(*args, act_int8=True), mk.moe_decode_int4_plain(*args)
        # the same integers and float steps in the same order: bit-equal but
        # for the last ulp of expf, which can flip one int8 step of h
        err = (got.float() - ref.float()).abs().max()
        assert err <= 2e-2 * ref.float().abs().max(), (T, err)
        assert (got != ref).float().mean() < 1e-2, (T, (got != ref).sum())
    assert mk.moe_decode_int4.launches == before + 5


def test_route_topk_row_gets_the_same_bits_at_every_row_count(cuda):
    """The serving router's logits, and so its choice and weights, do not
    depend on the rows beside a row (a cached prefix page must equal a
    recomputed one)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    gate = torch.randn((64, 2560), generator=g, device=cuda) * 2560**-0.5
    row = _randn(g, 1, 2560)
    ref = tmoe.route_topk(row, gate, 6)
    for T in (2, 7, 32, 112, 256, 896, 4096):
        x = _randn(g, T, 2560)
        for at in (0, T - 1):
            x[at] = row[0]
            got = tmoe.route_topk(x, gate, 6)
            assert torch.equal(got.indices[at], ref.indices[0]), (T, at)
            assert torch.equal(got.weights[at], ref.weights[0]), (T, at)


def test_moe_decode_int4_row_gets_the_same_bits_at_every_row_count(cuda):
    """Above one row (where the combine takes the slots in expert order) a
    token's output does not depend on the tokens beside it."""
    g = torch.Generator(device=cuda).manual_seed(2)
    E, k = 66, 6
    w1, w2 = _w4a8_stack(g, E)
    stacks = (w1["q4"], w1["sg"], w2["q4"], w2["s8"], 0)
    rng = np.random.RandomState(2)
    row, (rind, rw) = _randn(g, 1, 2560), _w4a8_routing(rng, cuda, 1, E, k)
    ref = None
    for T in (2, 7, 32, 33, 112, 114, 128):
        x = _randn(g, T, 2560)
        ind, wts = _w4a8_routing(rng, cuda, T, E, k)
        for at in (0, T - 1):
            x[at], ind[at], wts[at] = row[0], rind[0], rw[0]
            got = mk.moe_decode_int4(x, ind, wts, *stacks, act_int8=True)[at]
            ref = got if ref is None else ref
            assert torch.equal(got, ref), (T, at)


def test_moe_decode_int4_kernel_lists_the_routed_rows(cuda):
    """The kernel's pair lists are routed_rows', an expert no token picks is
    left out, and a second call repeats every bit."""
    g = torch.Generator(device=cuda).manual_seed(1)
    E, k = 66, 6
    w1, w2 = _w4a8_stack(g, E)
    rng = np.random.RandomState(1)
    for T in (1, 32, 128):
        ind, wts = _w4a8_routing(rng, cuda, T, E, k, skip=(5,))
        args = (_randn(g, T, 2560), ind, wts, w1["q4"], w1["sg"], w2["q4"], w2["s8"], 0)
        buf = mk._w4a8(*args)
        order, pos, ids, valid, first, count = mk.routed_rows(ind, E)
        assert torch.equal(buf["pos"].long(), pos)
        meta = buf["meta"].long()
        assert torch.equal(meta[0][valid == 1], ids[valid == 1]) and torch.equal(meta[1], valid)
        assert torch.equal(meta[2][valid == 1], first[valid == 1])
        assert torch.equal(meta[3], count)
        assert 5 not in meta[0][meta[1] == 1].tolist()
        again = mk._w4a8(*args)["out"]
        assert torch.equal(buf["out"], again)
        # the unpicked expert's weights are not read
        w1q4 = w1["q4"].clone()
        w1q4[0, 5] = 0
        assert torch.equal(mk._w4a8(args[0], ind, wts, w1q4, *args[4:])["out"], again)


def test_decode_attention_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    L, B, H, S, D = 2, 3, 20, 1024, 128
    k, v = _randn(g, L, B, H, S, D), _randn(g, L, B, H, S, D)
    ks = torch.clamp_min(k.float().abs().amax(-1), 1e-6) * (1.0 / 127.0)
    vs = torch.clamp_min(v.float().abs().amax(-1), 1e-6) * (1.0 / 127.0)
    kq = torch.round(k.float() / ks[..., None]).to(torch.int8)
    vq = torch.round(v.float() / vs[..., None]).to(torch.int8)
    q = _randn(g, B, H, D)
    lengths = torch.tensor([1000, 1, 333], dtype=torch.int32, device=cuda)
    for args in ((q, kq, vq, 1, lengths, ks, vs), (q, k, v, 1, lengths)):
        # bf16 output; the plain version rounds p * v_scale to bf16 first
        torch.testing.assert_close(da.decode_attention(*args).float(),
                                   da.decode_attention_plain(*args).float(),
                                   rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("cache", ["bf16", "int8", "int4"])
def test_kv_cache_write_kernel_matches_plain(cuda, cache):
    """The 32-lane shapes, with a duplicate lane and two dropped ones."""
    g = torch.Generator(device=cuda).manual_seed(0)
    L, R, H, S, D, B = 28, 32, 20, 384, 128, 34
    Hc = H // 2 if cache == "int4" else H
    if cache == "bf16":
        k, v, kn, vn = (_randn(g, *shape) for shape in [(L, R, Hc, S, D)] * 2 + [(B, Hc, D)] * 2)
        scales = ()
    else:
        def ints(*shape):
            return torch.randint(-128, 128, shape, generator=g, device=cuda, dtype=torch.int8)

        sdt = torch.float32 if cache == "int8" else torch.bfloat16
        k, v, kn, vn = ints(L, R, Hc, S, D), ints(L, R, Hc, S, D), ints(B, Hc, D), ints(B, Hc, D)
        scales = tuple(torch.rand(shape, generator=g, device=cuda).to(sdt)
                       for shape in [(L, R, H, S)] * 2 + [(B, H)] * 2)
    rows = torch.randperm(R, generator=g, device=cuda)[:B - 2].to(torch.int32)
    slots = torch.randint(0, S, (B - 2,), generator=g, device=cuda, dtype=torch.int32)
    # lane 32 repeats lane 0 verbatim; lane 33 lies past the cache and is dropped
    rows = torch.cat([rows, rows[:1], torch.tensor([R], dtype=torch.int32, device=cuda)])
    slots = torch.cat([slots, slots[:1], slots[:1]])
    kn[32], vn[32] = kn[0], vn[0]
    if scales:
        scales[2][32], scales[3][32] = scales[2][0], scales[3][0]
    new = (kn, vn) + scales[2:]
    ref = [t.clone() for t in (k, v) + scales[:2]]
    kw.kv_cache_write_plain(ref[0], ref[1], 5, rows, slots, *new[:2], *ref[2:], *new[2:])
    got = [k, v, *scales[:2]]
    launches = kw.kv_cache_write.launches
    kw.kv_cache_write(got[0], got[1], 5, rows, slots, *new[:2], *got[2:], *new[2:])
    torch.cuda.synchronize()
    assert kw.kv_cache_write.launches == launches + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)  # a byte copy: exact


def test_int4_decode_attention_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    for B, S, lens in ((32, 384, None), (1, 1024, [1000]), (3, 384, [1, 129, 384])):
        L, H, D = 2, 20, 128
        kp = torch.randint(-128, 128, (L, B, H // 2, S, D), generator=g, device=cuda,
                           dtype=torch.int8)
        vp = torch.randint(-128, 128, (L, B, H // 2, S, D), generator=g, device=cuda,
                           dtype=torch.int8)
        ks = (torch.rand((L, B, H, S), generator=g, device=cuda) * 0.3 + 0.05).to(torch.bfloat16)
        vs = (torch.rand((L, B, H, S), generator=g, device=cuda) * 0.3 + 0.05).to(torch.bfloat16)
        lengths = (torch.randint(48, 321, (B,), generator=g, device=cuda) if lens is None
                   else torch.tensor(lens, device=cuda)).to(torch.int32)
        q = _randn(g, B, H, D)
        args = (q, kp, vp, 1, lengths, ks, vs)
        launches = da.decode_attention_int4.launches
        got = da.decode_attention(*args)
        assert da.decode_attention_int4.launches == launches + 1
        # bf16 output; p * v_scale rounds to bf16 on both sides, after the
        # online softmax's rescaling in the kernel and a one-pass softmax in
        # the plain version
        torch.testing.assert_close(got.float(), da.decode_attention_plain(*args).float(),
                                   rtol=1e-2, atol=1e-2)


def _paged_case(g, cuda, pages, B=32, NP=65, maxp=2):
    """A [2, NP, 20, 256, 128] pool (int8 pages with f32 scales, or bf16),
    lane tables shuffled over pages 1.., lengths 48-511 of 512."""
    L, H, PS, D = 2, 20, 256, 128
    shape = (L, NP, H, PS, D)
    if pages == "int8":
        kq, vq = (torch.randint(-128, 128, shape, generator=g, device=cuda, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = ((torch.rand(shape[:-1], generator=g, device=cuda) * 0.02 + 0.005)
                  for _ in range(2))
        cache = pg.PagedKVCache(kq, vq, ks, vs)
    else:
        cache = pg.PagedKVCache(_randn(g, *shape), _randn(g, *shape))
    table = (torch.randperm(NP - 1, generator=g, device=cuda)[:B * maxp] + 1).reshape(B, maxp)
    lengths = torch.randint(48, 512, (B,), generator=g, device=cuda).to(torch.int32)
    return cache, table.to(torch.int32), lengths, _randn(g, B, H, D)


@pytest.mark.parametrize("pages", ["int8", "bf16"])
def test_paged_decode_attention_kernel_matches_plain(cuda, pages):
    """32 lanes on page tables shuffled over a 65-page pool, lengths 48-511
    of 512, one lane past its table, one over a single position, one of
    length 0 (its output 0), and two whose second page id lies outside the
    pool (-1, and NP): their positions there are masked, so they equal the
    plain version over their first page."""
    g = torch.Generator(device=cuda).manual_seed(0)
    cache, table, lengths, q = _paged_case(g, cuda, pages)
    NP, PS = cache.num_pages, cache.page_size
    lengths[0], lengths[1], lengths[2], lengths[3], lengths[4] = 600, 1, 0, 400, 511
    table[3, 1], table[4, 1] = -1, NP
    args = (q, cache, 1, table, lengths)
    launches = pg.paged_decode_attention.launches
    got = pg.paged_decode_attention(*args)
    assert pg.paged_decode_attention.launches == launches + 1
    assert torch.equal(got[2], torch.zeros_like(got[2]))
    # the masked pages: the plain version over the first page alone (a
    # valid id in the table, which the capped length never reaches)
    ref_table, ref_lengths = table.clone(), lengths.clone()
    ref_table[3, 1] = ref_table[4, 1] = 1
    ref_lengths[3] = ref_lengths[4] = PS
    want = pg.paged_decode_attention_plain(q, cache, 1, ref_table, ref_lengths)
    keep = torch.arange(q.shape[0], device=cuda) != 2
    # bf16 output; p (times v_scale) rounds to bf16 on both sides, after the
    # online softmax's rescaling in the kernel and a one-pass softmax in the
    # plain version
    torch.testing.assert_close(got[keep].float(), want[keep].float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("pages", ["int8", "bf16"])
@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_paged_decode_attention_split_matches_plain(cuda, pages, splits):
    """Each forced split of the 512 positions (chunks of 512 down to 64)
    against the plain rendering of the same split and the unsplit plain
    version, 4 lanes at 400-511 (the low-occupancy shape)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    cache, table, lengths, q = _paged_case(g, cuda, pages, B=4, NP=9)
    lengths = torch.tensor([400, 437, 474, 511], dtype=torch.int32, device=cuda)
    args = (q, cache, 1, table, lengths)
    got = pg.paged_decode_attention(*args, splits=splits)
    for want in (pg.paged_decode_attention_split_plain(*args, splits=splits),
                 pg.paged_decode_attention_plain(*args)):
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("pages", ["int8", "bf16"])
def test_paged_decode_attention_lane_bits_do_not_depend_on_other_lanes(cuda, pages):
    """Lane 0's output bits, at the split the wrapper picks, stay the same
    when every other lane's length and table change (same B)."""
    g = torch.Generator(device=cuda).manual_seed(2)
    cache, table, lengths, q = _paged_case(g, cuda, pages)
    first = pg.paged_decode_attention(q, cache, 1, table, lengths)
    for seed in (3, 4):
        g2 = torch.Generator(device=cuda).manual_seed(seed)
        pool = torch.randperm(cache.num_pages - 1, generator=g2, device=cuda) + 1
        other_table = pool[:table.numel()].reshape(table.shape).to(torch.int32)
        other_lengths = torch.randint(0, 600, lengths.shape, generator=g2, device=cuda)
        other_table[0], other_lengths[0] = table[0], lengths[0]
        got = pg.paged_decode_attention(q, cache, 1, other_table, other_lengths.to(torch.int32))
        assert torch.equal(got[0], first[0]), seed


def test_paged_engine_greedy_streams_repeat(cuda):
    """A 2-layer full-width int4 model, 8 lanes on int8 pages: serving the
    same greedy requests twice gives the same streams, through the
    fused prologue (rope_kv_write) and paged decode-attention kernels."""
    text = TextConfig(num_layers=2)
    lm = init_lm_params_serving_int4(text, torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(5, 1000, n)] for n in (48, 48, 20, 300, 7)]
    streams = []
    before = (kw.rope_kv_write.launches, pg.paged_decode_attention.launches)
    for _ in range(2):
        eng = PagedBatchedEngine({"lm": lm}, AriaConfig(text=text), max_lanes=8,
                                 max_seq_len=512, page_size=256, prefill_chunk=128,
                                 decode_chunk=10, cache_dtype=torch.int8)
        uids = [eng.submit(p, max_new_tokens=24) for p in prompts]
        fin = {r.uid: r for r in eng.run_until_complete()}
        streams.append([fin[u].generated for u in uids])
    assert streams[0] == streams[1]
    assert all(len(s) == 24 for s in streams[0])
    assert kw.rope_kv_write.launches > before[0]
    assert pg.paged_decode_attention.launches > before[1]


def test_batched_engine_greedy_streams_repeat(cuda):
    """A 2-layer full-width int4 model, 8 lanes, the int4 KV cache: serving
    the same greedy requests twice gives the same streams, through the
    fused prologue (rope_kv_write) and int4 decode-attention kernels."""
    text = TextConfig(num_layers=2)
    lm = init_lm_params_serving_int4(text, torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(5, 1000, n)] for n in (48, 48, 20, 100, 7)]
    streams = []
    before = (kw.rope_kv_write.launches, da.decode_attention_int4.launches)
    for _ in range(2):
        eng = BatchedEngine({"lm": lm}, AriaConfig(text=text), max_lanes=8, max_seq_len=320,
                            decode_chunk=10, cache_dtype="int4")
        uids = [eng.submit(p, max_new_tokens=24) for p in prompts]
        fin = {r.uid: r for r in eng.run_until_complete()}
        streams.append([fin[u].generated for u in uids])
    assert streams[0] == streams[1]
    assert all(len(s) == 24 for s in streams[0])
    assert kw.rope_kv_write.launches > before[0] and da.decode_attention_int4.launches > before[1]


def test_flash_causal_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    for B, S in ((1, 64), (1, 128), (2, 37), (1, 512), (1, 509)):
        q, k, v = (_randn(g, B, S, 20, 128) for _ in range(3))
        # bf16 output; both round p to bf16 before p.v, the plain version
        # after normalising it
        torch.testing.assert_close(fl.flash_causal(q, k, v).float(),
                                   fl.flash_causal_plain(q, k, v).float(),
                                   rtol=1e-2, atol=1e-2)


def _valid_mask(cuda, B, S, valid):
    """[B, S] bool: a prefix of each length in ``valid``, or "crop": a 980 x
    630 crop's 70 x 45 of the 70 x 70 patches (3,150 valid, interleaved with
    padding inside every 128-key tile)."""
    if valid == "crop":
        side = int(S**0.5)
        grid = torch.zeros((side, side), dtype=torch.bool, device=cuda)
        grid[:, :side * 630 // 980] = True
        return grid.reshape(1, S).expand(B, S).contiguous()
    mask = torch.zeros((B, S), dtype=torch.bool, device=cuda)
    for b, n in enumerate(valid):
        mask[b, :n] = True
    return mask


@pytest.mark.parametrize("B,S,H,D,valid", [(1, 4900, 16, 72, (4900,)), (1, 4900, 16, 72, (2450,)),
                                            (1, 4900, 16, 72, "crop"),
                                            (2, 300, 2, 72, (300, 137)), (1, 129, 4, 64, (129,))])
def test_vit_flash_kernel_matches_plain(cuda, B, S, H, D, valid):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (_randn(g, B, S, H, D) for _ in range(3))
    kv_valid = _valid_mask(cuda, B, S, valid)
    got, ref = vf.vit_flash(q, k, v, kv_valid), vf.vit_flash_plain(q, k, v, kv_valid)
    # valid query rows only (padding rows are garbage by contract); bf16
    # output, and p rounds to bf16 before p.v unnormalised in the kernel,
    # normalised in the plain version
    for b in range(B):
        rows = kv_valid[b]
        torch.testing.assert_close(got[b, rows].float(), ref[b, rows].float(), rtol=1e-2,
                                   atol=1e-2)


def _vit_forms(q, k, v, mask):
    """The two forms of the ViT's attention kernel on one mask, each with
    its plain version."""
    return {"vit": (lambda: vf.vit_flash(q, k, v, mask), lambda: vf.vit_flash_plain(q, k, v, mask)),
            "segment": (lambda: fl.flash_segment(q, k, v, mask, mask),
                        lambda: fl.flash_sdpa_plain(q, k, v, mask, mask))}


@pytest.mark.parametrize("form", ["vit", "segment"])
@pytest.mark.parametrize("B,S,H,valid", [(1, 4900, 16, "crop"), (2, 300, 2, (300, 137))])
def test_vit_attention_bits_repeat(cuda, form, B, S, H, valid):
    """A second call of either form gives the same bits (no atomics, one
    order of sums)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (_randn(g, B, S, H, 72) for _ in range(3))
    run, _ = _vit_forms(q, k, v, _valid_mask(cuda, B, S, valid))[form]
    assert torch.equal(run(), run())


@pytest.mark.parametrize("form", ["vit", "segment"])
@pytest.mark.parametrize("B,S,H,valid", [(1, 4900, 2, "crop"), (2, 300, 2, (300, 137))])
def test_vit_attention_large_logits_match_plain(cuda, form, B, S, H, valid):
    """q and k at 6x their scale, so that a row's running max moves by
    tens across its key tiles and the rescale of O and l by alpha carries
    the result: valid rows (the vit form; every row, the segment form)
    within one bf16 ulp of the element plus 1e-2 (vit) or 3e-3 (segment)."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k = (_randn(g, B, S, H, 72, scale=6.0) for _ in range(2))
    v = _randn(g, B, S, H, 72)
    mask = _valid_mask(cuda, B, S, valid)
    run, plain = _vit_forms(q, k, v, mask)[form]
    got, ref = run(), plain()
    rows = mask if form == "vit" else torch.ones_like(mask)
    torch.testing.assert_close(got[rows].float(), ref[rows].float(), rtol=2**-7,
                               atol=1e-2 if form == "vit" else 3e-3)


def _expert_stack(g, L, E, I, D):
    w1 = {"q4": torch.empty((L, E, 2 * I, D // 2), dtype=torch.int8, device=g.device),
          "sg": torch.empty((L, E, 8, 2 * I), dtype=torch.bfloat16, device=g.device)}
    w2 = {"q4": torch.empty((L, E, I, D // 2), dtype=torch.int8, device=g.device),
          "s8": torch.empty((L, E, 8, D), dtype=torch.bfloat16, device=g.device)}
    for e0 in range(0, E, 11):
        n = min(11, E - e0)
        q1, q2 = quantize_expert_int4(_randn(g, L, n, 2 * I, D, scale=D**-0.5),
                                      _randn(g, L, n, I, D, scale=I**-0.5))
        for dst, src in ((w1, q1), (w2, q2)):
            for leaf in dst:
                dst[leaf][:, e0:e0 + n] = src[leaf]
    return w1, w2


def _prefill_segments(ind, x, E):
    """x's rows scattered into the padded expert segments: (x_seg, dest,
    tile_expert, tile_rows)."""
    dest, tile_e, R, tile_rows = mp.segment_dispatch(ind, E)
    x_seg = torch.zeros((R, x.shape[1]), dtype=x.dtype, device=x.device)
    x_seg[dest.long()] = x.repeat_interleave(ind.shape[1], dim=0)
    return x_seg, dest, tile_e, tile_rows


def _hold_prefill(x_seg, tile_e, tile_rows, experts):
    """The kernel against its plain version on each tile's routed rows, and
    the rows past each tile's count exactly 0; returns the plain output."""
    used = 128 * int((tile_rows > 0).sum())
    ref = mp.moe_prefill_int4_plain(x_seg, tile_e, *experts, tile_rows)
    got = mp.moe_prefill_int4(x_seg, tile_e, *experts, tile_rows)
    routed = (torch.arange(used, device=x_seg.device) % 128
              < tile_rows.repeat_interleave(128)[:used])
    # exact products and f32 sums on both sides, in another order; h rounds
    # to bf16 between the products on both, so a sum near a rounding edge of
    # h moves one row's input to the down product by one bf16 ulp
    err = (got[:used][routed] - ref[:used][routed]).abs().max()
    assert err <= 1e-2 * ref.abs().max(), err.item()
    assert torch.equal(got[:used][~routed], torch.zeros_like(got[:used][~routed]))
    return ref


@pytest.mark.parametrize("T", [129, 512, 2048, 4096])
def test_moe_prefill_int4_kernel_matches_plain(cuda, T):
    """64 routed + 2 shared experts at full width, top-6 + 2 shared: the
    routed rows only, then 128 rows in every tile."""
    g = torch.Generator(device=cuda).manual_seed(0)
    E, I, D = 66, 1664, 2560
    w1, w2 = _expert_stack(g, 1, E, I, D)
    top = torch.topk(torch.randn((T, 64), generator=g, device=cuda), 6, dim=-1)
    shared = torch.arange(64, 66, device=cuda).expand(T, 2)
    ind = torch.cat([top.indices, shared], 1).to(torch.int32)
    wts = torch.cat([torch.softmax(top.values, -1), torch.ones((T, 2), device=cuda)], 1)
    x = _randn(g, T, D)
    experts = (w1["q4"], w1["sg"], w2["q4"], w2["s8"], 0)
    x_seg, dest, tile_e, tile_rows = _prefill_segments(ind, x, E)
    ref = _hold_prefill(x_seg, tile_e, tile_rows, experts)
    full = torch.full_like(tile_rows, 128)  # every row of every tile, padding included
    _hold_prefill(x_seg, tile_e, full, experts)
    # the whole FFN
    before = mp.moe_prefill_int4.launches
    got = mp.experts_segmented_int4(x, ind, wts.to(x.dtype), *experts)
    assert mp.moe_prefill_int4.launches == before + 1
    with torch.no_grad():
        vals = ref[dest.long()].reshape(T, 8, D)
        ref = torch.einsum("tkd,tk->td", vals, wts.to(x.dtype).float()).to(x.dtype)
    err = (got.float() - ref.float()).abs().max()
    assert err <= 1e-2 * ref.float().abs().max(), err.item()


def test_moe_prefill_int4_kernel_takes_every_tile_width(cuda):
    """Experts of 1, 15, 16, 17, 127 and 128 rows (and 129: a full tile and
    one of 1, and none) at a small width, each on its own tile width."""
    g = torch.Generator(device=cuda).manual_seed(1)
    E, I, D = 8, 128, 512
    w1, w2 = _expert_stack(g, 2, E, I, D)
    counts = (1, 15, 16, 17, 127, 128, 0, 129)
    ind = torch.repeat_interleave(torch.arange(E, device=cuda),
                                  torch.tensor(counts, device=cuda))
    ind = ind[torch.randperm(ind.numel(), generator=g, device=cuda)].to(torch.int32)[:, None]
    x_seg, _, tile_e, tile_rows = _prefill_segments(ind, _randn(g, ind.shape[0], D), E)
    assert sorted(tile_rows.tolist()) == sorted([0] * (tile_rows.numel() - 8) +
                                                [1, 15, 16, 17, 127, 128, 128, 1])
    _hold_prefill(x_seg, tile_e, tile_rows, (w1["q4"], w1["sg"], w2["q4"], w2["s8"], 1))


def test_moe_prefill_int4_row_gets_the_same_bits_at_every_row_count(cuda):
    """A row's output does not depend on how many rows share its tile (it
    alone, 40 or 128, at any place in the tile) or on T: a cached prefix
    page must equal a recomputed one."""
    g = torch.Generator(device=cuda).manual_seed(2)
    E, I, D = 66, 1664, 2560
    w1, w2 = _expert_stack(g, 1, E, I, D)
    experts = (w1["q4"], w1["sg"], w2["q4"], w2["s8"], 0)
    row = _randn(g, 1, D)
    tile_e = torch.tensor([5], dtype=torch.int32, device=cuda)
    seen = []
    for n, at in ((1, 0), (40, 17), (40, 39), (128, 100), (128, 0)):
        x_seg = torch.zeros((128, D), dtype=torch.bfloat16, device=cuda)
        x_seg[:n] = _randn(g, n, D)
        x_seg[at] = row[0]
        rows = torch.tensor([n], dtype=torch.int32, device=cuda)
        seen.append(mp.moe_prefill_int4(x_seg, tile_e, *experts, rows)[at])
    for other in seen[1:]:
        assert torch.equal(other, seen[0])
    # token 0, routed to the same 8 experts, in a 129- and a 512-token prompt
    slots = []
    for T in (129, 512):
        top = torch.topk(torch.randn((T, 64), generator=g, device=cuda), 6, dim=-1).indices
        top[0] = torch.arange(6, device=cuda)
        ind = torch.cat([top, torch.arange(64, 66, device=cuda).expand(T, 2)], 1)
        x = _randn(g, T, D)
        x[0] = row[0]
        x_seg, dest, tile_e, tile_rows = _prefill_segments(ind.to(torch.int32), x, E)
        out = mp.moe_prefill_int4(x_seg, tile_e, *experts, tile_rows)
        slots.append(out[dest[:8].long()])
    assert torch.equal(slots[0], slots[1])


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    w = quantize_dense_int4(_randn(g, 1, 512, 256))
    with pytest.raises(TypeError):
        di.dense_int4(_randn(g, 2, 512, dtype=torch.float32), w, 0)
    with pytest.raises(IndexError):
        di.dense_int4(_randn(g, 2, 512), w, 1)
    with pytest.raises(ValueError):
        q = _randn(g, 1, 8, 2, 64)
        fl.flash_causal(q, q, q)
    q = _randn(g, 1, 64, 2, 72)
    with pytest.raises(TypeError):
        vf.vit_flash(q.float(), q.float(), q.float())
    for D in (60, 80, 128):  # the kernel takes D = 64 and 72 only
        with pytest.raises(ValueError):
            vf.vit_flash(*(_randn(g, 1, 64, 2, D) for _ in range(3)))
    with pytest.raises(ValueError):  # not contiguous
        vf.vit_flash(q, q.transpose(1, 2).contiguous().transpose(1, 2), q)
    with pytest.raises(TypeError):  # the mask is bool
        vf.vit_flash(q, q, q, torch.ones((1, 64), dtype=torch.int32, device=cuda))
    w1, w2 = _expert_stack(g, 1, 4, 128, 512)
    tile_e = torch.zeros(2, dtype=torch.int32, device=cuda)
    rows = torch.tensor([128, 72], dtype=torch.int32, device=cuda)
    experts = (w1["q4"], w1["sg"], w2["q4"], w2["s8"])
    with pytest.raises(TypeError):
        mp.moe_prefill_int4(_randn(g, 256, 512, dtype=torch.float32), tile_e, *experts, 0, rows)
    with pytest.raises(ValueError):  # rows not whole 128-row tiles
        mp.moe_prefill_int4(_randn(g, 200, 512), tile_e, *experts, 0, rows)
    with pytest.raises(IndexError):
        mp.moe_prefill_int4(_randn(g, 256, 512), tile_e, *experts, 1, rows)
    with pytest.raises(TypeError):  # the tiles' row counts are int32
        mp.moe_prefill_int4(_randn(g, 256, 512), tile_e, *experts, 0, rows.long())
    with pytest.raises(ValueError):  # one count a tile
        mp.moe_prefill_int4(_randn(g, 256, 512), tile_e, *experts, 0, rows[:1])


def _fp_stack(g, E, I, D, form):
    """One layer of 64 + 2 experts at full width, bf16 or int8 with s8."""
    w1, w2 = _randn(g, 1, E, 2 * I, D, scale=D**-0.5), _randn(g, 1, E, I, D, scale=I**-0.5)
    if form == "bf16":
        return w1, None, w2, None
    q1, q2 = with_s8(quantize_weight(w1, input_axis=-1)), with_s8(quantize_weight(w2, input_axis=-2))
    return q1["q"], q1["s8"], q2["q"], q2["s8"]


def _top6(g, T, E):
    top = torch.topk(torch.randn((T, E - 2), generator=g, device=g.device), 6, dim=-1)
    shared = torch.arange(E - 2, E, device=g.device).expand(T, 2)
    ind = torch.cat([top.indices, shared], 1).to(torch.int32)
    wts = torch.cat([torch.softmax(top.values, -1), torch.ones((T, 2), device=g.device)], 1)
    return ind, wts.to(torch.bfloat16)


@pytest.mark.parametrize("form", ["bf16", "int8"])
def test_moe_decode_fp_kernels_match_plain(cuda, form):
    """moe_decode (bf16) and moe_decode_quant (int8, the routed-pair kernel
    of csrc/moe_decode_bf16x.cu) at full width, 64 + 2 experts, top-6 + 2
    shared, T = 1, 5, 32 and 128."""
    g = torch.Generator(device=cuda).manual_seed(0)
    E, I, D = 66, 1664, 2560
    w1, s1, w2, s2 = _fp_stack(g, E, I, D, form)
    for T in (1, 5, 32, 128):
        ind, wts = _top6(g, T, E)
        x = _randn(g, T, D)
        if form == "bf16":
            wrapper, args = mk.moe_decode, (x, ind, wts, w1, w2, 0)
            ref = mk.moe_decode_plain(*args)
        else:
            wrapper, args = mk.moe_decode_quant, (x, ind, wts, w1, s1, w2, s2, 0)
            ref = mk.moe_decode_plain(x, ind, wts, w1, w2, 0, s1, s2)
        launches = wrapper.launches
        got = wrapper(*args)
        torch.cuda.synchronize()
        assert wrapper.launches == launches + 1
        # exact products and f32 sums in another order; h and the output
        # round to bf16 on both sides, so a sum at a rounding edge of h
        # moves by one bf16 ulp
        err = (got.float() - ref.float()).abs().max()
        assert err <= 1e-2 * ref.float().abs().max(), (T, err.item())
    if form == "int8":
        with pytest.raises(ValueError):  # more rows than a decode step has
            mk.moe_decode_quant(_randn(g, 129, D), *_top6(g, 129, E), w1, s1, w2, s2, 0)


def _groups(g, M, E, empty):
    """E group sizes summing to M, the groups in ``empty`` without rows."""
    w = torch.rand(E, generator=g, device=g.device)
    w[list(empty)] = 0
    sizes = torch.floor(w / w.sum() * M).to(torch.int32)
    sizes[E - 1 if E - 1 not in empty else 0] += M - int(sizes.sum())
    return sizes


@pytest.mark.parametrize("transpose_rhs", [True, False])
def test_gmm_kernel_matches_plain(cuda, transpose_rhs):
    """The w1 layout [E, 2I, D] and the w2 layout [E, I, D] at 512 x 8,
    2048 x 8 and the full recipe's 2048 x 8 x 6 rows, 66 groups with empty
    ones and groups that start and end inside 128-row tiles."""
    g = torch.Generator(device=cuda).manual_seed(0)
    E, I, D = 66, 1664, 2560
    K, N = (D, 2 * I) if transpose_rhs else (I, D)
    rhs = _randn(g, E, N, K, scale=K**-0.5) if transpose_rhs else _randn(g, E, K, N, scale=K**-0.5)
    for M in (4096, 16384, 98304):
        sizes = _groups(g, M, E, empty=(0, 7, 40, 41))
        lhs = _randn(g, M, K)
        launches = tmoe.gmm.launches
        got = tmoe.gmm(lhs, rhs, sizes, transpose_rhs)
        torch.cuda.synchronize()
        assert tmoe.gmm.launches == launches + 1
        ref = tmoe.gmm_plain(lhs, rhs, sizes, transpose_rhs)
        # exact bf16 products, f32 sums in another order
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * ref.abs().max().item())


def test_gmm_row_gets_the_same_bits_at_every_row_count(cuda):
    """Row 0 alone in a 128-row call and among 4096 rows in 66 groups; and a
    row of group 1 at offset 77 of its group's first tile among 4096 rows
    (group 0 holds 50) against the same row at offset 30 in a 256-row call
    (group 0 holds 10), both layouts."""
    g = torch.Generator(device=cuda).manual_seed(1)
    E, K, N = 66, 2560, 3328
    rhs = _randn(g, E, N, K, scale=K**-0.5)
    lhs = _randn(g, 4096, K)
    sizes = _groups(g, 4096, E, empty=(3,))
    small = torch.zeros(E, dtype=torch.int32, device=cuda)
    small[0] = 128
    big = tmoe.gmm(lhs, rhs, sizes, True)
    one = tmoe.gmm(lhs[:128].contiguous(), rhs, small, True)
    assert torch.equal(big[0], one[0])
    sizes_a = torch.cat([torch.tensor([50, 300], dtype=torch.int32, device=cuda),
                         _groups(g, 4096 - 350, E - 2, empty=(3,))])
    sizes_b = torch.zeros(E, dtype=torch.int32, device=cuda)
    sizes_b[:2] = torch.tensor([10, 246], dtype=torch.int32, device=cuda)
    for w, trans in ((rhs, True), (_randn(g, E, K, N, scale=K**-0.5), False)):
        lhs_b = _randn(g, 256, K)
        lhs_b[40] = lhs[127]
        many, few = tmoe.gmm(lhs, w, sizes_a, trans), tmoe.gmm(lhs_b, w, sizes_b, trans)
        assert torch.equal(many[127], few[40])


@pytest.mark.parametrize("transpose_rhs", [True, False])
def test_gmm_groups_inside_tiles_match_plain(cuda, transpose_rhs):
    """Groups of 1 to 127 rows that start and end inside 128-row tiles,
    empty groups between them, and one group over several tiles: every
    row held against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(2)
    E, K, N = 12, 512, 384
    rhs = _randn(g, E, N, K, scale=K**-0.5) if transpose_rhs else _randn(g, E, K, N, scale=K**-0.5)
    sizes = torch.tensor([37, 0, 90, 5, 127, 1, 0, 64, 200, 3, 100, 269], dtype=torch.int32,
                         device=cuda)
    assert int(sizes.sum()) % 128 == 0
    lhs = _randn(g, int(sizes.sum()), K)
    got = tmoe.gmm(lhs, rhs, sizes, transpose_rhs)
    ref = tmoe.gmm_plain(lhs, rhs, sizes, transpose_rhs)
    # exact bf16 products, f32 sums in another order
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * ref.abs().max().item())


def test_fp_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    w1, w2 = _randn(g, 1, 4, 256, 256), _randn(g, 1, 4, 128, 256)
    ind = torch.zeros((129, 2), dtype=torch.int32, device=cuda)
    ind[:, 1] = 1
    wts = torch.ones((129, 2), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):  # more than 128 rows
        mk.moe_decode(_randn(g, 129, 256), ind, wts, w1, w2, 0)
    with pytest.raises(TypeError):
        mk.moe_decode(_randn(g, 2, 256, dtype=torch.float32), ind[:2], wts[:2], w1, w2, 0)
    with pytest.raises(IndexError):
        mk.moe_decode(_randn(g, 2, 256), ind[:2], wts[:2], w1, w2, 1)
    sizes = torch.tensor([100, 28], dtype=torch.int32, device=cuda)
    rhs = _randn(g, 2, 256, 128)
    with pytest.raises(ValueError):  # rows not whole 128-row tiles
        tmoe.gmm(_randn(g, 100, 128), rhs, sizes, True)
    with pytest.raises(TypeError):  # group sizes are int32
        tmoe.gmm(_randn(g, 128, 128), rhs, sizes.long(), True)
    with pytest.raises(ValueError):  # rhs not [E, N, K]
        tmoe.gmm(_randn(g, 128, 256), rhs, sizes, True)


# ------------------------------------------------------------ training kernels


@pytest.mark.parametrize("B,S,H", [(1, 64, 4), (2, 640, 4), (1, 1000, 20), (1, 2048, 20),
                                   (8, 2048, 20)])
def test_flash_causal_backward_matches_plain(cuda, B, S, H):
    """dq, dk, dv of the backward kernel against autograd of the plain
    version on the same q, k, v, do (bf16; the forward's row statistics)."""
    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v, do = (_randn(g, B, S, H, 128) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    launches = fl.flash_causal_bwd.launches
    out = fl.flash_causal(*leaves)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert fl.flash_causal_bwd.launches == launches + 1
    # equal to the serving forward, which keeps no statistics
    assert torch.equal(out.detach(), fl.flash_causal(q, k, v))
    ref = fl.flash_causal_bwd_plain(q, k, v, do)
    for name, a, b in zip("qkv", got, ref):
        # bf16 outputs; p and ds enter their products as bf16 in the kernel,
        # the plain version's p as bf16 and ds in f32
        scale = b.float().abs().max().item()
        torch.testing.assert_close(a.float(), b.float(), rtol=2e-2, atol=2e-2 * scale,
                                   msg=f"d{name}")


@pytest.mark.parametrize("B,S", [(1, 1000), (4, 2048)])
def test_flash_causal_backward_bits_repeat(cuda, B, S):
    """dq, dk and dv get the same bits from a second call: the key tiles add
    to dq in their order, whatever order the blocks run in."""
    g = torch.Generator(device=cuda).manual_seed(B * 4096 + S)
    q, k, v, do = (_randn(g, B, S, 20, 128) for _ in range(4))
    lse = torch.empty((B, 20, S), dtype=torch.float32, device=cuda)
    out = fl._forward(q, k, v, 128**-0.5, lse)
    first = fl.flash_causal_bwd(q, k, v, out, do, lse)
    for _ in range(3):
        again = fl.flash_causal_bwd(q, k, v, out, do, lse)
        for name, a, b in zip("qkv", first, again):
            assert torch.equal(a, b), f"d{name}"


@pytest.mark.parametrize("transpose_rhs", [True, False])
def test_gmm_dlhs_and_tgmm_match_plain(cuda, transpose_rhs):
    """The backward of the w1 ([E, 2I, D], transpose_rhs) and w2 ([E, I, D])
    products at 512 x 8 rows in 66 groups, four of them empty and the
    others straddling tiles: the f32 cotangent is a bf16 value times a
    bf16 combine weight, as in training, so the split into bf16 hi + lo
    is exact."""
    g = torch.Generator(device=cuda).manual_seed(2)
    E, I, D, M = 66, 1664, 2560, 4096
    K, N = (D, 2 * I) if transpose_rhs else (I, D)
    rhs = _randn(g, E, N, K, scale=K**-0.5) if transpose_rhs else _randn(g, E, K, N, scale=K**-0.5)
    sizes = _groups(g, M, E, empty=(0, 7, 40, 41))
    lhs = _randn(g, M, K)
    grad = (_randn(g, M, N).float() * _randn(g, M, 1).float()).contiguous()
    n_dlhs, n_tgmm = tmoe.gmm_dlhs.launches, tmoe.tgmm.launches
    dlhs = tmoe.gmm_dlhs(grad, rhs, sizes, not transpose_rhs)
    drhs = tmoe.tgmm(lhs, grad, sizes)
    torch.cuda.synchronize()
    assert (tmoe.gmm_dlhs.launches, tmoe.tgmm.launches) == (n_dlhs + 1, n_tgmm + 1)
    ref = tmoe.gmm_plain(grad, rhs, sizes, not transpose_rhs)
    assert dlhs.dtype == torch.bfloat16
    # exact products (hi + lo), f32 sums in another order, one bf16 rounding
    torch.testing.assert_close(dlhs.float(), ref, rtol=1e-2, atol=1e-3 * ref.abs().max().item())
    ref = tmoe.tgmm_plain(lhs, grad, sizes)
    assert drhs.shape == (E, K, N) and drhs.dtype == torch.bfloat16
    torch.testing.assert_close(drhs.float(), ref, rtol=1e-2, atol=1e-3 * ref.abs().max().item())
    for e in (0, 7, 40, 41):
        assert torch.equal(drhs[e], torch.zeros_like(drhs[e]))


@pytest.mark.parametrize("transpose_rhs", [True, False])
def test_gmm_backward_bf16_exact_cotangent_takes_one_product(cuda, transpose_rhs):
    """Training's w1 cotangent, the f32 upcast of a bf16 gradient: the split
    flags no tile, the kernels match the plain versions, and they give the
    same bits as with every flag set (the lo products then add zeros)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    E, I, D, M = 66, 1664, 2560, 4096
    K, N = (D, 2 * I) if transpose_rhs else (I, D)
    rhs = _randn(g, E, N, K, scale=K**-0.5) if transpose_rhs else _randn(g, E, K, N, scale=K**-0.5)
    sizes = _groups(g, M, E, empty=(0, 7, 40, 41))
    lhs = _randn(g, M, K)
    grad = _randn(g, M, N).float()
    split = tmoe.split_hi_lo(grad)
    assert int(split[2].sum()) == 0 and not split[1].any()
    both = (split[0], split[1], torch.ones_like(split[2]))
    dlhs = tmoe.gmm_dlhs(grad, rhs, sizes, not transpose_rhs, split=split)
    drhs = tmoe.tgmm(lhs, grad, sizes, split=split)
    assert torch.equal(dlhs, tmoe.gmm_dlhs(grad, rhs, sizes, not transpose_rhs, split=both))
    assert torch.equal(drhs, tmoe.tgmm(lhs, grad, sizes, split=both))
    ref = tmoe.gmm_plain(grad, rhs, sizes, not transpose_rhs)
    torch.testing.assert_close(dlhs.float(), ref, rtol=1e-2, atol=1e-3 * ref.abs().max().item())
    ref = tmoe.tgmm_plain(lhs, grad, sizes)
    torch.testing.assert_close(drhs.float(), ref, rtol=1e-2, atol=1e-3 * ref.abs().max().item())


@pytest.mark.parametrize("M,N", [(4096, 3328), (4000, 2560), (96, 256)])
def test_split_hi_lo_kernel_matches_plain(cuda, M, N):
    """The split kernel against its plain version, bit for bit, for a
    16-bit cotangent with one 128-row tile bf16-exact, and a bf16-exact one."""
    g = torch.Generator(device=cuda).manual_seed(M)
    x = (_randn(g, M, N).float() * _randn(g, M, 1).float()).contiguous()
    x[:128] = _randn(g, min(M, 128), N).float()
    for grad in (x, _randn(g, M, N).float()):
        launches = tmoe.split_hi_lo.launches
        got = tmoe.split_hi_lo(grad)
        torch.cuda.synchronize()
        assert tmoe.split_hi_lo.launches == launches + 1
        for a, b in zip(got, tmoe.split_hi_lo_plain(grad)):
            assert torch.equal(a, b)
    assert tmoe.split_hi_lo(x)[2][0].item() == 0


@pytest.mark.parametrize("transpose_rhs", [True, False])
def test_gmm_backward_cancellation_witness(cuda, transpose_rhs):
    """gmm_dlhs: one row whose cotangent is 1 + 2^-12 and -1 at two
    contraction columns whose rhs rows are equal; tgmm: a group of two rows
    with equal lhs and cotangents (1 + 2^-12) v and -v. The exact results are
    2^-12 times the shared values, held to 1e-2 of their own size (one bf16
    rounding); with every flag cleared (the lo product skipped) they read
    about 1."""
    g = torch.Generator(device=cuda).manual_seed(5)
    E, I, D, M, eps = 66, 1664, 2560, 4096, 2.0**-12
    K, N = (D, 2 * I) if transpose_rhs else (I, D)
    rhs = _randn(g, E, N, K, scale=K**-0.5) if transpose_rhs else _randn(g, E, K, N, scale=K**-0.5)
    sizes = _groups(g, M, E, empty=(0, 7, 40, 41))
    sizes[6] -= 2
    sizes[7] = 2
    start = torch.cumsum(sizes, 0) - sizes
    r1, r3, c1, c2 = int(start[7]), int(start[8]), 3, 200
    lhs = _randn(g, M, K)
    lhs[r1 + 1] = lhs[r1]
    grad = (_randn(g, M, N).float() * _randn(g, M, 1).float()).contiguous()
    v = grad[r1].bfloat16().float()
    grad[r1], grad[r1 + 1] = v * (1 + eps), -v
    grad[r3] = 0
    grad[r3, c1], grad[r3, c2] = 1 + eps, -1.0
    if transpose_rhs:  # gmm_dlhs reads rhs [E, 2I, D] with contraction rows
        rhs[8, c2] = rhs[8, c1]
        b = rhs[8, c1]
    else:  # [E, I, D] transposed: contraction columns
        rhs[8, :, c2] = rhs[8, :, c1]
        b = rhs[8, :, c1]
    want_d = b.double() * eps
    want_t = torch.outer(lhs[r1].double(), v.double()) * eps

    def rel(got, want):
        return ((got.double() - want).abs().max() / want.abs().max()).item()

    split = tmoe.split_hi_lo(grad)
    fault = (split[0], split[1], torch.zeros_like(split[2]))
    for sp, ok in ((split, True), (fault, False)):
        d = rel(tmoe.gmm_dlhs(grad, rhs, sizes, not transpose_rhs, split=sp)[r3], want_d)
        t = rel(tmoe.tgmm(lhs, grad, sizes, split=sp)[7], want_t)
        if ok:
            assert d <= 1e-2 and t <= 1e-2, (d, t)
        else:
            assert d > 0.5 and t > 0.5, (d, t)


def test_experts_ragged_backward_runs_the_kernels(cuda):
    """Autograd through experts_ragged on the card launches gmm, gmm_dlhs
    and tgmm, and its gradients agree with the plain versions' on the CPU."""
    g = torch.Generator(device=cuda).manual_seed(3)
    T, D, I, E, k = 200, 256, 128, 8, 2
    x = _randn(g, T, D)
    ids = torch.argsort(torch.rand(T, E, generator=g, device=cuda), 1)[:, :k].to(torch.int32)
    w = torch.softmax(torch.randn(T, k, generator=g, device=cuda), 1).bfloat16()
    w1, w2 = _randn(g, E, 2 * I, D, scale=D**-0.5), _randn(g, E, I, D, scale=I**-0.5)
    cot = _randn(g, T, D)
    grads = []
    splits = tmoe.split_hi_lo.launches
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.to(dev).clone().requires_grad_() for t in (x, w, w1, w2)]
        out = tmoe.experts_ragged(leaves[0], ids.to(dev), leaves[1], leaves[2], leaves[3])
        grads.append([t.float().cpu() for t in torch.autograd.grad(out, leaves, cot.to(dev))])
    assert tmoe.split_hi_lo.launches == splits + 2  # one split for each product's backward
    for name, a, b in zip(("x", "weights", "w1", "w2"), *grads):
        torch.testing.assert_close(a, b, rtol=2e-2, atol=2e-2 * b.abs().max().item(), msg=name)


def test_lm_head_logits_are_the_f32_product(cuda):
    """(f): the int8 lm_head's logits are the f32 product of the bf16
    activations and the int8 weights times the f32 scales, never rounded
    to bf16 (a logit near 20 would otherwise move by up to 0.0625)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = _randn(g, 1, 7, 2560)
    head = quantize_weight(_randn(g, 2560, 100352, scale=2560**-0.5))
    got = linear(x, head)
    assert got.dtype == torch.float32
    ref = (x.double() @ head["q"].double()) * head["s"].double()
    torch.testing.assert_close(got.double(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("form", ["int4", "int8"])
def test_expert_block_dequant_kernel_matches_plain(cuda, form):
    """Blocks of 11 of a full-width layer of 66 experts, bf16 and f32 out:
    bit-equal to the plain version (one rounding of an exact product)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    E, I, D = 22, 1664, 2560
    if form == "int4":
        w1, w2 = _expert_stack(g, 1, E, I, D)
    else:
        q1, _, q2, _ = _fp_stack(g, E, I, D, "int8")
        s1 = torch.rand((1, E, 2 * I), generator=g, device=cuda) * 1e-2
        s2 = torch.rand((1, E, D), generator=g, device=cuda) * 1e-2
        w1, w2 = {"q": q1, "s": s1}, {"q": q2, "s": s2}
    before = ed.expert_block_dequant.launches
    for w, kind in ((w1, "w1"), (w2, "w2")):
        layer = {k: v[0] for k, v in w.items()}
        for e0 in (0, 11):
            for dtype in (torch.bfloat16, torch.float32):
                got = ed.expert_block_dequant(layer, kind, e0, 11, dtype)
                want = ed.expert_block_dequant_plain(layer, kind, e0, 11, dtype)
                assert got.dtype == dtype and got.shape == want.shape
                assert torch.equal(got, want), (kind, e0, dtype)
    assert ed.expert_block_dequant.launches == before + 8
    with pytest.raises(IndexError):
        ed.expert_block_dequant({k: v[0] for k, v in w1.items()}, "w1", 12, 11)


@pytest.mark.parametrize("T", [1, 5, 8, 9, 32, 40])
def test_dense_int4_a8_kernel_matches_plain(cuda, T):
    """W4A8 wqkv and wo at full width: the integer dots are exact and the
    float steps are the plain version's, each rounded once, so bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(1)
    before = di.dense_int4_a8.launches
    for F in (7680, 2560):
        w = quantize_dense_int4(_randn(g, 2, 2560, F, scale=2560**-0.5))
        x = _randn(g, T, 2560)
        got, ref = di.dense_int4(x, w, 1, act_int8=True), di.dense_int4_a8_plain(x, w, 1)
        assert got.dtype == torch.float32 and torch.equal(got, ref), (T, F)
    assert di.dense_int4_a8.launches == before + 2
    with pytest.raises(TypeError):
        di.dense_int4(x.float(), w, 1, act_int8=True)


@pytest.mark.parametrize("D,F", [(2048, 512), (256, 384), (160, 200)])
def test_dense_int4_a8_kernel_takes_other_widths(cuda, D, F):
    """Groups of 256 (D 2048: x quantized in the split from two reads),
    one group of whole stages (D 256) and one whose last stage is partly
    past its end (D 160), on both sides of the split: bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(7)
    w = quantize_dense_int4(_randn(g, 2, D, F, scale=D**-0.5))
    for T in (1, 8, 9, 33):
        x = _randn(g, T, D)
        assert torch.equal(di.dense_int4_a8(x, w, 1), di.dense_int4_a8_plain(x, w, 1)), (D, T)


def test_dense_int4_a8_row_gets_the_same_bits_at_every_row_count(cuda):
    """One token's W4A8 output bits alone, among 8 rows (the split over the
    D-groups, x quantized in the kernel) and among 32 (act_quant_int8 first,
    one block over every group), wqkv and wo."""
    g = torch.Generator(device=cuda).manual_seed(4)
    for F in (7680, 2560):
        w = quantize_dense_int4(_randn(g, 1, 2560, F, scale=2560**-0.5))
        row = _randn(g, 1, 2560)
        ref = di.dense_int4_a8(row, w, 0)
        assert torch.equal(ref, di.dense_int4_a8_plain(row, w, 0))
        for T in (8, 32):
            x = _randn(g, T, 2560)
            for at in (0, T - 1):
                x[at] = row[0]
                assert torch.equal(di.dense_int4_a8(x, w, 0)[at], ref[0]), (F, T, at)


def _kernels_launched(fn) -> list:
    """The names of the card's kernels one call of fn launches (profiled;
    one warm-up call first)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def test_dense_int4_a8_and_paged_attention_launch_once_a_call(cuda):
    """One kernel a call: dense_int4_a8 up to 8 rows (x quantized in the
    kernel) and paged_decode_attention split over positions (the merge in
    the same launch); above 8 rows dense_int4_a8 is act_quant_int8 then the
    kernel. Each wrapper counts one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(6)
    w = quantize_dense_int4(_randn(g, 1, 2560, 7680, scale=2560**-0.5))
    for T, want in ((1, ["dense_int4_a8_kernel"]), (8, ["dense_int4_a8_kernel"]),
                    (32, ["act_quant_kernel", "dense_int4_a8_kernel"])):
        x = _randn(g, T, 2560)
        before = di.dense_int4_a8.launches
        names = _kernels_launched(lambda: di.dense_int4_a8(x, w, 0))
        assert di.dense_int4_a8.launches == before + 2
        assert len(names) == len(want) and all(n in got for n, got in zip(want, names)), names
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for pages in ("int8", "bf16"):
        for B, NP in ((32, 65), (4, 9)):  # one block a lane's head; split, P > 1
            cache, table, lengths, q = _paged_case(g, cuda, pages, B=B, NP=NP)
            assert (pg.paged_split_count(B, 20, 2, 256, sms) > 1) == (B == 4)
            before = pg.paged_decode_attention.launches
            names = _kernels_launched(lambda: pg.paged_decode_attention(q, cache, 1, table,
                                                                        lengths))
            assert pg.paged_decode_attention.launches == before + 2
            assert len(names) == 1 and "decode_attention_kernel" in names[0], names


@pytest.mark.parametrize("T", [1, 5, 32, 128])
def test_moe_decode_int4_bf16_kernel_matches_plain(cuda, T):
    """The bf16-activation int4 MoE at full width, 64 + 2 experts."""
    g = torch.Generator(device=cuda).manual_seed(2)
    E, I, D = 66, 1664, 2560
    w1, w2 = _expert_stack(g, 1, E, I, D)
    ind, wts = _top6(g, T, E)
    args = (_randn(g, T, D), ind, wts, w1["q4"], w1["sg"], w2["q4"], w2["s8"], 0)
    before = mk.moe_decode_int4_bf16.launches
    got, ref = mk.moe_decode_int4(*args), mk.moe_decode_int4_bf16_plain(*args)
    assert mk.moe_decode_int4_bf16.launches == before + 1
    # exact products and f32 sums on both sides in another order; h rounds
    # to bf16 on both, so a sum at a rounding edge moves by one bf16 ulp;
    # bf16 output
    err = (got.float() - ref.float()).abs().max()
    assert err <= 1e-2 * ref.float().abs().max(), (T, err.item())
    with pytest.raises(ValueError):  # more rows than a decode step has
        mk.moe_decode_int4(_randn(g, 129, D), *_top6(g, 129, E), *args[3:])


def _bf16x_case(g, form, E=66, I=1664, D=2560):
    """One layer of 64 + 2 experts at full width for a routed bf16-activation
    kernel (csrc/moe_decode_bf16x.cu): the wrapper, its routed-pair plain
    version, and the stacks both take after (x, indices, weights)."""
    if form == "int4":
        w1, w2 = _expert_stack(g, 1, E, I, D)
        return (mk.moe_decode_int4_bf16, mk.moe_decode_int4_bf16_routed_plain,
                (w1["q4"], w1["sg"], w2["q4"], w2["s8"], 0))
    q1, s1, q2, s2 = _fp_stack(g, E, I, D, "int8")
    return mk.moe_decode_quant, mk.moe_decode_quant_routed_plain, (q1, s1, q2, s2, 0)


@pytest.mark.parametrize("form", ["int4", "int8"])
def test_bf16x_row_gets_the_same_bits_at_every_row_count(cuda, form):
    """A token's output bits do not depend on the tokens beside it: alone
    (its slots in ascending expert order, the order the combine takes above
    one row), among 32 rows and among 128, as the first and the last row;
    its pairs then sit in other chunks at other offsets."""
    g = torch.Generator(device=cuda).manual_seed(5)
    E = 66
    wrapper, _, stacks = _bf16x_case(g, form)
    rng = np.random.RandomState(5)
    row, (rind, rw) = _randn(g, 1, 2560), _w4a8_routing(rng, cuda, 1, E, 6)
    up = torch.argsort(rind[0])
    rind, rw = rind[:, up], rw[:, up]
    ref = wrapper(row, rind, rw, *stacks)[0]
    for T in (32, 128):
        x = _randn(g, T, 2560)
        ind, wts = _w4a8_routing(rng, cuda, T, E, 6)
        for at in (0, T - 1):
            x[at], ind[at], wts[at] = row[0], rind[0], rw[0]
            assert torch.equal(wrapper(x, ind, wts, *stacks)[at], ref), (T, at)


@pytest.mark.parametrize("form", ["int4", "int8"])
def test_bf16x_kernel_lists_the_routed_rows(cuda, form):
    """At T = 128, an expert that one token picks (1 row), the shared
    experts (128 rows: 8 work-list entries each) and two experts that no
    token picks: the kernel matches its routed-pair plain version, launches
    once a call, lists the pairs as routed_rows does, and its work list
    holds one entry for each 16-row chunk of each picked expert, in u order,
    then -1; the unpicked experts' weights are not read, and a second call
    repeats every bit."""
    g = torch.Generator(device=cuda).manual_seed(6)
    E, T = 66, 128
    wrapper, plain, stacks = _bf16x_case(g, form)
    rng = np.random.RandomState(6)
    ind, wts = _w4a8_routing(rng, cuda, T, E, 6, skip=(5, 9))
    ind[7, 0] = 5
    x = _randn(g, T, 2560)
    before = wrapper.launches
    got = wrapper(x, ind, wts, *stacks)
    assert wrapper.launches == before + 1
    ref = plain(x, ind, wts, *stacks)
    err = (got.float() - ref.float()).abs().max()
    assert err <= 1e-2 * ref.float().abs().max(), err.item()
    buf = mk._bf16x("bf16x", x, ind, wts, *stacks, int4=form == "int4")
    order, pos, ids, valid, first, count = mk.routed_rows(ind, E)
    assert torch.equal(buf["pos"].long(), pos)
    meta, ok = buf["meta"].long(), valid == 1
    assert torch.equal(meta[0][ok], ids[ok]) and torch.equal(meta[1], valid)
    assert torch.equal(meta[2][ok], first[ok]) and torch.equal(meta[3], count)
    assert count[ids == 5].tolist() == [1] and count[ids >= E - 2].tolist() == [T, T]
    assert 9 not in ids[ok].tolist()
    want = [u | c << 16 for u in range(len(ids)) if valid[u]
            for c in range(-(-int(count[u]) // mk.PAIR_CHUNK))]
    work = buf["work"].tolist()
    assert work == want + [-1] * (len(work) - len(want))
    assert torch.equal(buf["out"], got)
    w1 = stacks[0].clone()
    w1[0, 9] = 0
    assert torch.equal(wrapper(x, ind, wts, w1, *stacks[1:]), got)


# At the ViT's 4,900 patches the outputs are ~0.024 in rms and ~0.14 at most:
# an absolute 3e-3, ~3x the one bf16 ulp (9.8e-4) the kernel reads there. The
# shorter rows' outputs reach ~1, so they also take one bf16 ulp of the element.
@pytest.mark.parametrize("B,S,H,D,valid,rtol", [(1, 4900, 16, 72, (4900,), 0.0),
                                                 (1, 4900, 16, 72, (3150,), 0.0),
                                                 (1, 4900, 16, 72, "crop", 0.0),
                                                 (2, 300, 2, 72, (300, 137), 2**-7),
                                                 (1, 129, 4, 64, (100,), 2**-7)])
def test_flash_segment_kernel_matches_plain(cuda, B, S, H, D, valid, rtol):
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (_randn(g, B, S, H, D) for _ in range(3))
    mask = _valid_mask(cuda, B, S, valid)
    before = fl.flash_segment.launches
    got = fl.flash_sdpa(q, k, v, q_valid=mask, kv_valid=mask)
    ref = fl.flash_sdpa_plain(q, k, v, mask, mask)
    assert fl.flash_segment.launches == before + 1
    # every row: pad queries attend pad keys on both sides; bf16 output, p
    # rounds to bf16 before p.v relative to the running max in the kernel
    # and to the row max in the plain version
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=3e-3)
    unmasked = fl.flash_segment(q, k, v)
    torch.testing.assert_close(unmasked.float(), fl.flash_sdpa_plain(q, k, v).float(),
                               rtol=rtol, atol=3e-3)
    for bad in (60, 80, 128):  # the kernel takes the ViT's head dims only
        with pytest.raises(ValueError):
            fl.flash_segment(*(_randn(g, 1, 64, 2, bad) for _ in range(3)))


# Sq != Sk: the query tiles follow Sq and the key tiles and masks Sk. The
# first case's queries are the crop's first 300 patches over its 4,900 keys.
@pytest.mark.parametrize("B,Sq,Sk,H,D,q_valid,kv_valid,rtol", [
    (1, 300, 4900, 16, 72, "crop", "crop", 0.0),
    (2, 129, 300, 2, 72, (129, 60), (300, 137), 2**-7),
    (1, 300, 129, 4, 64, (250,), (100,), 2**-7)])
def test_flash_segment_kernel_takes_sq_other_than_sk(cuda, B, Sq, Sk, H, D, q_valid, kv_valid,
                                                      rtol):
    g = torch.Generator(device=cuda).manual_seed(7)
    q = _randn(g, B, Sq, H, D)
    k, v = (_randn(g, B, Sk, H, D) for _ in range(2))
    qm = _valid_mask(cuda, B, Sk, q_valid)[:, :Sq].contiguous() if q_valid == "crop" \
        else _valid_mask(cuda, B, Sq, q_valid)
    km = _valid_mask(cuda, B, Sk, kv_valid)
    before = fl.flash_segment.launches
    got = fl.flash_sdpa(q, k, v, q_valid=qm, kv_valid=km)
    assert fl.flash_segment.launches == before + 1 and got.shape == q.shape
    torch.testing.assert_close(got.float(), fl.flash_sdpa_plain(q, k, v, qm, km).float(),
                               rtol=rtol, atol=3e-3)
    torch.testing.assert_close(fl.flash_segment(q, k, v).float(),
                               fl.flash_sdpa_plain(q, k, v).float(), rtol=rtol, atol=3e-3)


def _stats_caches(g, cuda, L, B, H, S, D):
    """bf16, int8 (amax / 127 scales) and packed-int4 caches of one shape."""
    k, v = _randn(g, L, B, H, S, D), _randn(g, L, B, H, S, D)
    ks, vs = (torch.clamp_min(t.float().abs().amax(-1), 1e-6) * (1.0 / 127.0) for t in (k, v))
    kq, vq = (torch.round(t.float() / sc[..., None]).to(torch.int8) for t, sc in ((k, ks), (v, vs)))
    kp, vp = (torch.randint(-128, 128, (L, B, H // 2, S, D), generator=g, device=cuda,
                            dtype=torch.int8) for _ in range(2))
    ks4, vs4 = ((torch.rand((L, B, H, S), generator=g, device=cuda) * 0.3 + 0.02)
                .to(torch.bfloat16) for _ in range(2))
    return {"bf16": (k, v), "int8": (kq, vq, ks, vs), "int4": (kp, vp, ks4, vs4)}


@pytest.mark.parametrize("cache", ["bf16", "int8", "int4"])
def test_decode_attention_stats_kernel_matches_plain(cuda, cache):
    """The stats form over one block of the cp phase's cache (4,352
    positions, 20 heads) at lengths 0, 1, 1,648 and the whole block: acc / s
    within 3e-3 of max |ref| (the plain version rounds p, times v_scale, to
    bf16 against the lane's max, the kernel against its warps' running max),
    m to f32 rounding, and an empty lane exactly m = -1e30, acc = s = 0."""
    g = torch.Generator(device=cuda).manual_seed(0)
    L, H, S, D = 2, 20, 4352, 128
    lengths = torch.tensor([0, 1, 1648, S], dtype=torch.int32, device=cuda)
    forms = _stats_caches(g, cuda, L, 4, H, S, D)
    args = (_randn(g, 4, H, D), *forms[cache][:2], 1, lengths, *forms[cache][2:])
    launches = da.decode_attention_stats.launches
    acc, m, s = da.decode_attention(*args, return_stats=True)
    torch.cuda.synchronize()
    assert da.decode_attention_stats.launches == launches + 1
    racc, rm, rs = da.decode_attention_plain(*args, return_stats=True)
    assert (m[0] == da.NEG_INF).all() and (acc[0] == 0).all() and (s[0] == 0).all()
    out, ref = acc[1:] / s[1:, :, None], racc[1:] / rs[1:, :, None]
    assert ((out - ref).abs().max() / ref.abs().max()).item() <= 3e-3
    torch.testing.assert_close(m[1:], rm[1:], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s[1:], rs[1:], rtol=1e-4, atol=0)


@pytest.mark.parametrize("cache", ["bf16", "int8", "int4"])
def test_decode_attention_stats_merge_of_two_blocks_matches_one_launch(cuda, cache):
    """Two blocks of 4,352 positions through the stats form, merged as
    parallel/cp_cache.py merges them (corr = exp(m - max m)), against the
    normal kernel over all 8,704 (length 6,000): within the normal kernel's
    bf16 output rounding; without block 1 the merge is far off."""
    g = torch.Generator(device=cuda).manual_seed(1)
    L, H, block, D = 2, 20, 4352, 128
    forms = _stats_caches(g, cuda, L, 1, H, 2 * block, D)
    q = _randn(g, 1, H, D)
    lengths = torch.tensor([6000], dtype=torch.int32, device=cuda)
    cache_args = forms[cache]
    whole = da.decode_attention(q, *cache_args[:2], 1, lengths, *cache_args[2:]).float()
    parts = []
    for b in range(2):
        local = [t[:, :, :, b * block:(b + 1) * block].contiguous() for t in cache_args]
        len_b = torch.clamp(lengths - b * block, 0, block).to(torch.int32)
        parts.append(da.decode_attention_stats(q, *local[:2], 1, len_b, *local[2:]))

    def merge(ps):
        m_g = torch.stack([m for _, m, _ in ps]).amax(0)
        acc = sum(a * torch.exp(m - m_g)[..., None] for a, m, _ in ps)
        return acc / sum(s * torch.exp(m - m_g) for _, m, s in ps)[..., None]

    scale = whole.abs().max()
    assert ((merge(parts) - whole).abs().max() / scale).item() <= 1e-2
    assert ((merge(parts[:1]) - whole).abs().max() / scale).item() > 1e-2


@pytest.mark.parametrize("cache", ["bf16", "int8", "int4"])
def test_kv_cache_write_slot_outside_the_block_leaves_the_cache(cuda, cache):
    """A rank's block of a cache sharded by position: a decode token whose
    slot falls before or past the block writes nothing, in the kernel as in
    its plain version."""
    g = torch.Generator(device=cuda).manual_seed(2)
    L, R, H, S, D = 2, 3, 20, 256, 128
    Hc = H // 2 if cache == "int4" else H
    if cache == "bf16":
        k, v, kn, vn = (_randn(g, *shape) for shape in [(L, R, Hc, S, D)] * 2 + [(R, Hc, D)] * 2)
        scales = ()
    else:
        k, v, kn, vn = (torch.randint(-128, 128, shape, generator=g, device=cuda,
                                      dtype=torch.int8)
                        for shape in [(L, R, Hc, S, D)] * 2 + [(R, Hc, D)] * 2)
        sdt = torch.float32 if cache == "int8" else torch.bfloat16
        scales = tuple(torch.rand(shape, generator=g, device=cuda).to(sdt)
                       for shape in [(L, R, H, S)] * 2 + [(R, H)] * 2)
    rows = torch.arange(R, dtype=torch.int32, device=cuda)
    slots = torch.tensor([-1, S, 5000], dtype=torch.int32, device=cuda)  # global - block start
    before = [t.clone() for t in (k, v) + scales[:2]]
    plain = [t.clone() for t in before]
    kw.kv_cache_write(k, v, 1, rows, slots, kn, vn, *scales)
    kw.kv_cache_write_plain(plain[0], plain[1], 1, rows, slots, kn, vn, *plain[2:], *scales[2:])
    torch.cuda.synchronize()
    for got, want, ref in zip((k, v) + scales[:2], before, plain):
        assert torch.equal(got, want) and torch.equal(ref, want)


# ------------------------------------------------------------ the redesigned attention kernels

FLASH_S = (1, 37, 64, 65, 127, 128, 129, 509, 512, 2047, 2048)


def _causal_lse(q, k, scale):
    """Each query row's log-sum-exp of its scaled causal scores [B, H, S]."""
    S = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    above = torch.ones((S, S), dtype=torch.bool, device=q.device).triu(1)
    return torch.logsumexp(scores.masked_fill_(above, float("-inf")), -1)


@pytest.mark.parametrize("S", FLASH_S)
@pytest.mark.parametrize("B", [1, 3, 32])
def test_flash_causal_wgmma_matches_plain(cuda, B, S):
    """The wgmma + TMA forward (64- and 128-row query tiles, ragged S)
    against the plain version at 1e-2 (bf16 output; both round p to bf16
    before p.v, the plain version after normalising it), its row
    log-sum-exp within 1e-4 of the f32 reference, and the same bits with and
    without the statistics; one launch a call. The references run a few
    lanes at a time."""
    g = torch.Generator(device=cuda).manual_seed(B * 4096 + S)
    H, D = 20, 128
    q, k, v = (_randn(g, B, S, H, D) for _ in range(3))
    launches = fl.flash_causal.launches
    out = fl.flash_causal(q, k, v)
    torch.cuda.synchronize()
    assert fl.flash_causal.launches == launches + 1
    lse = torch.empty((B, H, S), dtype=torch.float32, device=cuda)
    assert torch.equal(fl._forward(q, k, v, D**-0.5, lse), out)
    step = max(1, (1 << 22) // (S * S))
    for b0 in range(0, B, step):
        sl = slice(b0, b0 + step)
        torch.testing.assert_close(out[sl].float(), fl.flash_causal_plain(q[sl], k[sl], v[sl]).float(),
                                   rtol=1e-2, atol=1e-2)
        torch.testing.assert_close(lse[sl], _causal_lse(q[sl], k[sl], D**-0.5), rtol=0, atol=1e-4)


DECODE_LENGTHS = (0, 1, 255, 256, 257)  # and the whole cache


def _decode_check(args, full, splits, stats_limit=3e-3):
    """The kernel's normal and stats forms at ``splits`` against the plain
    version: lanes with positions to 1e-2 (normal, bf16 output) and acc / s
    within ``stats_limit`` of max |ref|, m and s to f32 rounding; lanes of
    length 0 exactly 0 (normal) and m = -1e30, acc = s = 0 (stats); one
    launch a call, whatever the split."""
    packed = da.is_packed4(args[1], args[5] if len(args) > 5 else None)
    counter = da.decode_attention_int4 if packed else da.decode_attention
    launches = (counter.launches, da.decode_attention_stats.launches)
    got = da.decode_attention(*args, splits=splits)
    acc, m, s = da.decode_attention(*args, return_stats=True, splits=splits)
    torch.cuda.synchronize()
    assert (counter.launches, da.decode_attention_stats.launches) == (launches[0] + 1,
                                                                      launches[1] + 1)
    ref = da.decode_attention_plain(*args)
    racc, rm, rs = da.decode_attention_plain(*args, return_stats=True)
    assert (got[~full] == 0).all()
    assert (m[~full] == da.NEG_INF).all() and (acc[~full] == 0).all() and (s[~full] == 0).all()
    if not full.any():
        return
    torch.testing.assert_close(got[full].float(), ref[full].float(), rtol=1e-2, atol=1e-2)
    out, want = acc[full] / s[full][..., None], racc[full] / rs[full][..., None]
    assert ((out - want).abs().max() / want.abs().max()).item() <= stats_limit
    torch.testing.assert_close(m[full], rm[full], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s[full], rs[full], rtol=1e-4, atol=0)


@pytest.mark.parametrize("splits", [1, None])
@pytest.mark.parametrize("cache", ["bf16", "int8", "int4"])
def test_decode_attention_split_matches_plain(cuda, cache, splits):
    """Every form and both outputs at P = 1 and at the heuristic's P, lanes
    of lengths 0, 1, 255, 256, 257 and the whole 4,352 positions: six lanes
    in one call, and each length alone in one lane (P = 14, 17 for int4)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    L, H, S, D = 2, 20, 4352, 128
    lens = list(DECODE_LENGTHS) + [S]
    forms = _stats_caches(g, cuda, L, len(lens), H, S, D)
    c = forms[cache]
    q = _randn(g, len(lens), H, D)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    _decode_check((q, c[0], c[1], 1, lengths, *c[2:]), lengths > 0, splits)
    for i, n in enumerate(lens):
        one = [t[:, i:i + 1].contiguous() for t in c]
        lane = torch.tensor([n], dtype=torch.int32, device=cuda)
        _decode_check((q[i:i + 1], one[0], one[1], 1, lane, *one[2:]), lane > 0, splits)


@pytest.mark.parametrize("splits", [None, 2])
@pytest.mark.parametrize("cache", ["bf16", "int8", "int4"])
def test_decode_attention_32_ragged_lanes_match_plain(cuda, cache, splits):
    """32 lanes over 384 positions at ragged lengths from 0 to 384 (the
    heuristic gives P = 1; forced P = 2, the most 384 positions take,
    splits each lane in two)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    L, B, H, S, D = 2, 32, 20, 384, 128
    c = _stats_caches(g, cuda, L, B, H, S, D)[cache]
    lengths = torch.randint(0, S + 1, (B,), generator=g, device=cuda, dtype=torch.int32)
    lengths[:3] = torch.tensor([0, 1, S], dtype=torch.int32, device=cuda)
    _decode_check((_randn(g, B, H, D), c[0], c[1], 1, lengths, *c[2:]), lengths > 0, splits)
