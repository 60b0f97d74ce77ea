"""The port's paged server against the JAX package's, on the CPU.

The small int4 serving config of tests/test_torch_server.py (hidden 256,
2 heads x 128, 2 layers, 8 + 2 experts, f32): the same param tree goes
through both packages, the JAX side with ``ARIA_TPU_KERNELS=interpret``
(kv_cache_write, paged_decode_attention, dense_int4 and the MoE kernels in
interpret mode), the port through its plain versions.

Chunks are 32 tokens on 32-token pages, so the JAX side's rows per chunk
(lanes padded to a power of two, times 32) are at most 128 or a multiple
of 128, the only sizes its ``dense_int4`` takes. Six lanes admitted at
once make a first chunk of 192 rows in the port (256 in JAX): the MoE's
>128-token branch; the later chunks of the longer prompts run 32-128
rows: its decode branch.

Greedy streams are pinned at the prompts of a seeded pool where none moves
(tests/test_torch_server.py docstring: with int8 pages the attention
output is bf16, and the JAX ``dense_int4`` sits ~2% from exact math for
such an input, ROADMAP queue 3 (d)). A batch changes the MoE's branch for
the prompts in it, so a stream served in a batch can differ from the same
prompt served alone, in both packages alike. The serving semantics follow
tests/test_server.py:253-349 and :425-441.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aria_tpu.config import AriaConfig as JAriaConfig
from aria_tpu.config import ProjectorConfig as JProjectorConfig
from aria_tpu.config import TextConfig as JTextConfig
from aria_tpu.engine import paged as jpaged
from aria_tpu.engine.server import PagedBatchedEngine as JPagedBatchedEngine
from aria_tpu.models import moe_lm as jm
from aria_tpu.ops import backend as jbackend
from aria_tpu.ops import quant as jquant
from aria_tpu.ops.quant import dequantize_weight
from aria_tpu_torch.checkpoint.from_jax import from_jax
from aria_tpu_torch.config import TextConfig, config_from_dict
from aria_tpu_torch.data.tokenizer import ByteTokenizer
from aria_tpu_torch.engine import paged as tpaged
from aria_tpu_torch.engine.generate import Engine, GenerationConfig
from aria_tpu_torch.engine.guided import regex_fsm
from aria_tpu_torch.engine.server import PagedBatchedEngine
from aria_tpu_torch.models import moe_lm as tm
from aria_tpu_torch.models.projector import init_projector_params
from aria_tpu_torch.models.vit import init_vit_params
from aria_tpu_torch.ops import paged_attention as tpa
from aria_tpu_torch.parallel.mesh import Mesh, MeshConfig

torch.set_num_threads(1)

JTEXT = JTextConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2,
                    num_kv_heads=2, head_dim=128, num_experts=8, moe_topk=2,
                    moe_intermediate_size=128, num_shared_experts=2, max_seq_len=512)
# the tiny vision tower, projected to the text width
JCFG = JAriaConfig.tiny().replace(
    text=JTEXT, projector=dataclasses.replace(JAriaConfig.tiny().projector, output_dim=256))
assert isinstance(JCFG.projector, JProjectorConfig)
CFG = config_from_dict(dataclasses.asdict(JCFG))  # the port's own config, field for field
SEED = 1
_rng = np.random.RandomState(SEED + 100)
_POOL = {n: [int(t) for t in _rng.randint(1, 512, n)]
         for n in (3, 5, 9, 14, 20, 27, 33, 40, 45, 50, 60, 70)}
# six lanes at once (a 192-row chunk), two longer prompts that take 2 and 3
# chunks, and a request that shares the 70-token prompt's first two pages
PROMPTS = [_POOL[n] for n in (3, 50, 5, 14, 20, 70)] + [_POOL[70][:64] + [7, 9]]
N_NEW = 8
CACHES = {"int8": (jnp.int8, torch.int8), "f32": (jnp.float32, torch.float32)}
ENGINE = dict(max_lanes=6, max_seq_len=128, page_size=32, prefill_chunk=32, decode_chunk=3)


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


@pytest.fixture(scope="module")
def params(interpret):
    lm = jm.init_lm_params_serving_int4(jax.random.PRNGKey(SEED), JTEXT, dtype=jnp.float32)
    lm["embed"] = dequantize_weight(lm["embed"], dtype=jnp.float32)
    return {"lm": lm}, {"lm": from_jax(jax.tree.map(np.asarray, lm), device="cpu")}


def _serve(engine, prompts=PROMPTS, n_new=N_NEW):
    uids = [engine.submit(p, max_new_tokens=n_new) for p in prompts]
    fin = {r.uid: r for r in engine.run_until_complete()}
    assert len(fin) == len(prompts) and not any(r.error for r in fin.values())
    return [fin[u].generated for u in uids], [fin[u].cached_tokens for u in uids]


@pytest.fixture(scope="module")
def served(params):
    """Both engines over PROMPTS, per page dtype: (streams, cached tokens,
    pool hits) each, and the token counts the port's MoE saw per branch."""
    jparams, tparams = params
    out, rows = {}, {"decode": [], "prefill": []}
    real = tm.moe_decode_int4, tm.experts_segmented_int4

    def counted(fn, branch):
        def call(x, *args, **kw):
            rows[branch].append(x.shape[0])
            return fn(x, *args, **kw)
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tm, "moe_decode_int4", counted(real[0], "decode"))
        mp.setattr(tm, "experts_segmented_int4", counted(real[1], "prefill"))
        for name, (jdt, tdt) in CACHES.items():
            jeng = JPagedBatchedEngine(jparams, JCFG, cache_dtype=jdt, **ENGINE)
            teng = PagedBatchedEngine(tparams, CFG, cache_dtype=tdt, **ENGINE)
            out[name] = ((*_serve(jeng), jeng.pool.hits), (*_serve(teng), teng.pool.hits))
    return out, rows


@pytest.mark.parametrize("cache", list(CACHES))
def test_greedy_streams_match_jax_paged_engine(served, cache):
    want, got = served[0][cache]
    assert all(len(g) == N_NEW for g in got[0])
    assert got[0] == want[0]


@pytest.mark.parametrize("cache", list(CACHES))
def test_prefix_cache_accounting_matches_jax(served, cache):
    want, got = served[0][cache]
    assert got[1] == want[1] and got[1][-1] == 64  # the shared request reused 2 pages
    assert got[2] == want[2] == 2


def test_chunks_cover_both_moe_branches(served):
    """A chunk over more than 128 rows (the 6-lane first chunk) and chunks
    of at most 128 (the longer prompts' later chunks)."""
    rows = served[1]
    assert 6 * 32 in rows["prefill"]
    assert {32, 64} <= set(rows["decode"])


@pytest.mark.parametrize("form", ["bf16", "int8"])
def test_serving_forms_match_jax_paged_engine(interpret, form):
    """The bf16 and int8 serving forms (bench.py:410-425; f32 here) in both
    paged engines, f32 pages: the 6-lane first chunk takes the ragged
    path, the later chunks and the decode steps the form's decode MoE."""
    lm = {"lm": jm.init_lm_params(jax.random.PRNGKey(SEED), JTEXT, dtype=jnp.float32)}
    if form == "int8":
        lm = jquant.quantize_params(lm)
    lm = jquant.fuse_shared_experts(lm)
    tparams = {"lm": from_jax(jax.tree.map(np.asarray, lm["lm"]), device="cpu")}
    jeng = JPagedBatchedEngine(lm, JCFG, cache_dtype=jnp.float32, **ENGINE)
    teng = PagedBatchedEngine(tparams, CFG, cache_dtype=torch.float32, **ENGINE)
    want, got = _serve(jeng), _serve(teng)
    assert all(len(g) == N_NEW for g in got[0])
    assert got == want


# ------------------------------------------------------------ PagePool


def test_page_pool_matches_jax():
    pools = jpaged.PagePool(6), tpaged.PagePool(6)

    def state(p):
        return (list(p.free), dict(p.refs), dict(p.key_to_page), list(p.lru), p.hits,
                p.available)

    ops = [("alloc", 2), ("register", "a", 1), ("register", "b", 2), ("register", "a", 3),
           ("release", [1, 2]), ("lookup", "a"), ("lookup", "zz"), ("alloc", 3),
           ("alloc", 2), ("release", [1, 0]), ("lookup", "b"), ("alloc", 1), ("release", [3])]
    for op, *args in ops:
        got = [getattr(p, op)(*args) for p in pools]
        assert got[0] == got[1], (op, args)
        assert state(pools[0]) == state(pools[1]), (op, args)


# ------------------------------------------------------------ cache ops

PAGE = dict(L=2, NP=9, H=2, PS=32, D=128)
TABLE = np.array([[3, 1, 5], [2, 7, 0], [0, 0, 0]], np.int32)  # lane 2 idle


def _both(arrays, dtype):
    """numpy arrays as (JAX, torch) pairs, bf16 rounded alike on both sides."""
    if dtype == "bf16":
        return ([jnp.asarray(a, jnp.bfloat16) for a in arrays],
                [torch.from_numpy(a).to(torch.bfloat16) for a in arrays])
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a.copy()) for a in arrays]


def _caches(dtype, seed=0):
    """The same random pages in both packages (int8 with f32 scales)."""
    rng = np.random.RandomState(seed)
    L, NP, H, PS, D = PAGE.values()
    shape = (L, NP, H, PS, D)
    if dtype == "int8":
        k, v = (rng.randint(-127, 128, shape).astype(np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.01, 0.05, shape[:-1]).astype(np.float32) for _ in range(2))
        leaves = (k, v, ks, vs)
    else:
        leaves = tuple(rng.randn(*shape).astype(np.float32) for _ in range(2))
    jleaves, tleaves = _both(leaves, dtype)
    return jpaged.PagedKVCache(*jleaves), tpa.PagedKVCache(*tleaves)


def _new_kv(dtype, B, S, seed=1):
    rng = np.random.RandomState(seed)
    H, D = PAGE["H"], PAGE["D"]
    if dtype == "int8":
        return (rng.randint(-127, 128, (B, H, S, D)).astype(np.int8),
                rng.randint(-127, 128, (B, H, S, D)).astype(np.int8),
                rng.uniform(0.01, 0.05, (B, H, S)).astype(np.float32),
                rng.uniform(0.01, 0.05, (B, H, S)).astype(np.float32))
    return tuple(rng.randn(B, H, S, D).astype(np.float32) for _ in range(2))


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("S", [1, 32])
def test_paged_write_matches_jax(interpret, dtype, S):
    """Bytes and scales equal outside the null page 0, for a decode write
    (the JAX side through its kv_cache_write kernel in interpret mode) and
    a chunk write; lane 2's zeroed table writes only into page 0."""
    jc, tc = _caches(dtype)
    pos = np.array([40, 10, 17] if S == 1 else [32, 0, 0], np.int32)
    jnew_kv, tnew_kv = _both(_new_kv(dtype, 3, S), dtype)
    jnew = jpaged.paged_write(jc, jnp.int32(1), jnp.asarray(TABLE), jnp.asarray(pos),
                              *jnew_kv, use_kernel=True)
    pages, slots = tpa.write_index(torch.from_numpy(TABLE), torch.from_numpy(pos), S,
                                      PAGE["PS"])
    tpa.paged_write(tc, 1, pages, slots, *tnew_kv)
    for name in ("k", "v", "k_scale", "v_scale")[:4 if dtype == "int8" else 2]:
        want = np.asarray(getattr(jnew, name).astype(jnp.float32))
        got = getattr(tc, name).float().numpy()
        np.testing.assert_array_equal(got[:, 1:], want[:, 1:], err_msg=name)


def test_paged_write_drops_positions_past_the_table():
    """A lane past MAXP * PS writes nothing (the JAX scatter drops the
    out-of-range page), decode and chunk alike."""
    _, tc = _caches("int8")
    before = [t.clone() for t in (tc.k, tc.v, tc.k_scale, tc.v_scale)]
    table = torch.from_numpy(TABLE[:1])
    for pos, S in ((96, 1), (100, 1), (96, 32)):
        pages, slots = tpa.write_index(table, torch.tensor([pos]), S, PAGE["PS"])
        assert (pages == -1).all()
        tpa.paged_write(tc, 0, pages, slots,
                           *(torch.from_numpy(a) for a in _new_kv("int8", 1, S)))
    for b, a in zip(before, (tc.k, tc.v, tc.k_scale, tc.v_scale)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_gather_lane_kv_matches_jax(dtype):
    jc, tc = _caches(dtype)
    for layer in range(PAGE["L"]):
        want = jpaged.gather_lane_kv(jc, jnp.int32(layer), jnp.asarray(TABLE))
        got = tpa.gather_lane_kv(tc, layer, torch.from_numpy(TABLE))
        for w, g in zip(want, got):
            assert g.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(w.astype(jnp.float32)))


def _kernel_setup(dtype):
    """tests/test_kernels.py:351-388 at D = 128: lane 0 on pages [1, 2, 3],
    lane 1 on [4, 5] and the null page, lengths spilling across pages;
    each layer written with its own scale so a layer-index bug shows."""
    rng = np.random.RandomState(3)
    L, B, H, D, PS, NP = 2, 2, 4, 128, 128, 7
    cfg = JTextConfig(vocab_size=64, hidden_size=H * D, num_layers=L, num_heads=H,
                      num_kv_heads=H, head_dim=D)
    jdt = jnp.int8 if dtype == "int8" else jnp.float32
    cache = jpaged.PagedKVCache.init(cfg, NP, PS, dtype=jdt)
    table = jnp.asarray([[1, 2, 3], [4, 5, 0]], jnp.int32)
    S = 300
    k_new = rng.randn(B, H, S, D).astype(np.float32)
    v_new = rng.randn(B, H, S, D).astype(np.float32)
    for l in range(L):
        if dtype == "int8":
            ks, vs = np.abs(k_new).max(-1) / 127.0, np.abs(v_new).max(-1) / 127.0
            kw = (jnp.asarray(np.round(k_new / ks[..., None]).astype(np.int8)),
                  jnp.asarray(np.round(v_new / vs[..., None]).astype(np.int8)),
                  jnp.asarray(ks * (l + 1)), jnp.asarray(vs * (l + 1)))
        else:
            kw = (jnp.asarray(k_new * (l + 1)), jnp.asarray(v_new * (l + 1)))
        cache = jpaged.paged_write(cache, jnp.int32(l), table, jnp.zeros(B, jnp.int32), *kw)
    q = jnp.asarray(rng.randn(B, H, D).astype(np.float32))
    if dtype == "int8":
        q = q.astype(jnp.bfloat16)
    tcache = tpa.PagedKVCache(*(torch.from_numpy(np.asarray(a).copy()) for a in cache
                                   if a is not None))
    tq = torch.from_numpy(np.array(q.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == "int8" else torch.float32)
    return cache, table, q, tcache, tq


@pytest.mark.parametrize("dtype,rtol,atol", [("f32", 2e-4, 2e-4), ("int8", 2e-2, 5e-3)])
@pytest.mark.parametrize("lengths", [(300, 200), (384 + 50, 1)])
def test_paged_decode_attention_plain_matches_jax_kernel(interpret, dtype, rtol, atol, lengths):
    """The plain version against the Pallas kernel in interpret mode; the
    second case runs one lane past its table (every page counts) and one
    over a single position."""
    cache, table, q, tcache, tq = _kernel_setup(dtype)
    lens = np.asarray(lengths, np.int32)
    for layer in range(2):
        want = jpaged.paged_decode_attention(q, cache, jnp.int32(layer), table,
                                             jnp.asarray(lens), interpret=True)
        got = tpa.paged_decode_attention(tq, tcache, layer,
                                            torch.from_numpy(np.array(table)),
                                            torch.from_numpy(lens))
        assert got.dtype == (torch.bfloat16 if dtype == "int8" else torch.float32)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   rtol=rtol, atol=atol)


def test_int4_pages_raise():
    with pytest.raises(NotImplementedError, match="int4 pages"):
        tpa.PagedKVCache.init(TextConfig(num_layers=1), 3, 32, "int4", device="cpu")


# ------------------------------------------------------------ the stall


def test_tight_pool_request_finishes_where_the_reference_stalls(params):
    """One lane, max_seq_len 64 in 32-token pages: the default pool is 3
    pages. A 5-token prompt with 58 new tokens reaches position 61 with 57
    tokens; the JAX ``_ensure_pages`` then asks for a third page that the
    pool cannot give, and the request never finishes (ROADMAP queue 3 (e)).
    The port caps the lane at the table's 2 pages and finishes it."""
    jparams, tparams = params
    kw = dict(max_lanes=1, max_seq_len=64, page_size=32, prefill_chunk=32, decode_chunk=4)
    jeng = JPagedBatchedEngine(jparams, JCFG, cache_dtype=jnp.int8, **kw)
    teng = PagedBatchedEngine(tparams, CFG, cache_dtype=torch.int8, **kw)
    prompt = _POOL[5]
    for eng in (jeng, teng):
        eng.submit(prompt, max_new_tokens=58)
    assert jeng.run_until_complete(max_ticks=40) == []
    (req,) = jeng.lane_req
    assert int(jeng.lane_pos[0]) == 61 and len(req.generated) == 57
    (done,) = teng.run_until_complete(max_ticks=40)
    assert done.error is None and len(done.generated) == 58
    assert teng.pool.available == 2 and not teng.page_table.any()


# ------------------------------------------------------------ serving semantics


def _paged(tparams, **kw):
    kw = {"max_lanes": 1, "max_seq_len": 256, "page_size": 32, "prefill_chunk": 32,
          "temperature": 0.0, "decode_chunk": 4, "cache_dtype": torch.float32, **kw}
    return PagedBatchedEngine(tparams, CFG, **kw)


def _single(tparams, prompt, n, max_seq_len=256):
    gen = GenerationConfig(max_new_tokens=n, temperature=0.0, top_k=None, decode_chunk=4)
    eng = Engine(tparams, CFG, max_seq_len=max_seq_len, cache_dtype=torch.float32)
    return eng.generate(prompt, gen).tokens


def test_shared_system_prompt_reuses_pages_and_matches(params):
    tparams = params[1]
    srv = _paged(tparams)
    sys_prompt = [7 + (i % 90) for i in range(64)]  # 2 full 32-token pages
    p1, p2 = sys_prompt + [5, 17, 3], sys_prompt + [9, 200, 41]
    srv.submit(p1, max_new_tokens=6)
    (f1,) = srv.run_until_complete()
    srv.submit(p2, max_new_tokens=6)
    (f2,) = srv.run_until_complete()
    assert f1.cached_tokens == 0 and f2.cached_tokens == 64
    assert srv.pool.hits == 2
    assert f1.generated == _single(tparams, p1, 6)
    assert f2.generated == _single(tparams, p2, 6)


def test_page_aligned_prompt_never_reuses_final_page(params):
    tparams = params[1]
    srv = _paged(tparams)
    prompt = [11 + (i % 50) for i in range(96)]  # exactly 3 pages
    exp = _single(tparams, prompt, 5)
    srv.submit(prompt, max_new_tokens=5)
    (f1,) = srv.run_until_complete()
    srv.submit(prompt, max_new_tokens=5)
    (f2,) = srv.run_until_complete()
    assert f2.cached_tokens == 64  # 2 of 3 pages
    assert f1.generated == exp and f2.generated == exp


def test_eviction_under_pool_pressure(params):
    srv = _paged(params[1], num_pages=1 + 4, max_seq_len=128)
    srv.submit([3] * 60, max_new_tokens=4)  # 2 pages, 1 registered
    srv.run_until_complete()
    assert len(srv.pool.lru) >= 1
    srv.submit([4] * 120, max_new_tokens=4)  # needs all 4 pages
    (f,) = srv.run_until_complete()
    assert f.error is None and len(f.generated) == 4
    assert len(srv.pool.key_to_page) <= 4


def test_prefix_cache_disabled(params):
    srv = _paged(params[1], prefix_cache=False)
    prompt = [5 + (i % 40) for i in range(64)]
    for _ in range(2):
        srv.submit(prompt, max_new_tokens=4)
        (f,) = srv.run_until_complete()
        assert f.cached_tokens == 0
    assert srv.pool.hits == 0


def test_image_requests_bypass_prefix_cache(params):
    """Image KV depends on the pixels, not only the token ids: an image
    request neither reuses nor registers pages."""
    gen = torch.Generator().manual_seed(0)
    tparams = {**params[1], "vision": init_vit_params(CFG.vision, gen, device="cpu"),
               "projector": init_projector_params(CFG.projector, gen, device="cpu")}
    side = CFG.vision.image_size
    n_q = CFG.projector.query_count(CFG.vision.patches_per_side**2)
    prompt = [4] + [CFG.image_token_id] * n_q + [7] * (70 - 2 - n_q)
    pixels = np.random.RandomState(3).randn(1, 3, side, side).astype(np.float32)
    mask = np.ones((1, side, side), bool)
    srv = _paged(tparams)
    for _ in range(2):
        srv.submit(prompt, max_new_tokens=3, pixel_values=pixels, pixel_mask=mask)
        (f,) = srv.run_until_complete()
        assert f.cached_tokens == 0 and f.error is None and len(f.generated) == 3
    assert srv.pool.hits == 0 and not srv.pool.key_to_page


def test_mixed_sampling_params(params):
    """A plain greedy lane, a min_p = 1.0 lane at temperature 1 (greedy), a
    lane with repetition_penalty 1e6 (no token repeats, none from its
    prompt), in one batch of 16-token chunks."""
    tparams = params[1]
    prompts = [[5, 17, 3], [9, 9, 200, 41, 7], [100, 2, 30, 44]]
    srv = _paged(tparams, max_lanes=3, max_seq_len=128, prefill_chunk=16)
    u_plain = srv.submit(prompts[0], max_new_tokens=8)
    u_minp = srv.submit(prompts[1], max_new_tokens=8, temperature=1.0, min_p=1.0)
    u_rep = srv.submit(prompts[2], max_new_tokens=10, repetition_penalty=1e6)
    fin = {r.uid: r for r in srv.run_until_complete()}
    assert not any(r.error for r in fin.values())
    assert fin[u_plain].generated == _single(tparams, prompts[0], 8, 128)
    assert fin[u_minp].generated == _single(tparams, prompts[1], 8, 128)
    rep = fin[u_rep].generated
    assert len(rep) == 10 and len(set(rep)) == len(rep), rep
    assert not set(rep) & set(prompts[2]), rep


def test_cancel_queued_and_running_recycles_pages(params):
    srv = _paged(params[1], decode_chunk=2)
    avail0 = srv.pool.available
    running = srv.submit([5, 17, 3], max_new_tokens=50)
    queued = srv.submit([9, 9, 9], max_new_tokens=50)  # no free lane
    srv.step()  # admits `running`, runs its chunk and a decode chunk
    assert srv.cancel(queued) and srv.cancel(running)
    assert not srv.cancel(12345)
    by_uid = {r.uid: r for r in srv.run_until_complete()}
    assert by_uid[queued].error == "cancelled" and by_uid[running].error == "cancelled"
    assert srv.lane_req[0] is None and srv.pool.available == avail0
    ok = srv.submit([4, 4], max_new_tokens=3)
    (f,) = srv.run_until_complete()
    assert f.uid == ok and len(f.generated) == 3


def test_oversized_request_reports_error(params):
    srv = _paged(params[1], max_seq_len=64)
    srv.submit([3] * 40, max_new_tokens=30)
    (req,) = srv.run_until_complete()
    assert req.done and "needs 70 > max_seq_len 64" in req.error


def test_not_ported_options_raise(params):
    # guided decoding is ported (tests/test_torch_guided.py); a serving mesh is not
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        _paged(params[1], mesh=Mesh(MeshConfig(), 0, {}))
    fsm = regex_fsm("(yes|no)", ByteTokenizer(), [0], vocab_size=512, device="cpu")
    with pytest.raises(ValueError, match="guided FSM is on meta"):
        _paged(params[1], guided_fsm=fsm.to("meta"))
    with pytest.raises(ValueError, match="guided_fsm"):
        _paged(params[1]).submit([1, 2], guided=True)
    with pytest.raises(ValueError, match="without adapters"):  # adapters: test_torch_multi_lora
        _paged(params[1]).submit([1, 2], adapter="t1")
