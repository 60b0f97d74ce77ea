"""Guided decoding in the port against the JAX package, on the CPU (after
tests/test_guided.py).

The port keeps its own copy of the JAX module's numpy pipeline (regex and
JSON grammar to a byte DFA, lifted to a token table over ``ByteTokenizer``)
and holds the table on a torch device: the tables are held equal array for
array, the mask and the state step equal on seeded states and logits. The
engines run the small int4 serving config of tests/test_torch_server.py
with an f32 cache, the JAX side with ``ARIA_TPU_KERNELS=interpret``:
guided greedy streams through ``Engine``, ``BatchedEngine`` (beside an
unguided lane, which must equal a plain engine's stream) and
``PagedBatchedEngine`` (with the prefix cache) equal the JAX engines' and
conform to the constraint.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aria_tpu.config import AriaConfig as JAriaConfig
from aria_tpu.config import TextConfig as JTextConfig
from aria_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from aria_tpu.engine import guided as jguided
from aria_tpu.engine.generate import Engine as JEngine
from aria_tpu.engine.generate import GenerationConfig as JGen
from aria_tpu.engine.server import BatchedEngine as JBatchedEngine
from aria_tpu.engine.server import PagedBatchedEngine as JPagedBatchedEngine
from aria_tpu.models import moe_lm as jm
from aria_tpu.ops import backend as jbackend
from aria_tpu.ops.quant import dequantize_weight
from aria_tpu_torch.checkpoint.from_jax import from_jax
from aria_tpu_torch.config import config_from_dict
from aria_tpu_torch.data.tokenizer import ByteTokenizer
from aria_tpu_torch.engine import guided as tguided
from aria_tpu_torch.engine.generate import Engine, GenerationConfig
from aria_tpu_torch.engine.server import BatchedEngine, PagedBatchedEngine

torch.set_num_threads(1)

JTEXT = JTextConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2,
                    num_kv_heads=2, head_dim=128, num_experts=8, moe_topk=2,
                    moe_intermediate_size=128, num_shared_experts=2, max_seq_len=512)
JCFG = JAriaConfig.tiny().replace(text=JTEXT)
CFG = config_from_dict(dataclasses.asdict(JCFG))
V = JTEXT.vocab_size
SEED = 1
TOK = ByteTokenizer()
EOS = TOK.eos_token_id
CHOICES = ("yes", "no", "maybe")
SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"},
    "n": {"enum": [1, 22, 333]},
}}
_rng = np.random.RandomState(SEED + 40)
PROMPTS = [[int(t) for t in _rng.randint(1, 256, n)] for n in (5, 9, 14)]
N_NEW = 12

# (name, port builder, JAX builder): tables over ByteTokenizer, padded to V
TABLES = {
    "choice": (lambda tok, **kw: tguided.regex_fsm("(yes|no|maybe)", tok, [EOS], V, **kw),
               lambda tok: jguided.regex_fsm("(yes|no|maybe)", tok, [EOS], V)),
    "number": (lambda tok, **kw: tguided.regex_fsm("-?[0-9]{1,3}(\\.[0-9]+)?", tok, [EOS], V, **kw),
               lambda tok: jguided.regex_fsm("-?[0-9]{1,3}(\\.[0-9]+)?", tok, [EOS], V)),
    "words": (lambda tok, **kw: tguided.regex_fsm("[a-z]+( [a-z]+)*\\.", tok, [EOS], **kw),
              lambda tok: jguided.regex_fsm("[a-z]+( [a-z]+)*\\.", tok, [EOS])),
    "json": (lambda tok, **kw: tguided.json_fsm(tok, [EOS], V, max_depth=2, **kw),
             lambda tok: jguided.json_fsm(tok, [EOS], V, max_depth=2)),
    "schema": (lambda tok, **kw: tguided.schema_fsm(SCHEMA, tok, [EOS], V, **kw),
               lambda tok: jguided.schema_fsm(SCHEMA, tok, [EOS], V)),
}


@pytest.mark.parametrize("name", list(TABLES))
def test_token_fsm_equals_jax(name):
    mine, theirs = TABLES[name]
    got, want = mine(TOK, device="cpu"), theirs(JByteTokenizer())
    for field in ("trans", "accepting", "stop_mask"):
        a, b = getattr(got, field), np.asarray(getattr(want, field))
        assert a.device.type == "cpu" and a.numpy().dtype == b.dtype, field
        np.testing.assert_array_equal(a.numpy(), b, err_msg=field)
    assert (got.start, got.free_state, got.num_states) == \
        (want.start, want.free_state, want.num_states)


def test_copied_pipeline_equals_jax():
    """The numpy stages the port copied: byte DFAs of a regex and the JSON
    grammar, and the token byte map."""
    for got, want in ((tguided.compile_regex("(ab|cd){2,3}x?"),
                       jguided.compile_regex("(ab|cd){2,3}x?")),
                      (tguided.json_dfa(2), jguided.json_dfa(2))):
        np.testing.assert_array_equal(got.trans, want.trans)
        np.testing.assert_array_equal(got.accepting, want.accepting)
    assert tguided.token_byte_strings(TOK, V) == jguided.token_byte_strings(JByteTokenizer(), V)


def test_to_moves_the_table():
    fsm = TABLES["choice"][0](TOK, device="cpu")
    meta = fsm.to("meta")
    assert meta.device.type == "meta" and meta.start == fsm.start
    assert fsm.nbytes == fsm.trans.numel() * 2 + fsm.accepting.numel() + fsm.stop_mask.numel()


@pytest.mark.parametrize("name", ["choice", "json"])
def test_mask_and_next_state_equal_jax(name):
    mine, theirs = TABLES[name]
    got, want = mine(TOK, device="cpu"), theirs(JByteTokenizer())
    rng = np.random.RandomState(5)
    B = 16
    # seeded states: every row of the table, the free state among them
    states = rng.randint(0, got.num_states, B).astype(np.int32)
    states[:2] = [got.start, got.free_state]
    logits = rng.randn(B, V).astype(np.float32)
    toks = rng.randint(0, V, B).astype(np.int32)
    toks[2] = EOS
    jargs = (want.trans, want.accepting, want.stop_mask)
    targs = (got.trans, got.accepting, got.stop_mask)
    np.testing.assert_array_equal(
        tguided.guided_mask(*targs, torch.from_numpy(states), torch.from_numpy(logits)).numpy(),
        np.asarray(jguided.guided_mask(*jargs, jnp.asarray(states), jnp.asarray(logits))))
    nxt = tguided.guided_next_state(got.trans, torch.from_numpy(states), torch.from_numpy(toks))
    assert nxt.dtype == torch.int32
    np.testing.assert_array_equal(
        nxt.numpy(), np.asarray(jguided.guided_next_state(want.trans, jnp.asarray(states),
                                                          jnp.asarray(toks))))


# ------------------------------------------------------------ the engines


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


@pytest.fixture(scope="module")
def fsms():
    return {name: (mine(TOK, device="cpu"), theirs(JByteTokenizer()))
            for name, (mine, theirs) in TABLES.items() if name in ("choice", "schema")}


def _conforms(name, tokens) -> bool:
    """A stream that ended in EOS is in the language; one cut by
    max_new_tokens is a live prefix of it under the JAX package's byte DFA
    (tests/test_guided.py:318-345). Returns whether it ended."""
    ended = tokens[-1] == EOS
    text = TOK.decode(tokens[:-1] if ended else tokens)
    if name == "choice":
        assert ended and text in CHOICES, tokens
    elif ended:
        doc = json.loads(text)
        assert set(doc) == {"ok", "n"} and isinstance(doc["ok"], bool) and doc["n"] in (1, 22, 333)
    else:
        dfa = jguided.compile_expr(jguided.seq(jguided._WS, jguided.schema_to_expr(SCHEMA)))
        assert dfa.simulate(text.encode()) >= 0, text
    return ended


@pytest.mark.parametrize("name", ["choice", "schema"])
def test_engine_guided_greedy_matches_jax(params, fsms, name):
    jp, tp = params
    tf, jf = fsms[name]
    n = 24 if name == "schema" else N_NEW
    je = JEngine(jp, JCFG, max_seq_len=256, cache_dtype=jnp.float32)
    te = Engine(tp, CFG, max_seq_len=256, cache_dtype=torch.float32)
    for prompt in PROMPTS:
        want = je.generate(prompt, JGen(max_new_tokens=n, temperature=0.0, top_k=None,
                                        stop_token_ids=(EOS,), guided=jf, decode_chunk=5))
        got = te.generate(prompt, GenerationConfig(max_new_tokens=n, temperature=0.0, top_k=None,
                                                   stop_token_ids=(EOS,), guided=tf,
                                                   decode_chunk=5))
        assert got.tokens == want.tokens
        _conforms(name, got.tokens)


def test_engine_guided_sampled_conforms(params, fsms):
    """At temperature 1 the FSM, not the model, sets the structure."""
    tf, _ = fsms["schema"]
    eng = Engine(params[1], CFG, max_seq_len=256, rng_seed=2)
    ended = [_conforms("schema", eng.generate(prompt, GenerationConfig(
        max_new_tokens=64, temperature=1.0, top_k=None, stop_token_ids=(EOS,),
        guided=tf)).tokens) for prompt in PROMPTS]
    assert any(ended), "no stream reached a complete document"


def _serve(engine, reqs):
    uids = [engine.submit(p, **kw) for p, kw in reqs]
    fin = {r.uid: r for r in engine.run_until_complete()}
    assert not any(r.error for r in fin.values())
    return [fin[u].generated for u in uids]


def test_batched_engine_mixed_guided_lanes_match_jax(params, fsms):
    """tests/test_guided.py:348-388: guided and unguided requests in one
    batch of 3 lanes (one lane reused); the guided streams equal the JAX
    engine's and conform, the unguided ones equal a plain engine's token
    for token (the free state allows every token)."""
    jp, tp = params
    tf, jf = fsms["choice"]
    guided = dict(max_new_tokens=N_NEW, stop_token_ids=(EOS,), guided=True)
    free = dict(max_new_tokens=N_NEW)
    reqs = [(PROMPTS[0], free), (PROMPTS[1], guided), (PROMPTS[2], guided),
            (PROMPTS[1], free)]
    kw = dict(max_lanes=3, max_seq_len=128, decode_chunk=3)
    want = _serve(JBatchedEngine(jp, JCFG, cache_dtype=jnp.float32, guided_fsm=jf, **kw), reqs)
    got = _serve(BatchedEngine(tp, CFG, cache_dtype=torch.float32, guided_fsm=tf, **kw), reqs)
    plain = _serve(BatchedEngine(tp, CFG, cache_dtype=torch.float32, **kw),
                   [(p, free) for p, _ in reqs])
    assert got == want
    for (_, req), stream, ref in zip(reqs, got, plain):
        if req.get("guided"):
            _conforms("choice", stream)
        else:
            assert stream == ref


def test_paged_engine_guided_with_prefix_cache_matches_jax(params, fsms):
    """tests/test_guided.py:390-415: the second identical request takes the
    cached pages and still decodes under the constraint; both packages'
    streams equal."""
    jp, tp = params
    tf, jf = fsms["choice"]
    prompt = [7 + (i % 90) for i in range(70)]  # 3 chunks of 32, 2 full pages
    kw = dict(max_lanes=2, max_seq_len=256, page_size=32, prefill_chunk=32, decode_chunk=4)
    streams = []
    for srv in (JPagedBatchedEngine(jp, JCFG, cache_dtype=jnp.float32, guided_fsm=jf, **kw),
                PagedBatchedEngine(tp, CFG, cache_dtype=torch.float32, guided_fsm=tf, **kw)):
        out = []
        for expect_cached in (0, 64):
            srv.submit(prompt, max_new_tokens=N_NEW, stop_token_ids=(EOS,), guided=True)
            srv.submit(PROMPTS[0], max_new_tokens=N_NEW)
            fin = sorted(srv.run_until_complete(), key=lambda r: r.uid)
            assert fin[0].cached_tokens == expect_cached
            out.append([r.generated for r in fin])
        streams.append(out)
    assert streams[1] == streams[0]
    for g, _ in streams[1]:
        _conforms("choice", g)
