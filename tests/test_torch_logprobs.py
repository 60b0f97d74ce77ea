"""Per-token logprobs and the single stream's penalties in the port against
the JAX package, on the CPU.

``token_logprobs`` takes the raw log-softmax in f32 and exact
``torch.topk`` where the JAX package takes ``approx_max_k`` (a difference
by design, ROADMAP queue 3): the values are held to 1e-5, a top id equal
wherever its log-probability stands apart from its neighbours' by more
than twice the tolerance. The engines run the small int4 serving config of
tests/test_torch_server.py with an f32 cache, the JAX side with
``ARIA_TPU_KERNELS=interpret``, at the prompts of that file's seeded pool
where the two packages' greedy streams agree (its docstring):
``BatchedEngine(logprobs_topk=)``, whose logprobs are held to 3e-2 (the
W4A8 MoE's int8 rounding flips move the logits by up to the relative 2e-2
of tests/test_torch_slice.py; up to 1.24e-2 seen here), and ``Engine`` with the
presence, frequency and repetition penalties.
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
from aria_tpu.ops.quant import dequantize_weight
from aria_tpu_torch.checkpoint.from_jax import from_jax
from aria_tpu_torch.config import config_from_dict
from aria_tpu_torch.engine import sampling as tsampling
from aria_tpu_torch.engine.generate import Engine, GenerationConfig
from aria_tpu_torch.engine.server import BatchedEngine

torch.set_num_threads(1)

JTEXT = JTextConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2,
                    num_kv_heads=2, head_dim=128, num_experts=8, moe_topk=2,
                    moe_intermediate_size=128, num_shared_experts=2, max_seq_len=512)
JCFG = JAriaConfig.tiny().replace(text=JTEXT)
CFG = config_from_dict(dataclasses.asdict(JCFG))
SEED = 1
_rng = np.random.RandomState(SEED + 100)  # tests/test_torch_server.py's pool
_POOL = {n: [int(t) for t in _rng.randint(1, 512, n)]
         for n in (3, 5, 9, 14, 20, 27, 33, 40, 45, 50, 60)}
PROMPTS = [_POOL[n] for n in (3, 50, 5, 14, 20)]
N_NEW = 8
K = 4
LP_TOL = 1e-5  # token_logprobs on the same logits
ENGINE_LP_TOL = 3e-2  # through the engines (module docstring)


def _check_logprobs(got, want, tol):
    """(chosen, top ids, top lps) of the port against the JAX package's."""
    chosen, ids, lps = (np.asarray(a) for a in got)
    jchosen, jids, jlps = (np.asarray(a) for a in want)
    np.testing.assert_allclose(chosen, jchosen, atol=tol, rtol=0)
    np.testing.assert_allclose(lps, jlps, atol=tol, rtol=0)
    # a rank's id is held where its log-probability stands apart from both
    # neighbours' by more than 2 tol (the last rank's lower neighbour, rank
    # k + 1, is not reported: it is left out)
    gap = np.diff(-lps, axis=-1) > 2 * tol  # [..., k - 1]: rank j against rank j + 1
    clear = np.zeros(ids.shape, bool)
    clear[..., :-1] = gap
    clear[..., 1:-1] &= gap[..., :-1]
    assert clear.any()
    np.testing.assert_array_equal(ids[clear], jids[clear])


def test_token_logprobs_matches_jax():
    rng = np.random.RandomState(3)
    logits = (rng.randn(6, 300) * 4).astype(np.float32)
    toks = rng.randint(0, 300, 6).astype(np.int32)
    got = tsampling.token_logprobs(torch.from_numpy(logits), torch.from_numpy(toks), K)
    want = jsampling.token_logprobs(jnp.asarray(logits), jnp.asarray(toks), k=K)
    assert got[1].dtype == torch.int32 and got[1].shape == (6, K)
    _check_logprobs(got, want, LP_TOL)
    # a row's log-probabilities normalize, and top-1 is its argmax
    assert torch.allclose(got[2][:, 0], torch.log_softmax(torch.from_numpy(logits), -1).amax(-1))
    assert got[1][:, 0].tolist() == logits.argmax(-1).tolist()


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


def _served(engine, prompts):
    uids = [engine.submit(p, max_new_tokens=N_NEW) for p in prompts]
    fin = {r.uid: r for r in engine.run_until_complete()}
    assert len(fin) == len(prompts) and not any(r.error for r in fin.values())
    return [fin[u] for u in uids]


def test_batched_engine_logprobs_match_jax(params):
    """Five greedy requests on three lanes (grouped prefills, a reused
    lane): each token's logprob and its top K against the JAX engine's;
    greedy, a token's logprob is its top-1 entry and top-1's id is it."""
    jp, tp = params
    kw = dict(max_lanes=3, max_seq_len=128, decode_chunk=3, logprobs_topk=K)
    want = _served(JBatchedEngine(jp, JCFG, cache_dtype=jnp.float32, **kw), PROMPTS)
    got = _served(BatchedEngine(tp, CFG, cache_dtype=torch.float32, **kw), PROMPTS)
    for g, w in zip(got, want):
        assert g.generated == w.generated and len(g.generated) == N_NEW
        assert len(g.logprobs) == len(g.top_logprobs) == N_NEW
        ids = np.array([list(d) for d in g.top_logprobs])
        lps = np.array([list(d.values()) for d in g.top_logprobs])
        jids = np.array([list(d) for d in w.top_logprobs])
        jlps = np.array([list(d.values()) for d in w.top_logprobs])
        _check_logprobs((g.logprobs, ids, lps), (w.logprobs, jids, jlps), ENGINE_LP_TOL)
        for tok, lp, top in zip(g.generated, g.logprobs, g.top_logprobs):
            (best, best_lp), *_ = top.items()
            assert best == tok and lp == best_lp and lp <= 0.0


def test_logprobs_leave_the_streams_alone(params):
    _, tp = params
    kw = dict(max_lanes=3, max_seq_len=128, decode_chunk=3, cache_dtype=torch.int8)
    plain = _served(BatchedEngine(tp, CFG, **kw), PROMPTS)
    with_lp = _served(BatchedEngine(tp, CFG, logprobs_topk=2, **kw), PROMPTS)
    assert [r.generated for r in plain] == [r.generated for r in with_lp]
    assert not plain[0].logprobs and len(with_lp[0].top_logprobs[0]) == 2


PENALTIES = [dict(repetition_penalty=1.3), dict(presence_penalty=0.5, frequency_penalty=0.3),
             dict(presence_penalty=0.4, frequency_penalty=0.2, repetition_penalty=1.2)]


@pytest.mark.parametrize("pen", range(len(PENALTIES)))
def test_engine_penalized_greedy_matches_jax(params, pen):
    """The single stream's penalties (generate.py:486-497): a [1, V] count
    plane and the prompt mask on the device, through the prefill's sample
    and every decode step; greedy against the JAX engine."""
    jp, tp = params
    kw = PENALTIES[pen]
    n = 12
    for prompt in PROMPTS[:2]:
        want = JEngine(jp, JCFG, max_seq_len=128, cache_dtype=jnp.float32).generate(
            prompt, JGen(max_new_tokens=n, temperature=0.0, top_k=None, decode_chunk=5, **kw))
        got = Engine(tp, CFG, max_seq_len=128, cache_dtype=torch.float32).generate(
            prompt, GenerationConfig(max_new_tokens=n, temperature=0.0, top_k=None,
                                     decode_chunk=5, **kw))
        assert got.tokens == want.tokens


def test_engine_repetition_penalty_bites(params):
    """A huge repetition penalty: no token of the prompt or the output
    comes again, at temperature 0 and sampled."""
    _, tp = params
    eng = Engine(tp, CFG, max_seq_len=128, cache_dtype=torch.int8, rng_seed=5)
    for temp in (0.0, 0.9):
        toks = eng.generate(PROMPTS[2], GenerationConfig(max_new_tokens=16, temperature=temp,
                                                         top_k=None, repetition_penalty=1e6,
                                                         decode_chunk=4)).tokens
        assert len(set(toks)) == len(toks) == 16 and not set(toks) & set(PROMPTS[2])
