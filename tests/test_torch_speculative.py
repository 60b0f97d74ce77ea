"""Prompt-lookup speculative decoding in the port against the JAX package,
on the CPU (after tests/test_speculative.py).

The small int4 serving config of tests/test_torch_server.py (hidden 256, 2
heads x 128, 2 layers, 8 + 2 experts, f32): the same param tree goes
through both packages, the JAX side with ``ARIA_TPU_KERNELS=interpret``.

The matcher and the greedy acceptance are held equal to the JAX functions;
the sampled acceptance draws from another generator, so its marginal is
held to the target by a binomial bound. The verify step attends several
new tokens over the cache (``cached_attention_plain``) with the decode
kernel's roundings, so its logits are a decode step's up to the order of
the sums, and greedy speculative decoding equals plain greedy decoding
token for token with an f32 and an int8 cache. The JAX package's verify
step attends an f32 plane in XLA while its decode kernel rounds to bf16
over a quantized cache (and sums in another order over an f32 one), so its
own speculative stream leaves its greedy stream at a near tie (ROADMAP
queue 3 (b)); the port's stream is held to the JAX greedy stream, which
the reference promises, and to the JAX speculative stream where that one
keeps the promise. As in tests/test_torch_server.py, the prompts are those
of a seeded pool where the two packages' plain greedy streams agree (the
W4A8 MoE's int8 rounding flips, ROADMAP queue 3 (d)).
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
from aria_tpu.engine import speculative as jspec
from aria_tpu.engine.generate import Engine as JEngine
from aria_tpu.engine.generate import GenerationConfig as JGen
from aria_tpu.models import moe_lm as jm
from aria_tpu.ops import backend as jbackend
from aria_tpu.ops.quant import dequantize_weight
from aria_tpu_torch.checkpoint.from_jax import from_jax
from aria_tpu_torch.config import config_from_dict
from aria_tpu_torch.engine import speculative as tspec
from aria_tpu_torch.engine.generate import Engine, GenerationConfig
from aria_tpu_torch.engine.speculative import SpeculativeConfig
from aria_tpu_torch.models import moe_lm as tm

torch.set_num_threads(1)

JTEXT = JTextConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2,
                    num_kv_heads=2, head_dim=128, num_experts=8, moe_topk=2,
                    moe_intermediate_size=128, num_shared_experts=2, max_seq_len=512)
JCFG = JAriaConfig.tiny().replace(text=JTEXT)
CFG = config_from_dict(dataclasses.asdict(JCFG))
TEXT = CFG.text
SEED = 1
_rng = np.random.RandomState(7)
# repetitive prompts, so that the matcher drafts from the prompt: four
# seeded 4-token phrases, each said four times
PROMPTS = [[int(t) for t in _rng.randint(1, 512, 4)] * 4 for _ in range(4)]
N_NEW = 24
SPEC = SpeculativeConfig(k=4, ngram=2, steps_per_chunk=3)
CACHES = {"float32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}


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


def _gen(**kw):
    return GenerationConfig(max_new_tokens=N_NEW, temperature=0.0, top_k=None, decode_chunk=7,
                            **kw)


# ------------------------------------------------------------ the matcher and acceptance


@pytest.mark.parametrize("n,k", [(1, 3), (2, 4), (3, 2)])
def test_ngram_draft_matches_jax(n, k):
    rng = np.random.RandomState(10 * n + k)
    hist = rng.randint(0, 5, (4, 40)).astype(np.int32)  # 5 symbols: many matches
    hist_len = np.array([40 - 2 * k, 12, n + 1, 25], np.int32)
    want = np.asarray(jspec.ngram_draft(jnp.asarray(hist), jnp.asarray(hist_len), n, k))
    got = tspec.ngram_draft(torch.from_numpy(hist), torch.from_numpy(hist_len), n, k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_ngram_draft_latest_match_and_no_match():
    """tests/test_speculative.py:34-49."""
    hist = torch.zeros((1, 32), dtype=torch.int32)
    seq = [9, 7, 8, 1, 2, 3, 9, 7, 8, 4, 5, 6, 9, 7, 8]
    hist[0, :len(seq)] = torch.tensor(seq)
    assert tspec.ngram_draft(hist, torch.tensor([len(seq)]), 2, 3)[0].tolist() == [4, 5, 6]
    short = torch.zeros((1, 16), dtype=torch.int32)
    short[0, :4] = torch.tensor([1, 2, 3, 4])
    assert tspec.ngram_draft(short, torch.tensor([4]), 2, 2).shape == (1, 2)


def test_verify_greedy_matches_jax():
    rng = np.random.RandomState(3)
    B, K1, V = 5, 5, 11
    logits = rng.randn(B, K1, V).astype(np.float32)
    draft = logits.argmax(-1)[:, :-1].astype(np.int32)
    for b, cut in enumerate((0, 1, 2, 4, 3)):  # row b diverges at draft position `cut`
        if cut < K1 - 1:
            draft[b, cut] = (draft[b, cut] + 1) % V
    want = [np.asarray(a) for a in jspec.verify_greedy(jnp.asarray(logits), jnp.asarray(draft))]
    got = tspec.verify_greedy(torch.from_numpy(logits), torch.from_numpy(draft))
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert got[1].tolist() == [1, 2, 3, 5, 4]


def test_verify_sampled_marginal_matches_target():
    """The first produced token's law is the target's (tests/test_speculative.py:
    64-83): 4,000 rows of one draft that the target partly agrees with, in
    one batched call, each bucket within 3.5 binomial sigmas + 1e-3."""
    V, N, temp = 8, 4000, 0.9
    logits = np.random.RandomState(0).randn(1, 2, V).astype(np.float32) * 1.5
    p = np.exp(logits[0, 0].astype(np.float64) / temp)
    p /= p.sum()
    gen = torch.Generator().manual_seed(42)
    prod, n = tspec.verify_sampled(gen, torch.from_numpy(logits).expand(N, 2, V),
                                   torch.full((N, 1), 3, dtype=torch.int32), temp, None)
    emp = np.bincount(prod[:, 0].numpy(), minlength=V) / N
    sigma = np.sqrt(p * (1 - p) / N)
    assert np.all(np.abs(emp - p) < 3.5 * sigma + 1e-3), (emp, p)
    # a rejected draft is never the bonus token
    rejected = n.numpy() == 1
    assert rejected.any() and not (prod[rejected, 0] == 3).any()


def test_verify_sampled_full_acceptance():
    """tests/test_speculative.py:85-96: a target that is the draft accepts all."""
    logits = torch.full((1, 3, 6), -30.0)
    logits[0, 0, 2] = logits[0, 1, 4] = logits[0, 2, 1] = 30.0
    prod, n = tspec.verify_sampled(torch.Generator().manual_seed(0), logits,
                                   torch.tensor([[2, 4]], dtype=torch.int32), 1.0, None)
    assert int(n[0]) == 3 and prod[0].tolist() == [2, 4, 1]


# ------------------------------------------------------------ several new tokens over a cache


def _prefilled(lm_j, lm_t, cache_j, cache_t, prompts):
    """Each lane's prompt prefilled from position 0 in both packages (one
    bucket for all lanes)."""
    S = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), S), np.int32)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = p
    pos = np.arange(S)
    mask = (np.arange(cache_j.k.shape[3])[None, :] <= pos[:, None])[None, None]
    cache_j = jm.lm_forward(lm_j, JTEXT, jnp.asarray(toks), positions=jnp.asarray(pos),
                            mask=jnp.asarray(mask), cache=cache_j, cache_pos=jnp.int32(0),
                            causal_flash=True).cache
    tm.lm_forward(lm_t, TEXT, torch.from_numpy(toks).long(), positions=torch.arange(S),
                  cache=cache_t, cache_pos=0, causal_flash=True)
    return cache_j


@pytest.mark.parametrize("cache", ["float32", "int8", "int4"])
def test_verify_forward_matches_jax(params, cache):
    """The JAX branch at moe_lm.py:614-638: two lanes at positions 20 and 13,
    each feeding 5 tokens through one forward with per-lane ``cache_pos``;
    token i of lane b attends positions up to cache_pos[b] + i. With the f32
    cache the logits agree to the relative 2e-2 of tests/test_torch_slice.py
    (the W4A8 MoE's int8 rounding flips: 0.5-0.6% seen here) and layer 0's
    written k/v, upstream of any MoE, to 1e-4 (the JAX dense kernel's ~1e-5
    split of tests/test_torch_slice.py); over a quantized
    cache the port rounds as its decode kernel does (q, p and the output to
    bf16) where the JAX package attends an f32 plane: 5e-2."""
    (jp, tp) = params
    jdt = {"float32": jnp.float32, "int8": jnp.int8, "int4": "int4"}[cache]
    tdt = {"float32": torch.float32, "int8": torch.int8, "int4": "int4"}[cache]
    Smax = 64
    cj = jm.KVCache.init(JTEXT, 2, Smax, jdt)
    ct = tm.KVCache.init(TEXT, 2, Smax, tdt, device="cpu")
    cj = _prefilled(jp["lm"], tp["lm"], cj, ct, [PROMPTS[0][:20], PROMPTS[1][:20]])
    start = np.array([20, 13], np.int32)
    fed = np.random.RandomState(5).randint(1, 512, (2, 5)).astype(np.int32)
    positions = start[:, None] + np.arange(5)[None, :]
    mask = (np.arange(Smax)[None, None, :] <= positions[:, :, None])[:, None]
    out_j = jm.lm_forward(jp["lm"], JTEXT, jnp.asarray(fed), positions=jnp.asarray(positions),
                          mask=jnp.asarray(mask), cache=cj, cache_pos=jnp.asarray(start))
    with torch.inference_mode():
        out_t = tm.lm_forward(tp["lm"], TEXT, torch.from_numpy(fed).long(),
                              positions=torch.from_numpy(positions),
                              cache=ct, cache_pos=torch.from_numpy(start))
    want, got = np.asarray(out_j.logits), out_t.logits.numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < (2e-2 if cache == "float32" else 5e-2), rel
    if cache == "float32":
        for name in ("k", "v"):
            np.testing.assert_allclose(getattr(ct, name)[0].numpy(),
                                       np.asarray(getattr(out_j.cache, name)[0]),
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cache", ["float32", "int8", "int4"])
def test_verify_step_is_decode_steps(params, cache):
    """One forward of k + 1 tokens over the cache gives the logits of k + 1
    decode steps fed the same tokens, to float rounding, and writes the
    same cache."""
    _, tp = params
    tdt = {"float32": torch.float32, "int8": torch.int8, "int4": "int4"}[cache]
    prompt = torch.tensor([PROMPTS[2]]).long()
    fed = torch.tensor([[7, 300, 12, 45, 9]])
    caches = []
    for _ in range(2):
        c = tm.KVCache.init(TEXT, 1, 128, tdt, device="cpu")
        tm.lm_forward(tp["lm"], TEXT, prompt, cache=c, cache_pos=0, causal_flash=True)
        caches.append(c)
    start = torch.tensor([prompt.shape[1]], dtype=torch.int32)
    with torch.inference_mode():
        verify = tm.lm_forward(tp["lm"], TEXT, fed, positions=start[:, None] + torch.arange(5),
                               cache=caches[0], cache_pos=start).logits[0]
        steps = torch.cat([tm.lm_forward(tp["lm"], TEXT, fed[:, i:i + 1],
                                         positions=start + i, cache=caches[1],
                                         cache_pos=start + i).logits[0] for i in range(5)])
    assert (verify - steps).abs().max().item() <= 1e-4 * steps.abs().max().item()
    assert verify.argmax(-1).tolist() == steps.argmax(-1).tolist()
    torch.testing.assert_close(caches[0].k.float(), caches[1].k.float(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("cache", ["int8", "int4", "bfloat16"])
def test_verify_writes_through_the_prologue(params, cache, monkeypatch):
    """The verify step's write takes ``rope_kv_write`` (one slot a token:
    lane b's S tokens at cache_pos[b] + s) and no chain op; through the
    chain it replaced (``_prologue_dest`` None) the cache and logits are
    bit-equal."""
    _, tp = params
    tdt = {"int8": torch.int8, "int4": "int4", "bfloat16": torch.bfloat16}[cache]
    lm = tp["lm"]
    fed = torch.tensor([[7, 300, 12], [45, 9, 1]])
    start = torch.tensor([5, 9], dtype=torch.int32)

    def run():
        c = tm.KVCache.init(TEXT, 2, 64, tdt, device="cpu")
        with torch.inference_mode():
            out = tm.lm_forward(lm, TEXT, fed, positions=start[:, None] + torch.arange(3),
                                cache=c, cache_pos=start).logits
        return c, out

    calls = {"rope_kv_write": 0}
    fused = tm.rope_kv_write

    def counted(*a, **kw):
        calls["rope_kv_write"] += 1
        return fused(*a, **kw)

    monkeypatch.setattr(tm, "rope_kv_write", counted)
    c1, o1 = run()
    assert calls["rope_kv_write"] == TEXT.num_layers
    monkeypatch.setattr(tm, "_prologue_dest", lambda *a: None)
    c2, o2 = run()
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(c1, name), getattr(c2, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b), name
    assert torch.equal(o1, o2)
    # lane 1's third token sits at 9 + 2; nothing past it was written
    assert (c1.k[:, 1, :, 12:] == 0).all() and (c1.k[:, 1, :, 11] != 0).any()


# ------------------------------------------------------------ the engine


@pytest.fixture(scope="module")
def streams(params):
    """Per cache and prompt: the JAX plain greedy and speculative streams
    and the port's, all through ``Engine.generate``."""
    jp, tp = params
    out = {}
    for name, (jdt, tdt) in CACHES.items():
        je = JEngine(jp, JCFG, max_seq_len=512, cache_dtype=jdt)
        te = Engine(tp, CFG, max_seq_len=512, cache_dtype=tdt)
        jg = JGen(max_new_tokens=N_NEW, temperature=0.0, top_k=None, decode_chunk=7)
        jsp = jspec.SpeculativeConfig(k=SPEC.k, ngram=SPEC.ngram,
                                      steps_per_chunk=SPEC.steps_per_chunk)
        for i, prompt in enumerate(PROMPTS):
            spec = te.generate(prompt, _gen(speculative=SPEC))
            out[name, i] = dict(
                jax_plain=je.generate(prompt, jg).tokens,
                jax_spec=je.generate(prompt, dataclasses.replace(jg, speculative=jsp)).tokens,
                plain=te.generate(prompt, _gen()).tokens, spec=spec.tokens, result=spec)
    return out


@pytest.mark.parametrize("cache", list(CACHES))
def test_greedy_speculative_equals_plain_greedy(streams, cache):
    for i in range(len(PROMPTS)):
        s = streams[cache, i]
        assert len(s["spec"]) == N_NEW and s["spec"] == s["plain"], i
        r = s["result"]
        # every verify step counted put its tokens into the result
        assert r.verify_steps == len(r.produced_per_step) and min(r.produced_per_step) >= 1
        assert sum(r.produced_per_step) == r.steps == N_NEW - 1
    # the matcher drafts from the repetitive prompts: some step takes a draft token
    assert max(max(streams[cache, i]["result"].produced_per_step)
               for i in range(len(PROMPTS))) > 1


@pytest.mark.parametrize("cache", list(CACHES))
def test_greedy_speculative_matches_jax(streams, cache):
    """Held to the JAX greedy stream at every prompt where the two packages'
    plain greedy streams agree (module docstring), and to the JAX
    speculative stream where it equals the JAX greedy stream."""
    agree = [i for i in range(len(PROMPTS))
             if streams[cache, i]["plain"] == streams[cache, i]["jax_plain"]]
    assert len(agree) >= 2, agree
    for i in agree:
        s = streams[cache, i]
        assert s["spec"] == s["jax_plain"], i
        if s["jax_spec"] == s["jax_plain"]:
            assert s["spec"] == s["jax_spec"], i


def test_stop_token_and_stop_check(params, streams):
    """A stop token mid-stream ends the speculative stream where it ends the
    plain one (tests/test_speculative.py:120-134); so does ``stop_check``,
    which the JAX engine's speculative path never calls (ROADMAP queue 3
    (a)), and the plain path's equals the JAX engine's."""
    jp, tp = params
    full = streams["float32", 0]["plain"]
    stop = full[N_NEW // 2]
    eng = Engine(tp, CFG, max_seq_len=512, cache_dtype=torch.float32)
    cut = full[:full.index(stop) + 1]
    for sp in (None, SPEC):
        assert eng.generate(PROMPTS[0], _gen(stop_token_ids=(stop,), speculative=sp)).tokens \
            == cut
    target = full[7]

    def seen(tokens):
        return tokens[-1] == target

    at = next(i for i, t in enumerate(full) if i > 0 and t == target)
    got = [eng.generate(PROMPTS[0], _gen(speculative=sp), stop_check=seen) for sp in (None, SPEC)]
    assert got[0].tokens == got[1].tokens == full[:at + 1]
    assert sum(got[1].produced_per_step) == got[1].steps
    want = JEngine(jp, JCFG, max_seq_len=512, cache_dtype=jnp.float32).generate(
        PROMPTS[0], JGen(max_new_tokens=N_NEW, temperature=0.0, top_k=None, decode_chunk=7),
        stop_check=seen)
    assert want.tokens == got[0].tokens


def test_sampled_speculative_is_seeded(params):
    """tests/test_speculative.py:136-146: the prefill token counts toward
    max_new_tokens; a seed repeats the stream."""
    _, tp = params
    gen = GenerationConfig(max_new_tokens=N_NEW, temperature=0.8, top_k=50, top_p=0.95,
                           speculative=SpeculativeConfig(k=3, ngram=2, steps_per_chunk=4))
    a, b = (Engine(tp, CFG, max_seq_len=512, rng_seed=4).generate(PROMPTS[1], gen)
            for _ in range(2))
    assert a.tokens == b.tokens and a.steps == N_NEW - 1
    assert all(0 <= t < TEXT.vocab_size for t in a.tokens)
    assert sum(a.produced_per_step) == a.steps


def test_slack_and_refusals(params):
    """tests/test_speculative.py:148-171: guided decoding and penalties are
    refused with a speculative config, and the cache must hold two chunks
    of verify rows past max_new_tokens."""
    _, tp = params
    eng = Engine(tp, CFG, max_seq_len=512)
    with pytest.raises(ValueError, match="speculative"):
        eng.generate([1, 2, 3], GenerationConfig(max_new_tokens=4, repetition_penalty=1.5,
                                                 speculative=SpeculativeConfig()))
    with pytest.raises(ValueError, match="slack"):
        eng.generate([1, 2, 3], GenerationConfig(
            max_new_tokens=420, speculative=SpeculativeConfig(k=7, steps_per_chunk=8)))
    # 2 * 8 * 8 + 7 = 135 rows of slack: 32 + 345 + 135 = 512 fits
    assert len(eng.generate([1, 2, 3], GenerationConfig(
        max_new_tokens=345, temperature=0.0, stop_token_ids=tuple(range(512)),
        speculative=SpeculativeConfig(k=7, steps_per_chunk=8))).tokens) == 1
