"""The port's serving slice end to end against the JAX package, on the CPU.

A small config that engages all four kernels (hidden 256, 2 heads x 128,
2 layers, 8 + 2 experts, top-2, I = 128, vocab 512, f32): the JAX
``init_lm_params_serving_int4`` tree goes through ``from_jax``; the JAX
side runs with ``ARIA_TPU_KERNELS=interpret`` (dense_int4, moe_decode_int4
and decode_attention in interpret mode, flash through its sdpa path), the
port through its plain versions.

``embed`` is given as a plain f32 table (the dequantized int8 one): an
int8 table yields bf16 embeddings (aria.py:92), and with f32 norms the
JAX layer scan then fails on its carry dtype.

Where the two runs can differ: the W4A8 MoE rounds its activations and h
to int8. The JAX dense kernel's biased-lo split (and XLA's summation
order) leaves ~1e-5 differences upstream, and a value that sits on a
rounding boundary of that int8 quantize flips by one step in one run and
not the other; the flip moves that token's MoE output by ~1e-2 and every
later position through attention. The logits are therefore held to a
relative error, and the greedy streams are pinned at a seed and prompt
where no flip changes a token (it is deterministic on a given build).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aria_tpu.config import AriaConfig, TextConfig
from aria_tpu.engine.generate import Engine as JEngine
from aria_tpu.engine.generate import GenerationConfig as JGen
from aria_tpu.models import moe_lm as jm
from aria_tpu.ops import backend as jbackend
from aria_tpu.ops.quant import dequantize_weight
from aria_tpu_torch.checkpoint.from_jax import from_jax
from aria_tpu_torch.config import config_from_dict
from aria_tpu_torch.data.tokenizer import ByteTokenizer
from aria_tpu_torch.engine.generate import Engine, GenerationConfig
from aria_tpu_torch.engine.guided import regex_fsm
from aria_tpu_torch.engine.speculative import SpeculativeConfig
from aria_tpu_torch.models import moe_lm as tm
from aria_tpu_torch.parallel.mesh import Mesh, MeshConfig

torch.set_num_threads(1)

TEXT = TextConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2,
                  num_kv_heads=2, head_dim=128, num_experts=8, moe_topk=2,
                  moe_intermediate_size=128, num_shared_experts=2, max_seq_len=512)
CFG = AriaConfig.tiny().replace(text=TEXT)
T_CFG = config_from_dict(dataclasses.asdict(CFG))  # the port's own config, field for field
T_TEXT = T_CFG.text
SEED = 1
PROMPT = [int(t) for t in np.random.RandomState(101).randint(1, 512, 48)]


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
    lm = jm.init_lm_params_serving_int4(jax.random.PRNGKey(SEED), TEXT, dtype=jnp.float32)
    lm["embed"] = dequantize_weight(lm["embed"], dtype=jnp.float32)
    return lm, from_jax(jax.tree.map(np.asarray, lm), device="cpu")


def test_lm_forward_logits_match_jax(params):
    lm, tlm = params
    toks = np.random.RandomState(SEED).randint(0, 512, (1, 40)).astype(np.int32)
    ref = np.asarray(jm.lm_forward(lm, TEXT, jnp.asarray(toks)).logits)
    with torch.inference_mode():
        got = tm.lm_forward(tlm, T_TEXT, torch.from_numpy(toks).long()).logits.numpy()
    assert got.shape == ref.shape == (1, 40, TEXT.vocab_size)
    # W4A8 rounding flips (module docstring): seen 0.5-0.8% relative, and
    # at most 0.06 on logits of magnitude ~4; a wrong scale or layout is O(1)
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < 2e-2, rel
    assert np.abs(got - ref).max() < 0.05 * np.abs(ref).max()
    # before any position that a flip reaches, the match is to f32 rounding
    np.testing.assert_allclose(got[0, 0], ref[0, 0], rtol=1e-4, atol=1e-4)


def test_lm_forward_with_logit_position_matches_full(params):
    _, tlm = params
    toks = torch.from_numpy(np.random.RandomState(2).randint(0, 512, (1, 24))).long()
    with torch.inference_mode():
        full = tm.lm_forward(tlm, T_TEXT, toks).logits
        one = tm.lm_forward(tlm, T_TEXT, toks, logit_position=17).logits
    assert one.shape == (1, 1, TEXT.vocab_size)
    # one row against 24 rows through lm_head: the matmul blocks differ
    torch.testing.assert_close(one[0, 0], full[0, 17], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_greedy_stream_matches_jax_engine(params, cache_dtype):
    lm, tlm = params
    jr = JEngine({"lm": lm}, CFG, max_seq_len=128, cache_dtype=getattr(jnp, cache_dtype)).generate(
        PROMPT, JGen(max_new_tokens=16, temperature=0.0, decode_chunk=8))
    tr = Engine({"lm": tlm}, T_CFG, max_seq_len=128,
                cache_dtype=getattr(torch, cache_dtype)).generate(
        PROMPT, GenerationConfig(max_new_tokens=16, temperature=0.0, decode_chunk=8))
    assert len(tr.tokens) == 16 and tr.steps == 15
    assert tr.tokens == jr.tokens


def test_stop_token_trims_the_stream(params):
    _, tlm = params
    eng = Engine({"lm": tlm}, T_CFG, max_seq_len=128)
    full = eng.generate(PROMPT, GenerationConfig(max_new_tokens=12, temperature=0.0,
                                                 decode_chunk=5)).tokens
    stop = full[6]
    cut = eng.generate(PROMPT, GenerationConfig(max_new_tokens=12, temperature=0.0,
                                                decode_chunk=5, stop_token_ids=(stop,))).tokens
    assert cut == full[: full.index(stop) + 1]


def test_sampled_stream_is_seeded_and_in_range(params):
    _, tlm = params
    gen = GenerationConfig(max_new_tokens=10, temperature=0.8, top_k=50, top_p=0.95,
                           min_p=0.01, decode_chunk=4)
    a = Engine({"lm": tlm}, T_CFG, max_seq_len=128, rng_seed=3).generate(PROMPT, gen).tokens
    b = Engine({"lm": tlm}, T_CFG, max_seq_len=128, rng_seed=3).generate(PROMPT, gen).tokens
    assert a == b and len(a) == 10
    assert all(0 <= t < TEXT.vocab_size for t in a)


def test_paths_not_yet_ported_raise(params):
    _, tlm = params
    eng = Engine({"lm": tlm}, T_CFG, max_seq_len=512)
    # a prompt over 128 tokens now prefills through moe_prefill_int4
    assert len(eng.generate(list(range(1, 200)), GenerationConfig(max_new_tokens=2)).tokens) == 2
    # speculative, guided and penalized decoding are ported
    # (tests/test_torch_speculative.py, test_torch_guided.py); what still
    # raises is speculative decoding over a serving mesh (ROADMAP queue 1 item 11)
    mesh = Engine({"lm": tlm}, T_CFG, max_seq_len=512,
                  mesh=Mesh(MeshConfig(context=2), 0, {"model": None, "context": None}))
    with pytest.raises(NotImplementedError, match="speculative decoding over a serving mesh"):
        mesh.generate(PROMPT, GenerationConfig(speculative=SpeculativeConfig()))
    with pytest.raises(ValueError, match="not \\(yet\\) with guided decoding"):
        eng.generate(PROMPT, GenerationConfig(presence_penalty=0.5,
                                              speculative=SpeculativeConfig()))
    fsm = regex_fsm("(yes|no)", ByteTokenizer(), [0], vocab_size=512, device="cpu")
    with pytest.raises(ValueError, match="guided FSM is on meta"):
        eng.generate(PROMPT, GenerationConfig(guided=fsm.to("meta")))
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.generate(PROMPT, GenerationConfig(max_new_tokens=1000))
    with pytest.raises(NotImplementedError, match="ft=256"):
        tm.lm_forward(tlm, dataclasses.replace(T_TEXT, moe_intermediate_size=2304),
                      torch.zeros((1, 4), dtype=torch.long))


@pytest.mark.parametrize("I,ft", [(1664, 1664), (128, 128), (2048, 2048), (2304, 256),
                                  (3072, 1024), (192, None)])
def test_decode_kernel_tile_follows_the_jax_rule(I, ft):
    """moe_lm.py:945-961 (no env override): ft = I = 1664 at flagship."""
    assert tm.decode_kernel_tile(I) == ft


@pytest.mark.parametrize("I,ft", [(1664, 128), (2048, 512), (768, 256), (192, None)])
def test_prefill_kernel_tile_follows_the_jax_rule(I, ft):
    """moe_lm.py:985-1002: the first of 512, 256, 128 dividing I."""
    assert tm.prefill_kernel_tile(I) == ft


def test_torch_init_serves_a_request():
    cfg = T_TEXT
    lm = tm.init_lm_params_serving_int4(cfg, torch.Generator().manual_seed(0), device="cpu",
                                        dtype=torch.float32)
    eng = Engine({"lm": lm}, T_CFG, max_seq_len=128, cache_dtype=torch.int8)
    out = eng.generate(PROMPT[:20], GenerationConfig(max_new_tokens=6, temperature=0.0,
                                                     decode_chunk=3))
    assert len(out.tokens) == 6 and all(0 <= t < cfg.vocab_size for t in out.tokens)
