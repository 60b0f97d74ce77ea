"""The bf16 and int8 serving forms of the port against the JAX package, on
the CPU.

The forms bench.py builds without ``--int4`` (bench.py:410-425):
``init_lm_params``, for int8 ``quantize_params``, then
``fuse_shared_experts``. A small config that engages the decode kernels
and the ragged path (hidden 256, 2 heads x 128, 2 layers, 8 + 2 experts,
top-2, I = 128, vocab 512, f32, as tests/test_torch_slice.py builds it):
the JAX tree goes through ``from_jax``; the JAX side runs with
``ARIA_TPU_KERNELS=interpret`` (``moe_decode`` / ``moe_decode_quant`` and
megablox ``gmm`` in interpret mode), the port through its plain versions.
Every product is f32 on both sides, so values agree to f32 rounding in
another summation order.
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
from aria_tpu.ops import quant as jquant
from aria_tpu.ops.moe import experts_ragged as j_experts_ragged
from aria_tpu.ops.moe_decode_kernel import moe_decode as j_moe_decode
from aria_tpu.ops.moe_decode_kernel import moe_decode_quant as j_moe_decode_quant
from aria_tpu_torch.checkpoint.from_jax import from_jax
from aria_tpu_torch.config import config_from_dict
from aria_tpu_torch.engine.generate import Engine, GenerationConfig
from aria_tpu_torch.models import moe_lm as tm
from aria_tpu_torch.ops import moe as tmoe
from aria_tpu_torch.ops import moe_decode_kernel as mk
from aria_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)

TEXT = TextConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2,
                  num_kv_heads=2, head_dim=128, num_experts=8, moe_topk=2,
                  moe_intermediate_size=128, num_shared_experts=2, max_seq_len=512)
CFG = AriaConfig.tiny().replace(text=TEXT)
T_CFG = config_from_dict(dataclasses.asdict(CFG))
T_TEXT = T_CFG.text
SEED = 1
FORMS = ("bf16", "int8")
PROMPT = [int(t) for t in np.random.RandomState(101).randint(1, 512, 48)]
LONG_PROMPT = [int(t) for t in np.random.RandomState(102).randint(1, 512, 150)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_form(form: str, dtype=jnp.float32) -> dict:
    """bench.py's build: init, int8 quantize (int8 form only), fuse."""
    params = {"lm": jm.init_lm_params(jax.random.PRNGKey(SEED), TEXT, dtype=dtype)}
    if form == "int8":
        params = jquant.quantize_params(params)
    return jquant.fuse_shared_experts(params, TEXT.num_shared_experts)


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
def forms(interpret):
    """{form: (JAX lm tree, the port's tree from it)}."""
    out = {}
    for form in FORMS:
        lm = _jax_form(form)["lm"]
        out[form] = (lm, from_jax(_np(lm), device="cpu"))
    return out


def _assert_trees_equal(got, want, path=""):
    """Same keys, dtypes, shapes and bytes, leaf for leaf."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        return
    want = np.asarray(want)
    if want.dtype.name == "bfloat16":
        assert got.dtype == torch.bfloat16, path
        got, want = got.view(torch.int16).numpy(), want.view(np.int16)
    else:
        got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", FORMS)
def test_quantize_and_fuse_are_byte_equal_to_jax(form, dtype):
    """quantize_params and fuse_shared_experts of the port on the same
    init tree give the JAX tree byte for byte (int8: the shared MLP is
    dequantized to bf16 and re-quantized per virtual expert)."""
    init = {"lm": jm.init_lm_params(jax.random.PRNGKey(SEED), TEXT, dtype=getattr(jnp, dtype))}
    want = init
    got = {"lm": from_jax(_np(init["lm"]), device="cpu")}
    if form == "int8":
        want, got = jquant.quantize_params(want), tquant.quantize_params(got)
        _assert_trees_equal(got, _np(want))
    want = jquant.fuse_shared_experts(want, TEXT.num_shared_experts)
    got = tquant.fuse_shared_experts(got, TEXT.num_shared_experts)
    _assert_trees_equal(got, _np(want))
    assert "shared_w1" not in got["lm"]["layers"]


@pytest.mark.parametrize("form", FORMS)
def test_from_jax_carries_a_whole_form_tree(form):
    """A whole bf16-form and int8-form tree, bf16 leaves included, crosses
    leaf for leaf."""
    lm = _np(_jax_form(form, jnp.bfloat16)["lm"])
    _assert_trees_equal(from_jax(lm, device="cpu"), lm)


def test_dequantize_expert_weights_matches_jax(forms):
    lm, tlm = forms["int8"]
    want = jquant.dequantize_expert_weights(
        {k: v[1] for k, v in lm["layers"]["w1"].items()},
        {k: v[1] for k, v in lm["layers"]["w2"].items()}, dtype=jnp.float32)
    got = tquant.dequantize_expert_weights(
        {k: v[1] for k, v in tlm["layers"]["w1"].items()},
        {k: v[1] for k, v in tlm["layers"]["w2"].items()}, dtype=torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _routing(T: int, seed: int):
    """top-2 of the 8 routed experts plus the 2 shared ones, as the decoder
    routes; returns (x, indices, weights) as numpy."""
    rng = np.random.RandomState(seed)
    x = rng.randn(T, TEXT.hidden_size).astype(np.float32)
    top = np.argsort(-rng.randn(T, TEXT.num_experts), axis=1)[:, :TEXT.moe_topk]
    ind = np.concatenate([top, np.broadcast_to([8, 9], (T, 2))], 1).astype(np.int32)
    wts = np.concatenate([rng.dirichlet(np.ones(2), T), np.ones((T, 2))], 1).astype(np.float32)
    return x, ind, wts


@pytest.mark.parametrize("T", [1, 5, 32])
@pytest.mark.parametrize("form", FORMS)
def test_moe_decode_matches_jax(forms, form, T):
    """The port's moe_decode / moe_decode_quant against the JAX kernels in
    interpret mode, f32, layer 1 of the fused stacks."""
    lm, tlm = forms[form]
    x, ind, wts = _routing(T, T)
    w1, w2 = lm["layers"]["w1"], lm["layers"]["w2"]
    t1, t2 = tlm["layers"]["w1"], tlm["layers"]["w2"]
    args = (jnp.asarray(x), jnp.asarray(ind), jnp.asarray(wts))
    targs = (torch.from_numpy(x), torch.from_numpy(ind), torch.from_numpy(wts))
    I = TEXT.moe_intermediate_size
    if form == "int8":
        want = j_moe_decode_quant(*args, w1["q"], w1["s8"], w2["q"], w2["s8"], jnp.int32(1),
                                  ft=I, interpret=True)
        got = mk.moe_decode_quant(*targs, t1["q"], t1["s8"], t2["q"], t2["s8"], 1)
    else:
        want = j_moe_decode(*args, w1, w2, jnp.int32(1), ft=I, interpret=True)
        got = mk.moe_decode(*targs, t1, t2, 1)
    # f32 on both sides: rounding in another summation order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("T", [1, 5, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_decode_quant_routed_plain_is_the_plain_version(forms, T, dtype):
    """The routed-pair statement of moe_decode_quant (what
    csrc/moe_decode_bf16x.cu computes) gives the bits of the plain version
    over every unique expert, layer 1 of the int8 stacks."""
    _, tlm = forms["int8"]
    x, ind, wts = _routing(T, 100 + T)
    t1, t2 = tlm["layers"]["w1"], tlm["layers"]["w2"]
    x, wts = torch.from_numpy(x).to(dtype), torch.from_numpy(wts).to(dtype)
    got = mk.moe_decode_quant_routed_plain(x, torch.from_numpy(ind), wts, t1["q"], t1["s8"],
                                           t2["q"], t2["s8"], 1)
    ref = mk.moe_decode_plain(x, torch.from_numpy(ind), wts, t1["q"], t2["q"], 1, t1["s8"],
                              t2["s8"])
    assert got.dtype == ref.dtype == dtype
    assert torch.equal(got, ref)


def test_moe_decode_bf16_activations_match_jax(forms):
    """bf16 x: h and the output round to bf16 on both sides, so a sum at a
    rounding edge may move one element by a bf16 ulp of h."""
    lm, tlm = forms["int8"]
    x, ind, wts = _routing(5, 7)
    w1, w2 = lm["layers"]["w1"], lm["layers"]["w2"]
    t1, t2 = tlm["layers"]["w1"], tlm["layers"]["w2"]
    want = j_moe_decode_quant(jnp.asarray(x, jnp.bfloat16), jnp.asarray(ind),
                              jnp.asarray(wts, jnp.bfloat16), w1["q"], w1["s8"], w2["q"],
                              w2["s8"], jnp.int32(0), ft=128, interpret=True)
    got = mk.moe_decode_quant(torch.from_numpy(x).bfloat16(), torch.from_numpy(ind),
                              torch.from_numpy(wts).bfloat16(), t1["q"], t1["s8"], t2["q"],
                              t2["s8"], 0)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("form", FORMS)
def test_experts_ragged_matches_jax(forms, form):
    """T = 50 tokens x 4 slots = 200 rows (padded to 256 on the last
    group), and routed expert 3 takes no row."""
    lm, tlm = forms[form]
    rng = np.random.RandomState(5)
    T = 50
    x = rng.randn(T, TEXT.hidden_size).astype(np.float32)
    routed = np.array([e for e in range(8) if e != 3])
    top = np.stack([rng.choice(routed, 2, replace=False) for _ in range(T)])
    ind = np.concatenate([top, np.broadcast_to([8, 9], (T, 2))], 1).astype(np.int32)
    wts = np.concatenate([rng.dirichlet(np.ones(2), T), np.ones((T, 2))], 1).astype(np.float32)
    w1, w2 = jquant.dequantize_expert_weights(
        *({k: v[0] for k, v in w.items()} if isinstance(w, dict) else w[0]
          for w in (lm["layers"]["w1"], lm["layers"]["w2"])), dtype=jnp.float32)
    want = j_experts_ragged(jnp.asarray(x), jnp.asarray(ind), jnp.asarray(wts), w1, w2,
                            interpret=True)
    got = tmoe.experts_ragged(torch.from_numpy(x), torch.from_numpy(ind),
                              torch.from_numpy(wts), torch.from_numpy(np.array(w1)),
                              torch.from_numpy(np.array(w2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("transpose_rhs", [True, False])
def test_gmm_plain_is_the_grouped_product(transpose_rhs):
    """Groups in order, an empty one among them; every row through its own
    group's matrix."""
    rng = np.random.RandomState(0)
    sizes = [3, 0, 5, 1]
    lhs = torch.from_numpy(rng.randn(sum(sizes), 16).astype(np.float32))
    rhs = torch.from_numpy(rng.randn(4, 8, 16).astype(np.float32))
    if not transpose_rhs:
        rhs = rhs.transpose(1, 2).contiguous()
    out = tmoe.gmm(lhs, rhs, torch.tensor(sizes, dtype=torch.int32), transpose_rhs)
    group = np.repeat(np.arange(4), sizes)
    for r in range(sum(sizes)):
        w = rhs[group[r]]
        want = lhs[r] @ (w.T if transpose_rhs else w)
        torch.testing.assert_close(out[r], want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("S", [40, 200])
@pytest.mark.parametrize("form", FORMS)
def test_lm_forward_logits_match_jax(forms, form, S):
    """40 tokens run the decode kernel of the form, 200 the ragged path."""
    lm, tlm = forms[form]
    toks = np.random.RandomState(S).randint(0, 512, (1, S)).astype(np.int32)
    want = np.asarray(jm.lm_forward(lm, TEXT, jnp.asarray(toks)).logits)
    with torch.inference_mode():
        got = tm.lm_forward(tlm, T_TEXT, torch.from_numpy(toks).long()).logits.numpy()
    assert got.shape == want.shape == (1, S, TEXT.vocab_size)
    # f32 products on both sides; the sums run in other orders
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("form", FORMS)
def test_greedy_streams_match_jax_engine(forms, form):
    """A 48-token prompt (decode-kernel prefill) and a 150-token one (the
    ragged prefill of a 256 bucket), 16 greedy tokens each."""
    lm, tlm = forms[form]
    jeng = JEngine({"lm": lm}, CFG, max_seq_len=512, cache_dtype=jnp.float32)
    teng = Engine({"lm": tlm}, T_CFG, max_seq_len=512, cache_dtype=torch.float32)
    for prompt in (PROMPT, LONG_PROMPT):
        want = jeng.generate(prompt, JGen(max_new_tokens=16, temperature=0.0, decode_chunk=8))
        got = teng.generate(prompt, GenerationConfig(max_new_tokens=16, temperature=0.0,
                                                     decode_chunk=8))
        assert len(got.tokens) == 16 and got.tokens == want.tokens


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    a = np.asarray(tree) if not isinstance(tree, torch.Tensor) else tree
    return (str(a.dtype).replace("torch.", ""), tuple(a.shape))


@pytest.mark.parametrize("form", FORMS)
def test_serving_init_has_the_jax_tree_and_serves(form):
    """init_lm_params_serving gives the tree quantize_params and
    fuse_shared_experts give (keys, dtypes, shapes), and it serves."""
    lm = tm.init_lm_params_serving(T_TEXT, torch.Generator().manual_seed(0), form=form,
                                   device="cpu", dtype=torch.float32)
    assert _structure(lm) == _structure(_jax_form(form)["lm"])
    eng = Engine({"lm": lm}, T_CFG, max_seq_len=512)
    for prompt in (PROMPT[:20], LONG_PROMPT):
        out = eng.generate(prompt, GenerationConfig(max_new_tokens=6, temperature=0.0,
                                                    decode_chunk=3))
        assert len(out.tokens) == 6 and all(0 <= t < TEXT.vocab_size for t in out.tokens)


def test_forms_keep_the_checks(forms):
    """What the port does not take raises; the capacity path (at most 2 x
    top-k experts) and an unfused int8 tree, ported with training, give
    the JAX package's logits."""
    jlm, tlm = forms["int8"]
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ft=256"):
        tm.lm_forward(tlm, dataclasses.replace(T_TEXT, moe_intermediate_size=2304), toks)
    with pytest.raises(ValueError, match="expert stack"):
        tm.lm_forward(tlm, dataclasses.replace(T_TEXT, num_shared_experts=1), toks)
    with pytest.raises(NotImplementedError, match="MHA"):
        tm.lm_forward(tlm, dataclasses.replace(T_TEXT, num_kv_heads=1), toks)
    few = dataclasses.replace(TEXT, num_experts=4, num_shared_experts=6)
    long_toks = np.asarray([LONG_PROMPT[:140] + LONG_PROMPT[:60]])
    want = np.asarray(jm.lm_forward(jlm, few, jnp.asarray(long_toks)).logits)
    got = tm.lm_forward(tlm, dataclasses.replace(T_TEXT, num_experts=4, num_shared_experts=6),
                        torch.as_tensor(long_toks)).logits
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    unfused_j = jquant.quantize_params(
        {"lm": jm.init_lm_params(jax.random.PRNGKey(0), TEXT, dtype=jnp.float32)})["lm"]
    unfused = from_jax(_np(unfused_j), device="cpu")
    want = np.asarray(jm.lm_forward(unfused_j, TEXT, jnp.asarray(toks.numpy())).logits)
    got = tm.lm_forward(unfused, T_TEXT, toks).logits
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
