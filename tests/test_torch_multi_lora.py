"""Multi-LoRA serving in the port against the JAX package, on the CPU.

The small int4 serving config of tests/test_torch_server.py (hidden 256, 2
heads x 128, 2 layers, 8 + 2 fused experts, f32), the JAX side with
``ARIA_TPU_KERNELS=interpret`` as tests/test_multi_lora.py:424-460 runs
it. Adapters are drawn with numpy from a seed in the training format
(``train/lora.py``: unfused shared targets, per-expert w1/w2), with nonzero
b factors, and the same leaves go to both packages. Covered: the registry
(stacking, the shared-expert fusion, ``registry_for_params``, the
selector, ``resolve``), the multi-adapter ``_lora_delta`` and
``experts_grouped``, ``expert_block_dequant``'s plain version against the
JAX ``_pin_default_layout`` and dequantize, ``_experts_lora_blocked``,
``lm_forward`` with a mixed selector, both engines' mixed-batch greedy
streams, a base-only engine with adapters, the paged prefix keys salted by
adapter, and the QLoRA guard.
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
from aria_tpu.engine import multi_lora as jml
from aria_tpu.engine.server import BatchedEngine as JBatchedEngine
from aria_tpu.engine.server import PagedBatchedEngine as JPagedBatchedEngine
from aria_tpu.models import moe_lm as jm
from aria_tpu.ops import backend as jbackend
from aria_tpu.ops import moe as jmoe
from aria_tpu.ops import quant as jquant
from aria_tpu_torch.checkpoint.from_jax import from_jax
from aria_tpu_torch.config import config_from_dict
from aria_tpu_torch.engine import multi_lora as tml
from aria_tpu_torch.engine.server import BatchedEngine, PagedBatchedEngine
from aria_tpu_torch.models import moe_lm as tm
from aria_tpu_torch.ops import moe as tmoe
from aria_tpu_torch.ops.expert_dequant import expert_block_dequant

torch.set_num_threads(1)

JTEXT = JTextConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2,
                    num_kv_heads=2, head_dim=128, num_experts=8, moe_topk=2,
                    moe_intermediate_size=128, num_shared_experts=2, max_seq_len=512)
JCFG = JAriaConfig.tiny().replace(text=JTEXT)
CFG = config_from_dict(dataclasses.asdict(JCFG))
SEED = 1
TARGETS = ("wqkv", "wo", "w1", "w2", "shared_w1", "shared_w2")


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


@pytest.fixture
def eblock(monkeypatch):
    """Experts per block of the blocked expert-LoRA path, for one test: the
    JAX package reads ``ARIA_TPU_LORA_EBLOCK``, the port ``LORA_EBLOCK``."""
    def set_block(n: int):
        monkeypatch.setenv("ARIA_TPU_LORA_EBLOCK", str(n))
        monkeypatch.setattr(tm, "LORA_EBLOCK", n)
    return set_block


@pytest.fixture(scope="module")
def params(interpret):
    lm = jm.init_lm_params_serving_int4(jax.random.PRNGKey(SEED), JTEXT, dtype=jnp.float32)
    lm["embed"] = jquant.dequantize_weight(lm["embed"], dtype=jnp.float32)
    return {"lm": lm}, {"lm": from_jax(jax.tree.map(np.asarray, lm), device="cpu")}


def make_adapter(seed: int, rank: int, targets=TARGETS, tc=JTEXT) -> dict:
    """A training-format adapter {"layers": {name: {"a", "b"}}} of numpy
    f32 leaves, a and b both nonzero."""
    L, D, E = tc.num_layers, tc.hidden_size, tc.num_experts
    I, Is, r = tc.moe_intermediate_size, tc.shared_intermediate_size, rank
    qkv = (tc.num_heads + 2 * tc.num_kv_heads) * tc.head_dim
    shapes = {"wqkv": ((L, D, r), (L, r, qkv)), "wo": ((L, tc.q_size, r), (L, r, D)),
              "w1": ((L, E, D, r), (L, E, r, 2 * I)), "w2": ((L, E, I, r), (L, E, r, D)),
              "shared_w1": ((L, D, r), (L, r, 2 * Is)), "shared_w2": ((L, Is, r), (L, r, D))}
    rng = np.random.RandomState(seed)
    out = {}
    for name in targets:
        a_shape, b_shape = shapes[name]
        out[name] = {"a": (rng.randn(*a_shape) * a_shape[-2] ** -0.5).astype(np.float32),
                     "b": (rng.randn(*b_shape) * 0.05).astype(np.float32)}
    return {"layers": out}


ADAPTERS = {"t1": (make_adapter(11, 8), 2.0), "t2": (make_adapter(12, 4), 4.0),
            "att": (make_adapter(13, 8, ("wqkv", "wo")), 2.0)}


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def registries(names=("t1", "t2", "att")):
    """The same adapters as a JAX and a port AdapterRegistry."""
    jreg = jml.AdapterRegistry({n: _tree(ADAPTERS[n][0], jnp.asarray) for n in names},
                               scales={n: ADAPTERS[n][1] for n in names})
    treg = tml.AdapterRegistry({n: _tree(ADAPTERS[n][0], torch.from_numpy) for n in names},
                               scales={n: ADAPTERS[n][1] for n in names}, device="cpu")
    return jreg, treg


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _assert_trees_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k])
        else:
            assert tuple(got[k].shape) == tuple(want[k].shape), k
            np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)


# ------------------------------------------------------------ the registry


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stack_adapters_matches_jax(dtype):
    """Ranks 8 and 4 padded to 8, an attention-only adapter zero elsewhere,
    scales folded into b, the caller's dtype kept: leaf for leaf, exact."""
    names = ("t1", "t2", "att")
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    scales = [ADAPTERS[n][1] for n in names]
    want = jml.stack_adapters([_tree(ADAPTERS[n][0], lambda v: jnp.asarray(v, jdt))
                               for n in names], scales)
    got = tml.stack_adapters([_tree(ADAPTERS[n][0], lambda v: torch.from_numpy(v).to(tdt))
                              for n in names], scales)
    _assert_trees_equal(got, want)
    assert all(leaf.dtype == tdt for ab in got["layers"].values() for leaf in ab.values())
    assert not got["layers"]["w1"]["a"][:, 0].any()  # adapter 0 is the base


@pytest.mark.parametrize("targets", [TARGETS, ("shared_w1", "shared_w2"), ("w1", "w2"),
                                     ("shared_w1", "w2")], ids="+".join)
@pytest.mark.parametrize("stacked", [True, False])
def test_fuse_shared_adapters_matches_jax(targets, stacked):
    """The shared MLP's factors split over the virtual experts, as the JAX
    function does, on stacked [L, A, ...] and single [L, ...] trees."""
    adapters = [make_adapter(21, 8, targets), make_adapter(22, 4, targets)]
    if stacked:
        layers = jml.stack_adapters([_tree(a, jnp.asarray) for a in adapters],
                                    [2.0, 4.0])["layers"]
    else:
        layers = _tree(adapters[0], jnp.asarray)["layers"]
    E, ns, I = JTEXT.num_experts, JTEXT.num_shared_experts, JTEXT.moe_intermediate_size
    want = jml.fuse_shared_adapters(dict(layers), E, ns, I)
    got = tml.fuse_shared_adapters(_tree(layers, lambda v: torch.from_numpy(np.array(v))),
                                   E, ns, I)
    _assert_trees_equal(got, want)
    assert got["w1"]["a"].shape[-3] == E + ns


def test_registry_for_params_matches_jax(params):
    jparams, tparams = params
    jreg, treg = registries()
    want = jml.registry_for_params(jreg, jparams["lm"]["layers"], JTEXT)
    got = tml.registry_for_params(treg, tparams["lm"]["layers"], CFG.text)
    assert got is not treg and got.index == treg.index
    _assert_trees_equal(got.stacked, want.stacked)
    # a base with unfused shared experts takes the registry as it is
    unfused = {"w1": torch.zeros((2, JTEXT.num_experts, 4, 4))}
    assert tml.registry_for_params(treg, unfused, CFG.text) is treg


def test_lane_onehot_and_resolve():
    jreg, treg = registries()
    ids = [1, 0, 3, 2, 0]
    np.testing.assert_array_equal(treg.lane_onehot(ids).numpy(), np.asarray(jreg.lane_onehot(ids)))
    assert treg.num_adapters == 4
    for name in (None, "", "base", "aria-tpu", "t1", "t2", "att"):
        assert treg.resolve(name) == jreg.resolve(name)
    with pytest.raises(KeyError, match="unknown adapter"):
        treg.resolve("nope")


# ------------------------------------------------------------ deltas and experts


@pytest.mark.parametrize("layout", ["rows", "tokens"])
def test_lora_delta_multi_matches_jax(layout):
    """Every adapter's delta, one selected per row: [A, B] over [B, S, d],
    or [A, T] over flat tokens [T, d]."""
    jreg, treg = registries()
    rng = np.random.RandomState(3)
    ab = treg.stacked["layers"]["wqkv"]
    if layout == "rows":
        x, ids = rng.randn(3, 5, 256).astype(np.float32), [1, 0, 2]
    else:
        x, ids = rng.randn(7, 256).astype(np.float32), [1, 0, 2, 3, 3, 0, 1]
    hot = jreg.lane_onehot(ids)
    jab = {f: v[1] for f, v in jreg.stacked["layers"]["wqkv"].items()}
    want = jm._lora_delta(jnp.asarray(x), jab, 0.5, hot)
    got = tm._lora_delta(torch.from_numpy(x), ab, 1, 0.5, treg.lane_onehot(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _expert_case(E, T, k=2, D=256, I=128, A=3, r=4, seed=4):
    rng = np.random.RandomState(seed)
    x = (rng.randn(T, D) * 0.3).astype(np.float32)
    idx = np.stack([rng.choice(E, k, replace=False) for _ in range(T)]).astype(np.int32)
    wts = rng.rand(T, k).astype(np.float32)
    lw1 = {"a": (rng.randn(A, E, D, r) * 0.1).astype(np.float32),
           "b": (rng.randn(A, E, r, 2 * I) * 0.1).astype(np.float32)}
    lw2 = {"a": (rng.randn(A, E, I, r) * 0.1).astype(np.float32),
           "b": (rng.randn(A, E, r, D) * 0.1).astype(np.float32)}
    hot = np.zeros((A, T), np.float32)
    hot[rng.randint(0, A, T), np.arange(T)] = 1.0
    return x, idx, wts, lw1, lw2, hot


def test_experts_grouped_multi_matches_jax():
    """The selector scattered into the expert buffers with the tokens."""
    E, T = 6, 10
    x, idx, wts, lw1, lw2, hot = _expert_case(E, T)
    rng = np.random.RandomState(5)
    w1 = (rng.randn(E, 256, 256) * 0.05).astype(np.float32)
    w2 = (rng.randn(E, 128, 256) * 0.05).astype(np.float32)
    j, t = (lambda v: jnp.asarray(v)), torch.from_numpy
    want = jmoe.experts_grouped(j(x), j(idx), j(wts), j(w1), j(w2), lora_w1=_tree(lw1, j),
                                lora_w2=_tree(lw2, j), lora_scale=0.5, lora_onehot=j(hot))
    got = tmoe.experts_grouped(t(x), t(idx), t(wts), t(w1), t(w2), lora_w1=_tree(lw1, t),
                               lora_w2=_tree(lw2, t), lora_scale=0.5, lora_onehot=t(hot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_experts_grouped_sends_out_of_block_slots_to_the_trash_row():
    """Id E marks a slot outside the block (weight 0): it takes no buffer
    row, so the result is that of the other slots alone; a whole block of
    such slots gives zeros."""
    E, T = 4, 6
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(T, 256).astype(np.float32))
    w1 = torch.from_numpy((rng.randn(E, 256, 256) * 0.05).astype(np.float32))
    w2 = torch.from_numpy((rng.randn(E, 128, 256) * 0.05).astype(np.float32))
    idx = torch.tensor([[0, 4], [4, 2], [1, 3], [4, 4], [2, 0], [3, 4]], dtype=torch.int32)
    wts = torch.where(idx < E, torch.rand(T, 2, generator=torch.Generator().manual_seed(0)), 0.0)
    got = tmoe.experts_grouped(x, idx, wts, w1, w2)
    ref = tmoe.experts_grouped(x, idx.clamp(max=E - 1), wts, w1, w2)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    trash = tmoe.experts_grouped(x, torch.full_like(idx, E), torch.zeros_like(wts), w1, w2)
    assert not trash.any()


# ------------------------------------------------------------ the block dequantize


def _quantized_stack(form, E=6, D=512, I=128, seed=7):
    rng = np.random.RandomState(seed)
    w1 = jnp.asarray((rng.randn(E, 2 * I, D) * 0.05).astype(np.float32))
    w2 = jnp.asarray((rng.randn(E, I, D) * 0.05).astype(np.float32))
    if form == "int4":
        return jquant.quantize_expert_int4(w1, w2)
    return (jquant.quantize_weight(w1, input_axis=-1),
            jquant.quantize_weight(w2, input_axis=-2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["int4", "int8"])
def test_expert_block_dequant_plain_matches_jax(interpret, form, dtype):
    """The block [2, 4) of a 6-expert stack (D 512: two nibble groups): the
    JAX ``_pin_default_layout`` copy of each leaf, then
    ``dequantize_expert_weights``, against the port's plain version, bit
    for bit."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    w1q, w2q = _quantized_stack(form)
    blk = [{k: jm._pin_default_layout(v[2:4]) for k, v in w.items()} for w in (w1q, w2q)]
    want = jquant.dequantize_expert_weights(*blk, dtype=jdt)
    for w, kind, ref in zip((w1q, w2q), ("w1", "w2"), want):
        got = expert_block_dequant(from_jax(jax.tree.map(np.asarray, w), device="cpu"),
                                   kind, 2, 2, tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))


def _blocked_inputs(E, multi, seed=8):
    """20 or 10 experts, 10 tokens routed away from experts 4 and 5."""
    rng = np.random.RandomState(seed)
    T, k, D, I, r = 10, 2, 256, 128, 4
    w1q, w2q = _quantized_stack("int4", E=E, D=D, I=I, seed=seed)
    x = (rng.randn(T, D) * 0.3).astype(np.float32)
    pool = [e for e in range(E) if e not in (4, 5)]  # the block [4, 6) gets no token
    idx = np.stack([rng.choice(pool, k, replace=False) for _ in range(T)]).astype(np.int32)
    wts = rng.rand(T, k).astype(np.float32)
    lead = (3, E) if multi else (E,)
    lora = {"w1": {"a": (rng.randn(*lead, D, r) * 0.1).astype(np.float32),
                   "b": (rng.randn(*lead, r, 2 * I) * 0.1).astype(np.float32)},
            "w2": {"a": (rng.randn(*lead, I, r) * 0.1).astype(np.float32),
                   "b": (rng.randn(*lead, r, D) * 0.1).astype(np.float32)}}
    hot = None
    if multi:
        hot = np.zeros((3, T), np.float32)
        hot[rng.randint(0, 3, T), np.arange(T)] = 1.0
    return x, idx, wts, w1q, w2q, lora, hot


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("block,blocks", [(2, 10), (3, 2), (0, 1)])
def test_experts_lora_blocked_matches_jax(interpret, eblock, multi, block, blocks):
    """Blocks of 2 (10 blocks, one of which no token routes to), a block
    size that does not divide 20 (the fallback: 10, in 2 blocks), and E =
    10 in one block, against the JAX function with its Pallas copy
    interpreted; single and stacked adapters."""
    eblock(block)
    E = 10 if blocks == 1 else 20
    x, idx, wts, w1q, w2q, lora, hot = _blocked_inputs(E, multi)
    assert tm.lora_block_size(E) * blocks == E
    j, t = jnp.asarray, torch.from_numpy
    want = jm._experts_lora_blocked(j(x), j(idx), j(wts), w1q, w2q, _tree(lora, j), 0.5,
                                    None if hot is None else j(hot), jnp.float32,
                                    pin_layout=True)
    tw1, tw2 = (from_jax(jax.tree.map(np.asarray, w), device="cpu") for w in (w1q, w2q))
    got = tm._experts_lora_blocked(t(x), t(idx), t(wts), tw1, tw2, _tree(lora, t), 0.5,
                                   None if hot is None else t(hot), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5, atol=3e-5)


# ------------------------------------------------------------ the model


@pytest.mark.parametrize("chunk", [0, 16], ids=["whole", "moe-chunks"])
def test_lm_forward_mixed_selector_matches_jax(params, eblock, monkeypatch, chunk):
    """Rows on t1, the base and t2 in one forward over the int4 base, the
    experts in two blocks of 5; the MoE also in 16-token slices, each with
    its slice of the selector (the JAX package's slice from its
    ``ARIA_TPU_MOE_CHUNK``, the port's from its module constant)."""
    eblock(5)
    if chunk:
        monkeypatch.setenv("ARIA_TPU_MOE_CHUNK", str(chunk))
        monkeypatch.setattr(tm, "MOE_CHUNK", chunk)
    jparams, tparams = params
    jreg, treg = registries()
    jreg = jml.registry_for_params(jreg, jparams["lm"]["layers"], JTEXT)
    treg = tml.registry_for_params(treg, tparams["lm"]["layers"], CFG.text)
    tokens = np.random.RandomState(0).randint(1, 400, size=(3, 16)).astype(np.int32)
    ids = [1, 0, 2]
    want = jm.lm_forward(jparams["lm"], JTEXT, jnp.asarray(tokens), lora=jreg.stacked,
                         lora_scale=1.0, lora_onehot=jreg.lane_onehot(ids)).logits
    got = tm.lm_forward(tparams["lm"], CFG.text, torch.from_numpy(tokens).long(),
                        lora=treg.stacked, lora_scale=1.0,
                        lora_onehot=treg.lane_onehot(ids)).logits
    want = np.asarray(want)
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel <= 1e-5, rel
    base = tm.lm_forward(tparams["lm"], CFG.text, torch.from_numpy(tokens).long()).logits
    assert not np.allclose(got[0].numpy(), base[0].numpy(), atol=1e-3)  # t1 moves row 0


def test_training_over_quantized_experts_raises(params):
    _, tparams = params
    _, treg = registries(("t1",))
    with pytest.raises(NotImplementedError, match="QLoRA"):
        tm.lm_forward(tparams["lm"], CFG.text, torch.ones((1, 4), dtype=torch.long),
                      training=True, lora=treg.stacked, lora_scale=1.0,
                      lora_onehot=treg.lane_onehot([1]))


# ------------------------------------------------------------ the engines

PROMPTS = {"t1": [5, 17, 3, 88], None: [9, 9, 200], "t2": [100, 2, 7, 31, 4], "att": [64, 1]}
N_NEW = 8


def _serve(engine, requests, n_new=N_NEW):
    uids = [engine.submit(p, max_new_tokens=n_new, adapter=a) for a, p in requests]
    fin = {r.uid: r for r in engine.run_until_complete()}
    assert not any(r.error for r in fin.values())
    return [fin[u].generated for u in uids], [fin[u].cached_tokens for u in uids]


@pytest.mark.parametrize("engine", ["batched", "paged"])
def test_engine_mixed_streams_match_jax(params, eblock, engine):
    """Four requests on three lanes (t1, the base, t2, then the
    attention-only adapter as a lane frees), greedy, f32 cache: token for
    token the JAX engine's, and the adapters move the streams."""
    eblock(5)
    jparams, tparams = params
    jreg, treg = registries()
    kw = dict(max_lanes=3, max_seq_len=128, decode_chunk=3)
    if engine == "batched":
        jeng = JBatchedEngine(jparams, JCFG, cache_dtype=jnp.float32, adapters=jreg, **kw)
        teng = BatchedEngine(tparams, CFG, cache_dtype=torch.float32, adapters=treg, **kw)
    else:
        kw.update(page_size=32, prefill_chunk=32)
        jeng = JPagedBatchedEngine(jparams, JCFG, cache_dtype=jnp.float32, adapters=jreg, **kw)
        teng = PagedBatchedEngine(tparams, CFG, cache_dtype=torch.float32, adapters=treg, **kw)
    requests = list(PROMPTS.items())
    want, got = _serve(jeng, requests)[0], _serve(teng, requests)[0]
    assert got == want
    plain = BatchedEngine(tparams, CFG, cache_dtype=torch.float32, **kw
                          ) if engine == "batched" else PagedBatchedEngine(
        tparams, CFG, cache_dtype=torch.float32, **kw)
    base = _serve(plain, [(None, p) for _, p in requests])[0]
    assert got[1] == base[1] and got[0] != base[0] and got[2] != base[2]


@pytest.mark.parametrize("engine", ["batched", "paged"])
def test_base_only_engine_with_adapters_equals_plain(params, engine):
    """No request names an adapter: every prefill and decode step takes the
    plain call (the int4 kernels' plain versions), so the streams are those
    of an engine built without adapters, bit for bit."""
    _, tparams = params
    _, treg = registries()
    cls = BatchedEngine if engine == "batched" else PagedBatchedEngine
    kw = dict(max_lanes=3, max_seq_len=128, decode_chunk=3, cache_dtype=torch.int8)
    requests = [(None, p) for p in PROMPTS.values()]
    got = _serve(cls(tparams, CFG, adapters=treg, **kw), requests)[0]
    assert got == _serve(cls(tparams, CFG, **kw), requests)[0]


def test_paged_prefix_keys_are_salted_by_adapter(params, eblock):
    """A 70-token prompt (two full 32-token pages) under t1, then under the
    base, then under t1 again, one at a time: the base shares no page of
    t1's, the second t1 request takes both full pages, and every stream is
    the JAX engine's."""
    eblock(5)
    jparams, tparams = params
    jreg, treg = registries(("t1",))
    kw = dict(max_lanes=2, max_seq_len=256, page_size=32, prefill_chunk=32, decode_chunk=3)
    jeng = JPagedBatchedEngine(jparams, JCFG, cache_dtype=jnp.float32, adapters=jreg, **kw)
    teng = PagedBatchedEngine(tparams, CFG, cache_dtype=torch.float32, adapters=treg, **kw)
    prompt = [7 + (i % 90) for i in range(70)]
    for eng in (jeng, teng):
        runs = [_serve(eng, [(a, prompt)], n_new=5) for a in ("t1", None, "t1")]
        streams = [r[0][0] for r in runs]
        assert [r[1][0] for r in runs] == [0, 0, 64]
        assert streams[2] == streams[0] != streams[1]
        if eng is jeng:
            want = streams
    assert streams == want
