"""The port's KV-cache pieces against the JAX package, on the CPU: the
``kv_cache_write`` and packed-int4 ``decode_attention`` plain versions
against the JAX kernels in interpret mode, the cache's int8 and int4
quantize-and-write against the JAX ``_attention`` under jit, the
``KVCache`` structure, per-lane RoPE; and two rules of the port: its own
config copy matches the JAX package's field for field, and nothing in it
imports jax or the JAX package.
"""

import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aria_tpu import config as jconfig
from aria_tpu.models import moe_lm as jm
from aria_tpu.ops.attention import sdpa as j_sdpa
from aria_tpu.ops.decode_attention import decode_attention as j_decode_attention
from aria_tpu.ops.kv_write import kv_cache_write as j_kv_cache_write
from aria_tpu.ops.rope import apply_rope as j_apply_rope
from aria_tpu.ops.rope import precompute_rope as j_precompute_rope
from aria_tpu_torch import config as tconfig
from aria_tpu_torch.checkpoint.from_jax import from_jax, to_tensor
from aria_tpu_torch.data.tokenizer import ByteTokenizer
from aria_tpu_torch.engine import guided as tguided
from aria_tpu_torch.engine.multi_lora import AdapterRegistry
from aria_tpu_torch.models import aria as taria
from aria_tpu_torch.models import moe_lm as tm
from aria_tpu_torch.models import projector as tproj
from aria_tpu_torch.models import vit as tvit
from aria_tpu_torch.ops import decode_attention as da
from aria_tpu_torch.ops import kv_write as kw
from aria_tpu_torch.ops.paged_attention import PagedKVCache
from aria_tpu_torch.ops.rope import apply_rope, precompute_rope
from aria_tpu_torch.train import lora as tlora

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = ("VisionConfig", "ProjectorConfig", "TextConfig", "AriaConfig")


def _t(a) -> torch.Tensor:
    return to_tensor(np.asarray(a), device="cpu")


# ------------------------------------------------------------ the port's rules


@pytest.mark.parametrize("name", CONFIGS)
def test_config_copy_matches_jax(name):
    jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
    jf = [(f.name, str(f.type)) for f in dataclasses.fields(jcls)]
    tf = [(f.name, str(f.type)) for f in dataclasses.fields(tcls)]
    assert tf == jf
    assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())
    props = {k for k, v in vars(jcls).items() if isinstance(v, property) or callable(v)}
    assert props <= set(vars(tcls))
    assert tcls.__dataclass_params__.frozen


def test_config_copy_builds_from_jax_configs():
    for jcfg in (jconfig.AriaConfig(), jconfig.AriaConfig.tiny(), jconfig.AriaConfig.aria_25b()):
        tcfg = tconfig.config_from_dict(dataclasses.asdict(jcfg))
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tcfg.text.q_size == jcfg.text.q_size
        assert tcfg.vision.patches_per_side == jcfg.vision.patches_per_side
        assert tcfg.projector.query_count(tcfg.vision.patches_per_side**2) == \
            jcfg.projector.query_count(jcfg.vision.patches_per_side**2)
    assert dataclasses.asdict(tconfig.AriaConfig.tiny()) == \
        dataclasses.asdict(jconfig.AriaConfig.tiny())
    assert tconfig.AriaConfig().replace(pad_token_id=5).pad_token_id == 5


def _port_sources():
    return sorted((ROOT / "aria_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    banned = ("jax", "jaxlib", "aria_tpu")
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in banned, f"{path.name}:{node.lineno} imports {name}"


ENV_READERS = {"aria_tpu_torch/ops/_build.py",  # finds nvcc through CUDA_HOME
               "aria_tpu_torch/cli/download.py"}  # the Hub token's default, $HF_TOKEN


@pytest.mark.parametrize("path", sorted((ROOT / "aria_tpu_torch").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_reads_no_environment_variable(path):
    """The JAX package's switches are module constants in the port
    (``LORA_EBLOCK``, ``DENSE_A8``, ``MOE_A8``, ``VIT_FLASH``): no module but
    the build reads the environment."""
    if str(path.relative_to(ROOT)) in ENV_READERS:
        return
    env = {"environ", "environb", "getenv", "getenvb"}
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Attribute) and node.attr in env:
            raise AssertionError(f"{path.name}:{node.lineno} reads os.{node.attr}")
        if isinstance(node, ast.ImportFrom) and node.module == "os":
            names = {a.name for a in node.names} & env
            assert not names, f"{path.name}:{node.lineno} imports {names} from os"


def test_entry_points_build_on_the_card_or_raise(monkeypatch):
    """Without a card every entry point that builds tensors raises, unless
    the caller asks for the CPU; none falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfig.AriaConfig.tiny()
    gen = torch.Generator().manual_seed(0)
    calls = [
        lambda **kw: tm.init_lm_params_serving_int4(cfg.text, gen, **kw),
        lambda **kw: tm.KVCache.init(cfg.text, 1, 128, **kw),
        lambda **kw: tm.KVCache.init(cfg.text, 1, 128, "int4", **kw),
        lambda **kw: PagedKVCache.init(cfg.text, 3, 32, torch.int8, **kw),
        lambda **kw: tvit.init_vit_params(cfg.vision, gen, **kw),
        lambda **kw: tproj.init_projector_params(cfg.projector, gen, **kw),
        lambda **kw: from_jax({"a": np.zeros(3, np.float32)}, **kw),
        lambda **kw: to_tensor(np.zeros(3, np.float32), **kw),
        lambda **kw: tm.init_lm_params(cfg.text, gen, **kw),
        lambda **kw: taria.init_aria_params(cfg, gen, **kw),
        lambda **kw: tlora.init_lora_params(cfg, tlora.LoraConfig(rank=2), gen, **kw),
        lambda **kw: AdapterRegistry({}, **kw),
        lambda **kw: tguided.regex_fsm("(yes|no)", ByteTokenizer(), [0], **kw),
        lambda **kw: tguided.json_fsm(ByteTokenizer(), [0], max_depth=1, **kw),
        lambda **kw: tguided.schema_fsm({"type": "boolean"}, ByteTokenizer(), [0], **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(device="cpu")


# ------------------------------------------------------------ KVCache


def test_cache_structure():
    """tests/test_quant.py:182-196."""
    text = tconfig.AriaConfig.tiny().text
    c = tm.KVCache.init(text, 2, 256, torch.int8, device="cpu")
    assert c.quantized and not c.packed4 and c.k.dtype == torch.int8
    assert c.k_scale.shape == c.k.shape[:-1] and c.k_scale.dtype == torch.float32
    c2 = tm.KVCache.init(text, 2, 256, torch.bfloat16, device="cpu")
    assert not c2.quantized and c2.k_scale is None and not c2.packed4
    c4 = tm.KVCache.init(text, 2, 256, "int4", device="cpu")
    H = text.num_kv_heads
    assert c4.quantized and c4.packed4 and c4.k.dtype == torch.int8
    assert c4.k.shape == (text.num_layers, 2, H // 2, 256, text.head_dim)
    assert c4.k_scale.shape == (text.num_layers, 2, H, 256)
    assert c4.k_scale.dtype == torch.bfloat16
    jc4 = jm.KVCache.init(jconfig.AriaConfig.tiny().text, 2, 256, "int4")
    for name in ("k", "v", "k_scale", "v_scale"):
        assert tuple(getattr(c4, name).shape) == getattr(jc4, name).shape
    with pytest.raises(ValueError, match="even"):
        tm.KVCache.init(dataclasses.replace(text, num_kv_heads=3), 1, 128, "int4", device="cpu")


# ------------------------------------------------------------ kv_cache_write


@pytest.mark.parametrize("dtype,dup", [("float32", False), ("bfloat16", False), ("int8", False),
                                       ("int4", False), ("bfloat16", True), ("int4", True)])
def test_kv_cache_write_matches_jax_kernel(dtype, dup):
    """tests/test_kernels.py:424-484; "int4" is the packed-byte plane
    [L, R, H/2, S, D] of an int4 cache."""
    L, B, H, S, D = 3, 4, 2, 64, 128
    Hc = H // 2 if dtype == "int4" else H
    rng = np.random.RandomState(0)

    def rand(shape):
        if dtype in ("int8", "int4"):
            return rng.randint(-128, 128, shape).astype(np.int8)
        return np.array(jnp.asarray(rng.randn(*shape).astype(np.float32), getattr(jnp, dtype)))

    kc, vc = rand((L, B, Hc, S, D)), rand((L, B, Hc, S, D))
    kn, vn = rand((B, Hc, D)), rand((B, Hc, D))
    rows = np.array([0, 2, 1, 3], np.int32)
    slots = np.array([5, 17, 5, 40], np.int32)
    if dup:  # admission padding repeats a lane verbatim: same row, slot and data
        rows[3], slots[3] = rows[1], slots[1]
        kn[3], vn[3] = kn[1], vn[1]
    tk, tv = _t(kc), _t(vc)
    jk, jv = j_kv_cache_write(jnp.asarray(kc), jnp.asarray(vc), jnp.int32(1), jnp.asarray(rows),
                              jnp.asarray(slots), jnp.asarray(kn), jnp.asarray(vn),
                              interpret=True)
    kw.kv_cache_write(tk, tv, 1, _t(rows), _t(slots), _t(kn), _t(vn))
    for got, want in ((tk, jk), (tv, jv)):
        assert torch.equal(got, _t(want))  # byte for byte


def test_kv_cache_write_scales_and_dropped_lanes():
    """Scales go to (layer, row, :, slot) with the k/v; a lane whose row or
    slot lies outside the cache writes nothing (the JAX scatter drops it)."""
    L, R, Hc, S, D = 2, 3, 2, 32, 128
    rng = np.random.RandomState(1)
    kc, vc = (rng.randint(-128, 128, (L, R, Hc, S, D)).astype(np.int8) for _ in range(2))
    ksc, vsc = (rng.rand(L, R, 2 * Hc, S).astype(np.float32) for _ in range(2))
    kn, vn = (rng.randint(-128, 128, (4, Hc, D)).astype(np.int8) for _ in range(2))
    ksn, vsn = (rng.rand(4, 2 * Hc).astype(np.float32) for _ in range(2))
    rows = np.array([2, 0, 1, 5], np.int32)
    slots = np.array([31, 0, 32, 3], np.int32)  # lane 2's slot and lane 3's row are out
    want = [a.copy() for a in (kc, vc, ksc, vsc)]
    for b in (0, 1):
        want[0][1, rows[b], :, slots[b]] = kn[b]
        want[1][1, rows[b], :, slots[b]] = vn[b]
        want[2][1, rows[b], :, slots[b]] = ksn[b]
        want[3][1, rows[b], :, slots[b]] = vsn[b]
    got = [_t(a) for a in (kc, vc, ksc, vsc)]
    kw.kv_cache_write(got[0], got[1], 1, _t(rows), _t(slots), _t(kn), _t(vn), got[2], got[3],
                      _t(ksn), _t(vsn))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


# ------------------------------------------------------------ int4 decode attention


def _pack(qv):  # [L, B, H, S, D] int4 values -> [L, B, H/2, S, D] bytes (test_kernels.py:321)
    Hh = qv.shape[2] // 2
    return ((qv[:, :, :Hh] + 8) & 0xF) | (qv[:, :, Hh:] << 4)


def test_unpack_heads_inverts_the_jax_packing():
    vals = np.stack(np.meshgrid(np.arange(-8, 8), np.arange(-8, 8)), 0).astype(np.int8)
    qv = vals.reshape(1, 1, 2, 256, 1)  # every (lo, hi) pair
    packed = _pack(qv)
    assert packed.dtype == np.int8 and len(np.unique(packed)) == 256
    np.testing.assert_array_equal(da.unpack_heads(torch.from_numpy(packed)).numpy(), qv)


@pytest.fixture(scope="module")
def int4_case():
    rng = np.random.RandomState(4)
    L, B, H, S, D = 2, 3, 4, 384, 128
    k = rng.randn(L, B, H, S, D).astype(np.float32)
    v = rng.randn(L, B, H, S, D).astype(np.float32)
    ks = np.asarray(jnp.asarray(np.maximum(np.abs(k).max(-1), 1e-6) / 7.0, jnp.bfloat16))
    vs = np.asarray(jnp.asarray(np.maximum(np.abs(v).max(-1), 1e-6) / 7.0, jnp.bfloat16))
    k4 = np.clip(np.round(k / ks.astype(np.float32)[..., None]), -8, 7).astype(np.int8)
    v4 = np.clip(np.round(v / vs.astype(np.float32)[..., None]), -8, 7).astype(np.int8)
    q = rng.randn(B, H, D).astype(np.float32)
    lengths = np.array([384, 1, 200], np.int32)  # one full, one of 1, one ragged
    return q, _pack(k4), _pack(v4), k4, v4, ks, vs, lengths


def test_int4_decode_attention_matches_jax(int4_case):
    q, kp, vp, _, _, ks, vs, lengths = int4_case
    ref = j_decode_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.int32(1),
                             jnp.asarray(lengths), jnp.asarray(ks), jnp.asarray(vs),
                             interpret=True, block_s=128)
    got = da.decode_attention(*map(_t, (q, kp, vp)), 1, _t(lengths), _t(ks), _t(vs))
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    # bf16 output; the JAX kernel sums 128-position blocks online and its
    # matrix-unit unpack in f32, the plain version one softmax over exact
    # nibbles, so a bf16 rounding of p*v_scale or the output lands one ulp
    # apart
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=1e-2, atol=1e-2)


def test_int4_decode_attention_is_attention_over_the_dequantized_cache(int4_case):
    """tests/test_kernels.py:311-340: sdpa over the dequantized values."""
    q, kp, vp, k4, v4, ks, vs, lengths = int4_case
    got = da.decode_attention_plain(*map(_t, (q, kp, vp)), 1, _t(lengths), _t(ks), _t(vs))
    kd = (k4[1].astype(np.float32) * ks[1].astype(np.float32)[..., None]).transpose(0, 2, 1, 3)
    vd = (v4[1].astype(np.float32) * vs[1].astype(np.float32)[..., None]).transpose(0, 2, 1, 3)
    S = kp.shape[3]
    mask = (jnp.arange(S)[None, :] < lengths[:, None])[:, None, None, :]
    ref = j_sdpa(jnp.asarray(q)[:, None], jnp.asarray(kd), jnp.asarray(vd), mask)[:, 0]
    # q and p*v_scale round to bf16 in the kernel's numerics, not in sdpa
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref), rtol=4e-2, atol=2e-2)


# ------------------------------------------------------------ the cache write in lm_forward


TEXT = jconfig.TextConfig(vocab_size=64, hidden_size=3 * 4 * 128, num_layers=2, num_heads=4,
                          num_kv_heads=4, head_dim=128, num_experts=4, moe_topk=2,
                          moe_intermediate_size=128, num_shared_experts=0)
WRITES = {"prefill": (0, 8), "lanes, one token": ([7, 19], 1), "lanes, 3 tokens": ([4, 40], 3)}


@pytest.mark.parametrize("cache_dtype", ["int8", "int4"])
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("write", list(WRITES))
def test_kv_quantize_and_write_match_jax(cache_dtype, xdtype, write):
    """The JAX ``_attention`` under jit with an identity wqkv, cos 1 and sin
    0, so its k and v are the input's thirds exactly; the port's
    ``_write_cache`` of the same k and v must give the same bytes and
    scales (moe_lm.py:435-532)."""
    pos, S = WRITES[write]
    B, H, D = 2, TEXT.num_kv_heads, TEXT.head_dim
    q_size = TEXT.q_size
    rng = np.random.RandomState(5)
    x = (rng.randn(B, S, 3 * q_size) * rng.uniform(0.05, 4, (B, S, 3 * q_size))).astype(np.float32)
    x = np.asarray(jnp.asarray(x, getattr(jnp, xdtype)).astype(jnp.float32))
    jdt = jnp.int8 if cache_dtype == "int8" else "int4"
    layer = {"wqkv": jnp.eye(3 * q_size, dtype=jnp.float32),
             "wo": jnp.zeros((q_size, TEXT.hidden_size), jnp.float32)}
    per_lane = isinstance(pos, list)
    jpos = jnp.asarray(pos, jnp.int32)

    @jax.jit
    def run(x, cache):
        cos = jnp.ones((B, S, D // 2) if per_lane else (S, D // 2), jnp.float32)
        _, new = jm._attention(layer, TEXT, x, cos, jnp.zeros_like(cos), None, cache, jpos,
                               layer_idx=jnp.int32(1), use_flash=not per_lane or S > 1)
        return new

    jc = run(jnp.asarray(x, getattr(jnp, xdtype)), jm.KVCache.init(TEXT, B, 128, jdt))
    tc = tm.KVCache.init(tconfig.config_from_dict({"text": dataclasses.asdict(TEXT)}).text, B, 128,
                         torch.int8 if cache_dtype == "int8" else "int4", device="cpu")
    xt = _t(x).to(getattr(torch, xdtype))
    k = xt[..., q_size:2 * q_size].reshape(B, S, H, D)
    v = xt[..., 2 * q_size:].reshape(B, S, H, D)
    tpos = torch.tensor(pos, dtype=torch.int32) if per_lane else pos
    rows = torch.arange(B, dtype=torch.int32) if per_lane and S == 1 else None
    tm._write_cache(tc, 1, tpos, k, v, rows)
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(tc, name), _t(getattr(jc, name))), name


# ------------------------------------------------------------ per-lane RoPE and logits


def test_rope_with_per_lane_positions_matches_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(3, 2, 4, 128).astype(np.float32)
    pos = np.array([[0, 1], [17, 18], [300, 301]], np.int32)
    jc, js = j_precompute_rope(jnp.asarray(pos), 128, 5e6)
    want = np.asarray(j_apply_rope(jnp.asarray(x), jc, js))
    tc, ts = precompute_rope(torch.from_numpy(pos), 128, 5e6)
    np.testing.assert_allclose(apply_rope(torch.from_numpy(x), tc, ts).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    # each lane's rows equal the [S]-positions form at that lane's positions
    for b in range(3):
        c1, s1 = precompute_rope(torch.from_numpy(pos[b]), 128, 5e6)
        torch.testing.assert_close(apply_rope(torch.from_numpy(x[b:b + 1]), c1, s1)[0],
                                   apply_rope(torch.from_numpy(x), tc, ts)[b])


def test_per_row_logit_position_selects_each_rows_logits():
    text = tconfig.TextConfig(vocab_size=128, hidden_size=256, num_layers=1, num_heads=2,
                              num_kv_heads=2, head_dim=128, num_experts=4, moe_topk=2,
                              moe_intermediate_size=128, num_shared_experts=2)
    lm = tm.init_lm_params_serving_int4(text, torch.Generator().manual_seed(0), device="cpu",
                                        dtype=torch.float32)
    toks = torch.from_numpy(np.random.RandomState(7).randint(0, 128, (3, 12)))
    with torch.inference_mode():
        full = tm.lm_forward(lm, text, toks).logits
        rows = tm.lm_forward(lm, text, toks, logit_position=torch.tensor([11, 0, 5])).logits
    assert rows.shape == (3, 1, 128)
    for b, p in enumerate((11, 0, 5)):
        torch.testing.assert_close(rows[b, 0], full[b, p], rtol=1e-5, atol=1e-5)
