"""Context-parallel serving of the port against the JAX package, on the CPU.

The JAX side runs on the 8-device virtual CPU mesh of tests/conftest.py,
its Pallas kernels in interpret mode, as tests/test_cp_cache.py runs it.
The port's ranks are processes that ``run_ranks`` spawns and joins over
gloo (tests/torch_cp_ranks.py, which imports no JAX); each holds its block
of the cache and runs the plain versions of the kernels. The references
are computed once per module and each mesh's ranks are spawned once.

- ``decode_attention_plain(return_stats=True)`` against the JAX kernel's
  stats form at lengths 0, 1, a partial block and a full one, for bf16,
  int8 and packed-int4 caches; and the two merge tests of
  tests/test_kernels.py:242-290 on the port's stats.
- ``mesh_decode_attention`` and ``cp_cached_prefill_attention`` against the
  JAX functions under context=2, context=2 x model=2 and context=4, for
  f32, int8 and int4 caches.
- ``Engine(mesh=)`` against the JAX ``Engine(mesh=)``: the four cases of
  tests/test_cp_cache.py:44-106 and the int4 serving form with an int8
  cache; ``BatchedEngine(mesh=model 2)`` against the JAX one; the stats
  kernel's calls (layers x decode steps on each rank, none of the normal
  form); and the axes that are not ported.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aria_tpu.engine.generate import Engine as JEngine
from aria_tpu.engine.generate import GenerationConfig as JGen
from aria_tpu.engine.server import BatchedEngine as JBatchedEngine
from aria_tpu.models import moe_lm as jm
from aria_tpu.models.aria import init_aria_params
from aria_tpu.ops.decode_attention import decode_attention as j_decode_attention
from aria_tpu.ops.quant import dequantize_weight
from aria_tpu.parallel import cp_cache as jcp
from aria_tpu.parallel.mesh import MeshConfig as JMeshConfig
from aria_tpu.parallel.mesh import make_mesh as j_make_mesh
from aria_tpu_torch.checkpoint.from_jax import from_jax
from aria_tpu_torch.config import config_from_dict
from aria_tpu_torch.ops import decode_attention as da
from aria_tpu_torch.parallel import mesh as tmesh
from aria_tpu_torch.parallel.distributed import run_ranks
from tests import torch_cp_ranks as ranks
from tests.test_mesh_kernels import kernel_cfg, kernels
from tests.test_torch_server import JCFG as SERVING_JCFG
from tests.test_torch_server import JTEXT as SERVING_JTEXT

torch.set_num_threads(1)

NEG_INF = -1e30
# stats against the JAX kernel. m and s are f32 (the scores' sums and the
# f32 probabilities' sum, in another order): 1e-5. acc sums p (times
# v_scale) rounded to bf16, and the JAX kernel rounds p against each 128-
# block's running max where the port rounds it against the lane's max:
# one bf16 rounding apart, 2^-8 of max |acc|.
STATS_RTOL = 1e-5
STATS_ACC_RTOL = 2.0**-8
MESH_RTOL = {"f32": 1e-5, "int8": 1e-5, "int4": 2e-4}  # of max |ref|


def _rel(got, ref) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float64) - ref)) / np.max(np.abs(ref)))


def _bf16(a: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16, kept as f32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _caches(rng, L, B, H, S, D) -> dict:
    """Global caches {name: {k, v, k_scale, v_scale}} as numpy: f32, int8
    (amax / 127 scales) and packed int4 (random bytes, bf16 scales)."""
    kf = rng.randn(L, B, H, S, D).astype(np.float32)
    vf = rng.randn(L, B, H, S, D).astype(np.float32)
    ks = np.abs(kf).max(-1) / 127.0
    vs = np.abs(vf).max(-1) / 127.0
    return {
        "f32": {"k": kf, "v": vf},
        "int8": {"k": np.round(kf / ks[..., None]).astype(np.int8),
                 "v": np.round(vf / vs[..., None]).astype(np.int8),
                 "k_scale": ks.astype(np.float32), "v_scale": vs.astype(np.float32)},
        "int4": {"k": rng.randint(-128, 128, (L, B, H // 2, S, D)).astype(np.int8),
                 "v": rng.randint(-128, 128, (L, B, H // 2, S, D)).astype(np.int8),
                 "k_scale": _bf16(rng.uniform(0.01, 0.1, (L, B, H, S)).astype(np.float32)),
                 "v_scale": _bf16(rng.uniform(0.01, 0.1, (L, B, H, S)).astype(np.float32))},
    }


def _jcache(arrays: dict) -> jm.KVCache:
    if "k_scale" not in arrays:
        return jm.KVCache(jnp.asarray(arrays["k"]), jnp.asarray(arrays["v"]))
    sdt = jnp.bfloat16 if arrays["k_scale"].shape[2] == 2 * arrays["k"].shape[2] else jnp.float32
    return jm.KVCache(jnp.asarray(arrays["k"]), jnp.asarray(arrays["v"]),
                      jnp.asarray(arrays["k_scale"], sdt), jnp.asarray(arrays["v_scale"], sdt))


# ------------------------------------------------------------ the stats form

STATS_LENGTHS = [0, 1, 200, 256]  # empty, one position, a partial 128-block, full


def _stats_inputs(cache: str):
    rng = np.random.RandomState(11)
    L, B, H, S, D = 2, 4, 4, 256, 128
    arrays = _caches(rng, L, B, H, S, D)["f32" if cache == "bf16" else cache]
    q = rng.randn(B, H, D).astype(np.float32)
    if cache == "bf16":  # bf16 query and cache
        q, arrays = _bf16(q), {n: _bf16(a) for n, a in arrays.items()}
    return q, arrays, np.asarray(STATS_LENGTHS, np.int32)


@pytest.mark.parametrize("cache", ["bf16", "int8", "int4"])
def test_stats_plain_matches_jax_kernel(cache):
    q, arrays, lengths = _stats_inputs(cache)
    jc = _jcache(arrays)
    jq = jnp.asarray(q, jnp.bfloat16 if cache == "bf16" else jnp.float32)
    jk, jv = (jnp.asarray(arrays[n], jnp.bfloat16) if cache == "bf16" else jc[i]
              for i, n in enumerate(("k", "v")))
    acc_j, m_j, s_j = (np.asarray(a, np.float32) for a in j_decode_attention(
        jq, jk, jv, jnp.int32(1), jnp.asarray(lengths), k_scale=jc.k_scale,
        v_scale=jc.v_scale, block_s=128, interpret=True, return_stats=True))
    tdt = torch.bfloat16 if cache == "bf16" else None
    t = {n: torch.from_numpy(a) for n, a in arrays.items()}
    if cache == "bf16":
        t = {n: a.to(tdt) for n, a in t.items()}
    if cache == "int4":
        t["k_scale"], t["v_scale"] = t["k_scale"].bfloat16(), t["v_scale"].bfloat16()
    tq = torch.from_numpy(q).to(tdt) if tdt else torch.from_numpy(q)
    acc, m, s = (a.numpy() for a in da.decode_attention(
        tq, t["k"], t["v"], 1, torch.from_numpy(lengths), t.get("k_scale"), t.get("v_scale"),
        return_stats=True))
    full = lengths > 0
    # empty lanes: the finite sentinel in both, nothing summed in the port
    assert np.all(m[~full] == NEG_INF) and np.all(m_j[~full] == np.float32(NEG_INF))
    assert np.all(acc[~full] == 0) and np.all(s[~full] == 0)
    assert _rel(acc[full], acc_j[full]) < STATS_ACC_RTOL
    assert _rel(m[full], m_j[full]) < STATS_RTOL
    assert np.allclose(s[full], s_j[full], rtol=STATS_RTOL, atol=0)


def _merge_setup():
    rng = np.random.RandomState(1)
    L, B, H, S, D = 2, 2, 4, 256, 64
    k = rng.randn(L, B, H, S, D).astype(np.float32)
    v = rng.randn(L, B, H, S, D).astype(np.float32)
    q = rng.randn(B, H, D).astype(np.float32)
    return k, v, q, np.asarray([100, 200], np.int32)


def _merge(acc, m, s, q, k1, v1):
    """The fresh token's analytic term merged into the stats."""
    score = np.sum(q * k1, axis=-1) / np.sqrt(q.shape[-1])
    m2 = np.maximum(m, score)
    corr, p_new = np.exp(m - m2), np.exp(score - m2)
    return (acc * corr[..., None] + p_new[..., None] * v1) / (s * corr + p_new)[..., None]


def test_stats_merge_equals_full():
    """tests/test_kernels.py:242-270 on the port: the stats over lengths-1
    positions, merged with the last position's k/v, equal the attention over
    all ``lengths``."""
    k, v, q, lengths = _merge_setup()
    t = torch.from_numpy
    full = da.decode_attention(t(q), t(k), t(v), 0, t(lengths)).numpy()
    acc, m, s = (a.numpy() for a in da.decode_attention(t(q), t(k), t(v), 0, t(lengths - 1),
                                                        return_stats=True))
    bi, last = np.arange(len(lengths)), lengths - 1
    merged = _merge(acc, m, s, q, k[0][bi, :, last], v[0][bi, :, last])
    np.testing.assert_allclose(merged, full, rtol=2e-4, atol=2e-4)


def test_stats_merge_empty_cache_gives_self_attention():
    """tests/test_kernels.py:272-290 on the port: at length 0 the finite
    sentinel makes corr = 0, and the merge is exactly the fresh value."""
    k, v, q, lengths = _merge_setup()
    t = torch.from_numpy
    acc, m, s = (a.numpy() for a in da.decode_attention(
        t(q), t(k), t(v), 0, t(np.zeros_like(lengths)), return_stats=True))
    rng = np.random.RandomState(7)
    k1 = rng.randn(*q.shape).astype(np.float32)
    v1 = rng.randn(*q.shape).astype(np.float32)
    merged = _merge(acc, m, s, q, k1, v1)
    assert np.all(np.isfinite(merged))
    np.testing.assert_allclose(merged, v1, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ the mesh functions

MESHES = {"context2": {"context": 2}, "context2_model2": {"context": 2, "model": 2},
          "context4": {"context": 4}, "model2": {"model": 2}}
OP_MESHES = ("context2", "context2_model2", "context4")
OP_CACHES = ("f32", "int8", "int4")
PREFILL_POS = 290  # the prefill chunk's first position: its keys span blocks

GEN = {"max_new_tokens": 6, "chunk": 3}
# tests/test_cp_cache.py:44-106: (name, mesh, JAX kernels, cache, prompt)
ENGINE_CASES = [
    ("xla_fallback", "context2_model2", "xla", "float32", [5, 17, 3, 42, 7]),
    ("kernel_decode_merge", "context2_model2", "interpret", "float32", [9, 9, 200, 31]),
    ("int8_kv", "context2", "interpret", "int8", [5, 17, 3]),
    ("int4_kv", "context2_model2", "interpret", "int4", [12, 300, 4, 4]),
]
JDT = {"float32": jnp.float32, "int8": jnp.int8, "int4": "int4"}
TDT = {"float32": torch.float32, "int8": torch.int8, "int4": "int4"}
SERVING_PROMPT = [7, 301, 44, 5, 18, 90]  # the int4 serving form, context=2, int8 KV
BATCHED_PROMPTS = [[5, 17, 3], [9, 9, 200], [31, 4, 4, 8]]  # on 2 lanes, model=2
BATCHED_NEW = 5


def _op_inputs() -> dict:
    rng = np.random.RandomState(3)
    L, B, H, S, D, Sq = 2, 2, 4, 512, 64, 8
    caches = _caches(rng, L, B, H, S, D)
    q_dec = rng.randn(B, H, D).astype(np.float32)
    lengths = np.asarray([300, 45], np.int32)  # lane 1 leaves the later blocks empty
    q_pre = rng.randn(B, Sq, H, D).astype(np.float32)
    qi = PREFILL_POS + np.arange(Sq)
    mask = (np.arange(S)[None, :] <= qi[:, None])[None, None]
    return {name: (caches[name], q_dec, lengths, q_pre, mask) for name in OP_CACHES}


def _jax_ops(kw: dict, arrays, q_dec, lengths, q_pre, mask) -> tuple:
    """The JAX functions' (decode, prefill) on one cache; the Pallas kernels
    as the caller's ``kernels`` mode sets them."""
    jmesh = j_make_mesh(JMeshConfig(**kw))
    jc = _jcache(arrays)
    dec = jcp.mesh_decode_attention(jnp.asarray(q_dec), jc, jnp.int32(1),
                                    jnp.asarray(lengths), jmesh)
    pre = jcp.cp_cached_prefill_attention(jnp.asarray(q_pre), jc, jnp.int32(1),
                                          jnp.asarray(mask), jmesh)
    return np.asarray(dec, np.float32), np.asarray(pre, np.float32)


def _jax_tokens(params, cfg, mesh_kw, cache, prompt):
    mesh = j_make_mesh(JMeshConfig(**mesh_kw))
    gen = JGen(max_new_tokens=GEN["max_new_tokens"], temperature=0.0, top_k=None,
               decode_chunk=GEN["chunk"])
    with mesh:
        return JEngine(params, cfg, max_seq_len=256, cache_dtype=JDT[cache],
                       mesh=mesh).generate(prompt, gen).tokens


def _jax_batched(params, cfg):
    mesh = j_make_mesh(JMeshConfig(**MESHES["model2"]))
    with mesh:
        srv = JBatchedEngine(params, cfg, max_lanes=2, max_seq_len=128, decode_chunk=3,
                             cache_dtype=jnp.float32, mesh=mesh)
        uids = [srv.submit(p, max_new_tokens=BATCHED_NEW) for p in BATCHED_PROMPTS]
        fin = {r.uid: r for r in srv.run_until_complete()}
    return [fin[u].generated for u in uids]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{"ops": {mesh: (JAX {cache: (decode, prefill)}, each rank's)},
    "engines": {case: (JAX tokens, each rank's (tokens, stats calls, normal
    calls))}, "batched": (JAX streams, each rank's (streams, cache shape))}.

    The port's ranks run in a thread, one spawn per mesh, while other
    threads of this process compute the JAX references (each under its own
    ``with mesh``; the kernel mode is the process's, so the one reference
    with the JAX kernels off runs first)."""
    op_inputs = _op_inputs()
    jcfg = kernel_cfg()
    jparams = init_aria_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tparams = from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    slm = jm.init_lm_params_serving_int4(jax.random.PRNGKey(1), SERVING_JTEXT, dtype=jnp.float32)
    slm["embed"] = dequantize_weight(slm["embed"], dtype=jnp.float32)
    s_tparams = {"lm": from_jax(jax.tree.map(np.asarray, slm), device="cpu")}
    s_tcfg = config_from_dict(dataclasses.asdict(SERVING_JCFG))

    engine_runs: dict = {}  # mesh -> [(case, Engine arguments)]
    for name, mesh, _, cache, prompt in ENGINE_CASES:
        engine_runs.setdefault(mesh, []).append(
            (name, (tparams, tcfg, TDT[cache], prompt, GEN["max_new_tokens"], GEN["chunk"])))
    engine_runs["context2"].append(
        ("int4_serving_form", (s_tparams, s_tcfg, torch.int8, SERVING_PROMPT,
                               GEN["max_new_tokens"], GEN["chunk"])))
    jobs = {mesh: [] for mesh in MESHES}
    for mesh in OP_MESHES:
        jobs[mesh].append(("ops", (op_inputs,)))
    for mesh, cases in engine_runs.items():
        jobs[mesh].append(("engines", ([c for _, c in cases],)))
    jobs["model2"].append(("batched", (tparams, tcfg, torch.float32, BATCHED_PROMPTS,
                                       BATCHED_NEW)))

    port: dict = {}

    def run_port():
        for mesh, mesh_jobs in jobs.items():
            kw = MESHES[mesh]
            port[mesh] = run_ranks(ranks.run, int(np.prod(list(kw.values()))), kw, mesh_jobs,
                                   store_dir=str(tmp_path_factory.mktemp(mesh)))

    with concurrent.futures.ThreadPoolExecutor(16) as pool:
        port_done = pool.submit(run_port)
        ref_tokens = {}
        for name, mesh, mode, cache, prompt in ENGINE_CASES:
            if mode == "xla":
                with kernels("xla"):
                    ref_tokens[name] = _jax_tokens(jparams, jcfg, MESHES[mesh], cache, prompt)
        with kernels("interpret"):
            ops = {(mesh, c): pool.submit(_jax_ops, MESHES[mesh], *op_inputs[c])
                   for mesh in OP_MESHES for c in OP_CACHES}
            toks = {name: pool.submit(_jax_tokens, jparams, jcfg, MESHES[mesh], cache, prompt)
                    for name, mesh, mode, cache, prompt in ENGINE_CASES if mode != "xla"}
            toks["int4_serving_form"] = pool.submit(
                _jax_tokens, {"lm": slm}, SERVING_JCFG, MESHES["context2"], "int8",
                SERVING_PROMPT)
            batched = pool.submit(_jax_batched, jparams, jcfg)
            ref_ops = {mesh: {c: ops[mesh, c].result() for c in OP_CACHES} for mesh in OP_MESHES}
            ref_tokens.update({name: f.result() for name, f in toks.items()})
            ref_batched = batched.result()
        port_done.result()

    def job(mesh, name):  # each rank's result of a job
        i = [n for n, _ in jobs[mesh]].index(name)
        return [rank_out[i] for rank_out in port[mesh]]

    engines = {}
    for mesh, cases in engine_runs.items():
        per_rank = job(mesh, "engines")
        for i, (name, _) in enumerate(cases):
            engines[name] = (ref_tokens[name], [r[i] for r in per_rank])
    return {"ops": {mesh: (ref_ops[mesh], job(mesh, "ops")) for mesh in OP_MESHES},
            "engines": engines, "batched": (ref_batched, job("model2", "batched"))}


@pytest.mark.parametrize("cache", OP_CACHES)
@pytest.mark.parametrize("mesh", OP_MESHES)
@pytest.mark.parametrize("fn", ["mesh_decode_attention", "cp_cached_prefill_attention"])
def test_mesh_attention_matches_jax(results, mesh, cache, fn):
    ref, got = results["ops"][mesh]
    i = 0 if fn == "mesh_decode_attention" else 1
    want = ref[cache][i]
    for rank_out in got:  # every rank holds the whole answer
        assert rank_out[cache][i].shape == want.shape
        assert _rel(rank_out[cache][i], want) < MESH_RTOL[cache], (mesh, cache, fn)


# ------------------------------------------------------------ the engines

@pytest.mark.parametrize("case", [c[0] for c in ENGINE_CASES] + ["int4_serving_form"])
def test_engine_mesh_greedy_tokens_match_jax(results, case):
    want, got = results["engines"][case]
    assert len(want) == GEN["max_new_tokens"]
    for tokens, _, _ in got:  # every rank returns the JAX engine's stream
        assert tokens == want


def test_cp_decode_runs_the_stats_kernel_once_a_layer_and_step(results):
    """Each rank calls the stats form once per layer of every decode step
    (the first token comes from the prefill), and never the normal form."""
    steps = GEN["max_new_tokens"] - 1
    for case in ("kernel_decode_merge", "int8_kv", "int4_serving_form"):
        layers = (SERVING_JTEXT if case == "int4_serving_form" else kernel_cfg().text).num_layers
        for _, stats, normal in results["engines"][case][1]:
            assert (stats, normal) == (layers * steps, 0), case


def test_batched_engine_model_mesh_matches_jax(results):
    """``BatchedEngine(mesh=model 2)``: each rank holds half the heads of every
    lane and returns the JAX engine's streams (3 requests on 2 lanes, an f32
    cache, as tests/test_mesh_kernels.py's TP cases)."""
    want, got = results["batched"]
    assert all(len(s) == BATCHED_NEW for s in want)
    text = kernel_cfg().text
    for streams, shape in got:
        assert streams == want
        assert list(shape) == [text.num_layers, 2, text.num_kv_heads // 2, 128, text.head_dim]


@pytest.mark.parametrize("axis", ["expert", "data", "fsdp", "pipe"])
def test_unported_axes_raise(axis):
    """pipe is not ported: its mesh raises. expert, data and fsdp are
    (tests/test_torch_ep.py, tests/test_torch_mesh_train.py); what stays
    unported beside them, training over model, raises."""
    if axis == "pipe":
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 11"):
            tmesh.make_mesh(tmesh.MeshConfig(pipe=2))
        return
    from aria_tpu_torch.models.aria import init_aria_params as t_init
    from aria_tpu_torch.models.moe_lm import lm_forward

    cfg = config_from_dict(dataclasses.asdict(kernel_cfg()))
    lm = t_init(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)["lm"]
    mesh = tmesh.Mesh(tmesh.MeshConfig(**{axis: 2, "model": 2}), 0, {})
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 11"):
        lm_forward(lm, cfg.text, torch.zeros((2, 8), dtype=torch.long), training=True, mesh=mesh)
