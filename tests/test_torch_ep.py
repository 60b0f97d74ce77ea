"""Expert parallelism and the mesh's spec trees of the port against the JAX
package, on the CPU.

The JAX side runs on the 8-device virtual CPU mesh of tests/conftest.py,
its Pallas kernels in interpret mode where a case says so, as
tests/test_parallel.py and tests/test_mesh_kernels.py run it. The port's
ranks are 4 processes that ``run_ranks`` spawns once for the module,
joined over gloo (tests/torch_mesh_ranks.py, which imports no JAX); on them
three meshes are built: expert 4, data 2 x expert 2 (two expert groups of
2, so n = 2) and expert 2 x model 2. Each rank keeps its experts of the
same numpy stacks and runs the plain versions of the kernels.

- ``experts_ep`` at n = 2 and 4 against the JAX ``experts_ep`` on the same
  inputs: f32 and bf16 stacks and activations, int8 and int4 stacks
  (tests/test_parallel.py:209-265), a finite ``capacity_factor`` (slots
  dropped by the JAX rule), training with the z and aux losses, and the
  whole-stack ``layer_idx`` path (the decode-MoE kernel's plain version)
  against the sliced one and against JAX's (tests/test_mesh_kernels.py:240-).
  Every rank holds the whole output.
- Only tokens move: every collective of the path carries at most the token
  buffers, and less than this rank's expert stack.
- ``Engine(mesh=expert 2)`` and ``expert 4`` (the f32 tree converted a
  shard at a time by ``from_jax(mesh=)``, the bf16 one given whole and cut
  by the engine) give the same greedy tokens as
  each other and as the JAX ``Engine(mesh=expert 2)`` on the unfused int4
  serving form with f32 activations, and the same as each other on its bf16
  form (the W4A8 decode MoE, whose plain version is exact integer
  arithmetic, so a row does not depend on the rows beside it; the JAX test
  of this, tests/test_mesh_kernels.py:149-171, takes the bf16-activation
  kernel instead). As in tests/test_torch_server.py, the W4A8 MoE's int8
  rounding flips against the JAX kernel's can move a greedy token on this
  random model: the JAX test's own prompt is one where none moves (5 of 8
  prompts drawn for this agree; expert 2 and 4 agree on all 8).
  ``BatchedEngine(mesh=expert 2 x model 2)`` gives the JAX
  one's streams (tests/test_mesh_kernels.py:208-238); a fused stack on an
  expert mesh raises.
- The spec trees (``lm``, ``vit``, ``projector``, ``aria``,
  ``serving_param_specs``, the spread over quantized leaves) equal the JAX
  ones leaf for leaf; ``shard_leaf`` gives every rank of expert 4 x fsdp 2
  the block that JAX's ``shard_tree`` puts on that device; each rank's
  groups are the JAX mesh's lines.

Tolerances: f32 outputs 1e-5 of max |ref| (the same products in another
order); bf16 activations 2^-7 of max |ref| (each slot's row rounds to bf16
on both sides; the f32 sums before it differ by order, so a row may round
the other way); int8 and int4 stacks 2e-5 (the JAX test's dequantized
references agree to f32 order); the losses 1e-5 relative.
"""

import concurrent.futures
import dataclasses
import os

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
from aria_tpu.ops import quant as jquant
from aria_tpu.parallel import mesh as jmesh
from aria_tpu.parallel.ep import experts_ep as j_experts_ep
from aria_tpu_torch.checkpoint.from_jax import from_jax
from aria_tpu_torch.config import config_from_dict
from aria_tpu_torch.parallel import mesh as tmesh
from aria_tpu_torch.parallel.distributed import run_ranks
from tests import torch_mesh_ranks as ranks
from tests.test_mesh_kernels import kernel_cfg, kernels
from tests.test_torch_server import JCFG as SERVING_JCFG

torch.set_num_threads(1)

MESHES = {"e4": dict(expert=4), "e2": dict(data=2, expert=2), "em": dict(expert=2, model=2)}
N = {"e4": 4, "e2": 2}
RTOL = {"f32": 1e-5, "bf16": 2.0**-7, "int8": 2e-5, "int4": 2e-5, "capacity": 1e-5,
        "train": 1e-5}
LOSS_RTOL = 1e-5
PROMPT, NEW, CHUNK = [5, 17, 3, 42], 5, 3  # tests/test_mesh_kernels.py:149-171's
BATCHED_PROMPTS = [[5, 17, 3], [9, 9, 200]]


def _rel(got, ref) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float64) - ref)) / np.max(np.abs(ref)))


def _ep_cases() -> dict:
    """{case: (x, gate, k, w1, w2, JAX kwargs)} as numpy (quantized stacks
    as dicts of numpy leaves), the shapes of tests/test_parallel.py."""
    rng = np.random.RandomState(0)
    T, D, E, k, I = 32, 64, 8, 2, 32
    x = rng.randn(T, D).astype(np.float32)
    gate = rng.randn(E, D).astype(np.float32)
    w1 = (rng.randn(E, 2 * I, D) * 0.05).astype(np.float32)
    w2 = (rng.randn(E, I, D) * 0.05).astype(np.float32)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))  # noqa: E731
    cases = {"f32": (x, gate, k, w1, w2, {}),
             "bf16": (bf(x), gate, k, bf(w1), bf(w2), {}),
             "capacity": (x, gate, k, w1, w2, {"capacity_factor": 0.5}),
             "train": (x, gate, k, w1, w2, {"training": True, "z_loss_coeff": 1e-2,
                                            "aux_loss_coeff": 1e-1})}
    rng = np.random.RandomState(1)
    T, D, E, k, I = 32, 512, 8, 2, 64  # D = 512: the int4 grouping (256 lanes) engages
    x = rng.randn(T, D).astype(np.float32)
    gate = rng.randn(E, D).astype(np.float32)
    w1 = jnp.asarray(rng.randn(E, 2 * I, D).astype(np.float32)) * 0.05
    w2 = jnp.asarray(rng.randn(E, I, D).astype(np.float32)) * 0.05
    q4 = jquant.quantize_expert_int4(w1, w2)
    q8 = (jquant._with_s8(jquant.quantize_weight(w1, input_axis=-1)),
          jquant._with_s8(jquant.quantize_weight(w2, input_axis=-2)))
    for name, (a, b) in (("int4", q4), ("int8", q8)):
        cases[name] = (x, gate, k, jax.tree.map(np.asarray, a), jax.tree.map(np.asarray, b), {})
    return cases


def _layer_case():
    """tests/test_mesh_kernels.py:240-: whole int4 stacks [L, E, ...] and a
    layer index."""
    rng = np.random.RandomState(0)
    L, T, D, E, k, I = 3, 8, 64, 8, 2, 256
    x = (rng.randn(T, D).astype(np.float32) * 0.3)
    gate = (rng.randn(E, D).astype(np.float32) * 0.3)
    w1 = jnp.asarray(rng.randn(L, E, 2 * I, D).astype(np.float32)) * 0.05
    w2 = jnp.asarray(rng.randn(L, E, I, D).astype(np.float32)) * 0.05
    q1, q2 = (jax.tree.map(np.asarray, q) for q in jquant.quantize_expert_int4(w1, w2))
    return x, gate, k, q1, q2, 1


def _jax_ep(n, x, gate, k, w1, w2, kw, layer_idx=None):
    mesh = jmesh.make_mesh(jmesh.MeshConfig(expert=n))
    tree = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    with mesh:
        if layer_idx is None:
            fn = jax.jit(lambda x, g, a, b: j_experts_ep(x, g, k, a, b, mesh, **kw))
            out, z, aux = fn(jnp.asarray(x), jnp.asarray(gate), tree(w1), tree(w2))
        else:
            fn = jax.jit(lambda x, g, a, b, li: j_experts_ep(x, g, k, a, b, mesh, layer_idx=li))
            out, z, aux = fn(jnp.asarray(x), jnp.asarray(gate), tree(w1), tree(w2),
                             jnp.int32(layer_idx))
    return np.asarray(out, np.float32), float(z), float(aux)


def _jax_engine(params, cfg, n):
    mesh = jmesh.make_mesh(jmesh.MeshConfig(expert=n))
    gen = JGen(max_new_tokens=NEW, temperature=0.0, top_k=None, decode_chunk=CHUNK)
    with mesh:
        return JEngine(params, cfg, max_seq_len=256, cache_dtype=jnp.int8,
                       mesh=mesh).generate(PROMPT, gen).tokens


def _jax_batched(params, cfg):
    mesh = jmesh.make_mesh(jmesh.MeshConfig(expert=2, model=2))
    with mesh:
        srv = JBatchedEngine(params, cfg, max_lanes=2, max_seq_len=128, temperature=0.0,
                             decode_chunk=3, cache_dtype=jnp.float32, mesh=mesh)
        uids = [srv.submit(p, max_new_tokens=NEW) for p in BATCHED_PROMPTS]
        fin = {r.uid: r for r in srv.run_until_complete()}
    return [fin[u].generated for u in uids]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{"ep": {(mesh, case): (JAX (out, z, aux), each rank's)}, "layer":
    (JAX out, each rank's (whole-stack, sliced)), "engines": (JAX tokens,
    {mesh: each rank's runs}), "batched": (JAX streams, each rank's),
    "groups": each rank's {e4, e2, em} groups, "refusals": each rank's}.
    The port's ranks run in a thread while this process computes the JAX
    references."""
    cases = _ep_cases()
    layer = _layer_case()
    # f32 activations, as tests/test_torch_cp_cache.py serves this form (the
    # JAX dense_int4 rounds a bf16 input's unpack identity; ROADMAP queue 3
    # (d)); and the bf16 form, which only the port's meshes compare
    slm = jm.init_lm_params_serving_int4(jax.random.PRNGKey(1), SERVING_JCFG.text,
                                         fuse_shared=False, dtype=jnp.float32)
    slm["embed"] = jquant.dequantize_weight(slm["embed"], dtype=jnp.float32)
    s_np = {"lm": jax.tree.map(np.asarray, slm)}  # each rank converts its shard
    b_tparams = {"lm": from_jax(jax.tree.map(np.asarray, jm.init_lm_params_serving_int4(
        jax.random.PRNGKey(2), SERVING_JCFG.text, fuse_shared=False)), device="cpu")}
    s_tcfg = config_from_dict(dataclasses.asdict(SERVING_JCFG))
    fused = {"lm": from_jax(jax.tree.map(np.asarray, jm.init_lm_params_serving_int4(
        jax.random.PRNGKey(1), SERVING_JCFG.text)), device="cpu")}
    kcfg = kernel_cfg()
    kparams = init_aria_params(jax.random.PRNGKey(0), kcfg, dtype=jnp.float32)
    k_tparams = from_jax(jax.tree.map(np.asarray, kparams), device="cpu")
    k_tcfg = config_from_dict(dataclasses.asdict(kcfg))

    jobs = []
    for mesh in ("e4", "e2"):
        for case, (x, gate, k, w1, w2, kw) in cases.items():
            jobs.append(("experts_ep", mesh, (x, gate, k, w1, w2, kw)))
        x, gate, k, q1, q2, li = layer
        jobs.append(("experts_ep", mesh, (x, gate, k, q1, q2, {"act_int8": False}, li)))
        jobs.append(("experts_ep", mesh, (x, gate, k, {n: v[li] for n, v in q1.items()},
                                          {n: v[li] for n, v in q2.items()}, {})))
        jobs.append(("engines", mesh, (s_np, s_tcfg, [(torch.int8, PROMPT, NEW, CHUNK,
                                                       True)])))
        jobs.append(("engines", mesh, (b_tparams, s_tcfg, [(torch.int8, PROMPT, NEW, CHUNK,
                                                            True)])))
    jobs.append(("batched", "em", (k_tparams, k_tcfg, BATCHED_PROMPTS, NEW)))
    for mesh in MESHES:
        jobs.append(("groups", mesh, ()))
    jobs.append(("refusals", "e4", (fused, s_tcfg)))

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        port_done = pool.submit(run_ranks, ranks.run, 4, MESHES, jobs,
                                store_dir=str(tmp_path_factory.mktemp("ep")))
        ref_ep = {(m, c): _jax_ep(N[m], *cases[c]) for m in N for c in cases}
        with kernels("interpret"):
            old = os.environ.get("ARIA_TPU_A8")
            os.environ["ARIA_TPU_A8"] = "0"
            try:
                x, gate, k, q1, q2, li = layer
                ref_layer = _jax_ep(4, x, gate, k, q1, q2, {}, layer_idx=li)
            finally:
                if old is None:
                    os.environ.pop("ARIA_TPU_A8", None)
                else:
                    os.environ["ARIA_TPU_A8"] = old
            ref_tokens = _jax_engine(s_np, SERVING_JCFG, 2)
            ref_batched = _jax_batched(kparams, kcfg)
        port = port_done.result()

    def job(i):
        return [rank_out[i] for rank_out in port]

    out = {"ep": {}, "layer": {}, "engines": {}}
    i = 0
    for mesh in ("e4", "e2"):
        for case in cases:
            out["ep"][mesh, case] = (ref_ep[mesh, case], job(i))
            i += 1
        out["layer"][mesh] = (ref_layer[0], job(i), job(i + 1))
        out["engines"][mesh] = (job(i + 2), job(i + 3))
        i += 4
    out["ref_tokens"] = ref_tokens
    out["batched"] = (ref_batched, job(i))
    out["groups"] = {mesh: job(i + 1 + j) for j, mesh in enumerate(MESHES)}
    out["refusals"] = job(i + 1 + len(MESHES))
    out["cases"] = cases
    return out


@pytest.mark.parametrize("case", list(RTOL))
@pytest.mark.parametrize("mesh", list(N))
def test_experts_ep_matches_jax(results, mesh, case):
    (want, z, aux), got = results["ep"][mesh, case]
    for r in got:  # every rank holds the whole output
        assert r["out"].shape == want.shape
        assert _rel(r["out"], want) <= RTOL[case], (mesh, case, _rel(r["out"], want))
        if case == "train":
            # each rank returns its share of the batch group's losses; the
            # data replicas of "e2" hold the same rows, so the group's batch
            # is this one twice, whose losses are these
            parts = MESHES[mesh].get("data", 1)
            assert abs(parts * r["z"] - z) <= LOSS_RTOL * abs(z) and z > 0
            assert abs(parts * r["aux"] - aux) <= LOSS_RTOL * abs(aux) and aux > 0
        else:
            assert r["z"] == 0.0 and r["aux"] == 0.0


def test_capacity_factor_drops_slots(results):
    """The finite factor's case differs from the dropless one: slots were
    dropped, and by the JAX rule (test above)."""
    (drop, _, _), _ = results["ep"]["e4", "capacity"]
    (full, _, _), _ = results["ep"]["e4", "f32"]
    assert _rel(drop, full) > 1e-2


@pytest.mark.parametrize("mesh", list(N))
def test_whole_stack_layer_path_matches_sliced_and_jax(results, mesh):
    """The decode-MoE kernel over the whole [L, E/n, ...] int4 stacks at a
    layer index equals the sliced layer through the ragged path (the JAX
    test's 2e-2, at f32 here: 1e-5 of max |ref|), and the JAX whole-stack
    path (its kernels interpreted, bf16 activations)."""
    want, whole, sliced = results["layer"][mesh]
    for w, s in zip(whole, sliced):
        assert _rel(w["out"], s["out"]) <= 1e-5
        assert _rel(w["out"], want) <= 2e-5


def test_only_tokens_move(results):
    """No collective of the int4 path carries more than the token buffers
    (rows of x out and back, the blocks gathered: T x k x D x 4 bytes at
    most), and each carries less than this rank's expert stacks."""
    x, _, k, w1, w2, _ = results["cases"]["int4"]
    T, D = x.shape
    for mesh, n in N.items():
        stack = sum(v.nbytes for w in (w1, w2) for v in w.values()) // n
        for r in results["ep"][mesh, "int4"][1]:
            sizes = [b for _, b in r["log"]]
            assert {name for name, _ in r["log"]} <= {"all_to_all", "exchange_counts",
                                                      "all_gather"}
            assert max(sizes) <= T * k * D * 4 and max(sizes) < stack


def test_engine_expert_meshes_match_each_other_and_jax(results):
    """The f32 form: each mesh's tokens are the JAX ``Engine(mesh=expert
    2)``'s. The bf16 form (each slot's row rounded to bf16 for the return):
    expert 2 and expert 4 give the same tokens (the W4A8 MoE's integer dots
    are exact, so a row's result does not depend on the rows beside it).
    Each rank keeps its experts only."""
    want = results["ref_tokens"]
    assert len(want) == NEW
    bf16 = {}
    for mesh, n in N.items():
        f32_runs, bf16_runs = results["engines"][mesh]
        for ((tokens, experts),), ((btokens, _),) in zip(f32_runs, bf16_runs):
            assert tokens == want, mesh
            assert experts == SERVING_JCFG.text.num_experts // n
            bf16.setdefault(mesh, btokens)
            assert btokens == bf16[mesh] and len(btokens) == NEW
    assert bf16["e2"] == bf16["e4"]


def test_batched_engine_expert_model_mesh_matches_jax(results):
    want, got = results["batched"]
    assert all(len(s) == NEW for s in want)
    for streams in got:
        assert streams == want


def test_fused_stack_on_an_expert_mesh_raises(results):
    for r in results["refusals"]:
        assert "fuse_shared=False" in r["fused"]
        assert "fuse_shared=False" in r["lm_forward"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_groups_are_the_jax_mesh_lines(results, mesh):
    """Each rank's group along an axis is the line of the JAX mesh's device
    array through that rank (devices in the order of jax.devices(), as the
    port's ranks): rank r sits at unravel_index(r, shape)."""
    cfg = jmesh.MeshConfig(**MESHES[mesh])
    devices = jmesh.make_mesh(cfg).devices
    ids = np.vectorize(lambda d: d.id)(devices)
    for rank, got in enumerate(results["groups"][mesh]):
        coords = np.unravel_index(rank, cfg.shape)
        for name, axes in [(a, (i,)) for i, a in enumerate(jmesh.AXES)] + [("batch", (0, 1))]:
            idx = tuple(slice(None) if i in axes else c for i, c in enumerate(coords))
            line = sorted(int(d) for d in np.ravel(ids[idx]))
            want = None if len(line) == 1 else line
            if name == "pipe":
                assert name not in got
                continue
            assert got[name] == want, (mesh, rank, name)


# ------------------------------------------------------------ the spec trees

def _same_specs(port, jax_specs, path=""):
    if isinstance(jax_specs, dict):
        assert set(port) == set(jax_specs), path
        for k in jax_specs:
            _same_specs(port[k], jax_specs[k], f"{path}/{k}")
    else:
        assert isinstance(port, tmesh.P) and tuple(port) == tuple(jax_specs), path


@pytest.mark.parametrize("name", ["lm_param_specs", "vit_param_specs", "projector_param_specs",
                                  "aria_param_specs"])
def test_spec_trees_match_jax(name):
    _same_specs(getattr(tmesh, name)(), getattr(jmesh, name)())


def test_serving_and_quantized_specs_match_jax():
    """``serving_param_specs`` of the unfused int4 tree, and the bf16 tree's
    specs spread over the QLoRA base's quantized leaves (``_align_specs``)."""
    slm = {"lm": jax.tree.map(np.asarray, jm.init_lm_params_serving_int4(
        jax.random.PRNGKey(1), SERVING_JCFG.text, fuse_shared=False))}
    _same_specs(tmesh.serving_param_specs(slm), jmesh.serving_param_specs(slm))
    assert tmesh.is_serving_quantized(slm) and jmesh.is_serving_quantized(slm)
    base = jax.tree.map(np.asarray, jquant.quantize_params(
        init_aria_params(jax.random.PRNGKey(0), kernel_cfg(), dtype=jnp.float32)))
    _same_specs(tmesh.align_specs(base, tmesh.aria_param_specs()),
                jmesh._align_specs(base, jmesh.aria_param_specs()))


def test_shard_leaf_gives_each_rank_the_jax_shard():
    """Every leaf of the training tree over expert 4 x fsdp 2: the block
    ``shard_leaf`` cuts for rank r is the data JAX's ``shard_tree`` puts on
    device r (model and the other axes are 1, so nothing else splits)."""
    cfg = kernel_cfg()
    params = init_aria_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    jcfg = jmesh.MeshConfig(expert=4, fsdp=2)
    sharded = jmesh.shard_tree(params, jmesh.aria_param_specs(), jmesh.make_mesh(jcfg))
    specs = tmesh.leaf_specs(params, tmesh.aria_param_specs())
    whole = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), params)
    tcfg = tmesh.MeshConfig(expert=4, fsdp=2)
    views = [tmesh.Mesh(tcfg, r, {}) for r in range(tcfg.num_devices)]
    flat_j = jax.tree_util.tree_leaves_with_path(sharded)
    flat_s = dict(jax.tree_util.tree_leaves_with_path(specs, is_leaf=lambda s: isinstance(
        s, tmesh.P)))
    flat_w = dict(jax.tree_util.tree_leaves_with_path(whole))
    split = 0
    for path, arr in flat_j:
        for shard in arr.addressable_shards:
            mine = tmesh.shard_leaf(flat_w[path], flat_s[path], views[shard.device.id])
            np.testing.assert_array_equal(mine.numpy(), np.asarray(shard.data), str(path))
            split += mine.numel() < flat_w[path].numel()
    assert split > 0
