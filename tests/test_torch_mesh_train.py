"""Sharded training of the port (the ``data``, ``fsdp`` and ``expert`` axes)
against the JAX package and against its own one-rank step, on the CPU.

The port's ranks are 8 processes that ``run_ranks`` spawns once for the
module (tests/torch_mesh_ranks.py, which imports no JAX), joined over gloo;
on them three meshes are built: expert 4 x fsdp 2 (recipes/config_full.yaml's),
data 2 x fsdp 2 x expert 2, and fsdp 4 x data 2 (no expert axis: the
router's losses over the global batch). Every rank starts from the same
``AriaConfig.tiny()`` tree in f32 (the JAX ``init_aria_params``), cut to its
shard by ``aria_param_specs``, and trains on its rows of the same global
batch. ``train()`` runs on 4 more spawned ranks (mesh_fsdp 2, mesh_expert 2).

- ``train_step`` over expert 4 x fsdp 2: loss and aux loss within 2e-3
  relative of the JAX ``train_step`` over the same mesh
  (tests/test_parallel.py:289-318's tolerance and inputs), and every metric
  and trainable leaf after two steps within f32 summation order of the
  port's one-rank step (only trainable leaves: the reference's frozen ViT
  under ``freeze_vit`` is fault (h) of ROADMAP queue 3).
- The gradients of the first step, gathered whole, equal the one-rank
  step's; the same gradients summed once more over ``expert`` (what a port
  that forgot that the loss is replicated over ``expert`` would apply) do
  not: the witness that the test would see that fault.
- The two other meshes' steps and ``lora_train_step`` over the recipe's
  mesh against one rank.
- Each rank's resident parameter bytes: 1/8 of the expert stacks, 1/2 of
  every leaf ``fsdp`` shards, the rest whole.
- ``train()`` with mesh_fsdp 2, mesh_expert 2 for 2 steps ends where the
  one-rank ``train()`` does, rank 0's checkpoint is in the one-device format
  and resumes on one rank; from an HF model_path its step is one rank's;
  model and context in training, and pipe, raise.

Tolerances: gradients 1e-5 of the leaf's largest value (f32 in another
summation order); each trainable leaf's change over the steps 2e-3 of its
norm (tests/test_torch_train_loop.py's rule, for Adam's amplification
where a gradient is near 0); metrics 1e-5 relative.
"""

import concurrent.futures
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from aria_tpu.config import AriaConfig as JAriaConfig
from aria_tpu.models.aria import init_aria_params
from aria_tpu.parallel import mesh as jmesh
from aria_tpu.train import step as jstep
from aria_tpu_torch.checkpoint.from_jax import from_jax
from aria_tpu_torch.checkpoint.io import latest_step, load_checkpoint
from aria_tpu_torch.config import config_from_dict
from aria_tpu_torch.models.moe_lm import lm_forward
from aria_tpu_torch.parallel import mesh as tmesh
from aria_tpu_torch.parallel.distributed import run_ranks
from aria_tpu_torch.train import lora as tlora
from aria_tpu_torch.train import step as tstep
from aria_tpu_torch.train.loop import recipe_mesh, train, train_on_ranks
from aria_tpu_torch.train.recipe import Recipe, load_recipe
from tests import torch_mesh_ranks as ranks

torch.set_num_threads(1)

JCFG = JAriaConfig.tiny()
CFG = config_from_dict(dataclasses.asdict(JCFG))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"fe": dict(fsdp=2, expert=4), "dfe": dict(data=2, fsdp=2, expert=2),
          "fd": dict(fsdp=4, data=2)}
TC = dict(freeze_vit=True, freeze_projector=True, learning_rate=1e-3)
LORA = tlora.LoraConfig(rank=4, alpha=8.0,
                        target_modules=("wqkv", "wo", "shared_w1", "shared_w2"))
LEAF_RTOL, METRIC_RTOL, CHANGE_RTOL = 1e-5, 1e-5, 2e-3


def _batch(rows: int, seed: int = 1):
    """tests/test_parallel.py:289-318's batch (B x 16 tokens of PRNGKey(1)),
    with a row's tail masked to exercise the global label count."""
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (rows, 16), 0,
                                           JCFG.text.vocab_size), np.int64)
    labels = tokens.copy()
    if rows > 2:
        labels[1, 9:] = -100
    return tokens, labels


def _one_rank(params_np, tokens, labels, steps: int):
    """The port's one-rank step: metrics, trainable leaves after ``steps``,
    the first step's gradients."""
    params = from_jax(params_np, "cpu")
    tc = tstep.TrainConfig(**TC)
    opt = tstep.make_optimizer(tc, params)
    state = tstep.TrainState(params, opt.init(params), 0)
    batch = {"input_ids": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    named = opt.trainable(params)
    for _, t in named:
        t.requires_grad_(True)
    with torch.enable_grad():
        loss, _ = tstep.loss_fn(params, CFG, batch)
        grads = {p: g.detach().numpy().copy() for p, g in tstep._grads(loss, named).items()}
    metrics = []
    for _ in range(steps):
        state, m = tstep.train_step(state, batch, CFG, tc, opt)
        metrics.append({k: float(v) for k, v in m.items()})
    trained = {p: t.detach().numpy() for p, t in tstep.leaves(state.params) if opt.mask[p]}
    return {"metrics": metrics, "params": trained, "grads": grads}


def _one_rank_lora(params_np, lora_np, tokens, labels):
    params, lora = from_jax(params_np, "cpu"), from_jax(lora_np, "cpu")
    opt = tstep.make_lora_optimizer(tstep.TrainConfig(**TC))
    state = tstep.TrainState(lora, opt.init(lora), 0)
    batch = {"input_ids": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    state, m = tstep.lora_train_step(state, batch, params, CFG, LORA.scale, opt)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "lora": {p: t.detach().numpy() for p, t in tstep.leaves(state.params)}}


def _jax_step(params, tokens, labels):
    """The JAX train_step over expert 4 x fsdp 2 (tests/test_parallel.py:289-318)."""
    tc = jstep.TrainConfig(freeze_vit=True, freeze_projector=True, learning_rate=1e-3)
    mesh = jmesh.make_mesh(jmesh.MeshConfig(expert=4, fsdp=2))
    sharded = jmesh.shard_tree(params, jmesh.aria_param_specs(), mesh)
    state, opt = jstep.init_train_state(sharded, tc)
    batch = {"input_ids": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    batch = {k: jax.device_put(v, NamedSharding(mesh, JP(("data", "fsdp"))))
             for k, v in batch.items()}
    with mesh:
        _, m = jax.jit(lambda s, b: jstep.train_step(s, b, JCFG, tc, opt, mesh=mesh))(state,
                                                                                    batch)
    return {k: float(v) for k, v in m.items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    params = init_aria_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)
    params_np = jax.tree.map(np.asarray, params)
    lora = tlora.init_lora_params(CFG, LORA, torch.Generator().manual_seed(3), device="cpu")
    lora_np = {p: t.numpy() for p, t in tstep.leaves(lora)}
    lora_tree = {}
    for p, a in lora_np.items():
        node = lora_tree
        *keys, last = p.split("/")
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = a
    batches = {"fe": _batch(2), "dfe": _batch(4), "fd": _batch(8)}
    jobs = [("train_step", m, (params_np, CFG, *batches[m], TC, 2)) for m in MESHES]
    jobs.append(("lora_step", "fe", (params_np, lora_tree, CFG, *batches["fe"], LORA.scale, TC)))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        port_done = pool.submit(run_ranks, ranks.run, 8, MESHES, jobs,
                                store_dir=str(tmp_path_factory.mktemp("mesh_train")))
        ref_jax = _jax_step(params, *batches["fe"])
        ref_one = {m: _one_rank(params_np, *batches[m], 2) for m in MESHES}
        ref_lora = _one_rank_lora(params_np, lora_tree, *batches["fe"])
        port = port_done.result()
    got = {m: [r[i] for r in port] for i, m in enumerate(MESHES)}
    return {"jax": ref_jax, "one": ref_one, "port": got, "lora": (ref_lora,
                                                                    [r[-1] for r in port]),
            "params": params_np, "flat": dict(tstep.leaves(params_np)), "lora_init": lora_np}


def _close(got: dict, want: dict, rtol: float, what: str):
    for p, w in want.items():
        scale = max(float(np.max(np.abs(w))), 1e-30)
        err = float(np.max(np.abs(got[p] - w)))
        assert err <= rtol * scale, (what, p, err, scale)


def _same_change(got: dict, want: dict, init: dict, what: str):
    """Each leaf's change over the steps agrees to CHANGE_RTOL of its norm
    (tests/test_torch_train_loop.py's rule: where a gradient is near 0,
    Adam's steps g / (|g| + eps) amplify f32 order differences in single
    elements)."""
    for p, w in want.items():
        moved = w - init[p]
        err = float(np.linalg.norm(got[p] - w))
        assert err <= CHANGE_RTOL * float(np.linalg.norm(moved)), (what, p, err)


def test_step_over_the_recipe_mesh_matches_jax(results):
    """Loss and aux loss of one step over expert 4 x fsdp 2 against the JAX
    step over the same mesh, 2e-3 relative (tests/test_parallel.py:289-318)."""
    want = results["jax"]
    for r in results["port"]["fe"]:
        m = r["metrics"][0]
        for key in ("loss", "aux_loss"):
            np.testing.assert_allclose(m[key], want[key], rtol=2e-3)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_step_matches_one_rank_leaf_by_leaf(results, mesh):
    want = results["one"][mesh]
    for r in results["port"][mesh]:
        for mg, mw in zip(r["metrics"], want["metrics"]):
            for key, value in mw.items():
                assert abs(mg[key] - value) <= METRIC_RTOL * abs(value), (mesh, key)
        assert set(r["params"]) == set(want["params"])
        _same_change(r["params"], want["params"], results["flat"], mesh)


@pytest.mark.parametrize("mesh", ["fe", "dfe"])
def test_gradients_are_not_summed_over_expert(results, mesh):
    """The reduced gradients equal one rank's; summed once more over
    ``expert`` they are n times too large wherever a leaf is replicated
    there, and the check above would fail on them."""
    want = results["one"][mesh]["grads"]
    n = MESHES[mesh]["expert"]
    for r in results["port"][mesh]:
        _close(r["grads"], want, LEAF_RTOL, mesh)
        for p in ("lm/embed", "lm/layers/wqkv", "lm/layers/gate", "lm/final_norm"):
            np.testing.assert_allclose(r["wrong"][p], n * r["grads"][p], rtol=1e-6, atol=1e-12)
            assert np.max(np.abs(r["wrong"][p] - want[p])) > 100 * LEAF_RTOL * np.max(
                np.abs(want[p]))


def test_lora_step_over_the_recipe_mesh_matches_one_rank(results):
    want, got = results["lora"]
    for r in got:
        for key, value in want["metrics"].items():
            assert abs(r["metrics"][key] - value) <= METRIC_RTOL * abs(value), key
        _same_change(r["lora"], want["lora"], results["lora_init"], "lora")


def test_resident_shards(results):
    """Expert 4 x fsdp 2: each rank holds 1/8 of w1 and w2 (experts over 4,
    D over 2), 1/2 of every other leaf whose spec names fsdp, and the rest
    whole."""
    params = results["params"]
    specs = tmesh.leaf_specs(params, tmesh.aria_param_specs())
    whole = {p: a.nbytes for p, a in tstep.leaves(params)}
    flat_specs = {}

    def walk(s, prefix=""):
        if isinstance(s, dict):
            for k, v in s.items():
                walk(v, f"{prefix}{k}/")
        else:
            flat_specs[prefix[:-1]] = s

    walk(specs)
    for r in results["port"]["fe"]:
        for p, nbytes in r["resident"].items():
            spec = flat_specs[p]
            split = (4 if "expert" in spec else 1) * (2 if "fsdp" in spec else 1)
            assert nbytes * split == whole[p], p
        experts = sum(r["resident"][f"lm/layers/{w}"] for w in ("w1", "w2"))
        assert experts * 8 == whole["lm/layers/w1"] + whole["lm/layers/w2"]


# ------------------------------------------------------------ train()

def _dataset(path, n=8):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "train.jsonl"), "w") as f:
        for i in range(n):
            f.write(json.dumps({"messages": [
                {"role": "user", "content": [{"type": "text", "text": f"question {i}?"}]},
                {"role": "assistant", "content": [{"type": "text", "text": f"answer {i}!"}]}],
                "images": None, "video": None}) + "\n")
    return path


def test_train_over_a_mesh_checkpoints_and_resumes_on_one_rank(tmp_path):
    """recipes/config_full.yaml at mesh_fsdp 2, mesh_expert 2 on 4 spawned
    ranks, 2 steps of the global batch of 4: the metrics and the saved
    state equal the one-rank run's; the checkpoint (rank 0's, gathered whole)
    resumes on one rank, which then trains on."""
    base = load_recipe(os.path.join(ROOT, "recipes", "config_full.yaml"))
    ds = _dataset(str(tmp_path / "ds"), 12)  # 3 steps of 4 rows: the resumed run takes the 3rd

    def recipe(out, **kw):
        return dataclasses.replace(base, output_dir=str(tmp_path / out), dataset_mixer={ds: 1.0},
                                   per_device_train_batch_size=4, gradient_accumulation_steps=1,
                                   max_seq_length=64, learning_rate=1e-3, dtype="float32", **kw)

    one = train(recipe("one", mesh_fsdp=1, mesh_expert=1), cfg=CFG, max_steps=2, device="cpu")
    summary = train_on_ranks(recipe("mesh", mesh_fsdp=2, mesh_expert=2), cfg=CFG, max_steps=2,
                             device="cpu")
    assert [s["step"] for s in summary] == [2] * 4
    whole = sum(t.numel() * t.element_size() for _, t in tstep.leaves(one.params))
    assert all(s["param_bytes"] < whole for s in summary)
    lines = {name: [json.loads(x) for x in open(tmp_path / name / "metrics.jsonl")]
             for name in ("one", "mesh")}
    assert [x["step"] for x in lines["mesh"]] == [1, 2]  # rank 0 alone writes them
    for a, b in zip(lines["mesh"], lines["one"]):
        for key in ("loss", "ce_loss", "z_loss", "aux_loss", "grad_norm"):
            assert abs(a[key] - b[key]) <= METRIC_RTOL * abs(b[key]), key
    ckpt = str(tmp_path / "mesh" / "checkpoints")
    saved, _ = load_checkpoint(ckpt, latest_step(ckpt), "cpu")
    assert saved["step"] == 2 and saved["opt_state"]["count"] == 2
    want = {p: t.detach().numpy() for p, t in tstep.leaves(one.params)}
    from aria_tpu_torch.models.aria import init_aria_params as t_init

    init = {p: t.numpy() for p, t in tstep.leaves(t_init(
        CFG, torch.Generator().manual_seed(base.seed), device="cpu", dtype=torch.float32))}
    _same_change({p: t.numpy() for p, t in tstep.leaves(saved["params"])}, want, init, "ckpt")
    resumed = train(recipe("mesh", mesh_fsdp=1, mesh_expert=1, resume_from_checkpoint=True),
                    cfg=CFG, max_steps=3, device="cpu")
    assert resumed.step == 3 and resumed.opt_state["count"] == 3


def test_train_over_a_mesh_from_a_model_path(tmp_path):
    """A recipe whose model_path is an HF safetensors directory, over
    mesh_fsdp 2, mesh_expert 2 on 4 spawned ranks: each rank builds its
    shard on the CPU before it reaches the device (``build_params``), and
    the step's metrics equal the one-rank run's from the same directory."""
    from tests.test_checkpoint import synthetic_hf_state_dict
    from tests.test_torch_checkpoint_io import _save_shards

    model = _save_shards(synthetic_hf_state_dict(JCFG), tmp_path / "hf")
    base = load_recipe(os.path.join(ROOT, "recipes", "config_full.yaml"))
    ds = _dataset(str(tmp_path / "ds"), 4)

    def recipe(out, **kw):
        return dataclasses.replace(base, output_dir=str(tmp_path / out), dataset_mixer={ds: 1.0},
                                   model_path=str(model), per_device_train_batch_size=4,
                                   gradient_accumulation_steps=1, max_seq_length=64,
                                   learning_rate=1e-3, dtype="float32", save_every_steps=0,
                                   **kw)

    train(recipe("one", mesh_fsdp=1, mesh_expert=1), cfg=CFG, max_steps=1, device="cpu")
    summary = train_on_ranks(recipe("mesh", mesh_fsdp=2, mesh_expert=2), cfg=CFG, max_steps=1,
                             device="cpu")
    assert [s["step"] for s in summary] == [1] * 4
    (one,), (mesh,) = ([json.loads(x) for x in open(tmp_path / name / "metrics.jsonl")]
                       for name in ("one", "mesh"))
    for key in ("loss", "ce_loss", "z_loss", "aux_loss", "grad_norm"):
        assert abs(mesh[key] - one[key]) <= METRIC_RTOL * abs(one[key]), key


def test_unported_training_axes_raise():
    params = init_aria_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)
    lm = from_jax(jax.tree.map(np.asarray, params["lm"]), "cpu")
    tokens = torch.zeros((2, 8), dtype=torch.long)
    for axis in ("model", "context"):
        mesh = tmesh.Mesh(tmesh.MeshConfig(**{axis: 2}), 0, {})
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 11"):
            lm_forward(lm, CFG.text, tokens, training=True, mesh=mesh)
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 11"):
            recipe_mesh(Recipe(**{f"mesh_{axis}": 2}))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 11"):
        tmesh.make_mesh(tmesh.MeshConfig(pipe=2))
