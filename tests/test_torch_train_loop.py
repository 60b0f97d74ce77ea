"""The port's optimizer and training loop against the JAX package, on the
CPU: the learning-rate schedules, three ``train_step`` and
``lora_train_step`` updates against optax (clipping, the trainable mask,
frozen decoder layers, ``MultiSteps``), and ``train()`` end to end on
jsonl the test writes, for both recipes and a resume, as
tests/test_train_loop.py drives the JAX loop.

``AriaConfig.tiny()`` in f32; the two sides' gradients agree to f32
rounding in another summation order. Each leaf's change over the three
steps agrees to 2e-3 of its norm: where a gradient is near 0, Adam's steps
g / (|g| + eps) amplify those differences in single elements.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aria_tpu.config import AriaConfig
from aria_tpu.models import aria as jaria
from aria_tpu.ops import backend as jbackend
from aria_tpu.train import lora as jlora
from aria_tpu.train import step as jstep
from aria_tpu_torch.checkpoint.from_jax import from_jax
from aria_tpu_torch.checkpoint.io import latest_step, load_checkpoint, save_checkpoint
from aria_tpu_torch.config import config_from_dict
from aria_tpu_torch.train import step as tstep
from aria_tpu_torch.train.loop import train
from aria_tpu_torch.train.recipe import Recipe, load_recipe

torch.set_num_threads(1)
CFG = AriaConfig.tiny()
T_CFG = config_from_dict(dataclasses.asdict(CFG))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


@pytest.mark.parametrize("warmup,total", [(0, 7), (3, 10), (1, 2)])
def test_schedules_match_optax(warmup, total):
    tc = tstep.TrainConfig(learning_rate=3e-4, warmup_steps=warmup, total_steps=total)
    jtc = jstep.TrainConfig(learning_rate=3e-4, warmup_steps=warmup, total_steps=total)
    mine, ref = tstep.make_schedule(tc), jstep._make_schedule(jtc)
    for count in range(total + 3):
        np.testing.assert_allclose(float(mine(count)), float(ref(jnp.int32(count))),
                                   rtol=1e-6, atol=1e-12, err_msg=str(count))


def _batches(n, B=2, S=24):
    out = []
    for i in range(n):
        rng = np.random.RandomState(100 + i)
        ids = rng.randint(0, CFG.text.vocab_size, (B, S)).astype(np.int32)
        labels = ids.copy()
        labels[:, :3] = -100
        out.append({"input_ids": ids, "labels": labels})
    return out


def _torch_batch(b):
    return {k: torch.as_tensor(v).long() for k, v in b.items()}


def _assert_updates_close(got_tree, want_tree, init_tree, rtol=2e-3):
    """Per leaf, |(got - init) - (want - init)| <= rtol |want - init| (norms)."""
    want = dict(tstep.leaves(jax.tree.map(np.asarray, want_tree)))
    init = dict(tstep.leaves(jax.tree.map(np.asarray, init_tree)))
    got = tstep.leaves(got_tree)
    assert [p for p, _ in got] == sorted(want)
    for path, t in got:
        step = want[path] - init[path]
        err = np.linalg.norm(t.detach().numpy() - want[path])
        assert err <= rtol * np.linalg.norm(step) + 1e-12, (path, err, np.linalg.norm(step))


def _assert_metrics(got, want):
    for name in ("loss", "ce_loss", "z_loss", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_updates_match_optax(interpret, accum):
    """Three micro steps of full fine-tuning: the projector and ViT frozen,
    decoder layer 1 frozen, a clip norm the gradients exceed, warm-up then
    cosine decay, weight decay; with accum = 2 the third step only
    accumulates."""
    kw = dict(learning_rate=1e-3, weight_decay=0.1, grad_clip_norm=0.5, b2=0.95,
              warmup_steps=1, total_steps=4, freeze_llm_layers=(1,), grad_accum_steps=accum,
              gradient_checkpointing=True)
    jtc, tc = jstep.TrainConfig(**kw), tstep.TrainConfig(**kw)
    params = jaria.init_aria_params(jax.random.PRNGKey(0), CFG, dtype=jnp.float32)
    jstate, jopt = jstep.init_train_state(params, jtc)
    if accum > 1:
        jopt = optax.MultiSteps(jopt, accum)
        jstate = jstep.TrainState(params, jopt.init(params), jstate.step)
    tparams = from_jax(jax.tree.map(np.asarray, params), device="cpu")
    topt = tstep.make_optimizer(tc, tparams, accum)
    tstate = tstep.TrainState(tparams, topt.init(tparams), 0)
    for b in _batches(3):
        jstate, jm = jstep.train_step(jstate, jax.tree.map(jnp.asarray, b), CFG, jtc, jopt)
        tstate, tm_ = tstep.train_step(tstate, _torch_batch(b), T_CFG, tc, topt)
        _assert_metrics(tm_, jm)
    assert tstate.step == 3
    _assert_updates_close(tstate.params, jstate.params, params)
    # a frozen layer keeps zero moments; weight decay still moves it, as in optax
    assert float(tstate.opt_state["mu"]["lm/layers/wqkv"][1].abs().max()) == 0
    assert float(tstate.opt_state["mu"]["lm/layers/wqkv"][0].abs().max()) > 0


@pytest.mark.parametrize("accum", [1, 2])
def test_lora_train_step_updates_match_optax(interpret, accum):
    kw = dict(learning_rate=2e-2, weight_decay=0.1, grad_clip_norm=0.05, b2=0.95,
              total_steps=3, grad_accum_steps=accum)
    jtc, tc = jstep.TrainConfig(**kw), tstep.TrainConfig(**kw)
    params = jaria.init_aria_params(jax.random.PRNGKey(0), CFG, dtype=jnp.float32)
    lc = jlora.LoraConfig(rank=4, alpha=8.0)
    lora = jlora.init_lora_params(jax.random.PRNGKey(1), CFG, lc)
    # B away from 0, so that no adapter gradient sits near Adam's eps
    rng = np.random.RandomState(4)
    lora = jax.tree.map(lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.randn(*a.shape)
                                              .astype(np.float32)), lora)
    jopt = jstep.make_lora_optimizer(jtc)
    if accum > 1:
        jopt = optax.MultiSteps(jopt, accum)
    jstate = jstep.TrainState(lora, jopt.init(lora), jnp.zeros((), jnp.int32))
    tparams = from_jax(jax.tree.map(np.asarray, params), device="cpu")
    tl = from_jax(jax.tree.map(np.asarray, lora), device="cpu")
    topt = tstep.make_lora_optimizer(tc, accum)
    tstate = tstep.TrainState(tl, topt.init(tl), 0)
    for b in _batches(3):
        jstate, jm = jstep.lora_train_step(jstate, jax.tree.map(jnp.asarray, b), params, CFG,
                                           lc.scale, jopt, True)
        tstate, tm_ = tstep.lora_train_step(tstate, _torch_batch(b), tparams, T_CFG, lc.scale,
                                            topt, True)
        _assert_metrics(tm_, jm)
    _assert_updates_close(tstate.params, jstate.params, lora)
    assert float(tstate.params["lm"]["layers"]["wqkv"]["b"].abs().sum()) > 0


def test_optimizer_state_counts_like_multisteps():
    tc = tstep.TrainConfig(total_steps=5)
    p = {"w": torch.ones(3)}
    opt = tstep.Optimizer(tc, None, every_k=3)
    state = opt.init(p)
    for i in range(7):
        opt.update({"w": torch.full((3,), float(i))}, state, p)
    assert (state["count"], state["mini_step"], state["gradient_step"]) == (2, 1, 2)
    torch.testing.assert_close(state["acc"]["w"], torch.full((3,), 6.0))


# ------------------------------------------------------------ train() end to end


def make_dataset(tmp_path, n=8):
    d = tmp_path / "ds"
    d.mkdir(parents=True, exist_ok=True)
    with open(d / "train.jsonl", "w") as f:
        for i in range(n):
            f.write(json.dumps({
                "messages": [
                    {"role": "user", "content": [{"type": "text", "text": f"question {i}?"}]},
                    {"role": "assistant", "content": [{"type": "text", "text": f"answer {i}!"}]},
                ],
                "images": None, "video": None}) + "\n")
    return str(d)


def base_recipe(tmp_path, **kw):
    defaults = dict(output_dir=str(tmp_path / "out"), dataset_mixer={make_dataset(tmp_path): 1.0},
                    per_device_train_batch_size=2, gradient_accumulation_steps=1,
                    num_train_epochs=1, max_seq_length=64, learning_rate=1e-3,
                    gradient_checkpointing=True, dtype="float32", logging_steps=1)
    defaults.update(kw)
    return Recipe(**defaults)


def _metric_lines(r):
    return [json.loads(line) for line in open(os.path.join(r.output_dir, "metrics.jsonl"))]


@pytest.mark.parametrize("peft", [False, True])
def test_train_runs_the_recipes_and_checkpoints(tmp_path, peft):
    """Both recipes' settings (the full one trains the projector) on the tiny
    model: 3 steps, finite metrics, a loss that moves, the epoch-end
    checkpoint of the whole state."""
    recipe = load_recipe(os.path.join(ROOT, "recipes", "config_lora.yaml" if peft else
                                      "config_full.yaml"))
    over = dict(output_dir=str(tmp_path / "out"), dataset_mixer={make_dataset(tmp_path): 1.0},
                per_device_train_batch_size=2, gradient_accumulation_steps=1,
                max_seq_length=64, learning_rate=1e-3, dtype="float32", mesh_fsdp=1,
                mesh_expert=1, lora_r=4, lora_alpha=8)
    r = dataclasses.replace(recipe, **over)
    state = train(r, cfg=T_CFG, max_steps=3, device="cpu")
    assert state.step == 3
    lines = _metric_lines(r)
    assert [line["step"] for line in lines] == [1, 2, 3]
    assert all(np.isfinite(line["loss"]) and np.isfinite(line["grad_norm"]) for line in lines)
    assert lines[0]["loss"] != lines[-1]["loss"]
    ckpt = os.path.join(r.output_dir, "checkpoints")
    assert latest_step(ckpt) == 3
    saved, cfg = load_checkpoint(ckpt, 3, device="cpu")
    assert cfg.text.moe_aux_loss_coeff == recipe.moe_aux_loss_coeff
    assert saved["step"] == 3 and saved["opt_state"]["count"] == 3
    if peft:
        assert sorted(saved["params"]["lm"]["layers"]) == sorted(
            ["shared_w1", "shared_w2", "w1", "w2", "wo", "wqkv"])
    else:
        assert set(saved["params"]) == {"vision", "projector", "lm"}
        assert any(p.startswith("projector/") for p in saved["opt_state"]["mu"])
        assert not any(p.startswith("vision/") for p in saved["opt_state"]["mu"])


def test_resume_from_checkpoint(tmp_path):
    """A run saved every 2 steps, resumed from step 2, ends where the
    uninterrupted run does: the state and the data order come back."""
    r = base_recipe(tmp_path, save_every_steps=2)
    straight = train(r, cfg=T_CFG, max_steps=4, device="cpu")
    ckpt = os.path.join(r.output_dir, "checkpoints")
    assert latest_step(ckpt) == 4
    shutil.rmtree(os.path.join(ckpt, "step_4"))
    resumed = train(base_recipe(tmp_path, save_every_steps=2, resume_from_checkpoint=True),
                    cfg=T_CFG, max_steps=4, device="cpu")
    assert resumed.step == 4 and resumed.opt_state["count"] == 4
    assert [line["step"] for line in _metric_lines(r)] == [1, 2, 3, 4, 3, 4]
    for (p, a), (_, b) in zip(tstep.leaves(resumed.params), tstep.leaves(straight.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=p)


def test_grad_accum_and_cli(tmp_path):
    r = base_recipe(tmp_path, gradient_accumulation_steps=2)
    state = train(r, cfg=T_CFG, max_steps=4, device="cpu")
    assert state.step == 4 and state.opt_state["gradient_step"] == 2
    from aria_tpu_torch.cli.train import main

    out = tmp_path / "cli"
    main(["--config", os.path.join(ROOT, "recipes", "config_lora.yaml"), "--tiny", "--cpu",
          "--max-steps", "2", "--dataset_mixer", json.dumps({make_dataset(tmp_path): 1.0}),
          "--output_dir", str(out), "--per_device_train_batch_size", "2",
          "--gradient_accumulation_steps", "1", "--max_seq_length", "64", "--dtype", "float32"])
    lines = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert len(lines) == 2 and all(np.isfinite(line["loss"]) for line in lines)


def test_load_checkpoint_defaults_to_the_card(tmp_path, monkeypatch):
    """The port's rule for entry points: the card unless the caller names
    another device; without a card the default raises and nothing falls
    back to the CPU."""
    save_checkpoint(str(tmp_path), {"w": torch.arange(3.0), "step": 2}, T_CFG, step=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint(str(tmp_path), 2)
    tree, cfg = load_checkpoint(str(tmp_path), 2, device="cpu")
    assert tree["w"].device.type == "cpu" and torch.equal(tree["w"], torch.arange(3.0))
    assert tree["step"] == 2 and cfg == T_CFG


def test_train_refuses_what_is_not_ported(tmp_path, monkeypatch):
    with pytest.raises(NotImplementedError, match="mesh_fsdp"):
        train(base_recipe(tmp_path, mesh_fsdp=2), cfg=T_CFG, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(base_recipe(tmp_path), cfg=T_CFG)
