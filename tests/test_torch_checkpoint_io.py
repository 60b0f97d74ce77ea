"""The port's HF imports against the JAX package's, on the CPU.

- The reader (``SafetensorsDir``) against ``safetensors.safe_open`` on
  shards that ``safetensors`` writes, for every dtype it supports and for
  first-axis slices; ``chip_smoke.py``'s writer read back by
  ``safetensors``.
- ``import_hf_state_dict`` against the JAX one on
  ``tests/test_checkpoint.py:synthetic_hf_state_dict(AriaConfig.tiny())``,
  leaf for leaf and bit-equal in f32 (the import only permutes, transposes
  and stacks).
- ``import_hf_lm_serving_int4`` against the JAX streamed import, fused and
  not, at ``expert_chunk`` 4: packed bytes equal byte for byte and the
  scales bit-equal; and against the port's own
  ``quantize_lm_params_int4(fuse_shared_experts(import_hf_state_dict(...)))``.
- ``import_hf_serving`` (the serving CLI's import, a layer at a time)
  against ``quantize_params(fuse_shared_experts(import_hf_checkpoint(...)))``.
- ``train/loop.py:build_params`` from a safetensors directory.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from aria_tpu.checkpoint import io as jio
from aria_tpu.config import AriaConfig as JAriaConfig
from aria_tpu.ops import quant as jquant
from aria_tpu_torch.checkpoint import io as tio
from aria_tpu_torch.checkpoint.from_jax import from_jax
from aria_tpu_torch.config import config_from_dict
from aria_tpu_torch.ops import quant as tquant
from aria_tpu_torch.train.loop import build_params
from aria_tpu_torch.train.recipe import Recipe
from tests.test_checkpoint import synthetic_hf_state_dict

JCFG = JAriaConfig.tiny()
CFG = config_from_dict(dataclasses.asdict(JCFG))


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bit patterns, so that equality is bit-equality."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.contiguous().view(ints[t.element_size()])


def _assert_trees_equal(got, want, path="") -> int:
    """Bit-equal, leaf for leaf, with the same keys, dtypes and shapes;
    returns the number of leaves."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        return sum(_assert_trees_equal(got[k], want[k], f"{path}/{k}") for k in want)
    assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype,
                                                                 got.shape, want.shape)
    assert torch.equal(_bits(got), _bits(want)), path
    return 1


def _from_jax(tree):
    return from_jax(jax.tree.map(np.asarray, tree), device="cpu")


def _save_shards(sd, path, n_shards=3, framework="numpy"):
    """Write the dict as several .safetensors shards (the name index)."""
    path.mkdir(parents=True, exist_ok=True)
    names = sorted(sd)
    per = -(-len(names) // n_shards)
    for s in range(n_shards):
        shard = {k: sd[k] for k in names[s * per:(s + 1) * per]}
        if not shard:
            continue
        if framework == "numpy":
            from safetensors.numpy import save_file
        else:
            from safetensors.torch import save_file
        save_file(shard, str(path / f"model-{s:05d}.safetensors"))
    return path


@pytest.fixture(scope="module")
def hf(tmp_path_factory):
    sd = synthetic_hf_state_dict(JCFG)
    return sd, _save_shards(sd, tmp_path_factory.mktemp("hf") / "ckpt")


# ------------------------------------------------------------ the reader

DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
          "I8": torch.int8, "U8": torch.uint8, "I32": torch.int32, "I64": torch.int64}


def _sample(dtype, shape, rng):
    x = torch.from_numpy(np.array(rng.randn(*shape) * 50, np.float32))
    return x.to(dtype)


@pytest.mark.parametrize("name", list(DTYPES))
def test_reader_matches_safe_open(tmp_path, name):
    from safetensors import safe_open
    from safetensors.torch import save_file

    dtype = DTYPES[name]
    rng = np.random.RandomState(sorted(DTYPES).index(name))
    tensors = {"a": _sample(dtype, (7, 5, 3), rng), "b": _sample(dtype, (11,), rng),
               "c": _sample(dtype, (4, 6), rng), "empty": _sample(dtype, (0, 3), rng),
               "scalar": _sample(dtype, (), rng)}
    save_file(tensors, str(tmp_path / "x.safetensors"), metadata={"format": "pt"})
    st = tio.SafetensorsDir(str(tmp_path))
    assert sorted(st.keys()) == sorted(tensors)
    with safe_open(str(tmp_path / "x.safetensors"), framework="pt") as f:
        for k in tensors:
            got, want = st.get(k), f.get_tensor(k)
            assert got.dtype == want.dtype == dtype and got.shape == want.shape
            assert torch.equal(_bits(got), _bits(want)), k
        for k, lo, hi in (("a", 0, 7), ("a", 2, 5), ("a", 6, 7), ("a", 3, 3), ("c", 1, 4),
                          ("b", 4, 11)):
            got, want = st.get_slice(k, lo, hi), f.get_slice(k)[lo:hi]
            assert got.shape == want.shape and torch.equal(_bits(got), _bits(want)), (k, lo, hi)


def test_reader_indexes_shards_and_numpy_files(hf):
    from safetensors import safe_open

    sd, path = hf
    st = tio.SafetensorsDir(str(path))
    assert sorted(st.keys()) == sorted(sd)
    assert len({st.index[k] for k in sd}) == 3
    for k in ("language_model.model.layers.1.mlp.experts.fc1.weight",
              "vision_tower.vision_model.embeddings.patch_embedding.weight"):
        assert np.array_equal(st[k].numpy(), sd[k])
        with safe_open(str(path / st.index[k]), framework="np") as f:
            assert np.array_equal(st.get_slice(k, 2, 5).numpy(), f.get_slice(k)[2:5])
    assert sorted(tio.load_safetensors_dir(str(path))) == sorted(sd)
    (path.parent / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        tio.SafetensorsDir(str(path.parent / "empty"))


def test_chip_smoke_writer_is_read_by_safetensors(tmp_path):
    from safetensors import safe_open

    rng = np.random.RandomState(3)
    tensors = {f"t.{name}": _sample(dtype, (5, 4), rng) for name, dtype in DTYPES.items()}
    tensors["w.t"] = _sample(torch.bfloat16, (6, 8), rng).T  # a transposed view
    nbytes = chip_smoke._write_safetensors(str(tmp_path / "w.safetensors"), tensors)
    assert nbytes == sum(t.numel() * t.element_size() for t in tensors.values())
    with safe_open(str(tmp_path / "w.safetensors"), framework="pt") as f:
        assert sorted(f.keys()) == sorted(tensors)
        for k, t in tensors.items():
            got = f.get_tensor(k)
            assert got.dtype == t.dtype and torch.equal(_bits(got), _bits(t)), k


# ------------------------------------------------------------ whole import


@pytest.mark.parametrize("source", ["dict", "dir"])
def test_whole_import_matches_jax(hf, source):
    sd, path = hf
    want = _from_jax(jio.import_hf_state_dict(sd, JCFG, dtype=jnp.float32))
    src = sd if source == "dict" else tio.SafetensorsDir(str(path))
    got = tio.import_hf_state_dict(src, CFG, torch.float32, device="cpu")
    assert _assert_trees_equal(got, want) == 49
    # the tree owns its memory: nothing aliases the mapped shards or the dict
    got["lm"]["embed"].add_(1.0)
    assert np.array_equal(tio.SafetensorsDir(str(path))["language_model.model.embed_tokens"
                                                        ".weight"].numpy(),
                          sd["language_model.model.embed_tokens.weight"])


def test_whole_import_keeps_the_gate_f32(hf):
    sd, path = hf
    got = tio.import_hf_checkpoint(str(path), CFG, torch.bfloat16, device="cpu")
    want = _from_jax(jio.import_hf_state_dict(sd, JCFG, dtype=jnp.bfloat16))
    assert got["lm"]["layers"]["gate"].dtype == torch.float32
    assert got["lm"]["layers"]["w1"].dtype == torch.bfloat16
    _assert_trees_equal(got, want)


def test_imports_build_on_the_card_or_raise(hf, monkeypatch):
    sd, path = hf
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda **kw: tio.import_hf_state_dict(sd, CFG, torch.float32, **kw),
        lambda **kw: tio.import_hf_checkpoint(str(path), CFG, torch.float32, **kw),
        lambda **kw: tio.import_hf_lm_serving_int4(str(path), CFG.text, expert_chunk=4, **kw),
        lambda **kw: tio.import_hf_serving(str(path), CFG, dtype=torch.float32, **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(device="cpu")


# ------------------------------------------------------------ streamed int4


@pytest.mark.parametrize("fuse", [True, False])
def test_streamed_int4_import_matches_jax(hf, fuse):
    _, path = hf
    want = _from_jax(jio.import_hf_lm_serving_int4(str(path), JCFG.text, fuse_shared=fuse,
                                                   expert_chunk=4, layer_chunk=1))
    got = tio.import_hf_lm_serving_int4(str(path), CFG.text, fuse_shared=fuse, expert_chunk=4,
                                        layer_chunk=1, device="cpu")
    assert _assert_trees_equal(got, want) == (16 if fuse else 20)
    assert got["layers"]["w1"]["q4"].shape[1] == CFG.text.num_experts + (2 if fuse else 0)


@pytest.mark.parametrize("fuse", [True, False])
def test_streamed_int4_import_equals_quantize_after_import(hf, fuse):
    _, path = hf
    params = tio.import_hf_checkpoint(str(path), CFG, torch.bfloat16, device="cpu")
    if fuse:
        params = tquant.fuse_shared_experts(params, CFG.text.num_shared_experts)
    want = tquant.quantize_lm_params_int4(params["lm"])
    for expert_chunk, layer_chunk in ((None, 4), (2, 1)):
        got = tio.import_hf_lm_serving_int4(str(path), CFG.text, fuse_shared=fuse,
                                            expert_chunk=expert_chunk, layer_chunk=layer_chunk,
                                            device="cpu")
        _assert_trees_equal(got, want)


def test_quantize_lm_params_int4_matches_jax(hf):
    sd, _ = hf
    jp = jio.import_hf_state_dict(sd, JCFG, dtype=jnp.bfloat16)
    jp = jquant.fuse_shared_experts(jp, JCFG.text.num_shared_experts)
    want = _from_jax(jquant.quantize_lm_params_int4(jp["lm"]))
    got = tquant.quantize_lm_params_int4(_from_jax(jp)["lm"])
    assert _assert_trees_equal(got, want) == 16


def test_streamed_import_refuses_a_chunk_that_does_not_divide(hf):
    _, path = hf
    with pytest.raises(ValueError, match="does not divide"):
        tio.import_hf_lm_serving_int4(str(path), CFG.text, expert_chunk=3, device="cpu")


# ------------------------------------------------------------ serving import


@pytest.mark.parametrize("form", ["int8", "bf16"])
def test_serving_import_equals_quantize_after_fuse(hf, form):
    _, path = hf
    params = tquant.fuse_shared_experts(
        tio.import_hf_checkpoint(str(path), CFG, torch.bfloat16, device="cpu"),
        CFG.text.num_shared_experts)
    want = tquant.quantize_params(params) if form == "int8" else params
    got = tio.import_hf_serving(str(path), CFG, form=form, device="cpu")
    _assert_trees_equal(got, want)
    assert "shared_w1" not in got["lm"]["layers"]


# ------------------------------------------------------------ the trainer


def test_build_params_imports_a_safetensors_dir(hf):
    sd, path = hf
    got = build_params(Recipe(model_path=str(path)), CFG, torch.float32, torch.device("cpu"))
    want = _from_jax(jio.import_hf_state_dict(sd, JCFG, dtype=jnp.float32))
    _assert_trees_equal(got, want)
