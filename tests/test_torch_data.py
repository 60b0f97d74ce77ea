"""The port's own copies of the JAX package's jax-free trainer modules, held
to the originals on the CPU: the recipe (fields, defaults, YAML loading,
overrides), the datasets and their mixer, the chat template and its label
masking, the byte tokenizer, the vision processor (PIL's resize; the JAX
package's C++ resize switched off), the collation of text and image rows,
video sampling, and the metrics writer.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
from PIL import Image

from aria_tpu.data import chat as jchat
from aria_tpu.data import collate as jcollate
from aria_tpu.data import datasets as jdatasets
from aria_tpu.data import tokenizer as jtok
from aria_tpu.data import video as jvideo
from aria_tpu.data import vision_processor as jvp
from aria_tpu.train import recipe as jrecipe
from aria_tpu.utils import metrics as jmetrics
from aria_tpu_torch.data import chat as tchat
from aria_tpu_torch.data import collate as tcollate
from aria_tpu_torch.data import datasets as tdatasets
from aria_tpu_torch.data import tokenizer as ttok
from aria_tpu_torch.data import video as tvideo
from aria_tpu_torch.data import vision_processor as tvp
from aria_tpu_torch.train import recipe as trecipe
from aria_tpu_torch.utils import metrics as tmetrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = ["recipes/config_lora.yaml", "recipes/config_full.yaml"] + [
    f"examples/{task}/config_{kind}.yaml" for task in ("refcoco", "nlvr2", "nextqa", "code_sft")
    for kind in ("lora", "full")]


@pytest.fixture
def no_native(monkeypatch):
    """The JAX processor on its PIL path, the one the port copies."""
    monkeypatch.setattr(jvp, "_native_available", lambda: False)


def _equal_batches(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_recipe_fields_match():
    jf = [(f.name, str(f.type)) for f in dataclasses.fields(jrecipe.Recipe)]
    tf = [(f.name, str(f.type)) for f in dataclasses.fields(trecipe.Recipe)]
    assert tf == jf
    assert dataclasses.asdict(trecipe.Recipe()) == dataclasses.asdict(jrecipe.Recipe())


@pytest.mark.parametrize("path", RECIPES)
def test_load_recipe_matches(path):
    over = {"learning_rate": "1e-5", "use_peft": "false", "freeze_llm_layers": "[0, 2]",
            "dataset_mixer": '{"a": 0.5}'}
    for o in (None, over):
        got = trecipe.load_recipe(os.path.join(ROOT, path), o)
        want = jrecipe.load_recipe(os.path.join(ROOT, path), o)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(KeyError):
        trecipe.load_recipe(None, {"not_a_key": "1"})


def _write_dataset(tmp_path, name, n, images=False):
    d = tmp_path / name
    d.mkdir()
    rng = np.random.RandomState(len(name))
    rows = []
    for i in range(n):
        user = [{"type": "text", "text": f"{name} q{i}?"}]
        row = {"messages": [{"role": "user", "content": user},
                            {"role": "assistant", "content": [{"type": "text",
                                                               "text": f"a{i} " * (i + 1)}]}],
               "images": None, "video": None}
        if images and i % 2 == 0:
            img = Image.fromarray(rng.randint(0, 256, (60 + 7 * i, 90, 3), dtype=np.uint8))
            img.save(d / f"im{i}.png")
            user.insert(0, {"type": "image"})
            row["images"] = [f"im{i}.png"]
        rows.append(row)
    with open(d / "train.jsonl", "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return str(d)


def test_datasets_and_batches_match(tmp_path):
    mixer = {_write_dataset(tmp_path, "a", 7): 0.5, _write_dataset(tmp_path, "b", 5): 2}
    got, want = tdatasets.mix_datasets(mixer, seed=3), jdatasets.mix_datasets(mixer, seed=3)
    assert got == want and len(got["train"]) == 13
    for drop in (True, False):
        assert list(tdatasets.iter_batches(got["train"], 4, drop_last=drop)) == \
            list(jdatasets.iter_batches(want["train"], 4, drop_last=drop))


def test_tokenizer_and_chat_template_match(tmp_path):
    tt, jt = ttok.ByteTokenizer(), jtok.ByteTokenizer()
    text = "hi <|img|><fim_prefix>é<|im_end|>\n"
    assert tt.encode(text) == jt.encode(text)
    assert tt.decode(tt.encode(text)) == jt.decode(jt.encode(text))
    assert (tt.pad_token_id, tt.eos_token_id, tt.image_token_id, tt.vocab_size) == \
        (jt.pad_token_id, jt.eos_token_id, jt.image_token_id, jt.vocab_size)
    msgs = [[{"role": "user", "content": [{"type": "image"}, {"type": "text", "text": "what?"}]},
             {"role": "assistant", "content": [{"type": "text", "text": "a cat"}]}],
            [{"role": "user", "content": [{"type": "text", "text": "x" * 40}]},
             {"role": "assistant", "content": [{"type": "text", "text": "y"}]}]]
    for max_len in (64, 600):
        got = tchat.apply_chat_template_and_tokenize(msgs, tt, iter([2]), max_length=max_len,
                                                     max_image_size=490)
        want = jchat.apply_chat_template_and_tokenize(msgs, jt, iter([2]), max_length=max_len,
                                                      max_image_size=490)
        _equal_batches(got, want)
    assert tchat.build_inference_prompt(msgs[0], [3]) == jchat.build_inference_prompt(msgs[0],
                                                                                       [3])
    (tmp_path / "tokenizer.model").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="spm"):
        ttok.load_tokenizer(str(tmp_path))


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("size", [490, 980])
def test_vision_processor_matches(no_native, split, size):
    rng = np.random.RandomState(size)
    imgs = [Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
            for h, w in ((300, 500), (700, 200))]
    for normalize in (True, False):
        got = tvp.AriaVisionProcessor(max_image_size=size)(imgs, split_image=split,
                                                           normalize=normalize)
        want = jvp.AriaVisionProcessor(max_image_size=size)(imgs, split_image=split,
                                                            normalize=normalize)
        _equal_batches(dataclasses.asdict(got), dataclasses.asdict(want))
    assert tvp.select_best_resolution(900, 300, tvp.DEFAULT_SPLIT_RATIOS, 980) == \
        jvp.select_best_resolution(900, 300, jvp.DEFAULT_SPLIT_RATIOS, 980)


def test_collate_matches_with_images(no_native, tmp_path):
    rows = jdatasets.mix_datasets({_write_dataset(tmp_path, "img", 4, images=True): 1.0})["train"]
    got = tcollate.collate_fn(rows, ttok.ByteTokenizer(), tvp.AriaVisionProcessor(490),
                              max_length=700, max_image_size=490)
    want = jcollate.collate_fn(rows, jtok.ByteTokenizer(), jvp.AriaVisionProcessor(490),
                               max_length=700, max_image_size=490)
    _equal_batches(got, want)
    assert got["pixel_values"].shape[0] == 2


def test_video_sampling_matches(tmp_path):
    import cv2
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (32, 24))
    for i in range(12):
        writer.write(np.full((24, 32, 3), 20 * i, np.uint8))
    writer.release()
    got, want = tvideo.load_video(path, 4), jvideo.load_video(path, 4)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tvideo.count_frames(path) == jvideo.count_frames(path)
    with pytest.raises(FileNotFoundError):
        tvideo.load_video(str(tmp_path / "missing.mp4"))


def test_metrics_logger_writes_the_same_lines(tmp_path):
    lines = []
    for mod, name in ((tmetrics, "t"), (jmetrics, "j")):
        log = mod.MetricsLogger(str(tmp_path / name), echo=False)
        log.log(3, {"loss": np.float32(1.5), "grad_norm": 2})
        log.close()
        rec = json.loads(open(tmp_path / name / "metrics.jsonl").read())
        rec.pop("time")
        lines.append(rec)
        assert set(mod.StepTimer().lap(10)) == {"step_time_s", "tokens_per_s"}
    assert lines[0] == lines[1] == {"step": 3, "loss": 1.5, "grad_norm": 2.0}
    with tmetrics.profile_trace(str(tmp_path / "trace")):
        np.zeros(3).sum()
    assert os.path.exists(tmp_path / "trace" / "trace.json")
