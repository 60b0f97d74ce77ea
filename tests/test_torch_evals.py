"""The port's copies of the JAX package's jax-free front-door modules, held
to the originals on the same inputs (CPU): ``data/spm.py`` (and
``load_tokenizer``'s sentencepiece branch), ``data/processor.py``,
``data/pdf.py``, ``evals/parsers.py``, ``evals/code_exec.py`` and
``evals/runner.py``; then ``cli/eval.py`` with a mocked generate and end to
end on the tiny engine.
"""

import dataclasses
import json
import random

import numpy as np
import pytest
import torch
from PIL import Image

from aria_tpu.data import pdf as jpdf
from aria_tpu.data import processor as jproc
from aria_tpu.data import spm as jspm
from aria_tpu.data import tokenizer as jtok
from aria_tpu.data import vision_processor as jvp
from aria_tpu.evals import code_exec as jcode
from aria_tpu.evals import parsers as jparsers
from aria_tpu.evals import runner as jrunner
from aria_tpu_torch.cli import eval as teval
from aria_tpu_torch.config import AriaConfig
from aria_tpu_torch.data import pdf as tpdf
from aria_tpu_torch.data import processor as tproc
from aria_tpu_torch.data import spm as tspm
from aria_tpu_torch.data import tokenizer as ttok
from aria_tpu_torch.evals import code_exec as tcode
from aria_tpu_torch.evals import parsers as tparsers
from aria_tpu_torch.evals import runner as trunner
from tests.test_spm import tiny_pieces

TEXTS = ["hello world", "  hello   world ", "hellowor ld!", "héllo ✓ wörld", "",
         "<|img|>hello<|im_start|>world<|im_end|>", "abc\ndef\tghi", "hello" * 20]


# ------------------------------------------------------------ spm


@pytest.fixture(scope="module")
def spm_pair():
    pieces = tiny_pieces()
    data = jspm.encode_model_proto(pieces)
    assert tspm.encode_model_proto(pieces) == data
    base = len(pieces)
    added = {"<|img|>": base, "<|im_start|>": base + 1, "<|im_end|>": base + 2}
    return (tspm.SentencePieceTokenizer(tspm.parse_model_proto(data), added_tokens=added),
            jspm.SentencePieceTokenizer(jspm.parse_model_proto(data), added_tokens=added))


def test_spm_copy_matches_the_original(spm_pair):
    t, j = spm_pair
    assert t.pieces == j.pieces and t.vocab_size == j.vocab_size
    for text in TEXTS:
        ids = t.encode(text)
        assert ids == j.encode(text), text
        assert t.decode(ids) == j.decode(ids)
    assert t._segment(tspm.WS + "hellowor") == j._segment_py(jspm.WS + "hellowor")
    assert ([t.token_bytes(i) for i in range(t.vocab_size)]
            == [j.token_bytes(i) for i in range(j.vocab_size)])
    assert (t.pad_token_id, t.image_token_id) == (j.pad_token_id, j.image_token_id)


@pytest.mark.parametrize("added", ["added_tokens.json", "tokenizer_config.json"])
def test_load_tokenizer_reads_a_sentencepiece_dir(tmp_path, spm_pair, monkeypatch, added):
    """The third branch: tokenizer.model with added_tokens.json or
    tokenizer_config.json, as the card's machine needs (no transformers)."""
    (tmp_path / "tokenizer.model").write_bytes(jspm.encode_model_proto(tiny_pieces()))
    base = len(tiny_pieces())
    names = {"<|img|>": base, "<|im_start|>": base + 1, "<|im_end|>": base + 2}
    if added == "added_tokens.json":
        (tmp_path / added).write_text(json.dumps(names))
    else:
        (tmp_path / added).write_text(json.dumps({"added_tokens_decoder": {
            str(i): {"content": n} for n, i in names.items()}}))

    def no_transformers(*a, **k):
        raise ImportError("transformers")

    monkeypatch.setattr(ttok.HFTokenizer, "__init__", no_transformers)
    monkeypatch.setattr(jtok.HFTokenizer, "__init__", no_transformers)
    got, want = ttok.load_tokenizer(str(tmp_path)), jtok.load_tokenizer(str(tmp_path))
    assert isinstance(got, tspm.SentencePieceTokenizer)
    for text in TEXTS:
        assert got.encode(text) == want.encode(text) == spm_pair[0].encode(text)
    assert got.image_token_id == base
    with pytest.raises(FileNotFoundError):
        ttok.load_tokenizer(str(tmp_path / "nope"))


# ------------------------------------------------------------ processor, pdf


def _image(h, w, seed):
    return Image.fromarray(np.random.RandomState(seed).randint(0, 255, (h, w, 3), np.uint8))


@pytest.mark.parametrize("max_size,split", [(980, False), (490, True), (490, False)])
def test_processor_copy_matches_the_original(monkeypatch, max_size, split):
    # the JAX vision processor on its PIL path, the one the port copies
    # (tests/test_torch_data.py's ``no_native``)
    monkeypatch.setattr(jvp, "_native_available", lambda: False)
    tok_t, tok_j = ttok.ByteTokenizer(), jtok.ByteTokenizer()
    prompts = ["<fim_prefix><|img|><fim_suffix>what is this?",
               "two <|img|> images <|img|> here"]
    images = [_image(300, 700, 0), _image(500, 200, 1), _image(64, 64, 2)]
    got = tproc.AriaProcessor(tok_t)(prompts, images=images, max_image_size=max_size,
                                     split_image=split, pad_to_multiple=8)
    want = jproc.AriaProcessor(tok_j)(prompts, images=images, max_image_size=max_size,
                                      split_image=split, pad_to_multiple=8)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    text_only = tproc.AriaProcessor(tok_t)("plain text")
    assert text_only.pixel_values is None
    assert np.array_equal(text_only.input_ids,
                          jproc.AriaProcessor(tok_j)("plain text").input_ids)


def test_pdf_copy_matches_the_original(tmp_path, monkeypatch):
    """Both raise the same actionable error when no rasterizer is present,
    and rasterize through the same stack when one is (pdftoppm stubbed)."""
    import builtins
    import shutil

    real_import = builtins.__import__

    def no_rasterizers(name, *a, **k):
        if name in ("pdf2image", "pypdfium2"):
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_rasterizers)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    errors = []
    for mod in (tpdf, jpdf):
        with pytest.raises(RuntimeError) as e:
            mod.load_pdf_pages(str(tmp_path / "x.pdf"))
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "pdftoppm" in errors[0]

    def fake_run(cmd, check):
        out = cmd[-1]
        for i in range(3):
            _image(20, 10 + i, i).save(f"{out}-{i + 1}.png")

    monkeypatch.setattr(shutil, "which", lambda name: "/bin/pdftoppm")
    monkeypatch.setattr("subprocess.run", fake_run)
    pages = [mod.load_pdf_pages(str(tmp_path / "x.pdf"), max_pages=3) for mod in (tpdf, jpdf)]
    assert [p.size for p in pages[0]] == [p.size for p in pages[1]] == [(10, 20), (11, 20),
                                                                         (12, 20)]


# ------------------------------------------------------------ evals


PREDS = ["[12, 40, 300, 500]", "the box is (0.1,0.2,0.3,0.4)", "nothing here", "Yes.",
         "no, it is not", "(B) because", "Answer: C", "a cat", "D. the dog", "", "B",
         "I think the answer is A or maybe B"]


def test_parsers_copy_matches_the_original():
    for p in PREDS:
        for fn in ("parse_bbox", "parse_yes_no"):
            assert getattr(tparsers, fn)(p) == getattr(jparsers, fn)(p), (fn, p)
        choices, index2ans = ["A", "B", "C", "D"], {"A": "a cat", "B": "the dog",
                                                    "C": "a bird", "D": "a fish"}
        assert (tparsers.parse_multi_choice(p, choices, index2ans, random.Random(3))
                == jparsers.parse_multi_choice(p, choices, index2ans, random.Random(3)))
    rng = np.random.RandomState(0)
    for _ in range(20):
        a, b = rng.rand(4) * 500, rng.rand(4) * 500
        assert tparsers.box_iou(a, b) == jparsers.box_iou(a, b)
    ref = [{"pred": p, "bbox": [10, 30, 200, 400], "hw": [600, 800]} for p in PREDS]
    assert tparsers.refcoco_score(ref) == jparsers.refcoco_score(ref)
    yn = [{"pred": p, "gt": g} for p, g in zip(PREDS, ["yes", "no"] * 6)]
    assert tparsers.nlvr2_score(yn) == jparsers.nlvr2_score(yn)
    mc = [{"pred": p, "gt": g} for p, g in zip("ABCDAB", ["A", "B", ["C", "D"], "D", "B", "B"])]
    assert tparsers.multi_choice_score(mc) == jparsers.multi_choice_score(mc)


def test_code_exec_copy_matches_the_original():
    problem = {"prompt": "def add(a, b):\n",
               "test": "def check(candidate):\n    assert candidate(1, 2) == 3\n",
               "entry_point": "add"}
    samples = [{"task_id": "t0", "completion": c}
               for c in ("    return a + b\n", "    return a * b\n",
                         "    import os; os.system('true'); return a + b\n")]
    for mod in (tcode, jcode):
        res = mod.check_correctness("    return a - b\n", problem["test"], entry_point="add",
                                    prompt=problem["prompt"])
        assert not res["passed"] and "AssertionError" in res["result"]
    assert (tcode.evaluate_functional_correctness(samples, {"t0": problem}, k_values=(1, 2))
            == jcode.evaluate_functional_correctness(samples, {"t0": problem},
                                                     k_values=(1, 2)))
    assert all(tcode.pass_at_k(n, c, k) == jcode.pass_at_k(n, c, k)
               for n, c, k in ((1, 1, 1), (10, 3, 1), (4, 2, 2), (7, 0, 3)))


def _dataset(tmp_path, task):
    """A small local eval set of each task, images on disk."""
    img = tmp_path / "img.png"
    _image(98, 98, 4).save(img)
    rows = []
    for i, gt in enumerate(["yes", "no", "yes"]):
        row = {"messages": [
            {"role": "user", "content": [{"type": "image", "text": None},
                                         {"type": "text", "text": f"question {i}?"}]},
            {"role": "assistant", "content": [{"type": "text", "text": gt}]}],
            "images": [str(img)], "video": None}
        if task == "refcoco":
            row.update(bbox=[10, 10, 50, 60], hw=[98, 98])
        if task == "nextqa":
            row.update(index2ans={"A": "yes", "B": "no"}, all_choices=["A", "B"])
        rows.append(row)
    d = tmp_path / task
    d.mkdir()
    (d / "train.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(d)


@pytest.mark.parametrize("task", ["refcoco", "nlvr2", "nextqa"])
def test_runner_copy_matches_the_original(tmp_path, task):
    ds = _dataset(tmp_path, task)
    outs = iter(["yes", "[10, 10, 500, 600]", "B"] * 2)
    answers = {}

    def fake(prompt, images):
        assert prompt.endswith("<|im_start|>assistant\n") and len(images) == 1
        return answers.setdefault(prompt, next(outs))

    assert (trunner.run_eval(task, ds, fake, limit=2)
            == jrunner.run_eval(task, ds, fake, limit=2))


def test_eval_cli_with_a_mocked_generate(tmp_path, monkeypatch, capsys):
    ds = _dataset(tmp_path, "nlvr2")

    def fake_fn(engine, tokenizer, **kw):
        assert kw == {"max_image_size": 490, "split_image": False, "max_new_tokens": 5}
        return lambda prompt, images: "yes" if "question 0" in prompt else "maybe"

    monkeypatch.setattr("aria_tpu_torch.evals.runner.make_engine_generate_fn", fake_fn)
    teval.main(["--tiny", "--device", "cpu", "--task", "nlvr2", "--dataset", ds,
                "--max-image-size", "490", "--max-new-tokens", "5", "--max-seq-len", "512"])
    want = tparsers.nlvr2_score([{"pred": p, "gt": g} for p, g in
                                 zip(["yes", "maybe", "maybe"], ["yes", "no", "yes"])])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == want


def test_eval_end_to_end_on_the_tiny_engine(tmp_path, capsys):
    """``make_engine_generate_fn`` over the port's ``Engine`` (the tiny model
    at 490px crops): each prediction is the engine's greedy text for the
    processed prompt, and the CLI's metric is the runner's on them."""
    from aria_tpu_torch.data.processor import AriaProcessor
    from aria_tpu_torch.engine.generate import Engine, GenerationConfig
    from aria_tpu_torch.models.aria import init_aria_params

    tiny = AriaConfig.tiny()
    cfg = tiny.replace(vision=dataclasses.replace(tiny.vision, image_size=490),
                       projector=dataclasses.replace(tiny.projector,
                                                     patch_to_query=((1225, 8),)))
    params = init_aria_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                              dtype=torch.float32)
    engine = Engine(params, cfg, max_seq_len=1024, cache_dtype=torch.float32)
    tok = ttok.ByteTokenizer()
    gen_fn = trunner.make_engine_generate_fn(engine, tok, max_image_size=490, max_new_tokens=4)
    ds = _dataset(tmp_path, "nlvr2")
    preds = []
    metrics = trunner.run_eval("nlvr2", ds, lambda p, i: preds.append(gen_fn(p, i)) or preds[-1])
    assert len(preds) == 3 and "acc" in metrics
    row = json.loads(open(f"{ds}/train.jsonl").readline())
    prompt = trunner._render(row, [1])
    out = AriaProcessor(tok)(prompt, images=trunner._load_images(row), max_image_size=490)
    res = engine.generate(out.input_ids[0].tolist(), GenerationConfig(
        max_new_tokens=4, temperature=0.0, top_k=None, stop_token_ids=(tok.eos_token_id,)),
        pixel_values=out.pixel_values, pixel_mask=out.pixel_mask)
    assert preds[0] == tok.decode(res.tokens).split("<|im_end|>")[0]
