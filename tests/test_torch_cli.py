"""The port's command-line front doors on the CPU (``--device cpu``), at
``AriaConfig.tiny()``:

- ``cli.infer``: from the same HF safetensors directory, the port's greedy
  f32 text equals ``aria_tpu.cli.infer``'s, character for character;
  ``load_model_and_tokenizer``'s other branches (a native checkpoint, a
  LoRA merge, random weights in the served form, the int8 form).
- ``cli.serve``: the builder (``build``) makes the engine ``main`` serves,
  with every flag (``--paged``, ``--json-mode``, ``--json-schema``,
  ``--logprobs``, ``--adapter``, ``--bf16``), and an HF directory's int8
  import equals ``quantize_params(fuse_shared_experts(...))``.
- ``cli.chat``: ``AriaChat`` over a scripted session, and the REPL.
- ``cli.download``: against a mocked hub (nothing is fetched).
- every CLI refuses to start without a card unless ``--device cpu``.
"""

import argparse
import dataclasses
import json

import numpy as np
import pytest
import torch
from PIL import Image

from aria_tpu.cli import infer as jinfer
from aria_tpu.config import AriaConfig as JAriaConfig
from aria_tpu_torch.checkpoint import io as tio
from aria_tpu_torch.cli import chat as tchat
from aria_tpu_torch.cli import download as tdl
from aria_tpu_torch.cli import eval as teval
from aria_tpu_torch.cli import infer as tinfer
from aria_tpu_torch.cli import serve as tserve
from aria_tpu_torch.config import AriaConfig
from aria_tpu_torch.data.tokenizer import ByteTokenizer
from aria_tpu_torch.engine.generate import Engine
from aria_tpu_torch.engine.server import BatchedEngine, PagedBatchedEngine
from aria_tpu_torch.ops import quant as tquant
from tests.test_checkpoint import synthetic_hf_state_dict
from tests.test_torch_checkpoint_io import _assert_trees_equal, _save_shards

TINY = AriaConfig.tiny()


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    sd = synthetic_hf_state_dict(JAriaConfig.tiny(), seed=5)
    return _save_shards(sd, tmp_path_factory.mktemp("cli") / "hf", n_shards=2)


def _ns(**kw):
    base = dict(model_path=None, tokenizer_path=None, lora_path=None, lora_r=8,
                lora_alpha=32.0, tiny=True, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def _text(out: str) -> str:
    """The generated text that ``main`` prints before its timing line."""
    return out.rsplit("\n\n[", 1)[0]


# ------------------------------------------------------------ infer


@pytest.mark.parametrize("prompt", ["describe the weather", "hi"])
def test_infer_prints_the_jax_cli_text(hf_dir, capsys, prompt):
    args = ["--tiny", "--greedy", "--model-path", str(hf_dir), "--prompt", prompt,
            "--max-new-tokens", "12", "--max-seq-len", "512"]
    jinfer.main(args)
    want = _text(capsys.readouterr().out)
    tinfer.main(args + ["--device", "cpu"])
    got = _text(capsys.readouterr().out)
    assert got == want and len(got) > 0


def test_infer_loads_the_reference_tree(hf_dir):
    params, cfg, tok = tinfer.load_model_and_tokenizer(_ns(model_path=str(hf_dir)))
    # the prompt's <|img|> id is the tokenizer's: ByteTokenizer's 256, not the config's 9
    assert cfg == TINY.replace(image_token_id=256) and isinstance(tok, ByteTokenizer)
    want = tio.import_hf_checkpoint(str(hf_dir), TINY, torch.float32, device="cpu")
    _assert_trees_equal(params, want)
    assert params["lm"]["layers"]["w1"].device.type == "cpu"


def test_infer_native_checkpoint_and_lora_merge(tmp_path, hf_dir):
    from aria_tpu_torch.train.lora import LoraConfig, init_lora_params, merge_lora

    base = tio.import_hf_checkpoint(str(hf_dir), TINY, torch.float32, device="cpu")
    tio.save_checkpoint(str(tmp_path / "native"), base, TINY, step=3)
    params, cfg, _ = tinfer.load_model_and_tokenizer(_ns(model_path=str(tmp_path / "native")))
    assert cfg == TINY.replace(image_token_id=256)
    _assert_trees_equal(params, base)

    lc = LoraConfig(rank=4, alpha=8.0)
    lora = init_lora_params(TINY, lc, torch.Generator().manual_seed(1), device="cpu")
    for ab in lora["lm"]["layers"].values():
        ab["b"].normal_(generator=torch.Generator().manual_seed(2))
    tio.save_checkpoint(str(tmp_path / "lora"), lora, step=1)
    merged, _, _ = tinfer.load_model_and_tokenizer(_ns(
        model_path=str(hf_dir), lora_path=str(tmp_path / "lora"), lora_r=4, lora_alpha=8.0))
    _assert_trees_equal(merged, merge_lora(base, lora, lc))
    served, _, _ = tinfer.load_model_and_tokenizer(
        _ns(model_path=str(hf_dir), lora_path=str(tmp_path / "lora"), lora_r=4,
            lora_alpha=8.0), form="int8")
    _assert_trees_equal(served, tquant.quantize_params(tquant.fuse_shared_experts(
        merge_lora(base, lora, lc), TINY.text.num_shared_experts)))


@pytest.mark.parametrize("form", [None, "bf16", "int8"])
def test_random_weights_are_drawn_in_the_served_form(form):
    """No model path: the decoder is drawn by ``init_lm_params_serving``
    straight into the served form (bf16 when none is asked for), the
    stream the serving init draws from seed 0."""
    from aria_tpu_torch.models.moe_lm import init_lm_params_serving
    from aria_tpu_torch.models.projector import init_projector_params
    from aria_tpu_torch.models.vit import init_vit_params

    params, _, _ = tinfer.load_model_and_tokenizer(_ns(), form=form)
    gen = torch.Generator().manual_seed(0)
    init_vit_params(TINY.vision, gen, device="cpu", dtype=torch.float32)
    init_projector_params(TINY.projector, gen, device="cpu", dtype=torch.float32)
    want = init_lm_params_serving(TINY.text, gen, form=form or "bf16", device="cpu",
                                  dtype=torch.float32)
    _assert_trees_equal(params["lm"], want)
    assert "shared_w1" not in params["lm"]["layers"]


def test_clis_refuse_to_start_without_a_card(monkeypatch, hf_dir, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = tmp_path / "ds"
    ds.mkdir()
    (ds / "test.jsonl").write_text("")
    calls = [
        lambda: tinfer.main(["--tiny", "--prompt", "x", "--model-path", str(hf_dir)]),
        lambda: tserve.build(tserve.parse_args(["--tiny"])),
        lambda: tchat.main(["--tiny"]),
        lambda: teval.main(["--tiny", "--task", "nlvr2", "--dataset", str(ds)]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ------------------------------------------------------------ serve


def test_serve_form_from_an_hf_dir(hf_dir):
    """The serving builder's import: an HF directory in the int8 form (the
    default without --tiny or --bf16), imported a layer at a time, equals
    the quantize-after-fuse of the whole import leaf for leaf; --tiny
    serves it fused and float, as the reference's --tiny does."""
    params, _, _ = tinfer.load_model_and_tokenizer(_ns(model_path=str(hf_dir)), form="int8")
    whole = tio.import_hf_checkpoint(str(hf_dir), TINY, torch.float32, device="cpu")
    fused = tquant.fuse_shared_experts(whole, TINY.text.num_shared_experts)
    _assert_trees_equal(params, tquant.quantize_params(fused))
    engine, tok = tserve.build(tserve.parse_args(
        ["--model-path", str(hf_dir), "--device", "cpu", "--tiny", "--max-lanes", "2",
         "--max-seq-len", "256"]))
    assert isinstance(engine, BatchedEngine) and isinstance(tok, ByteTokenizer)
    _assert_trees_equal(engine.params, fused)


def test_serve_flags(tmp_path):
    from aria_tpu_torch.train.lora import LoraConfig, init_lora_params

    lora = init_lora_params(TINY, LoraConfig(rank=4), torch.Generator().manual_seed(3),
                            device="cpu")
    tio.save_checkpoint(str(tmp_path / "ad"), lora, step=2)
    schema = tmp_path / "schema.json"
    schema.write_text(json.dumps({"type": "object", "properties": {"ok": {"type": "boolean"}},
                                  "required": ["ok"]}))
    common = ["--tiny", "--device", "cpu", "--max-lanes", "3", "--max-seq-len", "256"]
    eng, _ = tserve.build(tserve.parse_args(common))
    assert isinstance(eng, BatchedEngine) and eng.B == 3 and eng.guided_fsm is None
    assert not isinstance(eng.params["lm"]["layers"]["w1"], dict)  # --tiny: float
    eng, _ = tserve.build(tserve.parse_args(common + ["--json-mode", "--logprobs", "3"]))
    assert eng.guided_fsm is not None and eng.logprobs_topk == 3
    eng, _ = tserve.build(tserve.parse_args(common + ["--json-schema", str(schema)]))
    assert eng.guided_fsm is not None
    eng, _ = tserve.build(tserve.parse_args(
        common + ["--paged", "--page-size", "64", "--no-prefix-cache",
                  "--adapter", f"tuned={tmp_path / 'ad'}:4:16"]))
    assert isinstance(eng, PagedBatchedEngine) and not eng.prefix_cache
    assert eng.adapters.names == ["tuned"]
    assert eng.adapters.resolve("tuned") == 1
    uid = eng.submit([5, 6, 7], max_new_tokens=3, adapter="tuned")
    fin = {r.uid: r for r in eng.run_until_complete()}
    assert len(fin[uid].generated) == 3 and fin[uid].error is None


def test_serve_main_serves_what_build_builds(monkeypatch):
    seen = {}
    monkeypatch.setattr("aria_tpu_torch.engine.http_server.serve",
                        lambda engine, tok, host, port: seen.update(
                            engine=engine, host=host, port=port))
    tserve.main(["--tiny", "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
                 "--max-seq-len", "256"])
    assert isinstance(seen["engine"], BatchedEngine)
    assert (seen["host"], seen["port"]) == ("127.0.0.1", 0)


# ------------------------------------------------------------ chat

# a tiny model that takes real 490px processor output (35 x 35 patches), as
# tests/test_chat.py builds it
CHAT_CFG = TINY.replace(
    vision=dataclasses.replace(TINY.vision, image_size=490),
    projector=dataclasses.replace(TINY.projector, patch_to_query=((1225, 8),)))


@pytest.fixture(scope="module")
def chat():
    from aria_tpu_torch.models.aria import init_aria_params

    params = init_aria_params(CHAT_CFG, torch.Generator().manual_seed(0), device="cpu",
                              dtype=torch.float32)
    engine = Engine(params, CHAT_CFG, max_seq_len=1024, cache_dtype=torch.float32)
    return tchat.AriaChat(engine, ByteTokenizer(), max_image_size=490, max_new_tokens=6,
                          temperature=0.0)


class TestChat:
    def test_multi_turn_history(self, chat):
        chat.reset()
        assert isinstance(chat.ask("hi"), str)
        assert len(chat.history) == 2
        chat.ask("again")
        assert [m["role"] for m in chat.history] == ["user", "assistant", "user", "assistant"]

    def test_reset(self, chat):
        chat.reset()
        assert chat.history == [] and chat.images == []

    def test_image_attachment(self, chat):
        chat.reset()
        img = Image.fromarray(np.random.RandomState(0).randint(0, 255, (98, 98, 3), np.uint8))
        chat.add_image(img)
        chat.ask("what is this?")
        assert "image" in [c["type"] for c in chat.history[0]["content"]]
        chat.ask("and now?")  # the image stays on the first message only
        assert [c["type"] for c in chat.history[2]["content"]] == ["text"]

    def test_replies_are_the_engines_greedy_text(self, chat):
        from aria_tpu_torch.data.chat import build_inference_prompt
        from aria_tpu_torch.engine.generate import GenerationConfig

        chat.reset()
        reply = chat.ask("say something")
        prompt = build_inference_prompt([{"role": "user", "content": [
            {"type": "text", "text": "say something"}]}])
        tok = ByteTokenizer()
        res = chat.engine.generate(tok.encode(prompt), GenerationConfig(
            max_new_tokens=6, temperature=0.0, stop_token_ids=(tok.eos_token_id,)))
        assert reply == tok.decode(res.tokens).split("<|im_end|>")[0].strip()


def test_chat_repl_scripted_session(monkeypatch, capsys, tmp_path):
    img = tmp_path / "x.png"
    Image.fromarray(np.zeros((20, 30, 3), np.uint8)).save(img)
    lines = iter(["", "hello", f"/image {img}", "/reset", "bye", "/exit"])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(lines))
    asked = []
    monkeypatch.setattr(tchat.AriaChat, "ask", lambda self, text: asked.append(text) or "ok")
    tchat.main(["--tiny", "--device", "cpu", "--max-seq-len", "512"])
    out = capsys.readouterr().out
    assert asked == ["hello", "bye"]
    assert "(attached" in out and "(history cleared)" in out and out.count("ok\n") == 2


# ------------------------------------------------------------ download


class TestDownloadCLI:
    """tests/test_download.py's cases on the port's copy: the hub mocked."""

    def test_retries_then_succeeds(self, tmp_path, monkeypatch):
        calls = []

        def fake_snapshot(repo, local_dir, repo_type, token, max_workers, allow_patterns):
            calls.append((repo, local_dir, repo_type, allow_patterns))
            if len(calls) < 3:
                raise ConnectionError("transient")
            return local_dir

        monkeypatch.setattr("huggingface_hub.snapshot_download", fake_snapshot)
        monkeypatch.setattr(tdl.time, "sleep", lambda s: None)
        out = tdl.download("org/repo", str(tmp_path), "dataset", None, retries=5,
                           allow=["*.safetensors"])
        assert out == str(tmp_path) and len(calls) == 3
        assert calls[0][2] == "dataset" and calls[0][3] == ["*.safetensors"]

    def test_401_is_fatal_not_retried(self, tmp_path, monkeypatch):
        class Resp:
            status_code = 401

        def fake_snapshot(*a, **k):
            e = RuntimeError("gated")
            e.response = Resp()
            raise e

        monkeypatch.setattr("huggingface_hub.snapshot_download", fake_snapshot)
        with pytest.raises(SystemExit, match="--token"):
            tdl.download("org/private", str(tmp_path), "model", None, retries=5, allow=None)

    def test_exhausted_retries_raise(self, tmp_path, monkeypatch):
        def fake_snapshot(*a, **k):
            raise ConnectionError("down")

        monkeypatch.setattr("huggingface_hub.snapshot_download", fake_snapshot)
        monkeypatch.setattr(tdl.time, "sleep", lambda s: None)
        with pytest.raises(SystemExit, match="after 2 attempts"):
            tdl.download("org/repo", str(tmp_path), "model", None, retries=2, allow=None)

    def test_zero_egress_exits_2(self, monkeypatch, capsys):
        monkeypatch.setattr(tdl, "_has_egress", lambda **k: False)
        monkeypatch.setattr("sys.argv", ["download", "--repo", "x/y"])
        with pytest.raises(SystemExit) as ei:
            tdl.main()
        assert ei.value.code == 2
        assert "zero-egress" in capsys.readouterr().err

    def test_main_downloads_into_checkpoints(self, monkeypatch, capsys, tmp_path):
        monkeypatch.setattr(tdl, "_has_egress", lambda **k: True)
        monkeypatch.chdir(tmp_path)
        monkeypatch.setattr("huggingface_hub.snapshot_download",
                            lambda repo, local_dir, **k: local_dir)
        monkeypatch.setattr("sys.argv", ["download", "--repo", "org/m", "--allow", "*.json"])
        tdl.main()
        assert "snapshot complete: checkpoints/org/m" in capsys.readouterr().out
        assert (tmp_path / "checkpoints" / "org" / "m").is_dir()


# ------------------------------------------------------------ --tiny's MoE


@pytest.mark.parametrize("form", ["f32", "int8", "int4"])
@pytest.mark.parametrize("T", [8, 40])
def test_the_tiny_config_serves_through_the_dequantizing_moe(form, T):
    """``AriaConfig.tiny()``'s experts (I = 32, no kernel tile) serve through
    the reference's dequantizing path (moe_lm.py:1020-1044: the layer's
    experts as float stacks, gathered up to 32 tokens, grouped above), which
    is what lets ``--tiny`` run: the port's logits against the JAX
    package's at f32, for a float, an int8 and an int4 tree (relative 1e-4:
    f32 sums in another order)."""
    import jax
    import jax.numpy as jnp

    from aria_tpu.models import moe_lm as jm
    from aria_tpu.ops import quant as jq
    from aria_tpu_torch.checkpoint.from_jax import from_jax
    from aria_tpu_torch.models import moe_lm as tm

    jtext = JAriaConfig.tiny().text
    key = jax.random.PRNGKey(3)
    if form == "int4":
        jlm = jm.init_lm_params_serving_int4(key, jtext, dtype=jnp.float32)
        jlm["embed"] = jq.dequantize_weight(jlm["embed"], dtype=jnp.float32)
    else:
        jlm = jm.init_lm_params(key, jtext, dtype=jnp.float32)
        if form == "int8":
            jlm = jq.quantize_lm_params(jlm)
    toks = np.random.RandomState(T).randint(1, jtext.vocab_size, (2, T))
    want = np.asarray(jm.lm_forward(jlm, jtext, jnp.asarray(toks)).logits)
    tlm = from_jax(jax.tree.map(np.asarray, jlm), device="cpu")
    got = tm.lm_forward(tlm, TINY.text, torch.as_tensor(toks)).logits.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
