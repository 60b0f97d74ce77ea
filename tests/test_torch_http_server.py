"""The port's HTTP front door (aria_tpu_torch/engine/http_server.py) on the
tiny CPU model: every behaviour of tests/test_http_server.py (each of its
classes, the same requests and checks) through a live
``ThreadingHTTPServer`` (``http_server.HTTPServer``) over the port's
``BatchedEngine``, with ``ByteTokenizer``; ``_chat_to_prompt`` against the JAX package's on the
same messages; a greedy request's tokens against the same prompt submitted
straight to the engine; and a streamed request whose client hangs up after
its first chunk, whose lane must be free again long before its token
budget would end it (the reference's stream runs on to its budget).
"""

import base64
import io
import json
import os
import socket
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from aria_tpu.engine import http_server as jhttp
from aria_tpu_torch.config import AriaConfig
from aria_tpu_torch.data.processor import AriaProcessor, ProcessorOutput
from aria_tpu_torch.data.tokenizer import ByteTokenizer
from aria_tpu_torch.engine import http_server as thttp
from aria_tpu_torch.engine.http_server import ServingLoop, make_handler
from aria_tpu_torch.engine.server import BatchedEngine
from aria_tpu_torch.models.aria import init_aria_params

TINY = AriaConfig.tiny()


def _params(seed=0):
    return init_aria_params(TINY, torch.Generator().manual_seed(seed), device="cpu",
                            dtype=torch.float32)


def _engine(params, **kw):
    return BatchedEngine(params, TINY, max_lanes=kw.pop("max_lanes", 2), max_seq_len=128,
                         temperature=0.0, decode_chunk=4, cache_dtype=torch.float32, **kw)


class _Server:
    """A live server on 127.0.0.1 over ``loop`` (the front door's listener,
    as ``serve`` builds it); ``close()`` stops both."""

    def __init__(self, loop):
        self.loop = loop
        self.httpd = thttp.HTTPServer(("127.0.0.1", 0), make_handler(loop))
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_port}"

    def close(self):
        self.httpd.shutdown()
        self.loop.shutdown()


@pytest.fixture(scope="module")
def live():
    params = _params()
    srv = _Server(ServingLoop(_engine(params), ByteTokenizer()))
    yield srv, params
    srv.close()


@pytest.fixture(scope="module")
def server(live):
    return live[0].url


def post(url, payload, timeout=120, path="/generate"):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def get(url, path, timeout=30):
    with urllib.request.urlopen(url + path, timeout=timeout) as r:
        return json.loads(r.read())


def sse_events(url, path, payload, timeout=120):
    """POST and parse a text/event-stream response into json events."""
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            body = line[len("data: "):]
            if body == "[DONE]":
                break
            events.append(json.loads(body))
    return events


class TestHTTP:
    def test_health(self, server):
        assert get(server, "/health")["status"] == "ok"

    def test_generate(self, server):
        out = post(server, {"prompt": "hello", "max_new_tokens": 4})
        assert len(out["tokens"]) >= 1
        assert out["error"] is None

    def test_concurrent_requests(self, server):
        results = {}

        def worker(i):
            results[i] = post(server, {"prompt": f"req {i}", "max_new_tokens": 4})

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert len(results) == 4
        assert all(len(r["tokens"]) >= 1 for r in results.values())

    def test_missing_field_400(self, server):
        req = urllib.request.Request(server + "/generate", data=b"{}",
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 400

    def test_metrics(self, server):
        post(server, {"prompt": "metrics probe", "max_new_tokens": 3})
        data = get(server, "/metrics")
        assert data["requests"] >= 1
        assert data["generated_tokens"] >= 1
        assert data["tokens_per_second"] > 0

    def test_many_concurrent_clients(self, live):
        """More request threads than cores, with a short switch interval:
        every request finishes with its budget, each stream's and waiter's
        bookkeeping is released, and no lane stays busy."""
        import sys

        srv, _ = live
        before = srv.loop.metrics()["requests"]
        results, interval = {}, sys.getswitchinterval()

        def worker(i):
            if i % 3:
                results[i] = post(srv.url, {"prompt": f"n{i}", "max_new_tokens": 3,
                                            "temperature": 0.0})["tokens"]
            else:
                results[i] = [t for ev in sse_events(srv.url, "/generate", {
                    "prompt": f"s{i}", "max_new_tokens": 3, "temperature": 0.0,
                    "stream": True}) for t in ev["tokens"]]

        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(min(2 * (os.cpu_count() or 1), 40) + 4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(interval)
        assert len(results) == len(threads) and all(len(r) == 3 for r in results.values())
        assert srv.loop.metrics()["requests"] - before == len(threads)
        assert get(srv.url, "/health") == {"status": "ok", "active": 0, "queued": 0}
        loop = srv.loop
        assert not (loop._events or loop._results or loop._streams or loop._stream_reqs
                    or loop._sent or loop._abandoned)

    def test_greedy_tokens_equal_the_engines(self, live):
        """The front door adds nothing to the tokens: a greedy request over
        HTTP equals the same processed prompt submitted to an engine."""
        srv, params = live
        out = post(srv.url, {"prompt": "same tokens", "max_new_tokens": 6, "temperature": 0.0})
        ids = AriaProcessor(ByteTokenizer())("same tokens").input_ids[0].tolist()
        eng = _engine(params)
        uid = eng.submit(ids, max_new_tokens=6, stop_token_ids=(ByteTokenizer().eos_token_id,))
        fin = {r.uid: r for r in eng.run_until_complete()}
        assert out["tokens"] == fin[uid].generated


class TestStreaming:
    def test_generate_stream_matches_nonstream(self, server):
        plain = post(server, {"prompt": "stream me", "max_new_tokens": 6, "temperature": 0.0})
        events = sse_events(server, "/generate", {"prompt": "stream me", "max_new_tokens": 6,
                                                  "temperature": 0.0, "stream": True})
        toks = [t for ev in events for t in ev["tokens"]]
        text = "".join(ev["text"] for ev in events)
        assert toks[: len(plain["tokens"])] == plain["tokens"]
        assert text.startswith(plain["text"]) or plain["text"].startswith(text)

    def test_stream_delivers_incrementally(self, server):
        """Tokens arrive across several events (one a decode chunk:
        decode_chunk=4 < max_new_tokens=12)."""
        events = sse_events(server, "/generate", {"prompt": "incremental", "max_new_tokens": 12,
                                                  "temperature": 0.0, "stream": True})
        assert len(events) >= 2

    def test_dropped_stream_frees_its_lane(self):
        """A client that hangs up after its first chunk: the server's next
        writes fail, the stream's finally cancels the request, and the lane
        is free long before the 100-token budget would end it."""
        loop = ServingLoop(_engine(_params(), max_lanes=1), ByteTokenizer())
        slow = loop.engine.step

        def step():  # a tick of ~20 ms, so the budget takes ~0.5 s
            time.sleep(0.02)
            return slow()

        loop.engine.step = step
        srv = _Server(loop)
        try:
            body = json.dumps({"prompt": "drop me", "max_new_tokens": 100,
                               "temperature": 0.0, "stream": True}).encode()
            sock = socket.create_connection(("127.0.0.1", srv.httpd.server_port), timeout=30)
            sock.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\nContent-Type: application/json"
                         b"\r\nContent-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body)
            seen = b""
            while b"data: " not in seen:
                seen += sock.recv(4096)
            sock.close()
            t0 = time.perf_counter()
            while get(srv.url, "/health")["active"] and time.perf_counter() - t0 < 30:
                time.sleep(0.01)
            freed = time.perf_counter() - t0
            assert get(srv.url, "/health") == {"status": "ok", "active": 0, "queued": 0}
            fin = loop.metrics()
            # cancelled a few chunks in (the writes after the hang-up fail),
            # far from the budget of 25 chunks
            assert fin["generated_tokens"] < 40, (freed, fin)
            assert not loop._streams and not loop._events
        finally:
            srv.close()


class TestMultiLoraHTTP:
    @pytest.fixture(scope="class")
    def lora_server(self):
        from aria_tpu_torch.engine.multi_lora import AdapterRegistry
        from aria_tpu_torch.train.lora import LoraConfig, init_lora_params

        lc = LoraConfig(rank=8, alpha=16.0)
        lora = init_lora_params(TINY, lc, torch.Generator().manual_seed(7), device="cpu")["lm"]
        rng = np.random.RandomState(7)
        lora = {"layers": {name: {f: torch.from_numpy(
            rng.randn(*ab[f].shape).astype(np.float32) * 0.05) for f in ab}
            for name, ab in lora["layers"].items()}}
        reg = AdapterRegistry({"refcoco": lora}, scales={"refcoco": lc.scale}, device="cpu")
        srv = _Server(ServingLoop(_engine(_params(), adapters=reg), ByteTokenizer()))
        yield srv.url
        srv.close()

    def _chat(self, url, model, prompt="hello"):
        return post(url, {"model": model, "max_tokens": 6, "temperature": 0.0,
                          "messages": [{"role": "user", "content": prompt}]},
                    path="/v1/chat/completions")

    def test_models_lists_adapters(self, lora_server):
        ids = [m["id"] for m in get(lora_server, "/v1/models")["data"]]
        assert ids == ["aria-tpu", "refcoco"]

    def test_adapter_selected_by_model_field(self, lora_server):
        base = self._chat(lora_server, "aria-tpu")
        tuned = self._chat(lora_server, "refcoco")
        base2 = self._chat(lora_server, "aria-tpu")
        assert base["choices"][0]["message"] == base2["choices"][0]["message"]
        assert (tuned["choices"][0]["message"]["content"]
                != base["choices"][0]["message"]["content"])

    def test_unknown_model_400(self, lora_server):
        with pytest.raises(urllib.error.HTTPError) as e:
            post(lora_server, {"model": "nope", "max_tokens": 2,
                               "messages": [{"role": "user", "content": "x"}]},
                 timeout=30, path="/v1/chat/completions")
        assert e.value.code == 400


class TestStopStrings:
    def test_nonstream_stop_truncates(self, server):
        base = post(server, {"prompt": "stop test", "max_new_tokens": 8, "temperature": 0.0})
        assert len(base["text"]) >= 2
        marker = base["text"][1]
        out = post(server, {"prompt": "stop test", "max_new_tokens": 8, "temperature": 0.0,
                            "stop": marker})
        assert marker not in out["text"]
        assert out["text"] == base["text"].split(marker)[0]

    def test_stream_stop_cancels_early(self, server):
        base = post(server, {"prompt": "stream stop", "max_new_tokens": 12, "temperature": 0.0})
        marker = base["text"][1]
        events = sse_events(server, "/generate", {"prompt": "stream stop", "max_new_tokens": 12,
                                                  "temperature": 0.0, "stream": True,
                                                  "stop": [marker]})
        text = "".join(ev["text"] for ev in events)
        assert marker not in text
        assert text == base["text"].split(marker)[0]


def _png_b64(size=8):
    from PIL import Image

    img = Image.fromarray(np.random.RandomState(0).randint(0, 255, (size, size, 3), np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def _mp4_b64(frames=10):
    cv2 = pytest.importorskip("cv2")
    fd, path = tempfile.mkstemp(suffix=".mp4")
    os.close(fd)
    try:
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 5, (16, 16))
        rng = np.random.RandomState(0)
        for _ in range(frames):
            w.write(rng.randint(0, 255, (16, 16, 3), np.uint8))
        w.release()
        with open(path, "rb") as f:
            return "data:video/mp4;base64," + base64.b64encode(f.read()).decode()
    finally:
        os.unlink(path)


class TestMultimodalHTTP:
    def test_chat_to_prompt_extracts_images(self):
        prompt, images = thttp._chat_to_prompt([
            {"role": "user", "content": [
                {"type": "image_url", "image_url": {"url": _png_b64()}},
                {"type": "text", "text": "describe"},
            ]},
        ])
        assert len(images) == 1 and images[0].size == (8, 8)
        assert "<fim_prefix><|img|><fim_suffix>" in prompt
        assert prompt.endswith("<|im_start|>assistant\n")

    def test_chat_to_prompt_expands_video_to_frames(self):
        prompt, images = thttp._chat_to_prompt([
            {"role": "user", "content": [
                {"type": "video_url", "video_url": {"url": _mp4_b64()}, "num_frames": 4},
                {"type": "text", "text": "what happens?"},
            ]},
        ])
        assert len(images) == 4
        assert prompt.count("<|img|>") == 4

    def test_chat_to_prompt_matches_jax(self):
        """The same messages give the reference's prompt and images."""
        msgs = [
            {"role": "system", "content": "be brief"},
            {"role": "user", "content": [
                {"type": "image_url", "image_url": {"url": _png_b64(12)}},
                {"type": "text", "text": "and this?"},
                {"type": "image_url", "image_url": _png_b64(9)},
                {"type": "video_url", "video_url": {"url": _mp4_b64(6)}, "num_frames": 3},
            ]},
            {"role": "assistant", "content": [{"type": "text", "text": "a cat"}]},
            {"role": "user", "content": "more"},
        ]
        got, want = thttp._chat_to_prompt(msgs), jhttp._chat_to_prompt(msgs)
        assert got[0] == want[0]
        assert len(got[1]) == len(want[1]) == 5
        for a, b in zip(got[1], want[1]):
            assert np.array_equal(np.asarray(a), np.asarray(b))

    def test_images_flow_through_serving_loop(self):
        """A multimodal request travels ServingLoop -> processor -> engine
        with its pixels intact (a processor the tiny ViT can take)."""
        cfg = TINY
        loop = ServingLoop(_engine(_params(), max_lanes=1), ByteTokenizer())
        S_img = cfg.vision.image_size
        n_q = cfg.projector.query_count(cfg.vision.patches_per_side**2)
        seen = {}

        class FakeProc:
            def __call__(self, prompt, images=None, max_image_size=980):
                seen["images"] = images
                ids = [4] + [cfg.image_token_id] * n_q + [7]
                return ProcessorOutput(
                    np.asarray([ids], np.int32), np.ones((1, len(ids)), bool),
                    np.random.RandomState(3).randn(1, 3, S_img, S_img).astype(np.float32),
                    np.ones((1, S_img, S_img), bool))

        loop.processor = FakeProc()
        try:
            img = thttp._decode_image(_png_b64())
            out = loop.submit_and_wait("<|img|> describe", max_new_tokens=3, images=[img])
            assert len(out["tokens"]) >= 1 and out["error"] is None
            assert seen["images"] is not None and len(seen["images"]) == 1
        finally:
            loop.shutdown()


class TestOpenAICompat:
    def test_models(self, server):
        assert get(server, "/v1/models")["data"][0]["id"] == "aria-tpu"

    def test_completions(self, server):
        data = post(server, {"model": "aria-tpu", "prompt": "hello", "max_tokens": 4,
                             "temperature": 0.0}, path="/v1/completions")
        assert data["object"] == "text_completion"
        assert data["choices"][0]["finish_reason"] in ("stop", "length")
        assert data["usage"]["completion_tokens"] >= 1
        assert isinstance(data["choices"][0]["text"], str)

    def test_chat_completions(self, server):
        data = post(server, {"model": "aria-tpu",
                             "messages": [{"role": "user", "content": "hi there"}],
                             "max_tokens": 4, "temperature": 0.0}, path="/v1/chat/completions")
        assert data["object"] == "chat.completion"
        msg = data["choices"][0]["message"]
        assert msg["role"] == "assistant" and isinstance(msg["content"], str)

    def test_logprobs_field(self):
        """Completions ``logprobs`` returns token strings and logprobs when
        the engine is deployed with logprobs_topk: the loop's top-2 by id,
        keyed by each id's decoded string (as the reference keys them, so
        ids that decode alike, as ByteTokenizer's ids past its bytes and
        specials do, share one key)."""
        tok = ByteTokenizer()
        srv = _Server(ServingLoop(_engine(_params(), max_lanes=1, logprobs_topk=2), tok))
        try:
            data = post(srv.url, {"prompt": "lp", "max_tokens": 4, "temperature": 0.0,
                                  "logprobs": 2}, path="/v1/completions")
            lp = data["choices"][0]["logprobs"]
            assert len(lp["token_logprobs"]) == len(lp["tokens"]) == 4
            assert all(v <= 0 for v in lp["token_logprobs"])
            direct = srv.loop.submit_and_wait("lp", 4, 0.0)
            assert direct["logprobs"] == lp["token_logprobs"]
            assert all(len(d) == 2 for d in direct["top_logprobs"])
            assert lp["top_logprobs"] == [{tok.decode([t]): v for t, v in d.items()}
                                          for d in direct["top_logprobs"]]
        finally:
            srv.close()

    def test_n_choices(self, server):
        data = post(server, {"model": "aria-tpu", "prompt": "pick n", "max_tokens": 4,
                             "temperature": 0.0, "n": 3}, timeout=180, path="/v1/completions")
        assert [c["index"] for c in data["choices"]] == [0, 1, 2]
        assert len({c["text"] for c in data["choices"]}) == 1
        assert data["usage"]["completion_tokens"] == sum(4 for _ in data["choices"])

    def test_chat_completions_stream(self, server):
        events = sse_events(server, "/v1/chat/completions", {
            "model": "aria-tpu", "messages": [{"role": "user", "content": "stream chat"}],
            "max_tokens": 6, "temperature": 0.0, "stream": True})
        assert events[0]["choices"][0]["delta"].get("role") == "assistant"
        assert events[-1]["choices"][0]["finish_reason"] == "stop"
        content = "".join(ev["choices"][0]["delta"].get("content", "") for ev in events)
        assert isinstance(content, str)
        assert all(ev["object"] == "chat.completion.chunk" for ev in events)

    def test_guided_json_mode(self):
        """``response_format={"type": "json_object"}`` decodes under the
        engine's JSON FSM (serve --json-mode): the text is a JSON object or,
        cut by its budget, a live prefix of the grammar."""
        from aria_tpu_torch.engine.guided import json_dfa, json_fsm

        tok = ByteTokenizer()
        fsm = json_fsm(tok, [tok.eos_token_id], vocab_size=TINY.text.vocab_size, device="cpu")
        srv = _Server(ServingLoop(_engine(_params(), max_lanes=1, guided_fsm=fsm), tok))
        try:
            data = post(srv.url, {"prompt": "json", "max_tokens": 24, "temperature": 0.0,
                                  "response_format": {"type": "json_object"}},
                        path="/v1/completions")
            text = data["choices"][0]["text"].encode()
            assert json_dfa().simulate(text) >= 0, text
        finally:
            srv.close()


class TestHTTPSamplingParams:
    def test_repetition_penalty_changes_output(self, server):
        base = post(server, {"prompt": "hello", "max_new_tokens": 8})
        pen = post(server, {"prompt": "hello", "max_new_tokens": 8,
                            "repetition_penalty": 1e6})
        toks = pen["tokens"]
        assert len(set(toks)) == len(toks), toks
        assert base["error"] is None and pen["error"] is None

    def test_oai_chat_accepts_sampling_params(self, server):
        out = post(server, {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4,
                            "temperature": 0.7, "top_p": 0.9, "min_p": 0.01,
                            "presence_penalty": 0.5, "frequency_penalty": 0.5},
                   path="/v1/chat/completions")
        assert out["choices"][0]["message"]["content"] is not None
