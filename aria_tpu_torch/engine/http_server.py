"""HTTP serving frontend over the continuous-batching engine (the port's
counterpart of aria_tpu/engine/http_server.py, every route and field kept).

The reference delegates production serving to vLLM (docs/inference.md:80-149);
this is the equivalent front door here: a stdlib HTTP server that enqueues
requests into a BatchedEngine/PagedBatchedEngine and a scheduler thread that
drives decode chunks. Requests join/leave the batch mid-flight; streaming
responses deliver tokens per decode chunk; abandoned requests are cancelled
so they stop burning lane time (vLLM abort_request parity).

Native API:
    POST /generate {"prompt": str, "max_new_tokens": int, "temperature": float,
                    "stream": bool}
      -> {"text": str, "tokens": [...], "uid": int}
      -> (stream) text/event-stream of {"text": delta, "tokens": [...]} + [DONE]
    GET /health  -> {"status": "ok", "active": n, "queued": m}
    GET /metrics -> request/token counters, throughput, prefix-cache stats

OpenAI-compatible API (the de-facto serving surface vLLM exposes):
    GET  /v1/models
    POST /v1/completions       {"prompt", "max_tokens", "temperature", "stream"}
    POST /v1/chat/completions  {"messages": [{"role", "content"}], ...}
Chat messages use the ChatML template (data/chat.py, reference aria/data.py
format); string and [{"type": "text"}] content are both accepted.

The scheduler thread is the only caller of ``engine.step()`` (which runs
under ``torch.inference_mode()``); a request thread's ``submit`` and
``cancel`` take the loop's lock and run under ``torch.inference_mode()``
too, so no engine call records an autograd graph and a lane's tensors,
made in inference mode, may be written in place from either thread.
"""

from __future__ import annotations

import json
import queue as queue_mod
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import torch

MODEL_ID = "aria-tpu"


class ServingLoop:
    """Drives BatchedEngine.step() on a dedicated thread; callers block on
    per-request events or consume per-request streaming queues."""

    def __init__(self, engine, tokenizer, max_image_size: int = 980):
        from aria_tpu_torch.data.processor import AriaProcessor

        self.engine = engine
        self.tokenizer = tokenizer
        self.processor = AriaProcessor(tokenizer)
        self.max_image_size = max_image_size
        self._lock = threading.Lock()
        self._events: Dict[int, threading.Event] = {}
        self._results: Dict[int, object] = {}
        self._streams: Dict[int, queue_mod.Queue] = {}
        self._stream_reqs: Dict[int, object] = {}
        self._sent: Dict[int, int] = {}
        self._abandoned: set = set()
        self.stats = {"requests": 0, "generated_tokens": 0,
                      "prompt_tokens": 0, "started": time.time()}
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop:
            with self._lock:
                finished = self.engine.step()
                # push per-chunk token deltas to streaming consumers BEFORE
                # the EOS sentinel below, so the final chunk is never lost
                for uid, q in list(self._streams.items()):
                    req = self._stream_reqs[uid]
                    sent = self._sent[uid]
                    if len(req.generated) > sent:
                        q.put(list(req.generated[sent:]))
                        self._sent[uid] = len(req.generated)
                idle = not self.engine.queue and not self.engine._active_mask().any()
            for req in finished:
                self.stats["requests"] += 1
                self.stats["generated_tokens"] += len(req.generated)
                self.stats["prompt_tokens"] += len(req.prompt_tokens)
                q = self._streams.pop(req.uid, None)
                if q is not None:
                    self._stream_reqs.pop(req.uid, None)
                    self._sent.pop(req.uid, None)
                    q.put(None)  # EOS sentinel
                    continue
                if req.uid in self._abandoned:  # timed-out caller: discard
                    self._abandoned.discard(req.uid)
                    continue
                self._results[req.uid] = req
                ev = self._events.pop(req.uid, None)
                if ev:
                    ev.set()
            # yield between ticks: the lock is not fair, and a request
            # thread's submit or cancel waiting on it would otherwise lose
            # it to the next tick, tick after tick
            time.sleep(0.005 if idle else 0)

    # ------------------------------------------------------------ submit

    def _submit(self, prompt: str, max_new_tokens: int,
                temperature: Optional[float], guided: bool = False,
                adapter: Optional[str] = None, images=None, sampling=None):
        out = self.processor(prompt, images=images or None,
                             max_image_size=self.max_image_size)
        stop_ids = tuple(
            t for t in [getattr(self.tokenizer, "eos_token_id", None)]
            if t is not None
        )
        with torch.inference_mode():
            uid = self.engine.submit(
                out.input_ids[0].tolist(), max_new_tokens=max_new_tokens,
                stop_token_ids=stop_ids, temperature=temperature, guided=guided,
                adapter=adapter,
                pixel_values=out.pixel_values, pixel_mask=out.pixel_mask,
                **(sampling or {}),
            )
        return uid, self.engine.queue[-1]

    def submit_and_wait(self, prompt: str, max_new_tokens: int = 256,
                        temperature: Optional[float] = None,
                        timeout: float = 600.0, guided: bool = False,
                        adapter: Optional[str] = None, images=None,
                        sampling=None):
        ev = threading.Event()
        with self._lock:
            uid, _ = self._submit(prompt, max_new_tokens, temperature, guided,
                                  adapter, images, sampling)
            self._events[uid] = ev
        if not ev.wait(timeout):
            with self._lock:
                self._events.pop(uid, None)
                # free the lane instead of letting the abandoned request run
                # to max_new_tokens; the cancelled request still flows through
                # finished on the next tick, so mark it abandoned either way
                self._cancel_lane(uid)
                self._abandoned.add(uid)
                self._results.pop(uid, None)
            raise TimeoutError(f"request {uid} timed out")
        req = self._results.pop(uid)
        text = self.tokenizer.decode(req.generated).split("<|im_end|>")[0]
        out = {"text": text, "tokens": req.generated, "uid": uid,
               "error": req.error}
        if req.logprobs:
            out["logprobs"] = req.logprobs
            out["top_logprobs"] = req.top_logprobs
        return out

    def submit_stream(self, prompt: str, max_new_tokens: int = 256,
                      temperature: Optional[float] = None,
                      timeout: float = 600.0, guided: bool = False,
                      adapter: Optional[str] = None, images=None,
                      sampling=None):
        """Returns (uid, iterator of per-chunk token-id lists)."""
        q: queue_mod.Queue = queue_mod.Queue()
        with self._lock:
            uid, req = self._submit(prompt, max_new_tokens, temperature, guided,
                                    adapter, images, sampling)
            self._streams[uid] = q
            self._stream_reqs[uid] = req
            self._sent[uid] = 0

        def deltas():
            while True:
                try:
                    item = q.get(timeout=timeout)
                except queue_mod.Empty:
                    with self._lock:
                        self._cancel_lane(uid)
                        self._streams.pop(uid, None)
                        self._stream_reqs.pop(uid, None)
                        self._sent.pop(uid, None)
                    return
                if item is None:
                    return
                yield item

        return uid, deltas()

    def _cancel_lane(self, uid: int) -> bool:
        """The engine's cancel from a request thread (the lock held)."""
        with torch.inference_mode():
            return self.engine.cancel(uid)

    def cancel(self, uid: int) -> bool:
        with self._lock:
            ok = self._cancel_lane(uid)
            self._streams.pop(uid, None)
            self._stream_reqs.pop(uid, None)
            self._sent.pop(uid, None)
            self._events.pop(uid, None)
            # the cancelled request still flows through finished on the next
            # tick; without a consumer it must be discarded, not stored
            self._abandoned.add(uid)
            self._results.pop(uid, None)
        return ok

    # ------------------------------------------------------------ stats

    def metrics(self) -> dict:
        with self._lock:
            active = int(self.engine._active_mask().sum())
            queued = len(self.engine.queue)
            pool = getattr(self.engine, "pool", None)
            prefix = (
                {"prefix_cache_hits": pool.hits,
                 "pages_available": pool.available,
                 "pages_cached": len(pool.lru)}
                if pool is not None else {}
            )
        dt = max(time.time() - self.stats["started"], 1e-9)
        return {
            "requests": self.stats["requests"],
            "generated_tokens": self.stats["generated_tokens"],
            "prompt_tokens": self.stats["prompt_tokens"],
            "tokens_per_second": self.stats["generated_tokens"] / dt,
            "active": active, "queued": queued,
            "uptime_s": dt, **prefix,
        }

    def shutdown(self):
        self._stop = True
        self._thread.join(timeout=5)


def _decode_image(url: str):
    """data:image/...;base64,XXX (or bare base64) -> PIL image."""
    import base64
    import io

    from PIL import Image

    if url.startswith("data:"):
        url = url.split(",", 1)[1]
    return Image.open(io.BytesIO(base64.b64decode(url))).convert("RGB")


def _decode_video(url: str, num_frames: int):
    """base64 video -> uniformly sampled PIL frames (reference treats video
    as N image frames, aria/train.py:126-183 / load_video.py)."""
    import base64
    import os
    import tempfile

    from aria_tpu_torch.data.video import load_video

    if url.startswith("data:"):
        url = url.split(",", 1)[1]
    fd, path = tempfile.mkstemp(suffix=".mp4")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(base64.b64decode(url))
        return load_video(path, num_frames=num_frames)
    finally:
        os.unlink(path)


def _chat_to_prompt(messages: List[dict]):
    """OpenAI chat messages -> (ChatML prompt, PIL images).

    Image content (``{"type": "image_url", "image_url": {"url": "data:..."}}``)
    becomes one ``<|img|>`` placeholder in fim wrappers (data/chat.py);
    AriaProcessor then expands it by crop count and per-crop tokens.
    Video content (``{"type": "video_url", "video_url": {"url": ...},
    "num_frames": N}``) becomes N sampled frames, each an image placeholder
    (the reference's video->frames rewrite, aria/train.py:126-183)."""
    from aria_tpu_torch.data.chat import build_inference_prompt

    norm, images = [], []
    for m in messages:
        content = m.get("content", "")
        if isinstance(content, str):
            content = [{"type": "text", "text": content}]
        entries = []
        for c in content:
            if c.get("type") == "image_url":
                url = c["image_url"]["url"] if isinstance(c.get("image_url"), dict) else c["image_url"]
                images.append(_decode_image(url))
                entries.append({"type": "image"})
            elif c.get("type") == "video_url":
                url = c["video_url"]["url"] if isinstance(c.get("video_url"), dict) else c["video_url"]
                frames = _decode_video(url, int(c.get("num_frames", 8)))
                images.extend(frames)
                entries.extend([{"type": "image"}] * len(frames))
            else:
                entries.append(c)
        norm.append({"role": m["role"], "content": entries})
    # one placeholder per image here; the processor applies the real
    # crop-count + 128/256 token expansion (processing_aria.py:160-188)
    return build_inference_prompt(norm, num_crops=[1] * len(images)), images


def make_handler(loop: ServingLoop):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _sse(self, events):
            """events: iterator of json-able dicts; closes with [DONE]."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            try:
                for ev in events:
                    self.wfile.write(b"data: " + json.dumps(ev).encode() + b"\n\n")
                    self.wfile.flush()
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                pass  # client hung up
            finally:
                events.close()  # an unfinished stream's finally cancels its request

        # -------------------------------------------------------- GET

        def do_GET(self):
            if self.path == "/health":
                with loop._lock:
                    active = int(loop.engine._active_mask().sum())
                    queued = len(loop.engine.queue)
                self._json(200, {"status": "ok", "active": active, "queued": queued})
            elif self.path == "/metrics":
                self._json(200, loop.metrics())
            elif self.path == "/v1/models":
                reg = getattr(loop.engine, "adapters", None)
                models = [{"id": MODEL_ID, "object": "model",
                           "owned_by": "aria-tpu"}]
                models += [{"id": n, "object": "model", "owned_by": "aria-tpu",
                            "parent": MODEL_ID}  # served LoRA adapters
                           for n in (reg.names if reg else [])]
                self._json(200, {"object": "list", "data": models})
            else:
                self._json(404, {"error": "not found"})

        # -------------------------------------------------------- POST

        def _read_payload(self) -> dict:
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length) or b"{}")

        def _stream_text(self, prompt, max_new, temperature, guided=False,
                         stop_strings=(), adapter=None, images=None,
                         sampling=None):
            """Shared incremental detokenizer for both streaming APIs: yields
            (delta_text, token_ids) per decode chunk. Stop strings truncate
            the stream and CANCEL the request so the lane frees immediately
            (the reference pays a per-step detokenize check instead,
            gptfast/generate.py:324-335)."""
            uid, deltas = loop.submit_stream(prompt, max_new, temperature,
                                             guided=guided, adapter=adapter,
                                             images=images, sampling=sampling)
            toks: List[int] = []
            sent_text = ""
            stopped = False
            ended = False  # the engine finished the request, or a stop string cancelled it
            try:
                for chunk in deltas:
                    if stopped:
                        continue  # drain
                    toks.extend(chunk)
                    text = loop.tokenizer.decode(toks)
                    if "<|im_end|>" in text:
                        text = text.split("<|im_end|>")[0]
                        stopped = True
                    cut = min((i for i in (text.find(s) for s in stop_strings)
                               if i >= 0), default=-1)
                    if cut >= 0:
                        text = text[:cut]
                        stopped = True
                        loop.cancel(uid)
                        ended = True
                    if text.startswith(sent_text):
                        delta, sent_text = text[len(sent_text):], text
                    else:  # detokenizer retracted (partial multibyte): resend all
                        delta, sent_text = text, text
                    if delta or chunk:
                        yield delta, list(chunk)
                    if cut >= 0:
                        return
                ended = True
            finally:
                if not ended:  # the client hung up mid-stream: free its lane now
                    loop.cancel(uid)

        def do_POST(self):
            try:
                payload = self._read_payload()
                if self.path == "/generate":
                    self._generate(payload)
                elif self.path == "/v1/completions":
                    self._oai_completions(payload, chat=False)
                elif self.path == "/v1/chat/completions":
                    self._oai_completions(payload, chat=True)
                else:
                    self._json(404, {"error": "not found"})
            except KeyError as e:
                self._json(400, {"error": f"missing field {e}"})
            except Exception as e:  # noqa: BLE001
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

        @staticmethod
        def _sampling_params(payload) -> dict:
            """OpenAI (top_p, presence/frequency_penalty) + vLLM-extension
            (min_p, repetition_penalty) sampling params, passed through to
            the engine's per-lane sampling state.

            No-op defaults (top_p=1, min_p=0, penalties=0, repetition=1) are
            dropped HERE: standard OpenAI clients send them on every request,
            and forwarding one would permanently flip the engine's
            _nucleus/_penalties flags — a decode recompile plus per-step
            filtering/scatter work for all subsequent traffic."""
            noop = {"top_p": lambda v: v >= 1.0,
                    "min_p": lambda v: v <= 0.0,
                    "presence_penalty": lambda v: v == 0.0,
                    "frequency_penalty": lambda v: v == 0.0,
                    "repetition_penalty": lambda v: v == 1.0}
            return {
                k: float(payload[k])
                for k, is_noop in noop.items()
                if payload.get(k) is not None and not is_noop(float(payload[k]))
            }

        @staticmethod
        def _stops(payload) -> tuple:
            s = payload.get("stop") or ()
            return (s,) if isinstance(s, str) else tuple(s)

        def _generate(self, payload):
            prompt = payload["prompt"]
            max_new = int(payload.get("max_new_tokens", 256))
            temp = payload.get("temperature")
            stops = self._stops(payload)
            adapter = payload.get("adapter")
            samp = self._sampling_params(payload)
            images = [_decode_image(u) for u in payload.get("images", [])]
            if payload.get("stream"):
                self._sse(
                    {"text": d, "tokens": t}
                    for d, t in self._stream_text(prompt, max_new, temp,
                                                  stop_strings=stops,
                                                  adapter=adapter,
                                                  images=images,
                                                  sampling=samp)
                )
                return
            result = loop.submit_and_wait(prompt, max_new, temp,
                                          adapter=adapter, images=images,
                                          sampling=samp)
            cut = min((i for i in (result["text"].find(s) for s in stops)
                       if i >= 0), default=-1)
            if cut >= 0:
                result["text"] = result["text"][:cut]
            self._json(200, result)

        def _oai_completions(self, payload, *, chat: bool):
            images = []
            if chat:
                prompt, images = _chat_to_prompt(payload["messages"])
            else:
                prompt = payload["prompt"]
            max_new = int(payload.get("max_tokens", payload.get("max_new_tokens", 256)))
            temp = payload.get("temperature")
            # json_object uses the engine's generic JSON FSM; json_schema
            # uses whatever schema FSM the server was deployed with
            # (serve --json-schema) — per-request schema compilation would
            # need per-lane transition tables, not yet supported
            guided = (
                payload.get("response_format", {}).get("type")
                in ("json_object", "json_schema")
            )
            stops = self._stops(payload)
            samp = self._sampling_params(payload)
            n = int(payload.get("n", 1))
            model = payload.get("model")
            adapter = None if model in (None, MODEL_ID) else model
            rid = f"{'chatcmpl' if chat else 'cmpl'}-{uuid.uuid4().hex[:24]}"
            created = int(time.time())
            obj = "chat.completion" if chat else "text_completion"

            if payload.get("stream"):
                if n != 1:
                    self._json(400, {"error": "stream=true requires n=1"})
                    return
                def events():
                    if chat:  # role handshake chunk, per the OpenAI protocol
                        yield {
                            "id": rid, "object": "chat.completion.chunk",
                            "created": created, "model": MODEL_ID,
                            "choices": [{"index": 0, "delta": {"role": "assistant"},
                                         "finish_reason": None}],
                        }
                    for delta, _toks in self._stream_text(prompt, max_new, temp,
                                                          guided=guided,
                                                          stop_strings=stops,
                                                          adapter=adapter,
                                                          images=images,
                                                          sampling=samp):
                        choice = (
                            {"index": 0, "delta": {"content": delta},
                             "finish_reason": None}
                            if chat else
                            {"index": 0, "text": delta, "finish_reason": None}
                        )
                        yield {"id": rid, "object": obj + (".chunk" if chat else ""),
                               "created": created, "model": MODEL_ID,
                               "choices": [choice]}
                    final = (
                        {"index": 0, "delta": {}, "finish_reason": "stop"}
                        if chat else
                        {"index": 0, "text": "", "finish_reason": "stop"}
                    )
                    yield {"id": rid, "object": obj + (".chunk" if chat else ""),
                           "created": created, "model": MODEL_ID,
                           "choices": [final]}

                self._sse(events())
                return

            # n choices run CONCURRENTLY through the continuous batch — they
            # join the same decode chunks, so n completions cost ~one
            from concurrent.futures import ThreadPoolExecutor

            if n == 1:
                results = [loop.submit_and_wait(prompt, max_new, temp,
                                                guided=guided, adapter=adapter,
                                                images=images, sampling=samp)]
            else:
                with ThreadPoolExecutor(max_workers=n) as ex:
                    results = list(ex.map(
                        lambda _: loop.submit_and_wait(prompt, max_new, temp,
                                                       guided=guided,
                                                       adapter=adapter,
                                                       images=images,
                                                       sampling=samp),
                        range(n)))
            choices = []
            total_completion = 0
            for i, result in enumerate(results):
                cut = min((j for j in (result["text"].find(s) for s in stops)
                           if j >= 0), default=-1)
                if cut >= 0:
                    result["text"] = result["text"][:cut]
                total_completion += len(result["tokens"])
                finish = ("stop" if cut >= 0 else
                          "length" if len(result["tokens"]) >= max_new else "stop")
                choice = (
                    {"index": i, "finish_reason": finish,
                     "message": {"role": "assistant", "content": result["text"]}}
                    if chat else
                    {"index": i, "finish_reason": finish, "text": result["text"]}
                )
                if payload.get("logprobs") and "logprobs" in result:
                    dec = loop.tokenizer.decode
                    choice["logprobs"] = {
                        "tokens": [dec([t]) for t in result["tokens"]],
                        "token_logprobs": result["logprobs"],
                        "top_logprobs": [
                            {dec([t]): lp for t, lp in d.items()}
                            for d in result["top_logprobs"]
                        ],
                    }
                choices.append(choice)
            n_prompt = len(loop.tokenizer.encode(prompt))
            usage = {"prompt_tokens": n_prompt,
                     "completion_tokens": total_completion,
                     "total_tokens": n_prompt + total_completion}
            self._json(200, {"id": rid, "object": obj, "created": created,
                             "model": MODEL_ID, "choices": choices,
                             "usage": usage})

    return Handler


def serve(engine, tokenizer, host: str = "127.0.0.1", port: int = 8000):
    loop = ServingLoop(engine, tokenizer)
    httpd = ThreadingHTTPServer((host, port), make_handler(loop))
    print(f"serving on {host}:{port}")
    try:
        httpd.serve_forever()
    finally:
        loop.shutdown()
