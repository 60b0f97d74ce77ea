"""Continuous-batching serving engine (counterpart of
aria_tpu/engine/server.py:37-779).

A fixed pool of B cache lanes. Queued text requests are admitted in groups
of one prompt bucket, each group in one multi-row prefill (at most
``GROUP_ROWS`` rows) into a fresh bucket-length cache whose rows are then
copied into their lanes; an image request is admitted alone, through
``encode_images``. One decode step advances all B lanes together with a
per-lane ``cache_pos``: idle lanes compute behind the ``active`` mask and
their tokens are ignored. Requests join and leave at chunk boundaries.

Tokens, positions and penalty counts stay on the device. A chunk runs
``decode_chunk`` steps; its tokens, the lanes' positions and the first
tokens of the requests admitted before it come back to the host in one
transfer, where stop tokens, ``max_new_tokens`` and the ``S - 1`` limit
are checked.

The JAX engine pads a group to a power of two rows to bound its compile
count; the port has no compile and runs the rows it has (rows do not
interact, so the tokens are the same). Guided decoding, multi-LoRA
adapters, a serving mesh and per-token logprobs are not ported yet and
raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Sequence

import numpy as np
import torch

from aria_tpu_torch.config import AriaConfig
from aria_tpu_torch.engine.generate import _bucket
from aria_tpu_torch.engine.sampling import apply_penalties, sample, update_counts
from aria_tpu_torch.models.aria import encode_images, prepare_embeddings
from aria_tpu_torch.models.moe_lm import KVCache, lm_forward

GROUP_ROWS = 32  # most requests in one grouped admission prefill (server.py:470-477)

_NOT_PORTED = {
    "mesh": "a serving mesh (ROADMAP queue 1, item 11: parallel/ on torch.distributed)",
    "guided_fsm": "guided decoding (ROADMAP queue 1, item 7: the serving features)",
    "adapters": "multi-LoRA adapters (ROADMAP queue 1, item 7: the serving features)",
    "logprobs_topk": "per-token logprobs (ROADMAP queue 1, item 7: the serving features)",
}


@dataclasses.dataclass
class Request:
    uid: int
    prompt_tokens: List[int]
    max_new_tokens: int = 256
    stop_token_ids: tuple = ()
    pixel_values: Optional[np.ndarray] = None
    pixel_mask: Optional[np.ndarray] = None
    temperature: Optional[float] = None  # None = the engine's
    top_p: Optional[float] = None  # None = off
    min_p: Optional[float] = None
    presence_penalty: Optional[float] = None
    frequency_penalty: Optional[float] = None
    repetition_penalty: Optional[float] = None
    # filled by the engine
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    error: Optional[str] = None


class BatchedEngine:
    def __init__(
        self,
        params: dict,
        cfg: AriaConfig,
        *,
        max_lanes: int = 4,
        max_seq_len: int = 2048,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        decode_chunk: int = 16,
        cache_dtype=torch.bfloat16,
        rng_seed: int = 0,
        mesh=None,
        guided_fsm=None,
        adapters=None,
        logprobs_topk: Optional[int] = None,
    ):
        given = {"mesh": mesh, "guided_fsm": guided_fsm, "adapters": adapters,
                 "logprobs_topk": logprobs_topk}
        for name, value in given.items():
            if value is not None:
                raise NotImplementedError(f"BatchedEngine({name}=...): {_NOT_PORTED[name]} "
                                          "is not ported yet")
        self.cfg = cfg
        self.params = params
        self.B = max_lanes
        # a multiple of 128, as the JAX engine allocates (server.py:103)
        self.S = -(-max_seq_len // 128) * 128
        self.temperature = temperature
        self.top_k = top_k
        self.decode_chunk = decode_chunk
        self.cache_dtype = cache_dtype
        self.device = params["lm"]["final_norm"].device
        self.generator = torch.Generator(device=self.device).manual_seed(rng_seed)
        self.cache = KVCache.init(cfg.text, self.B, self.S, cache_dtype, device=self.device)
        self.lane_req: List[Optional[Request]] = [None] * self.B
        self.lane_pos = np.zeros(self.B, np.int32)  # next write position (host copy)
        self.lane_tok = torch.zeros(self.B, dtype=torch.int32, device=self.device)
        self.lane_temp = np.full(self.B, temperature, np.float32)
        # per-lane nucleus and penalty settings at their pass-through values;
        # the decode step reads them once a request has turned one on
        self.lane_top_p = np.ones(self.B, np.float32)
        self.lane_min_p = np.zeros(self.B, np.float32)
        self.lane_pres = np.zeros(self.B, np.float32)
        self.lane_freq = np.zeros(self.B, np.float32)
        self.lane_rep = np.ones(self.B, np.float32)
        self._nucleus = False
        self._penalties = False
        self.lane_counts: Optional[torch.Tensor] = None  # [B, V] int32 output counts
        self.lane_pmask: Optional[torch.Tensor] = None  # [B, V] bool prompt tokens
        self.queue: Deque[Request] = deque()
        self._uid = 0
        self._finished: List[Request] = []
        # (lane, request, first token as a 1-element device tensor), read
        # back with the next chunk's tokens
        self._pending_first: list = []

    # ------------------------------------------------------------ API

    def submit(
        self,
        prompt_tokens: Sequence[int],
        max_new_tokens: int = 256,
        stop_token_ids: Sequence[int] = (),
        pixel_values: Optional[np.ndarray] = None,
        pixel_mask: Optional[np.ndarray] = None,
        temperature: Optional[float] = None,
        guided: bool = False,
        adapter: Optional[str] = None,
        top_p: Optional[float] = None,
        min_p: Optional[float] = None,
        presence_penalty: Optional[float] = None,
        frequency_penalty: Optional[float] = None,
        repetition_penalty: Optional[float] = None,
    ) -> int:
        if guided:
            raise ValueError("engine was built without a guided_fsm")
        if adapter:
            raise ValueError("engine was built without adapters")
        self._uid += 1
        if top_p is not None or min_p is not None:
            self._nucleus = True
        if presence_penalty or frequency_penalty or repetition_penalty not in (None, 1.0):
            self._ensure_penalty_state()
        self.queue.append(Request(
            uid=self._uid, prompt_tokens=list(prompt_tokens), max_new_tokens=max_new_tokens,
            stop_token_ids=tuple(stop_token_ids), pixel_values=pixel_values,
            pixel_mask=pixel_mask, temperature=temperature, top_p=top_p, min_p=min_p,
            presence_penalty=presence_penalty, frequency_penalty=frequency_penalty,
            repetition_penalty=repetition_penalty))
        return self._uid

    def cancel(self, uid: int) -> bool:
        """Abort a queued or running request; its lane is free at once."""
        for r in self.queue:
            if r.uid == uid:
                self.queue.remove(r)
                r.done = True
                r.error = "cancelled"
                self._finished.append(r)
                return True
        for lane, r in enumerate(self.lane_req):
            if r is not None and r.uid == uid:
                self._pending_first = [e for e in self._pending_first if e[1].uid != uid]
                r.error = "cancelled"
                self._finish(lane)
                return True
        return False

    @torch.inference_mode()
    def step(self) -> List[Request]:
        """Admit queued requests, run one decode chunk, return the requests
        that finished."""
        self._admit_all()
        active = self._active_mask()
        if not active.any():
            out, self._finished = self._finished, []
            return out
        all_toks, pos = self._decode_chunk(active)
        n, B = all_toks.shape
        firsts = [e[2] for e in self._pending_first]
        # the one read-back per chunk
        host = torch.cat([all_toks.reshape(-1), pos, *firsts]).tolist()
        toks_host = np.asarray(host[:n * B], np.int64).reshape(n, B)
        self.lane_pos = np.asarray(host[n * B:n * B + B], np.int32)
        for (lane, req, _), first in zip(self._pending_first, host[n * B + B:]):
            req.generated.append(int(first))
            if first in req.stop_token_ids or len(req.generated) >= req.max_new_tokens:
                self._finish(lane)  # this lane's chunk tokens are dropped
        self._pending_first = []
        for lane in range(self.B):
            req = self.lane_req[lane]
            if req is None:
                continue
            for t in toks_host[:, lane].tolist():
                req.generated.append(t)
                if (t in req.stop_token_ids or len(req.generated) >= req.max_new_tokens
                        or int(self.lane_pos[lane]) >= self.S - 1):
                    self._finish(lane)
                    break
        out, self._finished = self._finished, []
        return out

    def run_until_complete(self, max_ticks: int = 10_000) -> List[Request]:
        """Drain the queue and the lanes; returns every finished request."""
        out: List[Request] = []
        for _ in range(max_ticks):
            out.extend(self.step())
            if not self.queue and not self._active_mask().any():
                break
        return out

    # ------------------------------------------------------------ lanes

    def _ensure_penalty_state(self):
        if not self._penalties:
            self._penalties = True
            V = self.cfg.text.vocab_size
            self.lane_counts = torch.zeros((self.B, V), dtype=torch.int32, device=self.device)
            self.lane_pmask = torch.zeros((self.B, V), dtype=torch.bool, device=self.device)

    @staticmethod
    def _req_sampling(req: Request) -> tuple:
        """(top_p, min_p, presence, frequency, repetition) with the unset
        ones at their pass-through values."""
        return (1.0 if req.top_p is None else req.top_p,
                0.0 if req.min_p is None else req.min_p,
                req.presence_penalty or 0.0,
                req.frequency_penalty or 0.0,
                1.0 if req.repetition_penalty is None else req.repetition_penalty)

    def _active_mask(self) -> np.ndarray:
        return np.asarray([r is not None for r in self.lane_req], bool)

    def _finish(self, lane: int):
        req = self.lane_req[lane]
        if req is not None:
            req.done = True
            self._finished.append(req)
        self.lane_req[lane] = None
        self.lane_top_p[lane] = 1.0
        self.lane_min_p[lane] = 0.0
        self.lane_pres[lane] = self.lane_freq[lane] = 0.0
        self.lane_rep[lane] = 1.0

    def _reject_oversized(self, req: Request) -> bool:
        if _bucket(len(req.prompt_tokens)) + req.max_new_tokens <= self.S:
            return False
        req.done = True
        req.error = f"request {req.uid} exceeds max_seq_len {self.S}"
        self._finished.append(req)
        return True

    def _admit_all(self):
        """Image requests one at a time; text requests grouped by prompt
        bucket, each group in one prefill (server.py:455-496)."""
        while self.queue:
            if self.queue[0].pixel_values is not None:
                if not self._admit_image():
                    return
                continue
            free = [i for i, r in enumerate(self.lane_req) if r is None]
            if not free:
                return
            group: List[Request] = []
            bucket = None
            while self.queue and len(group) < min(len(free), GROUP_ROWS):
                req = self.queue[0]
                if req.pixel_values is not None:
                    break
                if self._reject_oversized(req):
                    self.queue.popleft()
                    continue
                b = _bucket(len(req.prompt_tokens))
                if bucket is None:
                    bucket = b
                elif b != bucket:
                    break
                group.append(self.queue.popleft())
            if group:
                self._prefill(group, bucket, free[:len(group)])

    def _admit_image(self) -> bool:
        lane = next((i for i, r in enumerate(self.lane_req) if r is None), None)
        if lane is None:
            return False
        req = self.queue.popleft()
        if self._reject_oversized(req):
            return True
        dev = self.device
        pm = None if req.pixel_mask is None else torch.as_tensor(req.pixel_mask, device=dev)
        feats = encode_images(self.params, self.cfg,
                              torch.as_tensor(req.pixel_values, device=dev), pm)
        self._prefill([req], _bucket(len(req.prompt_tokens)), [lane], feats)
        return True

    def _prefill(self, reqs: List[Request], bucket: int, lanes: List[int],
                 image_features: Optional[torch.Tensor] = None):
        """One prefill of len(reqs) rows from position 0 into a fresh
        bucket-length cache, copied into the lanes' rows; samples each
        row's first token on the device (server.py:235-304, 498-571)."""
        N, dev, text = len(reqs), self.device, self.cfg.text
        tokens = np.zeros((N, bucket), np.int64)
        true_lens = np.zeros(N, np.int64)
        temps = np.zeros(N, np.float32)
        samp = np.zeros((N, 5), np.float32)  # top_p, min_p, presence, frequency, repetition
        for row, req in enumerate(reqs):
            tokens[row, :len(req.prompt_tokens)] = req.prompt_tokens
            true_lens[row] = len(req.prompt_tokens)
            temps[row] = self.temperature if req.temperature is None else req.temperature
            samp[row] = self._req_sampling(req)
        tok_t = torch.as_tensor(tokens, device=dev)
        lens_t = torch.as_tensor(true_lens, device=dev)
        lane_cache = KVCache.init(text, N, bucket, self.cache_dtype, device=dev)
        embeds = prepare_embeddings(self.params, self.cfg, tok_t, image_features=image_features)
        logits = lm_forward(self.params["lm"], text, inputs_embeds=embeds,
                            positions=torch.arange(bucket, device=dev), cache=lane_cache,
                            cache_pos=0, logit_position=lens_t - 1, causal_flash=True).logits[:, 0]
        lanes_t = torch.as_tensor(lanes, device=dev)
        for name in ("k", "v", "k_scale", "v_scale"):
            src = getattr(lane_cache, name)
            if src is not None:
                getattr(self.cache, name)[:, lanes_t, :, :bucket] = src
        pmask = None
        if self._penalties:
            valid = torch.arange(bucket, device=dev)[None, :] < lens_t[:, None]
            hits = torch.zeros((N, text.vocab_size), dtype=torch.int32, device=dev)
            pmask = hits.scatter_add_(1, tok_t, valid.to(torch.int32)) > 0
            pres, freq, rep = (torch.as_tensor(samp[:, i], device=dev) for i in (2, 3, 4))
            logits = apply_penalties(logits, torch.zeros_like(logits, dtype=torch.int32), pmask,
                                     pres, freq, rep)
        top_p = min_p = None
        if self._nucleus:
            top_p, min_p = (torch.as_tensor(samp[:, i], device=dev) for i in (0, 1))
        toks = sample(self.generator, logits, torch.as_tensor(temps, device=dev), self.top_k,
                      top_p, min_p)
        self.lane_tok[lanes_t] = toks
        if self._penalties:
            self.lane_pmask[lanes_t] = pmask
            self.lane_counts[lanes_t] = 0
            self.lane_counts[lanes_t, toks.long()] += 1
        for row, req in enumerate(reqs):
            lane = lanes[row]
            self._pending_first.append((lane, req, toks[row:row + 1]))
            self.lane_req[lane] = req
            self.lane_pos[lane] = len(req.prompt_tokens)
            self.lane_temp[lane] = temps[row]
            (self.lane_top_p[lane], self.lane_min_p[lane], self.lane_pres[lane],
             self.lane_freq[lane], self.lane_rep[lane]) = samp[row]

    def _decode_chunk(self, active: np.ndarray):
        """``decode_chunk`` steps over all B lanes (server.py:317-374).
        Returns the tokens [n, B] and the positions after the chunk, both
        on the device."""
        dev, lm, text = self.device, self.params["lm"], self.cfg.text
        act = torch.as_tensor(active, device=dev)
        pos = torch.as_tensor(self.lane_pos, device=dev)
        temps = torch.as_tensor(self.lane_temp, device=dev)
        top_p = min_p = None
        if self._nucleus:
            top_p = torch.as_tensor(self.lane_top_p, device=dev)
            min_p = torch.as_tensor(self.lane_min_p, device=dev)
        if self._penalties:
            pres, freq, rep = (torch.as_tensor(a, device=dev)
                               for a in (self.lane_pres, self.lane_freq, self.lane_rep))
        toks = self.lane_tok
        outs = []
        for _ in range(self.decode_chunk):
            logits = lm_forward(lm, text, toks[:, None].long(), positions=pos[:, None],
                                cache=self.cache, cache_pos=pos).logits[:, -1]
            if self._penalties:
                logits = apply_penalties(logits, self.lane_counts, self.lane_pmask, pres, freq, rep)
            nxt = sample(self.generator, logits, temps, self.top_k, top_p, min_p)
            if self._penalties:
                update_counts(self.lane_counts, nxt, act)
            pos = torch.where(act, pos + 1, pos)
            toks = torch.where(act, nxt, toks)
            outs.append(toks)
        self.lane_tok = toks
        return torch.stack(outs), pos
