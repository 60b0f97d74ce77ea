"""Continuous-batching serving engines (counterpart of
aria_tpu/engine/server.py): ``BatchedEngine`` (:37-779) over a contiguous
cache, and ``PagedBatchedEngine`` (:781-1365) over a shared page pool with
chunked prefill and a prefix cache (documented at the class). Both build
on ``_LaneEngine``: the queue, the per-lane sampling state, the decode
chunk over all lanes and its one read-back with the stop rules.

``BatchedEngine`` holds a fixed pool of B cache lanes. Queued text requests are admitted in groups
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
interact, so the tokens are the same). A serving mesh for the paged
engine is not ported and raises ``NotImplementedError``.

Guided decoding (``guided_fsm=``, a ``TokenFSM`` of engine/guided.py on the
engine's device): a request submitted with ``guided=True`` decodes under
the FSM, its state [B] on the device starting at the FSM's start, every
other lane at its free state, whose row allows every token, so one table
serves a mixed batch and the unguided lanes' streams stay the plain
engine's. The mask goes on the prefill's sample (single and grouped), on
the paged engine's chunk and on every decode step (server.py:235-374,
:895-999). ``BatchedEngine(logprobs_topk=K)`` records each generated
token's log-probability and its top K alternatives under the raw logits
(``Request.logprobs``, ``.top_logprobs``), read back with the chunk.

``BatchedEngine(mesh=)`` shards its cache by head over the ``model`` axis
of a serving mesh (``parallel/mesh.py``), as the JAX engine does
(server.py:108-125): every rank holds all lanes and H / model heads of
each, runs the same steps, and decode attention gathers the heads
(``parallel/cp_cache.py``). As in the JAX engine, the int4 cache, whose
bytes pair heads across the model shards, is refused there. Over the
``expert`` axis each rank keeps only its experts (``mesh.serving_shard``:
a whole tree given is sliced, an unfused tree is required) and the MoE is
expert-parallel (``parallel/ep.py``); every other leaf is replicated.

Multi-LoRA (``adapters=``, an ``AdapterRegistry`` of
``engine/multi_lora.py``): each request names an adapter at ``submit``
(none is the base), and a prefill or decode step over rows that hold one
passes the stacked factors and the rows' one-hot selector to
``lm_forward``. A prefill group, chunk or decode step whose rows hold no
adapter takes the plain call (server.py:514-536, :711-714), so base-only
traffic keeps the int4 kernels; in a mixed batch the base rows take the
blocked expert-LoRA path with the zero adapter. The paged engine salts its
prefix keys with the adapter id, so pages are never shared across
adapters (server.py:1099-1102).
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import deque
from typing import Deque, List, Optional, Sequence

import numpy as np
import torch

from aria_tpu_torch.config import AriaConfig
from aria_tpu_torch.engine.generate import _bucket
from aria_tpu_torch.engine.guided import guided_mask, guided_next_state
from aria_tpu_torch.engine.multi_lora import AdapterRegistry, registry_for_params
from aria_tpu_torch.engine.paged import PagePool
from aria_tpu_torch.engine.sampling import (
    apply_penalties,
    sample,
    token_logprobs,
    update_counts,
)
from aria_tpu_torch.models.aria import encode_images, prepare_embeddings
from aria_tpu_torch.models.moe_lm import KVCache, lm_forward
from aria_tpu_torch.ops.paged_attention import PagedKVCache
from aria_tpu_torch.parallel.mesh import serving_shard

GROUP_ROWS = 32  # most requests in one grouped admission prefill (server.py:470-477)

_NOT_PORTED = {
    "mesh": "a serving mesh for the paged engine (ROADMAP queue 1, item 11)",
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
    guided: bool = False  # decode under the engine's TokenFSM
    # filled by the engine
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    error: Optional[str] = None
    cached_tokens: int = 0  # prompt positions served from the prefix cache (paged engine)
    adapter_id: int = 0  # index into the engine's AdapterRegistry (0 = the base)
    # logprobs_topk=K: per generated token, its log-probability under the raw
    # (pre-temperature) distribution and its top K alternatives {id: logprob}
    logprobs: List[float] = dataclasses.field(default_factory=list)
    top_logprobs: List[dict] = dataclasses.field(default_factory=list)


class _LaneEngine:
    """What both engines share: the request queue, the per-lane sampling
    state, ``submit`` and ``cancel``, the decode chunk over all B lanes and
    its one read-back with the stop and finish rules. The engines differ
    in admission, prefill and the cache."""

    def __init__(self, params: dict, cfg: AriaConfig, max_lanes: int, temperature: float,
                 top_k: Optional[int], decode_chunk: int, rng_seed: int,
                 adapters: Optional[AdapterRegistry], guided_fsm=None,
                 logprobs_topk: Optional[int] = None, **given):
        for name, value in given.items():
            if value is not None:
                raise NotImplementedError(f"{type(self).__name__}({name}=...): "
                                          f"{_NOT_PORTED[name]} is not ported yet")
        self.cfg = cfg
        self.params = params
        self.mesh = None  # BatchedEngine's serving mesh
        self.B = max_lanes
        self.temperature = temperature
        self.top_k = top_k
        self.decode_chunk = decode_chunk
        self.device = params["lm"]["final_norm"].device
        if guided_fsm is not None and guided_fsm.device != self.device:
            raise ValueError(f"the guided FSM is on {guided_fsm.device}, the model on "
                             f"{self.device}: build it with device= or move it with .to()")
        self.guided_fsm = guided_fsm
        self.logprobs_topk = logprobs_topk
        # each lane's FSM state, the free state (every token allowed) unless
        # the lane holds a guided request
        self.lane_gstate = None if guided_fsm is None else torch.full(
            (self.B,), guided_fsm.free_state, dtype=torch.int32, device=self.device)
        if adapters is not None:
            placed = {ab[f].device for ab in adapters.stacked["layers"].values() for f in "ab"}
            if placed - {self.device}:
                raise ValueError(f"adapters on {sorted(map(str, placed))}, the model on "
                                 f"{self.device}")
            # a base with fused shared experts needs the factors fused to match
            adapters = registry_for_params(adapters, params["lm"]["layers"], cfg.text)
        self.adapters = adapters
        self.lane_adapter = np.zeros(self.B, np.int32)  # 0 = the base
        self.generator = torch.Generator(device=self.device).manual_seed(rng_seed)
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
        if guided and self.guided_fsm is None:
            raise ValueError("engine was built without a guided_fsm")
        if adapter and self.adapters is None:
            raise ValueError("engine was built without adapters")
        adapter_id = self.adapters.resolve(adapter) if self.adapters is not None else 0
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
            repetition_penalty=repetition_penalty, guided=guided, adapter_id=adapter_id))
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

    def _set_lane_sampling(self, lane: int, req: Request) -> None:
        (self.lane_top_p[lane], self.lane_min_p[lane], self.lane_pres[lane],
         self.lane_freq[lane], self.lane_rep[lane]) = self._req_sampling(req)

    def _active_mask(self) -> np.ndarray:
        return np.asarray([r is not None for r in self.lane_req], bool)

    def _finish(self, lane: int):
        req = self.lane_req[lane]
        if req is not None:
            req.done = True
            self._finished.append(req)
        self.lane_req[lane] = None
        self.lane_adapter[lane] = 0
        self.lane_top_p[lane] = 1.0
        self.lane_min_p[lane] = 0.0
        self.lane_pres[lane] = self.lane_freq[lane] = 0.0
        self.lane_rep[lane] = 1.0
        if self.guided_fsm is not None:
            self.lane_gstate[lane] = self.guided_fsm.free_state

    def _start_states(self, reqs) -> torch.Tensor:
        """[N] int32 FSM states for these requests' first sample: the
        start for a guided one, the free state for the rest."""
        f = self.guided_fsm
        return torch.as_tensor([f.start if r.guided else f.free_state for r in reqs],
                               dtype=torch.int32, device=self.device)

    def _guided(self, logits: torch.Tensor, states: torch.Tensor) -> torch.Tensor:
        f = self.guided_fsm
        return guided_mask(f.trans, f.accepting, f.stop_mask, states, logits)

    @staticmethod
    def _append_logprobs(req: Request, chosen: float, top_ids, top_lps) -> None:
        """One token's logprob and its top K alternatives (server.py:652-656)."""
        req.logprobs.append(float(chosen))
        req.top_logprobs.append({int(i): float(l) for i, l in zip(top_ids, top_lps)})

    def _lora_kwargs(self, ids) -> dict:
        """``lm_forward``'s adapter arguments for rows with these adapter
        ids: none when no row holds an adapter (the plain call)."""
        if self.adapters is None or not np.any(ids):
            return {}
        return {"lora": self.adapters.stacked, "lora_scale": 1.0,
                "lora_onehot": self.adapters.lane_onehot(ids)}

    def _take_finished(self) -> List[Request]:
        out, self._finished = self._finished, []
        return out

    def _decode_chunk(self, active: np.ndarray, page_table: Optional[torch.Tensor] = None):
        """``decode_chunk`` steps over all B lanes (server.py:317-374; the
        paged engine's :956-999 with its ``page_table``): the penalties, the
        FSM's mask, the draw, then the counts and the active lanes' FSM
        states. Returns the tokens [n, B], the positions after the chunk and,
        with ``logprobs_topk``, each step's (chosen [n, B], top ids [n, B,
        K], top logprobs [n, B, K]) under the raw logits, all on the
        device."""
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
        outs, lps = [], []
        lora = self._lora_kwargs(self.lane_adapter)
        for _ in range(self.decode_chunk):
            raw = lm_forward(lm, text, toks[:, None].long(), positions=pos[:, None],
                             cache=self.cache, cache_pos=pos, page_table=page_table,
                             mesh=self.mesh, **lora).logits[:, -1]
            logits = raw
            if self._penalties:
                logits = apply_penalties(logits, self.lane_counts, self.lane_pmask, pres, freq, rep)
            if self.guided_fsm is not None:
                logits = self._guided(logits, self.lane_gstate)
            nxt = sample(self.generator, logits, temps, self.top_k, top_p, min_p)
            if self._penalties:
                update_counts(self.lane_counts, nxt, act)
            if self.guided_fsm is not None:
                self.lane_gstate = torch.where(
                    act, guided_next_state(self.guided_fsm.trans, self.lane_gstate, nxt),
                    self.lane_gstate)
            if self.logprobs_topk:
                lps.append(token_logprobs(raw, nxt, self.logprobs_topk))
            pos = torch.where(act, pos + 1, pos)
            toks = torch.where(act, nxt, toks)
            outs.append(toks)
        self.lane_tok = toks
        lp = tuple(torch.stack(a) for a in zip(*lps)) if lps else None
        return torch.stack(outs), pos, lp

    def _read_back(self, active: np.ndarray, all_toks: torch.Tensor, pos: torch.Tensor,
                   lp: Optional[tuple] = None):
        """The chunk's one read-back: its tokens [n, B], the positions after
        it and the pending first tokens (server.py:742-779, :1330-1365),
        with their logprobs when the engine records them. Each active lane
        takes its tokens until a stop token, max_new_tokens or position S -
        1 (checked after the chunk, as both JAX engines do); a lane that
        finishes on its first token drops its chunk's."""
        n, B = all_toks.shape
        firsts = [e[2] for e in self._pending_first]
        host = torch.cat([all_toks.reshape(-1), pos, *firsts]).tolist()
        toks_host = np.asarray(host[:n * B], np.int64).reshape(n, B)
        new_pos = host[n * B:n * B + B]
        lp_host = first_lp = None
        if lp is not None:  # the floats in one more transfer
            lp_host = [a.cpu().numpy() for a in lp]
            if self._pending_first:
                first_lp = [torch.cat(a).cpu().numpy()
                            for a in zip(*(e[3] for e in self._pending_first))]
        for i, ((lane, req, *_), first) in enumerate(zip(self._pending_first,
                                                          host[n * B + B:])):
            req.generated.append(int(first))
            if first_lp is not None:
                self._append_logprobs(req, *(a[i] for a in first_lp))
            if first in req.stop_token_ids or len(req.generated) >= req.max_new_tokens:
                self._finish(lane)
        self._pending_first = []
        for lane in range(B):
            if not active[lane]:
                continue
            self.lane_pos[lane] = new_pos[lane]
            req = self.lane_req[lane]
            if req is None:
                continue  # finished on its first token
            for i, t in enumerate(toks_host[:, lane].tolist()):
                req.generated.append(t)
                if lp_host is not None:
                    self._append_logprobs(req, *(a[i, lane] for a in lp_host))
                if (t in req.stop_token_ids or len(req.generated) >= req.max_new_tokens
                        or int(self.lane_pos[lane]) >= self.S - 1):
                    self._finish(lane)
                    break


class BatchedEngine(_LaneEngine):
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
        params = serving_shard(params, cfg.text.num_experts, mesh)
        super().__init__(params, cfg, max_lanes, temperature, top_k, decode_chunk, rng_seed,
                         adapters, guided_fsm, logprobs_topk)
        if mesh is not None:
            if mesh.shape["context"] > 1:
                raise NotImplementedError(
                    "BatchedEngine(mesh=) with a context axis: the batched engine shards its "
                    "cache over model only, as the JAX engine does; context parallelism serves "
                    "through Engine(mesh=) (ROADMAP queue 1, item 11)")
            if cache_dtype == "int4" and mesh.shape["model"] > 1:
                raise ValueError("an int4 KV cache pairs heads across the model shards")
        self.mesh = mesh
        # a multiple of 128, as the JAX engine allocates (server.py:103)
        self.S = -(-max_seq_len // 128) * 128
        self.cache_dtype = cache_dtype
        self.cache = KVCache.init(cfg.text, self.B, self.S, cache_dtype, device=self.device,
                                  mesh=mesh)

    @torch.inference_mode()
    def step(self) -> List[Request]:
        """Admit queued requests, run one decode chunk, return the requests
        that finished."""
        self._admit_all()
        active = self._active_mask()
        if active.any():
            self._read_back(active, *self._decode_chunk(active))
        return self._take_finished()

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
        lane_cache = KVCache.init(text, N, bucket, self.cache_dtype, device=dev, mesh=self.mesh)
        embeds = prepare_embeddings(self.params, self.cfg, tok_t, image_features=image_features)
        ids = np.asarray([req.adapter_id for req in reqs], np.int32)
        raw = lm_forward(self.params["lm"], text, inputs_embeds=embeds,
                         positions=torch.arange(bucket, device=dev), cache=lane_cache,
                         cache_pos=0, logit_position=lens_t - 1, causal_flash=True,
                         mesh=self.mesh, **self._lora_kwargs(ids)).logits[:, 0]
        logits = raw
        self.lane_adapter[lanes] = ids
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
        if self.guided_fsm is not None:
            g0 = self._start_states(reqs)
            logits = self._guided(logits, g0)
        top_p = min_p = None
        if self._nucleus:
            top_p, min_p = (torch.as_tensor(samp[:, i], device=dev) for i in (0, 1))
        toks = sample(self.generator, logits, torch.as_tensor(temps, device=dev), self.top_k,
                      top_p, min_p)
        if self.guided_fsm is not None:
            self.lane_gstate[lanes_t] = guided_next_state(self.guided_fsm.trans, g0, toks)
        lp = None
        if self.logprobs_topk:
            lp = token_logprobs(raw, toks, self.logprobs_topk)
        self.lane_tok[lanes_t] = toks
        if self._penalties:
            self.lane_pmask[lanes_t] = pmask
            self.lane_counts[lanes_t] = 0
            self.lane_counts[lanes_t, toks.long()] += 1
        for row, req in enumerate(reqs):
            lane = lanes[row]
            self._pending_first.append((lane, req, toks[row:row + 1],
                                        None if lp is None else tuple(a[row:row + 1] for a in lp)))
            self.lane_req[lane] = req
            self.lane_pos[lane] = len(req.prompt_tokens)
            self.lane_temp[lane] = temps[row]
            self._set_lane_sampling(lane, req)


class PagedBatchedEngine(_LaneEngine):
    """Continuous batching over a shared page pool with chunked prefill
    (counterpart of aria_tpu/engine/server.py:781-1365).

    Lanes draw ``page_size``-token pages from one pool (``engine/paged.py``;
    the cache is ``ops/paged_attention.py``), so device memory scales with
    the tokens in flight. Admission allocates
    a request's pages and computes its prompt embedding (an image request
    runs ``encode_images`` once here); each ``step`` then advances every
    mid-prefill lane by one ``prefill_chunk``-token chunk in one batched
    call (at most ``PREFILL_ROWS`` rows) and runs one decode chunk for the
    lanes already decoding, so a long prompt does not stall the others.

    Prefix cache: full prompt pages are keyed by a chain hash of their
    tokens; a request whose prompt shares a prefix takes the cached pages
    and skips those chunks, but never the page that holds its last prompt
    token, so a chunk always runs to give the first token. Image requests
    neither reuse nor register pages.

    As the JAX engine: the decode step runs all B lanes; idle lanes write
    into the null page 0 and mid-prefill or paused lanes at their frozen
    positions, which the next chunk overwrites. A chunk attends the
    quantized pages it has just written, not its fresh k/v. Unlike the JAX
    engine, a chunk runs the rows it has (the JAX engine pads them to a
    power of two to bound its compiles), and a lane's pages are capped at
    the table's MAXP: the JAX ``_ensure_pages`` asks for more, which stalls
    a lane forever at a tight pool (ROADMAP queue 3 (e)). Positions past S
    are never kept; their writes are dropped.
    """

    PREFILL = "prefill"
    DECODE = "decode"
    PREFILL_ROWS = 32  # most lanes in one chunk (server.py:1159)

    def __init__(
        self,
        params: dict,
        cfg: AriaConfig,
        *,
        max_lanes: int = 4,
        max_seq_len: int = 2048,
        page_size: int = 256,
        num_pages: Optional[int] = None,
        prefill_chunk: int = 128,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        decode_chunk: int = 16,
        cache_dtype=torch.bfloat16,
        rng_seed: int = 0,
        prefix_cache: bool = True,
        guided_fsm=None,
        adapters=None,
        mesh=None,
    ):
        super().__init__(params, cfg, max_lanes, temperature, top_k, decode_chunk, rng_seed,
                         adapters, guided_fsm, mesh=mesh)
        self.PS = page_size
        self.MAXP = -(-max_seq_len // page_size)
        self.S = self.MAXP * page_size
        self.C = prefill_chunk
        # default pool: half of full residency, one slack page per lane, the null page
        if num_pages is None:
            num_pages = 1 + max_lanes * (self.MAXP // 2 + 1)
        self.pool = PagePool(num_pages)
        self.cache = PagedKVCache.init(cfg.text, num_pages, page_size, cache_dtype,
                                       device=self.device)
        self.page_table = np.zeros((self.B, self.MAXP), np.int32)  # 0 = the null page
        # cached pages start at page multiples, so chunks must tile pages
        self.prefix_cache = prefix_cache and page_size % prefill_chunk == 0
        self.lane_keys: List[Optional[list]] = [None] * self.B
        self.lane_state: List[Optional[str]] = [None] * self.B  # PREFILL | DECODE | None
        self.lane_pages: List[list] = [[] for _ in range(self.B)]
        self.lane_embeds: List[Optional[torch.Tensor]] = [None] * self.B  # [1, n*C, D] in prefill
        self.lane_true_len = np.zeros(self.B, np.int32)

    @torch.inference_mode()
    def step(self) -> List[Request]:
        """One tick: admit, one prefill chunk, one decode chunk; returns the
        requests that finished."""
        while self._admit():
            pass
        self._prefill_tick()
        active = self._decode_mask()
        for lane in range(self.B):  # decode growth: one chunk of headroom
            if active[lane] and not self._ensure_pages(
                    lane, int(self.lane_pos[lane]) + self.decode_chunk + 1):
                active[lane] = False  # page pressure: this lane waits
        if active.any():
            table = torch.as_tensor(self.page_table, device=self.device)
            self._read_back(active, *self._decode_chunk(active, table))
        return self._take_finished()

    # ------------------------------------------------------------ lanes

    def _decode_mask(self) -> np.ndarray:
        return np.asarray([s == self.DECODE for s in self.lane_state], bool)

    def _admit(self) -> bool:
        """Start the request at the head of the queue: its pages and its
        prompt embedding, the lane marked mid-prefill (server.py:1075-1132).
        No chunk runs here."""
        lane = next((i for i, r in enumerate(self.lane_req) if r is None), None)
        if lane is None or not self.queue:
            return False
        req = self.queue[0]
        true_len = len(req.prompt_tokens)
        total = true_len + req.max_new_tokens
        if total > self.S:
            self.queue.popleft()
            req.done = True
            req.error = f"request {req.uid} needs {total} > max_seq_len {self.S}"
            self._finished.append(req)
            return True
        n_chunks = -(-true_len // self.C)
        need_pages = min(-(-(n_chunks * self.C) // self.PS), self.MAXP)
        # never the page of the last prompt token: a chunk must run for the
        # first token's logits
        shared: list = []
        keys = None
        if self.prefix_cache and req.pixel_values is None:
            # an adapter changes the k/v of the same prompt: its own keys
            keys = self._page_keys(req.prompt_tokens, salt=req.adapter_id)
            for key in keys[:(true_len - 1) // self.PS]:
                page = self.pool.lookup(key)
                if page is None:
                    break
                shared.append(page)
        fresh = self.pool.alloc(need_pages - len(shared))
        if fresh is None:
            self.pool.release(shared)  # pool pressure: stay queued
            return False
        pages = shared + fresh
        self.queue.popleft()
        self.page_table[lane, :need_pages] = pages
        self.lane_pages[lane] = pages
        self.lane_keys[lane] = keys
        self.lane_req[lane] = req
        self.lane_adapter[lane] = req.adapter_id
        self.lane_state[lane] = self.PREFILL
        self.lane_pos[lane] = len(shared) * self.PS  # the cached chunks are skipped
        req.cached_tokens = len(shared) * self.PS
        self.lane_true_len[lane] = true_len
        self.lane_temp[lane] = self.temperature if req.temperature is None else req.temperature
        self._set_lane_sampling(lane, req)
        if self._penalties:
            self.lane_pmask[lane] = False
            self.lane_pmask[lane, torch.as_tensor(req.prompt_tokens, device=self.device)] = True
            self.lane_counts[lane] = 0
        self.lane_embeds[lane] = self._embeds_for(req, n_chunks * self.C)
        return True

    def _page_keys(self, tokens: Sequence[int], salt: int = 0) -> list:
        """A chain hash per full prompt page: key i commits to tokens[:(i + 1)
        * PS], so equal keys mean equal positions and history and the cached
        KV holds verbatim. The hash starts from ``salt``, the request's
        adapter id, so the keys are the JAX package's."""
        h = hashlib.sha1(np.int32(salt).tobytes())
        keys = []
        for i in range(len(tokens) // self.PS):
            h.update(np.asarray(tokens[i * self.PS:(i + 1) * self.PS], np.int32).tobytes())
            keys.append(h.hexdigest())
        return keys

    def _embeds_for(self, req: Request, bucket: int) -> torch.Tensor:
        """[1, bucket, D] prompt embedding, image features scattered in."""
        dev = self.device
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :len(req.prompt_tokens)] = req.prompt_tokens
        feats = None
        if req.pixel_values is not None:
            pm = None if req.pixel_mask is None else torch.as_tensor(req.pixel_mask, device=dev)
            feats = encode_images(self.params, self.cfg,
                                  torch.as_tensor(req.pixel_values, device=dev), pm)
        return prepare_embeddings(self.params, self.cfg, torch.as_tensor(tokens, device=dev),
                                  image_features=feats)

    def _prefill_tick(self):
        """Advance every mid-prefill lane (at most PREFILL_ROWS) by one chunk
        in one batched call (server.py:1149-1225). A lane whose prompt is
        now written samples its first token on the device, read back with
        the next decode chunk, and publishes its full prompt pages."""
        lanes = [i for i, s in enumerate(self.lane_state) if s == self.PREFILL]
        lanes = lanes[:self.PREFILL_ROWS]
        if not lanes:
            return
        dev, C = self.device, self.C
        logits = self._chunk_logits(lanes)
        new_g = None
        if self.guided_fsm is not None:
            # the state is committed on the chunk that completes the prompt
            # only: an earlier chunk's sample is a placeholder (server.py:933-941)
            g0 = self._start_states([self.lane_req[l] for l in lanes])
            logits = self._guided(logits, g0)
        top_p = min_p = None
        if self._nucleus:
            top_p = torch.as_tensor(self.lane_top_p[lanes], device=dev)
            min_p = torch.as_tensor(self.lane_min_p[lanes], device=dev)
        toks = sample(self.generator, logits, torch.as_tensor(self.lane_temp[lanes], device=dev),
                      self.top_k, top_p, min_p)
        if self.guided_fsm is not None:
            new_g = guided_next_state(self.guided_fsm.trans, g0, toks)
        for idx, lane in enumerate(lanes):
            self.lane_pos[lane] += C
            true_len = int(self.lane_true_len[lane])
            if self.lane_pos[lane] < true_len:
                continue
            tok = toks[idx:idx + 1]  # this row's sample is the first token
            self.lane_tok[lane] = tok[0]
            if self._penalties:
                self.lane_counts[lane, tok.long()] += 1
            self._pending_first.append((lane, self.lane_req[lane], tok, None))
            if new_g is not None:
                self.lane_gstate[lane] = new_g[idx]
            self.lane_pos[lane] = true_len
            self.lane_state[lane] = self.DECODE
            self.lane_embeds[lane] = None
            # the prompt's full pages are complete, and decode writes only
            # past true_len: publish them
            if self.lane_keys[lane]:
                for key, page in zip(self.lane_keys[lane], self.lane_pages[lane]):
                    self.pool.register(key, page)
                self.lane_keys[lane] = None

    def _chunk_logits(self, lanes: List[int]) -> torch.Tensor:
        """The next chunk of each lane's prompt through the model, its k/v
        written into the lane's pages: [N, V] logits at each row's last
        prompt position in the chunk (its last position while the prompt
        goes on), penalized as a fresh request's."""
        dev, C = self.device, self.C
        starts = self.lane_pos[lanes]
        embeds = torch.cat([self.lane_embeds[l][:, int(o):int(o) + C]
                            for l, o in zip(lanes, starts)])
        offsets = torch.as_tensor(starts, device=dev)
        logit_at = np.clip(self.lane_true_len[lanes] - 1 - starts, 0, C - 1)
        logits = lm_forward(
            self.params["lm"], self.cfg.text, inputs_embeds=embeds,
            positions=offsets[:, None] + torch.arange(C, dtype=torch.int32, device=dev)[None, :],
            cache=self.cache, cache_pos=offsets,
            logit_position=torch.as_tensor(logit_at, device=dev),
            page_table=torch.as_tensor(self.page_table[lanes], device=dev),
            **self._lora_kwargs(self.lane_adapter[lanes])).logits[:, 0]
        if self._penalties:  # a fresh request's output counts are zero
            pres, freq, rep = (torch.as_tensor(a[lanes], device=dev)
                               for a in (self.lane_pres, self.lane_freq, self.lane_rep))
            logits = apply_penalties(logits, torch.zeros_like(logits, dtype=torch.int32),
                                     self.lane_pmask[torch.as_tensor(lanes, device=dev)],
                                     pres, freq, rep)
        return logits

    def _ensure_pages(self, lane: int, upto: int) -> bool:
        """Grow the lane's table to cover logical positions < upto, capped
        at the table's MAXP pages (positions past S are never kept)."""
        need = min(-(-upto // self.PS), self.MAXP)
        have = len(self.lane_pages[lane])
        if need <= have:
            return True
        extra = self.pool.alloc(need - have)
        if extra is None:
            return False
        self.page_table[lane, have:need] = extra
        self.lane_pages[lane].extend(extra)
        return True

    def _finish(self, lane: int):
        super()._finish(lane)
        self.pool.release(self.lane_pages[lane])
        self.page_table[lane, :] = 0
        self.lane_pages[lane] = []
        self.lane_keys[lane] = None  # an unfinished prefill registers nothing
        self.lane_state[lane] = None
        self.lane_embeds[lane] = None
