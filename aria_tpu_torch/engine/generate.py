"""Single-stream serving engine: prefill then chunked decode over a static
KV cache (counterpart of aria_tpu/engine/generate.py).

The prompt is padded to a power-of-two bucket; the prefill attends it with
causal flash and samples the first token at the last real position. Decode
runs one token per step in a Python loop where the JAX package runs a
jitted 50-step scan; tokens stay on the device and are read back once per
chunk of ``decode_chunk`` steps, where stop tokens are checked.

An image request runs the vision tower and projector as their own step
(``encode_images``, as the JAX engine's ``_encode_jit``) inside the timed
prefill window, so ``prefill_s`` is the image-to-first-token time; the
features are then scattered into the ``<|img|>`` slots of the prompt.

The KV cache is bf16, int8 or ``"int4"`` (``cache_dtype``; head pairs
packed into bytes, ``models/moe_lm.KVCache``).

Guided decoding (``GenerationConfig(guided=TokenFSM)``, engine/guided.py)
masks the logits of the prefill's sample and of every decode step with the
FSM row of the stream's state, which stays on the device; the penalties
keep a [1, V] count plane and the prompt mask there (sampling.py). A
``stop_check(tokens)`` is called at each chunk's read-back after every
token, as a stop token is (generate.py:393, :526).

Speculative decoding (``GenerationConfig(speculative=SpeculativeConfig)``,
engine/speculative.py) replaces the decode loop after the prefill: each
verify step drafts k tokens from the stream's history by n-gram lookup and
feeds the last token and the draft through one forward of k + 1 tokens
(generate.py:249-380). A chunk of ``steps_per_chunk`` verify steps runs
over device tensors (the history, its length, the position, the last
token) with one read-back. It composes with temperature, top-k, top-p and
min-p, not with guided decoding or the penalties, as in the JAX engine.
Unlike the JAX engine it honours ``stop_check`` (ROADMAP queue 3 (a)), and
``produced_per_step`` counts the tokens each verify step put into the
result, so they sum to ``steps`` (queue 3 (c)).

``mesh`` (``parallel/mesh.py``, over a ``torch.distributed`` group: every
rank builds the same Engine on the same parameters and calls ``generate``
with the same arguments) serves one stream from a cache sharded over the
ranks (generate.py:97-150): each rank allocates its block of it, heads
over ``model`` (all of them for int4) and positions over ``context``. The
parameters stay replicated, as the JAX layout of the int4 serving form
keeps all but the expert stacks. The prefill writes the positions of this
rank's block; under ``context`` it attends the written cache blockwise, and
decode merges the ranks' partial softmaxes (``parallel/cp_cache.py``).
Every rank returns the same tokens: they sample from generators seeded
alike, as the JAX engine draws from its one key.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import torch

from aria_tpu_torch.config import AriaConfig
from aria_tpu_torch.engine.guided import guided_mask, guided_next_state
from aria_tpu_torch.engine.sampling import apply_penalties, sample, update_counts
from aria_tpu_torch.engine.speculative import ngram_draft, verify_greedy, verify_sampled
from aria_tpu_torch.models.aria import encode_images, prepare_embeddings
from aria_tpu_torch.models.moe_lm import KVCache, lm_forward


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 256
    temperature: float = 0.8
    top_k: Optional[int] = 200
    top_p: Optional[float] = None
    min_p: Optional[float] = None
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    stop_token_ids: tuple[int, ...] = ()
    decode_chunk: int = 32
    guided: Optional[object] = None  # engine/guided.TokenFSM, on the engine's device
    speculative: Optional[object] = None  # engine/speculative.SpeculativeConfig

    @property
    def uses_penalties(self) -> bool:
        return (self.presence_penalty != 0.0 or self.frequency_penalty != 0.0
                or self.repetition_penalty != 1.0)


@dataclasses.dataclass
class GenerateResult:
    tokens: list[int]  # generated tokens (no prompt), truncated at a stop
    prefill_s: float
    decode_s: float
    steps: int
    # speculative runs only: the verify steps whose tokens are in ``tokens``,
    # and how many each put there (they sum to ``steps``)
    verify_steps: Optional[int] = None
    produced_per_step: Optional[list[int]] = None

    @property
    def tokens_per_s(self) -> float:
        return self.steps / self.decode_s if self.decode_s > 0 else float("inf")


def _bucket(n: int, minimum: int = 32) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class Engine:
    def __init__(
        self,
        params: dict,
        cfg: AriaConfig,
        *,
        max_seq_len: int = 2048,
        cache_dtype=torch.bfloat16,
        rng_seed: int = 0,
        mesh=None,  # parallel/mesh.Mesh: this rank's view of a serving mesh
    ):
        self.cfg = cfg
        self.params = params
        self.mesh = mesh
        # a multiple of 512, as the JAX engine allocates (generate.py:103)
        self.max_seq_len = -(-max_seq_len // 512) * 512
        self.cache_dtype = cache_dtype
        self.device = params["lm"]["final_norm"].device
        self.generator = torch.Generator(device=self.device).manual_seed(rng_seed)

    def _sample(self, logits, gen: GenerationConfig, top_p, min_p) -> torch.Tensor:
        return sample(self.generator, logits, gen.temperature, gen.top_k, top_p, min_p)

    @torch.inference_mode()
    def generate(
        self,
        prompt_tokens: Sequence[int],
        gen: GenerationConfig = GenerationConfig(),
        pixel_values=None,
        pixel_mask=None,
        stop_check: Optional[Callable[[list[int]], bool]] = None,
    ) -> GenerateResult:
        """``pixel_values`` [N, C, S, S] (uint8 or float) and ``pixel_mask``
        [N, S, S] bool may be numpy arrays or tensors; the prompt carries one
        ``image_token_id`` per image feature. ``stop_check`` sees the tokens
        so far after each one is read back and ends the stream when True."""
        true_len = len(prompt_tokens)
        bucket = _bucket(true_len)
        if bucket + gen.max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt bucket {bucket} + max_new_tokens {gen.max_new_tokens} "
                f"exceeds max_seq_len {self.max_seq_len}")
        dev = self.device
        fsm = gen.guided
        penalized = gen.uses_penalties
        sp = gen.speculative
        if sp is not None:
            if fsm is not None or penalized:
                raise ValueError("speculative decoding composes with temperature/top_k/top_p/"
                                 "min_p but not (yet) with guided decoding or sampling penalties")
            if self.mesh is not None:
                raise NotImplementedError("speculative decoding over a serving mesh is not "
                                          "ported (ROADMAP queue 1, item 11)")
            # the JAX engine's slack (generate.py:404-423): two chunks of verify
            # rows past max_new_tokens, and k more written from the last position
            slack = 2 * sp.steps_per_chunk * (sp.k + 1) + sp.k
            if bucket + gen.max_new_tokens + slack > self.max_seq_len:
                raise ValueError(
                    f"speculative decoding needs {slack} slack cache rows: bucket {bucket} + "
                    f"max_new {gen.max_new_tokens} + {slack} > max_seq_len {self.max_seq_len}")
        if fsm is not None and fsm.device != dev:
            raise ValueError(f"the guided FSM is on {fsm.device}, the model on {dev}: build it "
                             "with device= or move it with .to()")
        tokens = torch.zeros((1, bucket), dtype=torch.long, device=dev)
        tokens[0, :true_len] = torch.as_tensor(list(prompt_tokens), dtype=torch.long)
        top_p = None if gen.top_p is None else torch.full((1,), float(gen.top_p), device=dev)
        min_p = None if gen.min_p is None else torch.full((1,), float(gen.min_p), device=dev)
        cache = KVCache.init(self.cfg.text, 1, self.max_seq_len, self.cache_dtype, device=dev,
                             mesh=self.mesh)
        lm, text_cfg = self.params["lm"], self.cfg.text
        gstate = None
        if fsm is not None:
            gstate = torch.full((1,), fsm.start, dtype=torch.int32, device=dev)
        if penalized:  # a [1, V] count plane and the prompt mask (generate.py:486-497)
            V = text_cfg.vocab_size
            counts = torch.zeros((1, V), dtype=torch.int32, device=dev)
            pmask = torch.zeros((1, V), dtype=torch.bool, device=dev)
            pmask[0, tokens[0, :true_len]] = True
            pen = tuple(torch.full((1,), float(v), device=dev) for v in (
                gen.presence_penalty, gen.frequency_penalty, gen.repetition_penalty))

        def pick(logits):
            """Penalties, the FSM's mask, the draw, then the counts and the
            FSM's state (generate.py:225-237)."""
            nonlocal gstate
            if penalized:
                logits = apply_penalties(logits, counts, pmask, *pen)
            if fsm is not None:
                logits = guided_mask(fsm.trans, fsm.accepting, fsm.stop_mask, gstate, logits)
            tok = self._sample(logits, gen, top_p, min_p)
            if penalized:
                update_counts(counts, tok)
            if fsm is not None:
                gstate = guided_next_state(fsm.trans, gstate, tok)
            return tok

        t0 = time.perf_counter()
        feats = None
        if pixel_values is not None:
            pm = None if pixel_mask is None else torch.as_tensor(pixel_mask, device=dev)
            feats = encode_images(self.params, self.cfg,
                                  torch.as_tensor(pixel_values, device=dev), pm)
        embeds = prepare_embeddings(self.params, self.cfg, tokens, image_features=feats)
        out = lm_forward(lm, text_cfg, inputs_embeds=embeds,
                         positions=torch.arange(bucket, device=dev), cache=cache,
                         cache_pos=0, logit_position=true_len - 1, causal_flash=True,
                         mesh=self.mesh)
        cur = pick(out.logits[:, 0])
        first = int(cur[0])  # waits for the prefill
        t1 = time.perf_counter()

        stop_ids = set(gen.stop_token_ids)
        if sp is not None:
            generated, per_step = self._speculative(gen, tokens[0, :true_len], cache, cur, first,
                                                    top_p, min_p, stop_check)
            return GenerateResult(tokens=generated, prefill_s=t1 - t0,
                                  decode_s=time.perf_counter() - t1, steps=len(generated) - 1,
                                  verify_steps=len(per_step), produced_per_step=per_step)
        generated = [first]
        stopped = first in stop_ids
        pos = true_len
        while not stopped and len(generated) < gen.max_new_tokens:
            n = min(gen.decode_chunk, gen.max_new_tokens - len(generated))
            chunk = []
            for _ in range(n):
                out = lm_forward(lm, text_cfg, cur[:, None].long(),
                                 positions=torch.full((1,), pos, device=dev),
                                 cache=cache, cache_pos=pos, mesh=self.mesh)
                cur = pick(out.logits[:, -1])
                chunk.append(cur)
                pos += 1
            for t in torch.cat(chunk).tolist():  # one read-back per chunk
                generated.append(t)
                if t in stop_ids or (stop_check is not None and stop_check(generated)):
                    stopped = True
                    break
        t2 = time.perf_counter()

        for i, t in enumerate(generated):  # trim after a stop token
            if t in stop_ids:
                generated = generated[: i + 1]
                break
        return GenerateResult(tokens=generated, prefill_s=t1 - t0, decode_s=t2 - t1,
                              steps=len(generated) - 1)

    def _speculative(self, gen: GenerationConfig, prompt: torch.Tensor, cache: KVCache,
                     cur: torch.Tensor, first: int, top_p, min_p, stop_check):
        """The verify loop after the prefill (generate.py:249-380): chunks of
        ``steps_per_chunk`` draft-verify-accept steps over device tensors,
        each chunk's produced tokens and counts read back at once. Returns
        the tokens and how many each verify step put into them."""
        sp, dev = gen.speculative, self.device
        lm, text_cfg = self.params["lm"], self.cfg.text
        K1 = sp.k + 1
        true_len = prompt.shape[0]
        cap = sp.steps_per_chunk * K1
        hist = torch.zeros((1, self.max_seq_len + 2 * cap + sp.ngram), dtype=torch.int32,
                           device=dev)
        hist[0, :true_len] = prompt
        hist[0, true_len] = cur[0]
        hist_len = torch.full((1,), true_len + 1, dtype=torch.int32, device=dev)
        pos = torch.full((1,), true_len, dtype=torch.int32, device=dev)
        steps = torch.arange(K1, dtype=torch.int32, device=dev)[None, :]
        greedy = gen.temperature <= 0.0 and top_p is None and min_p is None

        stop_ids = set(gen.stop_token_ids)
        generated = [first]
        stopped = first in stop_ids
        per_step: list[int] = []
        while not stopped and len(generated) < gen.max_new_tokens:
            prods, n_prods = [], []
            for _ in range(sp.steps_per_chunk):
                draft = ngram_draft(hist, hist_len, sp.ngram, sp.k)
                fed = torch.cat([cur[:, None], draft], dim=1)
                logits = lm_forward(lm, text_cfg, fed.long(), positions=pos[:, None] + steps,
                                    cache=cache, cache_pos=pos).logits.float()  # [1, k+1, V]
                if greedy:
                    prod, n_prod = verify_greedy(logits, draft)
                else:
                    prod, n_prod = verify_sampled(self.generator, logits, draft, gen.temperature,
                                                  gen.top_k, top_p, min_p)
                hist.scatter_(1, (hist_len[:, None] + steps).long(), prod)
                cur = prod.gather(1, (n_prod - 1).long()[:, None])[:, 0]
                pos, hist_len = pos + n_prod, hist_len + n_prod
                prods.append(prod[0])
                n_prods.append(n_prod)
            host = torch.cat([*prods, *n_prods]).tolist()  # one read-back per chunk
            counts = host[len(prods) * K1:]
            for i, n in enumerate(counts):
                emitted = 0
                for t in host[i * K1:i * K1 + n]:
                    generated.append(t)
                    emitted += 1
                    if t in stop_ids or (stop_check is not None and stop_check(generated)):
                        stopped = True
                    if stopped or len(generated) >= gen.max_new_tokens:
                        break
                per_step.append(emitted)
                if stopped or len(generated) >= gen.max_new_tokens:
                    break
        return generated, per_step
