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
packed into bytes, ``models/moe_lm.KVCache``). Speculative decoding,
guided decoding and penalties are not ported for the single stream yet and
raise ``NotImplementedError`` (the batched engine, ``engine/server.py``,
has the penalties).

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
from typing import Optional, Sequence

import torch

from aria_tpu_torch.config import AriaConfig
from aria_tpu_torch.engine.sampling import sample
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
    guided: Optional[object] = None
    speculative: Optional[object] = None

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
    ) -> GenerateResult:
        """``pixel_values`` [N, C, S, S] (uint8 or float) and ``pixel_mask``
        [N, S, S] bool may be numpy arrays or tensors; the prompt carries one
        ``image_token_id`` per image feature."""
        if gen.speculative is not None:
            raise NotImplementedError("speculative decoding is not ported yet")
        if gen.guided is not None:
            raise NotImplementedError("guided decoding is not ported yet")
        if gen.uses_penalties:
            raise NotImplementedError("sampling penalties are not ported yet")
        true_len = len(prompt_tokens)
        bucket = _bucket(true_len)
        if bucket + gen.max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt bucket {bucket} + max_new_tokens {gen.max_new_tokens} "
                f"exceeds max_seq_len {self.max_seq_len}")
        dev = self.device
        tokens = torch.zeros((1, bucket), dtype=torch.long, device=dev)
        tokens[0, :true_len] = torch.as_tensor(list(prompt_tokens), dtype=torch.long)
        top_p = None if gen.top_p is None else torch.full((1,), float(gen.top_p), device=dev)
        min_p = None if gen.min_p is None else torch.full((1,), float(gen.min_p), device=dev)
        cache = KVCache.init(self.cfg.text, 1, self.max_seq_len, self.cache_dtype, device=dev,
                             mesh=self.mesh)
        lm, text_cfg = self.params["lm"], self.cfg.text

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
        cur = self._sample(out.logits[:, 0], gen, top_p, min_p)
        first = int(cur[0])  # waits for the prefill
        t1 = time.perf_counter()

        generated = [first]
        stop_ids = set(gen.stop_token_ids)
        stopped = first in stop_ids
        pos = true_len
        while not stopped and len(generated) < gen.max_new_tokens:
            n = min(gen.decode_chunk, gen.max_new_tokens - len(generated))
            chunk = []
            for _ in range(n):
                out = lm_forward(lm, text_cfg, cur[:, None].long(),
                                 positions=torch.full((1,), pos, device=dev),
                                 cache=cache, cache_pos=pos, mesh=self.mesh)
                cur = self._sample(out.logits[:, -1], gen, top_p, min_p)
                chunk.append(cur)
                pos += 1
            for t in torch.cat(chunk).tolist():  # one read-back per chunk
                generated.append(t)
                if t in stop_ids:
                    stopped = True
                    break
        t2 = time.perf_counter()

        for i, t in enumerate(generated):  # trim after a stop token
            if t in stop_ids:
                generated = generated[: i + 1]
                break
        return GenerateResult(tokens=generated, prefill_s=t1 - t0, decode_s=t2 - t1,
                              steps=len(generated) - 1)
