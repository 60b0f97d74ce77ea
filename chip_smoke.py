#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``aria_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. Device: the card's name and power limit.
2. Build the hand kernels from ``aria_tpu_torch/csrc`` (nvcc, sm_90a) and
   hold each against its plain PyTorch version at the shapes the text,
   image, lanes, paged and forms paths give it, with the tolerance stated beside each,
   timing kernel, plain version and, where one exists, one PyTorch call
   of the same function, beside the kernel's bound (bytes over the memory
   rate or operations over the peak rate, the larger). At long context:
   the causal flash forward at 8,192 and 32,768 prompt tokens (the latter
   held on its first and last 128 rows), decode attention at one lane over
   32,768 positions (int4, int8, bf16), both held row by row beside a
   planted fault, and decode attention with its split over positions
   forced to 1 against the split the wrapper picks. The fused prologue
   ``rope_kv_write`` (RoPE and the cache's quantization and write in one
   kernel a layer) bit-equal to the plain chain it replaced, in the three
   cache forms, at decode T = 1 and 32, on pages, at the speculative
   verify step's 8 tokens from a per-lane position, and at the from-zero
   prefill of 512 and 8,192 tokens (RoPE's bf16 branch).
3. The text path: random-init the full-width, 64+2-expert int4 serving
   model on the card at ``SERVING_LAYERS`` (14) of its 28 decoder layers
   (the serving paths through 6f and the forms share that depth, cut so
   that ep-serve and train-mesh fit the run's time; the per-step launch
   counts below are a layer's times that depth), build
   ``Engine(max_seq_len=1024, int8 KV)``
   and answer three text requests through ``Engine.generate``; the five
   kernels of that path must each launch, and no layer of a decode step or
   of a from-zero prefill may call ``apply_rope`` or ``quantize_kv`` (the
   fused prologue takes them whole; so on every serving path below but
   the cp phase's).
4. The image path (bench.py's default request): add the 27-layer ViT and
   the projector (int8, as bench.py builds them) and serve one 980px crop
   with the prompt [11]*8 + [9]*256 + [13]*8 through ``Engine.generate``;
   its seven kernels must each launch. Then the image prefill's device time
   by kernel, its launches beside the chain's, and the card against the CPU's plain versions at reduced
   depth: ``encode_images`` with 2 ViT layers, and a 2-layer prefill over
   more than 128 tokens.
5. The lanes path (bench.py's lanes child): ``BatchedEngine`` with 32
   lanes and the int4 KV cache serves a warm-up round of 32 x 50 tokens
   and a timed one of 32 x 100 (cut from 200 to make room for ep-serve
   and train-mesh); ``rope_kv_write`` and the int4
   decode attention must launch. Then a profiled decode chunk (and the
   same chunk through the chain the fused prologue replaced: launches and
   busy time a step, side by side), a greedy int8-KV check, and a 2-layer
   batched decode step against the CPU.
6. The paged path (bench.py's lanes child with ``--paged --kv-int8``):
   ``PagedBatchedEngine`` with 32 lanes on int8 pages serves a warm-up
   round of 32 x 50 tokens and a timed one of 32 x 100 (cut from 200)
   through 128-token
   prefill chunks; ``paged_decode_attention`` must launch once per layer of
   every decode step. Then a profiled prefill tick and decode chunk (beside
   the chain's), where
   a row's result depends on the rows beside it (op by op), two
   prefix-cache rounds at the served chunk (the first request alone,
   reported; beside a companion, held, with two planted faults that must
   exceed the limit), the tight-pool request that stalls the JAX engine,
   and a 2-layer paged chunk and decode step against the CPU.
6b. Adapters (multi-LoRA serving), while the int4 model is resident: three
   adapters from the seed (the LoRA recipe's rank 8 and alpha 32 on all
   six targets, rank 16, and rank 8 on attention only) in one
   ``AdapterRegistry``; ``BatchedEngine(adapters=)`` with the int4 KV
   cache serves 32 greedy 48-token prompts (8 on the base, 8 on each
   adapter) x 16 tokens twice: the streams repeat, each adapter moves
   some, and each decode step launches ``expert_block_dequant`` 12 times a
   layer (336). Then a profiled mixed decode chunk (busy share, peak
   memory), a base-only round equal token for token to the plain
   ``BatchedEngine``'s, a 2-layer mixed prefill and decode step against
   the CPU (held to 5e-2, its bf16 witness beside it), one layer's blocked
   expert-LoRA MoE against the CPU (held to two bf16 roundings), and
   ``PagedBatchedEngine(adapters=)``'s prefix keys salted by adapter.
6c. Variants, on the same int4 model: the JAX package's three
   off-by-default kernel variants on (``DENSE_A8``, ``MOE_A8`` off,
   ``VIT_FLASH`` off; restored afterwards). bench.py's image request
   through ``Engine`` (a warm-up, one sampled 200-token request, two
   greedy ones: each decode step launches ``dense_int4_a8`` 56 and
   ``moe_decode_int4_bf16`` 28 times, the ViT ``flash_segment`` 27 times,
   and neither ``vit_flash`` nor the W4A8 MoE launches) and the lanes
   child through ``BatchedEngine`` (a warm-up and a timed round), a
   profiled chunk, the A/B against the default's numbers from this call,
   a 2-layer prefill (held to 5e-2 and its bf16 witness) and decode step
   (reported beside its witness) against the CPU, and layer 0's W4A8
   projections and bf16-activation MoE against the CPU on the same rows
   and routing (held to their rounding).
6e. The serving features, on the same int4 model: ``Engine`` (int8 KV)
   answers a 96-token repetitive prompt (one seeded 12-token phrase said 8
   times) with 128 greedy tokens, plainly and by prompt-lookup speculative
   decoding (k 7, 2-gram, 8 verify steps a read-back): the verify steps,
   the tokens each produced, both rates, how many leading tokens agree
   (reported: plain attention over 8 rows is not bit-equal to the decode
   kernel over one), and one verify forward's launches and device time
   beside a decode forward's. Guided decoding over ``ByteTokenizer``
   padded to the model's ids, a finite regex: an ``Engine`` stream that
   matches it, and a guided decode step's wall beside an unguided one's; a
   32-lane ``BatchedEngine`` with every other lane guided, whose unguided
   lanes must equal a plain engine's greedy streams token for token;
   ``PagedBatchedEngine`` with two of four lanes guided (JSON mode and
   engine logprobs are the front door's requests, 6f). A
   repetition-penalized ``Engine`` request. The path must launch
   ``dense_int4``, the W4A8 ``moe_decode_int4``, ``decode_attention``,
   ``flash_causal``, ``rope_kv_write`` and ``paged_decode_attention``, and
   the verify steps take the fused prologue. Held at 2 layers (5e-2, each
   with its bf16 witness): one verify step's logits against 8 decode
   steps' fed the same tokens, on the card; the logprobs of a 4-lane
   ``BatchedEngine`` against the CPU's for the same tokens; a
   repetition-penalized first token's logits against the CPU's.
6f. The front doors. (a) On the same int4 model, with a ViT and projector
   (int8): ``engine/http_server.py``'s ``ServingLoop`` over a 4-lane
   ``BatchedEngine`` (int8 KV, greedy, the JSON-mode FSM, logprobs top 5)
   behind a ``ThreadingHTTPServer`` on 127.0.0.1, ``ByteTokenizer``.
   ``/health``; a greedy 32-token ``/generate`` plainly and streamed (equal
   tokens); 4 concurrent ``/v1/completions`` with logprobs, admitted as one
   group; a ``/v1/chat/completions`` carrying a 980 px PNG as a base64 data
   URL; JSON mode greedy and twice at T 1.0 (JSON objects or live
   prefixes); a streamed request dropped after its first chunk, whose lane
   must be free within FRONT_DROP_TICKS ticks; ``/metrics``. Every greedy
   request's tokens (and the completions' logprobs) equal the same prompts
   served straight through the engine in the same grouping; each request's
   wall, first chunk and tok/s beside the straight ones; the int4 path's
   seven kernels must launch. (b) After ``del lm``: the script writes an
   HF-layout bf16 checkpoint (2 decoder and ViT layers at full width, one
   shard a decoder layer plus head, vision and projector; its own
   safetensors writer) to a temporary directory; the streamed int4 import
   must equal quantize-after-import bit for bit with a device peak at
   least 3 GiB below it (seconds, GB/s, device and host RssAnon peaks of
   both); ``cli/serve.py``'s builder serves the directory in its default
   int8 form and one ``/v1/completions`` over HTTP gives
   ``Engine.generate``'s greedy tokens, through ``moe_decode_quant`` and
   ``gmm``. The directory is removed.
6d. Context-parallel serving (cp), after the int4 model is freed: two
   ranks share cuda:0 over gloo (NCCL refuses two ranks on one device),
   spawned by ``parallel/distributed.run_ranks``, each with the full int4
   model from the phase's seed. ``Engine(mesh=context 2)`` with an int8
   cache of 8,704 positions (4,352 a rank) serves a 6,000-token prompt with
   64 greedy tokens: ``decode_attention_stats`` launches 28 times a decode
   step on each rank and the normal decode kernel never; prefill s, tok/s,
   peak memory and the agreement with one card's engine are printed. Held:
   2 layers of the same weights with a bf16 cache, the CP engine's
   first-token and 8 decode steps' logits within 5e-2 of one card's
   (bf16-activation MoE; the W4A8 reading printed beside; the limit from
   tools/cp_witness.py's reading of the JAX package), rank 1's partials
   left out at 10x it or more; ``BatchedEngine(mesh=model 2)`` with an
   int8 cache, 8 lanes x 32 greedy tokens, equal to one card's, its decode
   steps writing through ``kv_cache_write`` (a mesh's writers keep the
   chain: ``rope_kv_write`` must not launch).
6g. Expert-parallel serving (ep-serve), after cp: four ranks share cuda:0
   over gloo, each with its 16 of the 64 experts of the full-width,
   28-layer int4 serving form with the shared experts unfused, drawn from
   the phase's seed (``init_lm_params_serving_int4(fuse_shared=False,
   mesh=)``), the rest replicated. ``Engine(mesh=expert 4)`` with int8 KV
   answers a 64-token prompt (the decode-MoE kernel over each rank's whole
   stack) and a 300-token one (bucket 512: each layer's 16 experts
   dequantized by ``expert_block_dequant``, through ``gmm``) with 32
   greedy tokens each: ``moe_decode_int4`` launches 28 times a decode step
   on each rank, and no collective carries more than the token buffers
   (each call's bytes logged). Printed: tok/s, each rank's peak, the
   collectives' share of the decode steps' wall. Held at 2 layers of one
   whole 2-layer model: expert 4 and expert 2 (data 2 x expert 2) give the
   same greedy tokens; the EP prefill's last-position logits within
   ``EP_REF_LIMIT`` of one card's (a bf16 witness beside it);
   ``BatchedEngine(mesh=expert 2 x model 2)``'s 8 x 32 greedy streams
   against one card's (leading tokens that agree, printed).
7. The forms (bench.py without ``--int4``): with the int4 model freed,
   the int8 and then the bf16 serving form at full width and
   ``SERVING_LAYERS`` deep, the ViT and projector bf16. int8: bench.py's
   image request sampled (a 50-token warm-up, then 100 tokens, cut from
   200) and twice greedy
   through ``Engine``
   (bf16 KV), bench.py's lanes child
   through ``BatchedEngine`` (32 lanes, bf16 KV, 64 tokens, a warm-up and
   a timed round), and a 2-layer prefill and decode step against the
   CPU (held to the larger of 5e-2 and 3 times its bf16 witness); bf16:
   the image request once sampled and twice greedy, and the same
   reference. Each path must launch its form's decode MoE kernel,
   ``gmm`` and the attention kernels, and none of the int4 kernels.

8. Training: with the forms freed, three runs through ``train()`` at full
   width on text and 980px image rows the script writes, batch 1 x 2048,
   2 optimizer steps each (2 accumulated micro steps a step; cut from 3):
   train-lora,
   the LoRA recipe (recipes/config_lora.yaml) on a random bf16 base at 4
   decoder layers (the frozen ViT runs ``vit_flash``); train-qlora, the
   same recipe with ``quantize_base`` at ``QLORA_LAYERS`` (14; cut from
   28) layers over the int8 base
   that ``train()`` quantizes a layer at a time (``expert_block_dequant``
   must launch); train-vit, the full recipe (recipes/config_full.yaml)
   with ``freeze_vit`` false and its mesh fields set to 1, at 2 decoder
   layers and the whole ViT, at the recipe's batch of 8 with every 2nd row
   an image: ``flash_segment`` with row statistics and
   ``flash_segment_bwd`` launch 27 times each per ViT call, ``vit_flash``
   never, and the epoch-end checkpoint is written; its micro steps' ms are
   printed by their images beside the first design's. Each prints the base's
   build (seconds, device peak, resident bytes beside the bf16 form's),
   each micro step's ms, tokens/s, loss and gradient norm, the peak
   memory, the device's busy share (with a check that the profile holds
   every launch the wrappers counted) and the device time by kernel; the
   flash backward must launch on all three, ``gmm``, ``split_hi_lo``,
   ``gmm_dlhs`` and ``tgmm`` on train-vit. Then one micro step at 2
   decoder layers and 512 tokens of each of: LoRA over the bf16 base,
   QLoRA over the int8 base, and train-vit's recipe with a 2-layer ViT,
   the projector and the decoder trained on a 490px image; each on the
   card against the CPU's plain versions, leaf by leaf.
8b. train-mesh (run right after the build, while the main process holds
   the least of the card: the 8 ranks fill it): recipes/config_full.yaml
   with its mesh as written (fsdp 2 x expert 4), 8 ranks sharing cuda:0
   over gloo through ``train()``, each rank's allocator capped at an
   eighth of the card's free memory (``share_card``): full
   width, 2 decoder layers, the whole ViT frozen (as the recipe says), its
   batch of 8 with every 2nd row a 980px image, 2 optimizer steps of 2
   micro steps, at 512 tokens (``TRAIN_MESH_SEQ``: 8 ranks' logits at
   2,048 do not fit the card). ``gmm``, ``gmm_dlhs``, ``tgmm``,
   ``split_hi_lo``, the flash forward and backward and ``vit_flash`` must
   launch on every rank. Printed: each micro step's ms, each rank's peak
   and resident parameter and optimizer bytes beside one rank's, the
   collectives' share. Held against one rank's ``train()`` on the same
   global batches and weights: every micro step's loss and aux loss (2e-3
   relative) and grad_norm (``TRAIN_MESH_NORM``); rank 0's epoch-end
   checkpoint loads on one rank, its optimizer moments within
   ``TRAIN_MESH_MOMENT`` of one rank's and each trainable leaf's change
   from its initial value within ``TRAIN_MESH_CHANGE`` of one rank's
   (``tools/train_mesh_faults.py`` plants faults that these checks read).

Phase 2 also holds the variants' kernels at their path's shapes
(``dense_int4_a8`` bit-equal, ``moe_decode_int4_bf16`` beside the W4A8
kernel with its row bits, ``flash_segment`` at 4,900 patches all valid and 3,150 valid, to
an absolute 3e-3), the ViT's training attention (``flash_segment`` with its
row statistics, bit-equal to the serving forward, and ``flash_segment_bwd``
against its plain version at [1, 4900, 16, 72] all valid, 3,150 valid as a
prefix and as a portrait crop's patches, [2, 300, 2, 72] and [1, 129, 4,
64], cotangents zero on pad rows, with a planted fault and a second call's
bits),
``decode_attention_stats`` (the stats form of decode attention) over one
rank's block of the cp phase's cache, bf16, int8 and int4, at 1 and 32
lanes (absolute on acc / s, ``STATS_LIMIT``), and two blocks merged
against one launch over both,
``moe_decode``, ``moe_decode_quant`` and ``gmm`` at the forms' shapes,
``expert_block_dequant`` at the adapters path's blocks (int4 and int8, bf16 and f32 out, bit-equal), and the training
kernels at the train phase's shapes: the flash forward, its row log-sum-exp and its backward at
[1, 2048, 20, 128] and [8, 2048, 20, 128]; ``gmm``, ``split_hi_lo``,
``gmm_dlhs`` and ``tgmm`` at the full recipe's 98,304 rows, the backward
for w1's bf16-exact cotangent (training's) and a 16-bit one, with a
cancellation witness held to 1e-2 of its own size and, with the lo product
skipped, a planted fault that must exceed it. Each path sets every launch
count to 0 just before it runs and reads them
just after. Any failure raises and exits non-zero; without a CUDA device
the script exits non-zero before printing any result. The line before the
last is the kernels' JSON record (``launches`` from the newest path that
runs the kernel, ``launches_by_path`` from each); the last line is the
device record.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# The decoder's depth on the serving paths (text through the front doors,
# and the forms), cut from 28 so that ep-serve and train-mesh fit the run's
# time; cp and ep-serve build their own 28-layer models.
SERVING_LAYERS = 14
QLORA_LAYERS = 14  # train-qlora's decoder layers (cut from 28 for the same reason)


def _gpu_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int, warmup: int = 2) -> tuple[float, float]:
    """(device ms, wall ms) per call. Device time is the sum of the times of
    every kernel the call launched (the profiler's device events; its CPU
    events carry the same time again); wall time is CUDA events around
    back-to-back calls, which the host bounds when a call's launches take
    longer to issue than to run. Profile early: after the serving phases'
    profiles the profiler was seen to drop some of the card's events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    return device_us / iters / 1e3, wall


def _compare(name, got, ref, tol: float, why: str, absolute: bool = False) -> float:
    """max |got - ref| must be <= tol * max(1, max |ref|), or <= tol where
    ``absolute``."""
    import torch

    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    g, r = got.float(), ref.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (g - r).abs().max().item()
    bound = tol if absolute else tol * max(1.0, r.abs().max().item())
    print(f"  {name}: max_abs_err {err:.3e} (limit {bound:.3e}: {why})", flush=True)
    if err > bound:
        raise AssertionError(f"{name}: max_abs_err {err} > {bound}")
    return err


# flash_segment's limit at the ViT's [1, 4900, 16, 72], absolute: about 3x
# the 9.8e-4 (one bf16 ulp of its largest outputs, ~0.14) it reads on the
# card; dropping the last partial key tile (36 keys) moves an output by ~5e-2
FLASH_SEG_ATOL = 3e-3

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
L2_BYTES = 50 * 2**20  # H100 SXM L2
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}  # dense tensor-core peaks


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes: float, ops: float, kind: str = "bf16") -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over
    the memory rate (each input read once, each output written once) and
    the operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _timed(at, kernel, plain, iters, plain_iters, bound, library=None) -> dict:
    """One timed shape: device and wall ms of kernel and plain version (None
    where the plain version cannot run whole: "n/a"), the bound, and the
    device ms of one PyTorch call of the same function."""
    return {"at": at, "k": _time_ms(kernel, iters),
            "p": (None, None) if plain is None else _time_ms(plain, plain_iters),
            "bound": bound, "lib": None if library is None else _time_ms(library, iters)[0]}


def _print_timed(name: str, t: dict) -> None:
    lib = "none" if t["lib"] is None else f"{t['lib']:.4f} ms"
    plain = ("n/a (rows only)", "n/a") if t["p"][0] is None else (
        f"{t['p'][0]:.4f} ms", f"{t['p'][1]:.4f} ms")
    print(f"  {name} {t['at']}: device time per call: kernel {t['k'][0]:.4f} ms, plain "
          f"{plain[0]}, library {lib}, bound {t['bound'][0]:.4f} ms "
          f"({t['bound'][1]}); wall per call: kernel {t['k'][1]:.4f} ms, plain "
          f"{plain[1]}", flush=True)


def _entry(t: dict) -> dict:
    return {"ms": t["k"][0], "plain_ms": t["p"][0], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["lib"]}


def _record(results: dict, name: str, errs, timed) -> None:
    """A kernel's record: the worst error over the shapes checked, its first
    timed shape's numbers and every timed shape's ("times"), printed."""
    results[name] = {"max_abs_err": max(errs), **_entry(timed[0]),
                     "times": [{"at": t["at"], **_entry(t)} for t in timed]}
    for t in timed:
        _print_timed(name, t)


def _check_rope_kv_write(device, gen, cfg, record, lanes, lanes_seq, page_size, paged_seq):
    """``rope_kv_write``, the fused prologue, against its plain chain
    (``qkv.to(bf16)``, ``apply_rope``, ``quantize_kv``, the write) on the
    same inputs, bit-equal: the query (q, k and v
    at prefill), the cache's bytes and its scales, in the three cache forms
    at decode T = 1 (one position, the single-stream engines) and T =
    ``lanes`` (per-lane positions), at the speculative verify step's B = 1,
    S = 8 (one slot a token from a per-lane position), on ``lanes`` lanes of int8 and bf16
    pages (an idle lane on the null page, one past its table; page 0, which
    the idle lanes share, left out), and at the from-zero prefill of 512
    tokens and of LONG_SEQ (RoPE's bf16 branch). Timed beside the plain
    chain and its byte bound (the f32 qkv rows, cos and sin, the
    destinations, the query or q, k, v out, and the bytes and scales of the
    tokens that write); no PyTorch call computes it. The prefill is timed
    over copies of qkv that together hold twice the card's L2, so each
    call reads its qkv from memory, as the image prefill does after the
    wqkv product; the decode shapes (under 1 MB) are timed L2-warm."""
    import torch

    from aria_tpu_torch.models.moe_lm import KVCache
    from aria_tpu_torch.ops import kv_write as kw
    from aria_tpu_torch.ops.paged_attention import PagedKVCache, write_index
    from aria_tpu_torch.ops.rope import LONG_SEQ, precompute_rope

    print("rope_kv_write", flush=True)
    H, Dh = cfg.num_heads, cfg.head_dim
    two = dataclasses.replace(cfg, num_layers=2)  # layer 1 is written
    forms = {"int8": torch.int8, "int4": "int4", "bf16": torch.bfloat16}
    errs, timed = [], []
    # label, lanes, tokens a lane, paged; the main path's shapes timed
    cases = (("decode T=1", 1, 1, False), (f"decode T={lanes}", lanes, 1, False),
             (f"paged T={lanes}", lanes, 1, True), ("verify B=1 S=8", 1, 8, False),
             ("prefill 512", 1, 512, False),
             (f"prefill {LONG_SEQ} (bf16 rotation)", 1, LONG_SEQ, False))
    for label, B, S, paged in cases:
        verify = label.startswith("verify")
        for form, dtype in forms.items():
            if paged and form == "int4":
                continue  # pages are bf16 or int8
            qkv = (torch.randn((B, S, 3 * H * Dh), generator=gen, device=device)
                   * torch.rand((B, S, 3 * H * Dh), generator=gen, device=device) * 4)
            if paged:
                NP = 1 + 2 * B  # two pages a lane: paged_seq positions
                caches = [PagedKVCache.init(two, NP, page_size, dtype, device=device)
                          for _ in range(2)]
                table = (torch.randperm(NP - 1, generator=gen, device=device) + 1).to(
                    torch.int32).reshape(B, 2)
                table[B - 2] = 0  # an idle lane: the null page
                pos = torch.randint(0, paged_seq, (B,), generator=gen, device=device,
                                    dtype=torch.int32)
                pos[B - 1] = paged_seq  # past its table: page -1
                pages, slots = write_index(table, pos, 1, page_size)
                rows, slots, positions = pages.reshape(-1), slots.reshape(-1), pos[:, None]
            else:
                caches = [KVCache.init(two, B, max(lanes_seq, S), dtype, device=device)
                          for _ in range(2)]
                if verify:  # lane 0's S tokens from a per-lane position
                    start = torch.full((1,), lanes_seq // 2, dtype=torch.int32, device=device)
                    rows = torch.zeros(S, dtype=torch.int32, device=device)
                    slots = start + torch.arange(S, dtype=torch.int32, device=device)
                    positions = slots[None, :]
                elif S > 1:  # the from-zero prefill
                    rows = torch.zeros(S, dtype=torch.int32, device=device)
                    slots = torch.arange(S, dtype=torch.int32, device=device)
                    positions = slots
                elif B == 1:  # one position, as Engine's decode step
                    rows = torch.zeros(1, dtype=torch.int32, device=device)
                    slots = torch.full((1,), lanes_seq // 2, dtype=torch.int32, device=device)
                    positions = slots
                else:
                    rows = torch.arange(B, dtype=torch.int32, device=device)
                    slots = torch.randint(0, lanes_seq, (B,), generator=gen, device=device,
                                          dtype=torch.int32)
                    positions = slots[:, None]
            cos, sin = precompute_rope(positions, Dh, cfg.rope_base)
            fresh = S > 1 and not verify
            args = [(qkv, cos, sin, c, 1, rows, slots, H) for c in caches]
            got = kw.rope_kv_write(*args[0], fresh=fresh, null_page=paged)
            want = kw.rope_kv_write_plain(*args[1], fresh=fresh, null_page=paged)
            torch.cuda.synchronize()
            planes = [dataclasses.astuple(c) for c in caches]
            same = all(torch.equal(a, b) for a, b in zip(got, want) if a is not None) and all(
                torch.equal(a[:, 1:], b[:, 1:]) if paged else torch.equal(a, b)
                for a, b in zip(*planes) if a is not None)
            if not same:
                raise AssertionError(f"rope_kv_write {label}, {form} cache: differs from its "
                                     "plain chain")
            print(f"  rope_kv_write {label}, {form} cache: {'q, k, v' if fresh else 'q'}, the "
                  "cache's bytes and scales equal to the plain chain's (limit: bit-equal)",
                  flush=True)
            errs.append(0.0)
            if S == LONG_SEQ or (form != "int8" and (paged or S > 1)):
                continue  # timed: every decode form; int8 pages, verify and image prefill
            live = (rows >= 0) & (rows < caches[0].k.shape[1]) & (slots < caches[0].k.shape[3])
            n = int(live.sum())
            per_token = 2 * caches[0].k[0, 0, :, 0].numel() * caches[0].k.element_size()
            if caches[0].quantized:
                per_token += 2 * H * caches[0].k_scale.element_size()
            nbytes = _nbytes(qkv, cos, sin, rows, slots, *(t for t in got if t is not None))
            copies = [qkv] + [qkv.clone() for _ in range(
                -(-2 * L2_BYTES // _nbytes(qkv)) - 1 if fresh else 0)]
            turn = itertools.count()

            def call(fn, cache, copies=copies, turn=turn, fresh=fresh, paged=paged):
                fn(copies[next(turn) % len(copies)], *args[0][1:3], cache, *args[0][4:],
                   fresh=fresh, null_page=paged)

            timed.append(_timed(
                f"{label}, {form} cache" + (f", {len(copies)} qkv copies" if fresh else ""),
                lambda: call(kw.rope_kv_write, caches[0]),
                lambda: call(kw.rope_kv_write_plain, caches[1]),
                200, 20, _bound(nbytes + n * per_token, 0)))
            del copies
        del qkv, caches, args, got, want, planes
    record("rope_kv_write", errs, timed)  # decode T = 1, int8 first


def check_kernels(device, gen, cfg=None, S=1024, vision=None, lanes=32, lanes_seq=384,
                  page_size=256, paged_seq=512, paged_chunk=128):
    """Phase 2: each kernel against its plain version at the shapes the
    text, image, lanes and paged paths give it. Returns {kernel name:
    {"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
    "times"}}: the worst error over the shapes checked; "times" lists every
    timed shape with the same keys, and the others are its first entry (the
    decode shape for dense_int4 and moe_decode_int4, one 1000-position lane
    for decode_attention, S = 64 for flash_causal, the 32-lane int4 write
    and 32-lane attention for the int4 KV kernels, 32 lanes on int8 pages
    for paged_decode_attention, the image request's shape for the
    others)."""
    import torch
    import torch.nn.functional as F

    from aria_tpu_torch import TextConfig, VisionConfig
    from aria_tpu_torch.ops import decode_attention as da
    from aria_tpu_torch.ops import dense_int4 as di
    from aria_tpu_torch.ops import flash as fl
    from aria_tpu_torch.ops import kv_write as kw
    from aria_tpu_torch.ops import moe_decode_kernel as mk
    from aria_tpu_torch.ops import moe_prefill_kernel as mp
    from aria_tpu_torch.ops import paged_attention as pg
    from aria_tpu_torch.ops import vit_flash as vfl
    from aria_tpu_torch.ops import moe as tmoe
    from aria_tpu_torch.ops.quant import (dequantize_dense_int4, dequantize_w1_int4,
                                          dequantize_w2_int4, quantize_dense_int4,
                                          quantize_expert_int4)

    cfg = cfg or TextConfig()
    vision = vision or VisionConfig()
    D, H, Dh, I = cfg.hidden_size, cfg.num_heads, cfg.head_dim, cfg.moe_intermediate_size
    E = cfg.num_experts + cfg.num_shared_experts
    results = {}

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    def record(name, errs, timed):
        _record(results, name, errs, timed)

    # dense_int4: wqkv (F = 7680) and wo (F = 2560) at decode (T = 1), at
    # the 32-lane decode step (T = 32), at the 64- and 128-token prompt
    # buckets, at the image prompt's 512, at the 32-row grouped admission
    # of 64-token prompts (T = 2048) and at the paged prefill tick's 32
    # lanes x one 128-token chunk (T = 4096). No PyTorch call takes this
    # int4 layout: library none.
    #
    # On the same inputs at T = 1, 8 and 32, dense_int4_a8: the W4A8
    # projections of a decode step under DENSE_A8 (T = 8: the most rows of
    # its split form, x quantized in the kernel). Exact integer dots and
    # the plain version's f32 steps, each rounded once: bit-equal is the
    # claim, printed; the limit is f32 rounding.
    print("dense_int4, dense_int4_a8", flush=True)
    errs, timed, errs8, timed8 = [], [], [], []
    tick = lanes * paged_chunk
    for F_out in ((cfg.num_heads + 2 * cfg.num_kv_heads) * Dh, D):
        w = quantize_dense_int4(randn(2, D, F_out, scale=D**-0.5))
        for T in dict.fromkeys((1, 8, 32, 64, 128, 512, 2048, tick)):
            x = randn(T, D)
            got, ref = di.dense_int4(x, w, 1), di.dense_int4_plain(x, w, 1)
            errs.append(_compare(f"dense_int4 T={T} F={F_out}", got, ref, 1e-4,
                                 "both f32 sums of exact products; order differs"))
            read = _nbytes(x, w["q4t"][1], w["sg"][1]) + T * F_out * 4
            if T in (1, 32, 512, 2048, tick):
                iters = {1: 200, 32: 100}.get(T, max(5, 20480 // T))
                timed.append(_timed(f"T={T} F={F_out}", lambda: di.dense_int4(x, w, 1),
                                    lambda: di.dense_int4_plain(x, w, 1), iters, 5,
                                    _bound(read, 2 * T * D * F_out)))
                if T >= 512:  # what the unpacking costs: a yardstick, not the same function
                    wbf = dequantize_dense_int4({"q4t": w["q4t"][1], "sg": w["sg"][1]})
                    mm = _time_ms(lambda: torch.matmul(x, wbf), iters)[0]
                    print(f"  dense_int4 T={T} F={F_out}: {timed[-1]['k'][0]:.4f} ms against "
                          f"torch.matmul by the weight dequantized to bf16 {mm:.4f} ms",
                          flush=True)
                    del wbf
            if T in (1, 8, lanes):
                got, ref = di.dense_int4(x, w, 1, act_int8=True), di.dense_int4_a8_plain(x, w, 1)
                same = "bit-equal" if torch.equal(got, ref) else "NOT bit-equal"
                errs8.append(_compare(f"dense_int4_a8 T={T} F={F_out} ({same})", got, ref, 1e-6,
                                      "exact integer dots, then the same f32 steps"))
                timed8.append(_timed(f"T={T} F={F_out}",
                                     lambda: di.dense_int4(x, w, 1, act_int8=True),
                                     lambda: di.dense_int4_a8_plain(x, w, 1),
                                     200 if T == 1 else 100, 5,
                                     _bound(read, 2 * T * D * F_out, "int8")))
                if T != 8:  # dense_int4 is not timed at 8 rows
                    print(f"  dense_int4_a8 T={T} F={F_out}: {timed8[-1]['k'][0]:.4f} ms "
                          f"against dense_int4 (bf16 activations) {timed[-1]['k'][0]:.4f} ms",
                          flush=True)
    record("dense_int4", errs, timed)  # wqkv at T = 1 first
    record("dense_int4_a8", errs8, timed8)  # wqkv at T = 1 first
    del w

    # moe_decode_int4 (W4A8): 64 + 2 experts at full width, T = 1 (one
    # stream), 32 (the lanes), 64, 128, timed at 1, 32 and 128. Bound: the
    # used experts' bytes. Bit-equal to the plain version is the design's
    # claim: printed, with the count of elements that differ.
    print("moe_decode_int4", flush=True)
    L = 2
    w1 = {"q4": torch.empty((L, E, 2 * I, D // 2), dtype=torch.int8, device=device),
          "sg": torch.empty((L, E, 8, 2 * I), dtype=torch.bfloat16, device=device)}
    w2 = {"q4": torch.empty((L, E, I, D // 2), dtype=torch.int8, device=device),
          "s8": torch.empty((L, E, 8, D), dtype=torch.bfloat16, device=device)}
    for layer in range(L):
        for e0 in range(0, E, 11):
            n = min(11, E - e0)
            q1, q2 = quantize_expert_int4(randn(n, 2 * I, D, scale=D**-0.5),
                                          randn(n, I, D, scale=I**-0.5))
            for dst, src in ((w1, q1), (w2, q2)):
                for leaf in dst:
                    dst[leaf][layer, e0:e0 + n] = src[leaf]
    expert_bytes = _nbytes(w1["q4"][1, 0], w1["sg"][1, 0], w2["q4"][1, 0], w2["s8"][1, 0])
    # on the same inputs, moe_decode_int4_bf16, the bf16-activation form
    # (MOE_A8 off; the routed-pair kernel of csrc/moe_decode_bf16x.cu): the
    # A/B of the decode MoE, timed at 1, 32 and 128 too
    errs, timed, errs16, timed16 = [], [], [], []
    for T in (1, lanes, 64, 128):
        x = randn(T, D)
        logits = torch.randn((T, cfg.num_experts), generator=gen, device=device)
        top, idx = torch.topk(logits, cfg.moe_topk, dim=-1)
        shared = torch.arange(cfg.num_experts, E, device=device).expand(T, -1)
        indices = torch.cat([idx, shared], dim=1).to(torch.int32)
        weights = torch.cat([torch.softmax(top, -1), torch.ones_like(shared, dtype=top.dtype)], 1).to(x.dtype)
        args = (x, indices, weights, w1["q4"], w1["sg"], w2["q4"], w2["s8"], 1)
        got, ref = mk.moe_decode_int4(*args, act_int8=True), mk.moe_decode_int4_plain(*args)
        differ = int((got != ref).sum())
        same = "bit-equal" if differ == 0 else f"{differ} of {got.numel()} elements differ"
        errs.append(_compare(
            f"moe_decode_int4 T={T} ({same})", got, ref, 2e-2,
            "the same integers and f32 steps in the same order; expf's last ulp can flip "
            "one int8 step of h; bf16 output"))
        got, ref = mk.moe_decode_int4(*args), mk.moe_decode_int4_bf16_plain(*args)
        errs16.append(_compare(
            f"moe_decode_int4_bf16 T={T} ({_differ(got, ref)})", got, ref, 1e-2,
            "exact products, f32 sums in another order; h rounds to bf16 on both sides, so a "
            "sum at a rounding edge moves by one bf16 ulp; bf16 output"))
        if T in (1, lanes, 128):
            used = int(torch.unique(indices).numel())
            read = used * expert_bytes + _nbytes(x, indices, weights, got)
            ops = T * indices.shape[1] * 6 * I * D
            at = f"T={T} ({used} experts)"
            timed.append(_timed(at, lambda: mk.moe_decode_int4(*args, act_int8=True),
                                lambda: mk.moe_decode_int4_plain(*args), 100, 3,
                                _bound(read, ops, "int8")))
        if T in (1, lanes, 128):
            timed16.append(_timed(at, lambda: mk.moe_decode_int4(*args),
                                  lambda: mk.moe_decode_int4_bf16_plain(*args), 100, 3,
                                  _bound(read, ops)))
            print(f"  moe_decode_int4_bf16 {at}: {timed16[-1]['k'][0]:.4f} ms against the W4A8 "
                  f"moe_decode_int4 {timed[-1]['k'][0]:.4f} ms", flush=True)
    _decode_row_bits("moe_decode_int4_bf16", mk.moe_decode_int4_bf16,
                     (w1["q4"], w1["sg"], w2["q4"], w2["s8"], 1), randn, device, gen, cfg, E)
    record("moe_decode_int4", errs, timed)
    record("moe_decode_int4_bf16", errs16, timed16)

    # moe_prefill_int4 on the same stacks: top-6 + 2 shared at T = 512 (the
    # image prompt's bucket), 129, 2048 (32 rows of 64-token prompts) and
    # 4096 (the paged prefill tick); each tile computes its routed rows, and
    # its other rows must read exactly 0. The bound counts the routed rows
    # (T x 8), the padded tiles' bound is printed beside it, and so is a
    # yardstick: torch._grouped_mm over the same tiles with the used
    # experts' weights dequantized to bf16 (bf16 out, the two products
    # only: not a call of the same function).
    print("moe_prefill_int4", flush=True)
    errs, timed = [], []
    w1bf = dequantize_w1_int4({"q4": w1["q4"][1], "sg": w1["sg"][1]})  # [E, 2I, D]
    w2bf = dequantize_w2_int4({"q4": w2["q4"][1], "s8": w2["s8"][1]})  # [E, I, D]
    for T in dict.fromkeys((512, 129, lanes * 64, tick)):
        logits = torch.randn((T, cfg.num_experts), generator=gen, device=device)
        _, idx = torch.topk(logits, cfg.moe_topk, dim=-1)
        shared = torch.arange(cfg.num_experts, E, device=device).expand(T, -1)
        indices = torch.cat([idx, shared], dim=1).to(torch.int32)
        dest, tile_e, R, tile_rows = mp.segment_dispatch(indices, E)
        x_seg = torch.zeros((R, D), dtype=torch.bfloat16, device=device)
        x_seg[dest.long()] = randn(T, D).repeat_interleave(indices.shape[1], dim=0)
        args = (x_seg, tile_e, w1["q4"], w1["sg"], w2["q4"], w2["s8"], 1, tile_rows)
        tiles = int((tile_rows > 0).sum())
        used = tiles * mp.TM
        routed = (torch.arange(used, device=device) % mp.TM
                  < tile_rows[:tiles].repeat_interleave(mp.TM))
        got, ref = mp.moe_prefill_int4(*args), mp.moe_prefill_int4_plain(*args)
        errs.append(_compare(
            f"moe_prefill_int4 T={T} ({tiles} of {R // mp.TM} tiles used)",
            got[:used][routed], ref[:used][routed], 1e-2,
            "exact products, f32 sums in another order; h rounds to bf16 between the "
            "products on both sides, so a sum at a rounding edge moves by one bf16 ulp"))
        if (got[:used][~routed] != 0).any():
            raise AssertionError(f"moe_prefill_int4 T={T}: a row past its tile's count is not 0")
        if T != 129:
            n_exp = int(torch.unique(tile_e[:tiles]).numel())
            slots = T * indices.shape[1]
            bound = _bound(n_exp * expert_bytes + slots * D * (2 + 4), slots * 6 * I * D)
            padded = _bound(n_exp * expert_bytes + _nbytes(x_seg[:used], got[:used]),
                            used * 6 * I * D)
            timed.append(_timed(f"T={T} ({tiles} tiles)",
                                lambda: mp.moe_prefill_int4(*args),
                                lambda: mp.moe_prefill_int4_plain(*args),
                                max(5, 10240 // T), 3, bound))
            sizes = (torch.bincount(tile_e[:tiles], minlength=E) * mp.TM).to(torch.int32)
            ref1 = tmoe.gmm_plain(x_seg[:used], w1bf, sizes, True)
            hbf = (F.silu(ref1[:, :I]) * ref1[:, I:]).to(torch.bfloat16)
            ref2 = tmoe.gmm_plain(hbf, w2bf, sizes, False)
            lib1 = _grouped_mm(x_seg[:used], w1bf.transpose(1, 2), sizes, ref1)
            lib2 = _grouped_mm(hbf, w2bf, sizes, ref2)
            yard = ("not timed" if lib1 is None or lib2 is None else
                    f"{_time_ms(lib1, 10)[0] + _time_ms(lib2, 10)[0]:.4f} ms")
            print(f"  moe_prefill_int4 T={T}: {timed[-1]['k'][0]:.4f} ms; bound on the routed "
                  f"rows ({slots}) {bound[0]:.4f} ms ({bound[1]}), on the padded tiles ({used} "
                  f"rows) {padded[0]:.4f} ms ({padded[1]}); torch._grouped_mm over the same "
                  f"tiles, weights dequantized to bf16, bf16 out: {yard}", flush=True)
            del ref1, hbf, ref2
    del w1bf, w2bf
    _prefill_row_bits(mp, (w1["q4"], w1["sg"], w2["q4"], w2["s8"], 1), randn, device, gen, cfg,
                      E)
    record("moe_prefill_int4", errs, timed)
    del w1, w2
    check_fp_experts(device, gen, cfg, lanes, results, randn, record)
    check_expert_dequant(device, cfg, randn, record)

    # decode_attention over a 1024-position cache, int8 and bf16. The bf16
    # cache's library call is scaled_dot_product_attention with the length
    # mask; no PyTorch call takes the int8 cache with its scales.
    print("decode_attention", flush=True)
    L = 2
    kf, vf = randn(L, 1, H, S, Dh), randn(L, 1, H, S, Dh)
    ks = torch.clamp_min(kf.float().abs().amax(-1), 1e-6) / 127.0
    vs = torch.clamp_min(vf.float().abs().amax(-1), 1e-6) / 127.0
    kq = torch.round(kf.float() / ks[..., None]).to(torch.int8)
    vq = torch.round(vf.float() / vs[..., None]).to(torch.int8)
    q = randn(1, H, Dh)
    errs = []
    for n in (S - 24, 1, S // 3):
        lengths = torch.full((1,), n, dtype=torch.int32, device=device)
        for label, args in (("int8", (q, kq, vq, 1, lengths, ks, vs)),
                            ("bf16", (q, kf, vf, 1, lengths))):
            got, ref = da.decode_attention(*args), da.decode_attention_plain(*args)
            errs.append(_compare(f"decode_attention {label} len={n}", got, ref, 1e-2,
                                 "bf16 output; the plain version rounds p*v_scale to bf16"))
    n = S - 24
    lengths = torch.full((1,), n, dtype=torch.int32, device=device)
    a8, a16 = (q, kq, vq, 1, lengths, ks, vs), (q, kf, vf, 1, lengths)
    mask = (torch.arange(S, device=device) < n)[None, None, None, :]
    timed = [
        _timed(f"int8 len={n}", lambda: da.decode_attention(*a8),
               lambda: da.decode_attention_plain(*a8), 200, 20,
               _bound(2 * n * H * Dh + 2 * n * H * 4 + 2 * _nbytes(q), 4 * n * H * Dh)),
        _timed(f"bf16 len={n}", lambda: da.decode_attention(*a16),
               lambda: da.decode_attention_plain(*a16), 200, 20,
               _bound(2 * n * H * Dh * 2 + 2 * _nbytes(q), 4 * n * H * Dh),
               lambda: F.scaled_dot_product_attention(q[:, :, None], kf[1], vf[1],
                                                      attn_mask=mask)),
    ]
    record("decode_attention", errs, timed)
    del kf, vf, kq, vq

    # the packed-int4 cache: 32 lanes with lengths spread over 48-320 of
    # 384 positions (the lanes path), and one lane over 1000 of 1024. No
    # PyTorch call takes the packed cache: library none.
    print("decode_attention_int4", flush=True)
    errs, timed = [], []
    for B, S4, lens in ((lanes, lanes_seq, None), (1, S, [S - 24])):
        kp = torch.randint(-128, 128, (L, B, H // 2, S4, Dh), generator=gen, device=device,
                           dtype=torch.int8)
        vp = torch.randint(-128, 128, (L, B, H // 2, S4, Dh), generator=gen, device=device,
                           dtype=torch.int8)
        ks4, vs4 = ((torch.rand((L, B, H, S4), generator=gen, device=device) * 0.3 + 0.02)
                    .to(torch.bfloat16) for _ in range(2))
        if lens is None:
            lens = torch.linspace(48, min(320, S4), B).round().int().tolist()
        lengths = torch.tensor(lens, dtype=torch.int32, device=device)
        q = randn(B, H, Dh)
        args = (q, kp, vp, 1, lengths, ks4, vs4)
        got, ref = da.decode_attention_int4(*args), da.decode_attention_plain(*args)
        errs.append(_compare(
            f"decode_attention_int4 B={B} len={min(lens)}..{max(lens)} of {S4}", got, ref, 1e-2,
            "bf16 output; p*v_scale rounds to bf16 after the kernel's online rescaling and "
            "after the plain version's one-pass softmax"))
        n_tot = sum(lens)
        bound = _bound(n_tot * (H // 2 * Dh * 2 + H * 2 * 2) + 2 * _nbytes(q), 4 * n_tot * H * Dh)
        timed.append(_timed(f"B={B} len={min(lens)}..{max(lens)} of {S4}",
                            lambda: da.decode_attention_int4(*args),
                            lambda: da.decode_attention_plain(*args), 200, 10, bound))
    record("decode_attention_int4", errs, timed)
    del kp, vp
    check_decode_stats(device, gen, cfg, randn, record, lanes)

    # paged_decode_attention at the paged path's shapes: 32 lanes on page
    # tables shuffled over the engine's default pool (1 + 2 pages per
    # lane), lengths 48-511 of 512, then 4 lanes at 400-511 (where the split
    # over positions matters most), int8 pages with f32 scales and bf16
    # pages, at the split the wrapper's plan picks (printed). A lane's bits
    # must not depend on the other lanes: lane 0 again with the others'
    # lengths and tables changed, the claim printed. No PyTorch call reads
    # through a page table: library none.
    print("paged_decode_attention", flush=True)
    errs, timed = [], []
    maxp = -(-paged_seq // page_size)
    sms = torch.cuda.get_device_properties(device).multi_processor_count \
        if device.type == "cuda" else 132
    for n_lanes, lo in ((lanes, 48), (min(4, lanes), 400 * paged_seq // 512)):
        NP = 1 + n_lanes * (maxp // 2 + 1)
        shape = (L, NP, H, page_size, Dh)
        table = (torch.randperm(NP - 1, generator=gen, device=device)[:n_lanes * maxp] + 1)
        table = table.reshape(n_lanes, maxp).to(torch.int32)
        lens = torch.linspace(lo, paged_seq - 1, n_lanes).round().int().tolist()
        lengths = torch.tensor(lens, dtype=torch.int32, device=device)
        q = randn(n_lanes, H, Dh)
        P = pg.paged_split_count(n_lanes, H, maxp, page_size, sms)
        other_table = table.roll(1, dims=0).contiguous()
        other_lengths = torch.tensor([lens[0]] + [paged_seq - 1 - v for v in lens[1:]],
                                     dtype=torch.int32, device=device)
        other_table[0] = table[0]
        for label in ("int8", "bf16"):
            if label == "int8":
                pages = [torch.randint(-128, 128, shape, generator=gen, device=device,
                                       dtype=torch.int8) for _ in range(2)]
                pages += [torch.rand(shape[:-1], generator=gen, device=device) * 0.02 + 0.005
                          for _ in range(2)]
                per_pos = 2 * Dh + 8  # k and v bytes and two f32 scales per head
            else:
                pages = [randn(*shape) for _ in range(2)]
                per_pos = 4 * Dh
            cache = pg.PagedKVCache(*pages)
            args = (q, cache, 1, table, lengths)
            got, ref = pg.paged_decode_attention(*args), pg.paged_decode_attention_plain(*args)
            alone = torch.equal(pg.paged_decode_attention(q, cache, 1, other_table,
                                                          other_lengths)[0], got[0])
            errs.append(_compare(
                f"paged_decode_attention {label} B={n_lanes} len={min(lens)}..{max(lens)} of "
                f"{maxp * page_size}, P={P} (lane 0's bits with the other lanes changed: "
                f"{'the same' if alone else 'DIFFER'})", got, ref, 1e-2,
                "bf16 output; p (times v_scale) rounds to bf16 after the kernel's online "
                "rescaling and after the plain version's one-pass softmax"))
            if not alone:
                raise AssertionError("paged_decode_attention: lane 0's bits moved with the "
                                     "other lanes")
            bound = _bound(sum(lens) * H * per_pos + _nbytes(table, lengths) + 2 * _nbytes(q),
                           4 * sum(lens) * H * Dh)
            timed.append(_timed(f"{label}, {n_lanes} lanes, len {min(lens)}..{max(lens)}, P={P}",
                                lambda: pg.paged_decode_attention(*args),
                                lambda: pg.paged_decode_attention_plain(*args), 200, 10, bound))
            del cache, args, pages
    record("paged_decode_attention", errs, timed)  # int8 at 32 lanes first

    # kv_cache_write at the lanes shapes: 32 lanes into [28, 32, H, 384,
    # 128], bf16, int8 with f32 scales, packed int4 (H/2 byte planes) with
    # bf16 scales. A byte copy: exact. The library call is the indexed
    # assignment of the same rows (index_put_, one per tensor).
    print("kv_cache_write", flush=True)
    errs, timed = [], []
    rows = torch.arange(lanes, dtype=torch.int32, device=device)
    slots = torch.randint(0, min(320, lanes_seq), (lanes,), generator=gen, device=device,
                          dtype=torch.int32)
    r, s = rows.long(), slots.long()
    for label in ("int4", "int8", "bf16"):
        Hc = H // 2 if label == "int4" else H
        shape = (cfg.num_layers, lanes, Hc, lanes_seq, Dh)
        if label == "bf16":
            k, v, kn, vn = (randn(*sh) for sh in (shape, shape, (lanes, Hc, Dh), (lanes, Hc, Dh)))
            sc = ()
        else:
            k, v, kn, vn = (torch.randint(-128, 128, sh, generator=gen, device=device,
                                          dtype=torch.int8)
                            for sh in (shape, shape, (lanes, Hc, Dh), (lanes, Hc, Dh)))
            sdt = torch.float32 if label == "int8" else torch.bfloat16
            sc = tuple(torch.rand(sh, generator=gen, device=device).to(sdt)
                       for sh in ((cfg.num_layers, lanes, H, lanes_seq),) * 2 + ((lanes, H),) * 2)
        ref = [t.clone() for t in (k, v) + sc[:2]]
        kw.kv_cache_write_plain(ref[0], ref[1], 1, rows, slots, kn, vn, *ref[2:], *sc[2:])
        kw.kv_cache_write(k, v, 1, rows, slots, kn, vn, *sc)
        if not all(torch.equal(got, want) for got, want in zip((k, v) + sc[:2], ref)):
            raise AssertionError(f"kv_cache_write {label}: differs from the plain version")
        print(f"  kv_cache_write {label}: equal to the plain version (a byte copy: exact)",
              flush=True)
        errs.append(0.0)
        del ref

        def library(k=k, v=v, kn=kn, vn=vn, sc=sc):
            k[1][r, :, s] = kn
            v[1][r, :, s] = vn
            if sc:
                sc[0][1][r, :, s] = sc[2]
                sc[1][1][r, :, s] = sc[3]

        args = (k, v, 1, rows, slots, kn, vn, *sc)
        timed.append(_timed(f"{label}, {lanes} lanes", lambda: kw.kv_cache_write(*args),
                            lambda: kw.kv_cache_write_plain(*args), 200, 50,
                            _bound(2 * _nbytes(kn, vn, *sc[2:]) + _nbytes(rows, slots), 0),
                            library))
        del k, v, args
    # the paged decode step's write: int8 pages of the default pool [28,
    # NP, H, 256, 128] with f32 scales, rows = shuffled page ids; idle
    # lanes all write page 0, slot 0 with differing data (the null page,
    # never read, so left out of the comparison), and a lane past its
    # table has page -1 and writes nothing. Bound and library: the lanes
    # that write.
    NP = 1 + lanes * (-(-paged_seq // page_size) // 2 + 1)
    shape = (cfg.num_layers, NP, H, page_size, Dh)
    n_idle, n_past = max(1, lanes // 8), max(1, lanes // 16)
    rows = (torch.randperm(NP - 1, generator=gen, device=device)[:lanes] + 1).to(torch.int32)
    rows[lanes - n_idle - n_past:lanes - n_past] = 0
    rows[lanes - n_past:] = -1
    slots = torch.randint(0, page_size, (lanes,), generator=gen, device=device,
                          dtype=torch.int32)
    slots = torch.where(rows == 0, torch.zeros_like(slots), slots)
    k, v = (torch.randint(-128, 128, shape, generator=gen, device=device, dtype=torch.int8)
            for _ in range(2))
    kn, vn = (torch.randint(-128, 128, (lanes, H, Dh), generator=gen, device=device,
                            dtype=torch.int8) for _ in range(2))
    sc = tuple(torch.rand(sh, generator=gen, device=device)
               for sh in (shape[:-1],) * 2 + ((lanes, H),) * 2)
    ref = [t.clone() for t in (k, v) + sc[:2]]
    kw.kv_cache_write_plain(ref[0], ref[1], 1, rows, slots, kn, vn, *ref[2:], *sc[2:])
    kw.kv_cache_write(k, v, 1, rows, slots, kn, vn, *sc)
    if not all(torch.equal(got[:, 1:], want[:, 1:]) for got, want in zip((k, v) + sc[:2], ref)):
        raise AssertionError("kv_cache_write on pages: differs from the plain version")
    print(f"  kv_cache_write int8 pages, {lanes} lanes ({n_idle} idle on page 0, {n_past} past "
          "the table): equal to the plain version outside the null page (a byte copy: exact)",
          flush=True)
    errs.append(0.0)
    del ref
    keep = rows >= 0
    r, s = rows[keep].long(), slots[keep].long()
    kept = (kn[keep], vn[keep], sc[2][keep], sc[3][keep])

    def library():
        k[1][r, :, s], v[1][r, :, s] = kept[0], kept[1]
        sc[0][1][r, :, s], sc[1][1][r, :, s] = kept[2], kept[3]

    args = (k, v, 1, rows, slots, kn, vn, *sc)
    timed.append(_timed(f"int8 pages [{', '.join(map(str, shape))}], {lanes} lanes",
                        lambda: kw.kv_cache_write(*args), lambda: kw.kv_cache_write_plain(*args),
                        200, 50, _bound(2 * _nbytes(*kept) + _nbytes(rows, slots), 0), library))
    del k, v, args, sc
    record("kv_cache_write", errs, timed)  # int4 first
    _check_rope_kv_write(device, gen, cfg, record, lanes, lanes_seq, page_size, paged_seq)

    # flash_causal at the 64-, 128- and 512-token prompt buckets, at a
    # ragged S below each of the short and the long ones, and at the
    # grouped admission's 32 rows of 64. The library call is
    # scaled_dot_product_attention(is_causal=True) on the [B, H, S, D] views.
    print("flash_causal", flush=True)
    errs, timed = [], []
    for B, S in ((1, 64), (1, 128), (1, 37), (1, 512), (1, 509), (lanes, 64)):
        qkv = [randn(B, S, H, Dh) for _ in range(3)]
        got, ref = fl.flash_causal(*qkv), fl.flash_causal_plain(*qkv)
        errs.append(_compare(f"flash_causal B={B} S={S}", got, ref, 1e-2,
                             "bf16 output; both round p to bf16 before p.v, the plain "
                             "version after normalising it"))
        if S in (64, 512):
            bound = _bound(4 * _nbytes(qkv[0]), B * H * 4 * Dh * S * (S + 1) / 2)
            timed.append(_timed(f"B={B} S={S}", lambda: fl.flash_causal(*qkv),
                                lambda: fl.flash_causal_plain(*qkv), 200 if S == 64 else 50, 20,
                                bound, lambda: F.scaled_dot_product_attention(
                                    *(t.transpose(1, 2) for t in qkv), is_causal=True)))
    record("flash_causal", errs, timed)  # B = 1, S = 64 first
    del qkv

    # vit_flash over the 4,900 patches of a 980px crop, 16 heads of 72:
    # every key valid, a prefix of half, and a 980 x 630 crop (70 x 45 of the
    # 70 x 70 patches valid, 3,150, interleaved with padding inside every
    # 128-key tile), compared on the valid rows, and a second call's bits;
    # the limit must see the last partial key tile (36 keys) left out.
    # Library: sdpa with the key mask on the [B, H, S, D] views.
    print("vit_flash", flush=True)
    P, VH, VD = vision.patches_per_side**2, vision.num_heads, vision.head_dim
    side = vision.patches_per_side
    ragged = torch.zeros((side, side), dtype=torch.bool, device=device)
    ragged[:, :side * 630 // 980] = True
    prefix = torch.zeros((1, P), dtype=torch.bool, device=device)
    prefix[0, :P // 2] = True
    masks = (("all valid", torch.ones((1, P), dtype=torch.bool, device=device), True),
             (f"{P // 2} valid (prefix)", prefix, False),
             (f"{int(ragged.sum())} valid", ragged.reshape(1, P), True))  # label, mask, timed
    errs, timed = [], []
    qkv = [randn(1, P, VH, VD) for _ in range(3)]
    for label, valid, time_it in masks:
        got, ref = vfl.vit_flash(*qkv, valid), vfl.vit_flash_plain(*qkv, valid)
        rows = valid[0]
        errs.append(_compare(
            f"vit_flash S={P} {label}", got[:, rows], ref[:, rows], 1e-2,
            "valid rows; bf16 output, p rounds to bf16 for p.v unnormalised in the "
            "kernel and normalised in the plain version"))
        if not torch.equal(vfl.vit_flash(*qkv, valid), got):
            raise AssertionError(f"vit_flash {label}: a second call gives other bits")
        if label == "all valid":  # what the limit must catch: the last 36-key tile left out
            cut = valid.clone()
            cut[0, P - 36:] = False
            moved = (vfl.vit_flash_plain(*qkv, cut).float() - ref.float()).abs().max().item()
            limit = 1e-2 * max(1.0, ref.float().abs().max().item())
            print(f"  vit_flash S={P}: the plain version without the last 36 keys moves an output "
                  f"by {moved:.3e} (limit {limit:.3e}); a second call gives the same bits",
                  flush=True)
            if not moved > limit:
                raise AssertionError("vit_flash's limit does not see a dropped key tile")
        if time_it:
            timed.append(_timed(
                f"S={P} {label}", lambda: vfl.vit_flash(*qkv, valid),
                lambda: vfl.vit_flash_plain(*qkv, valid), 20, 3,
                _bound(4 * _nbytes(qkv[0]) + _nbytes(valid), 4 * VD * VH * P * P),
                lambda: F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in qkv),
                                                       attn_mask=valid[:, None, None, :])))
        del got, ref
    record("vit_flash", errs, timed)  # all valid first

    # flash_segment, the ViT's attention with VIT_FLASH off, on the same
    # q, k, v: every patch valid, and the 980 x 630 crop, compared on the
    # valid rows to an absolute limit (the outputs are ~0.024 in rms, so a
    # limit relative to 1 would pass a dropped key tile), and a second
    # call's bits. Library: sdpa with the boolean segment mask on the
    # [B, H, S, D] views.
    print("flash_segment", flush=True)
    errs, timed = [], []
    for label, valid in (("all valid", torch.ones((1, P), dtype=torch.bool, device=device)),
                         (f"{int(ragged.sum())} valid", ragged.reshape(1, P))):
        got, ref = fl.flash_sdpa(*qkv, q_valid=valid, kv_valid=valid), fl.flash_sdpa_plain(
            *qkv, valid, valid)
        rows = valid[0]
        errs.append(_compare(
            f"flash_segment S={P} {label}", got[:, rows], ref[:, rows], FLASH_SEG_ATOL,
            "valid rows, absolute; bf16 output, p rounds to bf16 for p.v against the running "
            "max in the kernel and the row max in the plain version", absolute=True))
        if not torch.equal(fl.flash_sdpa(*qkv, q_valid=valid, kv_valid=valid), got):
            raise AssertionError(f"flash_segment {label}: a second call gives other bits")
        if label == "all valid":  # what the limit must catch: the last 36-key tile left out
            moved = (fl.flash_sdpa_plain(*(t[:, :P - 36] if i else t for i, t in enumerate(qkv)))
                     .float() - ref.float()).abs().max().item()
            print(f"  flash_segment S={P}: the plain version without the last 36 keys moves an "
                  f"output by {moved:.3e} (limit {FLASH_SEG_ATOL:.0e})", flush=True)
            if not moved > FLASH_SEG_ATOL:
                raise AssertionError("flash_segment's limit does not see a dropped key tile")
        seg = valid[:, None, :, None] == valid[:, None, None, :]
        timed.append(_timed(
            f"S={P} {label}", lambda: fl.flash_sdpa(*qkv, q_valid=valid, kv_valid=valid),
            lambda: fl.flash_sdpa_plain(*qkv, valid, valid), 20, 3,
            _bound(4 * _nbytes(qkv[0]) + 2 * _nbytes(valid), 4 * VD * VH * P * P),
            lambda: F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in qkv),
                                                   attn_mask=seg)))
        del got, ref, seg
    record("flash_segment", errs, timed)  # all valid first
    del qkv
    check_long_context(device, cfg, randn, results)
    return results


def _ragged_sizes(gen, M: int, E: int, empty=(0, 7, 40, 41)):
    """E group sizes summing to M, random, with the groups in ``empty``
    left without rows (int32 on the generator's device)."""
    import torch

    w = torch.rand(E, generator=gen, device=gen.device)
    w[[e for e in empty if e < E - 1]] = 0
    sizes = torch.floor(w / w.sum() * M).to(torch.int32)
    sizes[E - 1] += M - int(sizes.sum())
    return sizes


def _grouped_mm(lhs, rhs_kn, sizes, ref, out_dtype=None):
    """torch._grouped_mm on the same rows and groups (rhs as [E, K, N]),
    output in ``out_dtype`` (None: the operands' bf16), the library
    yardstick of gmm, or None where the card's torch has no such call or it
    does not take these operands."""
    import torch

    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        print("  library: torch._grouped_mm is missing", flush=True)
        return None
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    kw = {} if out_dtype is None else {"out_dtype": out_dtype}
    try:
        out = fn(lhs, rhs_kn, offs=offs, **kw)
    except (RuntimeError, TypeError, ValueError) as exc:
        args = "".join(f"{k}={v}" for k, v in kw.items())
        print(f"  library: torch._grouped_mm({args}) refuses these operands ({exc})", flush=True)
        return None
    if _rel_err(out.float(), ref) > 1e-2:
        print("  library: torch._grouped_mm gives another result; not timed", flush=True)
        return None
    return lambda: fn(lhs, rhs_kn, offs=offs, **kw)


def _gmm_library(lhs, rhs_kn, sizes, ref, at: str):
    """gmm's yardstick: torch._grouped_mm with an f32 output, as gmm gives,
    where the card's torch takes it, else with its bf16 output; the
    bf16-output call's device ms is printed beside."""
    import torch

    bf16 = _grouped_mm(lhs, rhs_kn, sizes, ref)
    f32 = _grouped_mm(lhs, rhs_kn, sizes, ref, torch.float32)
    if bf16 is not None:
        print(f"  gmm {at}: torch._grouped_mm with bf16 out {_time_ms(bf16, 5)[0]:.4f} ms; the "
              f"library time below has {'f32' if f32 else 'bf16'} out", flush=True)
    return f32 or bf16


def _prefill_row_bits(mp, experts, randn, device, gen, cfg, E):
    """moe_prefill_int4 gives a row the same bits whatever the rows beside
    it: alone in its expert's tile, among 40 or 128, at another place in
    the tile, and token 0's slots in a 129- and a 512-token prompt."""
    import torch

    row = randn(1, cfg.hidden_size)
    tile_e = torch.tensor([5], dtype=torch.int32, device=device)
    seen = []
    for n, at in ((1, 0), (40, 17), (128, 100)):
        x_seg = torch.zeros((mp.TM, cfg.hidden_size), dtype=torch.bfloat16, device=device)
        x_seg[:n] = randn(n, cfg.hidden_size)
        x_seg[at] = row[0]
        rows = torch.tensor([n], dtype=torch.int32, device=device)
        seen.append(mp.moe_prefill_int4(x_seg, tile_e, *experts, rows)[at])
    if not all(torch.equal(s, seen[0]) for s in seen[1:]):
        raise AssertionError("moe_prefill_int4: a row gets other bits among 1, 40, 128 rows")
    slots = []
    for T in (129, 512):
        logits = torch.randn((T, cfg.num_experts), generator=gen, device=device)
        top = torch.topk(logits, cfg.moe_topk, dim=-1).indices
        top[0] = torch.arange(cfg.moe_topk, device=device)
        shared = torch.arange(cfg.num_experts, E, device=device).expand(T, -1)
        indices = torch.cat([top, shared], dim=1).to(torch.int32)
        x = randn(T, cfg.hidden_size)
        x[0] = row[0]
        dest, tile_e, R, tile_rows = mp.segment_dispatch(indices, E)
        x_seg = torch.zeros((R, cfg.hidden_size), dtype=torch.bfloat16, device=device)
        x_seg[dest.long()] = x.repeat_interleave(indices.shape[1], dim=0)
        out = mp.moe_prefill_int4(x_seg, tile_e, *experts, tile_rows)
        slots.append(out[dest[:indices.shape[1]].long()])
    if not torch.equal(slots[0], slots[1]):
        raise AssertionError("moe_prefill_int4: token 0 gets other bits at T = 129 and 512")
    print("  moe_prefill_int4 rows: equal bits alone in its tile, among 40 and 128 rows (at "
          "rows 0, 17, 100), and token 0's 8 slots at T = 129 and 512", flush=True)


def _differ(got, ref) -> str:
    """How many elements of a kernel's output differ from its plain
    version's, for a check's label."""
    n = int((got != ref).sum())
    return "bit-equal" if n == 0 else f"{n} of {got.numel()} elements differ"


def _decode_row_bits(name, wrapper, stacks, randn, device, gen, cfg, E):
    """A routed decode MoE kernel gives a token the same bits whatever the
    tokens beside it: alone (its slots in ascending expert order, the order
    the combine takes above one row), and as the first and the last of 32
    and of 128 rows under random top-k routing."""
    import torch

    D, k = cfg.hidden_size, cfg.moe_topk
    row = randn(1, D)
    top = torch.randperm(cfg.num_experts, generator=gen, device=device)[:k].sort().values
    shared = torch.arange(cfg.num_experts, E, device=device)
    rind = torch.cat([top, shared])[None].to(torch.int32)
    rw = torch.cat([torch.softmax(torch.randn(k, generator=gen, device=device), -1),
                    torch.ones(E - cfg.num_experts, device=device)])[None].to(torch.bfloat16)
    ref = wrapper(row, rind, rw, *stacks)[0]
    for T in (32, 128):
        x = randn(T, D)
        logits = torch.randn((T, cfg.num_experts), generator=gen, device=device)
        top, idx = torch.topk(logits, k, dim=-1)
        ind = torch.cat([idx, shared.expand(T, -1)], 1).to(torch.int32)
        wts = torch.cat([torch.softmax(top, -1), torch.ones((T, E - cfg.num_experts),
                                                            device=device)], 1).to(torch.bfloat16)
        for at in (0, T - 1):
            x[at], ind[at], wts[at] = row[0], rind[0], rw[0]
            if not torch.equal(wrapper(x, ind, wts, *stacks)[at], ref):
                raise AssertionError(f"{name}: a token gets other bits at row {at} of {T}")
    print(f"  {name} rows: a token's bits equal alone, and as the first and the last of 32 "
          "and of 128 rows", flush=True)


def check_fp_experts(device, gen, cfg, lanes, results, randn, record, L=2):
    """Phase 2, the bf16 and int8 forms' expert kernels at full width on
    ``L`` layers of 64 + 2 experts (a whole 28-layer bf16 stack is 47 GB):
    ``moe_decode`` and ``moe_decode_quant`` under top-6 + 2 shared random
    routing at T = 1 (one stream), the lanes' T, 64 and 128 (timed at 1 and
    the lanes' T, ``moe_decode_quant`` at 128 too), the count of elements
    that differ from the plain version printed, and ``moe_decode_quant``'s
    row bits at every row count (``_decode_row_bits``); ``gmm`` in both
    layouts at the image prefill's 512 x 8 rows and the lanes admission's
    2048 x 8, four groups empty and tiles straddling the others, and row
    0's bits alone in a 128-row call against among 4096 rows."""
    import torch

    from aria_tpu_torch.ops import moe as tmoe
    from aria_tpu_torch.ops import moe_decode_kernel as mk
    from aria_tpu_torch.ops.quant import quantize_weight, with_s8

    D, I = cfg.hidden_size, cfg.moe_intermediate_size
    E = cfg.num_experts + cfg.num_shared_experts
    w1 = torch.empty((L, E, 2 * I, D), dtype=torch.bfloat16, device=device)
    w2 = torch.empty((L, E, I, D), dtype=torch.bfloat16, device=device)
    for layer in range(L):
        for e0 in range(0, E, 11):
            w1[layer, e0:e0 + 11] = randn(min(11, E - e0), 2 * I, D, scale=D**-0.5)
            w2[layer, e0:e0 + 11] = randn(min(11, E - e0), I, D, scale=I**-0.5)
    q1 = [with_s8(quantize_weight(w1[layer], input_axis=-1)) for layer in range(L)]
    q2 = [with_s8(quantize_weight(w2[layer], input_axis=-2)) for layer in range(L)]
    q1, q2 = ({k: torch.stack([p[k] for p in q]) for k in q[0]} for q in (q1, q2))
    per_expert = {"moe_decode": _nbytes(w1[1, 0], w2[1, 0]),
                  "moe_decode_quant": _nbytes(q1["q"][1, 0], q1["s"][1, 0], q2["q"][1, 0],
                                              q2["s"][1, 0])}
    print("moe_decode, moe_decode_quant", flush=True)
    errs = {name: [] for name in per_expert}
    timed = {name: [] for name in per_expert}
    for T in dict.fromkeys((1, lanes, 64, 128)):
        x = randn(T, D)
        logits = torch.randn((T, cfg.num_experts), generator=gen, device=device)
        top, idx = torch.topk(logits, cfg.moe_topk, dim=-1)
        shared = torch.arange(cfg.num_experts, E, device=device).expand(T, -1)
        indices = torch.cat([idx, shared], dim=1).to(torch.int32)
        weights = torch.cat([torch.softmax(top, -1), torch.ones_like(shared, dtype=top.dtype)],
                            1).to(x.dtype)
        used = int(torch.unique(indices).numel())
        for name, args, plain_args in (
                ("moe_decode", (x, indices, weights, w1, w2, 1),
                 (x, indices, weights, w1, w2, 1)),
                ("moe_decode_quant", (x, indices, weights, q1["q"], q1["s8"], q2["q"], q2["s8"], 1),
                 (x, indices, weights, q1["q"], q2["q"], 1, q1["s8"], q2["s8"]))):
            kernel = getattr(mk, name)
            got, ref = kernel(*args), mk.moe_decode_plain(*plain_args)
            errs[name].append(_compare(
                f"{name} T={T} ({used} experts; {_differ(got, ref)})", got, ref, 1e-2,
                "exact products, f32 sums in another order; h and the output round to bf16 on "
                "both sides, so a sum at a rounding edge of h moves by one bf16 ulp"))
            if T in (1, lanes) or (T == 128 and name == "moe_decode_quant"):
                bound = _bound(used * per_expert[name] + _nbytes(x, indices, weights, got),
                               T * indices.shape[1] * 6 * I * D)
                timed[name].append(_timed(
                    f"T={T} ({used} experts)", lambda k=kernel, a=args: k(*a),
                    lambda a=plain_args: mk.moe_decode_plain(*a), 100, 3, bound))
    _decode_row_bits("moe_decode_quant", mk.moe_decode_quant,
                     (q1["q"], q1["s8"], q2["q"], q2["s8"], 1), randn, device, gen, cfg, E)
    for name in per_expert:
        record(name, errs[name], timed[name])  # T = 1 first
    del q1, q2

    print("gmm", flush=True)
    errs, timed = [], []
    for M in (512 * 8, lanes * 64 * 8):
        sizes = _ragged_sizes(gen, M, E)
        used = int((sizes > 0).sum())
        for label, rhs, trans in (("w1 [E, 2I, D]", w1[1], True), ("w2 [E, I, D]", w2[1], False)):
            K, N = (D, 2 * I) if trans else (I, D)
            lhs = randn(M, K)
            got, ref = tmoe.gmm(lhs, rhs, sizes, trans), tmoe.gmm_plain(lhs, rhs, sizes, trans)
            errs.append(_compare(f"gmm {label} M={M} ({used} of {E} groups)", got, ref, 1e-4,
                                 "exact bf16 products, f32 sums in another order"))
            bound = _bound(_nbytes(lhs, sizes) + used * N * K * 2 + M * N * 4, 2 * M * N * K)
            library = _gmm_library(lhs, rhs.transpose(1, 2) if trans else rhs, sizes, ref,
                                   f"{label} M={M}")
            timed.append(_timed(f"{label} M={M}", lambda a=(lhs, rhs, sizes, trans): tmoe.gmm(*a),
                                lambda a=(lhs, rhs, sizes, trans): tmoe.gmm_plain(*a),
                                max(5, 81920 // M), 3, bound, library))
    # row 0 alone in a 128-row call against among 4096 rows in 62 groups;
    # then a row of expert 1 at offset 77 of its group's first tile among
    # 4096 rows, and at offset 30 in a 256-row call
    sizes = _ragged_sizes(gen, 4096, E)
    first = int(torch.nonzero(sizes)[0])
    alone = torch.zeros(E, dtype=torch.int32, device=device)
    alone[first] = 128
    lhs = randn(4096, D)
    many, one = tmoe.gmm(lhs, w1[1], sizes, True), tmoe.gmm(lhs[:128].contiguous(), w1[1], alone,
                                                            True)
    if not torch.equal(many[0], one[0]):
        raise AssertionError("gmm: row 0 gets other bits at 4096 rows than at 128")
    sizes_a = torch.cat([torch.tensor([50, 300], dtype=torch.int32, device=device),
                         _ragged_sizes(gen, 4096 - 350, E - 2)])
    sizes_b = torch.zeros(E, dtype=torch.int32, device=device)
    sizes_b[:2] = torch.tensor([10, 246], dtype=torch.int32, device=device)
    lhs_b = randn(256, D)
    lhs_b[40] = lhs[127]
    many, few = tmoe.gmm(lhs, w1[1], sizes_a, True), tmoe.gmm(lhs_b, w1[1], sizes_b, True)
    if not torch.equal(many[127], few[40]):
        raise AssertionError("gmm: a row gets other bits at offset 77 of its tile than at 30")
    print("  gmm rows: equal bits alone in a 128-row call and among 4096 rows, and mid-tile at "
          "offsets 77 and 30", flush=True)
    record("gmm", errs, timed)  # w1 at M = 4096 first
    del w1, w2


def check_expert_dequant(device, cfg, randn, record):
    """Phase 2, ``expert_block_dequant`` at the adapters path's shapes: the
    second block of 11 experts of a full-width layer (the blocked
    expert-LoRA path's block at 64 + 2 experts), int4 w1 [11, 3328, 2560]
    and w2 [11, 1664, 2560], bf16 and f32 out, and the same blocks of the
    int8 form; bit-equal to the plain version (the slice, then the
    dequantize). Bound: the block's packed bytes and scales read once and
    its float weights written once (of the int4 scales, the ng rows of sg
    and row 0 of s8 that the function reads). No PyTorch call unpacks this
    int4 layout: library none."""
    import torch

    from aria_tpu_torch.ops import expert_dequant as ed
    from aria_tpu_torch.models.moe_lm import lora_block_size
    from aria_tpu_torch.ops.quant import (
        int4_group_count,
        quantize_expert_int4,
        quantize_weight,
        with_s8,
    )

    D, I = cfg.hidden_size, cfg.moe_intermediate_size
    eb = lora_block_size(cfg.num_experts + cfg.num_shared_experts)
    ng = int4_group_count(D)
    print(f"expert_block_dequant (blocks of {eb})", flush=True)
    w1, w2 = randn(2 * eb, 2 * I, D, scale=D**-0.5), randn(2 * eb, I, D, scale=I**-0.5)
    forms = {"int4": quantize_expert_int4(w1, w2),
             "int8": (with_s8(quantize_weight(w1, input_axis=-1)),
                      with_s8(quantize_weight(w2, input_axis=-2)))}
    del w1, w2
    errs, timed = [], []
    for form, pair in forms.items():
        for kind, w in zip(("w1", "w2"), pair):
            blk = {k: v[eb:2 * eb] for k, v in w.items()}
            # what the function reads: the rows of sg [E, 8, 2I] and s8 [E, 8, D]
            # past ng and 0 are padding
            read = (_nbytes(blk["q4"], blk["sg"][:, :ng] if kind == "w1" else blk["s8"][:, :1])
                    if form == "int4" else _nbytes(blk["q"], blk["s"]))
            for dtype in (torch.bfloat16, torch.float32):
                args = (w, kind, eb, eb, dtype)
                got, ref = ed.expert_block_dequant(*args), ed.expert_block_dequant_plain(*args)
                label = f"{form} {kind} [{eb}, {got.shape[1]}, {D}] {str(dtype)[6:]}"
                errs.append(_compare(f"expert_block_dequant {label}", got, ref, 0.0,
                                     "bit-equal: one rounding of an exact product"))
                timed.append(_timed(label, lambda a=args: ed.expert_block_dequant(*a),
                                    lambda a=args: ed.expert_block_dequant_plain(*a), 50, 5,
                                    _bound(read + _nbytes(got), got.numel())))
                del got, ref
    record("expert_block_dequant", errs, timed)  # int4 w1 bf16 first
    del forms


# decode_attention_stats against its plain version, absolute on acc / s and
# scaled by max |ref|: about 3x the largest the card read (1.185e-3 to
# 2.256e-3 over the three forms at 1 and 32 lanes; NVIDIA H100 80GB HBM3,
# 700 W). The merge of two blocks against one normal launch over both:
# about 3x its readings (2.639e-3 to 3.301e-3, the normal kernel's bf16
# output rounding); the merge without block 1 read 0.4363-0.6174.
STATS_LIMIT = {"int8": 7e-3, "bf16": 7e-3, "int4": 7e-3}
STATS_MERGE_LIMIT = 1e-2
CP_BLOCK = 4352  # one rank's block of the cp phase's 8,704-position cache


def _stats_err(got, ref, lengths) -> float:
    """max |acc/s - ref acc/s| over the lanes with a position, over max
    |ref acc/s|; lanes of length 0 must give the finite NEG_INF and acc = s
    = 0 on both sides."""
    import torch

    from aria_tpu_torch.ops.decode_attention import NEG_INF

    full = lengths > 0
    for name, (acc, m, s) in (("kernel", got), ("plain", ref)):
        if not (torch.isfinite(acc).all() and torch.isfinite(s).all()):
            raise AssertionError(f"decode_attention_stats ({name}): non-finite acc or s")
        if not ((m[~full] == NEG_INF).all() and (acc[~full] == 0).all()
                and (s[~full] == 0).all()):
            raise AssertionError(f"decode_attention_stats ({name}): an empty lane is not "
                                 "(m = -1e30, acc = s = 0)")
    if not full.any():
        return 0.0
    out = got[0][full] / got[2][full][..., None]
    want = ref[0][full] / ref[2][full][..., None]
    return ((out - want).abs().max() / want.abs().max()).item()


def _merge_blocks(parts):
    """The exact merge of parts' (acc, m, s) (parallel/cp_cache.py's, on one
    device): acc / s of the sum over blocks with corr = exp(m - max m)."""
    import torch

    from aria_tpu_torch.ops.decode_attention import merge_partials

    acc, _, s = merge_partials(parts)
    return acc / torch.clamp_min(s, 1e-30)[..., None]


def check_decode_stats(device, gen, cfg, randn, record, lanes=32, block=CP_BLOCK):
    """Phase 2's ``decode_attention_stats``: the stats form over one rank's
    block of the cp phase's cache (4,352 positions, 20 heads), bf16, int8
    and packed int4, at one lane with local lengths 4,352, 1,648 and 0 and
    at ``lanes`` lanes from 0 to the block, against its plain version; the
    merge of two blocks against the normal kernel over both (8,704
    positions, length 6,000), with the merge that leaves block 1 out as the
    planted fault; and the times at one lane over the whole block beside
    the bound and, for bf16, sdpa over the block (no stats)."""
    import torch
    import torch.nn.functional as F

    from aria_tpu_torch.ops import decode_attention as da

    print("decode_attention_stats", flush=True)
    H, Dh, L = cfg.num_heads, cfg.head_dim, 2

    def caches(B, S):
        return _decode_forms(device, gen, randn, H, Dh, B, S, L)

    errs, timed = [], []
    for B, lens in ((1, [block, 1648, 0]), (lanes, None)):
        forms = caches(B, block)
        q = randn(B, H, Dh)
        for label, cache in forms.items():
            for n in (lens or [None]):
                lengths = (torch.full((1,), n, dtype=torch.int32, device=device) if n is not None
                           else torch.linspace(0, block, B, device=device).round().int())
                args = (q, cache[0], cache[1], 1, lengths, *cache[2:])
                got, ref = da.decode_attention_stats(*args), da.decode_attention_plain(
                    *args, return_stats=True)
                err = _stats_err(got, ref, lengths)
                at = f"len={n}" if n is not None else f"B={B} len=0..{block}"
                limit = STATS_LIMIT[label]
                print(f"  decode_attention_stats {label} {at} of {block}: acc/s max_abs_err "
                      f"{err:.3e} of max |ref| (limit {limit:.0e}: the plain version rounds p "
                      "(times v_scale) to bf16 against the lane's max, the kernel against its "
                      "warps' running max); m max diff "
                      f"{(got[1] - ref[1]).abs().max().item():.3e}", flush=True)
                if not err <= limit:
                    raise AssertionError(f"decode_attention_stats {label} {at}: {err} > {limit}")
                errs.append(err)
        if B == 1:
            n = block
            lengths = torch.full((1,), n, dtype=torch.int32, device=device)
            mask = torch.ones((1, 1, 1, block), dtype=torch.bool, device=device)
            for label, cache in forms.items():
                args = (q, cache[0], cache[1], 1, lengths, *cache[2:])
                Hc = H // 2 if label == "int4" else H
                per = {"int8": 1, "bf16": 2, "int4": 1}[label]
                sc_bytes = {"int8": 4, "bf16": 0, "int4": 2}[label]
                nbytes = 2 * n * Hc * Dh * per + 2 * n * H * sc_bytes + _nbytes(q) + B * H * (
                    Dh + 2) * 4
                library = None
                if label == "bf16":
                    kf, vf = cache
                    library = lambda kf=kf, vf=vf: F.scaled_dot_product_attention(
                        q[:, :, None], kf[1], vf[1], attn_mask=mask)
                timed.append(_timed(f"{label} len={n} of {block}",
                                    lambda a=args: da.decode_attention_stats(*a),
                                    lambda a=args: da.decode_attention_plain(*a, return_stats=True),
                                    200, 10, _bound(nbytes, 4 * n * H * Dh), library))
        del forms

    # two blocks against one normal launch over both
    S2, n = 2 * block, 6000
    lengths = torch.full((1,), n, dtype=torch.int32, device=device)
    q = randn(1, H, Dh)
    for label, cache in caches(1, S2).items():
        whole = da.decode_attention(q, cache[0], cache[1], 1, lengths, *cache[2:]).float()
        parts = []
        for b in range(2):
            local = [t[:, :, :, b * block:(b + 1) * block].contiguous() for t in cache]
            len_b = torch.clamp(lengths - b * block, 0, block).to(torch.int32)
            parts.append(da.decode_attention_stats(q, local[0], local[1], 1, len_b, *local[2:]))
        scale = whole.abs().max().item()
        err = (_merge_blocks(parts) - whole).abs().max().item() / scale
        fault = (_merge_blocks(parts[:1]) - whole).abs().max().item() / scale
        print(f"  decode_attention_stats {label}: two blocks of {block} merged against one "
              f"decode_attention over {S2} positions (length {n}): {err:.3e} of max |ref| (limit "
              f"{STATS_MERGE_LIMIT:.0e}: the normal kernel's bf16 output); block 1 left out: "
              f"{fault:.3e}", flush=True)
        if not err <= STATS_MERGE_LIMIT:
            raise AssertionError(f"decode_attention_stats {label}: merge {err} > limit")
        if not fault > STATS_MERGE_LIMIT:
            raise AssertionError(f"decode_attention_stats {label}: the merge without block 1 "
                                 "passes the limit")
    record("decode_attention_stats", errs, timed)  # int8 at one lane first


LONG_PROMPTS = (8192, 32768)  # flash_causal's long prompts: the cp phase's and bench.py's ctx
LONG_CACHE, LONG_LEN = 32896, 32768  # bench.py's ctx child: --ctx 32768, max_seq 32,896
EDGE_ROWS = 128  # at 32K, the first and the last EDGE_ROWS query rows are held to plain
KEY_TILE = 128  # flash_causal's key tile: the planted fault leaves the last one out
# flash_causal at the long prompts and decode attention at long context,
# held row by row (one query row of one head): max |got - ref| over max
# |ref| of that row, since a row that averages thousands of keys is a
# hundred times smaller than the first rows. About 3x the sound reading,
# one bf16 ulp of a row's largest output (2^-7 = 7.8e-3 at the bottom of a
# binade): flash read 7.752e-3-7.812e-3 on the card at 8K and 32K, decode
# over 32K positions 4.808e-3-5.988e-3 (NVIDIA H100 80GB HBM3, 700 W). The
# planted faults must read above it: the late rows without their last key
# tile read 0.2248-0.3892, the merge without one split's partial
# 8.444e-2-0.5289.
LONG_ROW_LIMIT = 2.5e-2


def _row_err(got, ref) -> float:
    """max over rows (vectors along the last dimension) of max |got - ref|
    over max |ref| of that row."""
    g, r = got.float(), ref.float()
    return ((g - r).abs().amax(-1) / r.abs().amax(-1).clamp_min(1e-30)).max().item()


def _hold_rows(name, got, ref, why: str, fault=None) -> float:
    """``got`` within LONG_ROW_LIMIT of ``ref`` by ``_row_err``, and the
    planted ``fault`` (what, an output with it) above the limit. Returns
    max |got - ref|."""
    import torch

    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    err = _row_err(got, ref)
    planted = None if fault is None else _row_err(fault[1], ref)
    print(f"  {name}: {err:.3e} of its row's max |ref| (limit {LONG_ROW_LIMIT:.1e}: {why})"
          + ("" if fault is None else f"; planted fault, {fault[0]}: {planted:.3e}"), flush=True)
    if not err <= LONG_ROW_LIMIT:
        raise AssertionError(f"{name}: {err} of the row's max |ref| > {LONG_ROW_LIMIT}")
    if fault is not None and not planted > LONG_ROW_LIMIT:
        raise AssertionError(f"{name}: the planted fault ({fault[0]}) passes the limit")
    return (got.float() - ref.float()).abs().max().item()


def _causal_rows_plain(q, k, v, rows, scale, keys=None):
    """flash_causal_plain's numerics (ops/attention.py sdpa) for the query
    rows ``rows`` alone, over their causal keys below ``keys`` (all of them
    by default): [B, len(rows), H, D]."""
    import torch

    from aria_tpu_torch.ops.attention import NEG_INF

    keys = int(rows.max()) + 1 if keys is None else keys
    logits = torch.einsum("bqhd,bkhd->bhqk", q[:, rows].float(), k[:, :keys].float()) * scale
    mask = torch.arange(keys, device=q.device)[None, :] <= rows[:, None]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v[:, :keys].float())
    return out.to(q.dtype)


def _decode_forms(device, gen, randn, H, Dh, B, S, L=2):
    """bf16, int8 (f32 amax / 127 scales) and packed-int4 (bf16 scales)
    caches [L, B, H or H/2, S, Dh] as decode_attention's argument tails."""
    import torch

    kf, vf = randn(L, B, H, S, Dh), randn(L, B, H, S, Dh)
    ks, vs = (torch.clamp_min(t.float().abs().amax(-1), 1e-6) / 127.0 for t in (kf, vf))
    kq, vq = (torch.round(t.float() / sc[..., None]).to(torch.int8)
              for t, sc in ((kf, ks), (vf, vs)))
    kp, vp = (torch.randint(-128, 128, (L, B, H // 2, S, Dh), generator=gen, device=device,
                            dtype=torch.int8) for _ in range(2))
    ks4, vs4 = ((torch.rand((L, B, H, S), generator=gen, device=device) * 0.3 + 0.02)
                .to(torch.bfloat16) for _ in range(2))
    return {"int8": (kq, vq, ks, vs), "bf16": (kf, vf), "int4": (kp, vp, ks4, vs4)}


def _decode_bytes(label, n, H, Dh, q) -> int:
    """The bytes decode attention must move over n positions of one lane:
    keys, values and scales read once, the query read and the output
    written once."""
    per = {"int8": 2 * H * Dh + 2 * H * 4, "bf16": 2 * H * Dh * 2,
           "int4": H // 2 * Dh * 2 + H * 2 * 2}[label]
    return n * per + 2 * _nbytes(q)


def _without_one_split(args, S, label, sms):
    """The planted fault of the split checks: (what, (acc, m, s)), the
    plain version's partials over the heuristic's chunks merged with the
    middle chunk's left out."""
    from aria_tpu_torch.ops import decode_attention as da

    P = da.split_count(1, args[0].shape[1] // (2 if label == "int4" else 1), S, sms)
    parts = da.split_partials(*args, splits=P)
    del parts[P // 2]
    return f"split {P // 2} of {P} left out of the merge", da.merge_partials(parts)


def check_long_context(device, cfg, randn, results):
    """Phase 2 at long context: flash_causal (serving form) at [1, 8192,
    20, 128] and [1, 32768, 20, 128] against its plain version (at 32K the
    plain version cannot run whole: the first and the last 128 query rows
    against the plain attention of those rows), timed beside the bound and
    sdpa; decode_attention's normal form at one lane over 32,768 of 32,896
    positions, int4, int8 and bf16, against the plain version and timed
    beside the bound (sdpa for bf16); and the kernel with its split forced to
    P = 1 against the heuristic's P at one lane over 4,352 and 32,768
    positions, every cache form and both outputs, within the stats limit of
    each other, each call one launch by the counters. The first two are
    held row by row (``_hold_rows``), each with a planted fault that the
    limit must catch: the late rows without their last key tile (flash),
    the merge without one split's partial (decode); the split check has the
    second fault too."""
    import torch
    import torch.nn.functional as F

    from aria_tpu_torch.ops import backend
    from aria_tpu_torch.ops import decode_attention as da
    from aria_tpu_torch.ops import flash as fl

    H, Dh = cfg.num_heads, cfg.head_dim
    sms = backend.sm_count(device)
    gen = torch.Generator(device=device).manual_seed(SEED + 12)

    print("flash_causal (long prompts)", flush=True)
    errs, timed = [], []
    for S in LONG_PROMPTS:
        qkv = [randn(1, S, H, Dh) for _ in range(3)]
        got = fl.flash_causal(*qkv)
        why = ("bf16 output; both round p to bf16 before p.v, the plain version after "
               "normalising it")
        late = torch.arange(S - EDGE_ROWS, S, device=device)
        dropped = (f"rows {S - EDGE_ROWS}..{S - 1} without keys {S - KEY_TILE}..",
                   _causal_rows_plain(*qkv, late, Dh**-0.5, keys=S - KEY_TILE))
        if S == LONG_PROMPTS[0]:
            fault = got.clone()
            fault[:, late] = dropped[1]
            errs.append(_hold_rows(f"flash_causal B=1 S={S}", got, fl.flash_causal_plain(*qkv),
                                   why, (dropped[0], fault)))
            plain = lambda qkv=qkv: fl.flash_causal_plain(*qkv)
            del fault
        else:
            for rows in (torch.arange(EDGE_ROWS, device=device), late):
                errs.append(_hold_rows(
                    f"flash_causal B=1 S={S} rows {int(rows[0])}..{int(rows[-1])}", got[:, rows],
                    _causal_rows_plain(*qkv, rows, Dh**-0.5), why,
                    dropped if rows is late else None))
            plain = None
        del dropped
        del got
        timed.append(_timed(f"B=1 S={S}", lambda qkv=qkv: fl.flash_causal(*qkv), plain, 3, 2,
                            _bound(4 * _nbytes(qkv[0]), H * 4 * Dh * S * (S + 1) / 2),
                            lambda qkv=qkv: F.scaled_dot_product_attention(
                                *(t.transpose(1, 2) for t in qkv), is_causal=True)))
        _print_timed("flash_causal", timed[-1])
        del qkv, plain
    _extend(results["flash_causal"], errs, timed)

    print(f"decode_attention, decode_attention_int4 (one lane over {LONG_LEN} of {LONG_CACHE})",
          flush=True)
    forms = _decode_forms(device, gen, randn, H, Dh, 1, LONG_CACHE)
    q = randn(1, H, Dh)
    lengths = torch.full((1,), LONG_LEN, dtype=torch.int32, device=device)
    mask = (torch.arange(LONG_CACHE, device=device) < LONG_LEN)[None, None, None, :]
    for label, cache in forms.items():
        name = "decode_attention_int4" if label == "int4" else "decode_attention"
        args = (q, cache[0], cache[1], 1, lengths, *cache[2:])
        what, (acc, _, s) = _without_one_split(args, LONG_CACHE, label, sms)
        err = _hold_rows(f"{name} {label} len={LONG_LEN} of {LONG_CACHE}",
                         da.decode_attention(*args), da.decode_attention_plain(*args),
                         "bf16 output; p (times v_scale) rounds to bf16 against the chunk's "
                         "running max in the kernel and the lane's max in the plain version",
                         (what, acc / s[..., None]))
        library = None
        if label == "bf16":
            library = lambda kf=cache[0], vf=cache[1]: F.scaled_dot_product_attention(
                q[:, :, None], kf[1], vf[1], attn_mask=mask)
        t = _timed(f"{label} len={LONG_LEN} of {LONG_CACHE}", lambda a=args: da.decode_attention(*a),
                   lambda a=args: da.decode_attention_plain(*a), 50, 3,
                   _bound(_decode_bytes(label, LONG_LEN, H, Dh, q), 4 * LONG_LEN * H * Dh), library)
        _print_timed(name, t)
        _extend(results[name], [err], [t])

    print("decode_attention split over positions against no split", flush=True)
    counters = {"normal": {"int8": da.decode_attention, "bf16": da.decode_attention,
                           "int4": da.decode_attention_int4},
                "stats": da.decode_attention_stats}
    errs = []
    for S, n, cases in ((CP_BLOCK, CP_BLOCK, _decode_forms(device, gen, randn, H, Dh, 1, CP_BLOCK)),
                        (LONG_CACHE, LONG_LEN, forms)):
        lengths = torch.full((1,), n, dtype=torch.int32, device=device)
        for label, cache in cases.items():
            args = (q, cache[0], cache[1], 1, lengths, *cache[2:])
            P = da.split_count(1, H // 2 if label == "int4" else H, S, sms)
            what, without = _without_one_split(args, S, label, sms)
            for form in ("normal", "stats"):
                stats = form == "stats"
                counter = counters["stats"] if stats else counters["normal"][label]
                before = counter.launches
                one = da.decode_attention(*args, return_stats=stats, splits=1)
                split = da.decode_attention(*args, return_stats=stats)
                if counter.launches != before + 2:
                    raise AssertionError(f"decode_attention {label} {form}: "
                                         f"{counter.launches - before} launches for two calls")
                if stats:
                    err, fault = _stats_err(split, one, lengths), _stats_err(without, one, lengths)
                else:
                    top = one.float().abs().max()
                    err = ((split.float() - one.float()).abs().max() / top).item()
                    fault = ((without[0] / without[2][..., None] - one.float()).abs().max()
                             / top).item()
                limit = STATS_LIMIT[label]
                print(f"  decode_attention {label} {form} len={n} of {S}: P={P} against P=1: "
                      f"{err:.3e} of max |P=1| (limit {limit:.0e}: f32 partials merged in "
                      f"another order; the normal form's bf16 output); planted fault, {what}: "
                      f"{fault:.3e}", flush=True)
                if not err <= limit:
                    raise AssertionError(f"decode_attention {label} {form}: split {err} > {limit}")
                if not fault > limit:
                    raise AssertionError(f"decode_attention {label} {form}: the merge without "
                                         "one split passes the limit")
                errs.append(err)
        del cases
    _extend(results["decode_attention_stats"], errs, [])
    del forms


KERNELS = {
    "dense_int4": ("aria_tpu_torch/csrc/dense_int4.cu", "aria_tpu/ops/dense_int4.py:124"),
    "moe_decode_int4": ("aria_tpu_torch/csrc/moe_decode.cu",
                        "aria_tpu/ops/moe_decode_kernel.py:450"),
    "decode_attention": ("aria_tpu_torch/csrc/decode_attention.cu",
                         "aria_tpu/ops/decode_attention.py:208"),
    "flash_causal": ("aria_tpu_torch/csrc/flash.cu", "aria_tpu/ops/flash.py:30"),
    "vit_flash": ("aria_tpu_torch/csrc/vit_attention.cu", "aria_tpu/ops/vit_flash.py:91"),
    "moe_prefill_int4": ("aria_tpu_torch/csrc/moe_prefill.cu",
                         "aria_tpu/ops/moe_prefill_kernel.py:120"),
    "kv_cache_write": ("aria_tpu_torch/csrc/kv_write.cu", "aria_tpu/ops/kv_write.py:91"),
    "rope_kv_write": ("aria_tpu_torch/csrc/kv_write.cu", "aria_tpu/ops/kv_write.py:91"),
    "decode_attention_int4": ("aria_tpu_torch/csrc/decode_attention.cu",
                              "aria_tpu/ops/decode_attention.py:80"),
    "paged_decode_attention": ("aria_tpu_torch/csrc/decode_attention.cu",
                               "aria_tpu/engine/paged.py:150"),
    "moe_decode": ("aria_tpu_torch/csrc/moe_decode_fp.cu",
                   "aria_tpu/ops/moe_decode_kernel.py:389"),
    "moe_decode_quant": ("aria_tpu_torch/csrc/moe_decode_bf16x.cu",
                         "aria_tpu/ops/moe_decode_kernel.py:503"),
    "gmm": ("aria_tpu_torch/csrc/gmm.cu", "aria_tpu/ops/moe.py:204"),
    "flash_causal_bwd": ("aria_tpu_torch/csrc/flash_bwd.cu",
                         "jax/experimental/pallas/ops/tpu/flash_attention.py:941"),
    "split_hi_lo": ("aria_tpu_torch/csrc/gmm.cu",
                    "jax/experimental/pallas/ops/tpu/megablox/gmm.py:314"),
    "gmm_dlhs": ("aria_tpu_torch/csrc/gmm.cu",
                 "jax/experimental/pallas/ops/tpu/megablox/gmm.py:314"),
    "tgmm": ("aria_tpu_torch/csrc/gmm.cu", "jax/experimental/pallas/ops/tpu/megablox/gmm.py:573"),
    "expert_block_dequant": ("aria_tpu_torch/csrc/expert_dequant.cu",
                             "aria_tpu/models/moe_lm.py:655"),
    "dense_int4_a8": ("aria_tpu_torch/csrc/dense_int4.cu", "aria_tpu/ops/dense_int4.py:97"),
    "moe_decode_int4_bf16": ("aria_tpu_torch/csrc/moe_decode_bf16x.cu",
                             "aria_tpu/ops/moe_decode_kernel.py:307"),
    "flash_segment": ("aria_tpu_torch/csrc/vit_attention.cu", "aria_tpu/ops/flash.py:30"),
    "decode_attention_stats": ("aria_tpu_torch/csrc/decode_attention.cu",
                               "aria_tpu/ops/decode_attention.py:221"),
    "flash_segment_bwd": ("aria_tpu_torch/csrc/vit_attention_bwd.cu",
                          "jax/experimental/pallas/ops/tpu/flash_attention.py:941"),
}
TEXT_PATH = ("dense_int4", "moe_decode_int4", "decode_attention", "flash_causal",
             "rope_kv_write")
IMAGE_PATH = TEXT_PATH + ("vit_flash", "moe_prefill_int4")
INT4_ONLY = ("dense_int4", "moe_decode_int4", "moe_prefill_int4")
FORM_DECODE = {"int8": "moe_decode_quant", "bf16": "moe_decode"}
# the serving features' requests: the verify step (T = 8) and the decode
# steps of the guided, logprobs and penalized requests, the paged lanes
SERVING_PATH = ("dense_int4", "moe_decode_int4", "decode_attention", "flash_causal",
                "rope_kv_write", "paged_decode_attention")
# newest first: a kernel's "launches" is the first with any
PATHS = ("train-mesh", "ep-serve", "train-vit", "train-qlora", "frontdoor-serve", "frontdoor", "serving", "cp",
         "variants-lanes", "variants-image", "adapters", "train-lora", "image-bf16", "lanes-int8",
         "image-int8", "paged", "lanes", "image", "text")


def _wrappers():
    from aria_tpu_torch.ops.decode_attention import (
        decode_attention,
        decode_attention_int4,
        decode_attention_stats,
    )
    from aria_tpu_torch.ops.dense_int4 import dense_int4, dense_int4_a8
    from aria_tpu_torch.ops.expert_dequant import expert_block_dequant
    from aria_tpu_torch.ops.flash import (
        flash_causal,
        flash_causal_bwd,
        flash_segment,
        flash_segment_bwd,
    )
    from aria_tpu_torch.ops.kv_write import kv_cache_write, rope_kv_write
    from aria_tpu_torch.ops.moe import gmm, gmm_dlhs, split_hi_lo, tgmm
    from aria_tpu_torch.ops.moe_decode_kernel import (
        moe_decode,
        moe_decode_int4,
        moe_decode_int4_bf16,
        moe_decode_quant,
    )
    from aria_tpu_torch.ops.moe_prefill_kernel import moe_prefill_int4
    from aria_tpu_torch.ops.paged_attention import paged_decode_attention
    from aria_tpu_torch.ops.vit_flash import vit_flash

    return {"dense_int4": dense_int4, "moe_decode_int4": moe_decode_int4,
            "decode_attention": decode_attention, "flash_causal": flash_causal,
            "vit_flash": vit_flash, "moe_prefill_int4": moe_prefill_int4,
            "kv_cache_write": kv_cache_write, "decode_attention_int4": decode_attention_int4,
            "paged_decode_attention": paged_decode_attention, "moe_decode": moe_decode,
            "moe_decode_quant": moe_decode_quant, "gmm": gmm,
            "flash_causal_bwd": flash_causal_bwd, "split_hi_lo": split_hi_lo,
            "gmm_dlhs": gmm_dlhs, "tgmm": tgmm,
            "expert_block_dequant": expert_block_dequant, "dense_int4_a8": dense_int4_a8,
            "moe_decode_int4_bf16": moe_decode_int4_bf16, "flash_segment": flash_segment,
            "decode_attention_stats": decode_attention_stats, "rope_kv_write": rope_kv_write,
            "flash_segment_bwd": flash_segment_bwd}


@contextlib.contextmanager
def _the_chain():
    """Every forward inside takes the chain that the fused prologue
    ``rope_kv_write`` replaced (``apply_rope``, ``quantize_kv``, the cache
    write): the A/B of launches and busy time. Decode attention scales a
    bf16 query in its kernel either way."""
    from aria_tpu_torch.models import moe_lm

    dest = moe_lm._prologue_dest
    moe_lm._prologue_dest = lambda *args: None
    try:
        yield
    finally:
        moe_lm._prologue_dest = dest


@contextlib.contextmanager
def _no_chain(device, path: str):
    """On the card, every layer of a forward that writes a contiguous cache
    or one token a lane into pages (a decode step, a speculative verify
    step, a from-zero prefill; no serving mesh, no paged chunk) must take
    the fused prologue: a call of ``apply_rope`` or ``quantize_kv`` inside
    one fails ``path``. Prints how many such layer forwards it watched."""
    import inspect

    from aria_tpu_torch.models import moe_lm
    from aria_tpu_torch.ops import kv_write

    if device.type != "cuda":
        yield
        return
    state = {"watch": False, "layers": 0, "chain": 0}
    attention = moe_lm._attention
    bind = inspect.signature(attention).bind

    def watched(*args, **kw):
        a = bind(*args, **kw).arguments
        paged_chunk = a.get("paged") is not None and a["x"].shape[1] > 1
        state["watch"] = a["cache"] is not None and a.get("mesh") is None and not paged_chunk
        state["layers"] += state["watch"]
        try:
            return attention(*args, **kw)
        finally:
            state["watch"] = False

    def counted(fn):
        def call(*args, **kw):
            state["chain"] += state["watch"]
            return fn(*args, **kw)
        return call

    saved = [(moe_lm, "_attention", attention)] + [
        (m, name, getattr(m, name)) for m in (moe_lm, kv_write)
        for name in ("apply_rope", "quantize_kv")]
    for m, name, fn in saved:
        setattr(m, name, watched if name == "_attention" else counted(fn))
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
    if state["chain"] or not state["layers"]:
        raise AssertionError(f"{path}: {state['chain']} calls of apply_rope or quantize_kv in "
                             f"{state['layers']} layer forwards of decode, verify and from-zero "
                             "prefill steps, which the fused prologue should take whole")
    print(f"  {path}: {state['layers']} layer forwards of decode, verify and from-zero prefill "
          "steps, none through apply_rope or quantize_kv (the fused prologue took each)",
          flush=True)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _rel_err(a, b) -> float:
    import torch

    return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()


def _top1(a, b) -> float:
    return (a.argmax(-1) == b.argmax(-1)).float().mean().item()


# The bound on a card-vs-CPU relative error at reduced depth; a wrong
# scale, layout or mask is an O(1) error
REF_LIMIT = 5e-2


def _bump_half(t):
    """One bf16 ulp added to the magnitude of a random half of the entries
    of a bf16 tensor: the witness of how far bf16-level differences alone
    carry, with no kernel involved."""
    import torch

    nudge = torch.rand(t.shape, generator=torch.Generator().manual_seed(SEED)) < 0.5
    return torch.where(nudge, (t.view(torch.int16) + 1).view(torch.bfloat16), t)


def _lm_reference(lm, text, prompt, device, ref_layers=2):
    """The first ``ref_layers`` decoder layers on the card against the CPU's
    plain versions on the same prompt, with the witness beside the limit."""
    import torch

    from aria_tpu_torch.models.moe_lm import embed_tokens, lm_forward

    cut = dataclasses.replace(text, num_layers=ref_layers)
    small = {**lm, "layers": _tree_map(lambda v: v[:ref_layers].contiguous(), lm["layers"])}
    small_cpu = _tree_map(lambda v: v.cpu(), small)
    x = torch.tensor([prompt], device=device)
    got = lm_forward(small, cut, x).logits.float().cpu()
    ref = lm_forward(small_cpu, cut, x.cpu()).logits.float()
    emb = _bump_half(embed_tokens(small_cpu["embed"], x.cpu()))
    ulp = lm_forward(small_cpu, cut, inputs_embeds=emb).logits.float()
    rel, witness = _rel_err(got, ref), _rel_err(ulp, ref)
    # bf16 rounding that differs between card and CPU flips single int8
    # roundings of the W4A8 MoE, which the witness measures without any kernel
    print(f"  reference ({ref_layers} layers, {len(prompt)} tokens, CPU plain versions): "
          f"relative logit error {rel:.3e} (limit {REF_LIMIT:.0e}), top-1 agreement "
          f"{_top1(got, ref):.3f}; witness, CPU with one bf16 ulp on half the embeddings: "
          f"relative error {witness:.3e}, top-1 agreement {_top1(ulp, ref):.3f}", flush=True)
    if not rel <= REF_LIMIT:
        raise AssertionError(f"reference logits differ: relative error {rel}")


def _serve(engine, requests, wrappers, vocab, gpu, **image):
    """Answer the requests with every launch count set to 0 first; returns
    the results and the counts read right after."""
    for w in wrappers.values():  # count only what the serving path launches
        w.launches = 0
    results = []
    with _no_chain(engine.device, "the requests"):
        for name, prompt, gcfg in requests:
            r = engine.generate(prompt, gcfg, **image)
            results.append(r)
            print(f"  request {name}: {len(r.tokens)} tokens, prefill {r.prefill_s * 1e3:.1f} "
                  f"ms, decode {r.tokens_per_s:.2f} tok/s ({gpu})", flush=True)
    launches = {name: w.launches for name, w in wrappers.items()}
    print(f"  launches: {launches}", flush=True)
    for (name, _, gcfg), r in zip(requests, results):
        if len(r.tokens) != gcfg.max_new_tokens:
            raise AssertionError(f"{name}: {len(r.tokens)} tokens, wanted {gcfg.max_new_tokens}")
        if not all(0 <= t < vocab for t in r.tokens):
            raise AssertionError(f"{name}: token out of range")
    return results, launches


def run_slice(device, gen, cfg=None, gpu=""):
    """Phase 3: the text path through ``Engine.generate`` on the random
    full-width int4 model. Returns the model's LM params and each kernel's
    launch count in this phase."""
    import numpy as np
    import torch

    from aria_tpu_torch import AriaConfig
    from aria_tpu_torch.engine.generate import Engine, GenerationConfig
    from aria_tpu_torch.models.moe_lm import KVCache, init_lm_params_serving_int4, lm_forward

    cfg = cfg or AriaConfig()
    text = cfg.text
    t0 = time.perf_counter()
    lm = init_lm_params_serving_int4(text, gen, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
        gib = torch.cuda.memory_allocated() / 2**30
    else:
        gib = float("nan")
    print(f"slice: {text.num_layers} layers, {text.num_experts}+{text.num_shared_experts} "
          f"experts, int4 serving form initialised in {time.perf_counter() - t0:.1f} s "
          f"({gib:.2f} GiB on the card)", flush=True)
    engine = Engine({"lm": lm}, cfg, max_seq_len=1024, cache_dtype=torch.int8,
                    rng_seed=SEED)
    rng = np.random.RandomState(SEED)
    prompt100 = [int(t) for t in rng.randint(1, text.vocab_size, 100)]
    greedy = GenerationConfig(max_new_tokens=64, temperature=0.0, decode_chunk=50)
    sampled = GenerationConfig(max_new_tokens=200, temperature=0.8, top_k=200,
                               decode_chunk=50)
    requests = [("[11]*48 greedy", [11] * 48, greedy),
                ("[11]*48 greedy again", [11] * 48, greedy),
                ("100-token prompt, T 0.8 top-k 200", prompt100, sampled)]
    wrappers = _wrappers()
    results, launches = _serve(engine, requests, wrappers, text.vocab_size, gpu)
    if results[0].tokens != results[1].tokens:
        raise AssertionError("the repeated greedy request gave another stream")
    for name in TEXT_PATH:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the text path")
    with _the_chain():  # the stream through the chain the fused prologue replaced
        chained = engine.generate(*requests[0][1:])
    if chained.tokens != results[0].tokens:
        raise AssertionError("the greedy text stream through the chain differs from the fused "
                             "prologue's")
    print(f"  {requests[0][0]} through the chain the fused prologue replaced: the same "
          f"{len(chained.tokens)} tokens", flush=True)

    with torch.inference_mode():
        # the prefill's logits: finite, and their argmax is the first token
        tokens = torch.zeros((1, 64), dtype=torch.long, device=device)
        tokens[0, :48] = 11
        cache = KVCache.init(text, 1, engine.max_seq_len, torch.int8, device=device)
        logits = lm_forward(lm, text, tokens, positions=torch.arange(64, device=device),
                            cache=cache, cache_pos=0, logit_position=47,
                            causal_flash=True).logits
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite prefill logits")
        if int(logits[0, 0].argmax()) != results[0].tokens[0]:
            raise AssertionError("prefill argmax differs from the first greedy token")
        _lm_reference(lm, text, prompt100[:16], device)
    return lm, launches


def _device_ms(fn) -> tuple[float, object]:
    """One call under the profiler: (device ms, key_averages)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    return sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3, events


def _image_prefill(device, params, cfg, engine, pv, prompt, first_token, gpu):
    """bench.py's image prefill again, outside the engine: the features'
    shape, finite logits whose argmax is the first greedy token, and on the
    card the warm encode and prefill times with the device time by kernel."""
    import torch

    from aria_tpu_torch.models.aria import encode_images, prepare_embeddings
    from aria_tpu_torch.models.moe_lm import KVCache, lm_forward

    text = cfg.text
    lm = params["lm"]
    bucket = max(32, 1 << (len(prompt) - 1).bit_length())  # the engine's: 512 at 272 tokens
    tokens = torch.zeros((1, bucket), dtype=torch.long, device=device)
    tokens[0, :len(prompt)] = torch.tensor(prompt)

    def encode():
        return encode_images(params, cfg, pv)

    def prefill(feats):
        embeds = prepare_embeddings(params, cfg, tokens, image_features=feats)
        cache = KVCache.init(text, 1, engine.max_seq_len, engine.cache_dtype, device=device)
        return lm_forward(lm, text, inputs_embeds=embeds,
                          positions=torch.arange(bucket, device=device), cache=cache,
                          cache_pos=0, logit_position=len(prompt) - 1,
                          causal_flash=True).logits

    feats = encode()
    logits = prefill(feats)
    n_q = cfg.projector.query_count(cfg.vision.patches_per_side**2)
    if feats.shape != (1, n_q, text.hidden_size) or not torch.isfinite(feats).all():
        raise AssertionError(f"image features: shape {tuple(feats.shape)} or non-finite")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite image prefill logits")
    if int(logits[0, 0].argmax()) != first_token:
        raise AssertionError("image prefill argmax differs from the first greedy token")
    if device.type != "cuda":
        return
    # where the image-to-first-token time goes, warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = encode()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prefill(feats)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    enc_ms, enc_ev = _device_ms(encode)
    pre_ms, pre_ev = _device_ms(lambda: prefill(feats))
    print(f"  image prefill, warm ({gpu}): ViT + projector {(t1 - t0) * 1e3:.1f} ms wall, "
          f"{enc_ms:.1f} ms device; LM prefill ({bucket} tokens) {(t2 - t1) * 1e3:.1f} ms "
          f"wall, {pre_ms:.1f} ms device", flush=True)
    for label, ev in (("ViT + projector", enc_ev), ("LM prefill", pre_ev)):
        print(f"  device time by kernel, {label} ({gpu}):\n"
              + ev.table(sort_by="self_device_time_total", row_limit=12), flush=True)
    _prefill_moe_shares(lambda: prefill(feats), pre_ms, gpu)
    fused = _launches_ms(lambda: prefill(feats))
    with _the_chain():
        chain = _launches_ms(lambda: prefill(feats))
    print(f"  LM prefill ({bucket} tokens, {gpu}): {fused[0]} kernel launches through the fused "
          f"prologue against {chain[0]} through the chain it replaced ({chain[0] - fused[0]} "
          f"fewer); device {fused[1]:.2f} against {chain[1]:.2f} ms; wall {fused[2]:.1f} "
          f"against {chain[2]:.1f} ms (profiler on)", flush=True)


def _launches_ms(fn) -> tuple[int, float, float]:
    """One call under the profiler: (kernel launches, device ms, wall ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    return (sum(e.count for e in events if e.key == "cudaLaunchKernel"),
            sum(e.self_device_time_total for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3, wall)


def _prefill_moe_shares(prefill, pre_ms: float, gpu: str) -> None:
    """What the LM prefill's MoE FFN costs beside its kernel: the calls of
    ``experts_segmented_int4`` of one prefill, recorded, run again under the
    profiler, with the device time of moe_prefill_int4's two kernels and of
    ``segment_dispatch`` alone; the rest is the glue around them (the x_seg
    zero fill and scatter, the gather and the einsum)."""
    from aria_tpu_torch.models import moe_lm
    from aria_tpu_torch.ops import moe_prefill_kernel as mp

    calls, fn = [], moe_lm.experts_segmented_int4

    def recorded(*args):
        calls.append(args)
        return fn(*args)

    moe_lm.experts_segmented_int4 = recorded
    try:
        prefill()
    finally:
        moe_lm.experts_segmented_int4 = fn
    moe_ms, moe_ev = _device_ms(lambda: [fn(*a) for a in calls])
    disp_ms = _device_ms(lambda: [mp.segment_dispatch(a[1], a[3].shape[1]) for a in calls])[0]
    kern = {name: sum(e.self_device_time_total for e in moe_ev if name in e.key) / 1e3
            for name in ("prefill_glu", "prefill_down")}
    glue = moe_ms - sum(kern.values())

    def share(ms):
        return f"{ms:.2f} ms ({100 * ms / pre_ms:.1f}%)"

    print(f"  LM prefill's MoE FFN ({len(calls)} calls of experts_segmented_int4, {gpu}): "
          f"{share(moe_ms)} of {pre_ms:.1f} ms device; moe_prefill_int4 glu "
          f"{share(kern['prefill_glu'])}, down {share(kern['prefill_down'])}; the torch glue "
          f"{share(glue)}: segment_dispatch {share(disp_ms)}, the x_seg zero fill and "
          f"scatter, the gather and the einsum {share(glue - disp_ms)}", flush=True)


def run_image(device, gen, lm, cfg=None, gpu=""):
    """Phase 4: bench.py's image request (bench.py:387-461) through
    ``Engine.generate``: one uint8 980px crop, the prompt [11]*8 + [9]*256 +
    [13]*8 (a 512-token bucket), int8 KV, the ViT and projector
    random-initialised and int8-quantized as bench.py builds them. Returns
    each kernel's launch count in this phase and the timed request's
    (image-to-first-token ms, decode tok/s)."""
    import numpy as np
    import torch

    from aria_tpu_torch import AriaConfig
    from aria_tpu_torch.engine.generate import Engine, GenerationConfig
    from aria_tpu_torch.models.aria import encode_images, normalize_pixels
    from aria_tpu_torch.models.projector import init_projector_params
    from aria_tpu_torch.models.vit import init_vit_params
    from aria_tpu_torch.ops.quant import quantize_projector_params, quantize_vit_params

    cfg = cfg or AriaConfig()
    text, vision = cfg.text, cfg.vision
    t0 = time.perf_counter()
    params = {
        "lm": lm,
        "vision": quantize_vit_params(init_vit_params(vision, gen, device=device)),
        "projector": quantize_projector_params(init_projector_params(cfg.projector, gen,
                                                                     device=device)),
    }
    if device.type == "cuda":
        torch.cuda.synchronize()
    print(f"image path: {vision.num_layers}-layer ViT ({vision.hidden_size} wide) and the "
          f"projector, int8, initialised in {time.perf_counter() - t0:.1f} s", flush=True)
    engine = Engine(params, cfg, max_seq_len=1024, cache_dtype=torch.int8, rng_seed=SEED)
    side = vision.image_size
    pixels = np.random.RandomState(SEED).randint(0, 256, (1, 3, side, side), dtype=np.uint8)
    n_q = cfg.projector.query_count(vision.patches_per_side**2)
    prompt = [11] * 8 + [cfg.image_token_id] * n_q + [13] * 8
    sampled = GenerationConfig(max_new_tokens=200, temperature=0.8, top_k=200,
                               decode_chunk=50)
    greedy = GenerationConfig(max_new_tokens=64, temperature=0.0, decode_chunk=50)
    warm = dataclasses.replace(sampled, max_new_tokens=WARMUP_TOKENS)
    requests = [("image, T 0.8 top-k 200 (warm-up)", prompt, warm),
                ("image, T 0.8 top-k 200", prompt, sampled),
                ("image greedy", prompt, greedy),
                ("image greedy again", prompt, greedy)]
    results, launches = _serve(engine, requests, _wrappers(), text.vocab_size, gpu,
                               pixel_values=pixels)
    if results[2].tokens != results[3].tokens:
        raise AssertionError("the repeated greedy image request gave another stream")
    for name in IMAGE_PATH:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the image path")
    print(f"  image request (bench.py's): image-to-first-token {results[1].prefill_s * 1e3:.1f} "
          f"ms, decode {results[1].tokens_per_s:.2f} tok/s ({gpu})", flush=True)

    with torch.inference_mode():
        pv = torch.as_tensor(pixels, device=device)
        _image_prefill(device, params, cfg, engine, pv, prompt, results[2].tokens[0], gpu)

        # the card against the CPU's plain versions at reduced depth
        ref_layers = 2
        cut = cfg.replace(vision=dataclasses.replace(vision, num_layers=ref_layers))
        vis2 = {**params["vision"],
                "layers": _tree_map(lambda v: v[:ref_layers].contiguous(),
                                    params["vision"]["layers"])}
        small = {"vision": vis2, "projector": params["projector"]}
        small_cpu = _tree_map(lambda v: v.cpu(), small)
        got = encode_images(small, cut, pv).float().cpu()
        ref = encode_images(small_cpu, cut, pv.cpu()).float()
        bumped = _bump_half(normalize_pixels(pv.cpu()).to(torch.bfloat16)).float()
        ulp = encode_images(small_cpu, cut, bumped).float()
        rel, witness = _rel_err(got, ref), _rel_err(ulp, ref)
        print(f"  reference encode_images ({ref_layers} ViT layers, one {side}px crop, CPU "
              f"plain versions): relative error {rel:.3e} (limit {REF_LIMIT:.0e}); witness, CPU "
              f"with one bf16 ulp on half the pixels: relative error {witness:.3e}", flush=True)
        if not rel <= REF_LIMIT:
            raise AssertionError(f"reference image features differ: relative error {rel}")
        rng = np.random.RandomState(SEED + 1)
        _lm_reference(lm, text, [int(t) for t in rng.randint(1, text.vocab_size, 200)], device)
    return launches, (results[1].prefill_s * 1e3, results[1].tokens_per_s)


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


# the decode MoE's kernels, by name: csrc/moe_decode.cu (W4A8) and
# moe_decode_bf16x.cu (bf16 activations: the int4 form under the variants,
# and the int8 form), both on moe_pairs.cuh's prep_kernel and combine_kernel;
# moe_decode_fp.cu's bf16 experts end in moe_combine_kernel. Each path runs
# one form.
MOE_KERNELS = ("prep_kernel", "gateup_kernel", "hquant_kernel", "down_kernel",
               "combine_kernel")
BF16X_MOE_KERNELS = ("prep_kernel", "bf16x_gateup_kernel", "bf16x_down_kernel",
                     "combine_kernel")


WARMUP_TOKENS = 50  # a warm-up round's tokens per request: one of bench.py's decode chunks


def _lanes_rounds(device, engine, wrappers, lanes, top, new_tokens, rounds, gpu) -> tuple:
    """bench.py's lanes rounds on ``engine``: each submits ``lanes``
    prompts of 48 tokens drawn from ``np.random.RandomState(0).randint(5,
    1000)`` with ``new_tokens`` each (the warm-up round at most
    WARMUP_TOKENS), times the grouped admission on its own and the decode
    steps after it, and checks every request. Returns the last round's wall
    ms per decode step and its aggregate tok/s."""
    import numpy as np
    import torch

    rng = np.random.RandomState(0)
    vocab = engine.cfg.text.vocab_size
    # the engine's state is inference tensors
    with torch.inference_mode(), _no_chain(device, "the lanes rounds"):
        for rnd in range(rounds):
            n_new = new_tokens if rnd else min(new_tokens, WARMUP_TOKENS)
            for _ in range(lanes):
                engine.submit(rng.randint(5, top, 48).tolist(), max_new_tokens=n_new)
            _sync(device)
            t0 = time.perf_counter()
            engine._admit_all()  # the grouped admission, timed on its own
            _sync(device)
            t1 = time.perf_counter()
            admitted = {n: w.launches for n, w in wrappers.items()}
            finished, chunks = [], 0
            while engine.queue or engine._active_mask().any():
                finished += engine.step()  # each ends in the chunk's one read-back
                chunks += 1
            t2 = time.perf_counter()
            if len(finished) != lanes:
                raise AssertionError(f"lanes round {rnd}: {len(finished)} of {lanes} finished")
            for r in finished:
                if r.error or len(r.generated) != n_new:
                    raise AssertionError(f"lanes request {r.uid}: {len(r.generated)} tokens, "
                                         f"error {r.error}")
                if not all(0 <= t < vocab for t in r.generated):
                    raise AssertionError(f"lanes request {r.uid}: token out of range")
            steps = chunks * engine.decode_chunk
            per_step = sum(w.launches - admitted[n] for n, w in wrappers.items()) / steps
            total = sum(len(r.generated) for r in finished)
            step_ms = (t2 - t1) / steps * 1e3
            print(f"  round {rnd}{' (warm-up)' if rnd == 0 else ''}: {total} tokens in "
                  f"{t2 - t0:.3f} s = {total / (t2 - t0):.2f} tok/s aggregate; grouped admission "
                  f"{(t1 - t0) * 1e3:.1f} ms wall; decode {steps} steps, "
                  f"{step_ms:.2f} ms wall per step; {per_step:.1f} hand-kernel "
                  f"launches per step ({gpu})", flush=True)
    return step_ms, total / (t2 - t0)


def run_lanes(device, lm, cfg=None, gpu="", lanes=32, new_tokens=100, rounds=2):
    """Phase 5: bench.py's lanes child (bench.py:48-104, 247-256) through
    the port's ``BatchedEngine``: 32 lanes, max_seq_len 320, T 0.8, top-k
    200, decode_chunk 50, the int4 KV cache; each round submits 32 prompts
    of 48 tokens drawn from ``np.random.RandomState(0).randint(5, 1000)``
    with 200 new tokens each; one warm-up round and one timed one. Then a
    profiled decode chunk, a greedy check with the int8 KV cache and a
    2-layer batched decode step against the CPU's plain versions. Returns
    each kernel's launch count over the rounds and the timed round's
    (tok/s, decode-step ms)."""
    import torch

    from aria_tpu_torch import AriaConfig
    from aria_tpu_torch.engine.server import BatchedEngine

    cfg = cfg or AriaConfig()
    text = cfg.text
    top = min(1000, text.vocab_size)
    wrappers = _wrappers()
    for w in wrappers.values():  # count only what the lanes path launches
        w.launches = 0
    engine = BatchedEngine({"lm": lm}, cfg, max_lanes=lanes, max_seq_len=320, temperature=0.8,
                           top_k=200, decode_chunk=50, cache_dtype="int4", rng_seed=SEED)
    print(f"lanes: {lanes} lanes, int4 KV over {engine.S} positions, {new_tokens} tokens per "
          f"request, {rounds} rounds (the first warms up, at most {WARMUP_TOKENS} tokens)",
          flush=True)
    step_ms, tok_s = _lanes_rounds(device, engine, wrappers, lanes, top, new_tokens, rounds, gpu)
    launches = {name: w.launches for name, w in wrappers.items()}
    print(f"  launches: {launches}", flush=True)
    for name in ("rope_kv_write", "decode_attention_int4"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the lanes path")

    with torch.inference_mode():
        if device.type == "cuda":
            _profile_lanes_chunk(engine, lanes, top, new_tokens, step_ms)
        del engine
        _lanes_greedy_check(device, lm, cfg, top)
        _lanes_reference(device, lm, text, top)
    return launches, (tok_s, step_ms)


def _profile_lanes_chunk(engine, lanes, top, new_tokens, step_ms, steps=5, label="lanes",
                        moe_kernels=None):
    """A decode chunk of ``steps`` steps over all lanes under the profiler:
    device busy time, the decode MoE's share (the W4A8 kernels unless
    ``moe_kernels`` names others) and kernel launches per step; the idle
    share is against ``step_ms``, the wall per step of the last round with
    the profiler off."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.RandomState(1)
    uids = [engine.submit(rng.randint(5, top, 48).tolist(), max_new_tokens=new_tokens)
            for _ in range(lanes)]
    engine.decode_chunk = steps
    engine.step()  # admission and a first chunk, unprofiled
    torch.cuda.synchronize()

    def chunk():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.step()
            wall = (time.perf_counter() - t0) / steps
        events = prof.key_averages()
        dev_ev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in dev_ev) / steps / 1e3
        n_launch = sum(e.count for e in events if e.key == "cudaLaunchKernel") / steps
        return events, dev_ev, busy, wall, n_launch

    events, dev_ev, busy, wall, n_launch = chunk()
    moe = sum(e.self_device_time_total for e in dev_ev
              if any(k in e.key for k in moe_kernels or MOE_KERNELS)) / steps / 1e3
    print(f"  profiled decode chunk ({steps} steps x {lanes} lanes): wall {wall * 1e3:.2f} ms per "
          f"step (profiler on), device busy {busy:.3f} ms per step, of it the decode MoE "
          f"{moe:.3f} ms; {n_launch:.0f} kernel launches per step; device idle share "
          f"{1 - busy / step_ms:.3f} of the {step_ms:.2f} ms step (profiler off)", flush=True)
    print(f"  device time by kernel, {label} decode:\n"
          + events.table(sort_by="self_device_time_total", row_limit=12), flush=True)
    with _the_chain():  # the same chunk through the chain the prologue replaced
        _, _, chain_busy, chain_wall, chain_launch = chunk()
    print(f"  {label} decode, per step: {n_launch:.0f} kernel launches through the fused "
          f"prologue against {chain_launch:.0f} through the chain it replaced "
          f"({chain_launch - n_launch:.0f} fewer); device busy {busy:.3f} against "
          f"{chain_busy:.3f} ms; wall {wall * 1e3:.2f} against {chain_wall * 1e3:.2f} ms "
          "(profiler on)", flush=True)
    for uid in uids:
        engine.cancel(uid)
    engine.step()


def _lanes_greedy_check(device, lm, cfg, top):
    """Greedy with the int8 KV cache: four requests in two buckets, served
    twice, give the same streams, and the same again through the chain that
    the fused prologue replaced; each first token is the argmax of its row
    of the grouped prefill's logits."""
    import numpy as np
    import torch

    from aria_tpu_torch.engine.server import BatchedEngine
    from aria_tpu_torch.models.moe_lm import KVCache, lm_forward

    text = cfg.text
    rng = np.random.RandomState(2)
    prompts = [rng.randint(5, top, n).tolist() for n in (20, 30, 40, 60)]  # buckets 32 and 64
    streams = []
    for chain in (False, False, True):
        eng = BatchedEngine({"lm": lm}, cfg, max_lanes=4, max_seq_len=320, decode_chunk=16,
                            cache_dtype=torch.int8, rng_seed=SEED)
        uids = [eng.submit(p, max_new_tokens=32) for p in prompts]
        with _the_chain() if chain else contextlib.nullcontext():
            fin = {r.uid: r for r in eng.run_until_complete()}
        streams.append([fin[u].generated for u in uids])
    if streams[0] != streams[1] or any(len(s) != 32 for s in streams[0]):
        raise AssertionError("the repeated greedy lanes requests gave other streams")
    if streams[2] != streams[0]:
        raise AssertionError("the greedy lanes streams through the chain differ from the fused "
                             "prologue's")
    for group, bucket in (((0, 1), 32), ((2, 3), 64)):  # the engine's two grouped prefills
        toks = torch.zeros((2, bucket), dtype=torch.long, device=device)
        for row, i in enumerate(group):
            toks[row, :len(prompts[i])] = torch.tensor(prompts[i])
        lens = torch.tensor([len(prompts[i]) for i in group], device=device)
        cache = KVCache.init(text, 2, bucket, torch.int8, device=device)
        logits = lm_forward(lm, text, toks, positions=torch.arange(bucket, device=device),
                            cache=cache, cache_pos=0, logit_position=lens - 1,
                            causal_flash=True).logits[:, 0]
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite grouped prefill logits")
        for row, i in enumerate(group):
            if int(logits[row].argmax()) != streams[0][i][0]:
                raise AssertionError(f"lane {i}: first token is not its prefill row's argmax")
    print(f"  greedy, int8 KV, 4 requests in buckets 32 and 64: streams repeat, and are the "
          f"same through the chain the fused prologue replaced; first tokens "
          f"{[s[0] for s in streams[0]]} equal their prefill rows' argmax", flush=True)


def _lanes_reference(device, lm, text, top, ref_layers=2):
    """A 2-layer grouped prefill then one batched decode step with per-lane
    positions, on the card against the CPU's plain versions, with the bf16
    witness beside the limit. The int8 KV cache is held to the limit; the
    int4 one is reported beside its own witness and not held: a one-ulp
    move of a bf16 k or v moves its int4 rounding by a seventh of the
    head's range, which the witness shows is far above 5e-2."""
    import numpy as np
    import torch

    from aria_tpu_torch.models.moe_lm import KVCache, embed_tokens, lm_forward

    cut = dataclasses.replace(text, num_layers=ref_layers)
    small = {**lm, "layers": _tree_map(lambda v: v[:ref_layers].contiguous(), lm["layers"])}
    small_cpu = _tree_map(lambda v: v.cpu(), small)
    rng = np.random.RandomState(3)
    lens = [5, 9, 14, 20]
    toks = torch.zeros((4, 32), dtype=torch.long)
    for b, n in enumerate(lens):
        toks[b, :n] = torch.from_numpy(rng.randint(5, top, n))
    new = torch.from_numpy(rng.randint(5, top, 4)).to(torch.int32)
    cpu = torch.device("cpu")

    def step(params, dev, cache_dtype, bump=False):
        emb = embed_tokens(params["embed"], toks.to(dev))
        if bump:
            emb = _bump_half(emb)
        cache = KVCache.init(cut, 4, 128, cache_dtype, device=dev)
        lm_forward(params, cut, inputs_embeds=emb, positions=torch.arange(32, device=dev),
                   cache=cache, cache_pos=0, causal_flash=True)
        pos = torch.tensor(lens, dtype=torch.int32, device=dev)
        return lm_forward(params, cut, new[:, None].long().to(dev), positions=pos[:, None],
                          cache=cache, cache_pos=pos).logits[:, 0].float().cpu()

    for cache_dtype, label in ((torch.int8, "int8"), ("int4", "int4")):
        got, ref = step(small, device, cache_dtype), step(small_cpu, cpu, cache_dtype)
        ulp = step(small_cpu, cpu, cache_dtype, bump=True)
        rel, witness = _rel_err(got, ref), _rel_err(ulp, ref)
        held = cache_dtype == torch.int8
        print(f"  reference ({ref_layers} layers, {label} KV, a decode step of 4 lanes at "
              f"positions {lens}, CPU plain versions): relative logit error {rel:.3e} "
              f"({f'limit {REF_LIMIT:.0e}' if held else 'not held'}), top-1 agreement "
              f"{_top1(got, ref):.3f}; witness, CPU with one bf16 ulp on half the prompt "
              f"embeddings: relative error {witness:.3e}, top-1 agreement {_top1(ulp, ref):.3f}",
              flush=True)
        if held and not rel <= REF_LIMIT:
            raise AssertionError(f"reference lanes logits differ: relative error {rel}")


PREFIX_LOGIT_LIMIT = 5e-2  # relative first-token logit error, cached against uncached pages


def run_paged(device, lm, cfg=None, gpu="", lanes=32, new_tokens=100, rounds=2,
              max_seq=512, page_size=256, chunk=128):
    """Phase 6: bench.py's lanes child with ``--paged --kv-int8``
    (bench.py:48-104) through the port's ``PagedBatchedEngine``: 32 lanes,
    max_seq_len 512 in 256-token pages (the default pool: 1 + 32 x 2
    pages), 128-token prefill chunks, T 0.8, top-k 200, decode_chunk 50,
    int8 pages; each round submits 32 prompts of 48 tokens drawn from
    ``np.random.RandomState(0).randint(5, 1000)`` with 200 new tokens each;
    one warm-up round and one timed one. Then a profiled prefill tick and
    decode chunk, the batch-dependence diagnosis, two prefix-cache rounds,
    the tight-pool request and a 2-layer paged chunk and decode step
    against the CPU's plain versions. Returns each kernel's launch count
    over the rounds."""
    import numpy as np
    import torch

    from aria_tpu_torch import AriaConfig
    from aria_tpu_torch.engine.server import PagedBatchedEngine

    cfg = cfg or AriaConfig()
    text = cfg.text
    top = min(1000, text.vocab_size)
    wrappers = _wrappers()
    for w in wrappers.values():  # count only what the paged path launches
        w.launches = 0
    engine = PagedBatchedEngine({"lm": lm}, cfg, max_lanes=lanes, max_seq_len=max_seq,
                                page_size=page_size, prefill_chunk=chunk, temperature=0.8,
                                top_k=200, decode_chunk=50, cache_dtype=torch.int8,
                                rng_seed=SEED)
    rng = np.random.RandomState(0)
    print(f"paged: {lanes} lanes, int8 pages of {page_size} over {engine.S} positions, "
          f"{engine.pool.available + 1} pages, chunks of {chunk}, {new_tokens} tokens per "
          f"request, {rounds} rounds (the first warms up, {WARMUP_TOKENS} tokens)", flush=True)
    pda = wrappers["paged_decode_attention"]
    # the engine's state is inference tensors
    with torch.inference_mode(), _no_chain(device, "the paged rounds"):
        for rnd in range(rounds):
            n_new = new_tokens if rnd else min(new_tokens, WARMUP_TOKENS)
            for _ in range(lanes):
                engine.submit(rng.randint(5, top, 48).tolist(), max_new_tokens=n_new)
            _sync(device)
            t0 = time.perf_counter()
            while engine._admit():
                pass
            engine._prefill_tick()  # one chunk holds every 48-token prompt
            _sync(device)
            t1 = time.perf_counter()
            admitted = {n: w.launches for n, w in wrappers.items()}
            finished, chunks = [], 0
            while engine.queue or any(s is not None for s in engine.lane_state):
                finished += engine.step()  # each ends in the chunk's one read-back
                chunks += 1
            t2 = time.perf_counter()
            if len(finished) != lanes:
                raise AssertionError(f"paged round {rnd}: {len(finished)} of {lanes} finished")
            for r in finished:
                if r.error or len(r.generated) != n_new:
                    raise AssertionError(f"paged request {r.uid}: {len(r.generated)} tokens, "
                                         f"error {r.error}")
                if not all(0 <= t < text.vocab_size for t in r.generated):
                    raise AssertionError(f"paged request {r.uid}: token out of range")
            steps = chunks * engine.decode_chunk
            per_step = sum(w.launches - admitted[n] for n, w in wrappers.items()) / steps
            attn = (pda.launches - admitted["paged_decode_attention"]) / steps
            if device.type == "cuda" and attn != text.num_layers:
                raise AssertionError(f"paged_decode_attention launched {attn} times per decode "
                                     f"step, not once per layer ({text.num_layers})")
            total = sum(len(r.generated) for r in finished)
            step_ms = (t2 - t1) / steps * 1e3
            print(f"  round {rnd}{' (warm-up)' if rnd == 0 else ''}: {total} tokens in "
                  f"{t2 - t0:.3f} s = {total / (t2 - t0):.2f} tok/s aggregate; prefill tick "
                  f"({lanes} x {chunk} tokens) {(t1 - t0) * 1e3:.1f} ms wall; decode {steps} "
                  f"steps, {step_ms:.2f} ms wall per step; {per_step:.1f} hand-kernel launches "
                  f"per step, of them paged_decode_attention {attn:.0f} ({gpu})", flush=True)
    launches = {name: w.launches for name, w in wrappers.items()}
    print(f"  launches: {launches}", flush=True)
    for name in ("rope_kv_write", "paged_decode_attention", "dense_int4", "moe_decode_int4",
                 "moe_prefill_int4"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the paged path")

    with torch.inference_mode():
        if device.type == "cuda":
            _profile_prefill_tick(engine, lanes, top, new_tokens)
            _profile_lanes_chunk(engine, lanes, top, new_tokens, step_ms, label="paged")
        del engine
        # the served chunk beside a companion and alone, and a whole page alone
        for at, few in ((chunk, 2), (chunk, 1), (page_size, 1)):
            _batch_dependence(device, lm, cfg, top, max_seq, page_size, at, few)
        _prefix_round(lm, cfg, top, max_seq, page_size, chunk, companion=False)
        _prefix_round(lm, cfg, top, max_seq, page_size, chunk, companion=True)
        _tight_pool(lm, cfg, top, max_seq, page_size, chunk)
        _paged_reference(device, lm, text, top, page_size)
    return launches


def _profile_prefill_tick(engine, lanes, top, new_tokens):
    """One prefill tick of ``lanes`` 48-token prompts (one chunk each)
    under the profiler: wall and device time, by kernel."""
    import numpy as np
    import torch

    rng = np.random.RandomState(4)
    uids = [engine.submit(rng.randint(5, top, 48).tolist(), max_new_tokens=new_tokens)
            for _ in range(lanes)]
    while engine._admit():
        pass
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    busy, events = _device_ms(engine._prefill_tick)
    wall = (time.perf_counter() - t0) * 1e3
    print(f"  profiled prefill tick ({lanes} x {engine.C} rows): wall {wall:.1f} ms (profiler "
          f"on), device busy {busy:.1f} ms; device time by kernel:\n"
          + events.table(sort_by="self_device_time_total", row_limit=15), flush=True)
    for uid in uids:
        engine.cancel(uid)
    engine.step()


def _row0(x, rows: int, C: int):
    """Row 0's share of an op's argument or result in a chunk of ``rows``
    lanes x C tokens: tensors led by rows * C tokens keep the first C, led
    by rows lanes the first lane; weights, ints and caches pass as they
    are."""
    import torch

    if isinstance(x, torch.Tensor):
        if x.dim() and x.shape[0] == rows * C:
            return x[:C]
        return x[:1] if x.dim() and x.shape[0] == rows else x
    if isinstance(x, tuple):
        parts = [_row0(v, rows, C) for v in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return x


def _max_diff(a, b) -> float:
    if isinstance(a, tuple):
        return max(_max_diff(x, y) for x, y in zip(a, b))
    return (a.float() - b.float()).abs().max().item()


BATCH_OPS = (("models.moe_lm", "rms_norm"), ("models.moe_lm", "dense_int4"),
             ("models.moe_lm", "apply_rope"), ("models.moe_lm", "quantize_kv"),
             ("models.moe_lm", "gather_lane_kv"), ("models.moe_lm", "sdpa"),
             ("models.moe_lm", "route_topk"), ("ops.moe_prefill_kernel", "expert_slots"),
             ("models.moe_lm", "experts_segmented_int4"), ("models.moe_lm", "linear"))


def _prefix_prompts(top, page_size, n=8, tail=16):
    """The prefix round's prompts: n that share one page of prompt, each
    with its own tail, and a companion with another prompt."""
    import numpy as np

    rng = np.random.RandomState(5)
    prefix = rng.randint(5, top, page_size).tolist()
    prompts = [prefix + rng.randint(5, top, tail).tolist() for _ in range(n)]
    return prompts, rng.randint(5, top, page_size + tail).tolist()


def _batch_dependence(device, lm, cfg, top, max_seq, page_size, chunk, few, lanes=7):
    """Where a row's result depends on the rows beside it, on the served
    path at full depth. A paged engine runs the first prompt chunk of
    the prefix round's first request in a ``few``-lane chunk (beside its
    companion, or alone), and of ``lanes`` followers that share its first
    page in one chunk, as the engine without the prefix cache does: the
    first row's logits and the int8 page it writes are compared. Then
    every op of the larger chunk's forward, recorded as it ran, runs again
    on the first row's share alone; an op whose result differs from that
    row's part of the recorded one depends on the rows beside it. Printed,
    not held."""
    import importlib

    import torch

    from aria_tpu_torch.engine.server import PagedBatchedEngine

    prompts, companion = _prefix_prompts(top, page_size, n=lanes + 1)
    calls = []

    def run(batch, record=False):
        eng = PagedBatchedEngine({"lm": lm}, cfg, max_lanes=lanes, max_seq_len=max_seq,
                                 page_size=page_size, prefill_chunk=chunk,
                                 cache_dtype=torch.int8, prefix_cache=False, rng_seed=SEED)
        for p in batch:
            eng.submit(p, max_new_tokens=1)
        while eng._admit():
            pass
        saved = []
        if record:
            for mod, name in BATCH_OPS:
                m = importlib.import_module(f"aria_tpu_torch.{mod}")
                fn = getattr(m, name)
                saved.append((m, name, fn))

                def wrapped(*args, _fn=fn, _name=name, **kw):
                    out = _fn(*args, **kw)
                    calls.append((_name, _fn, args, kw, out))
                    return out

                setattr(m, name, wrapped)
        try:
            logits = eng._chunk_logits(list(range(len(batch))))
        finally:
            for m, name, fn in saved:
                setattr(m, name, fn)
        page = int(eng.page_table[0, 0])
        return logits[0].float(), [t[:, page] for t in (eng.cache.k, eng.cache.v)]

    (one, p1), (many, pn) = run([prompts[0], companion][:few]), run(prompts[1:], record=True)
    differ = sum(int((a != b).sum()) for a, b in zip(p1, pn))
    total = sum(a.numel() for a in p1)
    worst = {}
    for name, fn, args, kw, out in calls:
        alone = fn(*_row0(args, lanes, chunk), **{k: _row0(v, lanes, chunk) for k, v in kw.items()})
        worst[name] = max(worst.get(name, 0.0), _max_diff(_row0(out, lanes, chunk), alone))
    ops = ", ".join(f"{name} {d:.3e}" for name, d in worst.items())
    print(f"  batch dependence ({cfg.text.num_layers} layers, a shared prompt's first "
          f"{chunk}-token chunk in {few} lane(s) against in {lanes}): logits max |diff| "
          f"{_max_diff(one, many):.3e}; its int8 page's k/v bytes differ at {differ} of {total}; op by op, the first row's "
          f"share alone against its part of the {lanes}-lane call, max |diff|: {ops}",
          flush=True)


def _serve_prefix(lm, cfg, max_seq, page_size, chunk, first, rest, new, cached, fault=None):
    """Greedy: the requests ``first`` together, then ``rest`` together, on a
    fresh engine (``cached``: with the prefix cache). A planted ``fault``
    corrupts the page that first[0] registered before ``rest`` comes: "page
    left unwritten" zeroes it, "wrong page" points its key at first[1]'s
    page. Returns, for each request in order, (tokens, cached tokens,
    first-token logits), and the pool's hits."""
    import torch

    from aria_tpu_torch.engine.server import PagedBatchedEngine

    eng = PagedBatchedEngine({"lm": lm}, cfg, max_lanes=len(rest) + 1, max_seq_len=max_seq,
                             page_size=page_size, prefill_chunk=chunk, decode_chunk=16,
                             cache_dtype=torch.int8, prefix_cache=cached, rng_seed=SEED)
    first_logits = {}
    chunk_logits = eng._chunk_logits

    def record(lanes):
        logits = chunk_logits(lanes)
        for row, lane in enumerate(lanes):  # the completing chunk's row wins
            first_logits[eng.lane_req[lane].uid] = logits[row].float().cpu()
        return logits

    eng._chunk_logits = record
    uids = [eng.submit(p, max_new_tokens=new) for p in first]
    fin = eng.run_until_complete()
    if fault is not None:
        key = eng._page_keys(first[0])[0]
        page = eng.pool.key_to_page[key]
        if fault == "page left unwritten":
            eng.cache.k[:, page] = 0
            eng.cache.v[:, page] = 0
        else:
            eng.pool.key_to_page[key] = eng.pool.key_to_page[eng._page_keys(first[1])[0]]
    uids += [eng.submit(p, max_new_tokens=new) for p in rest]
    fin += eng.run_until_complete()
    by_uid = {r.uid: r for r in fin}
    if len(by_uid) != len(uids) or any(r.error or len(r.generated) != new for r in fin):
        raise AssertionError(f"prefix round (prefix cache {cached}, fault {fault}): a request "
                             "failed")
    return ([(by_uid[u].generated, by_uid[u].cached_tokens, first_logits[u]) for u in uids],
            eng.pool.hits)


def _prefix_round(lm, cfg, top, max_seq, page_size, chunk, companion, n=8, tail=16, new=32):
    """Greedy requests that share one full page of prompt: the first is
    served (alone, or beside a companion with another prompt) and
    registers the page; the other n - 1, served together, each take it
    from the cache (cached tokens and pool hits held). Their streams and
    first-token logits are compared with an engine without the prefix
    cache serving the same requests in the same order.

    Alone, the first request's one-lane chunks (128 rows) take the MoE's
    W4A8 decode kernel and the uncached engine's (n-1)-lane chunks its
    prefill kernel, so the cached page is not the recomputed one: reported.
    With the companion every chunk takes the prefill kernel, and the two
    pages differ only by the rows beside them in their launches: the
    streams must be equal, or else the first-token logits within
    PREFIX_LOGIT_LIMIT, while two planted faults (the cached page left
    unwritten; its key pointing at the companion's page) must exceed it."""
    prompts, other = _prefix_prompts(top, page_size, n, tail)
    first = [prompts[0]] + ([other] if companion else [])
    faults = ("page left unwritten", "wrong page") if companion else ()
    runs = {fault: _serve_prefix(lm, cfg, max_seq, page_size, chunk, first, prompts[1:], new,
                                 cached=fault != "uncached",
                                 fault=None if fault in ("cached", "uncached") else fault)
            for fault in ("cached", "uncached") + faults}
    (cached, hits), (plain, plain_hits) = runs["cached"], runs["uncached"]
    k0 = len(first)
    if [c for _, c, _ in cached] != [0] * k0 + [page_size] * (n - 1) or hits != n - 1:
        raise AssertionError(f"prefix round: cached tokens {[c for _, c, _ in cached]}, "
                             f"pool hits {hits}")
    if plain_hits != 0 or any(c for _, c, _ in plain):
        raise AssertionError("prefix round: the engine without a prefix cache reused pages")
    same = sum(a[0] == b[0] for a, b in zip(cached, plain))
    firsts = all(a[0][0] == b[0][0] for a, b in zip(cached, plain))
    rel = max(_rel_err(a[2], b[2]) for a, b in zip(cached, plain))
    print(f"  prefix cache ({n} greedy requests, a {page_size}-token shared page + {tail}, {new} "
          f"tokens, chunks of {chunk}, the first request "
          f"{'beside a companion: held' if companion else 'alone: reported'}): cached tokens "
          f"{[c for _, c, _ in cached]}, pool hits {hits}; streams equal to the engine without "
          f"the cache: {same} of {len(cached)}; first-token logits, relative error {rel:.3e} "
          f"(largest); first tokens equal: {firsts}", flush=True)
    if not companion:
        return
    for fault in faults:
        caught = min(_rel_err(a[2], b[2]) for a, b in zip(runs[fault][0][k0:], plain[k0:]))
        print(f"  planted fault, {fault}: first-token logits of the {n - 1} followers at least "
              f"{caught:.3e} from the uncached engine's (limit {PREFIX_LOGIT_LIMIT:.0e})",
              flush=True)
        if not caught > PREFIX_LOGIT_LIMIT:
            raise AssertionError(f"prefix round: the planted fault ({fault}) gives logits within "
                                 f"the limit ({caught})")
    if same < len(cached):
        print(f"  finding: {len(cached) - same} of {len(cached)} cached streams differ from the "
              f"uncached ones; first-token logits held to {PREFIX_LOGIT_LIMIT:.0e} instead",
              flush=True)
        if not rel <= PREFIX_LOGIT_LIMIT:
            raise AssertionError(f"prefix round: first-token logits differ by {rel}")


def _tight_pool(lm, cfg, top, max_seq, page_size, chunk, prompt_len=48):
    """One lane over max_seq positions with the default pool (1 + 2 pages
    at max_seq 512): a request that fills the window. The JAX engine asks
    for a page past the table once the lane stands within a decode chunk of
    S and waits for it forever; the port returns the request whole."""
    import numpy as np
    import torch

    from aria_tpu_torch.engine.server import PagedBatchedEngine

    eng = PagedBatchedEngine({"lm": lm}, cfg, max_lanes=1, max_seq_len=max_seq,
                             page_size=page_size, prefill_chunk=chunk, decode_chunk=50,
                             cache_dtype=torch.int8, rng_seed=SEED)
    new = eng.S - 60  # 452 at S = 512: the request ends within a decode chunk of S
    eng.submit(np.random.RandomState(6).randint(5, top, prompt_len).tolist(), max_new_tokens=new)
    trace, fin = [], []
    for _ in range(20):
        fin += eng.step()
        if fin:
            break
        trace.append((int(eng.lane_pos[0]), len(eng.lane_req[0].generated)))
    if len(fin) != 1 or fin[0].error or len(fin[0].generated) != new:
        raise AssertionError(f"tight pool: {fin} after positions and counts {trace}")
    pos, got = trace[-1]
    print(f"  tight pool ({eng.pool.available + 1} pages, one lane, {prompt_len} + {new} of "
          f"{eng.S} positions): the last tick before the end stood at position {pos} with "
          f"{got} tokens (the JAX engine asks for {-(-(pos + 51) // page_size)} pages of a "
          f"{eng.MAXP}-page table there and stalls); the request returned {len(fin[0].generated)} tokens, "
          f"no error", flush=True)


def _paged_reference(device, lm, text, top, page_size, ref_layers=2):
    """A 2-layer paged prefill chunk of 4 lanes, then one decode step at
    per-lane positions through the page table, int8 pages, on the card
    against the CPU's plain versions, with the bf16 witness beside the
    limit."""
    import numpy as np
    import torch

    from aria_tpu_torch.models.moe_lm import embed_tokens, lm_forward
    from aria_tpu_torch.ops.paged_attention import PagedKVCache

    cut = dataclasses.replace(text, num_layers=ref_layers)
    small = {**lm, "layers": _tree_map(lambda v: v[:ref_layers].contiguous(), lm["layers"])}
    small_cpu = _tree_map(lambda v: v.cpu(), small)
    rng = np.random.RandomState(7)
    lens = [5, 9, 14, 20]
    toks = torch.zeros((4, 32), dtype=torch.long)
    for b, n in enumerate(lens):
        toks[b, :n] = torch.from_numpy(rng.randint(5, top, n))
    new = torch.from_numpy(rng.randint(5, top, 4)).to(torch.int32)
    table = torch.tensor([[5, 2], [1, 8], [7, 3], [4, 6]], dtype=torch.int32)
    cpu = torch.device("cpu")

    def step(params, dev, bump=False):
        emb = embed_tokens(params["embed"], toks.to(dev))
        if bump:
            emb = _bump_half(emb)
        cache = PagedKVCache.init(cut, 9, page_size, torch.int8, device=dev)
        pt = table.to(dev)
        lm_forward(params, cut, inputs_embeds=emb, positions=torch.arange(32, device=dev),
                   cache=cache, cache_pos=torch.zeros(4, dtype=torch.int32, device=dev),
                   page_table=pt)
        pos = torch.tensor(lens, dtype=torch.int32, device=dev)
        return lm_forward(params, cut, new[:, None].long().to(dev), positions=pos[:, None],
                          cache=cache, cache_pos=pos, page_table=pt).logits[:, 0].float().cpu()

    got, ref = step(small, device), step(small_cpu, cpu)
    ulp = step(small_cpu, cpu, bump=True)
    rel, witness = _rel_err(got, ref), _rel_err(ulp, ref)
    print(f"  reference ({ref_layers} layers, int8 pages, a 32-token chunk of 4 lanes then a "
          f"decode step at positions {lens} through shuffled page tables, CPU plain versions): "
          f"relative logit error {rel:.3e} (limit {REF_LIMIT:.0e}), top-1 agreement "
          f"{_top1(got, ref):.3f}; witness, CPU with one bf16 ulp on half the prompt "
          f"embeddings: relative error {witness:.3e}, top-1 agreement {_top1(ulp, ref):.3f}",
          flush=True)
    if not rel <= REF_LIMIT:
        raise AssertionError(f"reference paged logits differ: relative error {rel}")


ADAPTER_SPECS = {  # name: (rank, alpha, targets); the LoRA recipe's rank 8, alpha 32
    "t1": (8, 32.0, None),
    "t2": (16, 32.0, None),
    "att": (8, 32.0, ("wqkv", "wo")),
}
ADAPTER_B_STD = 0.02  # b ~ N(0, 0.02^2): a delta of ~0.1-0.2 of the base projection


def _make_adapters(device, gen, cfg):
    """The adapters phase's three adapters in the training format, bf16, a
    as ``init_lora_params`` draws it and b drawn too (its b = 0 would make
    each adapter a no-op); returns ({name: tree}, {name: alpha / rank})."""
    import torch

    from aria_tpu_torch.train.lora import LoraConfig, init_lora_params

    trees, scales = {}, {}
    for name, (rank, alpha, targets) in ADAPTER_SPECS.items():
        lc = LoraConfig(rank=rank, alpha=alpha, **({"target_modules": targets} if targets else {}))
        tree = init_lora_params(cfg, lc, gen, device=device, dtype=torch.bfloat16)["lm"]
        for ab in tree["layers"].values():
            ab["b"] = (torch.randn(ab["b"].shape, generator=gen, device=device)
                       * ADAPTER_B_STD).to(torch.bfloat16)
        trees[name], scales[name] = tree, lc.scale
    return trees, scales


def _adapter_round(device, engine, wrappers, prompts, names, new_tokens, label, gpu):
    """Greedy requests ``prompts[i]`` under adapter ``names[i]`` on
    ``engine``, the grouped admission timed on its own and the decode steps
    after it; returns (streams, step ms, {kernel: launches per decode
    step})."""
    uids = [engine.submit(p, max_new_tokens=new_tokens, adapter=a)
            for p, a in zip(prompts, names)]
    _sync(device)
    t0 = time.perf_counter()
    engine._admit_all()
    _sync(device)
    t1 = time.perf_counter()
    admitted = {n: w.launches for n, w in wrappers.items()}
    finished, chunks = [], 0
    while engine.queue or engine._active_mask().any():
        finished += engine.step()
        chunks += 1
    t2 = time.perf_counter()
    fin = {r.uid: r for r in finished}
    for uid in uids:
        r = fin[uid]
        if r.error or len(r.generated) != new_tokens:
            raise AssertionError(f"{label} request {uid}: {len(r.generated)} tokens, {r.error}")
        if not all(0 <= t < engine.cfg.text.vocab_size for t in r.generated):
            raise AssertionError(f"{label} request {uid}: token out of range")
    steps = chunks * engine.decode_chunk
    per_step = {n: (w.launches - admitted[n]) / steps for n, w in wrappers.items()}
    total = len(uids) * new_tokens
    step_ms = (t2 - t1) / steps * 1e3
    print(f"  {label}: {total} tokens in {t2 - t0:.3f} s = {total / (t2 - t0):.2f} tok/s "
          f"aggregate; grouped admission {(t1 - t0) * 1e3:.1f} ms wall; decode {steps} steps, "
          f"{step_ms:.2f} ms wall per step; expert_block_dequant "
          f"{per_step['expert_block_dequant']:.0f} launches per step ({gpu})", flush=True)
    return [fin[u].generated for u in uids], step_ms, per_step


def run_adapters(device, gen, lm, cfg=None, gpu="", lanes=32, new_tokens=16, ref_layers=2):
    """The adapters phase: multi-LoRA serving over the int4 model (still
    resident after the paged phase). Three adapters from the seed
    (``ADAPTER_SPECS``) in one ``AdapterRegistry``; ``BatchedEngine(adapters=)``
    with the int4 KV cache serves ``lanes`` greedy 48-token prompts, a
    quarter on the base and a quarter on each adapter (each quarter the
    same prompts), ``new_tokens`` each, twice: the streams repeat, every
    adapter moves some stream, and each decode step launches
    ``expert_block_dequant`` 12 times a layer (6 blocks of 11 experts, w1
    and w2). Then a base-only round on the same engine, token for token the
    plain ``BatchedEngine``'s (the same program), a profiled mixed decode
    chunk (busy share), the peak memory, a 2-layer mixed prefill and decode
    step and one layer's blocked MoE against the CPU, and
    ``PagedBatchedEngine(adapters=)``'s prefix keys salted by adapter.
    Returns each kernel's launch count over the mixed rounds."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from aria_tpu_torch import AriaConfig
    from aria_tpu_torch.engine.multi_lora import AdapterRegistry
    from aria_tpu_torch.engine.server import BatchedEngine
    from aria_tpu_torch.models.moe_lm import lora_block_size

    cfg = cfg or AriaConfig()
    text = cfg.text
    top = min(1000, text.vocab_size)
    t0 = time.perf_counter()
    trees, scales = _make_adapters(device, gen, cfg)
    reg = AdapterRegistry(trees, scales, device=device)
    del trees
    wrappers = _wrappers()
    kw = dict(max_lanes=lanes, max_seq_len=48 + new_tokens, temperature=0.0, decode_chunk=16,
              cache_dtype="int4", rng_seed=SEED)
    engine = BatchedEngine({"lm": lm}, cfg, adapters=reg, **kw)
    E = text.num_experts + text.num_shared_experts
    eb = lora_block_size(E)
    want = 2 * (E // eb) * text.num_layers
    names = [None, *ADAPTER_SPECS]
    quarter = lanes // len(names)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(5, top, 48).tolist() for _ in range(quarter)]
    print(f"adapters: {len(ADAPTER_SPECS)} adapters {dict(ADAPTER_SPECS)} (b ~ N(0, "
          f"{ADAPTER_B_STD}^2)), set up in {time.perf_counter() - t0:.1f} s; {lanes} lanes "
          f"({quarter} each on the base and {', '.join(ADAPTER_SPECS)}), int4 KV over "
          f"{engine.S} positions, {new_tokens} greedy tokens, blocks of {eb} experts", flush=True)
    mixed_names = [n for n in names for _ in range(quarter)]
    mixed_prompts = prompts * len(names)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():  # count only what the mixed rounds launch
        w.launches = 0
    streams = []
    with torch.inference_mode():  # the engine's state is inference tensors
        for rnd in range(2):
            got, mixed_ms, per_step = _adapter_round(
                device, engine, wrappers, mixed_prompts, mixed_names, new_tokens,
                f"mixed round {rnd}{' (warm-up)' if rnd == 0 else ''}", gpu)
            streams.append(got)
            deq = per_step["expert_block_dequant"]
            if device.type == "cuda" and deq != want:
                raise AssertionError(f"expert_block_dequant launched {deq} times per decode "
                                     f"step, not {want}")
    launches = {name: w.launches for name, w in wrappers.items()}
    print(f"  launches: {launches}", flush=True)
    if streams[0] != streams[1]:
        raise AssertionError("the repeated mixed round gave other streams")
    base = streams[0][:quarter]
    for i, name in enumerate(ADAPTER_SPECS, start=1):
        moved = sum(s != b for s, b in zip(streams[0][i * quarter:(i + 1) * quarter], base))
        print(f"  {name}: {moved} of {quarter} streams differ from the base's on the same "
              f"prompts", flush=True)
        if not moved:
            raise AssertionError(f"adapter {name} moved no stream")

    with torch.inference_mode():
        if device.type == "cuda":  # a profiled mixed decode chunk: the busy share
            uids = [engine.submit(p, max_new_tokens=new_tokens, adapter=a)
                    for p, a in zip(mixed_prompts, mixed_names)]
            steps, engine.decode_chunk = 2, 2
            engine.step()  # admission and a first chunk, unprofiled
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                engine.step()
                torch.cuda.synchronize()
            dev_ev = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in dev_ev) / steps / 1e3
            deq = sum(e.self_device_time_total for e in dev_ev
                      if "dequant_int4_kernel" in e.key) / steps / 1e3
            print(f"  profiled mixed decode chunk ({steps} steps x {lanes} lanes): device busy "
                  f"{busy:.3f} ms per step, of it expert_block_dequant {deq:.3f} ms; busy "
                  f"share {busy / mixed_ms:.3f} of the {mixed_ms:.2f} ms step (profiler off); "
                  f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
            print("  device time by kernel, mixed adapters decode:\n" + prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=12), flush=True)
            for uid in uids:
                engine.cancel(uid)
            engine.step()
            engine.decode_chunk = 16
        base_prompts = [rng.randint(5, top, 48).tolist() for _ in range(lanes)]
        counts0 = {n: w.launches for n, w in wrappers.items()}
        got, base_ms, per_step = _adapter_round(device, engine, wrappers, base_prompts,
                                                [None] * lanes, new_tokens,
                                                "base-only round, adapters engine", gpu)
        if wrappers["expert_block_dequant"].launches != counts0["expert_block_dequant"]:
            raise AssertionError("a base-only round launched expert_block_dequant")
        plain = BatchedEngine({"lm": lm}, cfg, **kw)
        want_streams, _, _ = _adapter_round(device, plain, wrappers, base_prompts,
                                            [None] * lanes, new_tokens,
                                            "base-only round, plain engine", gpu)
        if got != want_streams:
            raise AssertionError("the base-only round differs from the plain engine's")
        print(f"  base-only round: {lanes} streams equal the plain engine's; decode step "
              f"{mixed_ms:.2f} ms with adapter lanes, {base_ms:.2f} ms without", flush=True)
        fused = engine.adapters
        del engine, plain
        _adapters_reference(device, lm, text, fused, top, ref_layers)
        del fused
        _adapters_prefix(lm, cfg, reg, top)
    return launches


MOE_ULP_LIMIT = 4e-3  # two bf16 roundings (the block's output, the sum's), relative
ADAPTER_REF_INPUTS = (5,)  # the numpy seed of the 2-layer adapters reference's input
WITNESS_DRAWS = 6


def _adapters_reference(device, lm, text, reg, top, ref_layers=2):
    """A 2-layer grouped prefill of 4 lanes (adapters t1, none, t2, att)
    then one mixed decode step with per-lane positions, int8 KV, on the
    card against the CPU's plain versions, on each input of
    ADAPTER_REF_INPUTS, held to the limit and to its bf16 witness, each
    lane's error beside them. A
    router near-tie makes a lane's error heavy-tailed: whether one draw of
    the witness (one ulp on half the prompt embeddings) trips the tie is
    chance, as it is for the card's roundings. So the witness is the
    largest of ``WITNESS_DRAWS`` draws, run on the CPU as one batch of
    the inputs' copies (a row's expert buffers then hold other rows too,
    which moves only roundings). Then one layer's blocked expert-LoRA MoE
    is held on its own, card against CPU, on the same 64 bf16 tokens and
    routing, to MOE_ULP_LIMIT: without the router and the layers that
    amplify a flip, the path differs only by its roundings."""
    import numpy as np
    import torch

    from aria_tpu_torch.models.moe_lm import (
        KVCache,
        _experts_lora_blocked,
        embed_tokens,
        lm_forward,
    )

    cut = dataclasses.replace(text, num_layers=ref_layers)
    small = {**lm, "layers": _tree_map(lambda v: v[:ref_layers].contiguous(), lm["layers"])}
    lora = _tree_map(lambda v: v[:ref_layers].contiguous(), reg.stacked)
    small_cpu, lora_cpu = (_tree_map(lambda v: v.cpu(), t) for t in (small, lora))
    ids = [1, 0, 2, 3]
    hot = reg.lane_onehot(ids)
    lens = [5, 9, 14, 16]
    inputs = []
    for seed in ADAPTER_REF_INPUTS:
        rng = np.random.RandomState(seed)
        toks = torch.zeros((4, 16), dtype=torch.long)
        for b, n in enumerate(lens):
            toks[b, :n] = torch.from_numpy(rng.randint(5, top, n))
        inputs.append((toks, torch.from_numpy(rng.randint(5, top, 4)).to(torch.int32)))
    cpu = torch.device("cpu")

    def step(params, lora_tree, dev, batch, bump=False):
        """Logits [len(batch), 4, V] of the inputs in ``batch``, 4 lanes each."""
        n = len(batch)
        toks = torch.cat([t for t, _ in batch]).to(dev)
        new = torch.cat([w for _, w in batch]).long().to(dev)
        ml = dict(lora=lora_tree, lora_scale=1.0, lora_onehot=hot.repeat(1, n).to(dev))
        emb = embed_tokens(params["embed"], toks)
        if bump:
            emb = _bump_half(emb)
        cache = KVCache.init(cut, 4 * n, 128, torch.int8, device=dev)
        lm_forward(params, cut, inputs_embeds=emb, positions=torch.arange(16, device=dev),
                   cache=cache, cache_pos=0, logit_position=0, causal_flash=True, **ml)
        pos = torch.tensor(lens * n, dtype=torch.int32, device=dev)
        out = lm_forward(params, cut, new[:, None], positions=pos[:, None], cache=cache,
                         cache_pos=pos, **ml).logits[:, 0].float().cpu()
        return out.reshape(n, 4, -1)

    K = WITNESS_DRAWS
    ulps = step(small_cpu, lora_cpu, cpu, [x for x in inputs for _ in range(K)], bump=True)
    failed = []
    for i, (seed, x) in enumerate(zip(ADAPTER_REF_INPUTS, inputs)):
        (got,), (ref,) = step(small, lora, device, [x]), step(small_cpu, lora_cpu, cpu, [x])
        draws = [_rel_err(u, ref) for u in ulps[i * K:(i + 1) * K]]
        rel, witness = _rel_err(got, ref), max(draws)
        ulp = ulps[i * K + draws.index(witness)]
        by_lane = [[f"{_rel_err(o[j], ref[j]):.3e}" for j in range(4)] for o in (got, ulp)]
        print(f"  reference ({ref_layers} layers, int8 KV, input {seed}: a mixed prefill then "
              f"decode step of 4 lanes on adapters {ids} at positions {lens}, CPU plain "
              f"versions): relative logit error {rel:.3e} (limit {REF_LIMIT:.0e} and the "
              f"witness; by lane {by_lane[0]}), top-1 agreement {_top1(got, ref):.3f}; witness, "
              f"the largest of {K} draws of one bf16 ulp on half the prompt embeddings on the "
              f"CPU: relative error {witness:.3e} (draws "
              f"{[f'{d:.3e}' for d in draws]}; its lanes {by_lane[1]}), top-1 agreement "
              f"{_top1(ulp, ref):.3f}", flush=True)
        if not rel <= min(REF_LIMIT, witness):
            failed.append(f"input {seed}: relative error {rel} (witness {witness})")

    g = torch.Generator().manual_seed(SEED)
    T, E = 64, text.num_experts
    x = (torch.randn(T, text.hidden_size, generator=g) * 0.5).to(torch.bfloat16)
    idx = torch.stack([torch.randperm(E, generator=g)[:text.moe_topk] for _ in range(T)])
    idx = torch.cat([idx, torch.arange(E, E + text.num_shared_experts).expand(T, -1)], 1)
    wts = torch.softmax(torch.randn(T, text.moe_topk, generator=g), -1)
    wts = torch.cat([wts, torch.ones(T, text.num_shared_experts)], 1).to(torch.bfloat16)
    sel = reg.lane_onehot([i % 4 for i in range(T)])
    out = []
    for params, lora_tree, dev in ((small, lora, device), (small_cpu, lora_cpu, cpu)):
        w1, w2 = ({k: v[0] for k, v in params["layers"][n].items()} for n in ("w1", "w2"))
        lw = {n: {f: lora_tree["layers"][n][f][0] for f in "ab"} for n in ("w1", "w2")}
        out.append(_experts_lora_blocked(x.to(dev), idx.to(torch.int32).to(dev), wts.to(dev), w1,
                                         w2, lw, 1.0, sel.to(dev), torch.bfloat16).float().cpu())
    moe_rel = _rel_err(*out)
    print(f"  blocked expert-LoRA MoE, layer 0, {T} tokens on the 4 adapters' rows, card "
          f"against CPU: relative error {moe_rel:.3e} (limit {MOE_ULP_LIMIT:.0e}), "
          f"{(out[0] != out[1]).float().mean().item():.4f} of the entries differ", flush=True)
    if not moe_rel <= MOE_ULP_LIMIT:
        failed.append(f"one layer's blocked expert-LoRA MoE: relative error {moe_rel}")
    if failed:
        raise AssertionError(f"the adapters reference differs: {failed}")


def _adapters_prefix(lm, cfg, reg, top, prompt_len=300, page_size=256, chunk=128, new=8):
    """``PagedBatchedEngine(adapters=)`` at full width, int8 pages: one
    prompt of ``prompt_len`` tokens (one full page) under t1, then under
    the base, then under t1 again, one request at a time. The base takes
    none of t1's pages, the second t1 request takes the full page and gives
    the first's stream."""
    import numpy as np
    import torch

    from aria_tpu_torch.engine.server import PagedBatchedEngine

    eng = PagedBatchedEngine({"lm": lm}, cfg, max_lanes=2, max_seq_len=512,
                             page_size=page_size, prefill_chunk=chunk, temperature=0.0,
                             decode_chunk=16, cache_dtype=torch.int8, adapters=reg)
    prompt = np.random.RandomState(6).randint(5, top, prompt_len).tolist()
    runs = []
    for name in ("t1", None, "t1"):
        uid = eng.submit(prompt, max_new_tokens=new, adapter=name)
        (r,) = eng.run_until_complete()
        if r.uid != uid or r.error or len(r.generated) != new:
            raise AssertionError(f"paged adapters request {uid}: {r.error}")
        runs.append((r.cached_tokens, r.generated))
    cached = [c for c, _ in runs]
    print(f"  paged prefix keys by adapter ({prompt_len}-token prompt, pages of {page_size}): "
          f"cached tokens t1 {cached[0]}, base {cached[1]}, t1 again {cached[2]}; t1's streams "
          f"{'equal' if runs[0][1] == runs[2][1] else 'differ'}, the base's "
          f"{'differs' if runs[1][1] != runs[0][1] else 'equals t1'}", flush=True)
    if cached != [0, 0, page_size * ((prompt_len - 1) // page_size)]:
        raise AssertionError(f"prefix pages across adapters: cached tokens {cached}")
    if runs[2][1] != runs[0][1]:
        raise AssertionError("t1 over its cached page gave another stream")


@contextlib.contextmanager
def variants_on():
    """The JAX package's three kernel variants on (ARIA_TPU_DENSE_A8=1,
    ARIA_TPU_A8=0, ARIA_TPU_VIT_FLASH=0), as the port's module constants,
    restored afterwards, also when the body raises."""
    from aria_tpu_torch.models import moe_lm, vit

    saved = moe_lm.DENSE_A8, moe_lm.MOE_A8, vit.VIT_FLASH
    moe_lm.DENSE_A8, moe_lm.MOE_A8, vit.VIT_FLASH = True, False, False
    try:
        yield
    finally:
        moe_lm.DENSE_A8, moe_lm.MOE_A8, vit.VIT_FLASH = saved


def run_variants(device, gen, lm, cfg=None, gpu="", lanes=32, new_tokens=100,
                 default_image=(float("nan"),) * 2, default_lanes=(float("nan"),) * 2):
    """The variants phase: the int4 model (still resident after the
    adapters phase) with the three kernel variants on. bench.py's image
    request through ``Engine.generate`` (int8 KV; cut to a 50-token warm-up,
    one sampled 200-token request and two greedy 32-token ones): the ViT
    runs ``flash_segment`` 27 times an image, each decode step
    ``dense_int4_a8`` 56 times and ``moe_decode_int4_bf16`` 28 times, and
    neither ``vit_flash`` nor the W4A8 ``moe_decode_int4`` launches. Then
    bench.py's lanes child through ``BatchedEngine`` (32 lanes, int4 KV, a
    warm-up round and a timed one of ``new_tokens``, T = 32 a decode step), a
    profiled decode chunk, the A/B against the default configuration's
    numbers from this call (``default_image``: run_image's (first-token
    ms, tok/s); ``default_lanes``: run_lanes' (tok/s, step ms)), and the
    2-layer reference. Returns the launch counts of the image and the
    lanes paths."""
    import numpy as np
    import torch

    from aria_tpu_torch import AriaConfig
    from aria_tpu_torch.engine.generate import Engine, GenerationConfig
    from aria_tpu_torch.engine.server import BatchedEngine
    from aria_tpu_torch.models.projector import init_projector_params
    from aria_tpu_torch.models.vit import init_vit_params
    from aria_tpu_torch.ops.quant import quantize_projector_params, quantize_vit_params

    cfg = cfg or AriaConfig()
    text, vision = cfg.text, cfg.vision
    L = text.num_layers
    top = min(1000, text.vocab_size)
    params = {
        "lm": lm,
        "vision": quantize_vit_params(init_vit_params(vision, gen, device=device)),
        "projector": quantize_projector_params(init_projector_params(cfg.projector, gen,
                                                                     device=device)),
    }
    side = vision.image_size
    pixels = np.random.RandomState(SEED).randint(0, 256, (1, 3, side, side), dtype=np.uint8)
    n_q = cfg.projector.query_count(vision.patches_per_side**2)
    prompt = [11] * 8 + [cfg.image_token_id] * n_q + [13] * 8
    sampled = dict(temperature=0.8, top_k=200, decode_chunk=50)
    greedy = GenerationConfig(max_new_tokens=32, temperature=0.0, decode_chunk=50)
    requests = [("image, variants, T 0.8 top-k 200 (warm-up)", prompt,
                 GenerationConfig(max_new_tokens=50, **sampled)),
                ("image, variants, T 0.8 top-k 200", prompt,
                 GenerationConfig(max_new_tokens=new_tokens, **sampled)),
                ("image greedy, variants", prompt, greedy),
                ("image greedy again, variants", prompt, greedy)]
    wrappers = _wrappers()
    print(f"variants: DENSE_A8 on, MOE_A8 off, VIT_FLASH off (the JAX package's "
          f"ARIA_TPU_DENSE_A8=1, ARIA_TPU_A8=0, ARIA_TPU_VIT_FLASH=0) on the {L}-layer int4 "
          f"model", flush=True)
    with variants_on():
        engine = Engine(params, cfg, max_seq_len=1024, cache_dtype=torch.int8, rng_seed=SEED)
        results, image = _serve(engine, requests, wrappers, text.vocab_size, gpu,
                                pixel_values=pixels)
        del engine
        if results[2].tokens != results[3].tokens:
            raise AssertionError("the repeated greedy image request gave another stream")
        # the prefill's projections are W4A8 only in a bucket of at most 32
        # rows, and its MoE the decode kernel only up to 128: not at the
        # 512-token bucket of bench.py's request
        n = len(requests)
        bucket = max(32, 1 << (len(prompt) - 1).bit_length())
        pre_a8, pre_dec = int(bucket <= 32), int(bucket <= 128)
        steps, rem = divmod(image["moe_decode_int4_bf16"] - L * n * pre_dec, L)
        want = {"flash_segment": vision.num_layers * n, "vit_flash": 0, "moe_decode_int4": 0,
                "dense_int4": 2 * L * n * (1 - pre_a8), "moe_prefill_int4": L * n * (1 - pre_dec),
                "dense_int4_a8": 2 * L * (steps + n * pre_a8)}
        wrong = {k: (image[k], v) for k, v in want.items() if image[k] != v}
        if wrong or rem or not steps:
            raise AssertionError(f"variants image path launches (got, wanted): {wrong}; "
                                 f"moe_decode_int4_bf16 {image['moe_decode_int4_bf16']}")
        print(f"  {steps} decode steps: dense_int4_a8 {2 * L}, moe_decode_int4_bf16 {L} "
              f"launches a step; flash_segment {vision.num_layers} an image; vit_flash and the "
              f"W4A8 moe_decode_int4 none", flush=True)

        for w in wrappers.values():  # count only what the lanes path launches
            w.launches = 0
        engine = BatchedEngine({"lm": lm}, cfg, max_lanes=lanes, max_seq_len=320,
                               temperature=0.8, top_k=200, decode_chunk=50, cache_dtype="int4",
                               rng_seed=SEED)
        print(f"variants lanes: {lanes} lanes, int4 KV over {engine.S} positions, {new_tokens} "
              f"tokens per request, a warm-up round of {WARMUP_TOKENS} and a timed one",
              flush=True)
        step_ms, tok_s = _lanes_rounds(device, engine, wrappers, lanes, top, new_tokens, 2, gpu)
        lanes_counts = {name: w.launches for name, w in wrappers.items()}
        print(f"  launches: {lanes_counts}", flush=True)
        for name in ("dense_int4_a8", "moe_decode_int4_bf16"):
            if lanes_counts[name] <= 0:
                raise AssertionError(f"{name} was not launched by the variants lanes path")
        for name in ("moe_decode_int4", "vit_flash"):
            if lanes_counts[name]:
                raise AssertionError(f"{name} was launched by the variants lanes path")
        if device.type == "cuda":
            with torch.inference_mode():
                _profile_lanes_chunk(engine, lanes, top, new_tokens, step_ms,
                                     label="variants lanes", moe_kernels=BF16X_MOE_KERNELS)
        del engine
        ttft, rate = results[1].prefill_s * 1e3, results[1].tokens_per_s
        d_img, d_lanes = default_image, default_lanes
        print(f"  A/B in this call ({gpu}), variants against the default: image-to-first-token "
              f"{ttft:.1f} ms (default {d_img[0]:.1f}), decode {rate:.2f} tok/s (default "
              f"{d_img[1]:.2f}); {lanes} lanes {tok_s:.2f} tok/s at {step_ms:.2f} ms a step "
              f"(default {d_lanes[0]:.2f} tok/s at {d_lanes[1]:.2f} ms)", flush=True)
        with torch.inference_mode():
            _variants_reference(device, lm, text, top)
    return {"variants-image": image, "variants-lanes": lanes_counts}


A8_PROJ_LIMIT = 1e-6  # relative: exact integer dots, then the same f32 steps on both sides


def _variants_reference(device, lm, text, top, ref_layers=2):
    """With the variants on: a 2-layer prefill of 4 lanes x 16 tokens (64
    rows: the bf16 projections and the bf16-activation MoE kernel) and one
    decode step with per-lane positions (4 rows: the W4A8 projections and
    the bf16-activation MoE), int8 KV, on the card against the CPU's plain
    versions, each beside its bf16 witness, the largest of
    ``WITNESS_DRAWS`` draws of one ulp on half the prompt embeddings, run
    on the CPU as one batch of copies (its prefill then takes the
    segmented MoE, the same exact products). The prefill is held to
    REF_LIMIT and to its witness. The decode step is reported beside its
    witness and not held: its W4A8 projections turn a bf16-level
    difference upstream into a flipped int8 rounding, so even the witness's
    draws exceed REF_LIMIT. What holds the decode step's kernels is the
    check after it: layer 0's W4A8 wqkv and wo and its bf16-activation MoE,
    card against CPU on the same bf16 rows and routing, at 4 and 32 rows,
    held to their rounding: A8_PROJ_LIMIT for the projections,
    MOE_ULP_LIMIT for the MoE."""
    import numpy as np
    import torch

    from aria_tpu_torch.models.moe_lm import KVCache, _project, embed_tokens, lm_forward
    from aria_tpu_torch.ops.moe_decode_kernel import moe_decode_int4

    cut = dataclasses.replace(text, num_layers=ref_layers)
    small = {**lm, "layers": _tree_map(lambda v: v[:ref_layers].contiguous(), lm["layers"])}
    small_cpu = _tree_map(lambda v: v.cpu(), small)
    rng = np.random.RandomState(8)
    lens = [5, 9, 14, 16]
    toks = torch.zeros((4, 16), dtype=torch.long)
    for b, n in enumerate(lens):
        toks[b, :n] = torch.from_numpy(rng.randint(5, top, n))
    new = torch.from_numpy(rng.randint(5, top, 4))
    cpu = torch.device("cpu")

    def step(params, dev, copies=1, bump=False):
        """(prefill logits, decode logits), each [copies, 4, V]."""
        emb = embed_tokens(params["embed"], toks.repeat(copies, 1).to(dev))
        if bump:
            emb = _bump_half(emb)
        B = 4 * copies
        cache = KVCache.init(cut, B, 128, torch.int8, device=dev)
        pos = torch.tensor(lens * copies, dtype=torch.int32, device=dev)
        pre = lm_forward(params, cut, inputs_embeds=emb, positions=torch.arange(16, device=dev),
                         cache=cache, cache_pos=0, logit_position=pos - 1,
                         causal_flash=True).logits[:, 0]
        dec = lm_forward(params, cut, new.repeat(copies)[:, None].to(dev),
                         positions=pos[:, None], cache=cache, cache_pos=pos).logits[:, 0]
        return tuple(t.float().cpu().reshape(copies, 4, -1) for t in (pre, dec))

    K = WITNESS_DRAWS
    got, ref, ulps = step(small, device), step(small_cpu, cpu), step(small_cpu, cpu, K, True)
    failed = []
    for i, (label, held) in enumerate((("prefill (last prompt positions)", True),
                                       ("decode step", False))):
        draws = [_rel_err(u, ref[i][0]) for u in ulps[i]]
        rel, witness = _rel_err(got[i][0], ref[i][0]), max(draws)
        print(f"  reference, variants ({ref_layers} layers, int8 KV, 4 lanes at {lens}): "
              f"{label} relative logit error {rel:.3e} "
              f"({f'limit {REF_LIMIT:.0e} and the witness' if held else 'not held'}; "
              f"by lane {[f'{_rel_err(got[i][0][j], ref[i][0][j]):.3e}' for j in range(4)]}), "
              f"top-1 agreement {_top1(got[i][0], ref[i][0]):.3f}; witness, the largest of {K} "
              f"draws of one bf16 ulp on half the prompt embeddings on the CPU: {witness:.3e} "
              f"(draws {[f'{d:.3e}' for d in draws]})", flush=True)
        if held and not rel <= min(REF_LIMIT, witness):
            failed.append(f"{label}: relative error {rel} (witness {witness})")

    g = torch.Generator().manual_seed(SEED)
    E = text.num_experts
    experts = [tuple(p["layers"][n][leaf] for n, leaf in (("w1", "q4"), ("w1", "sg"),
                                                           ("w2", "q4"), ("w2", "s8")))
               for p in (small, small_cpu)]
    for T in (4, 32):
        x = torch.randn(T, text.hidden_size, generator=g).to(torch.bfloat16)
        for name in ("wqkv", "wo"):
            out = [_project(x.to(dev), p["layers"][name], 0).cpu()
                   for p, dev in ((small, device), (small_cpu, cpu))]
            rel = _rel_err(*out)
            print(f"  W4A8 {name}, layer 0, {T} rows, card against CPU: relative error "
                  f"{rel:.3e} (limit {A8_PROJ_LIMIT:.0e}), "
                  f"{(out[0] != out[1]).float().mean().item():.4f} of the entries differ",
                  flush=True)
            if not rel <= A8_PROJ_LIMIT:
                failed.append(f"W4A8 {name} at {T} rows: relative error {rel}")
        idx = torch.stack([torch.randperm(E, generator=g)[:text.moe_topk] for _ in range(T)])
        idx = torch.cat([idx, torch.arange(E, E + text.num_shared_experts).expand(T, -1)], 1)
        wts = torch.softmax(torch.randn(T, text.moe_topk, generator=g), -1)
        wts = torch.cat([wts, torch.ones(T, text.num_shared_experts)], 1).to(torch.bfloat16)
        out = [moe_decode_int4(x.to(dev), idx.to(torch.int32).to(dev), wts.to(dev), *ex, 0,
                               act_int8=False).float().cpu()
               for ex, dev in zip(experts, (device, cpu))]
        rel = _rel_err(*out)
        print(f"  bf16-activation int4 MoE, layer 0, {T} rows, card against CPU: relative "
              f"error {rel:.3e} (limit {MOE_ULP_LIMIT:.0e}), "
              f"{(out[0] != out[1]).float().mean().item():.4f} of the entries differ",
              flush=True)
        if not rel <= MOE_ULP_LIMIT:
            failed.append(f"bf16-activation MoE at {T} rows: relative error {rel}")
    if failed:
        raise AssertionError(f"the variants reference differs: {failed}")


# Phase 6e, the serving features. The speculative request (bench.py has
# none; the JAX engine's defaults): greedy, k = 7 drafted tokens, 2-gram
# lookup, 8 verify steps a read-back, 128 tokens on a prompt of one seeded
# 12-token phrase said 8 times.
SPEC_K, SPEC_NGRAM, SPEC_STEPS, SPEC_TOKENS = 7, 2, 8, 128
# a finite language, so every guided stream ends in the stop token
GUIDED_REGEX = "(yes|no|maybe), [0-9]{1,3}\\."
LOGPROBS_K = 5
LOGPROBS_REF_TOKENS = 3  # each lane's greedy tokens in the 2-layer logprobs check
GUIDED_TOKENS = 40  # the JSON-mode requests' budget (the front door's, phase 6f)


def _guided_text(tokens, eos: int) -> tuple[bytes, bool]:
    """The bytes of a guided stream (a byte-level FSM allows byte tokens
    only before the stop token) and whether it ended."""
    ended = bool(tokens) and tokens[-1] == eos
    body = tokens[:-1] if ended else tokens
    if any(not 0 <= t < 256 for t in body):
        raise AssertionError(f"guided stream holds a non-byte token: {body}")
    return bytes(body), ended


def _hold_regex(label, tokens, eos, dfa) -> None:
    text, ended = _guided_text(tokens, eos)
    if not (ended and dfa.matches(text)):
        raise AssertionError(f"{label}: {text!r} (ended {ended}) is not in {GUIDED_REGEX!r}")


def _hold_json(label, tokens, eos, dfa) -> bool:
    """An ended JSON-mode stream is a JSON object; one cut by its budget a
    live prefix of the grammar's DFA. Returns whether it ended."""
    text, ended = _guided_text(tokens, eos)
    if ended:
        # a JSON string may hold any byte from 0x20 up: not always UTF-8
        if not isinstance(json.loads(text.decode("utf-8", errors="replace")), dict):
            raise AssertionError(f"{label}: {text!r} is not a JSON object")
    elif dfa.simulate(text) < 0:
        raise AssertionError(f"{label}: {text!r} left the JSON grammar")
    return ended


def _small(lm, text, layers=2):
    """The first ``layers`` layers of ``lm``, on its device and on the CPU."""
    cut = dataclasses.replace(text, num_layers=layers)
    small = {**lm, "layers": _tree_map(lambda v: v[:layers].contiguous(), lm["layers"])}
    return cut, small, _tree_map(lambda v: v.cpu(), small)


def _spec_round(device, engine, prompt, wrappers, gpu):
    """Plain greedy and speculative greedy on ``engine`` (warmed up), then one
    verify forward and one decode forward under the profiler. Returns the
    speculative stream."""
    import torch

    from aria_tpu_torch.engine.generate import GenerationConfig
    from aria_tpu_torch.engine.speculative import SpeculativeConfig
    from aria_tpu_torch.models.moe_lm import KVCache, lm_forward

    plain_cfg = GenerationConfig(max_new_tokens=SPEC_TOKENS, temperature=0.0, decode_chunk=32)
    spec_cfg = dataclasses.replace(plain_cfg, speculative=SpeculativeConfig(
        k=SPEC_K, ngram=SPEC_NGRAM, steps_per_chunk=SPEC_STEPS))
    for g in (plain_cfg, spec_cfg):  # warm-up
        engine.generate(prompt, dataclasses.replace(g, max_new_tokens=16))
    with _no_chain(device, "the speculative requests"):
        plain = engine.generate(prompt, plain_cfg)
        before = {n: w.launches for n, w in wrappers.items()}
        spec = engine.generate(prompt, spec_cfg)
        spec_launches = {n: w.launches - before[n] for n, w in wrappers.items()}
    lead = next((i for i, (a, b) in enumerate(zip(spec.tokens, plain.tokens)) if a != b),
                min(len(spec.tokens), len(plain.tokens)))
    mean = sum(spec.produced_per_step) / len(spec.produced_per_step)
    print(f"  speculative greedy (k {SPEC_K}, {SPEC_NGRAM}-gram, {SPEC_STEPS} steps a "
          f"read-back), int8 KV, {len(prompt)}-token repetitive prompt, {SPEC_TOKENS} tokens: "
          f"{spec.verify_steps} verify steps, {mean:.3f} tokens produced a step (max "
          f"{max(spec.produced_per_step)}), {spec.tokens_per_s:.2f} tok/s, "
          f"{spec.decode_s / spec.verify_steps * 1e3:.2f} ms wall a verify step; plain greedy "
          f"{plain.tokens_per_s:.2f} tok/s, {plain.decode_s / plain.steps * 1e3:.2f} ms wall a "
          f"decode step ({gpu})", flush=True)
    print(f"  speculative against plain greedy: the first {lead} of {len(plain.tokens)} tokens "
          "equal (reported, not held: the verify step's plain attention over 8 rows is not "
          "bit-equal to the decode kernel over one)", flush=True)
    print(f"  the speculative request's launches: "
          f"{ {n: c for n, c in spec_launches.items() if c} }", flush=True)
    if len(spec.tokens) != SPEC_TOKENS or sum(spec.produced_per_step) != spec.steps:
        raise AssertionError(f"speculative: {len(spec.tokens)} tokens, produced "
                             f"{sum(spec.produced_per_step)} of {spec.steps}")
    if device.type == "cuda":  # the counts move on the card only
        for name in ("dense_int4", "moe_decode_int4", "rope_kv_write", "flash_causal"):
            if spec_launches[name] <= 0:
                raise AssertionError(f"the speculative request launched no {name}")
        # one verify forward against one decode forward
        text = engine.cfg.text
        n = len(prompt)
        cache = KVCache.init(text, 1, engine.max_seq_len, torch.int8, device=device)
        toks = torch.tensor([prompt], device=device)
        lm = engine.params["lm"]
        lm_forward(lm, text, toks, positions=torch.arange(n, device=device), cache=cache,
                   cache_pos=0, causal_flash=True)
        fed = torch.tensor([spec.tokens[:SPEC_K + 1]], device=device)
        pos = torch.full((1,), n, dtype=torch.int32, device=device)
        steps = torch.arange(SPEC_K + 1, dtype=torch.int32, device=device)[None, :]

        def verify():
            lm_forward(lm, text, fed, positions=pos[:, None] + steps, cache=cache, cache_pos=pos)

        def decode():
            lm_forward(lm, text, fed[:, :1], positions=pos, cache=cache, cache_pos=pos)

        rows = {}
        for label, fn in (("verify step (T = 8)", verify), ("decode step (T = 1)", decode)):
            fn()
            rows[label] = _launches_ms(fn)
        for label, (n_launch, dev_ms, wall) in rows.items():
            print(f"  one {label} forward, {text.num_layers} layers: {n_launch} kernel "
                  f"launches, device busy {dev_ms:.3f} ms, wall {wall:.2f} ms (profiler on; "
                  f"{gpu})", flush=True)
    return spec


def _serving_guided(device, engine, lm, cfg, gpu, lanes, paged_lanes, new_tokens):
    """Guided decoding through ``Engine``, a 32-lane ``BatchedEngine`` with
    half of its lanes guided (the others held equal to a plain engine's
    greedy streams) and ``PagedBatchedEngine`` with a few guided lanes."""
    import numpy as np
    import torch

    from aria_tpu_torch.data.tokenizer import ByteTokenizer
    from aria_tpu_torch.engine.generate import GenerationConfig
    from aria_tpu_torch.engine.guided import compile_regex, regex_fsm
    from aria_tpu_torch.engine.server import BatchedEngine, PagedBatchedEngine

    text = cfg.text
    tok = ByteTokenizer()
    eos = tok.eos_token_id
    t0 = time.perf_counter()
    regex = regex_fsm(GUIDED_REGEX, tok, [eos], vocab_size=text.vocab_size, device=device)
    rdfa = compile_regex(GUIDED_REGEX)
    print(f"  guided table over ByteTokenizer padded to {text.vocab_size} ids: regex "
          f"{GUIDED_REGEX!r} {regex.num_states} states, {regex.nbytes} bytes on the card, "
          f"built in {time.perf_counter() - t0:.2f} s (host; JSON mode is the front door's, "
          "phase 6f)", flush=True)
    rng = np.random.RandomState(SEED + 61)
    top = min(1000, text.vocab_size)
    prompt = rng.randint(5, top, 40).tolist()
    greedy = GenerationConfig(max_new_tokens=24, temperature=0.0, stop_token_ids=(eos,),
                              decode_chunk=8)
    with _no_chain(device, "the guided requests"):
        r = engine.generate(prompt, dataclasses.replace(greedy, guided=regex))
        _hold_regex("Engine, regex, greedy", r.tokens, eos, rdfa)
        free = engine.generate(prompt, dataclasses.replace(greedy, stop_token_ids=()))
    print(f"  Engine, regex greedy: {_guided_text(r.tokens, eos)[0]!r}", flush=True)
    print(f"  decode step, wall: guided (regex) {r.decode_s / max(r.steps, 1) * 1e3:.2f} ms "
          f"over {r.steps} steps against unguided {free.decode_s / free.steps * 1e3:.2f} ms over "
          f"{free.steps} ({gpu})", flush=True)

    kw = dict(max_lanes=lanes, max_seq_len=320, decode_chunk=16, cache_dtype=torch.int8,
              rng_seed=SEED)
    prompts = [rng.randint(5, top, 48).tolist() for _ in range(lanes)]
    guided_eng = BatchedEngine({"lm": lm}, cfg, guided_fsm=regex, **kw)
    plain_eng = BatchedEngine({"lm": lm}, cfg, **kw)
    streams = []
    with _no_chain(device, "the guided lanes"):
        for eng, guide in ((guided_eng, True), (plain_eng, False)):
            uids = [eng.submit(p, max_new_tokens=new_tokens, guided=guide and i % 2 == 1,
                               stop_token_ids=(eos,) if guide and i % 2 else ())
                    for i, p in enumerate(prompts)]
            t0 = time.perf_counter()
            fin = {r.uid: r for r in eng.run_until_complete()}
            wall = time.perf_counter() - t0
            if any(r.error for r in fin.values()):
                raise AssertionError("a guided lanes request failed")
            streams.append([fin[u].generated for u in uids])
            print(f"  BatchedEngine, {lanes} lanes, int8 KV, greedy, "
                  f"{'half guided' if guide else 'none guided'}: "
                  f"{sum(map(len, streams[-1]))} tokens in {wall:.2f} s ({gpu})", flush=True)
    for i, (g, p) in enumerate(zip(*streams)):
        if i % 2:
            _hold_regex(f"BatchedEngine lane {i}", g, eos, rdfa)
        elif g != p:
            raise AssertionError(f"unguided lane {i} beside guided lanes differs from the plain "
                                 f"engine's greedy stream: {g} against {p}")
    print(f"  the {lanes // 2} guided lanes match {GUIDED_REGEX!r} and end in the stop token; "
          f"the {lanes - lanes // 2} unguided lanes equal the plain BatchedEngine's greedy "
          "streams token for token", flush=True)

    paged = PagedBatchedEngine({"lm": lm}, cfg, max_lanes=paged_lanes, max_seq_len=512,
                               page_size=256, prefill_chunk=128, decode_chunk=16,
                               cache_dtype=torch.int8, guided_fsm=regex)
    pp = [rng.randint(5, top, n).tolist() for n in (48, 200, 130, 60)][:paged_lanes]
    with _no_chain(device, "the guided paged lanes"):
        uids = [paged.submit(p, max_new_tokens=new_tokens, guided=i % 2 == 0,
                             stop_token_ids=(eos,) if i % 2 == 0 else ())
                for i, p in enumerate(pp)]
        fin = {r.uid: r for r in paged.run_until_complete()}
    for i, u in enumerate(uids):
        if fin[u].error:
            raise AssertionError(f"paged guided request {i}: {fin[u].error}")
        if i % 2 == 0:
            _hold_regex(f"PagedBatchedEngine lane {i}", fin[u].generated, eos, rdfa)
        elif len(fin[u].generated) != new_tokens:
            raise AssertionError(f"paged unguided request {i}: {len(fin[u].generated)} tokens")
    print(f"  PagedBatchedEngine, {paged_lanes} lanes on int8 pages, "
          f"{(paged_lanes + 1) // 2} guided: every guided stream matches and ends", flush=True)


def _serving_references(device, lm, cfg, spec_tokens, prompt):
    """The 2-layer checks, each held to REF_LIMIT with its bf16 witness
    beside it: one verify step's [k+1, V] logits on the card against k+1
    decode steps' on the card fed the same tokens; the logprobs of a
    ``BatchedEngine(logprobs_topk=)`` on the card against the CPU's for
    the same tokens; a repetition-penalized first token's logits on the
    card against the CPU's."""
    import numpy as np
    import torch

    from aria_tpu_torch.engine.generate import Engine, GenerationConfig
    from aria_tpu_torch.engine.sampling import apply_penalties
    from aria_tpu_torch.engine.server import BatchedEngine
    from aria_tpu_torch.models.moe_lm import KVCache, embed_tokens, lm_forward

    cut, small, small_cpu = _small(lm, cfg.text)
    cut_cfg = dataclasses.replace(cfg, text=cut)
    n = len(prompt)

    # one verify step against k + 1 decode steps, same fed tokens
    fed = torch.tensor([spec_tokens[:SPEC_K + 1]], device=device)
    caches = []
    for _ in range(3):
        c = KVCache.init(cut, 1, 256, torch.int8, device=device)
        lm_forward(small, cut, torch.tensor([prompt], device=device),
                   positions=torch.arange(n, device=device), cache=c, cache_pos=0,
                   causal_flash=True)
        caches.append(c)
    pos = torch.full((1,), n, dtype=torch.int32, device=device)
    verify = lm_forward(small, cut, fed, positions=pos[:, None] + torch.arange(
        SPEC_K + 1, device=device), cache=caches[0], cache_pos=pos).logits[0].float()

    def steps(cache, bump):
        out = []
        for i in range(SPEC_K + 1):
            emb = embed_tokens(small["embed"], fed[:, i:i + 1], dtype=small["final_norm"].dtype)
            if bump:  # _bump_half draws its half on the CPU
                emb = _bump_half(emb.cpu()).to(device)
            out.append(lm_forward(small, cut, inputs_embeds=emb, positions=pos + i, cache=cache,
                                  cache_pos=n + i).logits[0, 0])
        return torch.stack(out).float()

    ref, ulp = steps(caches[1], False), steps(caches[2], True)
    rel, witness = _rel_err(verify, ref), _rel_err(ulp, ref)
    print(f"  verify step (2 layers, int8 KV, {SPEC_K + 1} tokens after {n}) against "
          f"{SPEC_K + 1} decode steps on the card: relative logit error {rel:.3e} (limit "
          f"{REF_LIMIT:.0e}), top-1 agreement {_top1(verify, ref):.3f}; witness, the decode steps "
          f"with one bf16 ulp on half the embeddings: {witness:.3e}", flush=True)
    if not rel <= REF_LIMIT:
        raise AssertionError(f"the verify step's logits differ from the decode steps': {rel}")

    # logprobs on the card against the CPU's, the same tokens
    rng = np.random.RandomState(SEED + 63)
    top = min(1000, cut.vocab_size)
    prompts = [rng.randint(5, top, 48).tolist() for _ in range(4)]
    eng = BatchedEngine({"lm": small}, cut_cfg, max_lanes=4, max_seq_len=128, decode_chunk=8,
                        cache_dtype=torch.int8, logprobs_topk=LOGPROBS_K)
    uids = [eng.submit(p, max_new_tokens=LOGPROBS_REF_TOKENS) for p in prompts]
    fin = {r.uid: r for r in eng.run_until_complete()}
    gen_toks = torch.tensor([fin[u].generated for u in uids])  # [4, LOGPROBS_REF_TOKENS]
    got = torch.tensor([fin[u].logprobs for u in uids])
    # the CPU follows the engine's steps: a bucket-64 prefill into an int8
    # cache, then decode steps fed the card's tokens
    cpu = torch.device("cpu")
    toks = torch.zeros((4, 64), dtype=torch.long)
    toks[:, :48] = torch.tensor(prompts)
    want, ulps = [], []
    for bump, sink in ((False, want), (True, ulps)):
        c = KVCache.init(cut, 4, 128, torch.int8, device=cpu)
        emb = embed_tokens(small_cpu["embed"], toks, dtype=small_cpu["final_norm"].dtype)
        logits = lm_forward(small_cpu, cut, inputs_embeds=_bump_half(emb) if bump else emb,
                            positions=torch.arange(64), cache=c, cache_pos=0, logit_position=47,
                            causal_flash=True).logits[:, 0]
        for i in range(LOGPROBS_REF_TOKENS):
            if i:
                logits = lm_forward(small_cpu, cut, gen_toks[:, i - 1:i],
                                    positions=torch.full((1,), 47 + i), cache=c,
                                    cache_pos=47 + i).logits[:, 0]
            sink.append(torch.log_softmax(logits.float(), -1).gather(
                -1, gen_toks[:, i:i + 1])[:, 0])
    want, ulps = torch.stack(want, 1), torch.stack(ulps, 1)
    rel, witness = _rel_err(got, want), _rel_err(ulps, want)
    print(f"  logprobs (2 layers, int8 KV, 4 lanes x {LOGPROBS_REF_TOKENS} greedy tokens) on the "
          f"card against the "
          f"CPU's for the same tokens: relative error {rel:.3e} (limit {REF_LIMIT:.0e}), max "
          f"|difference| {(got - want).abs().max().item():.3e}; witness, one bf16 ulp on half "
          f"the embeddings: {witness:.3e}", flush=True)
    if not rel <= REF_LIMIT:
        raise AssertionError(f"the card's logprobs differ from the CPU's: {rel}")

    # a repetition-penalized first token: the logits on the card and the CPU
    p = prompts[0]
    kw = dict(presence_penalty=0.0, frequency_penalty=0.0, repetition_penalty=1.3)
    first = Engine({"lm": small}, cut_cfg, max_seq_len=128, cache_dtype=torch.int8).generate(
        p, GenerationConfig(max_new_tokens=1, temperature=0.0, **kw)).tokens[0]
    outs = []
    for params, dev, bump in ((small, device, False), (small_cpu, torch.device("cpu"), False),
                              (small_cpu, torch.device("cpu"), True)):
        toks = torch.tensor([p], device=dev)
        emb = embed_tokens(params["embed"], toks, dtype=params["final_norm"].dtype)
        logits = lm_forward(params, cut, inputs_embeds=_bump_half(emb) if bump else emb,
                            logit_position=len(p) - 1).logits[:, 0].float()
        pmask = torch.zeros_like(logits, dtype=torch.bool)
        pmask[0, toks[0]] = True
        one = torch.ones(1, device=dev)
        outs.append(apply_penalties(logits, torch.zeros_like(logits, dtype=torch.int32), pmask,
                                    0.0 * one, 0.0 * one, 1.3 * one).cpu())
    rel, witness = _rel_err(outs[0], outs[1]), _rel_err(outs[2], outs[1])
    print(f"  repetition penalty 1.3 (2 layers): the penalized first-token logits on the card "
          f"against the CPU's: relative error {rel:.3e} (limit {REF_LIMIT:.0e}); witness "
          f"{witness:.3e}; the engine's first token {first} is the card's argmax "
          f"{int(outs[0].argmax())}", flush=True)
    if not rel <= REF_LIMIT or first != int(outs[0].argmax()):
        raise AssertionError(f"penalized first token: relative error {rel}, token {first}")


def run_serving(device, lm, cfg=None, gpu="", lanes=32, paged_lanes=4, new_tokens=32):
    """Phase 6e: the serving features on the resident full-width int4 model.
    Speculative greedy through ``Engine`` (int8 KV) beside plain greedy on
    the same repetitive prompt, one verify forward's launches and device
    time beside a decode forward's; guided decoding (a regex over
    ``ByteTokenizer``, padded to the model's ids) through ``Engine``, a
    32-lane ``BatchedEngine`` with half of its lanes guided and
    ``PagedBatchedEngine`` (JSON mode and engine logprobs are phase 6f's
    HTTP requests); a repetition-penalized ``Engine`` request. Then the
    2-layer checks
    (``_serving_references``). Returns each kernel's launch count over the
    served requests."""
    import numpy as np
    import torch

    from aria_tpu_torch import AriaConfig
    from aria_tpu_torch.engine.generate import Engine, GenerationConfig

    cfg = cfg or AriaConfig()
    text = cfg.text
    wrappers = _wrappers()
    for w in wrappers.values():  # count only what the served requests launch
        w.launches = 0
    rng = np.random.RandomState(SEED + 60)
    prompt = rng.randint(5, min(1000, text.vocab_size), 12).tolist() * 8
    engine = Engine({"lm": lm}, cfg, max_seq_len=1024, cache_dtype=torch.int8, rng_seed=SEED)
    print(f"serving features: speculative, guided, logprobs and penalties on the "
          f"{text.num_layers}-layer int4 model", flush=True)
    with torch.inference_mode():
        spec = _spec_round(device, engine, prompt, wrappers, gpu)
        _serving_guided(device, engine, lm, cfg, gpu, lanes, paged_lanes, new_tokens)
        with _no_chain(device, "the penalized request"):
            pen = engine.generate(prompt[:40], GenerationConfig(
                max_new_tokens=24, temperature=0.0, repetition_penalty=1.3, decode_chunk=12))
        plain = engine.generate(prompt[:40], GenerationConfig(max_new_tokens=24, temperature=0.0,
                                                              decode_chunk=12))
        print(f"  Engine, repetition penalty 1.3, greedy: {len(pen.tokens)} tokens, "
              f"{len(set(pen.tokens))} distinct (plain greedy: {len(set(plain.tokens))}), "
              f"{pen.tokens_per_s:.2f} tok/s ({gpu})", flush=True)
        launches = {name: w.launches for name, w in wrappers.items()}
        print(f"  launches: {launches}", flush=True)
        for name in SERVING_PATH:
            if launches[name] <= 0:
                raise AssertionError(f"{name} was not launched by the serving-features path")
        _serving_references(device, lm, cfg, spec.tokens, prompt)
    return launches


# The 2-layer bf16-cache CP engine against one card, relative L2 of the
# first-token and 8 decode steps' logits, held with the bf16-activation MoE
# (MOE_A8 off): the CP prefill's f32 attention and the flash kernel's bf16
# probabilities differ by bf16 rounding, which the W4A8 MoE's int8
# re-quantization turns into flips (its reading is printed beside the held
# one). The limit is the reference's own: tools/cp_witness.py reads the JAX
# package's CP engine against its one-device engine at this configuration
# (4 seeds, the CPU) at 2.241e-2 to 3.992e-2; 5e-2 is 1.25x the largest.
# Rank 1's partials left out read 0.628, and must read 10x the limit.
CP_REF_LIMIT = 5e-2
CP_FAULT_FACTOR = 10
CP_SIZES = {
    "prompt": 6000,  # tokens (bucket 8,192): both blocks hold prompt positions
    "max_seq": 8256,  # -> 8,704 positions, a block of 4,352 per rank
    "new": 64,
    # the 2-layer reference: blocks of 768, both holding prompt positions
    "ref_prompt": 900, "ref_seq": 1536, "ref_steps": 8,
    "lanes": 8, "lane_prompt": 48, "lane_new": 32,  # BatchedEngine over model 2
}


def _cp_logits(lm, text, prompt, cache, mesh, steps=0, feed=None, witness=False):
    """The prefill's logits at the prompt's last position, then ``steps``
    decode steps fed ``feed`` (else their own greedy tokens): ([1 + steps,
    V] f32 logits, the tokens fed). ``witness``: one bf16 ulp on half the
    prompt's embeddings (``_bump_half``)."""
    import torch

    from aria_tpu_torch.engine.generate import _bucket
    from aria_tpu_torch.models.moe_lm import embed_tokens, lm_forward

    dev = cache.k.device
    n, bucket = len(prompt), _bucket(len(prompt))
    tokens = torch.zeros((1, bucket), dtype=torch.long, device=dev)
    tokens[0, :n] = torch.tensor(prompt, device=dev)
    embeds = embed_tokens(lm["embed"], tokens, dtype=lm["final_norm"].dtype)
    if witness:
        embeds = _bump_half(embeds.cpu()).to(dev)
    out = [lm_forward(lm, text, inputs_embeds=embeds, positions=torch.arange(bucket, device=dev),
                      cache=cache, cache_pos=0, logit_position=n - 1, causal_flash=True,
                      mesh=mesh).logits[0, 0].float()]
    fed = []
    for i in range(steps):
        tok = int(out[-1].argmax()) if feed is None else feed[i]
        fed.append(tok)
        out.append(lm_forward(lm, text, torch.tensor([[tok]], device=dev),
                              positions=torch.full((1,), n + i, device=dev), cache=cache,
                              cache_pos=n + i, mesh=mesh).logits[0, -1].float())
    return torch.stack(out), fed


@contextlib.contextmanager
def moe_a8_off():
    """The bf16-activation decode MoE (the JAX package's ARIA_TPU_A8=0),
    restored afterwards."""
    from aria_tpu_torch.models import moe_lm

    saved, moe_lm.MOE_A8 = moe_lm.MOE_A8, False
    try:
        yield
    finally:
        moe_lm.MOE_A8 = saved


def _cp_rank(rank: int, seed: int, device_type: str = "cuda", cfg=None,
             sizes: dict = CP_SIZES) -> dict:
    """One rank of the cp phase, on cuda:0 beside the other (gloo). Returns
    its readings and the launch counts of the CP engine's request and the
    model-2 lanes. On the
    CPU (``device_type``, with a small ``cfg`` and ``sizes``: a rehearsal)
    the wrappers run their plain versions and count no launch."""
    import numpy as np
    import torch

    from aria_tpu_torch import AriaConfig
    from aria_tpu_torch.engine.generate import Engine, GenerationConfig
    from aria_tpu_torch.engine.server import BatchedEngine
    from aria_tpu_torch.models.moe_lm import KVCache, init_lm_params_serving_int4
    from aria_tpu_torch.parallel import cp_cache
    from aria_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    on_card = device_type == "cuda"
    device = torch.device(device_type, 0 if on_card else None)
    if on_card:
        torch.cuda.set_device(device)
    cfg = cfg or AriaConfig()
    text = cfg.text
    z = sizes
    say = lambda msg: print(f"  [rank {rank}] {msg}", flush=True)  # noqa: E731
    t0 = time.perf_counter()
    lm = init_lm_params_serving_int4(text, torch.Generator(device=device).manual_seed(seed),
                                     device=device)
    _sync(device)
    say(f"int4 serving form ({text.num_layers} layers) initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    mesh = make_mesh(MeshConfig(context=2))
    rng = np.random.RandomState(seed)
    prompt = [int(t) for t in rng.randint(1, text.vocab_size, z["prompt"])]
    greedy = GenerationConfig(max_new_tokens=z["new"], temperature=0.0, decode_chunk=z["new"])
    out: dict = {}

    with torch.inference_mode():
        # the CP engine: int8 KV, this rank's 4,352 positions
        engine = Engine({"lm": lm}, cfg, max_seq_len=z["max_seq"], cache_dtype=torch.int8,
                        rng_seed=SEED, mesh=mesh)
        wrappers = _wrappers()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():  # count only the CP request
            w.launches = 0
        res = engine.generate(prompt, greedy)
        out["launches"] = {name: w.launches for name, w in wrappers.items()}
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
        out.update(tokens=res.tokens, prefill_s=res.prefill_s, tok_s=res.tokens_per_s)
        steps = len(res.tokens) - 1
        say(f"Engine(mesh=context 2, int8 KV, {engine.max_seq_len} positions): {z['prompt']}-token "
            f"prompt, {len(res.tokens)} greedy tokens; prefill {res.prefill_s:.3f} s, decode "
            f"{res.tokens_per_s:.2f} tok/s, peak {out['peak_gib']:.2f} GiB; launches "
            f"{ {k: v for k, v in out['launches'].items() if v} }")
        want = text.num_layers * steps if on_card else 0
        if out["launches"]["decode_attention_stats"] != want:
            raise AssertionError(f"decode_attention_stats launched "
                                 f"{out['launches']['decode_attention_stats']} times, not {want}")
        if out["launches"]["decode_attention"] or out["launches"]["decode_attention_int4"]:
            raise AssertionError("the normal decode kernel launched in CP decode")
        if out["launches"]["rope_kv_write"]:
            raise AssertionError("the fused prologue launched on a serving mesh, whose writers "
                                 "keep the chain")
        if len(res.tokens) != z["new"] or not all(0 <= t < text.vocab_size for t in res.tokens):
            raise AssertionError("the CP engine's tokens")

        # reported: the CP engine against one card's on the same weights and
        # prompt (the CP prefill reads the int8 cache, one card's fresh k/v)
        cache = KVCache.init(text, 1, engine.max_seq_len, torch.int8, device=device, mesh=mesh)
        cp_first = _cp_logits(lm, text, prompt, cache, mesh)[0][0]
        del cache
        if not torch.isfinite(cp_first).all():
            raise AssertionError("non-finite CP prefill logits")
        if int(cp_first.argmax()) != res.tokens[0]:
            raise AssertionError("the CP prefill's argmax is not the first token")
        if rank == 0:
            single = Engine({"lm": lm}, cfg, max_seq_len=z["max_seq"], cache_dtype=torch.int8,
                            rng_seed=SEED).generate(prompt, greedy)
            shared = next((i for i, (a, b) in enumerate(zip(res.tokens, single.tokens))
                           if a != b), len(res.tokens))
            firsts = []
            for witness in (False, True):
                cache = KVCache.init(text, 1, engine.max_seq_len, torch.int8, device=device)
                firsts.append(_cp_logits(lm, text, prompt, cache, None, witness=witness)[0][0])
                del cache
            out.update(shared=shared, first_rel=_rel_err(cp_first, firsts[0]),
                       first_witness=_rel_err(firsts[1], firsts[0]),
                       single_prefill_s=single.prefill_s, single_tok_s=single.tokens_per_s)
            say(f"one card's Engine on the same weights and prompt: prefill "
                f"{single.prefill_s:.3f} s, {single.tokens_per_s:.2f} tok/s; shared prefix "
                f"{shared} of {z['new']} tokens; first-token logits relative L2 "
                f"{out['first_rel']:.3e} (reported: CP reads the int8 cache it wrote); witness, "
                f"one card with one bf16 ulp on half the embeddings: {out['first_witness']:.3e}")

        # held: 2 layers of the same weights with a bf16 cache, the CP
        # engine's prefill and 8 decode steps against one card's
        cut = dataclasses.replace(text, num_layers=2)
        small = {**lm, "layers": _tree_map(lambda v: v[:2], lm["layers"])}
        ref_prompt = [int(t) for t in rng.randint(1, text.vocab_size, z["ref_prompt"])]

        def two_layers(m, feed=None):
            cache = KVCache.init(cut, 1, z["ref_seq"], torch.bfloat16, device=device, mesh=m)
            return _cp_logits(small, cut, ref_prompt, cache, m, z["ref_steps"], feed)

        def against_one_card(dtype=torch.bfloat16, fault=False):
            cache = KVCache.init(cut, 1, z["ref_seq"], dtype, device=device)
            one, fed = _cp_logits(small, cut, ref_prompt, cache, None, z["ref_steps"])
            cache = KVCache.init(cut, 1, z["ref_seq"], dtype, device=device, mesh=mesh)
            real = cp_cache._sum_partials

            def without_rank1(buf, m):  # the planted fault: rank 1's partials left out
                return real(torch.zeros_like(buf) if m.coords["context"] == 1 else buf, m)

            cp_cache._sum_partials = without_rank1 if fault else real
            try:
                cp, _ = _cp_logits(small, cut, ref_prompt, cache, mesh, z["ref_steps"], fed)
            finally:
                cp_cache._sum_partials = real
            return _rel_err(cp, one)

        w4a8, int8_read = against_one_card(), against_one_card(torch.int8)
        with moe_a8_off():
            rel, rel_fault = against_one_card(), against_one_card(fault=True)
        out.update(ref_rel=rel, ref_fault=rel_fault, ref_w4a8=w4a8, ref_int8=int8_read)
        say(f"2 layers, bf16 cache of {z['ref_seq']}, {z['ref_prompt']}-token prompt and "
            f"{z['ref_steps']} decode steps, bf16-activation MoE: CP against one card relative "
            f"L2 {rel:.3e} (limit {CP_REF_LIMIT:.0e}); rank 1's partials left out: "
            f"{rel_fault:.3e} (at least {CP_FAULT_FACTOR}x the limit). Reported: with the default W4A8 MoE {w4a8:.3e}; an int8 cache "
            f"(CP reads it, one card attends fresh k/v) {int8_read:.3e}")
        if not rel <= CP_REF_LIMIT:
            raise AssertionError(f"CP 2-layer logits differ from one card's: {rel}")
        if not rel_fault >= CP_FAULT_FACTOR * CP_REF_LIMIT:
            raise AssertionError(f"the merge without rank 1 reads {rel_fault}, under "
                                 f"{CP_FAULT_FACTOR}x the CP limit")

        # held: BatchedEngine over model 2, token for token against one card's
        tp = make_mesh(MeshConfig(model=2))
        prompts = [[int(t) for t in rng.randint(1, text.vocab_size, z["lane_prompt"])]
                   for _ in range(z["lanes"])]

        def serve(m):
            srv = BatchedEngine({"lm": lm}, cfg, max_lanes=z["lanes"], max_seq_len=128,
                                decode_chunk=16, cache_dtype=torch.int8, rng_seed=SEED, mesh=m)
            uids = [srv.submit(p, max_new_tokens=z["lane_new"]) for p in prompts]
            t = time.perf_counter()
            fin = {r.uid: r for r in srv.run_until_complete()}
            return [fin[u].generated for u in uids], time.perf_counter() - t

        for w in wrappers.values():  # count the model-2 lanes too: their decode writes
            w.launches = 0
        streams, secs = serve(tp)
        tp_launches = {name: w.launches for name, w in wrappers.items()}
        if on_card and (tp_launches["kv_cache_write"] <= 0 or tp_launches["rope_kv_write"]):
            raise AssertionError("BatchedEngine(mesh=model 2) did not write its decode steps "
                                 "through kv_cache_write alone")
        out["launches"] = {name: n + tp_launches[name] for name, n in out["launches"].items()}
        out["lanes_s"] = secs
        say(f"BatchedEngine(mesh=model 2, int8 KV): {z['lanes']} lanes x {z['lane_new']} greedy "
            f"tokens in {secs:.2f} s")
        if rank == 0:
            single, secs1 = serve(None)
            same = sum(a == b for a, b in zip(streams, single))
            say(f"one card's BatchedEngine: {secs1:.2f} s; {same} of {z['lanes']} streams equal")
            if streams != single:
                raise AssertionError("BatchedEngine(mesh=model 2) differs from one card's")
        out["lane_streams"] = streams
    return out


def run_cp(gpu="", device_type="cuda", cfg=None, sizes=CP_SIZES):
    """The cp phase: context-parallel serving, 2 ranks sharing cuda:0 over
    gloo (NCCL refuses two ranks on one device), each with the full-width,
    full-depth int4 model drawn from the phase's seed. ``Engine(mesh=
    context 2)`` serves a 6,000-token prompt with 64 greedy tokens from an
    int8 cache of 8,704 positions, 4,352 a rank; ``decode_attention_stats``
    must launch 28 times a decode step on each rank and the normal decode
    kernel never. Reported: prefill s, tok/s, peak memory, the prefix
    shared with one card's engine and the first-token logits' relative
    error (the CP prefill attends the int8 cache it wrote). Held: the
    2-layer bf16-cache CP engine within ``CP_REF_LIMIT`` of one card's
    (prefill and 8 decode steps), with rank 1's partials left out above
    it; ``BatchedEngine(mesh=model 2)`` token for token equal to one
    card's. Both ranks must return the same tokens. Returns rank 0's
    launch counts of the CP request and the model-2 lanes, whose decode
    steps write the cache through ``kv_cache_write`` (a serving mesh's
    writers keep the chain; the fused prologue must not launch)."""
    from aria_tpu_torch.parallel.distributed import run_ranks

    outs = run_ranks(_cp_rank, 2, SEED + 12, device_type, cfg, sizes, backend="gloo",
                     timeout_s=600)
    if outs[0]["tokens"] != outs[1]["tokens"] or outs[0]["lane_streams"] != outs[1][
            "lane_streams"]:
        raise AssertionError("the ranks returned different tokens")
    print(f"  cp ({gpu}): prefill {outs[0]['prefill_s']:.3f} / {outs[1]['prefill_s']:.3f} s, "
          f"decode {outs[0]['tok_s']:.2f} / {outs[1]['tok_s']:.2f} tok/s, peak "
          f"{outs[0]['peak_gib']:.2f} / {outs[1]['peak_gib']:.2f} GiB (rank 0 / 1); one card "
          f"prefill {outs[0]['single_prefill_s']:.3f} s, {outs[0]['single_tok_s']:.2f} tok/s; "
          f"shared prefix {outs[0]['shared']} of {sizes['new']}; first-token relative L2 "
          f"{outs[0]['first_rel']:.3e} (witness {outs[0]['first_witness']:.3e}); 2-layer {outs[0]['ref_rel']:.3e} (fault "
          f"{outs[0]['ref_fault']:.3e}; W4A8 {outs[0]['ref_w4a8']:.3e}; int8 cache "
          f"{outs[0]['ref_int8']:.3e})", flush=True)
    return outs[0]["launches"]


# ------------------------------------------------------------ expert parallelism

# EP_SIZES: the ep-serve phase. Prompts "short" (bucket 64: the decode-MoE
# kernel branch, up to 8 x 32 tokens) and "long" (bucket 512: the sliced
# branch, each rank's 16 experts dequantized a layer and through gmm).
EP_SIZES = {"short": 64, "long": 300, "new": 32, "max_seq": 1024,
            "ref_prompt": 64, "ref_new": 16, "lanes": 8, "lane_prompt": 48, "lane_new": 32}
# The 2-layer EP prefill's last-position logits against one card's, relative
# L2. EP rounds each expert slot's output to bf16 for the return exchange
# where one card keeps the weighted slot sum in f32 (tests/test_mesh_kernels.py
# holds the JAX package's to 0.15 absolute at its tiny config); the bf16
# witness (one ulp on half the embeddings) is printed beside.
EP_REF_LIMIT = 5e-2


def _ep_moe_launches(text, tokens: int, n: int) -> int:
    """moe_decode_int4's launches of one forward over ``tokens`` tokens on
    an expert mesh of n: each layer's padded [n, C] receive buffer (C = T/n
    x k rows from each rank) in launches of at most 128 rows; 0 past the
    kernel branch's 8 x 32 tokens."""
    from aria_tpu_torch.ops.moe_decode_kernel import DECODE_KERNEL_MAX_TOKENS

    t_pad = -(-tokens // n) * n
    if t_pad > 8 * 32:
        return 0
    rows = t_pad * text.moe_topk
    return text.num_layers * -(-rows // DECODE_KERNEL_MAX_TOKENS)


def _ep_request(engine, prompt, new, wrappers, text, n):
    """One greedy request through an EP engine: the result, the launches,
    the collectives' log (those that started after the prefill are the
    decode steps') and the largest token buffer of the prefill, in bytes."""
    from aria_tpu_torch.engine.generate import GenerationConfig, _bucket
    from aria_tpu_torch.parallel import distributed as dd

    for w in wrappers.values():
        w.launches = 0
    dd.LOG = []
    t0 = time.perf_counter()
    res = engine.generate(prompt, GenerationConfig(max_new_tokens=new, temperature=0.0,
                                                   decode_chunk=new))
    log, dd.LOG = dd.LOG, None
    decode_log = [e for e in log if e[3] >= t0 + res.prefill_s]
    launches = {name: w.launches for name, w in wrappers.items()}
    t_pad = -(-_bucket(len(prompt)) // n) * n
    token_bytes = t_pad * text.moe_topk * text.hidden_size * 2  # the [n, C] buffers, bf16
    return res, launches, (log, decode_log), token_bytes


def _ep_rank(rank: int, seed: int, device_type: str = "cuda", cfg=None,
             sizes: dict = EP_SIZES) -> dict:
    """One rank of the ep-serve phase, on cuda:0 beside three others (gloo).
    Returns its readings and the launches of its two requests. On the CPU
    (``device_type``, a small ``cfg`` and ``sizes``: a rehearsal) the
    wrappers run their plain versions and count no launch."""
    import numpy as np
    import torch

    from aria_tpu_torch import AriaConfig
    from aria_tpu_torch.engine.generate import Engine, GenerationConfig
    from aria_tpu_torch.engine.server import BatchedEngine
    from aria_tpu_torch.models.moe_lm import KVCache, init_lm_params_serving_int4
    from aria_tpu_torch.parallel.mesh import MeshConfig, make_mesh, serving_shard

    on_card = device_type == "cuda"
    device = torch.device(device_type, 0 if on_card else None)
    if on_card:
        torch.cuda.set_device(device)
    cfg = cfg or AriaConfig()
    text, z, n = cfg.text, sizes, 4
    say = lambda msg: print(f"  [rank {rank}] {msg}", flush=True)  # noqa: E731
    mesh = make_mesh(MeshConfig(expert=n))
    mesh2 = make_mesh(MeshConfig(data=2, expert=2))  # two expert groups of 2
    mesh_em = make_mesh(MeshConfig(expert=2, model=2))
    t0 = time.perf_counter()
    lm = init_lm_params_serving_int4(text, torch.Generator(device=device).manual_seed(seed),
                                     fuse_shared=False, mesh=mesh, device=device)
    _sync(device)
    stack = sum(t.numel() * t.element_size() for w in ("w1", "w2")
                for t in lm["layers"][w].values())
    rest = sum(t.numel() * t.element_size() for k, v in lm.items() if k != "layers"
               for t in (v.values() if isinstance(v, dict) else [v]))
    rest += sum(t.numel() * t.element_size() for k, v in lm["layers"].items()
                if k not in ("w1", "w2") for t in (v.values() if isinstance(v, dict) else [v]))
    say(f"int4 serving form ({text.num_layers} layers, shared experts unfused), this rank's "
        f"{lm['layers']['w1']['q4'].shape[1]} of {text.num_experts} experts, initialised in "
        f"{time.perf_counter() - t0:.1f} s: experts {stack / 2**30:.2f} GiB, the rest "
        f"{rest / 2**30:.2f} GiB")
    rng = np.random.RandomState(seed)
    out: dict = {"launches": {}, "streams": {}}
    with torch.inference_mode():
        engine = Engine({"lm": lm}, cfg, max_seq_len=z["max_seq"], cache_dtype=torch.int8,
                        rng_seed=SEED, mesh=mesh)
        wrappers = _wrappers()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        layer_stack = stack // text.num_layers // 2  # one layer's w1 or w2, about
        for label in ("short", "long"):
            prompt = [int(t) for t in rng.randint(1, text.vocab_size, z[label])]
            res, launches, (log, decode_log), token_bytes = _ep_request(
                engine, prompt, z["new"], wrappers, text, n)
            steps = len(res.tokens) - 1
            want = _ep_moe_launches(text, _bucket_of(prompt), n)
            want += steps * _ep_moe_launches(text, 1, n)
            got = launches["moe_decode_int4"]
            if on_card and got != want:
                raise AssertionError(f"ep-serve {label}: moe_decode_int4 launched {got} times, "
                                     f"not {want} ({text.num_layers} a decode step)")
            if on_card and label == "long" and not (launches["expert_block_dequant"]
                                                    and launches["gmm"]):
                raise AssertionError("ep-serve long: the sliced branch did not dequantize "
                                     "through expert_block_dequant and gmm")
            biggest = max(b for _, b, _, _ in log)
            if biggest > token_bytes:
                raise AssertionError(f"ep-serve {label}: a collective moved {biggest} bytes, "
                                     f"above the token buffers' {token_bytes}")
            coll_s = sum(s for _, _, s, _ in decode_log)
            share = coll_s / res.decode_s if res.decode_s > 0 else float("nan")
            if len(res.tokens) != z["new"] or not all(0 <= t < text.vocab_size
                                                      for t in res.tokens):
                raise AssertionError(f"ep-serve {label}: the tokens")
            out["launches"][label] = launches
            out["streams"][label] = res.tokens
            out[label] = {"prefill_s": res.prefill_s, "tok_s": res.tokens_per_s,
                          "share": share, "biggest": biggest, "calls": len(log)}
            say(f"Engine(mesh=expert {n}, int8 KV) {label} {z[label]}-token prompt: prefill "
                f"{res.prefill_s:.3f} s, {len(res.tokens)} greedy tokens at "
                f"{res.tokens_per_s:.2f} tok/s; moe_decode_int4 {got} launches ({want} "
                f"expected: {text.num_layers} a decode step), expert_block_dequant "
                f"{launches['expert_block_dequant']}, gmm {launches['gmm']}; {len(log)} "
                f"collectives, the largest {biggest} bytes (token buffers up to {token_bytes}, "
                f"a layer's w1 shard {layer_stack}); collectives {share:.3f} of the decode "
                f"steps' wall")
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
        say(f"device peak over the requests {out['peak_gib']:.2f} GiB")
        del engine, lm
        if on_card:
            torch.cuda.empty_cache()

        # held at 2 layers, a whole 2-layer model drawn from the next seed on
        # every rank (each mesh keeps its experts of it)
        cut = dataclasses.replace(text, num_layers=2)
        small = init_lm_params_serving_int4(
            cut, torch.Generator(device=device).manual_seed(seed + 1), fuse_shared=False,
            device=device)
        small_cfg = cfg.replace(text=cut)
        ref_prompt = [int(t) for t in rng.randint(1, text.vocab_size, z["ref_prompt"])]
        greedy = GenerationConfig(max_new_tokens=z["ref_new"], temperature=0.0,
                                  decode_chunk=z["ref_new"])
        with moe_a8_off():  # as tests/test_mesh_kernels.py:149-171 (ARIA_TPU_A8=0)
            t4 = Engine({"lm": small}, small_cfg, max_seq_len=256, cache_dtype=torch.int8,
                        mesh=mesh).generate(ref_prompt, greedy).tokens
            t2 = Engine({"lm": small}, small_cfg, max_seq_len=256, cache_dtype=torch.int8,
                        mesh=mesh2).generate(ref_prompt, greedy).tokens
        if t4 != t2:
            raise AssertionError(f"ep-serve: expert 4 and expert 2 gave other tokens: {t4} "
                                 f"{t2}")
        out["invariant"] = t4

        def first_logits(m, params, witness=False):
            cache = KVCache.init(cut, 1, 256, torch.int8, device=device, mesh=m)
            return _cp_logits(params, cut, ref_prompt, cache, m, witness=witness)[0][0]

        ep_first = first_logits(mesh, serving_shard({"lm": small}, text.num_experts, mesh)["lm"])
        if rank == 0:
            one = first_logits(None, small)
            witness = first_logits(None, small, witness=True)
            rel, wit = _rel_err(ep_first, one), _rel_err(witness, one)
            out.update(ref_rel=rel, ref_witness=wit)
            say(f"2 layers: the EP prefill's last-position logits against one card's relative "
                f"L2 {rel:.3e} (limit {EP_REF_LIMIT:.0e}; one card with one bf16 ulp on half "
                f"the embeddings {wit:.3e})")
            if not rel <= EP_REF_LIMIT:
                raise AssertionError(f"ep-serve: the EP prefill's logits differ from one "
                                     f"card's: {rel}")

        prompts = [[int(t) for t in rng.randint(1, text.vocab_size, z["lane_prompt"])]
                   for _ in range(z["lanes"])]

        def serve(m):
            srv = BatchedEngine({"lm": small}, small_cfg, max_lanes=z["lanes"], max_seq_len=128,
                                decode_chunk=16, cache_dtype=torch.int8, rng_seed=SEED, mesh=m)
            uids = [srv.submit(p, max_new_tokens=z["lane_new"]) for p in prompts]
            fin = {r.uid: r for r in srv.run_until_complete()}
            return [fin[u].generated for u in uids]

        out["lanes"] = serve(mesh_em)
        if rank == 0:
            single = serve(None)
            lead = [next((i for i, (a, b) in enumerate(zip(s, o)) if a != b), len(o))
                    for s, o in zip(out["lanes"], single)]
            out["lead"] = lead
            say(f"BatchedEngine(mesh=expert 2 x model 2, int8 KV), {z['lanes']} lanes x "
                f"{z['lane_new']} greedy tokens against one card's: leading tokens that agree "
                f"{lead} ({sum(x == z['lane_new'] for x in lead)} streams equal)")
    return out


def _bucket_of(prompt) -> int:
    from aria_tpu_torch.engine.generate import _bucket

    return _bucket(len(prompt))


def run_ep_serve(gpu="", device_type="cuda", cfg=None, sizes=EP_SIZES):
    """The ep-serve phase: expert-parallel serving, 4 ranks sharing cuda:0
    over gloo, each with its 16 of the 64 experts of the full-width,
    full-depth int4 serving form (the shared experts unfused) drawn from the
    phase's seed, the rest replicated. ``Engine(mesh=expert 4)`` with int8
    KV answers a 64-token prompt (the decode-MoE kernel over each rank's
    whole stack) and a 300-token one (bucket 512: the layer's 16 experts
    dequantized, through gmm) with 32 greedy tokens each; ``moe_decode_int4``
    launches 28 times a decode step on each rank and no collective carries
    more than the token buffers. Held at 2 layers: expert 4 and expert 2
    (data 2 x expert 2) give equal greedy tokens, and the EP prefill's
    last-position logits stay within ``EP_REF_LIMIT`` of one card's;
    ``BatchedEngine(mesh=expert 2 x model 2)``'s 8 streams are printed
    against one card's (leading tokens that agree). Every rank must return
    the same tokens. Returns rank 0's launches of the two requests."""
    from aria_tpu_torch.parallel.distributed import run_ranks

    outs = run_ranks(_ep_rank, 4, SEED + 15, device_type, cfg, sizes, backend="gloo",
                     timeout_s=900)
    for key in ("streams", "invariant", "lanes"):
        if any(o[key] != outs[0][key] for o in outs[1:]):
            raise AssertionError(f"ep-serve: the ranks returned different {key}")
    for label in ("short", "long"):
        prefill = " / ".join(f"{o[label]['prefill_s']:.3f}" for o in outs)
        rate = " / ".join(f"{o[label]['tok_s']:.2f}" for o in outs)
        share = " / ".join(f"{o[label]['share']:.3f}" for o in outs)
        print(f"  ep-serve {label} ({gpu}): prefill {prefill} s, decode {rate} tok/s, "
              f"collectives {share} of the decode steps' wall (ranks 0-3)", flush=True)
    peaks = " / ".join(f"{o['peak_gib']:.2f}" for o in outs)
    print(f"  ep-serve peaks {peaks} GiB; 2-layer logits {outs[0]['ref_rel']:.3e} (witness "
          f"{outs[0]['ref_witness']:.3e}); expert 2 x model 2 lanes' leading agreement "
          f"{outs[0]['lead']}", flush=True)
    launches = dict(outs[0]["launches"]["short"])
    for name, count in outs[0]["launches"]["long"].items():
        launches[name] += count
    return launches


def _check_form_path(path, launches, form, image=True):
    """A forms path went through its form's kernels and left the int4 ones."""
    want = (FORM_DECODE[form], "gmm", "flash_causal")
    want += ("rope_kv_write",) + (("decode_attention", "vit_flash") if image else ())
    for name in want:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the {path} path")
    for name in INT4_ONLY:
        if launches[name]:
            raise AssertionError(f"{name} was launched by the {path} path")


def _form_reference(lm, text, prompt, device, ref_layers=2):
    """The first ``ref_layers`` decoder layers on the card against the CPU's
    plain versions: a prefill of the prompt (over 128 tokens: the ragged
    path) into a bf16 cache, then one decode step, each with the witness
    beside the limit."""
    import torch

    from aria_tpu_torch.models.moe_lm import KVCache, embed_tokens, lm_forward

    cut = dataclasses.replace(text, num_layers=ref_layers)
    small = {**lm, "layers": _tree_map(lambda v: v[:ref_layers].contiguous(), lm["layers"])}
    small_cpu = _tree_map(lambda v: v.cpu(), small)
    S = len(prompt)
    toks = torch.tensor([prompt])
    new = torch.tensor([[prompt[0]]])
    cpu = torch.device("cpu")

    def run(params, dev, bump=False):
        emb = embed_tokens(params["embed"], toks.to(dev))
        if bump:
            emb = _bump_half(emb)
        cache = KVCache.init(cut, 1, S + 64, torch.bfloat16, device=dev)
        pre = lm_forward(params, cut, inputs_embeds=emb, positions=torch.arange(S, device=dev),
                         cache=cache, cache_pos=0, causal_flash=True).logits
        dec = lm_forward(params, cut, new.to(dev), positions=torch.full((1,), S, device=dev),
                         cache=cache, cache_pos=S).logits
        return pre.float().cpu(), dec.float().cpu()

    got, ref, ulp = run(small, device), run(small_cpu, cpu), run(small_cpu, cpu, bump=True)
    for i, label in enumerate((f"prefill of {S} tokens", "then a decode step")):
        rel, witness = _rel_err(got[i], ref[i]), _rel_err(ulp[i], ref[i])
        limit = max(REF_LIMIT, FORM_WITNESS_TIMES * witness)
        print(f"  reference ({ref_layers} layers, bf16 KV, {label}, CPU plain versions): "
              f"relative logit error {rel:.3e} (limit {limit:.3e}: the larger of "
              f"{REF_LIMIT:.0e} and {FORM_WITNESS_TIMES} x the witness), top-1 agreement "
              f"{_top1(got[i], ref[i]):.3f}; witness, CPU with one bf16 ulp on half the prompt "
              f"embeddings: relative error {witness:.3e}, top-1 agreement "
              f"{_top1(ulp[i], ref[i]):.3f}", flush=True)
        if not rel <= limit:
            raise AssertionError(f"reference logits ({label}) differ: relative error {rel} "
                                 f"(limit {limit})")


# The forms' 2-layer references are held to the larger of REF_LIMIT and this
# multiple of their own witness: in the bf16 form some weights carry one
# bf16 ulp on half the embeddings to 9.27e-2 after a decode step, above
# REF_LIMIT, and the card's roundings differ from the CPU's in every
# operation of the two layers, not in the embeddings alone. A wrong scale,
# layout or mask is an O(1) error, far above both.
FORM_WITNESS_TIMES = 3


def run_forms(device, gen, cfg=None, gpu="", lanes=32, lanes_new=64, lanes_rounds=2):
    """Phase 7: the int8 and bf16 serving forms at full width, at the
    depth of ``cfg``, as bench.py builds them without ``--int4``
    (bench.py:410-425), random
    weights from the phase's generator: ``init_lm_params_serving`` draws the
    fused expert stacks in slabs, and the ViT and projector stay bf16.

    int8: ``Engine(max_seq_len=1024)`` with a bf16 KV cache serves
    bench.py's image request sampled (T 0.8, top-k 200: a warm-up of
    WARMUP_TOKENS, then 100 tokens) and twice greedy (64 tokens); ``BatchedEngine`` serves bench.py's lanes
    child (``--lanes 32 --experts 64``: 32 prompts of 48 tokens, bf16 KV,
    max_seq_len 512, here 64 new tokens, a warm-up round and a timed one);
    then a 2-layer card-against-CPU reference. bf16, after the int8 model
    is freed: the image request once sampled and twice greedy, and the
    same reference (each held to the larger of ``REF_LIMIT`` and
    ``FORM_WITNESS_TIMES`` times its own witness). Each path must go through its form's kernels and none
    of the int4 ones. Returns {path: launches}."""
    import numpy as np
    import torch

    from aria_tpu_torch import AriaConfig
    from aria_tpu_torch.engine.generate import Engine, GenerationConfig
    from aria_tpu_torch.engine.server import BatchedEngine
    from aria_tpu_torch.models.moe_lm import init_lm_params_serving
    from aria_tpu_torch.models.projector import init_projector_params
    from aria_tpu_torch.models.vit import init_vit_params

    cfg = cfg or AriaConfig()
    text, vision = cfg.text, cfg.vision
    top = min(1000, text.vocab_size)
    side = vision.image_size
    pixels = np.random.RandomState(SEED).randint(0, 256, (1, 3, side, side), dtype=np.uint8)
    n_q = cfg.projector.query_count(vision.patches_per_side**2)
    prompt = [11] * 8 + [cfg.image_token_id] * n_q + [13] * 8
    sampled = GenerationConfig(max_new_tokens=100, temperature=0.8, top_k=200, decode_chunk=50)
    greedy = GenerationConfig(max_new_tokens=64, temperature=0.0, decode_chunk=50)
    rng = np.random.RandomState(SEED + 2)
    ref_prompt = [int(t) for t in rng.randint(1, text.vocab_size, 200)]
    launches = {}
    for form in ("int8", "bf16"):
        t0 = time.perf_counter()
        params = {"lm": init_lm_params_serving(text, gen, form=form, device=device),
                  "vision": init_vit_params(vision, gen, device=device),
                  "projector": init_projector_params(cfg.projector, gen, device=device)}
        _sync(device)
        gib = torch.cuda.memory_allocated() / 2**30 if device.type == "cuda" else float("nan")
        print(f"forms, {form}: decoder {text.num_layers} layers, {text.num_experts}+"
              f"{text.num_shared_experts} experts in the {form} serving form, bf16 "
              f"{vision.num_layers}-layer ViT and projector, initialised in "
              f"{time.perf_counter() - t0:.1f} s ({gib:.2f} GiB on the card)", flush=True)
        engine = Engine(params, cfg, max_seq_len=1024, cache_dtype=torch.bfloat16, rng_seed=SEED)
        n_sampled = 2 if form == "int8" else 1
        warm = dataclasses.replace(sampled, max_new_tokens=WARMUP_TOKENS)
        requests = [(f"image, T 0.8 top-k 200 ({i + 1} of {n_sampled}"
                     f"{', warm-up' if i < n_sampled - 1 else ''})", prompt,
                     warm if i < n_sampled - 1 else sampled) for i in range(n_sampled)]
        requests += [("image greedy", prompt, greedy), ("image greedy again", prompt, greedy)]
        results, counts = _serve(engine, requests, _wrappers(), text.vocab_size, gpu,
                                 pixel_values=pixels)
        if results[-1].tokens != results[-2].tokens:
            raise AssertionError(f"the repeated greedy image request ({form}) gave another stream")
        _check_form_path(f"image-{form}", counts, form)
        launches[f"image-{form}"] = counts
        r = results[n_sampled - 1]
        print(f"  image request ({form} form, bench.py's): image-to-first-token "
              f"{r.prefill_s * 1e3:.1f} ms, decode {r.tokens_per_s:.2f} tok/s ({gpu})", flush=True)
        with torch.inference_mode():
            _image_prefill(device, params, cfg, engine, torch.as_tensor(pixels, device=device),
                           prompt, results[-2].tokens[0], gpu)
        del engine
        if form == "int8":
            wrappers = _wrappers()
            for w in wrappers.values():  # count only what the lanes path launches
                w.launches = 0
            lanes_engine = BatchedEngine({"lm": params["lm"]}, cfg, max_lanes=lanes,
                                         max_seq_len=512, temperature=0.8, top_k=200,
                                         decode_chunk=50, cache_dtype=torch.bfloat16,
                                         rng_seed=SEED)
            print(f"lanes ({form} form): {lanes} lanes, bf16 KV over {lanes_engine.S} positions, "
                  f"{lanes_new} tokens per request, {lanes_rounds} rounds (the first warms up)",
                  flush=True)
            step_ms, _ = _lanes_rounds(device, lanes_engine, wrappers, lanes, top, lanes_new,
                                       lanes_rounds, gpu)
            counts = {name: w.launches for name, w in wrappers.items()}
            print(f"  launches: {counts}", flush=True)
            _check_form_path("lanes-int8", counts, form, image=False)
            launches["lanes-int8"] = counts
            if device.type == "cuda":
                with torch.inference_mode():
                    _profile_lanes_chunk(lanes_engine, lanes, top, lanes_new, step_ms,
                                         label="lanes-int8", moe_kernels=BF16X_MOE_KERNELS)
            del lanes_engine
        with torch.inference_mode():
            _form_reference(params["lm"], text, ref_prompt, device)
        del params
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    return launches


TRAIN_SEQ = 2048  # the recipes' max_seq_length
TRAIN_REF_SEQ = 512  # tokens of the 2-layer card-against-CPU training step


def _grouped_mm_t(lhs, grad, sizes, ref):
    """torch._grouped_mm as tgmm's yardstick: lhs^T [K, M] . grad [M, N]
    grouped along M, bf16 operands, or None where the card's torch does not
    take it."""
    import torch

    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    a, b = lhs.T, grad.to(torch.bfloat16)
    try:
        out = fn(a, b, offs=offs)
    except (RuntimeError, TypeError, ValueError) as exc:
        print(f"  library: torch._grouped_mm refuses the tgmm operands ({exc})", flush=True)
        return None
    if out.shape != ref.shape or _rel_err(out.float(), ref) > 1e-2:
        print("  library: torch._grouped_mm gives another tgmm result; not timed", flush=True)
        return None
    return lambda: fn(a, b, offs=offs)


def _causal_lse(q, k, scale: float):
    """Each query row's log-sum-exp of its scaled causal scores, [B, H, S]
    f32, from f32 products of q and k [B, S, H, D]."""
    import torch

    S = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    above = torch.ones((S, S), dtype=torch.bool, device=q.device).triu(1)
    return torch.logsumexp(scores.masked_fill_(above, float("-inf")), -1)


def _extend(record: dict, errs, timed) -> None:
    """Adds shapes checked in the training checks to a kernel's record."""
    record["max_abs_err"] = max([record["max_abs_err"], *errs])
    record["times"] += [{"at": t["at"], **_entry(t)} for t in timed]


def check_train_kernels(device, gen, results, cfg=None, batch=8):
    """Phase 2, the train phase's kernels at the training shapes, each against
    its plain version, added to ``results`` (check_kernels' records): the
    causal flash forward with its row log-sum-exp and its backward at
    [1, 2048, 20, 128] (the LoRA recipe) and [``batch``, 2048, 20, 128]
    (the full recipe), sdpa's backward alone as the yardstick (its forward +
    backward printed beside); the ragged
    forward and backward at the full recipe's rows (2048 x ``batch``
    tokens x 6 slots, padded to 128, in the 64 routed experts, four groups
    empty and the others straddling tiles): gmm of the w1 and w2 layouts;
    the cotangent split (bit-equal to its plain version, no tile flagged for
    a bf16-exact cotangent), gmm_dlhs and tgmm given the split, for w1's
    bf16-exact cotangent (training's) and a 16-bit one, and w2's 16-bit one;
    the cancellation witness and its planted fault (``_cancellation``);
    torch._grouped_mm as the yardstick."""
    import torch
    import torch.nn.functional as F

    from aria_tpu_torch import TextConfig
    from aria_tpu_torch.ops import flash as fl
    from aria_tpu_torch.ops import moe as tmoe

    cfg = cfg or TextConfig()
    H, Dh, D, I, E = (cfg.num_heads, cfg.head_dim, cfg.hidden_size, cfg.moe_intermediate_size,
                      cfg.num_experts)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    print("flash_causal, flash_causal_bwd (training shapes)", flush=True)
    S, scale = TRAIN_SEQ, Dh**-0.5
    ferrs, ftimed, berrs, btimed = [], [], [], []
    for B in dict.fromkeys((1, batch)):
        q, k, v, do = (randn(B, S, H, Dh) for _ in range(4))
        lse = torch.empty((B, H, S), device=device)
        out = fl._forward(q, k, v, scale, lse)
        if not torch.equal(out, fl.flash_causal(q, k, v)):
            raise AssertionError("flash_causal: the forward with statistics gives other bits")
        ferrs.append(_compare(f"flash_causal B={B} S={S}", out, fl.flash_causal_plain(q, k, v),
                              1e-2, "bf16 output; both round p to bf16 before p.v, the plain "
                              "version after normalising it"))
        _compare(f"flash_causal row log-sum-exp B={B} S={S}", lse, _causal_lse(q, k, scale), 1e-4,
                 "f32 scores of bf16 q and k, f32 exponent sums in another order")
        got = fl.flash_causal_bwd(q, k, v, out, do, lse)
        if not all(map(torch.equal, got, fl.flash_causal_bwd(q, k, v, out, do, lse))):
            raise AssertionError("flash_causal_bwd: a second call gives other bits")
        ref = fl.flash_causal_bwd_plain(q, k, v, do)
        berrs += [_compare(f"flash_causal_bwd d{n} B={B} S={S}", a, b, 2e-2,
                           "bf16 outputs; p and ds enter the kernel's products as bf16, the "
                           "plain version's p as bf16 and ds in f32")
                  for n, a, b in zip("qkv", got, ref)]
        del got, ref
        pairs = B * S * (S + 1) // 2 * H  # (query, key) pairs under the causal mask
        qkv_t = [t.transpose(1, 2) for t in (q, k, v)]

        def sdpa_fwd_bwd(qkv_t=qkv_t, do=do):
            leaves = [t.detach().requires_grad_() for t in qkv_t]
            o = F.scaled_dot_product_attention(*leaves, is_causal=True)
            torch.autograd.grad(o, leaves, do.transpose(1, 2))

        # sdpa's backward alone: its forward runs once, outside the timed call
        leaves = [t.detach().requires_grad_() for t in qkv_t]
        o_sdpa = F.scaled_dot_product_attention(*leaves, is_causal=True)
        do_t = do.transpose(1, 2)

        def sdpa_bwd(o=o_sdpa, leaves=leaves, do_t=do_t):
            torch.autograd.grad(o, leaves, do_t, retain_graph=True)

        # the backward's least work: s recomputed, dp, dv, dk, dq (5 products)
        btimed.append(_timed(
            f"[{B}, {S}, {H}, {Dh}] (the plain version includes its forward; library: sdpa's "
            f"backward alone)",
            lambda a=(q, k, v, out, do, lse): fl.flash_causal_bwd(*a),
            lambda a=(q, k, v, do): fl.flash_causal_bwd_plain(*a), 10, 2,
            _bound(_nbytes(q, k, v, out, do, lse) + 3 * _nbytes(q), 5 * 2 * pairs * Dh), sdpa_bwd))
        print(f"  flash_causal_bwd [{B}, {S}, {H}, {Dh}]: sdpa forward + backward "
              f"{_time_ms(sdpa_fwd_bwd, 10)[0]:.4f} ms", flush=True)
        del leaves, o_sdpa, do_t
        ftimed.append(_timed(
            f"forward with row statistics [{B}, {S}, {H}, {Dh}]",
            lambda a=(q, k, v, scale, lse): fl._forward(*a),
            lambda a=(q, k, v): fl.flash_causal_plain(*a), 10, 2,
            _bound(_nbytes(q, k, v, out, lse), 2 * 2 * pairs * Dh),
            lambda a=qkv_t: F.scaled_dot_product_attention(*a, is_causal=True)))
        del q, k, v, do, out, lse, qkv_t
    _record(results, "flash_causal_bwd", berrs, btimed)
    for t in ftimed:
        _print_timed("flash_causal", t)
    _extend(results["flash_causal"], ferrs, ftimed)

    print("gmm, split_hi_lo, gmm_dlhs, tgmm (training shapes)", flush=True)
    M = -(-S * batch * cfg.moe_topk // 128) * 128
    sizes = _ragged_sizes(gen, M, E)
    used = int((sizes > 0).sum())
    gerrs, gtimed, serrs, stimed, derrs, dtimed, terrs, ttimed = ([] for _ in range(8))
    exact = "exact products (hi + lo), f32 sums in another order, one bf16 rounding"
    for label, trans in (("w1 [E, 2I, D]", True), ("w2 [E, I, D]", False)):
        K, N = (D, 2 * I) if trans else (I, D)  # the forward's contraction and output
        rhs = randn(E, N, K, scale=K**-0.5) if trans else randn(E, K, N, scale=K**-0.5)
        lhs = randn(M, K)
        fwd = (lhs, rhs, sizes, trans)
        got, ref = tmoe.gmm(*fwd), tmoe.gmm_plain(*fwd)
        gerrs.append(_compare(f"gmm {label} M={M} ({used} of {E} groups)", got, ref, 1e-4,
                              "exact bf16 products, f32 sums in another order"))
        bound = _bound(_nbytes(lhs, sizes) + used * N * K * 2 + M * N * 4, 2 * M * N * K)
        lib = _gmm_library(lhs, rhs.transpose(1, 2) if trans else rhs, sizes, ref,
                           f"{label} M={M}")
        gtimed.append(_timed(f"{label} M={M}", lambda a=fwd: tmoe.gmm(*a),
                             lambda a=fwd: tmoe.gmm_plain(*a), 5, 1, bound, lib))
        del got, ref
        # the cotangents training sends: w1's is the f32 upcast of a bf16
        # gradient (the backward of ops/moe.py's .to(x.dtype)), every lo zero;
        # w2's a bf16 gradient times a bf16 combine weight (16 bits)
        kinds = {"bf16-exact": randn(M, N).float()} if trans else {}
        kinds["16-bit"] = (randn(M, N).float() * randn(M, 1).float()).contiguous()
        for kind, grad in kinds.items():
            at = f"{label} M={M}, {kind} cotangent"
            split = tmoe.split_hi_lo(grad)
            plain = tmoe.split_hi_lo_plain(grad)
            for n, a, b in zip(("hi", "lo", "flags"), split, plain):
                if not torch.equal(a, b):
                    raise AssertionError(f"split_hi_lo {at}: {n} differs from the plain version")
            flagged = int(split[2].sum())
            want = 0 if kind == "bf16-exact" else None
            print(f"  split_hi_lo {at}: hi, lo and flags bit-equal to the plain version; "
                  f"{flagged} of {split[2].numel()} row tiles flagged", flush=True)
            if want is not None and flagged != want:
                raise AssertionError(f"split_hi_lo {at}: {flagged} tiles flagged, not {want}")
            serrs.append(0.0)
            stimed.append(_timed(at, lambda g=grad: tmoe.split_hi_lo(g),
                                 lambda g=grad: tmoe.split_hi_lo_plain(g), 10, 2,
                                 _bound(_nbytes(grad, *split), 0)))
            bwd = (grad, rhs, sizes, not trans)
            got, ref = tmoe.gmm_dlhs(*bwd, split=split), tmoe.gmm_plain(*bwd)
            derrs.append(_compare(f"gmm_dlhs {at} ({used} of {E} groups)", got, ref, 1e-2,
                                  exact))
            # operations at the bf16 rate, one product: the split operands are bf16-exact
            bound = _bound(_nbytes(split[0], sizes, got) + used * N * K * 2, 2 * M * N * K)
            lib = _grouped_mm(grad.to(torch.bfloat16), rhs if trans else rhs.transpose(1, 2),
                              sizes, ref)
            dtimed.append(_timed(f"{at} (split given)",
                                 lambda a=bwd, sp=split: tmoe.gmm_dlhs(*a, split=sp),
                                 lambda a=bwd: tmoe.gmm_plain(*a), 5, 1, bound, lib))
            del got, ref
            got, ref = tmoe.tgmm(lhs, grad, sizes, split=split), tmoe.tgmm_plain(lhs, grad, sizes)
            terrs.append(_compare(f"tgmm {at}", got, ref, 1e-2, exact))
            for e in torch.nonzero(sizes == 0).flatten().tolist():
                if not torch.equal(got[e], torch.zeros_like(got[e])):
                    raise AssertionError(f"tgmm: empty group {e} is not zero")
            bound = _bound(_nbytes(lhs, split[0], sizes, got), 2 * M * N * K)
            ttimed.append(_timed(f"{at} (split given)",
                                 lambda a=(lhs, grad, sizes), sp=split: tmoe.tgmm(*a, split=sp),
                                 lambda a=(lhs, grad, sizes): tmoe.tgmm_plain(*a), 5, 1, bound,
                                 _grouped_mm_t(lhs, grad, sizes, ref)))
            del got, ref, split, plain
        derrs.append(_cancellation(tmoe, lhs, rhs, kinds["16-bit"], sizes, trans, label))
        del rhs, lhs, kinds
    for t in gtimed:
        _print_timed("gmm", t)
    _extend(results["gmm"], gerrs, gtimed)
    _record(results, "split_hi_lo", serrs, stimed)
    _record(results, "gmm_dlhs", derrs, dtimed)
    _record(results, "tgmm", terrs, ttimed)


# The segment backward's limit: each gradient's largest error within 2e-2 of
# its largest element (the card test's). The kernel rounds ds to bf16
# before dk and dq (relative 2^-9 a term; the plain version keeps it in
# f32) and rounds each gradient once, ~5e-3 of the largest element at
# 4,900 keys; the plain gradient without the last 36 keys must move dq by
# more.
SEG_BWD_REL = 2e-2
# [B, S, H, D] and the valid patches of each image: None (all valid), a
# prefix of each length (a landscape crop), or "crop": a 980 x 630 portrait
# crop's 70 x 45 of the 70 x 70 patches (3,150, padding inside every tile)
SEG_BWD_SHAPES = ((1, 4900, 16, 72, None), (1, 4900, 16, 72, (3150,)),
                  (1, 4900, 16, 72, "crop"), (2, 300, 2, 72, (300, 137)),
                  (1, 129, 4, 64, (100,)))


def check_segment_bwd(device, gen, results, shapes=SEG_BWD_SHAPES):
    """Phase 2, the ViT's training attention: ``flash_segment``'s forward
    with its row statistics (bits equal to the serving forward's, timed as
    the training form of row 6a) and ``flash_segment_bwd`` against
    ``flash_segment_bwd_plain`` (autograd of the plain version), each
    gradient to SEG_BWD_REL of its largest element, a second call's bits,
    and a planted fault at the all-valid 4,900 (the plain gradient without
    the last 36 keys) that must read above the limit. The cotangent is zero
    on pad rows: there the JAX package off the TPU (pad queries attend the
    valid keys) and the library kernel (pad queries attend pad keys) differ
    by design, and in the ViT the projector gives pad patches no gradient.
    Timed at 4,900 patches (all valid, a prefix of 3,150 and the crop)
    beside its bound (5 products over the pairs of equal segments), its
    plain version and sdpa's backward under the segment mask (its forward
    outside the timed call)."""
    import torch
    import torch.nn.functional as F

    from aria_tpu_torch.ops import flash as fl

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    print("flash_segment_bwd, flash_segment with row statistics (training)", flush=True)
    errs, timed, ferrs, ftimed = [], [], [], []
    for B, S, H, D, prefix in shapes:
        q, k, v, do = (randn(B, S, H, D) for _ in range(4))
        valid = torch.ones((B, S), dtype=torch.bool, device=device)
        if prefix == "crop":
            side = int(S**0.5)
            valid = valid.reshape(B, side, side)
            valid[:, :, side * 630 // 980:] = False
            valid = valid.reshape(B, S)
        else:
            for b, n in enumerate(prefix or ()):
                valid[b, n:] = False
        do = do * valid[:, :, None, None]
        at = f"[{B}, {S}, {H}, {D}] " + ("all valid" if prefix is None else
                                         f"the crop's {int(valid[0].sum())} valid"
                                         if prefix == "crop" else f"valid {prefix}")
        scale = D**-0.5
        stats = torch.empty((2, B, H, S), dtype=torch.float32, device=device)
        out = fl._segment_forward(q, k, v, valid, valid, scale, stats)
        if not torch.equal(out, fl.flash_segment(q, k, v, valid, valid)):
            raise AssertionError(f"flash_segment {at}: the forward with statistics gives "
                                 "other bits")
        ferrs.append(0.0)
        got = fl.flash_segment_bwd(q, k, v, out, do, stats, valid, valid)
        if not all(map(torch.equal, got, fl.flash_segment_bwd(q, k, v, out, do, stats, valid,
                                                              valid))):
            raise AssertionError(f"flash_segment_bwd {at}: a second call gives other bits")
        ref = fl.flash_segment_bwd_plain(q, k, v, do, valid, valid)
        for n, a, r in zip("qkv", got, ref):
            limit = SEG_BWD_REL * r.float().abs().max().item()
            errs.append(_compare(
                f"flash_segment_bwd d{n} {at}", a, r, limit,
                f"absolute, {SEG_BWD_REL:.0e} of the largest element: bf16 outputs; ds enters "
                "dk and dq as bf16 in the kernel, in f32 in the plain version", absolute=True))
        if S == 4900 and prefix is None:  # what the limit must catch: the last 36 keys left out
            cut = fl.flash_segment_bwd_plain(q, k[:, :S - 36], v[:, :S - 36], do,
                                             valid, valid[:, :S - 36])[0]
            moved = (cut.float() - ref[0].float()).abs().max().item()
            limit = SEG_BWD_REL * ref[0].float().abs().max().item()
            print(f"  flash_segment_bwd {at}: the plain dq without the last 36 keys moves by "
                  f"{moved:.3e} (limit {limit:.3e})", flush=True)
            if not moved > limit:
                raise AssertionError("flash_segment_bwd's limit does not see a dropped key tile")
            del cut
        del got, ref
        if S == 4900:
            n_seg = int(valid[0].sum())
            pairs = B * H * (n_seg**2 + (S - n_seg)**2)  # (query, key) pairs of equal segments
            qkv_t = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
            same = valid[:, None, :, None] == valid[:, None, None, :]
            o_sdpa = F.scaled_dot_product_attention(*qkv_t, attn_mask=same)
            do_t = do.transpose(1, 2)

            def sdpa_bwd(o=o_sdpa, leaves=qkv_t, do_t=do_t):
                torch.autograd.grad(o, leaves, do_t, retain_graph=True)

            timed.append(_timed(
                f"{at} (the plain version includes its forward; library: sdpa's backward "
                f"alone under the segment mask)",
                lambda a=(q, k, v, out, do, stats, valid, valid): fl.flash_segment_bwd(*a),
                lambda a=(q, k, v, do, valid, valid): fl.flash_segment_bwd_plain(*a), 10, 2,
                _bound(5 * _nbytes(q) + _nbytes(stats, valid, valid) + 3 * _nbytes(q),
                       5 * 2 * pairs * D), sdpa_bwd))
            ftimed.append(_timed(
                f"{at}, with row statistics (training)",
                lambda a=(q, k, v, valid, valid, scale, stats): fl._segment_forward(*a),
                lambda a=(q, k, v, valid, valid): fl.flash_sdpa_plain(*a), 10, 2,
                _bound(4 * _nbytes(q) + _nbytes(stats, valid, valid), 2 * 2 * pairs * D),
                lambda a=qkv_t, m=same: F.scaled_dot_product_attention(
                    *(t.detach() for t in a), attn_mask=m)))
            del qkv_t, same, o_sdpa, do_t
        del q, k, v, do, out, stats
    _record(results, "flash_segment_bwd", errs, timed)
    for t in ftimed:
        _print_timed("flash_segment", t)
    _extend(results["flash_segment"], ferrs, ftimed)


# the cancellation witness: an entry whose exact value is 2^-12 of its
# terms, which the hi product alone gives as 0; held to 1e-2 of its own size
# (the kernels' bf16 output rounds it by at most 2^-9), the lo product
# skipped must read about 1
CANCEL_LIMIT = 1e-2
CANCEL_EPS = 2.0**-12


def _cancellation(tmoe, lhs, rhs, grad, sizes, trans, label) -> float:
    """gmm_dlhs: one row whose cotangent is 1 + 2^-12 and -1 at two
    contraction columns whose rhs rows are equal; tgmm: a group of two rows
    with equal lhs and cotangents (1 + 2^-12) v and -v (the empty group 7 given
    the last two rows of group 6). Each held against the exact result, and
    again with every flag cleared (the lo product skipped everywhere), which
    must exceed the limit. Returns the larger reading."""
    import torch

    sizes = sizes.clone()
    sizes[6] -= 2
    sizes[7] = 2
    start = torch.cumsum(sizes, 0) - sizes
    r1 = int(start[7])
    r3 = int(start[8])  # gmm_dlhs's row: the first of group 8
    lhs, grad = lhs.clone(), grad.clone()
    lhs[r1 + 1] = lhs[r1]
    v = grad[r1].to(torch.bfloat16).float()
    grad[r1], grad[r1 + 1] = v * (1 + CANCEL_EPS), -v
    c1, c2 = 3, 200
    grad[r3] = 0
    grad[r3, c1], grad[r3, c2] = 1 + CANCEL_EPS, -1.0
    rhs = rhs.clone()
    if trans:  # gmm_dlhs takes rhs [E, 2I, D]: contraction rows c1 and c2
        rhs[8, c2] = rhs[8, c1]
        b = rhs[8, c1]
    else:  # rhs [E, I, D] transposed: contraction columns
        rhs[8, :, c2] = rhs[8, :, c1]
        b = rhs[8, :, c1]
    want_d = b.double() * CANCEL_EPS
    want_t = torch.outer(lhs[r1].double(), v.double()) * CANCEL_EPS
    split = tmoe.split_hi_lo(grad)
    fault = (split[0], split[1], torch.zeros_like(split[2]))
    # the plain versions (a rehearsal on the CPU) take no split: there the
    # fault is the hi plane given as the cotangent
    fault_grad = grad if grad.is_cuda else split[0].float()

    def err(got, want):
        return ((got.double() - want).abs().max() / want.abs().max()).item()

    reads = {}
    for name, g, sp in (("held", grad, split), ("lo skipped", fault_grad, fault)):
        d = tmoe.gmm_dlhs(g, rhs, sizes, not trans, split=sp)[r3]
        t = tmoe.tgmm(lhs, g, sizes, split=sp)[7]
        reads[name] = (err(d, want_d), err(t, want_t))
    print(f"  cancellation witness {label}: gmm_dlhs {reads['held'][0]:.3e}, tgmm "
          f"{reads['held'][1]:.3e} of the entries' own size (limit {CANCEL_LIMIT:.0e}); the lo "
          f"product skipped: {reads['lo skipped'][0]:.3e}, {reads['lo skipped'][1]:.3e}",
          flush=True)
    if max(reads["held"]) > CANCEL_LIMIT:
        raise AssertionError(f"the cancellation witness {label} reads {reads['held']}")
    if min(reads["lo skipped"]) <= CANCEL_LIMIT:
        raise AssertionError(f"the lo product skipped passes the witness {label}")
    return max(reads["held"])


def _train_dataset(path, rows, images, seed, words=(180, 130, 90)):
    """A jsonl dataset of ``rows`` chat rows drawn from ``seed``: long
    random-word text (most of a 2048-token sequence: ``words`` of a text
    row's question, an image row's, and the answer), every ``images``-th
    row (0: none) with one random 980px image."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    os.makedirs(path, exist_ok=True)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    n_text, n_image, n_answer = words

    def words(n):
        return " ".join("".join(rng.choice(letters, rng.randint(2, 9))) for _ in range(n))

    with open(os.path.join(path, "train.jsonl"), "w") as f:
        for i in range(rows):
            image = images and i % images == 0
            user = [{"type": "text", "text": words(n_image if image else n_text)}]
            row = {"messages": [{"role": "user", "content": user},
                                {"role": "assistant", "content": [{"type": "text",
                                                                   "text": words(n_answer)}]}],
                   "images": None, "video": None}
            if image:
                name = f"image{i}.png"
                Image.fromarray(rng.randint(0, 256, (980, 980, 3), dtype=np.uint8)).save(
                    os.path.join(path, name))
                user.insert(0, {"type": "image"})
                row["images"] = [name]
            f.write(json.dumps(row) + "\n")


def _union_ms(spans) -> float:
    """The time covered by (start us, end us, ...) spans sorted by start, in ms."""
    busy, cursor = 0.0, float("-inf")
    for s, e, *_ in spans:
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    return busy / 1e3


def _device_spans(prof) -> list:
    """(start us, end us, name) of every device event of a profile (kernels,
    copies, fills), sorted by start, from the profiler's raw events:
    ``prof.events()`` builds a Python object for each (~70 us each), too
    slow for a 28-layer training run's profile."""
    import torch

    return sorted((e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3, e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA)


def _busy_share(device_spans, first="flash_causal") -> tuple[float, float]:
    """(device busy ms, window ms) over the profiled run, from the start of
    the first kernel whose name holds ``first`` (the first step's first
    attention) to the end of the last kernel; copies and fills are left
    out, so that the checkpoint's device-to-host copies after the last
    step do not count."""
    spans = [t for t in device_spans if not t[2].startswith(("Memcpy", "Memset"))]
    start = next(s for s, _, name in spans if first in name)
    end = max(e for _, e, _ in spans)
    return _union_ms([(max(s, start), e) for s, e, _ in spans if e > start]), (end - start) / 1e3


# the profiler's name of each kernel the train phase launches once per
# wrapper call (the flash backward's two kernels once each), for the
# profile's completeness check; the gmm forward and gmm_dlhs have names of
# their own
TRAIN_KERNEL_EVENTS = {
    "flash_causal": (r"\bflash_causal_kernel\b",),
    "flash_causal_bwd": (r"\bflash_bwd_di_kernel\b", r"\bflash_bwd_kernel\b"),
    "vit_flash": (r"\bvit_attention_kernel<\d+, 0>",),
    "gmm": (r"\bgmm_fwd_kernel<",),
    "split_hi_lo": (r"\bsplit_kernel\b",),
    "gmm_dlhs": (r"\bgmm_dlhs_kernel<",),
    "tgmm": (r"\btgmm_kernel\b",),
    "flash_segment": (r"\bvit_attention_kernel<\d+, 1>",),
    "flash_segment_bwd": (r"\bseg_bwd_prep_kernel\b", r"\bseg_bwd_kernel<"),
}


def _profile_complete(device_spans, launches, label, event_ms) -> bool:
    """Whether the profile holds every launch of the port's kernels that the
    wrappers counted (the profiler was seen to drop events late in a long
    run); prints the counts and the profiled kernel time beside the CUDA
    events' span around the run."""
    import collections
    import re

    calls = collections.Counter(n for *_, n in device_spans)  # each name searched once
    seen = {}
    for name, patterns in TRAIN_KERNEL_EVENTS.items():
        if launches[name]:
            seen[name] = [sum(c for n, c in calls.items() if re.search(pat, n))
                          for pat in patterns]
    complete = all(n == launches[name] for name, ns in seen.items() for n in ns)
    total = _union_ms(device_spans)
    print(f"  {label}: profile {'complete' if complete else 'INCOMPLETE, busy share not measured'}"
          f": profiled launches {seen} against the wrappers' counts "
          f"{ {name: launches[name] for name in seen} }; profiled device busy time {total:.1f} ms "
          f"(copies included) in a CUDA-event span of {event_ms:.1f} ms around train()",
          flush=True)
    if total > event_ms:
        print(f"  {label}: the profiled busy time exceeds the CUDA-event span", flush=True)
        complete = False
    return complete


def _base_bytes(tree) -> tuple[int, int]:
    """(bytes the tree holds, bytes of its bf16 form): an int8 ``{"q", "s"}``
    leaf counts its values at 2 bytes in the bf16 form, and its scales not."""
    held = bf16 = 0
    for v in (tree.values() if isinstance(tree, dict) else ()):
        if isinstance(v, dict) and "q" in v and "s" in v:
            held += sum(t.numel() * t.element_size() for t in v.values())
            bf16 += 2 * v["q"].numel()
        elif isinstance(v, dict):
            h, b = _base_bytes(v)
            held, bf16 = held + h, bf16 + b
        else:
            held += v.numel() * v.element_size()
            bf16 += v.numel() * v.element_size()
    return held, bf16


@contextlib.contextmanager
def _watch_build(out: dict, cuda: bool):
    """Inside, ``train()``'s base build (``build_params``, then QLoRA's
    ``quantize_params_by_layer``) records into ``out`` its seconds, its
    device peak and the resident base's bytes beside its bf16 form's; the
    peak statistics are reset after it, so that the run's peak is the
    steps'."""
    import torch

    from aria_tpu_torch.train import loop

    build, quantize = loop.build_params, loop.quantize_params_by_layer

    def note(tree, t0):
        if cuda:
            torch.cuda.synchronize()
            out["peak_gib"] = max(out.get("peak_gib", 0.0),
                                  torch.cuda.max_memory_allocated() / 2**30)
            torch.cuda.reset_peak_memory_stats()
        out["s"] = out.get("s", 0.0) + time.perf_counter() - t0
        out["held"], out["bf16"] = _base_bytes(tree["lm"])
        return tree

    def build_params(*a, **kw):
        t0 = time.perf_counter()
        return note(build(*a, **kw), t0)

    def quantize_params_by_layer(params, *a, **kw):
        t0 = time.perf_counter()
        return note(quantize(params, *a, **kw), t0)

    loop.build_params, loop.quantize_params_by_layer = build_params, quantize_params_by_layer
    try:
        yield out
    finally:
        loop.build_params, loop.quantize_params_by_layer = build, quantize


def _run_recipe(device, recipe, cfg, label, gpu, steps):
    """``train()`` on the card under the profiler (kernels only), every launch
    count set to 0 first; prints the base's build (seconds, device peak,
    the decoder's resident bytes beside its bf16 form's), each micro step's
    metrics, the steps' peak memory, the device's busy share over the steps
    and the device time by kernel. Returns the launch counts, the final
    state and the build's record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from aria_tpu_torch.train.loop import train

    wrappers = _wrappers()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    built = {}
    with (profile(activities=[ProfilerActivity.CUDA]) if cuda else
          contextlib.nullcontext()) as prof, _watch_build(built, cuda):
        state = train(recipe, cfg=cfg, max_steps=steps, device=device)
        if cuda:
            end.record()
        _sync(device)
    wall = time.perf_counter() - t0
    print(f"  {label}: the base built in {built['s']:.2f} s, device peak "
          f"{built.get('peak_gib', float('nan')):.2f} GiB; the decoder holds "
          f"{built['held'] / 1e9:.2f} GB ({built['bf16'] / 1e9:.2f} GB in bf16)", flush=True)
    launches = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan")
    spans = _device_spans(prof) if cuda else []
    busy, window = _busy_share(spans) if cuda else (float("nan"), float("nan"))
    if cuda and not _profile_complete(spans, launches, label, start.elapsed_time(end)):
        busy = float("nan")  # not measured: the profile lost some of the card's events
    lines = [json.loads(line) for line in open(os.path.join(recipe.output_dir, "metrics.jsonl"))]
    for line in lines:
        print(f"  {label} micro step {line['step']}: {line['step_time_s'] * 1e3:.1f} ms, "
              f"{line['tokens_per_s']:.1f} tokens/s, loss {line['loss']:.5f}, grad_norm "
              f"{line['grad_norm']:.5f} ({gpu})", flush=True)
    print(f"  {label}: {len(lines)} micro steps in {wall:.1f} s with set-up; peak memory "
          f"{peak:.2f} GiB; device busy {busy:.1f} of {window:.1f} ms from the first "
          f"attention kernel on (busy share {busy / window:.3f}, idle {1 - busy / window:.3f}; "
          f"under the kernel profiler); launches: {launches}", flush=True)
    if cuda:  # where the device time goes over the run (set-up included)
        by_name = {}
        for s0, s1, name in spans:
            us, calls = by_name.get(name, (0.0, 0))
            by_name[name] = (us + s1 - s0, calls + 1)
        total = sum(us for us, _ in by_name.values())
        for name, (us, calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
            print(f"    {name[:90]}: {us / 1e3:.1f} ms ({us / total:.3f} of the device time), "
                  f"{calls} calls", flush=True)
    if len(lines) != steps or not all(
            all(map(lambda v: v == v and abs(v) != float("inf"), line.values()))
            for line in lines):
        raise AssertionError(f"{label}: {len(lines)} micro steps logged, or non-finite metrics")
    return launches, state, built


REF_VIT_LAYERS = 2  # the ViT's layers in the train-vit reference (full width)
REF_IMAGE = 490  # its image's side: 35 x 35 patches, 1,225 of them, 128 image tokens
REF_IMAGE_VALID = 322  # the image's valid columns (23 of 35 patch columns)
REF_KINDS = ("lora", "qlora", "vit")
# train-vit: one row in 8 with an image. The ViT keeps no checkpoints (nor
# does the JAX package's): its graph holds ~14.5 GiB a 980px image, so a
# micro step of this data (2, 0, 2, 1, 1 and 0 images) fits beside the
# 2-layer decoder at batch 8, and 8 image rows (~116 GiB) fit no card.
VIT_TRAIN_IMAGES = 8
# train-vit's micro step ms by its images with the segment backward's first
# design (mma.sync dkv and dq kernels; this script on an H100 80GB HBM3 at
# 700 W), printed beside this run's
TRAIN_VIT_FIRST_MS = {0: "784.0-789.6", 1: "1,156.7-1,548.3", 2: "1,298.8-2,432.6"}


def _train_reference(device, cfg, kind, seed, ref_layers=2):
    """One micro step at ``ref_layers`` decoder layers and ``TRAIN_REF_SEQ``
    tokens on the card against the plain versions on the CPU from the same
    weights, leaf by leaf. ``kind``: "lora", the LoRA recipe's adapters
    over the bf16 base; "qlora", the same over the int8 base of
    ``quantize_params_by_layer`` (the blocked dequantize); "vit", the full
    recipe with ``freeze_vit`` false: the ViT (``REF_VIT_LAYERS`` layers at
    full width, one ``REF_IMAGE`` px image whose last columns are padding,
    so pad patches meet the segment kernels), the projector and the
    decoder trained, so that one step goes through the segment backward and
    the expert products' backward (``gmm_dlhs``, ``tgmm``). Held: the loss,
    the gradient norm and each trainable leaf's gradient as relative errors
    beside a witness (the card with one bf16 ulp on half the embedding
    table, against the card), to the larger of REF_LIMIT and twice the
    witness; then the card's optimizer given the CPU's gradients and the
    CPU's global norm against the CPU's update, entry by entry (OPT_SHARE,
    OPT_STEPS). Adam's first step is close to -lr * sign(g), so the update
    of the card's own step flips wherever bf16 noise flips a small
    gradient's sign: the optimizer is held on equal gradients instead. The
    leaves are compared on the card, the CPU's gradients and updates moved
    there."""
    import numpy as np
    import torch

    from aria_tpu_torch.models.aria import init_aria_params
    from aria_tpu_torch.ops.quant import quantize_params_by_layer
    from aria_tpu_torch.train import step as tstep
    from aria_tpu_torch.train.lora import LoraConfig, init_lora_params

    peft = kind != "vit"
    text = dataclasses.replace(cfg.text, num_layers=ref_layers)
    small = cfg.replace(text=text)
    if not peft:
        small = small.replace(vision=dataclasses.replace(cfg.vision, num_layers=REF_VIT_LAYERS))
    gen = torch.Generator(device=device).manual_seed(seed)
    base = init_aria_params(small, gen, device=device)
    if kind == "qlora":
        base = quantize_params_by_layer(base)
    rng = np.random.RandomState(seed)
    ids = torch.as_tensor(rng.randint(0, text.vocab_size, (1, TRAIN_REF_SEQ)))
    batch = {"input_ids": ids, "labels": ids.clone()}
    if not peft:
        n_img = small.projector.query_count((REF_IMAGE // small.vision.patch_size) ** 2)
        ids[0, 8:8 + n_img] = small.image_token_id
        batch["labels"] = torch.where(ids == small.image_token_id, -100, ids)
        batch["pixel_values"] = torch.as_tensor(
            rng.uniform(-1, 1, (1, 3, REF_IMAGE, REF_IMAGE)).astype(np.float32))
        mask = torch.zeros((1, REF_IMAGE, REF_IMAGE), dtype=torch.bool)
        mask[:, :, :REF_IMAGE_VALID] = True
        batch["pixel_mask"] = mask
    tc = tstep.TrainConfig(learning_rate=5e-5, weight_decay=0.1, b2=0.95,
                           freeze_vit=peft, freeze_projector=peft, freeze_llm=False,
                           total_steps=3, gradient_checkpointing=True)
    lc = LoraConfig(rank=8, alpha=32.0)
    lora = init_lora_params(small, lc, gen, device=device) if peft else None
    if peft:  # B away from 0, so that the step moves A as well
        for ab in lora["lm"]["layers"].values():
            ab["b"].normal_(0, 0.02, generator=gen)

    def run(dev, bump=False, grads=None, updates=True):
        """(metrics, gradients, update) of one step on ``dev``, left there;
        with ``grads``, only the optimizer, given those gradients."""
        params = _tree_map(lambda t: t.to(dev).clone(), base)
        if bump:
            params["lm"]["embed"] = _bump_half(params["lm"]["embed"].cpu()).to(dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        caught, m = {}, {}
        if peft:
            tree = _tree_map(lambda t: t.to(dev).clone(), lora)
            opt = tstep.make_lora_optimizer(tc)
        else:
            tree = params
            opt = tstep.make_optimizer(tc, params)
        update = opt.update
        opt.update = lambda g, st, p: (caught.update(g), update(g, st, p))
        state = tstep.TrainState(tree, opt.init(tree), 0)
        before = {k: v.detach().clone() for k, v in opt.trainable(tree)} if updates else {}
        if grads is not None:
            # the clip's global norm is a reduction whose order the card
            # and the CPU choose differently: give the card the CPU's, so
            # that the elementwise steps are what is compared (the norm is
            # held as the step's grad_norm above)
            norm, global_norm = ref_norm.to(dev), tstep.global_norm
            tstep.global_norm = lambda g: norm
            try:
                opt.update(grads, state.opt_state, tree)
            finally:
                tstep.global_norm = global_norm
        elif peft:
            _, m = tstep.lora_train_step(state, b, params, small, lc.scale, opt, True)
        else:
            _, m = tstep.train_step(state, b, small, tc, opt)
        # in the leaves' dtypes; a bf16 update is the difference of two
        # adjacent bf16 values, which bf16 holds exactly
        return ({k: float(v) for k, v in m.items()}, dict(caught),
                {k: (v.detach().float() - before[k].float()).to(v.dtype)
                 for k, v in opt.trainable(tree) if k in before})

    t0 = time.perf_counter()
    # the witness runs on the card: the CPU's step is the reference's
    # slowest part, and a bump's spread does not depend on where the same
    # arithmetic runs
    got, ulp = run(device, updates=False), run(device, bump=True, updates=False)
    t1 = time.perf_counter()
    ref = run(torch.device("cpu"))
    ref_norm = tstep.global_norm(ref[1])  # what the CPU's optimizer clipped by
    ref = (ref[0], *({k: v.to(device) for k, v in part.items()} for part in ref[1:]))
    t2 = time.perf_counter()
    opt_got = run(device, grads=ref[1])[2]
    print(f"  reference ({TRAIN_REF_SEQ} tokens): the card's two steps {t1 - t0:.1f} s, the "
          f"CPU's step {t2 - t1:.1f} s, the card's optimizer {time.perf_counter() - t2:.1f} s",
          flush=True)
    label = {"lora": f"LoRA step, bf16 base, {ref_layers} layers, {TRAIN_REF_SEQ} tokens",
             "qlora": f"QLoRA step, int8 base, {ref_layers} layers, {TRAIN_REF_SEQ} tokens",
             "vit": f"full step, the ViT ({REF_VIT_LAYERS} layers, a {REF_IMAGE} px image, "
                    f"{REF_IMAGE_VALID} columns valid), the projector and {ref_layers} decoder "
                    f"layers trained, {TRAIN_REF_SEQ} tokens"}[kind]
    for key in ("loss", "grad_norm"):
        err = abs(got[0][key] - ref[0][key]) / abs(ref[0][key])
        witness = abs(ulp[0][key] - got[0][key]) / abs(got[0][key])
        print(f"  reference ({label}, CPU plain versions): {key} relative error {err:.3e} "
              f"(limit {REF_LIMIT:.3e}); witness, the card with one bf16 ulp on half the "
              f"embedding table against the card: {witness:.3e}", flush=True)
        if not err <= REF_LIMIT:
            raise AssertionError(f"training reference ({label}): {key} differs by {err}")
    worst, failed = [], []
    for leaf, g_ref in ref[1].items():
        u_got, u_ref = opt_got[leaf], ref[2][leaf]
        u_err = _rel_leaf(u_got, u_ref)
        differ = u_got != u_ref
        u_steps = float((u_got[differ].float() - u_ref[differ].float()).abs().max()
                        ) / tc.learning_rate if differ.any() else 0.0
        # the gradient and the share of differing entries over the entries
        # that are not a key bias (SHIFT_INVARIANT); the largest difference
        # over all
        held, note = _shift_held(leaf, ref[1], got[1])
        g_err = _rel_leaf(got[1][leaf][..., held], g_ref[..., held])
        g_wit = _rel_leaf(ulp[1][leaf][..., held], got[1][leaf][..., held])
        u_share = int(differ[..., held].sum()) / max(differ[..., held].numel(), 1)
        g_limit = max(REF_LIMIT, GRAD_WITNESS_FACTOR * g_wit)
        if not held.any():
            g_limit = u_share_limit = float("inf")
        else:
            u_share_limit = OPT_SHARE
        print(f"  reference ({label}): {leaf}{note} gradient relative error {g_err:.3e} "
              f"(limit {g_limit:.3e}; witness {g_wit:.3e}); the card's optimizer on the CPU's "
              f"gradient: {u_share:.3e} of {g_ref.numel()} entries differ (limit "
              f"{u_share_limit:.0e}), by at most {u_steps:.3f} x lr (limit {OPT_STEPS}); update "
              f"relative error {u_err:.3e}", flush=True)
        for what, err, limit in (("gradient", g_err, g_limit),
                                 ("update's share of differing entries", u_share, u_share_limit),
                                 ("update's largest difference in lr", u_steps, OPT_STEPS)):
            worst.append((err / limit, leaf, what))
            if not err <= limit:
                failed.append(f"{leaf} {what} {err:.3e} above {limit:.3e}")
    if failed:
        raise AssertionError(f"training reference ({label}): {'; '.join(failed)}")
    ratio, leaf, what = max(worst)
    print(f"  reference ({label}): every leaf within its limits; the closest, {leaf} {what}, "
          f"at {ratio:.3f} of its limit; {time.perf_counter() - t0:.1f} s", flush=True)


GRAD_WITNESS_FACTOR = 2  # a leaf's gradient is held to twice its witness
# A key bias adds q . b to every score of a query row, which the softmax
# cancels: its gradient is 0 but for rounding on either side, and Adam's
# g / (sqrt(v) + eps) on a rounding-sized gradient gives updates whose last
# bits differ between the card and the CPU (0.005 x lr seen on the ViT's
# bk and the projector's in_proj key bias, 13.6% of bk's entries). Leaf ->
# (the key bias's slice of its last axis, the query bias's leaf and slice
# that it is measured against), from the last axis's length. Where the
# CPU's key-bias gradient is below SHIFT_NOISE of the query bias's (norms),
# its gradient and its share of differing entries go unheld (its largest
# difference in lr stays held); else it is held as every other entry is.
SHIFT_INVARIANT = {
    "vision/layers/bk": (lambda n: slice(0, n), "vision/layers/bq", lambda n: slice(0, n)),
    "projector/attn_in_b": (lambda n: slice(n // 3, 2 * n // 3), "projector/attn_in_b",
                            lambda n: slice(0, n // 3)),
}
SHIFT_NOISE = 1e-2


def _shift_held(leaf: str, ref: dict, got: dict):
    """(bool [last axis], note): the entries of ``leaf`` that are held, and
    for a key bias its gradient's norm on the CPU and on the card beside
    its query bias's on the CPU."""
    import torch

    n = ref[leaf].shape[-1]
    held = torch.ones(n, dtype=torch.bool, device=ref[leaf].device)
    if leaf not in SHIFT_INVARIANT:
        return held, ""
    key, qleaf, qcols = SHIFT_INVARIANT[leaf]
    kcols, qcols = key(n), qcols(ref[qleaf].shape[-1])
    q_norm = float(torch.linalg.norm(ref[qleaf][..., qcols].float()))
    k_norm = float(torch.linalg.norm(ref[leaf][..., kcols].float()))
    k_card = float(torch.linalg.norm(got[leaf][..., kcols].float()))
    noise = k_norm <= SHIFT_NOISE * q_norm
    if noise:
        held[kcols] = False
    part = "all" if kcols == slice(0, n) else f"columns {kcols.start}-{kcols.stop - 1}"
    return held, (f" (key bias, {part}: gradient norm {k_norm:.3e} on the CPU, {k_card:.3e} "
                  f"on the card, beside the query bias's {q_norm:.3e} on the CPU, "
                  + (f"{k_norm / q_norm:.2e} of it, at most {SHIFT_NOISE:.0e}: 0 but for "
                     "rounding, its gradient and share not held)" if noise else
                     f"{k_norm / q_norm:.2e} of it, above {SHIFT_NOISE:.0e}: held)"))


# The update from equal gradients: the card's and the CPU's torch do not
# round every bf16 elementwise op alike, and where a step lands near half
# a bf16 ulp of its parameter the two results differ by that ulp, which
# is at most two steps (2 lr). A broken optimizer moves most entries.
OPT_SHARE = 1e-2  # of a leaf's entries (0.112% of the lm_head's seen)
OPT_STEPS = 4  # the largest difference, in units of the learning rate


def _rel_leaf(a, b) -> float:
    """|a - b| / |b| over a leaf (|a - b| where b is 0), in f32."""
    import torch

    d = float(torch.linalg.norm(a.float() - b.float()))
    den = float(torch.linalg.norm(b.float()))
    return d / den if den else d


def _recipe_run(device, work, name, cfg, gpu, steps, batch, images, seed, **over):
    """A recipe's dataset (``steps`` optimizer steps of rows, every
    ``images``-th with a 980px image) and its ``_run_recipe``; returns the
    launches, the final state, the build and the micro steps."""
    from aria_tpu_torch.train.recipe import load_recipe

    recipe = load_recipe(os.path.join(HERE, "recipes", f"config_{name}.yaml"))
    micro = steps * recipe.gradient_accumulation_steps
    label = over.pop("label")
    ds = os.path.join(work, f"{label}_ds")
    _train_dataset(ds, micro * batch, images, seed)
    recipe = dataclasses.replace(recipe, per_device_train_batch_size=batch, dataset_mixer={ds: 1},
                                 output_dir=os.path.join(work, f"{label}_out"), **over)
    counts, state, built = _run_recipe(device, recipe, cfg, label, gpu, micro)
    return counts, state, built, micro


@contextlib.contextmanager
def _watch_images(out: list, per_step: list | None = None):
    """Inside, each ``encode_images`` call appends (its images, whether
    the ViT records a graph, the device bytes its graph and features hold
    when it returns: 0 off the card) to ``out``, and each metrics line that
    ``train()`` logs appends the images encoded since the one before to
    ``per_step`` (one entry a micro step)."""
    import torch

    from aria_tpu_torch.models import aria
    from aria_tpu_torch.utils.metrics import MetricsLogger

    encode, log, seen = aria.encode_images, MetricsLogger.log, [0]

    def logged(self, step, metrics):
        if per_step is not None:
            per_step.append(sum(n for n, _, _ in out[seen[0]:]))
            seen[0] = len(out)
        return log(self, step, metrics)

    def encode_images(params, cfg, pixel_values, *a, **kw):
        cuda = pixel_values.is_cuda
        before = torch.cuda.memory_allocated() if cuda else 0
        feats = encode(params, cfg, pixel_values, *a, **kw)
        out.append((pixel_values.shape[0],
                    torch.is_grad_enabled() and aria._asks_grad(params["vision"]),
                    torch.cuda.memory_allocated() - before if cuda else 0))
        return feats

    aria.encode_images, MetricsLogger.log = encode_images, logged
    try:
        yield out
    finally:
        aria.encode_images, MetricsLogger.log = encode, log


def run_train(device, gen, cfg=None, gpu="", lora_layers=4, lora_batch=1, vit_layers=2,
              vit_batch=8, steps=2, qlora_layers=QLORA_LAYERS):
    """The train phase (its kernels are checked in phase 2), at full width,
    ``steps`` optimizer steps each (x the recipes' 2 accumulated micro
    steps), on rows of 2048 tokens, some with a 980px image:

    - train-lora: recipes/config_lora.yaml on a random bf16 base at
      ``lora_layers`` decoder layers (the frozen ViT runs ``vit_flash``),
      its batch cut to ``lora_batch`` (the LoRA capacity path's
      [64, T, 3328] f32 buffers), every 2nd row an image;
    - train-qlora: the same recipe with ``quantize_base``, all decoder
      layers over the int8 base that ``train()`` quantizes one layer at a
      time (the blocked dequantize, ``expert_block_dequant``);
    - train-vit: recipes/config_full.yaml with ``freeze_vit`` false and its
      mesh fields set to 1, ``vit_layers`` decoder layers, the ViT whole,
      at the recipe's batch of ``vit_batch`` (gmm, tgmm and split_hi_lo at
      M 98,304), one row in VIT_TRAIN_IMAGES an image:
      the ViT's attention through ``flash_segment`` with row statistics and
      the segment backward, one launch of each per ViT layer and micro step
      that has images; the epoch-end checkpoint;

    then one step of each of REF_KINDS at 2 decoder layers on the card
    against the CPU. Returns {path: launches}."""
    import shutil
    import tempfile

    import torch

    from aria_tpu_torch import AriaConfig
    from aria_tpu_torch.data.tokenizer import ByteTokenizer

    # the rows are tokenized by train()'s ByteTokenizer, whose <|img|> is
    # 256 (the flagship tokenizer's is the config's 9): without this the
    # image features would reach no token
    cfg = (cfg or AriaConfig.aria_25b()).replace(image_token_id=ByteTokenizer().image_token_id)
    L, LV = cfg.text.num_layers, cfg.vision.num_layers
    cuda = device.type == "cuda"
    launches = {}
    work = tempfile.mkdtemp(prefix="aria_train_")

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan")

    def need(path, counts, names):
        for name in names:
            if counts[name] <= 0:
                raise AssertionError(f"{name} was not launched on {path}")
        launches[path] = counts
        if cuda:
            torch.cuda.empty_cache()

    try:
        small = cfg.replace(text=dataclasses.replace(cfg.text, num_layers=lora_layers))
        print(f"train-lora (recipes/config_lora.yaml): {lora_layers} decoder layers (cut from "
              f"{L}), hidden {cfg.text.hidden_size}, "
              f"{cfg.text.num_experts} experts, bf16 base; per_device_train_batch_size cut from "
              f"8 to {lora_batch}; every 2nd row with a 980px image", flush=True)
        counts, _, lora_built, _ = _recipe_run(device, work, "lora", small, gpu, steps,
                                               lora_batch, 2, SEED, label="train-lora")
        lora_peak = peak_gib()
        need("train-lora", counts, ("flash_causal", "flash_causal_bwd", "vit_flash"))

        print(f"train-qlora (recipes/config_lora.yaml, quantize_base true): {qlora_layers} "
              f"decoder layers (cut from {L}), the int8 base of quantize_params_by_layer; batch "
              f"{lora_batch}, every 2nd row with a 980px image", flush=True)
        qcfg = cfg.replace(text=dataclasses.replace(cfg.text, num_layers=qlora_layers))
        counts, _, built, _ = _recipe_run(device, work, "lora", qcfg, gpu, steps, lora_batch, 2,
                                          SEED, label="train-qlora", quantize_base=True)
        peak = peak_gib()
        print(f"  train-qlora: resident decoder {built['held'] / 1e9:.2f} GB in int8 (its bf16 "
              f"form at {qlora_layers} layers: {built['bf16'] / 1e9:.2f} GB; train-lora's bf16 "
              f"decoder at "
              f"{lora_layers} layers: {lora_built['held'] / 1e9:.2f} GB); device peak over the "
              f"steps {peak:.2f} GiB (train-lora's at {lora_layers} layers: {lora_peak:.2f} "
              f"GiB), over the build {built.get('peak_gib', float('nan')):.2f} GiB ({gpu})",
              flush=True)
        need("train-qlora", counts, ("expert_block_dequant", "flash_causal", "flash_causal_bwd"))

        small = cfg.replace(text=dataclasses.replace(cfg.text, num_layers=vit_layers))
        print(f"train-vit (recipes/config_full.yaml, freeze_vit false): {vit_layers} decoder "
              f"layers (cut from {L}), the ViT's {LV} layers at hidden "
              f"{cfg.vision.hidden_size}; batch {vit_batch} x 2048, one row in {VIT_TRAIN_IMAGES} "
              f"with a 980px image (4,900 patches); mesh_fsdp 2 and mesh_expert 4 set to 1 (one "
              f"card)", flush=True)
        images, per_step = [], []
        with _watch_images(images, per_step):
            counts, state, _, micro = _recipe_run(
                device, work, "full", small, gpu, steps, vit_batch, VIT_TRAIN_IMAGES, SEED + 1,
                label="train-vit", freeze_vit=False, mesh_fsdp=1, mesh_expert=1)
        if not all(graph for _, graph, _ in images):
            raise AssertionError("train-vit: the ViT recorded no graph")
        want = LV * len(images)
        for name in ("flash_segment", "flash_segment_bwd"):
            if cuda and counts[name] != want:
                raise AssertionError(f"train-vit: {name} launched {counts[name]} times, not "
                                     f"{LV} per ViT call ({want})")
        per_image = max(b / n for n, _, b in images) / 2**30
        print(f"  train-vit: the ViT ran {len(images)} times in {micro} micro steps, on "
              f"{[n for n, _, _ in images]} images, its graph holding up to {per_image:.2f} GiB "
              f"an image when the decoder starts ({gpu}); flash_segment (with row statistics) and "
              f"flash_segment_bwd launched {counts['flash_segment']} and "
              f"{counts['flash_segment_bwd']} times, {LV} per ViT call; vit_flash "
              f"{counts['vit_flash']}", flush=True)
        if cuda and counts["vit_flash"]:
            raise AssertionError("train-vit: the trained ViT went through vit_flash")
        need("train-vit", counts, ("flash_causal", "flash_causal_bwd", "gmm", "split_hi_lo",
                                   "gmm_dlhs", "tgmm"))
        out = os.path.join(work, "train-vit_out")
        ckpt = os.path.join(out, "checkpoints")
        size = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(ckpt) for f in fs)
        state_file = os.path.join(ckpt, f"step_{state.step}", "state.pt")
        # the last metrics line is written just before the epoch-end save starts
        save_s = os.path.getmtime(state_file) - os.path.getmtime(
            os.path.join(out, "metrics.jsonl"))
        print(f"  train-vit: the epoch-end checkpoint (params, moments, accumulator) holds "
              f"{size / 2**30:.2f} GiB, written in {save_s:.1f} s (the files' times)",
              flush=True)
        step_ms = [json.loads(line)["step_time_s"] * 1e3
                   for line in open(os.path.join(out, "metrics.jsonl"))]
        for n in sorted(set(per_step)):
            ms = [t for t, k in zip(step_ms, per_step) if k == n]
            print(f"  train-vit micro steps with {n} image(s): {min(ms):.1f}-{max(ms):.1f} ms "
                  f"over {len(ms)} (the segment backward's first design: "
                  f"{TRAIN_VIT_FIRST_MS.get(n, 'none')} ms; {gpu})", flush=True)
        del state
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for kind in REF_KINDS:
        _train_reference(device, cfg, kind, SEED + 3)
        if cuda:
            torch.cuda.empty_cache()
    return launches


# train-mesh: recipes/config_full.yaml's mesh (fsdp 2 x expert 4) as 8 ranks
# sharing the card. At 2,048 tokens a rank's 4 rows hold [4, 2048, 100352]
# f32 logits three times over (logits, log-softmax, their gradient: ~10 GiB)
# beside its shards, whole embed, head and ViT and the optimizer's state: 8
# such ranks do not fit one card's 80 GB, so the phase runs at 512.
TRAIN_MESH_SEQ = 512
TRAIN_MESH = {"mesh_fsdp": 2, "mesh_expert": 4}


def _train_mesh_rank(rank: int, recipe, cfg, steps: int, device_type: str) -> dict:
    """One rank of train-mesh: ``train()`` on cuda:0 (or the CPU in a
    rehearsal) with every launch count at 0 and the collectives logged.
    Returns the launches, the peak, the resident bytes and the collectives'
    seconds within the steps (before the epoch-end gather starts) and their
    largest message."""
    import torch

    from aria_tpu_torch.parallel import distributed as dd
    from aria_tpu_torch.train import loop

    cuda = device_type == "cuda"
    device = torch.device("cuda", 0) if cuda else torch.device("cpu")
    if cuda:
        # 8 ranks share the card: segments that grow in place, so that a
        # rank's cache does not hold freed blocks of one size the next
        # allocation of another cannot use (2.4 GiB a rank without it)
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        torch.cuda.set_device(device)
        share = dd.share_card(device)  # each rank an eighth of what the card has free
        torch.cuda.reset_peak_memory_stats()
    else:
        share = 0
        torch.set_num_threads(1)
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    dd.LOG = []
    saving = []
    whole = loop._whole_state

    def marked(*a, **kw):  # the epoch-end gather's start closes the steps' window
        saving.append(time.perf_counter())
        return whole(*a, **kw)

    loop._whole_state = marked
    t0 = time.perf_counter()
    try:
        state = loop.train(recipe, cfg, max_steps=steps, device=device)
    finally:
        loop._whole_state = whole
    end = saving[0] if saving else time.perf_counter()
    log, dd.LOG = dd.LOG, None
    in_steps = [e for e in log if e[3] < end]
    summary = loop._rank_summary(state, device)
    summary.update(launches={name: w.launches for name, w in wrappers.items()}, share=share,
                   coll_s=sum(e[2] for e in in_steps), coll_calls=len(in_steps),
                   coll_bytes=sum(e[1] for e in in_steps), run_s=end - t0,
                   biggest=max((e[1], e[0]) for e in in_steps))
    return summary


def _one_rank_steps(recipe, cfg, micro: int, device) -> tuple:
    """``train()``'s first ``micro`` micro steps of ``recipe`` on one rank
    (its data order, build and optimizer), without a checkpoint: the final
    state, each step's metrics with its ms, and the trainable leaves as
    they were built."""
    import random

    import torch

    from aria_tpu_torch.data.collate import collate_fn
    from aria_tpu_torch.data.datasets import iter_batches, mix_datasets
    from aria_tpu_torch.data.vision_processor import AriaVisionProcessor
    from aria_tpu_torch.train import loop
    from aria_tpu_torch.train.step import TrainState, make_optimizer, train_step

    cfg = cfg.replace(text=dataclasses.replace(
        cfg.text, moe_z_loss_coeff=recipe.moe_z_loss_coeff,
        moe_aux_loss_coeff=recipe.moe_aux_loss_coeff))
    dtype = torch.bfloat16 if recipe.dtype == "bfloat16" else torch.float32
    rows = list(mix_datasets(recipe.dataset_mixer, seed=recipe.seed)["train"])
    random.Random(recipe.seed).shuffle(rows)
    total = max(len(rows) // recipe.per_device_train_batch_size, 1) * recipe.num_train_epochs
    accum = max(recipe.gradient_accumulation_steps, 1)
    tc = loop._to_train_config(recipe, min(total, micro) // accum)
    params = loop.build_params(recipe, cfg, dtype, device)
    opt = make_optimizer(tc, params, accum)
    state = TrainState(params, opt.init(params), 0)
    init = {path: t.detach().clone() for path, t in opt.trainable(params)}
    tokenizer, images = loop.build_tokenizer(recipe), AriaVisionProcessor(
        max_image_size=recipe.max_image_size)
    lines = []
    for batch_rows in itertools.islice(iter_batches(rows, recipe.per_device_train_batch_size),
                                       micro):
        batch = loop._pad_batch(collate_fn(batch_rows, tokenizer, images,
                                           max_length=recipe.max_seq_length,
                                           max_image_size=recipe.max_image_size,
                                           split_image=recipe.split_image),
                                recipe.max_seq_length, tokenizer.pad_token_id)
        _sync(device)
        t0 = time.perf_counter()
        state, metrics = train_step(state, loop._device_batch(batch, device), cfg, tc, opt)
        line = {k: float(v) for k, v in metrics.items()}
        _sync(device)
        lines.append({**line, "step_time_s": time.perf_counter() - t0})
    return state, lines, init


def run_train_mesh(device, gpu="", cfg=None, seq=TRAIN_MESH_SEQ, steps=2, layers=2, batch=8,
                   world=8):
    """train-mesh: recipes/config_full.yaml with its mesh as written (fsdp 2
    x expert 4), 8 ranks on cuda:0 over gloo, through ``train_on_ranks``'
    rank body: full width, ``layers`` decoder layers, the whole ViT frozen,
    the recipe's batch of 8 with every 2nd row a 980px image, ``steps``
    optimizer steps (2 accumulated micro steps each) at ``seq`` tokens.
    ``gmm``, ``gmm_dlhs``, ``tgmm``, ``split_hi_lo``, the flash forward and
    backward and ``vit_flash`` must launch on every rank. Printed: each
    micro step's ms, each rank's peak and resident parameter and optimizer
    bytes beside one rank's, the collectives' share of the steps. Held
    against one rank's ``train()`` steps on the same global batches and
    weights (``_hold_train_mesh``): every micro step's loss, aux loss and
    grad_norm, the optimizer's moments and each trainable leaf's change in
    the checkpoint rank 0 wrote, loaded on one rank. Returns rank 0's
    launches."""
    import shutil
    import tempfile

    import torch

    from aria_tpu_torch import AriaConfig
    from aria_tpu_torch.checkpoint.io import latest_step, load_checkpoint
    from aria_tpu_torch.data.tokenizer import ByteTokenizer
    from aria_tpu_torch.parallel.distributed import run_ranks
    from aria_tpu_torch.train import loop
    from aria_tpu_torch.train.recipe import load_recipe

    cuda = device.type == "cuda"
    cfg = (cfg or AriaConfig.aria_25b()).replace(image_token_id=ByteTokenizer().image_token_id)
    small = cfg.replace(text=dataclasses.replace(cfg.text, num_layers=layers))
    recipe = load_recipe(os.path.join(HERE, "recipes", "config_full.yaml"))
    if (recipe.mesh_fsdp, recipe.mesh_expert) != (2, 4):
        raise AssertionError("recipes/config_full.yaml's mesh is no longer fsdp 2 x expert 4")
    micro = steps * recipe.gradient_accumulation_steps
    work = tempfile.mkdtemp(prefix="aria_train_mesh_")
    try:
        ds = os.path.join(work, "ds")
        # rows that fit 512 tokens with their answer (an image row's 980px
        # image is 256 of them)
        _train_dataset(ds, micro * batch, 2, SEED + 16, words=(40, 8, 20))
        recipe = dataclasses.replace(recipe, per_device_train_batch_size=batch,
                                     dataset_mixer={ds: 1}, max_seq_length=seq,
                                     output_dir=os.path.join(work, "mesh"))
        fsdp, expert = recipe.mesh_fsdp, recipe.mesh_expert
        print(f"train-mesh (recipes/config_full.yaml, mesh fsdp {fsdp} x expert {expert} as "
              f"written): {fsdp * expert} ranks on one card over gloo; {layers} decoder layers "
              f"(cut from {cfg.text.num_layers}), the ViT frozen (as the recipe says); batch "
              f"{batch} x {seq} (max_seq_length cut from 2048: 8 ranks' logits do not fit), "
              f"every 2nd row a 980px image; {steps} optimizer steps of "
              f"{recipe.gradient_accumulation_steps} micro steps", flush=True)
        if cuda:
            free, total = torch.cuda.mem_get_info(device)
            print(f"  before the ranks start: {free / 2**30:.2f} of {total / 2**30:.2f} GiB free "
                  f"on the card, this process holding {torch.cuda.memory_reserved() / 2**30:.2f} "
                  f"GiB", flush=True)
        t0 = time.perf_counter()
        outs = run_ranks(_train_mesh_rank, world, recipe, small, micro, device.type,
                         backend="gloo", timeout_s=1200)
        mesh_s = time.perf_counter() - t0
        lines = [json.loads(line) for line in
                 open(os.path.join(recipe.output_dir, "metrics.jsonl"))]
        for line in lines:
            print(f"  train-mesh micro step {line['step']}: {line['step_time_s'] * 1e3:.1f} ms, "
                  f"loss {line['loss']:.5f}, aux {line['aux_loss']:.6f}, grad_norm "
                  f"{line['grad_norm']:.5f} ({gpu})", flush=True)
        for r, o in enumerate(outs):
            print(f"  [rank {r}] peak {o['peak_bytes'] / 2**30:.2f} GiB of its share "
                  f"{o['share'] / 2**30:.2f} GiB, parameters "
                  f"{o['param_bytes'] / 2**30:.3f} GiB, optimizer {o['opt_bytes'] / 2**30:.3f} "
                  f"GiB; collectives {o['coll_s']:.2f} s of {o['run_s']:.2f} s (set-up "
                  f"included), {o['coll_calls']} calls, {o['coll_bytes'] / 2**30:.2f} GiB sent, "
                  f"the largest {o['biggest'][0] / 2**20:.1f} MiB ({o['biggest'][1]})",
                  flush=True)
        for r, o in enumerate(outs):
            for name in ("gmm", "gmm_dlhs", "tgmm", "split_hi_lo", "flash_causal",
                         "flash_causal_bwd", "vit_flash"):
                if cuda and o["launches"][name] <= 0:
                    raise AssertionError(f"train-mesh: {name} did not launch on rank {r}")
        print(f"  train-mesh launches on rank 0: "
              f"{ {k: v for k, v in outs[0]['launches'].items() if v} }", flush=True)
        if len(lines) != micro:
            raise AssertionError(f"train-mesh: {len(lines)} micro steps logged, not {micro}")

        # one rank on the same global batches and weights: train()'s steps
        # without its epoch-end save (the mesh's checkpoint is the one held)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        state, one_lines, init = _one_rank_steps(recipe, small, micro, device)
        ref = loop._rank_summary(state, device)
        print(f"  one rank: {time.perf_counter() - t1:.1f} s, micro steps "
              f"{[round(x['step_time_s'] * 1e3, 1) for x in one_lines]} ms; peak "
              f"{ref['peak_bytes'] / 2**30:.2f} GiB, parameters {ref['param_bytes'] / 2**30:.3f} "
              f"GiB, optimizer {ref['opt_bytes'] / 2**30:.3f} GiB (a mesh rank holds "
              f"{outs[0]['param_bytes'] / ref['param_bytes']:.3f} and "
              f"{outs[0]['opt_bytes'] / ref['opt_bytes']:.3f} of them); the mesh's "
              f"{fsdp * expert} ranks took {mesh_s:.1f} s with their start", flush=True)
        ckpt = os.path.join(recipe.output_dir, "checkpoints")
        saved, _ = load_checkpoint(ckpt, latest_step(ckpt), "cpu", mmap=True)
        failed = _hold_train_mesh(lines, one_lines, saved, state, init, micro)
        del state, saved, init
        if failed:
            raise AssertionError("train-mesh: " + "; ".join(failed))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return outs[0]["launches"]


# The mesh's run against one rank's on the same global batches and weights
# (bf16 both; they reduce each gradient in another order). Every logged micro
# step's loss and aux loss: 2e-3 relative (tests/test_parallel.py:289-318).
# Its grad_norm, the sharded norm of the gradients before clipping (a sum
# over ``expert`` multiplies the replicated leaves' by 4, half the batch moves
# it by O(1)): TRAIN_MESH_NORM relative. The optimizer's moments mu and nu in
# the checkpoint, leaf by leaf, the norm of the difference over the norm of
# one rank's: TRAIN_MESH_MOMENT (bf16 roundings of the gradients, and the
# routing they flip; a sum over ``expert`` reads O(1), since clipping no
# longer scales every leaf alike).
# Each trainable leaf's change from its initial value, projected on one
# rank's change: |1 - <mesh, one> / <one, one>| within TRAIN_MESH_CHANGE. At
# the recipe's lr of 5e-6 an Adam step moves a bf16 weight only where its
# ulp is below ~1e-5 (|w| < 2^-9), by about lr, with the sign of its
# update: the two runs differ where that sign does (an update near 0), which
# the norm of the difference counts in full (0.42-0.50 on the card with no
# fault in the change), the projection by its share. A change left out
# reads 1, one of the wrong sign 2, one twice too large 1. A leaf with fewer
# than TRAIN_MESH_CHANGED moved elements in one rank's run is held in the
# sum over all trainable leaves alone: a few elements' signs are noise there.
TRAIN_MESH_NORM = 1e-2
TRAIN_MESH_MOMENT = 0.2
TRAIN_MESH_CHANGE = 0.5
TRAIN_MESH_CHANGED = 10_000


def _hold_train_mesh(lines, one_lines, saved, state, init, micro) -> list:
    """The held checks of train-mesh (see the limits above); prints every
    reading and returns the failures."""
    import torch

    from aria_tpu_torch.train.step import leaves

    failed = []
    for i, (a, b) in enumerate(zip(lines, one_lines)):
        parts = []
        for key, limit in (("loss", 2e-3), ("aux_loss", 2e-3), ("grad_norm", TRAIN_MESH_NORM)):
            rel = abs(a[key] - b[key]) / abs(b[key])
            parts.append(f"{key} {a[key]:.6g} / {b[key]:.6g}, relative {rel:.2e} (limit "
                         f"{limit:.0e})")
            if not rel <= limit:
                failed.append(f"micro step {i + 1}'s {key} is {rel:.3e} off one rank's")
        print(f"  micro step {i + 1}, mesh / one rank: " + "; ".join(parts), flush=True)
    if saved["step"] != micro:
        failed.append(f"the checkpoint is at step {saved['step']}, not {micro}")
    got = dict(leaves(saved["params"]))
    for path, want in leaves(state.params):
        if got[path].shape != want.shape:
            failed.append(f"the checkpoint's {path} is {tuple(got[path].shape)}, not "
                          f"{tuple(want.shape)}")
    dev = next(iter(init.values())).device

    @torch.no_grad()
    def rel(a, b):  # |a - b| / |b| in f32
        d = float(torch.linalg.vector_norm((a.to(dev).float() - b.float())))
        n = float(torch.linalg.vector_norm(b.float()))
        return d / n if n else (0.0 if d == 0 else float("inf"))

    for moment in ("mu", "nu"):
        worst = max((rel(saved["opt_state"][moment][p], w), p)
                    for p, w in state.opt_state[moment].items())
        print(f"  optimizer {moment}, leaf by leaf: the largest |mesh - one rank| / |one rank| "
              f"{worst[0]:.3e} ({worst[1]}; limit {TRAIN_MESH_MOMENT:.0e})", flush=True)
        if not worst[0] <= TRAIN_MESH_MOMENT:
            failed.append(f"optimizer {moment} of {worst[1]} is {worst[0]:.3e} off one rank's")
    params = dict(leaves(state.params))
    held, dot, norm2, moved, differ, rows = [], 0.0, 0.0, 0, 0, []
    with torch.no_grad():
        for path, start in init.items():
            mine, want = got[path].to(dev), params[path].detach()
            dm, do = mine.float() - start.float(), want.float() - start.float()
            d, n2 = float((dm * do).sum()), float((do * do).sum())
            dot, norm2 = dot + d, norm2 + n2
            changed = int((want != start).sum())
            moved += changed
            differ += int((mine != want).sum())
            gap = abs(1 - d / n2) if n2 else (0.0 if not dm.any() else float("inf"))
            rows.append((gap, path, changed))
            if changed >= TRAIN_MESH_CHANGED:
                held.append((gap, path))
    total = abs(1 - dot / norm2) if norm2 else float("inf")
    worst = max(held) if held else (0.0, "none")
    print(f"  the checkpoint (step {saved['step']}, rank 0) loads on one rank; each trainable "
          f"leaf's change from its initial value projected on one rank's, |1 - <mesh, one "
          f"rank> / <one rank, one rank>|: all {len(init)} leaves together {total:.3e}, the "
          f"largest of the {len(held)} with >= {TRAIN_MESH_CHANGED} moved elements "
          f"{worst[0]:.3e} ({worst[1]}; limit {TRAIN_MESH_CHANGE} for both); one rank moved "
          f"{moved} elements, {differ} end elsewhere on the mesh", flush=True)
    print("  by leaf (|1 - projection|, moved elements): " + ", ".join(
        f"{p} {r:.3e} ({n})" for r, p, n in sorted(rows, reverse=True)[:8]), flush=True)
    if not total <= TRAIN_MESH_CHANGE:
        failed.append(f"the trainable leaves' change is {total:.3e} off one rank's")
    if not worst[0] <= TRAIN_MESH_CHANGE:
        failed.append(f"{worst[1]}'s change is {worst[0]:.3e} off one rank's")
    return failed


# ------------------------------------------------------------ the front doors

SAFETENSORS_NAMES = {"bfloat16": "BF16", "float16": "F16", "float32": "F32", "int8": "I8",
                     "uint8": "U8", "int32": "I32", "int64": "I64"}


def _write_safetensors(path: str, tensors: dict) -> int:
    """Write ``{name: tensor}`` as one .safetensors file (an 8-byte
    little-endian header length, the JSON header padded with spaces to 8
    bytes, then each tensor's bytes in order), without the ``safetensors``
    package, which the card's machine lacks. Returns the tensor bytes."""
    import struct

    import torch

    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": SAFETENSORS_NAMES[str(t.dtype).split(".")[1]],
                        "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            if t.numel():
                flat = t.detach().contiguous().reshape(-1).cpu()
                f.write(flat.view(torch.uint8).numpy().tobytes())
    return offset


# the int4 path's kernels that the HTTP requests must launch (phase 6f, a)
FRONT_PATH = ("dense_int4", "moe_decode_int4", "decode_attention", "rope_kv_write",
              "flash_causal", "moe_prefill_int4", "vit_flash")
FRONT_TOKENS = 32  # each greedy HTTP request's budget
FRONT_DROP_BUDGET = 256  # the dropped stream's budget, far past when it must be freed
FRONT_DROP_TICKS = 6  # scheduler ticks within which a dropped stream's lane is free
# (the budget takes 16: a few chunks go out before a write fails)
FRONT_IMPORT_LAYERS = 2  # decoder and ViT layers of the checkpoint the script writes
FRONT_PEAK_MARGIN = 3 * 2**30  # the streamed import's device peak below the whole one's


def _http(url, path, payload=None, timeout=600):
    """(json, wall s) of one GET (no payload) or POST."""
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        out = json.loads(r.read())
    return out, time.perf_counter() - t0


def _http_stream(url, path, payload, timeout=600):
    """(events, wall s, s to the first event) of one streamed POST."""
    import urllib.request

    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    events, first = [], None
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            if line == "data: [DONE]":
                break
            first = time.perf_counter() - t0 if first is None else first
            events.append(json.loads(line[len("data: "):]))
    return events, time.perf_counter() - t0, first


def _direct(engine, batch):
    """Serve ``batch`` ([(token ids, submit keywords)]) straight through
    the engine, every request submitted before the first tick (one
    admission group where their buckets agree). Returns [(request, wall s,
    s to its first read-back tokens)]."""
    t0 = time.perf_counter()
    reqs = []
    for ids, kw in batch:
        engine.submit(ids, **kw)
        reqs.append(engine.queue[-1])
    first, done = {}, {}
    while len(done) < len(reqs):
        finished = engine.step()
        now = time.perf_counter() - t0
        for r in reqs:
            if r.generated and r.uid not in first:
                first[r.uid] = now
        for r in finished:
            done[r.uid] = now
    return [(r, done[r.uid], first[r.uid]) for r in reqs]


def _hold_logprobs(label, tokens, lps, tops):
    """Each greedy token's logprob is its top-1 entry and top-1's id is the
    token, with LOGPROBS_K alternatives (phase 6e's check)."""
    if len(lps) != len(tokens) or len(tops) != len(tokens):
        raise AssertionError(f"{label}: {len(tokens)} tokens, {len(lps)} logprobs")
    for t, lp, top in zip(tokens, lps, tops):
        (best, best_lp), *_ = top.items()
        if int(best) != t or lp != best_lp or len(top) != LOGPROBS_K or not lp <= 0.0:
            raise AssertionError(f"{label}: token {t} logprob {lp}, top {top}")


def _png_data_url(side: int, seed: int) -> str:
    import base64
    import io

    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    img = Image.fromarray(rng.randint(0, 256, (side, side, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


class _Front:
    """A live ``ThreadingHTTPServer`` on 127.0.0.1 over a ``ServingLoop``
    whose scheduler ticks can be held (``gate``) and are counted
    (``ticks``), and whose ``submit_and_wait`` results are kept by prompt
    (``results``: the OpenAI routes return text, the loop the token ids)."""

    def __init__(self, engine, tokenizer):
        import threading

        from aria_tpu_torch.engine.http_server import HTTPServer, ServingLoop, make_handler

        self.engine, self.ticks, self.results = engine, 0, {}
        self.gate = threading.Event()
        self.gate.set()
        step = engine.step

        def gated_step():
            if not self.gate.is_set():
                return []
            self.ticks += 1
            return step()

        engine.step = gated_step  # the scheduler thread's only call into the engine
        self.loop = ServingLoop(engine, tokenizer)
        wait = self.loop.submit_and_wait

        def recorded(prompt, *args, **kw):
            out = wait(prompt, *args, **kw)
            self.results.setdefault(prompt, []).append(out)
            return out

        self.loop.submit_and_wait = recorded
        self.httpd = HTTPServer(("127.0.0.1", 0), make_handler(self.loop))
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_port}"

    def queued(self) -> int:
        with self.loop._lock:
            return len(self.engine.queue)

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.loop.shutdown()
        # the wrappers close cycles through the engine and the loop: undo them,
        # so that the model is freed with its last name (``del lm``)
        del self.engine.step, self.loop.submit_and_wait


def _drop_stream(front, payload) -> tuple[int, int]:
    """A streamed /generate whose client hangs up after its first chunk.
    Returns (scheduler ticks from the hang-up until ``/health`` reads no
    active lane, the request's generated tokens)."""
    import socket

    body = json.dumps({**payload, "stream": True}).encode()
    stats = front.loop.stats
    before = (stats["requests"], stats["generated_tokens"])
    sock = socket.create_connection(("127.0.0.1", front.httpd.server_port), timeout=600)
    sock.sendall(b"POST /generate HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Type: "
                 b"application/json\r\nContent-Length: " + str(len(body)).encode()
                 + b"\r\n\r\n" + body)
    seen = b""
    while b"data: " not in seen:
        seen += sock.recv(65536)
    sock.close()
    at = front.ticks
    t0 = time.perf_counter()
    while _http(front.url, "/health")[0]["active"]:
        if time.perf_counter() - t0 > 120:
            raise AssertionError("the dropped stream's lane is still active after 120 s")
        time.sleep(0.002)
    ticks = front.ticks - at
    while stats["requests"] == before[0]:  # the cancelled request leaves on the next tick
        if time.perf_counter() - t0 > 120:
            raise AssertionError("the dropped stream's request never finished")
        time.sleep(0.002)
    return ticks, stats["generated_tokens"] - before[1]


def run_frontdoor(device, gen, lm, cfg=None, gpu=""):
    """Phase 6f (a): the HTTP front door on the resident full-width int4
    model, with the ViT and the projector (int8, as bench.py builds them).
    ``ServingLoop(BatchedEngine(max_lanes=4, int8 KV, greedy, the JSON-mode
    FSM, logprobs_topk=5), ByteTokenizer())`` behind a
    ``ThreadingHTTPServer`` on 127.0.0.1. Each request is first served
    straight through the same engine (the same processed prompt, the same
    grouping), then over HTTP: a greedy /generate plainly and streamed (the
    streamed tokens equal the plain ones), 4 concurrent /v1/completions
    with logprobs (admitted as one group, as the straight ones were; each
    token's logprob its top-1 entry), a /v1/chat/completions carrying a
    980 px PNG as a base64 data URL, JSON mode greedy and twice at T 1.0
    (JSON objects, or live prefixes where the budget cut them), and a
    streamed request dropped after its first chunk, whose lane must be free
    within FRONT_DROP_TICKS ticks. Every greedy request's tokens equal the
    straight ones, and each FRONT_PATH kernel launches during the requests.
    Returns the requests' launch counts."""
    import numpy as np
    import torch

    from aria_tpu_torch import AriaConfig
    from aria_tpu_torch.data.processor import AriaProcessor
    from aria_tpu_torch.data.tokenizer import ByteTokenizer
    from aria_tpu_torch.engine.guided import json_dfa, json_fsm
    from aria_tpu_torch.engine.http_server import _chat_to_prompt
    from aria_tpu_torch.engine.server import BatchedEngine
    from aria_tpu_torch.models.projector import init_projector_params
    from aria_tpu_torch.models.vit import init_vit_params
    from aria_tpu_torch.ops.quant import quantize_projector_params, quantize_vit_params

    tok = ByteTokenizer()
    eos = tok.eos_token_id
    # the prompt's <|img|> is the tokenizer's id (cli/infer.py does the same)
    cfg = (cfg or AriaConfig()).replace(image_token_id=tok.image_token_id)
    text = cfg.text
    t0 = time.perf_counter()
    params = {"lm": lm,
              "vision": quantize_vit_params(init_vit_params(cfg.vision, gen, device=device)),
              "projector": quantize_projector_params(init_projector_params(
                  cfg.projector, gen, device=device))}
    jsonm = json_fsm(tok, [eos], vocab_size=text.vocab_size, device=device)
    jdfa = json_dfa()
    engine = BatchedEngine(params, cfg, max_lanes=4, max_seq_len=1024, temperature=0.0,
                           decode_chunk=16, cache_dtype=torch.int8, rng_seed=SEED,
                           guided_fsm=jsonm, logprobs_topk=LOGPROBS_K)
    print(f"front door: ViT and projector (int8), JSON-mode FSM ({jsonm.num_states} states) "
          f"and a 4-lane BatchedEngine (int8 KV, logprobs_topk {LOGPROBS_K}) on the "
          f"{text.num_layers}-layer int4 model, built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    rng = np.random.RandomState(SEED + 70)

    def words(n):  # n bytes of lowercase words: n ByteTokenizer ids
        return "".join(" " if i % 6 == 5 else chr(97 + rng.randint(26)) for i in range(n))

    proc = AriaProcessor(tok)

    def ids(prompt, images=None):
        out = proc(prompt, images=images, max_image_size=980)
        return out.input_ids[0].tolist(), out

    greedy = dict(max_new_tokens=FRONT_TOKENS, stop_token_ids=(eos,), temperature=0.0)
    plain_p, json_p = words(40), "a json object: " + words(25)
    conc_p = [words(40) for _ in range(4)]
    url_img = _png_data_url(980, SEED + 71)
    messages = [{"role": "user", "content": [{"type": "image_url", "image_url": {"url": url_img}},
                                             {"type": "text", "text": "describe the image"}]}]
    chat_p, images = _chat_to_prompt(messages)
    img_ids, img_out = ids(chat_p, images)
    json_kw = dict(greedy, max_new_tokens=GUIDED_TOKENS, guided=True)

    # straight through the engine, each group as the HTTP requests will come,
    # after a 2-token warm-up of each (the first image encode, grouped
    # prefill and guided step pay one-time costs)
    wrappers = _wrappers()
    batches = {"plain": [(ids(plain_p)[0], greedy)],
               "completions": [(ids(p)[0], greedy) for p in conc_p],
               "image": [(img_ids, dict(greedy, pixel_values=img_out.pixel_values,
                                        pixel_mask=img_out.pixel_mask))],
               "json": [(ids(json_p)[0], json_kw)]}
    with torch.inference_mode(), _no_chain(device, "the front door's straight requests"):
        for batch in batches.values():
            _direct(engine, [(i, dict(kw, max_new_tokens=2)) for i, kw in batch])
        direct = {name: _direct(engine, batch) for name, batch in batches.items()}
        direct = {name: d if name == "completions" else d[0] for name, d in direct.items()}
    front = _Front(engine, tok)
    url = front.url
    timings = {}
    for w in wrappers.values():  # count only what the HTTP requests launch
        w.launches = 0
    try:
        with _no_chain(device, "the front door's HTTP requests"):
            health, _ = _http(url, "/health")
            if health != {"status": "ok", "active": 0, "queued": 0}:
                raise AssertionError(f"/health before the requests: {health}")
            body = {"prompt": plain_p, "max_new_tokens": FRONT_TOKENS, "temperature": 0.0}
            plain, wall = _http(url, "/generate", body)
            timings["/generate"] = (len(plain["tokens"]), wall, None, ("plain", 0))
            events, wall, first = _http_stream(url, "/generate", {**body, "stream": True})
            streamed = [t for ev in events for t in ev["tokens"]]
            timings["/generate, streamed"] = (len(streamed), wall, first, ("plain", 0))
            if streamed != plain["tokens"] or plain["tokens"] != direct["plain"][0].generated:
                raise AssertionError(f"/generate: streamed {streamed}, plain {plain['tokens']}, "
                                     f"straight {direct['plain'][0].generated}")

            # 4 concurrent completions, held until all four are queued: one group
            import threading

            outs = [None] * 4

            def complete(i):
                outs[i] = _http(url, "/v1/completions", {
                    "prompt": conc_p[i], "max_tokens": FRONT_TOKENS, "temperature": 0.0,
                    "logprobs": LOGPROBS_K})

            front.gate.clear()
            threads = [threading.Thread(target=complete, args=(i,)) for i in range(4)]
            for th in threads:
                th.start()
            t_wait = time.perf_counter()
            while front.queued() < 4:
                if time.perf_counter() - t_wait > 120:
                    raise AssertionError("the 4 concurrent completions were not all queued")
                time.sleep(0.001)
            front.gate.set()
            for th in threads:
                th.join()
            for i, p in enumerate(conc_p):
                (res,), (resp, wall) = front.results[p], outs[i]
                req = direct["completions"][i][0]
                timings[f"/v1/completions #{i}"] = (len(res["tokens"]), wall, None,
                                                    ("completions", i))
                if res["tokens"] != req.generated or res["logprobs"] != req.logprobs:
                    raise AssertionError(f"completion {i}: {res['tokens']} against the "
                                         f"straight {req.generated}")
                _hold_logprobs(f"completion {i}", res["tokens"], res["logprobs"],
                               res["top_logprobs"])
                choice = resp["choices"][0]
                if (choice["text"] != res["text"]
                        or len(choice["logprobs"]["token_logprobs"]) != len(res["tokens"])):
                    raise AssertionError(f"completion {i}: the response's text or logprobs "
                                         "differ from the loop's")

            chat, wall = _http(url, "/v1/chat/completions", {
                "messages": messages, "max_tokens": FRONT_TOKENS, "temperature": 0.0})
            (res,) = front.results[chat_p]
            timings["/v1/chat/completions, 980 px image"] = (len(res["tokens"]), wall, None,
                                                             ("image", 0))
            if (res["tokens"] != direct["image"][0].generated
                    or chat["choices"][0]["message"]["content"] != res["text"]):
                raise AssertionError(f"image chat: {res['tokens']} against the straight "
                                     f"{direct['image'][0].generated}")

            jbody = {"prompt": json_p, "max_tokens": GUIDED_TOKENS,
                     "response_format": {"type": "json_object"}}
            _, wall = _http(url, "/v1/completions", {**jbody, "temperature": 0.0})
            (res,) = front.results[json_p]
            timings["/v1/completions, JSON mode"] = (len(res["tokens"]), wall, None,
                                                     ("json", 0))
            if res["tokens"] != direct["json"][0].generated:
                raise AssertionError(f"JSON mode: {res['tokens']} against the straight "
                                     f"{direct['json'][0].generated}")
            ended = [_hold_json("HTTP JSON mode, greedy", res["tokens"], eos, jdfa)]
            for i in range(2):
                _http(url, "/v1/completions", {**jbody, "temperature": 1.0})
                ended.append(_hold_json(f"HTTP JSON mode, T 1.0, #{i}",
                                        front.results[json_p][i + 1]["tokens"], eos, jdfa))

            ticks, dropped = _drop_stream(front, {"prompt": words(40),
                                                  "max_new_tokens": FRONT_DROP_BUDGET,
                                                  "temperature": 0.0})
            metrics, _ = _http(url, "/metrics")
    finally:
        front.close()
    launches = {name: w.launches for name, w in wrappers.items()}
    print(f"  /health: {health}; /metrics after the requests: "
          f"{ {k: round(v, 3) if isinstance(v, float) else v for k, v in metrics.items()} }",
          flush=True)
    # the straight requests again, after: the host-bound steps' wall drifts
    # within a run, so the HTTP walls are read against both
    with torch.inference_mode():
        after = {name: _direct(engine, batch) for name, batch in batches.items()}
    for name, (n, wall, first, (key, i)) in timings.items():
        req, d_wall, d_first = (direct[key][i] if key == "completions" else direct[key])
        _, a_wall, a_first = after[key][i]
        if after[key][i][0].generated != req.generated:
            raise AssertionError(f"{name}: the straight request after the HTTP ones gave "
                                 "other tokens")
        mean = (d_wall + a_wall) / 2
        first_s = "" if first is None else f", first chunk {first * 1e3:.1f} ms"
        print(f"  {name}: {n} tokens over HTTP in {wall * 1e3:.1f} ms ({n / wall:.2f} tok/s"
              f"{first_s}); straight through the engine before / after {d_wall * 1e3:.1f} / "
              f"{a_wall * 1e3:.1f} ms ({len(req.generated) / mean:.2f} tok/s, first read-back "
              f"{d_first * 1e3:.1f} / {a_first * 1e3:.1f} ms): the front door's cost "
              f"{(wall - mean) * 1e3:.1f} ms ({gpu})", flush=True)
    print(f"  every greedy request's tokens equal the straight ones (the 4 completions' "
          f"logprobs too, each its top-1 entry); the stream equals /generate; JSON mode: "
          f"{sum(ended)} of 3 ended as JSON objects, the rest live prefixes", flush=True)
    print(f"  the stream dropped after its first chunk: its lane free {ticks} scheduler ticks "
          f"after the hang-up (limit {FRONT_DROP_TICKS}), {dropped} of its "
          f"{FRONT_DROP_BUDGET} tokens generated", flush=True)
    if ticks > FRONT_DROP_TICKS or dropped >= FRONT_DROP_BUDGET:
        raise AssertionError(f"the dropped stream ran on: {ticks} ticks, {dropped} tokens")
    print(f"  launches: { {n: c for n, c in launches.items() if c} }", flush=True)
    for name in FRONT_PATH:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the HTTP requests")
    return launches


def _rss_anon_kb() -> tuple[int, str]:
    """(kB, what was read): this process's resident anonymous memory,
    RssAnon of /proc/self/status; where the kernel gives none (a container's
    may not), the C heap's allocated bytes, glibc's ``mallinfo2`` (arena
    and mmapped chunks: where torch and numpy keep host arrays)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("RssAnon:"):
                    return int(line.split()[1]), "RssAnon"
    except OSError:
        pass
    import ctypes

    class Mallinfo2(ctypes.Structure):
        _fields_ = [(n, ctypes.c_size_t) for n in (
            "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks", "fsmblks",
            "uordblks", "fordblks", "keepcost")]

    libc = ctypes.CDLL(None)
    libc.mallinfo2.argtypes, libc.mallinfo2.restype = [], Mallinfo2
    info = libc.mallinfo2()
    return (info.uordblks + info.hblkhd) // 1024, "the C heap in use (mallinfo2: no RssAnon)"


@contextlib.contextmanager
def _rss_anon_peak():
    """Samples ``_rss_anon_kb`` every 2 ms; yields a dict whose ``peak_kb``
    is the largest sample above the one taken at entry, and ``source`` what
    was read."""
    import threading

    base, source = _rss_anon_kb()
    out = {"peak_kb": 0, "source": source}
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            out["peak_kb"] = max(out["peak_kb"], _rss_anon_kb()[0] - base)
            stop.wait(0.002)

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    try:
        yield out
    finally:
        stop.set()
        th.join()
        out["peak_kb"] = max(out["peak_kb"], _rss_anon_kb()[0] - base)


def _write_hf_checkpoint(path, cfg, gen, device) -> dict:
    """An HF-layout bf16 Aria checkpoint of ``cfg``'s shape, drawn on the
    card from ``gen`` (normal / sqrt(fan in); norms 1, biases 0), one
    shard per decoder layer plus head, vision and projector shards.
    Returns {shard: bytes}."""
    import torch

    tc, vc, pc = cfg.text, cfg.vision, cfg.projector

    def w(*shape, fan=None):
        fan = fan or shape[-1]
        return (torch.randn(shape, generator=gen, device=device) * fan**-0.5).to(torch.bfloat16)

    def const(value, *shape):
        return torch.full(shape, value, dtype=torch.bfloat16, device=device)

    D, V, H, Dh = tc.hidden_size, tc.vocab_size, tc.num_heads, tc.head_dim
    E, I, Is = tc.num_experts, tc.moe_intermediate_size, tc.shared_intermediate_size
    shards = {}
    for i in range(tc.num_layers):
        p = f"language_model.model.layers.{i}."
        shards[f"model-layer-{i:02d}.safetensors"] = {
            p + "self_attn.q_proj.weight": w(H * Dh, D),
            p + "self_attn.k_proj.weight": w(tc.num_kv_heads * Dh, D),
            p + "self_attn.v_proj.weight": w(tc.num_kv_heads * Dh, D),
            p + "self_attn.o_proj.weight": w(D, H * Dh),
            p + "mlp.router.weight": w(E, D),
            p + "mlp.experts.fc1.weight": w(E, D, 2 * I, fan=D),
            p + "mlp.experts.fc2.weight": w(E, I, D, fan=I),
            p + "mlp.shared_experts.gate_proj.weight": w(Is, D),
            p + "mlp.shared_experts.up_proj.weight": w(Is, D),
            p + "mlp.shared_experts.down_proj.weight": w(D, Is),
            p + "input_layernorm.weight": const(1.0, D),
            p + "post_attention_layernorm.weight": const(1.0, D),
        }
    shards["model-head.safetensors"] = {
        "language_model.model.embed_tokens.weight": w(V, D),
        "language_model.model.norm.weight": const(1.0, D),
        "language_model.lm_head.weight": w(V, D)}
    vd, vf, vt = vc.hidden_size, vc.intermediate_size, "vision_tower.vision_model."
    vis = {vt + "embeddings.patch_embedding.weight": w(vd, 3, vc.patch_size, vc.patch_size,
                                                       fan=3 * vc.patch_size**2),
           vt + "embeddings.patch_embedding.bias": const(0.0, vd),
           vt + "embeddings.position_embedding.weight": w(vc.patches_per_side**2, vd)}
    for i in range(vc.num_layers):
        p = f"{vt}encoder.layers.{i}."
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
            vis[p + f"self_attn.{nm}.weight"] = w(vd, vd)
            vis[p + f"self_attn.{nm}.bias"] = const(0.0, vd)
        for nm in ("layer_norm1", "layer_norm2"):
            vis[p + f"{nm}.weight"], vis[p + f"{nm}.bias"] = const(1.0, vd), const(0.0, vd)
        vis.update({p + "mlp.fc1.weight": w(vf, vd), p + "mlp.fc1.bias": const(0.0, vf),
                    p + "mlp.fc2.weight": w(vd, vf), p + "mlp.fc2.bias": const(0.0, vd)})
    shards["model-vision.safetensors"] = vis
    pe, mp = pc.embed_dim, "multi_modal_projector."
    shards["model-projector.safetensors"] = {
        mp + "query": w(pc.max_queries, pe),
        mp + "cross_attn.q_proj.weight": w(pe, pe),
        mp + "cross_attn.k_proj.weight": w(pe, pc.kv_dim),
        mp + "cross_attn.v_proj.weight": w(pe, pc.kv_dim),
        mp + "cross_attn.multihead_attn.in_proj_weight": w(3 * pe, pe),
        mp + "cross_attn.multihead_attn.in_proj_bias": const(0.0, 3 * pe),
        mp + "cross_attn.multihead_attn.out_proj.weight": w(pe, pe),
        mp + "cross_attn.multihead_attn.out_proj.bias": const(0.0, pe),
        mp + "cross_attn.linear.weight": w(pe, pe),
        mp + "cross_attn.linear.bias": const(0.0, pe),
        mp + "cross_attn.layer_norm.weight": const(1.0, pe),
        mp + "cross_attn.layer_norm.bias": const(0.0, pe),
        mp + "cross_attn.ln_kv.weight": const(1.0, pc.kv_dim),
        mp + "cross_attn.ln_kv.bias": const(0.0, pc.kv_dim),
        mp + "ln_ffn.weight": const(1.0, pe),
        mp + "ln_ffn.bias": const(0.0, pe),
        mp + "ffn.linear_in.weight": w(pc.ff_dim, pe),
        mp + "ffn.linear_out.weight": w(pc.output_dim, pc.ff_dim)}
    written = {}
    for name, tensors in shards.items():  # a shard's tensors live on the card until written
        written[name] = _write_safetensors(os.path.join(path, name), tensors)
        del tensors
    return written


def _trees_equal(got, want, path="") -> int:
    """Bit-equal, leaf for leaf (keys, dtypes, shapes, bits); returns the
    number of leaves."""
    import torch

    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(want):
            raise AssertionError(f"{path}: keys differ")
        return sum(_trees_equal(got[k], want[k], f"{path}/{k}") for k in want)
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(
            got.contiguous().view(ints[got.element_size()]),
            want.contiguous().view(ints[want.element_size()])):
        raise AssertionError(f"{path}: {got.dtype} {tuple(got.shape)} against {want.dtype} "
                             f"{tuple(want.shape)}, or other bits")
    return 1


def run_frontdoor_imports(device, gen, cfg=None, gpu=""):
    """Phase 6f (b), after the int4 model is freed: the HF imports and
    ``cli/serve.py`` at full width and FRONT_IMPORT_LAYERS decoder and ViT
    layers. The script writes an HF-layout bf16 checkpoint (its own
    safetensors writer) into a temporary directory, then on the card: the
    whole import (``import_hf_checkpoint``) and its int4 serving transform
    (``quantize_lm_params_int4(fuse_shared_experts(...))``), and the streamed
    import (``import_hf_lm_serving_int4``), which must equal it bit for bit
    on every leaf with a device peak at least FRONT_PEAK_MARGIN below the
    whole path's; each with its seconds, GB/s read, device peak and host
    RssAnon peak. Then ``cli/serve.py``'s builder makes its default engine
    (the int8 form) from the directory and answers one /v1/completions over
    HTTP, whose greedy tokens equal ``Engine.generate``'s on the same
    params. The directory is removed. Returns the HTTP request's launch
    counts."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from aria_tpu_torch import AriaConfig
    from aria_tpu_torch.checkpoint.io import import_hf_checkpoint, import_hf_lm_serving_int4
    from aria_tpu_torch.cli import serve
    from aria_tpu_torch.engine.generate import Engine, GenerationConfig
    from aria_tpu_torch.ops.quant import fuse_shared_experts, quantize_lm_params_int4

    cfg = cfg or AriaConfig()
    cut = cfg.replace(text=dataclasses.replace(cfg.text, num_layers=FRONT_IMPORT_LAYERS),
                      vision=dataclasses.replace(cfg.vision, num_layers=FRONT_IMPORT_LAYERS))
    path = tempfile.mkdtemp(prefix="chip_smoke_hf_")
    try:
        t0 = time.perf_counter()
        written = _write_hf_checkpoint(path, cut, gen, device)
        total = sum(written.values())
        lm_bytes = sum(n for name, n in written.items()
                       if name.startswith(("model-layer-", "model-head")))
        print(f"front door imports: an HF-layout bf16 checkpoint of {len(written)} shards, "
              f"{total / 1e9:.3f} GB ({lm_bytes / 1e9:.3f} GB of decoder), "
              f"{FRONT_IMPORT_LAYERS} decoder and ViT layers at full width, written in "
              f"{time.perf_counter() - t0:.1f} s (so its pages are warm in the host's cache)",
              flush=True)

        cuda = device.type == "cuda"

        def measured(label, nbytes, fn):
            _sync(device)
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated() if cuda else 0
            with _rss_anon_peak() as rss:
                t = time.perf_counter()
                out = fn()
                _sync(device)
                sec = time.perf_counter() - t
            peak = torch.cuda.max_memory_allocated() - base if cuda else 0
            print(f"  {label}: {sec:.2f} s, {nbytes / sec / 1e9:.2f} GB/s read (warm), device "
                  f"peak {peak / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB resident, host "
                  f"peak {rss['peak_kb'] / 2**20:.3f} GiB above entry, read as {rss['source']} "
                  f"({gpu})",
                  flush=True)
            return out, peak

        def whole():
            params = import_hf_checkpoint(path, cut, device=device)
            return quantize_lm_params_int4(fuse_shared_experts(
                params, cut.text.num_shared_experts)["lm"])

        want, whole_peak = measured(
            "whole import then quantize_lm_params_int4(fuse_shared_experts(...))", total, whole)
        got, stream_peak = measured(
            "streamed int4 import (import_hf_lm_serving_int4)", lm_bytes,
            lambda: import_hf_lm_serving_int4(path, cut.text, device=device))
        leaves = _trees_equal(got, want)
        print(f"  the streamed import equals quantize-after-import bit for bit on all {leaves} "
              f"leaves; its device peak {stream_peak / 2**30:.2f} GiB against "
              f"{whole_peak / 2**30:.2f} GiB (held at least {FRONT_PEAK_MARGIN / 2**30:.0f} GiB "
              "below on the card)", flush=True)
        if cuda and not stream_peak <= whole_peak - FRONT_PEAK_MARGIN:
            raise AssertionError(f"streamed import device peak {stream_peak} against the whole "
                                 f"import's {whole_peak}")
        del got, want

        t0 = time.perf_counter()
        args = serve.parse_args(["--model-path", path, "--max-lanes", "2", "--max-seq-len",
                                 "1024", "--host", "127.0.0.1", "--port", "0",
                                 "--device", str(device)])
        engine, tok = serve.build(args, cfg=cut)
        _sync(device)
        print(f"  cli/serve.py's builder (default int8 form, imported a layer at a time): "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        prompt = " ".join(np.random.RandomState(SEED + 72).choice(
            ["red", "green", "blue", "cat", "dog", "sun", "moon", "tree"], 50))  # > 128 ids
        wrappers = _wrappers()
        front = _Front(engine, tok)
        for w in wrappers.values():  # count only what the served request launches
            w.launches = 0
        try:
            with _no_chain(device, "the served request"):
                resp, wall = _http(front.url, "/v1/completions", {
                    "prompt": prompt, "max_tokens": FRONT_TOKENS, "temperature": 0.0})
            launches = {name: w.launches for name, w in wrappers.items()}
        finally:
            front.close()
        (res,) = front.results[prompt]
        ids = tok.encode(prompt)
        ref = Engine(engine.params, engine.cfg, max_seq_len=1024).generate(
            ids, GenerationConfig(max_new_tokens=FRONT_TOKENS, temperature=0.0,
                                  stop_token_ids=(tok.eos_token_id,)))
        print(f"  /v1/completions over HTTP ({len(ids)}-token prompt): {len(res['tokens'])} "
              f"tokens in {wall * 1e3:.1f} ms; Engine.generate on the same params "
              f"{'gives the same tokens' if ref.tokens == res['tokens'] else 'differs'}; "
              f"launches { {n: c for n, c in launches.items() if c} } ({gpu})", flush=True)
        if ref.tokens != res["tokens"] or resp["choices"][0]["text"] != res["text"]:
            raise AssertionError(f"the served tokens {res['tokens']} against Engine.generate's "
                                 f"{ref.tokens}")
        _check_form_path("frontdoor-serve", launches, "int8", image=False)
        return launches
    finally:
        shutil.rmtree(path, ignore_errors=True)


def main() -> int:
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    try:
        from aria_tpu_torch import AriaConfig
        from aria_tpu_torch.ops import _build
    except ImportError as exc:
        print(f"chip_smoke: the aria_tpu_torch package is missing: {exc}", file=sys.stderr)
        return 1

    device = torch.device("cuda", 0)
    gpu = _gpu_info()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {gpu}", flush=True)

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.library()

    def gen(phase):  # each phase draws from its own seeded stream
        return torch.Generator(device=device).manual_seed(SEED + phase)

    def done(phase, since):
        torch.cuda.synchronize()
        gc.collect()  # a model a phase left in a reference cycle is freed here, not later
        torch.cuda.empty_cache()
        print(f"phase {phase}: {time.perf_counter() - since:.1f} s", flush=True)
        return time.perf_counter()

    t0 = done("build", t0)
    # the 8 ranks fill the card: they run while this process holds the least
    # of it (after the other phases it holds ~1.1 GiB more, and a rank ran
    # out of memory there)
    train_mesh = run_train_mesh(device, gpu=gpu)
    t0 = done("train-mesh", t0)
    with torch.inference_mode():
        results = check_kernels(device, gen(2))
    check_train_kernels(device, gen(9), results)
    check_segment_bwd(device, gen(14), results)
    t0 = done("kernels", t0)
    # the serving paths' model: full width, SERVING_LAYERS deep
    serve = AriaConfig()
    serve = serve.replace(text=dataclasses.replace(serve.text, num_layers=SERVING_LAYERS))
    lm, text_launches = run_slice(device, gen(3), serve, gpu=gpu)
    t0 = done("text", t0)
    launches = {"text": text_launches, "train-mesh": train_mesh}
    launches["image"], image_headline = run_image(device, gen(4), lm, serve, gpu=gpu)
    t0 = done("image", t0)
    launches["lanes"], lanes_headline = run_lanes(device, lm, serve, gpu=gpu)
    t0 = done("lanes", t0)
    launches["paged"] = run_paged(device, lm, serve, gpu=gpu)
    t0 = done("paged", t0)
    launches["adapters"] = run_adapters(device, gen(10), lm, serve, gpu=gpu)
    t0 = done("adapters", t0)
    launches.update(run_variants(device, gen(11), lm, serve, gpu=gpu, default_image=image_headline,
                                 default_lanes=lanes_headline))
    t0 = done("variants", t0)
    launches["serving"] = run_serving(device, lm, serve, gpu=gpu)
    t0 = done("serving", t0)
    launches["frontdoor"] = run_frontdoor(device, gen(12), lm, serve, gpu=gpu)
    del lm  # the forms' models do not fit beside the int4 one
    t0 = done("frontdoor (HTTP)", t0)
    launches["frontdoor-serve"] = run_frontdoor_imports(device, gen(13), gpu=gpu)
    t0 = done("frontdoor (imports, cli/serve.py)", t0)
    launches["cp"] = run_cp(gpu=gpu)
    t0 = done("cp", t0)
    launches["ep-serve"] = run_ep_serve(gpu=gpu)
    t0 = done("ep-serve", t0)
    launches.update(run_forms(device, gen(7), serve, gpu=gpu))
    t0 = done("forms", t0)
    launches.update(run_train(device, gen(8), gpu=gpu))
    done("train", t0)
    for name in KERNELS:
        if not any(launches[path][name] for path in PATHS):
            raise AssertionError(f"{name} was launched on no path")

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": next(launches[path][name] for path in PATHS if launches[path][name]),
         "launches_by_path": {path: launches[path][name] for path in PATHS},
         **results[name]}
        for name, (src, rep) in KERNELS.items()]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
