#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``aria_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. Device: the card's name and power limit.
2. Build the hand kernels from ``aria_tpu_torch/csrc`` (nvcc, sm_90a) and
   hold each against its plain PyTorch version at the shapes the serving
   path gives it, with the tolerance stated beside each, timing both.
3. The text path: random-init the full-width 28-layer, 64+2-expert int4
   serving model on the card, build ``Engine(max_seq_len=1024, int8 KV)``
   and answer three text requests through ``Engine.generate``; the four
   kernels of that path must each launch.
4. The image path (bench.py's default request): add the 27-layer ViT and
   the projector (int8, as bench.py builds them) and serve one 980px crop
   with the prompt [11]*8 + [9]*256 + [13]*8 through ``Engine.generate``;
   all six kernels must each launch. Then the image prefill's device time
   by kernel, and the card against the CPU's plain versions at reduced
   depth: ``encode_images`` with 2 ViT layers, and a 2-layer prefill over
   more than 128 tokens.

Any failure raises and exits non-zero; without a CUDA device the script
exits non-zero before printing any result. The line before the last is
the kernels' JSON record; the last line is the device record.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0


def _gpu_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int, warmup: int = 2) -> tuple[float, float]:
    """(device ms, wall ms) per call. Device time is the sum of the times of
    every kernel the call launched (the profiler's device events; its CPU
    events carry the same time again); wall time is CUDA
    events around back-to-back calls, which the host bounds when a call's
    launches take longer to issue than to run."""
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


def _compare(name, got, ref, tol: float, why: str) -> float:
    """max |got - ref| must be <= tol * max(1, max |ref|)."""
    import torch

    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    g, r = got.float(), ref.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (g - r).abs().max().item()
    bound = tol * max(1.0, r.abs().max().item())
    print(f"  {name}: max_abs_err {err:.3e} (limit {bound:.3e}: {why})", flush=True)
    if err > bound:
        raise AssertionError(f"{name}: max_abs_err {err} > {bound}")
    return err


def check_kernels(device, gen, cfg=None, S=1024, vision=None):
    """Phase 2: each kernel against its plain version at the slice's shapes.
    Returns {kernel name: {"max_abs_err", "ms", "plain_ms", "times"}}: the
    worst error over the shapes checked; "times" lists the device ms of
    kernel and plain version at each timed shape, and "ms"/"plain_ms" are
    its first entry (the decode shape for dense_int4 and the decode
    kernels, S = 64 for flash_causal, the image request's shape for the
    others; dense_int4 and flash_causal are timed at 512 rows too)."""
    import torch

    from aria_tpu.config import VisionConfig
    from aria_tpu_torch import TextConfig
    from aria_tpu_torch.ops import decode_attention as da
    from aria_tpu_torch.ops import dense_int4 as di
    from aria_tpu_torch.ops import flash as fl
    from aria_tpu_torch.ops import moe_decode_kernel as mk
    from aria_tpu_torch.ops import moe_prefill_kernel as mp
    from aria_tpu_torch.ops import vit_flash as vfl
    from aria_tpu_torch.ops.quant import quantize_dense_int4, quantize_expert_int4

    cfg = cfg or TextConfig()
    vision = vision or VisionConfig()
    D, H, Dh, I = cfg.hidden_size, cfg.num_heads, cfg.head_dim, cfg.moe_intermediate_size
    E = cfg.num_experts + cfg.num_shared_experts
    results = {}

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    def record(name, errs, timed):
        """timed: [(shape, kernel (device, wall) ms, plain (device, wall) ms)]"""
        results[name] = {"max_abs_err": max(errs), "ms": timed[0][1][0],
                         "plain_ms": timed[0][2][0],
                         "times": [{"at": at, "ms": k[0], "plain_ms": p[0]} for at, k, p in timed]}
        for at, k, p in timed:
            print(f"  {name} {at}: device time per call: kernel {k[0]:.4f} ms, plain "
                  f"{p[0]:.4f} ms; wall per call: kernel {k[1]:.4f} ms, plain "
                  f"{p[1]:.4f} ms", flush=True)

    # dense_int4: wqkv (F = 7680) and wo (F = 2560) at decode (T = 1), at
    # the 64- and 128-token prompt buckets and at the image prompt's 512
    print("dense_int4", flush=True)
    errs, timed = [], []
    for F in ((cfg.num_heads + 2 * cfg.num_kv_heads) * Dh, D):
        w = quantize_dense_int4(randn(2, D, F, scale=D**-0.5))
        for T in (1, 64, 128, 512):
            x = randn(T, D)
            got, ref = di.dense_int4(x, w, 1), di.dense_int4_plain(x, w, 1)
            errs.append(_compare(f"dense_int4 T={T} F={F}", got, ref, 1e-4,
                                 "both f32 sums of exact products; order differs"))
            if T in (1, 512):
                timed.append((f"T={T} F={F}",
                              _time_ms(lambda: di.dense_int4(x, w, 1), 200 if T == 1 else 20),
                              _time_ms(lambda: di.dense_int4_plain(x, w, 1), 20 if T == 1 else 5)))
    record("dense_int4", errs, timed)  # wqkv at T = 1 first
    del w

    # moe_decode_int4 (W4A8): 64 + 2 experts at full width, T = 1, 64, 128
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
    errs = []
    for T in (1, 64, 128):
        x = randn(T, D)
        logits = torch.randn((T, cfg.num_experts), generator=gen, device=device)
        top, idx = torch.topk(logits, cfg.moe_topk, dim=-1)
        shared = torch.arange(cfg.num_experts, E, device=device).expand(T, -1)
        indices = torch.cat([idx, shared], dim=1).to(torch.int32)
        weights = torch.cat([torch.softmax(top, -1), torch.ones_like(shared, dtype=top.dtype)], 1).to(x.dtype)
        args = (x, indices, weights, w1["q4"], w1["sg"], w2["q4"], w2["s8"], 1)
        got, ref = mk.moe_decode_int4(*args), mk.moe_decode_int4_plain(*args)
        errs.append(_compare(
            f"moe_decode_int4 T={T}", got, ref, 2e-2,
            "bf16 output rounding, plus one-step flips of the int8 h re-quantization "
            "where the f32 sum order differs"))
        if T == 1:
            timed = [("T=1", _time_ms(lambda: mk.moe_decode_int4(*args), 100),
                      _time_ms(lambda: mk.moe_decode_int4_plain(*args), 5))]
    record("moe_decode_int4", errs, timed)

    # moe_prefill_int4 on the same stacks: top-6 + 2 shared at T = 512 (the
    # image prompt's bucket) and T = 129, rows past the used tiles skipped
    print("moe_prefill_int4", flush=True)
    errs = []
    for T in (512, 129):
        logits = torch.randn((T, cfg.num_experts), generator=gen, device=device)
        _, idx = torch.topk(logits, cfg.moe_topk, dim=-1)
        shared = torch.arange(cfg.num_experts, E, device=device).expand(T, -1)
        indices = torch.cat([idx, shared], dim=1).to(torch.int32)
        dest, tile_e, R, rows_used = mp.segment_dispatch(indices, E)
        x_seg = torch.zeros((R, D), dtype=torch.bfloat16, device=device)
        x_seg[dest.long()] = randn(T, D).repeat_interleave(indices.shape[1], dim=0)
        args = (x_seg, tile_e, w1["q4"], w1["sg"], w2["q4"], w2["s8"], 1, rows_used)
        used = int(rows_used)
        got, ref = mp.moe_prefill_int4(*args), mp.moe_prefill_int4_plain(*args)
        errs.append(_compare(
            f"moe_prefill_int4 T={T} ({used // mp.TM} of {R // mp.TM} tiles used)",
            got[:used], ref[:used], 1e-2,
            "exact products, f32 sums in another order; h rounds to bf16 between the "
            "products on both sides, so a sum at a rounding edge moves by one bf16 ulp"))
        if T == 512:
            timed = [(f"T=512 ({used // mp.TM} tiles)",
                      _time_ms(lambda: mp.moe_prefill_int4(*args), 20),
                      _time_ms(lambda: mp.moe_prefill_int4_plain(*args), 3))]
    record("moe_prefill_int4", errs, timed)
    del w1, w2

    # decode_attention over a 1024-position cache, int8 and bf16
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
    lengths = torch.full((1,), S - 24, dtype=torch.int32, device=device)
    args = (q, kq, vq, 1, lengths, ks, vs)
    record("decode_attention", errs, [(
        f"int8 len={S - 24}", _time_ms(lambda: da.decode_attention(*args), 200),
        _time_ms(lambda: da.decode_attention_plain(*args), 20))])
    del kf, vf, kq, vq

    # flash_causal at the 64-, 128- and 512-token prompt buckets, and at a
    # ragged S below each of the short and the long ones
    print("flash_causal", flush=True)
    errs, timed = [], []
    for S in (64, 128, 37, 512, 509):
        qkv = [randn(1, S, H, Dh) for _ in range(3)]
        got, ref = fl.flash_causal(*qkv), fl.flash_causal_plain(*qkv)
        errs.append(_compare(f"flash_causal S={S}", got, ref, 1e-2,
                             "bf16 output; both round p to bf16 before p.v, the plain "
                             "version after normalising it"))
        if S in (64, 512):
            timed.append((f"S={S}", _time_ms(lambda: fl.flash_causal(*qkv), 200 if S == 64 else 50),
                          _time_ms(lambda: fl.flash_causal_plain(*qkv), 50 if S == 64 else 20)))
    record("flash_causal", errs, timed)  # S = 64 first
    del qkv

    # vit_flash over the 4,900 patches of a 980px crop, 16 heads of 72,
    # with every key valid and with half of them
    print("vit_flash", flush=True)
    P, VH, VD = vision.patches_per_side**2, vision.num_heads, vision.head_dim
    errs = []
    qkv = [randn(1, P, VH, VD) for _ in range(3)]
    for n in (P, P // 2):
        valid = torch.zeros((1, P), dtype=torch.bool, device=device)
        valid[0, :n] = True
        got, ref = vfl.vit_flash(*qkv, valid), vfl.vit_flash_plain(*qkv, valid)
        errs.append(_compare(
            f"vit_flash S={P} valid={n}", got[:, :n], ref[:, :n], 1e-2,
            "valid rows; bf16 output, p rounds to bf16 for p.v unnormalised in the "
            "kernel and normalised in the plain version"))
    valid = torch.ones((1, P), dtype=torch.bool, device=device)
    record("vit_flash", errs, [(
        f"S={P} all valid", _time_ms(lambda: vfl.vit_flash(*qkv, valid), 20),
        _time_ms(lambda: vfl.vit_flash_plain(*qkv, valid), 3))])
    return results


KERNELS = {
    "dense_int4": ("aria_tpu_torch/csrc/dense_int4.cu", "aria_tpu/ops/dense_int4.py:124"),
    "moe_decode_int4": ("aria_tpu_torch/csrc/moe_decode.cu",
                        "aria_tpu/ops/moe_decode_kernel.py:450"),
    "decode_attention": ("aria_tpu_torch/csrc/decode_attention.cu",
                         "aria_tpu/ops/decode_attention.py:208"),
    "flash_causal": ("aria_tpu_torch/csrc/flash.cu", "aria_tpu/ops/flash.py:30"),
    "vit_flash": ("aria_tpu_torch/csrc/vit_flash.cu", "aria_tpu/ops/vit_flash.py:91"),
    "moe_prefill_int4": ("aria_tpu_torch/csrc/moe_prefill.cu",
                         "aria_tpu/ops/moe_prefill_kernel.py:120"),
}
TEXT_PATH = ("dense_int4", "moe_decode_int4", "decode_attention", "flash_causal")


def _wrappers():
    from aria_tpu_torch.ops.decode_attention import decode_attention
    from aria_tpu_torch.ops.dense_int4 import dense_int4
    from aria_tpu_torch.ops.flash import flash_causal
    from aria_tpu_torch.ops.moe_decode_kernel import moe_decode_int4
    from aria_tpu_torch.ops.moe_prefill_kernel import moe_prefill_int4
    from aria_tpu_torch.ops.vit_flash import vit_flash

    return {"dense_int4": dense_int4, "moe_decode_int4": moe_decode_int4,
            "decode_attention": decode_attention, "flash_causal": flash_causal,
            "vit_flash": vit_flash, "moe_prefill_int4": moe_prefill_int4}


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
    for name, prompt, gcfg in requests:
        r = engine.generate(prompt, gcfg, **image)
        results.append(r)
        print(f"  request {name}: {len(r.tokens)} tokens, prefill {r.prefill_s * 1e3:.1f} ms, "
              f"decode {r.tokens_per_s:.2f} tok/s ({gpu})", flush=True)
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


def run_image(device, gen, lm, cfg=None, gpu=""):
    """Phase 4: bench.py's image request (bench.py:387-461) through
    ``Engine.generate``: one uint8 980px crop, the prompt [11]*8 + [9]*256 +
    [13]*8 (a 512-token bucket), int8 KV, the ViT and projector
    random-initialised and int8-quantized as bench.py builds them. Returns
    each kernel's launch count in this phase."""
    import numpy as np
    import torch

    from aria_tpu_torch import AriaConfig
    from aria_tpu_torch.engine.generate import Engine, GenerationConfig
    from aria_tpu_torch.models.aria import encode_images, normalize_pixels, prepare_embeddings
    from aria_tpu_torch.models.moe_lm import KVCache, lm_forward
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
    requests = [("image, T 0.8 top-k 200 (first call)", prompt, sampled),
                ("image, T 0.8 top-k 200", prompt, sampled),
                ("image greedy", prompt, greedy),
                ("image greedy again", prompt, greedy)]
    results, launches = _serve(engine, requests, _wrappers(), text.vocab_size, gpu,
                               pixel_values=pixels)
    if results[2].tokens != results[3].tokens:
        raise AssertionError("the repeated greedy image request gave another stream")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched by the image path")
    print(f"  image request (bench.py's): image-to-first-token {results[1].prefill_s * 1e3:.1f} "
          f"ms, decode {results[1].tokens_per_s:.2f} tok/s ({gpu})", flush=True)

    with torch.inference_mode():
        pv = torch.as_tensor(pixels, device=device)
        bucket = 512  # the engine's bucket for bench.py's 272-token prompt
        tokens = torch.zeros((1, bucket), dtype=torch.long, device=device)
        tokens[0, :len(prompt)] = torch.tensor(prompt)

        def encode():
            return encode_images(params, cfg, pv)

        def prefill(feats):
            embeds = prepare_embeddings(params, cfg, tokens, image_features=feats)
            cache = KVCache.init(text, 1, engine.max_seq_len, torch.int8, device=device)
            return lm_forward(lm, text, inputs_embeds=embeds,
                              positions=torch.arange(bucket, device=device), cache=cache,
                              cache_pos=0, logit_position=len(prompt) - 1,
                              causal_flash=True).logits

        feats = encode()
        logits = prefill(feats)
        if feats.shape != (1, n_q, text.hidden_size) or not torch.isfinite(feats).all():
            raise AssertionError(f"image features: shape {tuple(feats.shape)} or non-finite")
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite image prefill logits")
        if int(logits[0, 0].argmax()) != results[2].tokens[0]:
            raise AssertionError("image prefill argmax differs from the first greedy token")
        if device.type == "cuda":
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
                  f"{enc_ms:.1f} ms device; LM prefill (512 tokens) {(t2 - t1) * 1e3:.1f} ms "
                  f"wall, {pre_ms:.1f} ms device", flush=True)
            for label, ev in (("ViT + projector", enc_ev), ("LM prefill", pre_ev)):
                print(f"  device time by kernel, {label}:\n"
                      + ev.table(sort_by="self_device_time_total", row_limit=12), flush=True)

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
    return launches


def main() -> int:
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    try:
        from aria_tpu_torch.ops import _build
    except ImportError as exc:
        print(f"chip_smoke: the aria_tpu_torch package is missing: {exc}", file=sys.stderr)
        return 1

    device = torch.device("cuda", 0)
    gpu = _gpu_info()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {gpu}", flush=True)

    t0 = time.perf_counter()
    _build.build(verbose=True)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    _build.library()

    def gen(phase):  # each phase draws from its own seeded stream
        return torch.Generator(device=device).manual_seed(SEED + phase)

    with torch.inference_mode():
        results = check_kernels(device, gen(2))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    lm, text_launches = run_slice(device, gen(3), gpu=gpu)
    # bench.py's image request is the main path: its counts are "launches"
    launches = {"text": text_launches, "image": run_image(device, gen(4), lm, gpu=gpu)}
    torch.cuda.synchronize()

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches["image"][name],
         "launches_by_path": {path: counts[name] for path, counts in launches.items()},
         **results[name]}
        for name, (src, rep) in KERNELS.items()]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
