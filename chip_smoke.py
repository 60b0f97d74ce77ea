#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``aria_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. Device: the card's name and power limit.
2. Build the hand kernels from ``aria_tpu_torch/csrc`` (nvcc, sm_90a) and
   hold each against its plain PyTorch version at the shapes the serving
   path gives it, with the tolerance stated beside each, timing both with
   CUDA events.
3. The slice: random-init the full-width 28-layer, 64+2-expert int4
   serving model on the card, build ``Engine(max_seq_len=1024, int8 KV)``
   and answer three requests through ``Engine.generate``. Every kernel's
   launch counter must rise during this phase.

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


def check_kernels(device, gen, cfg=None, S=1024):
    """Phase 2: each kernel against its plain version at the slice's shapes.
    Returns {kernel name: {"max_abs_err", "ms", "plain_ms"}} (worst case
    over the shapes checked, times at the decode shape)."""
    import torch

    from aria_tpu_torch import TextConfig
    from aria_tpu_torch.ops import decode_attention as da
    from aria_tpu_torch.ops import dense_int4 as di
    from aria_tpu_torch.ops import flash as fl
    from aria_tpu_torch.ops import moe_decode_kernel as mk
    from aria_tpu_torch.ops.quant import quantize_dense_int4, quantize_expert_int4

    cfg = cfg or TextConfig()
    D, H, Dh, I = cfg.hidden_size, cfg.num_heads, cfg.head_dim, cfg.moe_intermediate_size
    E = cfg.num_experts + cfg.num_shared_experts
    results = {}

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    def record(name, errs, kernel, plain):
        results[name] = {"max_abs_err": max(errs), "ms": kernel[0], "plain_ms": plain[0]}
        print(f"  {name}: device time per call: kernel {kernel[0]:.4f} ms, plain "
              f"{plain[0]:.4f} ms; wall per call: kernel {kernel[1]:.4f} ms, plain "
              f"{plain[1]:.4f} ms", flush=True)

    # dense_int4: wqkv (F = 7680) and wo (F = 2560) at decode (T = 1) and
    # at the 64- and 128-token prompt buckets
    print("dense_int4", flush=True)
    errs, times = [], {}
    for F in ((cfg.num_heads + 2 * cfg.num_kv_heads) * Dh, D):
        w = quantize_dense_int4(randn(2, D, F, scale=D**-0.5))
        for T in (1, 64, 128):
            x = randn(T, D)
            got, ref = di.dense_int4(x, w, 1), di.dense_int4_plain(x, w, 1)
            errs.append(_compare(f"dense_int4 T={T} F={F}", got, ref, 1e-4,
                                 "both f32 sums of exact products; order differs"))
            if T == 1 and F != D:
                times = (_time_ms(lambda: di.dense_int4(x, w, 1), 200),
                         _time_ms(lambda: di.dense_int4_plain(x, w, 1), 20))
    record("dense_int4", errs, *times)  # wqkv at T = 1
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
            times = (_time_ms(lambda: mk.moe_decode_int4(*args), 100),
                     _time_ms(lambda: mk.moe_decode_int4_plain(*args), 5))
    record("moe_decode_int4", errs, *times)  # T = 1
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
    record("decode_attention", errs,  # int8 cache, 1000 positions
           _time_ms(lambda: da.decode_attention(*args), 200),
           _time_ms(lambda: da.decode_attention_plain(*args), 20))
    del kf, vf, kq, vq

    # flash_causal at the 64- and 128-token prompt buckets (and a ragged S)
    print("flash_causal", flush=True)
    errs = []
    for S in (64, 128, 37):
        qkv = [randn(1, S, H, Dh) for _ in range(3)]
        got, ref = fl.flash_causal(*qkv), fl.flash_causal_plain(*qkv)
        errs.append(_compare(f"flash_causal S={S}", got, ref, 1e-2,
                             "bf16 output; both round p to bf16 before p.v, the plain "
                             "version after normalising it"))
    qkv = [randn(1, 64, H, Dh) for _ in range(3)]
    record("flash_causal", errs,  # S = 64
           _time_ms(lambda: fl.flash_causal(*qkv), 200),
           _time_ms(lambda: fl.flash_causal_plain(*qkv), 50))
    return results


KERNELS = {
    "dense_int4": ("aria_tpu_torch/csrc/dense_int4.cu", "aria_tpu/ops/dense_int4.py:124"),
    "moe_decode_int4": ("aria_tpu_torch/csrc/moe_decode.cu",
                        "aria_tpu/ops/moe_decode_kernel.py:450"),
    "decode_attention": ("aria_tpu_torch/csrc/decode_attention.cu",
                         "aria_tpu/ops/decode_attention.py:208"),
    "flash_causal": ("aria_tpu_torch/csrc/flash.cu", "aria_tpu/ops/flash.py:30"),
}


def _wrappers():
    from aria_tpu_torch.ops.decode_attention import decode_attention
    from aria_tpu_torch.ops.dense_int4 import dense_int4
    from aria_tpu_torch.ops.flash import flash_causal
    from aria_tpu_torch.ops.moe_decode_kernel import moe_decode_int4

    return {"dense_int4": dense_int4, "moe_decode_int4": moe_decode_int4,
            "decode_attention": decode_attention, "flash_causal": flash_causal}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def run_slice(device, gen, cfg=None, gpu=""):
    """Phase 3: the serving path through ``Engine.generate`` on the random
    full-width int4 model. Returns each kernel's launch count in it."""
    ref_layers = 2
    import numpy as np
    import torch

    from aria_tpu_torch import AriaConfig
    from aria_tpu_torch.engine.generate import Engine, GenerationConfig
    from aria_tpu_torch.models.moe_lm import (KVCache, embed_tokens,
                                              init_lm_params_serving_int4, lm_forward)

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
    for w in wrappers.values():  # count only what the serving path launches
        w.launches = 0
    results = []
    for name, prompt, gcfg in requests:
        r = engine.generate(prompt, gcfg)
        results.append(r)
        print(f"  request {name}: {len(r.tokens)} tokens, prefill {r.prefill_s * 1e3:.1f} ms, "
              f"decode {r.tokens_per_s:.2f} tok/s ({gpu})", flush=True)
    launches = {name: w.launches for name, w in wrappers.items()}
    print(f"  launches in the slice: {launches}", flush=True)

    for (name, _, gcfg), r in zip(requests, results):
        if len(r.tokens) != gcfg.max_new_tokens:
            raise AssertionError(f"{name}: {len(r.tokens)} tokens, wanted {gcfg.max_new_tokens}")
        if not all(0 <= t < text.vocab_size for t in r.tokens):
            raise AssertionError(f"{name}: token out of range")
    if results[0].tokens != results[1].tokens:
        raise AssertionError("the repeated greedy request gave another stream")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched by the serving path")

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
        # reference: the first layers on the CPU through the plain versions
        cut = dataclasses.replace(text, num_layers=ref_layers)
        small = {**lm, "layers": _tree_map(lambda v: v[:ref_layers].contiguous(), lm["layers"])}
        small_cpu = _tree_map(lambda v: v.cpu(), small)
        x = torch.tensor([prompt100[:16]], device=device)
        got = lm_forward(small, cut, x).logits.float().cpu()
        ref = lm_forward(small_cpu, cut, x.cpu()).logits.float()
        # witness of how far bf16-level differences alone carry: the same CPU
        # run with one bf16 ulp added to the magnitude of a random half of
        # the embedding entries (no kernel involved)
        emb = embed_tokens(small_cpu["embed"], x.cpu())
        nudge = torch.rand(emb.shape, generator=torch.Generator().manual_seed(SEED)) < 0.5
        emb = torch.where(nudge, (emb.view(torch.int16) + 1).view(torch.bfloat16), emb)
        ulp = lm_forward(small_cpu, cut, inputs_embeds=emb).logits.float()

        def rel_err(a, b):
            return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()

        def top1(a, b):
            return (a.argmax(-1) == b.argmax(-1)).float().mean().item()

        rel, witness = rel_err(got, ref), rel_err(ulp, ref)
        # a wrong scale, layout or mask is an O(1) error; bf16 rounding that
        # differs between card and CPU flips single int8 roundings of the
        # W4A8 MoE, which the witness measures without any kernel
        print(f"  reference ({ref_layers} layers, 16 tokens, CPU plain versions): relative "
              f"logit error {rel:.3e} (limit 5e-2), top-1 agreement {top1(got, ref):.3f}; "
              f"witness, CPU with one bf16 ulp on half the embeddings: relative error "
              f"{witness:.3e}, top-1 agreement {top1(ulp, ref):.3f}", flush=True)
        if not rel <= 5e-2:
            raise AssertionError(f"reference logits differ: relative error {rel}")
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

    gen = torch.Generator(device=device).manual_seed(SEED)
    with torch.inference_mode():
        results = check_kernels(device, gen)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    launches = run_slice(device, gen, gpu=gpu)
    torch.cuda.synchronize()

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **results[name]}
        for name, (src, rep) in KERNELS.items()]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
