#!/usr/bin/env python3
"""Image-to-first-token of the port's serving forms, for two checkouts on
one card, in turns (A, B, B, A).

    python3 tools/first_token_ab.py PARENT_DIR CHANGE_DIR [--runs 5]

Each turn is a fresh process that imports ``aria_tpu_torch`` from the
directory given, builds its kernels there, and serves bench.py's image
request (one 980px crop, prompt [11]*8 + [9]*256 + [13]*8, greedy, one new
token) through ``Engine.generate`` on the int4 form (int8 ViT, projector
and lm_head, int8 KV) and then on the int8 form (bf16 ViT and projector,
bf16 KV), both at full width and depth with random weights from a seed: a
warm-up request, then ``--runs`` timed ones. It prints each form's
``prefill_s`` in ms (min, median, max) per turn, the card's name and power
limit, and one JSON line per turn.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys


def serve(runs: int) -> dict:
    import numpy as np
    import torch

    from aria_tpu_torch import AriaConfig
    from aria_tpu_torch.engine.generate import Engine, GenerationConfig
    from aria_tpu_torch.models.moe_lm import init_lm_params_serving, init_lm_params_serving_int4
    from aria_tpu_torch.models.projector import init_projector_params
    from aria_tpu_torch.models.vit import init_vit_params
    from aria_tpu_torch.ops.quant import quantize_projector_params, quantize_vit_params

    cfg, dev = AriaConfig(), torch.device("cuda")
    pixels = np.random.RandomState(0).randint(0, 256, (1, 3, 980, 980), dtype=np.uint8)
    prompt = [11] * 8 + [cfg.image_token_id] * 256 + [13] * 8
    one = GenerationConfig(max_new_tokens=1, temperature=0.0)
    out = {}
    for form in ("int4", "int8"):
        gen = torch.Generator(device=dev).manual_seed(0)
        if form == "int4":
            params = {"lm": init_lm_params_serving_int4(cfg.text, gen, device=dev),
                      "vision": quantize_vit_params(init_vit_params(cfg.vision, gen, device=dev)),
                      "projector": quantize_projector_params(
                          init_projector_params(cfg.projector, gen, device=dev))}
            kv = torch.int8
        else:
            params = {"lm": init_lm_params_serving(cfg.text, gen, form="int8", device=dev),
                      "vision": init_vit_params(cfg.vision, gen, device=dev),
                      "projector": init_projector_params(cfg.projector, gen, device=dev)}
            kv = torch.bfloat16
        engine = Engine(params, cfg, max_seq_len=1024, cache_dtype=kv, rng_seed=0)
        engine.generate(prompt, one, pixel_values=pixels)  # warm-up
        out[form] = [engine.generate(prompt, one, pixel_values=pixels).prefill_s * 1e3
                     for _ in range(runs)]
        del engine, params
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="*")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--serve", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.serve:  # one turn, in the checkout on sys.path
        print(json.dumps(serve(args.runs)), flush=True)
        return 0
    if len(args.dirs) != 2:
        ap.error("give two checkout directories")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {gpu}", flush=True)
    a, b = (os.path.abspath(d) for d in args.dirs)
    for label, root in (("A", a), ("B", b), ("B", b), ("A", a)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--serve", "--runs",
                               str(args.runs)], cwd=root, capture_output=True, text=True,
                              env={**os.environ, "PYTHONPATH": root})
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, flush=True)
            return proc.returncode
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        for form, ms in times.items():
            print(f"{label} ({root}) {form} form: image-to-first-token ms min {min(ms):.1f}, "
                  f"median {statistics.median(ms):.1f}, max {max(ms):.1f}", flush=True)
        print(json.dumps({"turn": label, "dir": root, "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
