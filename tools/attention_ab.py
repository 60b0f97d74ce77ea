#!/usr/bin/env python3
"""Device times of the port's causal flash forward and decode attention, for
two checkouts on one card, in turns (A, B, B, A).

    python3 tools/attention_ab.py PARENT_DIR CHANGE_DIR [--iters 20]

Each turn is a fresh process that imports ``aria_tpu_torch`` from the
directory given, builds its kernels there, and times on random inputs from
a seed, 20 heads of 128 (the flagship's attention):

- ``flash_causal`` (serving form) at [1, 512], [8, 2048], [32, 64], [1, 8192]
  and [1, 32768], and with its row statistics at [1, 2048];
- ``decode_attention`` at one lane over 1,000 of 1,024 positions (int8,
  bf16), at 32 lanes over 48..320 of 384 (packed int4) and at one lane over
  32,768 of 32,896 (int4, int8, bf16);
- ``decode_attention_stats`` at one lane over one 4,352-position block
  (int8, bf16, int4);

with ``scaled_dot_product_attention`` beside each flash shape and each bf16
decode shape. Times are the card's kernel time per call from
``torch.profiler`` (the sum over the call's kernels). It prints the card's
name and power limit, one line per shape and turn, and one JSON line per
turn.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

H, D = 20, 128


def _device_ms(fn, iters: int) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / iters / 1e3


def measure(iters: int) -> dict:
    import torch
    import torch.nn.functional as F

    from aria_tpu_torch.ops import decode_attention as da
    from aria_tpu_torch.ops import flash as fl

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    out = {}
    for B, S, stats in ((1, 512, False), (1, 2048, True), (8, 2048, False), (32, 64, False),
                        (1, 8192, False), (1, 32768, False)):
        q, k, v = (randn(B, S, H, D) for _ in range(3))
        lse = torch.empty((B, H, S), dtype=torch.float32, device=dev) if stats else None
        n = iters if S <= 2048 else 3
        qt = [t.transpose(1, 2) for t in (q, k, v)]
        out[f"flash [{B}, {S}]" + (" with lse" if stats else "")] = {
            "ms": _device_ms(lambda: fl._forward(q, k, v, D**-0.5, lse), n),
            "sdpa_ms": _device_ms(lambda: F.scaled_dot_product_attention(*qt, is_causal=True), n)}
        del q, k, v, qt, lse

    # the caches of chip_smoke.py next to this tool, whichever checkout is timed
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    for B, S, lens, forms, fn in ((1, 1024, [1000], ("int8", "bf16"), "decode_attention"),
                                  (32, 384, None, ("int4",), "decode_attention"),
                                  (1, 32896, [32768], ("int4", "int8", "bf16"), "decode_attention"),
                                  (1, 4352, [4352], ("int8", "bf16", "int4"),
                                   "decode_attention_stats")):
        cs = smoke._decode_forms(dev, gen, randn, H, D, B, S)
        q = randn(B, H, D)
        if lens is None:
            lens = torch.linspace(48, 320, B).round().int().tolist()
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        for label in forms:
            c = cs[label]
            args = (q, c[0], c[1], 1, lengths, *c[2:])
            rec = {"ms": _device_ms(lambda: getattr(da, fn)(*args), iters)}
            if label == "bf16":
                mask = (torch.arange(S, device=dev) < lens[0])[None, None, None, :]
                rec["sdpa_ms"] = _device_ms(lambda: F.scaled_dot_product_attention(
                    q[:, :, None], c[0][1], c[1][1], attn_mask=mask), iters)
            out[f"{fn} {label} B={B} len={min(lens)}..{max(lens)} of {S}"] = rec
        del cs
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="*")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:  # one turn, in the checkout on sys.path
        print(json.dumps(measure(args.iters)), flush=True)
        return 0
    if len(args.dirs) != 2:
        ap.error("give two checkout directories")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {gpu}", flush=True)
    a, b = (os.path.abspath(d) for d in args.dirs)
    for label, root in (("A", a), ("B", b), ("B", b), ("A", a)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", "--iters",
                               str(args.iters)], cwd=root, capture_output=True, text=True,
                              env={**os.environ, "PYTHONPATH": root})
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, flush=True)
            return proc.returncode
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        for shape, rec in times.items():
            sdpa = f", sdpa {rec['sdpa_ms']:.4f} ms" if "sdpa_ms" in rec else ""
            print(f"{label} ({root}) {shape}: {rec['ms']:.4f} ms{sdpa}", flush=True)
        print(json.dumps({"turn": label, "dir": root, "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
