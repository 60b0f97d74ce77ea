#!/usr/bin/env python3
"""Device time of each launch of the decode MoE's three routed forms, at the
flagship's widths, on one card.

    PYTHONPATH=. python3 tools/moe_decode_probe.py [--iters 50]

from the root of a checkout, on the machine with the card. One layer of 64
routed experts top-6 plus 2 shared (D 2560, I 1664), random weights and
routing from a seed, at T = 1, 32 and 128 rows: ``moe_decode_int4_bf16``
and ``moe_decode_quant`` (csrc/moe_decode_bf16x.cu) and the W4A8
``moe_decode_int4`` (csrc/moe_decode.cu) beside them. For each, the sum of
the call's kernel times and each kernel's share, by name, from
``torch.profiler``; the card's name and power limit first. tools/int4_ab.py
times the same calls against another checkout.
"""

from __future__ import annotations

import argparse
import subprocess

D, I, ROUTED, TOPK, SHARED = 2560, 1664, 64, 6, 2


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from aria_tpu_torch.ops import moe_decode_kernel as mk
    from aria_tpu_torch.ops.quant import quantize_expert_int4, quantize_weight, with_s8

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {gpu}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    E = ROUTED + SHARED

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    w1, w2 = quantize_expert_int4(randn(1, E, 2 * I, D, scale=D**-0.5),
                                  randn(1, E, I, D, scale=I**-0.5))
    int4 = (w1["q4"], w1["sg"], w2["q4"], w2["s8"], 0)
    a, b = randn(1, E, 2 * I, D, scale=D**-0.5), randn(1, E, I, D, scale=I**-0.5)
    q1, q2 = with_s8(quantize_weight(a, input_axis=-1)), with_s8(quantize_weight(b, input_axis=-2))
    int8 = (q1["q"], q1["s8"], q2["q"], q2["s8"], 0)
    del a, b

    def by_kernel(fn) -> dict:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                fn()
            torch.cuda.synchronize()
        return {e.key: e.self_device_time_total / args.iters / 1e3 for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}

    for T in (1, 32, 128):
        top = torch.topk(torch.randn((T, ROUTED), generator=gen, device=dev), TOPK, dim=-1)
        shared = torch.arange(ROUTED, E, device=dev).expand(T, SHARED)
        ind = torch.cat([top.indices, shared], 1).to(torch.int32)
        wts = torch.cat([torch.softmax(top.values, -1), torch.ones((T, SHARED), device=dev)],
                        1).to(torch.bfloat16)
        x = randn(T, D)
        forms = (("moe_decode_int4_bf16", lambda: mk.moe_decode_int4_bf16(x, ind, wts, *int4)),
                 ("moe_decode_quant", lambda: mk.moe_decode_quant(x, ind, wts, *int8)),
                 ("moe_decode_int4 W4A8",
                  lambda: mk.moe_decode_int4(x, ind, wts, *int4, act_int8=True)))
        for name, fn in forms:
            ms = by_kernel(fn)
            parts = "; ".join(
                f"{k.replace('void ', '').replace('(anonymous namespace)::', '').split('(')[0]} "
                f"{v:.4f}" for k, v in ms.items())
            print(f"T={T} {name}: {sum(ms.values()):.4f} ms ({parts})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
