#!/usr/bin/env python3
"""Device time of ``dense_int4_a8`` by launch, and of ``paged_decode_attention``
at each split over positions, at the flagship's widths, on one card.

    PYTHONPATH=. python3 tools/a8_paged_probe.py [--iters 50]

from the root of a checkout, on the machine with the card. It prints the
card's name and power limit, then:

- ``dense_int4_a8`` for wqkv (F 7680) and wo (F 2560) at D 2560 and T = 1,
  8, 9 and 32 rows: the sum of the call's kernel times and each kernel's
  share by name (``torch.profiler``), whether the output is bit-equal to
  ``dense_int4_a8_plain``, and ``act_quant_int8`` launched alone at the same
  T (what quantizing x in its own launch costs: the split form, T <= 8,
  folds it into the kernel);
- ``paged_decode_attention`` over int8 and bf16 pages of 256 at the paged
  path's 32 lanes (lengths 48-511 of 512, tables shuffled over the pool)
  and at 4 lanes (400-511), 20 heads of 128, at each forced split P = 1, 2,
  4 and 8 and at the P the wrapper's plan picks, each with its largest
  difference from the plain version.
"""

from __future__ import annotations

import argparse
import json
import subprocess

D = 2560
DENSE = {"wqkv": 7680, "wo": 2560}
H, DH, PS, MAXP = 20, 128, 256, 2


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from aria_tpu_torch.ops import backend
    from aria_tpu_torch.ops import dense_int4 as di
    from aria_tpu_torch.ops import paged_attention as pg
    from aria_tpu_torch.ops._build import library
    from aria_tpu_torch.ops.quant import int4_group_count, quantize_dense_int4

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {gpu}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    def by_kernel(fn) -> dict:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        for _ in range(2):  # a profile with no device time was dropped: once more
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(args.iters):
                    fn()
                torch.cuda.synchronize()
            times = {}
            for e in prof.key_averages():
                if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total:
                    name = e.key.split("(")[0].split("::")[-1].split("<")[0]
                    times[name] = times.get(name, 0.0) + e.self_device_time_total / args.iters / 1e3
            if times:
                return times
        raise RuntimeError("the profiler recorded no kernel time, twice")

    out = {}
    lib, p, st = library(), backend.ptr, backend.stream
    for name, F in DENSE.items():
        w = quantize_dense_int4(randn(1, D, F, scale=D**-0.5))
        for T in (1, 8, 9, 32):
            x = randn(T, D)
            same = torch.equal(di.dense_int4_a8(x, w, 0), di.dense_int4_a8_plain(x, w, 0))
            times = by_kernel(lambda: di.dense_int4_a8(x, w, 0))
            xq = torch.empty((T, D), dtype=torch.int8, device=dev)
            sx = torch.empty((T, 8), dtype=torch.float32, device=dev)
            ng = int4_group_count(D)
            alone = by_kernel(lambda: lib.aria_act_quant_int8(p(x), p(xq), p(sx), T, D, ng, st()))
            rec = {"ms": sum(times.values()), "by_kernel": times, "bit_equal": same,
                   "act_quant_alone_ms": sum(alone.values())}
            out[f"dense_int4_a8 {name} T={T}"] = rec
            print(f"dense_int4_a8 {name} T={T}: {rec['ms']:.4f} ms "
                  f"({', '.join(f'{k} {v:.4f}' for k, v in times.items())}); act_quant_int8 "
                  f"alone {rec['act_quant_alone_ms']:.4f} ms; bit-equal to the plain version: "
                  f"{same}", flush=True)
        del w

    sms = backend.sm_count(dev)
    for lanes, lo in ((32, 48), (4, 400)):
        NP = 1 + lanes * MAXP
        shape = (2, NP, H, PS, DH)
        table = (torch.randperm(NP - 1, generator=gen, device=dev)[:lanes * MAXP] + 1)
        table = table.reshape(lanes, MAXP).to(torch.int32)
        lens = torch.linspace(lo, MAXP * PS - 1, lanes).round().int()
        lengths = lens.to(torch.int32).to(dev)
        q = randn(lanes, H, DH)
        plan = pg.paged_split_count(lanes, H, MAXP, PS, sms)
        for label in ("int8", "bf16"):
            if label == "int8":
                pages = [torch.randint(-128, 128, shape, generator=gen, device=dev,
                                       dtype=torch.int8) for _ in range(2)]
                pages += [torch.rand(shape[:-1], generator=gen, device=dev) * 0.02 + 0.005
                          for _ in range(2)]
            else:
                pages = [randn(*shape) for _ in range(2)]
            cache = pg.PagedKVCache(*pages)
            a = (q, cache, 1, table, lengths)
            ref = pg.paged_decode_attention_plain(*a).float()
            for P in (1, 2, 4, 8):
                got = pg.paged_decode_attention(*a, splits=P)
                err = (got.float() - ref).abs().max().item()
                ms = sum(by_kernel(lambda: pg.paged_decode_attention(*a, splits=P)).values())
                key = f"paged_decode_attention {label} B={lanes} len={lo}..{MAXP * PS - 1} P={P}"
                out[key] = {"ms": ms, "max_abs_err": err, "plan": P == plan}
                print(f"{key}: {ms:.4f} ms (all the call's kernels: the query's scaling "
                      f"too), max_abs_err {err:.3e}{' <- the plan' if P == plan else ''}",
                      flush=True)
            del cache, pages, a
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
