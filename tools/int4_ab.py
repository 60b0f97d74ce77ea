#!/usr/bin/env python3
"""Device times of the port's int4 and int8 serving kernels, for two
checkouts on one card, in turns (A, B, B, A).

    python3 tools/int4_ab.py PARENT_DIR CHANGE_DIR [--iters 20] [--only NAME ...]

with the parent unpacked from git into a directory that .gitignore lists,
for example ``mkdir -p tmp/parent && git archive HEAD~1 | tar -x -C
tmp/parent``, then ``python3 tools/int4_ab.py tmp/parent .`` from the root
of the change's checkout, on the machine with the card.

Each turn is a fresh process that imports ``aria_tpu_torch`` from the
directory given, builds its kernels there, and times on random inputs from
a seed, at the flagship's widths (D 2560, I 1664, 64 routed experts top-6
plus 2 shared):

- ``dense_int4`` (bf16 activations) for wqkv (F 7680) and wo (F 2560) at
  T = 1, 32, 512, 2048 and 4096 rows, and beside each prefill shape
  ``torch.matmul`` of x by the weight already dequantized to bf16 (a
  yardstick of what the unpacking costs, not a call of the same function);
- ``dense_int4_a8`` (the W4A8 form) for wqkv and wo at T = 1, 8 and 32,
  each with a hash of its output's bits, which the two checkouts must agree
  on (both are bit-equal to the same plain version);
- ``moe_decode_int4`` in its W4A8 form and in its bf16-activation form
  (``moe_decode_int4_bf16``) at T = 1, 32 and 128 rows, one layer of 66
  experts;
- ``moe_decode_quant`` at T = 1, 32 and 128 rows on one layer of 66 int8
  experts;
- ``moe_prefill_int4`` on the same layer at T = 512, 2048 and 4096 rows
  (each token's slots scattered into the padded expert segments by the
  checkout's own ``segment_dispatch``, whose fourth value the kernel
  takes), the routing drawn from the seed after the cases above, so both
  checkouts time the same tiles;
- the controls, kernels neither checkout should change, each with a hash
  of its output's bits that the two checkouts must agree on: the W4A8
  ``moe_decode_int4`` (T = 32) and ``moe_decode`` (bf16 experts, T = 32, 66
  experts).

``--only`` keeps the cases whose name holds one of the words given (for
example ``--only dense_int4_a8``); the controls always run. The cases keep
their order and draw their inputs from the seed in the same order whatever
is kept, so a kept case sees the same inputs either way.

Times are the card's kernel time per call from ``torch.profiler`` (the sum
over the call's kernels). It prints the card's name and power limit, one
line per case and turn, one JSON line per turn, and whether the controls'
bits agree in every turn (exit 1 where they do not).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

D, I, ROUTED, TOPK, SHARED = 2560, 1664, 64, 6, 2
DENSE = {"wqkv": 7680, "wo": 2560}
DENSE_T = (1, 32, 512, 2048, 4096)
A8_T = (1, 8, 32)
MOE_T = (1, 32, 128)
PREFILL_T = (512, 2048, 4096)


def _device_ms(fn, iters: int) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("the profile holds no device time")
    return us / iters / 1e3


def _bits(t) -> str:
    import torch

    raw = t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)
    return hashlib.sha256(raw.cpu().numpy().tobytes()).hexdigest()[:16]


def measure(iters: int, only=()) -> dict:
    import torch

    from aria_tpu_torch.ops import dense_int4 as di
    from aria_tpu_torch.ops import moe_decode_kernel as mk
    from aria_tpu_torch.ops import moe_prefill_kernel as mp
    from aria_tpu_torch.ops.quant import (dequantize_dense_int4, quantize_dense_int4,
                                          quantize_expert_int4, quantize_weight, with_s8)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    def want(case: str) -> bool:
        return case.startswith("control") or not only or any(o in case for o in only)

    out = {}
    for name, F in DENSE.items():
        w = quantize_dense_int4(randn(1, D, F, scale=D**-0.5))
        wbf = dequantize_dense_int4({"q4t": w["q4t"][0], "sg": w["sg"][0]})  # [D, F] bf16
        for T in sorted(set(DENSE_T) | set(A8_T)):
            x = randn(T, D)
            case = f"dense_int4 {name} T={T}"
            if T in DENSE_T and want(case):
                rec = {"ms": _device_ms(lambda: di.dense_int4(x, w, 0), iters)}
                if T >= 512:
                    rec["matmul_bf16_ms"] = _device_ms(lambda: torch.matmul(x, wbf), iters)
                out[case] = rec
            case = f"dense_int4_a8 {name} T={T}"
            if T in A8_T and want(case):
                out[case] = {
                    "ms": _device_ms(lambda: di.dense_int4(x, w, 0, act_int8=True), iters),
                    "bits": _bits(di.dense_int4(x, w, 0, act_int8=True))}
        del w, wbf
    E = ROUTED + SHARED

    def routing(T):
        logits = torch.randn((T, ROUTED), generator=gen, device=dev)
        top, idx = torch.topk(logits, TOPK, dim=-1)
        shared = torch.arange(ROUTED, E, device=dev).expand(T, -1)
        ind = torch.cat([idx, shared], 1).to(torch.int32)
        wts = torch.cat([torch.softmax(top, -1), torch.ones_like(shared, dtype=top.dtype)],
                        1).to(torch.bfloat16)
        return ind, wts

    w1, w2 = quantize_expert_int4(randn(1, E, 2 * I, D, scale=D**-0.5),
                                  randn(1, E, I, D, scale=I**-0.5))
    stacks = (w1["q4"], w1["sg"], w2["q4"], w2["s8"], 0)
    for T in MOE_T:
        ind, wts = routing(T)
        x = randn(T, D)
        case = f"{'control ' if T == 32 else ''}moe_decode_int4 W4A8 T={T}"
        if want(case):
            rec = {"ms": _device_ms(lambda: mk.moe_decode_int4(x, ind, wts, *stacks,
                                                                act_int8=True), iters)}
            if T == 32:
                rec["bits"] = _bits(mk.moe_decode_int4(x, ind, wts, *stacks, act_int8=True))
            out[case] = rec
        if want(f"moe_decode_int4_bf16 T={T}"):
            out[f"moe_decode_int4_bf16 T={T}"] = {
                "ms": _device_ms(lambda: mk.moe_decode_int4(x, ind, wts, *stacks), iters)}
    a, b = randn(1, E, 2 * I, D, scale=D**-0.5), randn(1, E, I, D, scale=I**-0.5)
    q1, q2 = with_s8(quantize_weight(a, input_axis=-1)), with_s8(quantize_weight(b, input_axis=-2))
    int8 = (q1["q"], q1["s8"], q2["q"], q2["s8"], 0)
    for T in MOE_T:
        ind, wts = routing(T)
        x = randn(T, D)
        if want(f"moe_decode_quant T={T}"):
            out[f"moe_decode_quant T={T}"] = {
                "ms": _device_ms(lambda: mk.moe_decode_quant(x, ind, wts, *int8), iters)}
        if T == 32:
            out["control moe_decode bf16 T=32"] = {
                "ms": _device_ms(lambda: mk.moe_decode(x, ind, wts, a, b, 0), iters),
                "bits": _bits(mk.moe_decode(x, ind, wts, a, b, 0))}
    del a, b, q1, q2, int8
    for T in PREFILL_T:
        logits = torch.randn((T, ROUTED), generator=gen, device=dev)
        idx = torch.topk(logits, TOPK, dim=-1).indices
        shared = torch.arange(ROUTED, E, device=dev).expand(T, -1)
        ind = torch.cat([idx, shared], 1).to(torch.int32)
        dest, tile_e, R, rows = mp.segment_dispatch(ind, E)
        x_seg = torch.zeros((R, D), dtype=torch.bfloat16, device=dev)
        x_seg[dest.long()] = randn(T, D).repeat_interleave(TOPK + SHARED, dim=0)
        if want(f"moe_prefill_int4 T={T}"):
            out[f"moe_prefill_int4 T={T}"] = {
                "ms": _device_ms(lambda: mp.moe_prefill_int4(x_seg, tile_e, *stacks, rows),
                                 iters)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="*")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", nargs="*", default=[])
    ap.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:  # one turn, in the checkout on sys.path
        print(json.dumps(measure(args.iters, args.only)), flush=True)
        return 0
    if len(args.dirs) != 2:
        ap.error("give two checkout directories")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {gpu}", flush=True)
    a, b = (os.path.abspath(d) for d in args.dirs)
    bits = {}
    for label, root in (("A", a), ("B", b), ("B", b), ("A", a)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", "--iters",
                               str(args.iters), "--only", *args.only], cwd=root,
                              capture_output=True, text=True,
                              env={**os.environ, "PYTHONPATH": root})
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, flush=True)
            return proc.returncode
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        for case, rec in times.items():
            extra = ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                              for k, v in rec.items() if k != "ms")
            print(f"{label} ({root}) {case}: {rec['ms']:.4f} ms" + (f"; {extra}" if extra else ""),
                  flush=True)
            if "bits" in rec:
                bits.setdefault(case, set()).add(rec["bits"])
        print(json.dumps({"turn": label, "dir": root, "ms": times}), flush=True)
    differ = sorted(case for case, seen in bits.items() if len(seen) > 1)
    print(f"controls' output bits: {'the same in every turn' if not differ else 'DIFFER: '}"
          f"{', '.join(differ)}", flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
