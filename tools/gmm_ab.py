#!/usr/bin/env python3
"""Device times of the port's ragged grouped matmuls, for two checkouts on
one card, in turns (A, B, B, A).

    python3 tools/gmm_ab.py PARENT_DIR CHANGE_DIR [--iters 10]

Each turn is a fresh process that imports ``aria_tpu_torch`` from the
directory given, builds its kernels there, and times on random inputs from
a seed, the flagship's experts (D 2560, I 1664; four groups empty, the
others random and straddling 128-row tiles) in the w1 ([E, 2I, D],
transpose_rhs) and w2 ([E, I, D]) layouts:

- the subject, ``gmm``, the forward: at M = 4,096 rows in 66 experts (the
  image prefill's 512 x 8 slots), 16,384 and 98,304 in 64 (the full
  recipe's 2048 x 8 x 6), beside ``torch._grouped_mm`` with bf16 and, where
  the card's torch takes it, f32 output (gmm gives f32);
- the controls at 98,304 rows: the cotangent split (``split_hi_lo``) and
  ``gmm_dlhs`` and ``tgmm`` given the split, for a bf16-exact cotangent
  (w1's in training: the f32 upcast of a bf16 gradient) and a 16-bit one
  (w2's: a bf16 gradient times a bf16 combine weight), each with a hash of
  its output's bits: the two checkouts must agree.

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

D, I = 2560, 1664
FORWARD = ((4096, 66), (16384, 64), (98304, 64))  # (rows, experts)
CONTROL_ROWS, CONTROL_E = 98304, 64


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


def _sizes(gen, M: int, E: int):
    import torch

    w = torch.rand(E, generator=gen, device=gen.device)
    w[[0, 7, 40, 41]] = 0
    sizes = torch.floor(w / w.sum() * M).to(torch.int32)
    sizes[E - 1] += M - int(sizes.sum())
    return sizes


def _bits(t) -> str:
    import torch

    raw = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
    return hashlib.sha256(raw.cpu().numpy().tobytes()).hexdigest()[:16]


def measure(iters: int) -> dict:
    import torch

    from aria_tpu_torch.ops import moe as tmoe

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    lib = getattr(torch, "_grouped_mm", None)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    def layouts(E, trans):
        K, N = (D, 2 * I) if trans else (I, D)  # the forward's contraction and output
        rhs = randn(E, N, K, scale=K**-0.5) if trans else randn(E, K, N, scale=K**-0.5)
        return K, N, rhs, (rhs.transpose(1, 2) if trans else rhs)

    out = {}
    for M, E in FORWARD:
        sizes = _sizes(gen, M, E)
        offs = torch.cumsum(sizes, 0).to(torch.int32)
        for label, trans in (("w1", True), ("w2", False)):
            K, N, rhs, rhs_kn = layouts(E, trans)
            lhs = randn(M, K)
            rec = {"ms": _device_ms(lambda: tmoe.gmm(lhs, rhs, sizes, trans), iters)}
            if lib is not None:
                rec["library_bf16_ms"] = _device_ms(lambda: lib(lhs, rhs_kn, offs=offs), iters)
                try:
                    lib(lhs, rhs_kn, offs=offs, out_dtype=torch.float32)
                    rec["library_f32_ms"] = _device_ms(
                        lambda: lib(lhs, rhs_kn, offs=offs, out_dtype=torch.float32), iters)
                except (RuntimeError, TypeError, ValueError) as exc:
                    rec["library_f32"] = f"refused: {str(exc).splitlines()[0][:80]}"
            out[f"gmm {label} M={M} E={E}"] = rec
            del rhs, rhs_kn, lhs
            torch.cuda.empty_cache()

    M, E = CONTROL_ROWS, CONTROL_E
    sizes = _sizes(gen, M, E)
    for label, trans in (("w1", True), ("w2", False)):
        K, N, rhs, _ = layouts(E, trans)
        lhs = randn(M, K)
        grads = {"bf16-exact": randn(M, N).float(),
                 "16-bit": (randn(M, N).float() * randn(M, 1).float()).contiguous()}
        for kind, grad in grads.items():
            at = f"{label} M={M} {kind}"
            sp = tmoe.split_hi_lo(grad)
            out[f"split {at}"] = {"ms": _device_ms(lambda: tmoe.split_hi_lo(grad), iters),
                                  "bits": _bits(torch.cat([sp[0], sp[1]]))}
            d = tmoe.gmm_dlhs(grad, rhs, sizes, not trans, split=sp)
            out[f"gmm_dlhs {at}"] = {
                "ms": _device_ms(lambda: tmoe.gmm_dlhs(grad, rhs, sizes, not trans, split=sp),
                                 iters), "bits": _bits(d)}
            t = tmoe.tgmm(lhs, grad, sizes, split=sp)
            out[f"tgmm {at}"] = {
                "ms": _device_ms(lambda: tmoe.tgmm(lhs, grad, sizes, split=sp), iters),
                "bits": _bits(t)}
            del sp, d, t
        del grads, rhs, lhs
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="*")
    ap.add_argument("--iters", type=int, default=10)
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
    bits = {}
    for label, root in (("A", a), ("B", b), ("B", b), ("A", a)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", "--iters",
                               str(args.iters)], cwd=root, capture_output=True, text=True,
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
