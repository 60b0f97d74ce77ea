#!/usr/bin/env python3
"""Device times of the port's ragged grouped matmuls, for two checkouts on
one card, in turns (A, B, B, A).

    python3 tools/gmm_ab.py PARENT_DIR CHANGE_DIR [--iters 10]

Each turn is a fresh process that imports ``aria_tpu_torch`` from the
directory given, builds its kernels there, and times on random inputs from
a seed, the flagship's experts (64 routed, D 2560, I 1664; four groups
empty, the others random and straddling 128-row tiles) at M = 16,384 and
98,304 rows (the full recipe's 2048 x 8 x 6), for the w1 ([E, 2I, D],
transpose_rhs) and w2 ([E, I, D]) layouts:

- ``gmm``, the forward (the control: unchanged code times the same in both
  checkouts when the card and host are);
- ``gmm_dlhs`` and ``tgmm`` as the backward calls them, for a bf16-exact
  cotangent (w1's in training: the f32 upcast of a bf16 gradient) and a
  16-bit one (w2's: a bf16 gradient times a bf16 combine weight). The
  public call's time (with its cotangent split where the checkout has
  one), and where the checkout has ``split_hi_lo``, the split alone and
  each kernel given the split;
- ``torch._grouped_mm`` beside each (bf16 operands, bf16 out);
- the causal flash forward at [8, 2048, 20, 128] with its row statistics,
  timed, with a hash of its output's bits: the two checkouts must agree.

Times are the card's kernel time per call from ``torch.profiler`` (the sum
over the call's kernels). It prints the card's name and power limit, one
line per case and turn, and one JSON line per turn.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

E, D, I = 64, 2560, 1664
ROWS = (16384, 98304)


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


def _sizes(gen, M: int):
    import torch

    w = torch.rand(E, generator=gen, device=gen.device)
    w[[0, 7, 40, 41]] = 0
    sizes = torch.floor(w / w.sum() * M).to(torch.int32)
    sizes[E - 1] += M - int(sizes.sum())
    return sizes


def measure(iters: int) -> dict:
    import torch

    from aria_tpu_torch.ops import flash as fl
    from aria_tpu_torch.ops import moe as tmoe

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    has_split = hasattr(tmoe, "split_hi_lo")
    lib = getattr(torch, "_grouped_mm", None)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    out = {}
    q, k, v = (randn(8, 2048, 20, 128) for _ in range(3))
    lse = torch.empty((8, 20, 2048), dtype=torch.float32, device=dev)
    o = fl._forward(q, k, v, 128**-0.5, lse)
    out["flash [8, 2048] with lse"] = {
        "ms": _device_ms(lambda: fl._forward(q, k, v, 128**-0.5, lse), iters),
        "bits": hashlib.sha256(o.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]}
    del q, k, v, lse, o

    for M in ROWS:
        sizes = _sizes(gen, M)
        offs = torch.cumsum(sizes, 0).to(torch.int32)
        for label, trans in (("w1", True), ("w2", False)):
            K, N = (D, 2 * I) if trans else (I, D)  # the forward's contraction and output
            rhs = randn(E, N, K, scale=K**-0.5) if trans else randn(E, K, N, scale=K**-0.5)
            lhs = randn(M, K)
            rhs_kn = rhs.transpose(1, 2) if trans else rhs
            rec = {"ms": _device_ms(lambda: tmoe.gmm(lhs, rhs, sizes, trans), iters)}
            if lib is not None:
                rec["library_ms"] = _device_ms(lambda: lib(lhs, rhs_kn, offs=offs), iters)
            out[f"gmm {label} M={M}"] = rec
            grads = {"bf16-exact": randn(M, N).float(),
                     "16-bit": (randn(M, N).float() * randn(M, 1).float()).contiguous()}
            for kind, grad in grads.items():
                at = f"{label} M={M} {kind}"
                gb = grad.to(torch.bfloat16)
                d = {"ms": _device_ms(lambda: tmoe.gmm_dlhs(grad, rhs, sizes, not trans), iters)}
                t = {"ms": _device_ms(lambda: tmoe.tgmm(lhs, grad, sizes), iters)}
                if has_split:
                    sp = tmoe.split_hi_lo(grad)
                    out[f"split {at}"] = {"ms": _device_ms(lambda: tmoe.split_hi_lo(grad), iters),
                                          "flagged": int(sp[2].sum())}
                    d["kernel_ms"] = _device_ms(
                        lambda: tmoe.gmm_dlhs(grad, rhs, sizes, not trans, split=sp), iters)
                    t["kernel_ms"] = _device_ms(lambda: tmoe.tgmm(lhs, grad, sizes, split=sp),
                                                iters)
                    del sp
                if lib is not None:
                    d_rhs = rhs if trans else rhs.transpose(1, 2)
                    d["library_ms"] = _device_ms(lambda: lib(gb, d_rhs, offs=offs), iters)
                    lt = lhs.T
                    t["library_ms"] = _device_ms(lambda: lib(lt, gb, offs=offs), iters)
                out[f"gmm_dlhs {at}"], out[f"tgmm {at}"] = d, t
                del gb
            del grads, rhs, lhs, rhs_kn
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
    bits = set()
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
        bits.add(times["flash [8, 2048] with lse"]["bits"])
        print(json.dumps({"turn": label, "dir": root, "ms": times}), flush=True)
    print(f"flash forward output bits: {'the same' if len(bits) == 1 else 'DIFFER'} in every "
          f"turn", flush=True)
    return 0 if len(bits) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
