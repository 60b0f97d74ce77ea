#!/usr/bin/env python3
"""Device times of the port's causal flash forward and backward, the ViT's
attention and decode attention, for two checkouts on one card, in turns
(A, B, B, A).

    python3 tools/attention_ab.py PARENT_DIR CHANGE_DIR [--iters 20] [--only NAME ...]

Each turn is a fresh process that imports ``aria_tpu_torch`` from the
directory given, builds its kernels there, and times on random inputs from
a seed, 20 heads of 128 (the flagship's attention):

- ``flash_causal`` (serving form) at [1, 512], [8, 2048], [32, 64], [1, 8192]
  and [1, 32768], and with its row statistics at [1, 2048], each with a
  hash of its output's bits;
- ``flash_causal_bwd`` at [1, 2048] and [8, 2048] (the LoRA and the full
  recipe's shapes), beside sdpa's backward alone (its forward run once,
  outside the timed call) and sdpa's forward + backward;
- ``vit_flash`` and ``flash_segment`` (the ViT's attention and its form
  under ``VIT_FLASH = False``) at [1, 4900, 16, 72], every patch valid and a
  980 x 630 crop's 3,150 (70 x 45 of the 70 x 70 patches), beside sdpa with
  the key mask and with the segment mask, each with a hash of its output's
  bits, and ``vit_flash`` at the card tests' small shapes [2, 300, 2, 72]
  (300 and 137 valid) and [1, 129, 4, 64];
- ``decode_attention`` at one lane over 1,000 of 1,024 positions (int8,
  bf16), at 32 lanes over 48..320 of 384 (packed int4) and at one lane over
  32,768 of 32,896 (int4, int8, bf16);
- ``decode_attention_stats`` at one lane over one 4,352-position block
  (int8, bf16, int4);
- ``paged_decode_attention`` over int8 and bf16 pages of 256 at the paged
  path's 32 lanes (lengths 48-511 of 512, tables shuffled over the default
  pool of 1 + 2 pages a lane) and at 4 lanes (400-511), each with its
  largest difference from the plain version;

with ``scaled_dot_product_attention`` beside each flash shape and each bf16
decode shape. Times are the card's kernel time per call from
``torch.profiler`` (the sum over the call's kernels); a reading of zero
(the profiler dropped the call's events) is taken again once and otherwise
fails the turn, and is never printed as a time. It prints the card's name
and power limit, one line per shape and turn, one JSON line per turn, and
whether the causal forward's bits agree in every turn and each checkout's
ViT outputs in its own turns (exit 1 where either does not: the causal
forward is the control when another kernel changes). ``--only`` keeps the
shapes whose name holds one of the words given (for example ``--only
paged``); the causal forward's shapes, the control, always run.
"""

from __future__ import annotations

import argparse
import hashlib
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
    for _ in range(2):  # a reading of zero is a dropped profile, not a time: once more
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / iters / 1e3
    raise RuntimeError("the profiler recorded no kernel time for a timed call, twice: "
                       "no time can be read from this turn")


def _bits(t) -> str:
    import torch

    return hashlib.sha256(t.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]


def measure(iters: int, only=()) -> dict:
    import torch
    import torch.nn.functional as F

    from aria_tpu_torch.ops import decode_attention as da
    from aria_tpu_torch.ops import flash as fl
    from aria_tpu_torch.ops import vit_flash as vf

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def want(*names: str) -> bool:
        return not only or any(o in n for o in only for n in names)

    out = {}
    for B, S, stats in ((1, 512, False), (1, 2048, True), (8, 2048, False), (32, 64, False),
                        (1, 8192, False), (1, 32768, False)):
        q, k, v = (randn(B, S, H, D) for _ in range(3))
        lse = torch.empty((B, H, S), dtype=torch.float32, device=dev) if stats else None
        n = iters if S <= 2048 else 3
        qt = [t.transpose(1, 2) for t in (q, k, v)]
        out[f"flash [{B}, {S}]" + (" with lse" if stats else "")] = {
            "ms": _device_ms(lambda: fl._forward(q, k, v, D**-0.5, lse), n),
            "sdpa_ms": _device_ms(lambda: F.scaled_dot_product_attention(*qt, is_causal=True), n),
            "bits": _bits(fl._forward(q, k, v, D**-0.5, lse))}
        del q, k, v, qt, lse

    for B in (1, 8):
        S = 2048
        if not want("flash_bwd"):
            break
        q, k, v, do = (randn(B, S, H, D) for _ in range(4))
        lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
        o = fl._forward(q, k, v, D**-0.5, lse)
        leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
        o_sdpa = F.scaled_dot_product_attention(*leaves, is_causal=True)
        do_t = do.transpose(1, 2)

        def sdpa_fwd_bwd():
            lv = [t.detach().requires_grad_() for t in leaves]
            torch.autograd.grad(F.scaled_dot_product_attention(*lv, is_causal=True), lv, do_t)

        out[f"flash_bwd [{B}, {S}]"] = {
            "ms": _device_ms(lambda: fl.flash_causal_bwd(q, k, v, o, do, lse), iters),
            "sdpa_bwd_ms": _device_ms(
                lambda: torch.autograd.grad(o_sdpa, leaves, do_t, retain_graph=True), iters),
            "sdpa_fwd_bwd_ms": _device_ms(sdpa_fwd_bwd, iters)}
        del q, k, v, do, lse, o, leaves, o_sdpa, do_t

    out.update(_paged(dev, gen, randn, iters) if want("paged_decode_attention") else {})
    if want("vit_flash", "flash_segment"):
        P, VH, VD, side = 4900, 16, 72, 70
        q, k, v = (randn(1, P, VH, VD) for _ in range(3))
        qt = [t.transpose(1, 2) for t in (q, k, v)]
        crop = torch.zeros((side, side), dtype=torch.bool, device=dev)
        crop[:, :side * 630 // 980] = True
        for label, valid in (("all valid", torch.ones((1, P), dtype=torch.bool, device=dev)),
                             ("3150 valid", crop.reshape(1, P))):
            key_mask = valid[:, None, None, :]
            seg_mask = valid[:, None, :, None] == valid[:, None, None, :]
            out[f"vit_flash [1, {P}, {VH}, {VD}] {label}"] = {
                "ms": _device_ms(lambda: vf.vit_flash(q, k, v, valid), iters),
                "sdpa_ms": _device_ms(lambda: F.scaled_dot_product_attention(
                    *qt, attn_mask=key_mask), iters),
                "vit_bits": _bits(vf.vit_flash(q, k, v, valid))}
            out[f"flash_segment [1, {P}, {VH}, {VD}] {label}"] = {
                "ms": _device_ms(lambda: fl.flash_segment(q, k, v, valid, valid), iters),
                "sdpa_ms": _device_ms(lambda: F.scaled_dot_product_attention(
                    *qt, attn_mask=seg_mask), iters),
                "vit_bits": _bits(fl.flash_segment(q, k, v, valid, valid))}
            del seg_mask
        del q, k, v, qt
        for B, S, VH, VD, lens in ((2, 300, 2, 72, (300, 137)), (1, 129, 4, 64, (129,))):
            q, k, v = (randn(B, S, VH, VD) for _ in range(3))
            qt = [t.transpose(1, 2) for t in (q, k, v)]
            valid = torch.arange(S, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
            out[f"vit_flash [{B}, {S}, {VH}, {VD}]"] = {
                "ms": _device_ms(lambda: vf.vit_flash(q, k, v, valid), iters),
                "sdpa_ms": _device_ms(lambda: F.scaled_dot_product_attention(
                    *qt, attn_mask=valid[:, None, None, :]), iters),
                "vit_bits": _bits(vf.vit_flash(q, k, v, valid))}
            del q, k, v, qt

    if not want("decode_attention"):
        return out
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


def _paged(dev, gen, randn, iters: int) -> dict:
    """``paged_decode_attention`` at the paged path's two shapes, int8 and
    bf16 pages (chip_smoke.py's phase 2 cases)."""
    import torch

    from aria_tpu_torch.ops import paged_attention as pg

    out, PS, maxp = {}, 256, 2
    for lanes, lo in ((32, 48), (4, 400)):
        NP = 1 + lanes * maxp
        shape = (2, NP, H, PS, D)
        table = (torch.randperm(NP - 1, generator=gen, device=dev)[:lanes * maxp] + 1)
        table = table.reshape(lanes, maxp).to(torch.int32)
        lengths = torch.linspace(lo, maxp * PS - 1, lanes).round().int().to(dev)
        q = randn(lanes, H, D)
        for label in ("int8", "bf16"):
            if label == "int8":
                pages = [torch.randint(-128, 128, shape, generator=gen, device=dev,
                                       dtype=torch.int8) for _ in range(2)]
                pages += [torch.rand(shape[:-1], generator=gen, device=dev) * 0.02 + 0.005
                          for _ in range(2)]
            else:
                pages = [randn(*shape) for _ in range(2)]
            args = (q, pg.PagedKVCache(*pages), 1, table, lengths)
            err = (pg.paged_decode_attention(*args).float()
                   - pg.paged_decode_attention_plain(*args).float()).abs().max().item()
            out[f"paged_decode_attention {label} B={lanes} len={lo}..{maxp * PS - 1} of "
                f"{maxp * PS}"] = {"ms": _device_ms(lambda: pg.paged_decode_attention(*args),
                                                    iters), "max_abs_err": err}
            del args, pages
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
    bits, own_bits = {}, {}
    for label, root in (("A", a), ("B", b), ("B", b), ("A", a)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", "--iters",
                               str(args.iters), "--only", *args.only], cwd=root,
                              capture_output=True, text=True,
                              env={**os.environ, "PYTHONPATH": root})
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, flush=True)
            return proc.returncode
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        for shape, rec in times.items():
            extra = "".join(f", {k[:-3]} {v:.4f} ms" for k, v in rec.items()
                            if k.endswith("_ms"))
            err = f", max_abs_err {rec['max_abs_err']:.3e}" if "max_abs_err" in rec else ""
            print(f"{label} ({root}) {shape}: {rec['ms']:.4f} ms{extra}{err}", flush=True)
            if "bits" in rec:
                bits.setdefault(shape, set()).add(rec["bits"])
            if "vit_bits" in rec:  # its own checkout's output, turn to turn
                own_bits.setdefault((label, shape), set()).add(rec["vit_bits"])
        print(json.dumps({"turn": label, "dir": root, "ms": times}), flush=True)
    differ = sorted(shape for shape, seen in bits.items() if len(seen) > 1)
    print(f"flash forward output bits: {'the same in every turn' if not differ else 'DIFFER: '}"
          f"{', '.join(differ)}", flush=True)
    own = sorted(f"{label} {shape}" for (label, shape), seen in own_bits.items() if len(seen) > 1)
    print(f"ViT attention output bits, each checkout in its own turns: "
          f"{'the same' if not own else 'DIFFER: '}{', '.join(own)}", flush=True)
    return 1 if differ or own else 0


if __name__ == "__main__":
    sys.exit(main())
