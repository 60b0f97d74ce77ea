#!/usr/bin/env python3
"""When each block of ``paged_decode_attention`` and ``dense_int4_a8`` runs,
and where its time goes, on the card: copies of
``aria_tpu_torch/csrc/decode_attention.cu`` and ``dense_int4.cu`` whose
blocks stamp the card's global timer at six points.

    python3 tools/trace_probe.py [--dir tmp/probe]

Each copy (text insertions only, built with ``nvcc -shared`` into ``--dir``,
a directory that .gitignore lists, and called through ctypes with the
package's C signatures) writes, from thread 0 of every block, %globaltimer
(ns) at six points:

- ``paged_decode_attention``: entry; after the block's lane is picked
  (longest first) and its length read (a block past it leaves here); the
  first tile landed; the tile loop's end; the warps' merge done; the exit. At the paged path's shapes (int8 and
  bf16 pages of 256, 20 heads of 128; 32 lanes at 48-511 of 512 and 4
  lanes at 400-511, tables shuffled over the pool) and each split P in 1,
  2, 4, 8.
- ``dense_int4_a8`` (wqkv F 7680 and wo F 2560 at D 2560, T = 1, 8, 9,
  32): entry; x quantized (the split form) or the scales staged; the first
  stage landed; the loop's end; the split's partial written and counted;
  the exit.

For each case it prints the kernel's span (first entry to last exit), how
many blocks ran and left early, the median and 90th percentile of each
phase over the blocks that ran, and the span of the block starts (how long
the last block waited for a slot). It prints the card's name and power
limit first. The stamps cost a few instructions a block; the timer ticks
in steps of about a quarter of a microsecond on the card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "aria_tpu_torch", "csrc")
H, DH, PS, MAXP = 20, 128, 256, 2
D = 2560
DENSE = {"wqkv": 7680, "wo": 2560}

STAMP = ("\n#define STAMP(i) if (threadIdx.x == 0) { unsigned long long t_; "
         "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
         "g_trace[(((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * 8 "
         "+ (i)] = t_; }\n__device__ unsigned long long* g_trace;\n")
SETTER = ('\nARIA_EXPORT int aria_set_trace(void* p) {\n'
          '  return (int)cudaMemcpyToSymbol(g_trace, &p, sizeof(p));\n}\n')
# per source: (anchor, text put before it), then (old, new) replacements;
# "LAST:" replaces the last occurrence of its anchor only
PATCHES = {
    "decode_attention.cu": (
        [("  const int hx = blockIdx.x, split = blockIdx.z, P = gridDim.z;\n", "  STAMP(0);\n"),
         ("  const int c1 = min(cend, len);\n", "  STAMP(1);\n"),
         ("    const uint8_t* ks = smem + (tile % NST) * C::STAGE;\n", "    if (tile == 0) STAMP(2);\n"),
         ("  // the 8 warps' merge; the ring's memory holds their accumulators\n", "  STAMP(3);\n"),
         ("  const size_t bx = (size_t)b * Hx + hx;  // this block's (lane, head or pair)\n",
          "  STAMP(4);\n")],
        [("  if (split >= max(nreal, 1)) return;\n",
          "  if (split >= max(nreal, 1)) { STAMP(1); STAMP(5); return; }\n"),
         ("    if (!last) return;\n", "    if (!last) { STAMP(5); return; }\n"),
         ("      out[bh * D + d] = __float2bfloat16(tot > 0.f ? a / tot : 0.f);\n    }\n  }\n}\n",
          "      out[bh * D + d] = __float2bfloat16(tot > 0.f ? a / tot : 0.f);\n    }\n  }\n"
          "  STAMP(5);\n}\n")]),
    "dense_int4.cu": (
        [("  if (warp == CW) {  // the producer: one thread starts every load\n", "  STAMP(0);\n"),
         ("  const int q = lane >> 2, r = lane & 3;\n  const int wrow = warp % 4 * 16 + q;",
          "  STAMP(1);\n"),
         ("    // rows wrow, wrow + 8: packed bytes 32r..32r+31 (word k: bytes 32r + 4k..),\n",
          "    if (c == 0) STAMP(2);\n"),
         ("  // tot[n][i]: row wrow (i < 2) or wrow + 8, token (n0 + n)*8 + 2r + (i & 1)\n",
          "  STAMP(3);\n"),
         ('  } else {\n    static_assert(NTW == 1, "the split takes one n-tile a warp");\n',
          "    STAMP(4);\n")],
        [('    asm volatile("bar.sync 1, %0;\\n" :: "n"(32 * CW) : "memory");\n    if (!last) return;\n',
          '    asm volatile("bar.sync 1, %0;\\n" :: "n"(32 * CW) : "memory");\n    STAMP(4);\n'
          '    if (!last) { STAMP(5); return; }\n'),
         ("LAST:    if (threadIdx.x == 0) counters[blockIdx.x] = 0;  // ready for the next call\n  }\n}\n",
          "    if (threadIdx.x == 0) counters[blockIdx.x] = 0;  // ready for the next call\n  }\n"
          "  STAMP(5);\n}\n")]),
}


def build(name: str, out_dir: str) -> ctypes.CDLL:
    src = open(os.path.join(CSRC, name)).read()
    at = src.index("namespace {")
    src = src[:at] + STAMP + src[at:]
    inserts, replaces = PATCHES[name]
    for anchor, text in inserts:
        if src.count(anchor) != 1:
            raise RuntimeError(f"{name}: anchor not found once: {anchor!r}")
        src = src.replace(anchor, text + anchor)
    for old, new in replaces:
        if old.startswith("LAST:"):
            old = old[5:]
            at = src.rfind(old)
            if at < 0:
                raise RuntimeError(f"{name}: anchor not found: {old!r}")
            src = src[:at] + new + src[at + len(old):]
            continue
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: anchor not found once: {old!r}")
        src = src.replace(old, new)
    os.makedirs(out_dir, exist_ok=True)
    stem = name.split(".")[0]
    path = os.path.join(out_dir, f"{stem}_trace.cu")
    with open(path, "w") as f:
        f.write(src + SETTER)
    lib = os.path.join(out_dir, f"lib{stem}_trace.so")
    subprocess.run(["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-I", CSRC, path, "-o", lib], check=True)
    so = ctypes.CDLL(lib)
    P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if stem == "decode_attention":
        so.aria_paged_decode_attention.argtypes = [P_] * 10 + [I_] * 8 + [F_, P_]
    else:
        so.aria_dense_int4_a8.argtypes = [P_] * 8 + [I_] * 5 + [P_]
        so.aria_act_quant_int8.argtypes = [P_, P_, P_, I_, I_, I_, P_]
    so.aria_set_trace.argtypes = [P_]
    return so


def report(label: str, trace, phase_names) -> None:
    """One line: the span, the blocks that ran and left, each phase's
    median / 90th percentile (us) over the blocks that ran."""
    t = trace.reshape(-1, 8).cpu().double()
    ran = t[:, 2] > 0
    span = (t[:, 5].max() - t[:, 0].min()).item() / 1e3
    t0 = t[:, 0].min()

    def q50_90(x):
        x = x / 1e3
        return f"{x.median().item():.2f}/{x.quantile(0.9).item():.2f}"

    r = t[ran]
    phases = {name: r[:, i + 1] - r[:, i] for i, name in enumerate(phase_names)}
    phases["block"] = r[:, 5] - r[:, 0]
    print(f"{label}: span {span:.2f} us, {int(ran.sum())} blocks ran, {int((~ran).sum())} left "
          f"early; last block start {((t[:, 0].max() - t0) / 1e3).item():.2f} us after the "
          f"first; us median/p90: " + ", ".join(f"{k} {q50_90(v)}" for k, v in phases.items()),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join(ROOT, "tmp", "probe"))
    args = ap.parse_args()

    import torch

    from aria_tpu_torch.ops import backend
    from aria_tpu_torch.ops import paged_attention as pg
    from aria_tpu_torch.ops.quant import int4_group_count, quantize_dense_int4

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {gpu}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    p = backend.ptr

    so = build("dense_int4.cu", args.dir)
    ng = int4_group_count(D)
    for name, F in DENSE.items():
        w = quantize_dense_int4((torch.randn((1, D, F), generator=gen, device=dev)
                                 * D**-0.5).to(torch.bfloat16))
        for T in (1, 8, 9, 32):
            x = torch.randn((T, D), generator=gen, device=dev).to(torch.bfloat16)
            out = torch.empty((T, F), dtype=torch.float32, device=dev)
            xq = torch.empty((T, D), dtype=torch.int8, device=dev)
            sx = torch.empty((T, 8), dtype=torch.float32, device=dev)
            ws, cnt = backend.workspace(dev, ng * T * F, -(-F // 64))
            split = T <= 8
            tn = 8 if T <= 8 else 16 if T <= 16 else 32  # the kernel's token rows a block
            blocks = -(-F // 64) * (ng if split else -(-T // tn))
            trace = torch.zeros((blocks, 8), dtype=torch.int64, device=dev)
            so.aria_set_trace(p(trace))

            def call():
                if not split:
                    so.aria_act_quant_int8(p(x), p(xq), p(sx), T, D, ng, backend.stream())
                err = so.aria_dense_int4_a8(p(x), p(xq), p(sx), p(w["q4t"]), p(w["sg"]), p(out),
                                            p(ws), p(cnt), T, D, F, 1, 0, backend.stream())
                if err:
                    raise RuntimeError(f"launch: CUDA error {err}")

            for _ in range(5):  # warm; the trace keeps the last call's stamps
                call()
            torch.cuda.synchronize()
            report(f"dense_int4_a8 {name} T={T} ({'split' if split else 'one block every group'})",
                   trace, ("scales and x", "first stage", "stages", "partial counted", "exit"))

    so = build("decode_attention.cu", args.dir)
    for lanes, lo in ((32, 48), (4, 400)):
        NP = 1 + lanes * MAXP
        shape = (2, NP, H, PS, DH)
        table = (torch.randperm(NP - 1, generator=gen, device=dev)[:lanes * MAXP] + 1)
        table = table.reshape(lanes, MAXP).to(torch.int32)
        lengths = torch.linspace(lo, MAXP * PS - 1, lanes).round().int().to(dev)
        q = torch.randn((lanes, H, DH), generator=gen, device=dev).to(torch.bfloat16)
        for label in ("int8", "bf16"):
            if label == "int8":
                pages = [torch.randint(-128, 128, shape, generator=gen, device=dev,
                                       dtype=torch.int8) for _ in range(2)]
                pages += [torch.rand(shape[:-1], generator=gen, device=dev) * 0.02 + 0.005
                          for _ in range(2)]
            else:
                pages = [torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                         for _ in range(2)]
            cache = pg.PagedKVCache(*pages)
            quantized = int(label == "int8")
            for P in (1, 2, 4, 8):
                out = torch.empty((lanes, H, DH), dtype=torch.bfloat16, device=dev)
                ws, cnt = backend.workspace(dev, lanes * H * P * (DH + 2), lanes * H)
                trace = torch.zeros((P, lanes, H, 8), dtype=torch.int64, device=dev)
                so.aria_set_trace(p(trace))

                def call():
                    err = so.aria_paged_decode_attention(
                        p(q), p(cache.k), p(cache.v), p(cache.k_scale) if quantized else None,
                        p(cache.v_scale) if quantized else None, p(table), p(lengths), p(out),
                        p(ws), p(cnt), lanes, H, NP, PS, MAXP, 1, quantized, P, DH**-0.5,
                        backend.stream())
                    if err:
                        raise RuntimeError(f"launch: CUDA error {err}")

                for _ in range(5):
                    call()
                torch.cuda.synchronize()
                report(f"paged_decode_attention {label} B={lanes} P={P}", trace,
                       ("length", "first tile", "tiles", "warp merge", "exit"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
