#!/usr/bin/env python3
"""Where `flash_segment_bwd`'s time goes on the card: copies of
``aria_tpu_torch/csrc/vit_attention_bwd.cu`` with one cost taken out, and a
timeline of the package's kernel block by block.

    python3 tools/seg_bwd_probe.py [--dir tmp/probe] [--heads 16]

Each probe is a copy of the kernel source with text substitutions, built
with ``nvcc -shared`` into ``--dir`` (a directory that .gitignore lists) and
called through ctypes with the package's C signature, on [1, 4900, H, 72]
(the ViT's 980 px crop) under three masks: every patch valid, 3,150 valid
as a prefix (a landscape crop) and a portrait crop's 70 x 45 of the 70 x 70
patches, the cotangent zero on pad rows:

- ``no-wait``: no key tile waits for the counter of the tiles before it
  (dq's sums race; the wavefront's cost);
- ``late-release``: the counter released after the step's dQ product, not
  before its dV and dK products;
- ``no-add``: no dQ part is staged into the scratch, added or counted;
- ``no-scores``: P and dS are the raw accumulators (no exponentials, no
  masks); ``no-sdp``, ``no-dvdk``, ``no-dq``: that product not issued;
- ``skeleton``: all of these out at once (the loads, the ring, the
  barriers and the prologue remain).

Every probe but ``late-release`` gives wrong gradients by design; what
counts is the time (CUDA events over 20 calls, the prep launch and the
scratch's allocation included, as the wrapper has them). ``late-release``
must give the package's bits. The timeline is a copy that stamps
%globaltimer at each block's start and end: it prints the span and each
place's mean block time over the heads, in the order of key tiles. It
prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "aria_tpu_torch", "csrc", "vit_attention_bwd.cu")
CSRC = os.path.dirname(SRC)
P, D, SIDE = 4900, 72, 70

RELEASE = ("    if (PART && ct == 0 && pending >= 0) aria::release_count(ctr + pending);\n"
           "    pending = -1;\n")
LOAD_NEXT = "    // both warpgroups are past step t - 1: its stage takes step t - 1 + STAGES\n"


def sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"probe: the kernel source no longer holds {old[:70]!r}")
    return src.replace(old, new)


def no_wait(src):
    for call in ("aria::wait_count(ctr + staged, C::NPARTS * staged_rank);",
                 "aria::wait_count(ctr + qt, C::NPARTS * rank);"):
        src = sub(src, call, "(void)0;")
    return src


def late_release(src):
    src = sub(src, RELEASE, "")
    return sub(src, LOAD_NEXT, RELEASE + LOAD_NEXT)


def no_add(src):
    src = sub(src, "    if constexpr (PART)\n      if (staged >= 0) add_staged();", "")
    return sub(src, "        staged = qt;\n        staged_rank = rank;\n", "")


def no_scores(src):
    a = src.index("#pragma unroll\n    for (int e = 0; e < 4; ++e) {\n      const float4& r")
    b = src.index("    pa[2 * n] = aria::pack_bf16(p[0], p[1]);")
    return src[:a] + ("    for (int e = 0; e < 4; ++e) {\n      p[e] = s[4 * n + e];\n"
                      "      ds[e] = dp[4 * n + e] + q0.z + q1.z;\n    }\n") + src[b:]


def no_products(src, *calls):
    for call in calls:
        src = sub(src, call, "if (false) " + call)
    return src


SDP = ("aria::wgmma_rs64<0>(s, kf[kk], desc(sq + kk * 32, 16), kk > 0);",
       "aria::wgmma_rs64<0>(dp, vf[kk], desc(sd + kk * 32, 16), kk > 0);",
       "aria::wgmma_rs64<0>(s, kf[4], ", "aria::wgmma_rs64<0>(dp, vf[4], ")
DVDK = ("aria::wgmma_rs64<1>(dvr, ", "aria::wgmma_rs64<1>(dkr, ", "aria::wgmma_rs8<1>(dvt, ",
        "aria::wgmma_rs8<1>(dkt, ")
DQ = ("aria::wgmma_ss64<1, 1>(dqr, ", "aria::wgmma_ss8<1, 1>(dqr, ")


def timeline(src):
    src = sub(src, '#include "hopper.cuh"\n',
              '#include "hopper.cuh"\n__device__ unsigned long long g_span[8192][2];\n'
              "__device__ __forceinline__ unsigned long long gtime() {\n"
              "  unsigned long long t;\n"
              '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n  return t;\n}\n'
              "ARIA_EXPORT int probe_span(void* dst) {\n"
              "  return (int)cudaMemcpyFromSymbol(dst, g_span, sizeof(g_span));\n}\n")
    src = sub(src, "  using C = Cfg<D>;\n  extern __shared__ uint8_t smem_raw[];",
              "  using C = Cfg<D>;\n  const unsigned long long t0 = gtime();\n"
              "  extern __shared__ uint8_t smem_raw[];")
    end = "                  Sq, Sk, H, scale);\n"
    return sub(src, end + "}\n",
               end + "  if (threadIdx.x == 0 && blockIdx.x < 8192) {\n"
               "    g_span[blockIdx.x][0] = t0;\n    g_span[blockIdx.x][1] = gtime();\n  }\n}\n")


def probes(src: str) -> dict:
    return {
        "package": src,
        "late-release": late_release(src),
        "no-wait": no_wait(src),
        "no-add": no_add(no_wait(src)),
        "no-scores": no_scores(no_wait(src)),
        "no-sdp": no_products(no_wait(src), *SDP),
        "no-dvdk": no_products(no_wait(src), *DVDK),
        "no-dq": no_products(no_wait(src), *DQ),
        "skeleton": no_products(no_scores(no_add(no_wait(src))), *SDP, *DVDK, *DQ),
        "timeline": timeline(src),
    }


def build(out_dir: str) -> dict:
    from aria_tpu_torch.ops._build import ARCH, SIGNATURES, _nvcc

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in probes(open(SRC).read()).items():
        cu = os.path.join(out_dir, f"segbwd_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_nvcc(), *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-I", CSRC,
             cu, "-o", cu[:-3] + ".so"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"probe {name} did not build:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"segbwd_{name}.so"))
        lib.aria_flash_segment_bwd.argtypes = SIGNATURES["aria_flash_segment_bwd"]
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join(ROOT, "tmp", "probe"))
    ap.add_argument("--heads", type=int, default=16)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from aria_tpu_torch.ops import backend
    from aria_tpu_torch.ops import flash as fl

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {gpu}", flush=True)
    libs = build(args.dir)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    H = args.heads
    q, k, v, do = (torch.randn((1, P, H, D), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(4))

    def call(lib, o, dm, stats, valid):
        nqt = -(-P // 64)
        qs = torch.empty((1, H, nqt * 64, 4), dtype=torch.float32, device=dev)
        qflags = torch.empty((1, H, nqt), dtype=torch.int32, device=dev)
        acc = torch.empty((1, H, nqt * 64, D), dtype=torch.float32, device=dev)
        ctr = torch.zeros((1, H, nqt), dtype=torch.int32, device=dev)
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        p = backend.ptr
        err = lib.aria_flash_segment_bwd(
            p(q), p(k), p(v), p(o), p(dm), p(stats), p(valid), p(valid), p(qs), p(qflags),
            p(acc), p(ctr), p(dq), p(dk), p(dv), 1, P, P, H, D, ctypes.c_float(D**-0.5),
            backend.stream())
        if err:
            raise RuntimeError(f"probe launch failed: {err}")
        return dq, dk, dv

    def ms(fn, n=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    crop = torch.zeros((SIDE, SIDE), dtype=torch.bool, device=dev)
    crop[:, :SIDE * 630 // 980] = True
    masks = (("all valid", torch.ones((1, P), dtype=torch.bool, device=dev)),
             ("3150 valid prefix", torch.arange(P, device=dev)[None] < 3150),
             ("crop's 3150 valid", crop.reshape(1, P)))
    for label, valid in masks:
        stats = torch.empty((2, 1, H, P), dtype=torch.float32, device=dev)
        o = fl._segment_forward(q, k, v, valid, valid, D**-0.5, stats)
        dm = do * valid[:, :, None, None]
        ref = call(libs["package"], o, dm, stats, valid)
        same = all(map(torch.equal, ref, call(libs["late-release"], o, dm, stats, valid)))
        times = {name: ms(lambda lib=lib: call(lib, o, dm, stats, valid))
                 for name, lib in libs.items() if name != "timeline"}
        print(f"[1, {P}, {H}, {D}] {label}: " + ", ".join(f"{n} {t:.4f} ms"
                                                         for n, t in times.items())
              + f"; late-release bits {'equal' if same else 'DIFFER'}", flush=True)
        call(libs["timeline"], o, dm, stats, valid)
        torch.cuda.synchronize()
        span = np.zeros((8192, 2), dtype=np.uint64)
        if libs["timeline"].probe_span(span.ctypes.data_as(ctypes.c_void_p)):
            raise RuntimeError("probe_span failed")
        nkt = -(-P // 128)
        t = span[:H * nkt].astype(np.float64) / 1e3
        t -= t[:, 0].min()
        by_place = (t[:, 1] - t[:, 0]).reshape(H, nkt).mean(0)
        print(f"  timeline: span {t[:, 1].max():.1f} us; mean block us by place in the order "
              "of key tiles: " + " ".join(f"{x:.0f}" for x in by_place), flush=True)
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
