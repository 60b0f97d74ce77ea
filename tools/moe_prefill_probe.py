#!/usr/bin/env python3
"""Where `moe_prefill_int4`'s time goes on the card: probes of copies of
``aria_tpu_torch/csrc/moe_prefill.cu`` with one cost taken out, beside a
bare loop of the same products.

    python3 tools/moe_prefill_probe.py [--dir tmp/probe]

Each probe is a copy of the kernel source with text substitutions, built
with ``nvcc -shared`` into ``--dir`` (a directory that .gitignore lists) and
called through ctypes with the package's C signatures:

- ``no-unpack``: the A fragments are constants, no packed byte is read;
- ``no-unpack-no-loads``: and no TMA load is issued or waited for;
- ``no-unpack-no-loads-cheap-end``: and a D-group's end reads one sum
  instead of scaling all of them into the totals in shared memory.

The results are wrong by design; what counts is the device time of
``prefill_glu`` and ``prefill_down`` (profiler), at the flagship's widths
(D 2560, I 1664, 64 routed experts top-6 plus 2 shared) at T = 512, 2048
and 4096, beside the package's kernel on the same inputs. Each probe's
SASS is checked: a product whose sums are never read is dropped by ptxas,
which would void the probe, so the count of products is printed.

``bare``: a loop of m64nNk16 products with A from registers (N 48 to 128)
and with A from shared memory (N 128), two warpgroups a block, one block a
SM, no loads: the rate the tensor cores give these products alone.

It prints the card's name, power limit and SM clock.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "aria_tpu_torch", "csrc", "moe_prefill.cu")

UNPACK = """      aria::unpack2(lds16(wg + swz<PB>(row, 16 * kk + 2 * r)), alo[kk][0], ahi[kk][0]);
      aria::unpack2(lds16(wu + swz<PB>(row, 16 * kk + 2 * r)), alo[kk][1], ahi[kk][1]);
      aria::unpack2(lds16(wg + swz<PB>(row, 16 * kk + 8 + 2 * r)), alo[kk][2], ahi[kk][2]);
      aria::unpack2(lds16(wu + swz<PB>(row, 16 * kk + 8 + 2 * r)), alo[kk][3], ahi[kk][3]);"""
CONST_A = """      for (int i = 0; i < 4; ++i)
        alo[kk][i] = 0x3F803F80u + c + wg * 0, ahi[kk][i] = 0x3F803F80u + kk + wu * 0;"""
WAIT = "    aria::mbar_wait_loop(bars + 8 * s, (c / G_STAGES) & 1);\n"
PRODUCER = ("    if (threadIdx.x == CONSUMERS) {\n      for (int c = 0; c < nk; ++c) {\n"
            "        const int s = c % G_STAGES, g")
END = re.compile(r"      const float fa = aria::bf2f\(sa\), fb = aria::bf2f\(sb\);\n#pragma unroll\n"
                 r"      for \(int j = 0; j < NA / 4; \+\+j\) \{.*?\n        \*ts = t4;\n      \}", re.S)

BARE = r'''
#include "hopper.cuh"
template <int N, bool RS>
__global__ void __launch_bounds__(256, 1) bare(float* out, int iters) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (aria::smem_u32(smem) + 1023) & ~1023u;
  for (int i = threadIdx.x; i < (N + 64) * 32; i += blockDim.x)
    reinterpret_cast<float*>(smem + (base - aria::smem_u32(smem)))[i] = 0.f;
  __syncthreads();
  const uint32_t a[4] = {0x3F803F80u + threadIdx.x, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u};
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < iters; ++it) {
    aria::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t db = aria::sw128_desc(base + kk % 4 * 32, 16, 1024);
      if constexpr (RS) aria::wgmma_rsn<N>(acc, a, db);
      else aria::wgmma_ss<0, 0>(acc, aria::sw128_desc(base + N * 128 + kk % 4 * 32, 16, 1024),
                                db, 1);
    }
    aria::wgmma_commit();
    aria::wgmma_wait<1>();
  }
  aria::wgmma_wait<0>();
  aria::fence_regs(acc);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int N, bool RS>
int run(float* out, int blocks, int iters) {
  const int smem = (N + 64) * 128 + 1024;
  cudaFuncSetAttribute(bare<N, RS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  bare<N, RS><<<blocks, 256, smem>>>(out, iters);
  return cudaGetLastError();
}
ARIA_EXPORT int aria_bare(int n, int rs, float* out, int blocks, int iters) {
  if (!rs) return run<128, false>(out, blocks, iters);
  if (n == 48) return run<48, true>(out, blocks, iters);
  if (n == 64) return run<64, true>(out, blocks, iters);
  if (n == 96) return run<96, true>(out, blocks, iters);
  return run<128, true>(out, blocks, iters);
}
'''


def _sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"the kernel source changed: {old[:60]!r} is not there once")
    return text.replace(old, new)


def probes() -> dict:
    src = open(SRC).read()
    no_unpack = _sub(src, UNPACK, CONST_A)
    no_loads = _sub(_sub(no_unpack, WAIT, ""), PRODUCER, PRODUCER.replace("CONSUMERS)", "-1)"))
    if len(END.findall(no_loads)) != 1:
        raise SystemExit("the kernel source changed: the group end's scaling is not there once")
    cheap_end = END.sub("      tot_s[threadIdx.x] += acc[0] * aria::bf2f(sa);", no_loads)
    return {"no-unpack": no_unpack, "no-unpack-no-loads": no_loads,
            "no-unpack-no-loads-cheap-end": cheap_end}


def build(name: str, text: str, out_dir: str) -> str:
    from aria_tpu_torch.ops import _build

    cu, so = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"{name}.so")
    open(cu, "w").write(text)
    subprocess.run([_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                    "-shared", "-I" + os.path.dirname(SRC), cu, "-o", so], check=True)
    return so


def products(so: str) -> dict:
    """HGMMA instructions by kernel, and how many a full wait follows."""
    from aria_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    fn, count = None, {}
    for line in sass.splitlines():
        if "Function :" in line:
            fn = next((k for k in ("prefill_glu", "prefill_down") if k in line), None)
            if fn:
                count[fn] = [0, 0]
        elif fn and "HGMMA" in line:
            count[fn][0] += 1
        elif fn and "WARPGROUP.DEPBAR.LE gsb0, 0x0" in line:
            count[fn][1] += 1
    return count


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join(ROOT, "tmp", "probe"))
    args = ap.parse_args()
    os.makedirs(args.dir, exist_ok=True)
    sys.path.insert(0, ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from aria_tpu_torch.ops import _build, backend
    from aria_tpu_torch.ops import moe_prefill_kernel as mp
    from aria_tpu_torch.ops.quant import quantize_expert_int4

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {smi.strip()}", flush=True)
    libs = {}
    for name, text in probes().items():
        so = build(name, text, args.dir)
        lib = ctypes.CDLL(so)
        for fn in ("aria_moe_prefill_glu", "aria_moe_prefill_down"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
        libs[name] = lib
        print(f"{name}: products (HGMMA, followed by a full wait) {products(so)}", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    E, I, D = 66, 1664, 2560

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    w1, w2 = quantize_expert_int4(randn(1, E, 2 * I, D, scale=D**-0.5),
                                  randn(1, E, I, D, scale=I**-0.5))
    p = backend.ptr

    def call(lib, x_seg, tile_e, rows):
        R = x_seg.shape[0]
        h = torch.empty((R, I), dtype=torch.bfloat16, device=dev)
        out = torch.empty((R, D), dtype=torch.float32, device=dev)
        st = backend.stream()
        for err in (lib.aria_moe_prefill_glu(p(x_seg), p(tile_e), p(rows), p(w1["q4"]),
                                             p(w1["sg"]), p(h), R, D, I, 1, E, 0, st),
                    lib.aria_moe_prefill_down(p(h), p(tile_e), p(rows), p(w2["q4"]), p(w2["s8"]),
                                              p(out), R, D, I, 1, E, 0, st)):
            backend.check(err, "probe")

    def ms(fn, iters=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by = {k: sum(e.self_device_time_total for e in prof.key_averages() if k in e.key)
              / iters / 1e3 for k in ("prefill_glu", "prefill_down")}
        return f"glu {by['prefill_glu']:.4f} down {by['prefill_down']:.4f}"

    for T in (512, 2048, 4096):
        top = torch.topk(torch.randn((T, 64), generator=gen, device=dev), 6, dim=-1).indices
        ind = torch.cat([top, torch.arange(64, 66, device=dev).expand(T, 2)], 1).to(torch.int32)
        dest, tile_e, R, rows = mp.segment_dispatch(ind, E)
        x_seg = torch.zeros((R, D), dtype=torch.bfloat16, device=dev)
        x_seg[dest.long()] = randn(T, D).repeat_interleave(8, dim=0)
        args_ = (x_seg, tile_e, w1["q4"], w1["sg"], w2["q4"], w2["s8"], 0, rows)
        print(f"T={T} kernel: {ms(lambda: mp.moe_prefill_int4(*args_))} ms", flush=True)
        for name, lib in libs.items():
            print(f"T={T} {name}: {ms(lambda: call(lib, x_seg, tile_e, rows))} ms", flush=True)

    bare = ctypes.CDLL(build("bare", BARE, args.dir))
    bare.aria_bare.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_int]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(sms * 256, device=dev)
    for n, rs in ((48, 1), (64, 1), (96, 1), (128, 1), (128, 0)):
        iters = 2000
        backend.check(bare.aria_bare(n, rs, p(out), sms, 10), "bare")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        backend.check(bare.aria_bare(n, rs, p(out), sms, iters), "bare")
        end.record()
        torch.cuda.synchronize()
        flop = sms * 2 * iters * 8 * 2 * 64 * n * 16
        rate = flop / start.elapsed_time(end) / 1e9
        print(f"bare m64n{n}k16, A from {'registers' if rs else 'shared memory'}: {rate:.1f} "
              f"TFLOP/s ({rate / 989 * 100:.1f}% of 989)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
