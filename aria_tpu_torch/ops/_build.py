"""Build and load the hand kernels in ``aria_tpu_torch/csrc``.

At first use, one ``nvcc`` process per ``.cu`` source, all started
together, compiles the sources for sm_90a, and one more links them into a
shared library with a plain C interface under ``aria_tpu_torch/_build/``
(listed in ``.gitignore``); the library is named by a hash of the sources
and flags, so an edit rebuilds it. It is loaded with
``ctypes``: pointers and the stream go as ``c_void_p``, and each entry point
returns ``cudaGetLastError()``. A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
LINK_FLAGS = [*ARCH, "-shared"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argtypes (all return int: the cudaError_t)
SIGNATURES = {
    # x, q4t, sg, out, ws, counters, T, D, F, L, layer, stream (ws and counters
    # NULL but where K is split over the D-groups, at most 8 rows)
    "aria_dense_int4": [_P] * 6 + [_I] * 5 + [_P],
    # x, xq, sx, q4t, sg, out, ws, counters, T, D, F, L, layer, stream (x, ws and
    # counters at most 8 rows, xq and sx above; the others NULL)
    "aria_dense_int4_a8": [_P] * 8 + [_I] * 5 + [_P],
    # q, k, v, k_scale, v_scale, lengths, out, acc, m, s, ws, counters, B, Hx, S, layer,
    # kind, P, qscale, stream (acc, m, s NULL but in the stats form, out NULL in it; ws
    # and counters NULL when P = 1)
    "aria_decode_attention": [_P] * 12 + [_I] * 6 + [_F, _P],
    # q, k, v, k_scale, v_scale, table, lengths, out, ws, counters, B, H, NP, PS, MAXP,
    # layer, quantized, P, qscale, stream (ws and counters NULL when P = 1)
    "aria_paged_decode_attention": [_P] * 10 + [_I] * 8 + [_F, _P],
    # k, v, k_scale, v_scale, k_new, v_new, ks_new, vs_new, rows, slots,
    # B, R, Hc, S, row_bytes, Hs, scale_bytes, layer, stream
    "aria_kv_write": [_P] * 10 + [_I] * 8 + [_P],
    # qkv, cos, sin, k, v, k_scale, v_scale, rows, slots, q_out, k_out, v_out, T, Tc, H, R,
    # S, layer, mode, low, null_page, stream (scales NULL for a bf16 cache; k_out and
    # v_out NULL at decode)
    "aria_rope_kv_write": [_P] * 12 + [_I] * 9 + [_P],
    # q, k, v, out, lse, B, S, H, scale, sms, stream
    "aria_flash_causal": [_P] * 5 + [_I] * 3 + [_F, _I, _P],
    # q, k, v, o, do, lse, ws, dq_acc, counters, dq, dk, dv, B, S, H, scale, stream
    "aria_flash_causal_bwd": [_P] * 12 + [_I] * 3 + [_F, _P],
    # x, xq, sx, T, D, ng, stream
    "aria_act_quant_int8": [_P, _P, _P, _I, _I, _I, _P],
    # x, indices, weights, w_bf16, w1q4, w1sg, w2q4, w2s8, xs, sxs, wsort, pos, meta, h, hq,
    # sh, part, out, T, k, D, I, L, E, U, ng, layer, stream
    "aria_moe_w4a8": [_P] * 3 + [_I] + [_P] * 14 + [_I] * 9 + [_P],
    # q, k, v, kv_valid, out, B, S, H, D, scale, stream
    "aria_vit_flash": [_P] * 5 + [_I] * 4 + [_F, _P],
    # q, k, v, q_valid, kv_valid, out, stats, B, Sq, Sk, H, D, scale, stream (stats NULL
    # but in training)
    "aria_flash_segment": [_P] * 7 + [_I] * 5 + [_F, _P],
    # q, k, v, o, do, stats, q_valid, kv_valid, qs, qflags, dq_acc, counters, dq, dk, dv,
    # B, Sq, Sk, H, D, scale, stream
    "aria_flash_segment_bwd": [_P] * 15 + [_I] * 5 + [_F, _P],
    # x_seg, tile_expert, tile_rows, w1q4, w1sg, h, R, D, I, L, E, layer, stream
    "aria_moe_prefill_glu": [_P] * 6 + [_I] * 6 + [_P],
    # h, tile_expert, tile_rows, w2q4, w2s8, out, R, D, I, L, E, layer, stream
    "aria_moe_prefill_down": [_P] * 6 + [_I] * 6 + [_P],
    # x, ids, valid, wd, w1, w2, h, part, out, T, D, I, E, U, layer, stream
    "aria_moe_decode_bf16": [_P] * 9 + [_I] * 6 + [_P],
    # x, indices, weights, w_bf16, w1, s1, w2, s2 (int4: w1q4, w1sg, w2q4, w2s8; int8: w1q,
    # its s8, w2q, its s8), xs, wsort, pos, meta, work, h, part, out, T, k, D, I, L, E, U,
    # layer, stream
    "aria_moe_bf16x_int4": [_P] * 3 + [_I] + [_P] * 12 + [_I] * 8 + [_P],
    "aria_moe_bf16x_int8": [_P] * 3 + [_I] + [_P] * 12 + [_I] * 8 + [_P],
    # lhs, rhs, group_sizes, out, M, K, N, E, rhs_kmajor, stream
    "aria_gmm": [_P] * 4 + [_I] * 5 + [_P],
    # x, hi, lo, flags, M, N, stream
    "aria_split_hi_lo": [_P] * 4 + [_I] * 2 + [_P],
    # hi, lo, flags, rhs, group_sizes, out, M, K, N, E, rhs_kmajor, stream
    "aria_gmm_dlhs": [_P] * 6 + [_I] * 5 + [_P],
    # lhs, hi, lo, flags, group_sizes, out, M, K, N, E, stream
    "aria_tgmm": [_P] * 6 + [_I] * 4 + [_P],
    # q, s, out, eb, R, D, group, mode, out_f32, stream
    "aria_expert_dequant": [_P] * 3 + [_I] * 6 + [_P],
}


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libaria_kernels-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _run_all(cmds: list[list[str]], verbose: bool) -> None:
    """Run the commands at once and wait for every one; raise if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    failed = [f"nvcc failed ({p.returncode}): {' '.join(p.args)}\n{log}"
              for p, log in zip(procs, logs) if p.returncode != 0]
    if verbose:
        print("".join(logs), flush=True)
    if failed:
        raise RuntimeError("\n".join(failed))


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless the current library exists; returns its
    path. ``verbose`` adds ``-Xptxas -v`` and prints the compiler output."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    srcs = [p for p in _sources() if p.suffix == ".cu"]
    objs = [BUILD_DIR / f"{p.stem}.{tag}.o" for p in srcs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    ptxas = ["-Xptxas", "-v"] if verbose else []
    try:
        _run_all([[nvcc, *COMPILE_FLAGS, *ptxas, "-c", str(s), "-o", str(o)]
                  for s, o in zip(srcs, objs)], verbose)
        _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]], verbose)
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
