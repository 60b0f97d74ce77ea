"""Build and load the hand kernels in ``aria_tpu_torch/csrc``.

At first use, one ``nvcc`` call compiles every ``.cu`` source for sm_90a
into a shared library with a plain C interface under
``aria_tpu_torch/_build/`` (listed in ``.gitignore``); the library is named
by a hash of the sources and flags, so an edit rebuilds it. It is loaded with
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

FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argtypes (all return int: the cudaError_t)
SIGNATURES = {
    # x, q4t, sg, out, T, D, F, layer, stream
    "aria_dense_int4": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # q, k, v, k_scale, v_scale, lengths, out, B, H, S, layer, quantized, stream
    "aria_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # q, k, v, out, B, S, H, scale, stream
    "aria_flash_causal": [_P, _P, _P, _P, _I, _I, _I, _F, _P],
    # x, xq, sx, T, D, ng, stream
    "aria_act_quant_int8": [_P, _P, _P, _I, _I, _I, _P],
    # xq, sx, ids, valid, wd, w1q4, w1sg, w2q4, w2s8, h, hq, sh, hsum, part, out,
    # T, D, I, E, U, ng, layer, stream
    "aria_moe_w4a8": [_P] * 15 + [_I] * 7 + [_P],
}


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
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


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless the current library exists; returns its
    path. ``verbose`` adds ``-Xptxas -v`` and prints the compiler output."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), *(str(p) for p in _sources() if p.suffix == ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if verbose or proc.returncode != 0:
        print(proc.stdout + proc.stderr, flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
