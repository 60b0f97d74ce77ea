"""The kernel switch.

A kernel wrapper launches its CUDA kernel when its tensors lie on a CUDA
device and runs its plain PyTorch version when they lie on the CPU. There is
nothing else: no environment override, and no fallback from a failed build
or launch to the plain version — a CUDA tensor gets the kernel or an error.

Each wrapper carries a plain integer ``launches`` attribute that it raises by
one where it launches its kernel, so a run can show which kernels it went
through (``chip_smoke.py`` resets and reads them).
"""

from __future__ import annotations

import ctypes
import functools

import torch


def device(dev="cuda") -> torch.device:
    """The device an entry point builds on: the card unless the caller names
    another. A CUDA device without a card raises; nothing falls back to the
    CPU."""
    dev = torch.device(dev)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build on the CPU")
    return dev


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device, False when every one
    lies on the CPU; a mix raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs on mixed or unsupported devices: {sorted(kinds)}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple | None = None):
    """Check what a kernel takes: dtype, shape and contiguity."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    """A tensor's device address for a ``c_void_p`` argument (None -> NULL)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


@functools.cache
def sm_count(dev: torch.device) -> int:
    """The card's streaming multiprocessors, read once per device: the
    kernels that size their grids by it take it from here."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


_workspaces: dict = {}  # device -> (f32 partials, zeroed counters)


def workspace(dev: torch.device, floats: int, counters: int):
    """The split kernels' workspace on ``dev`` (decode attention over
    positions, ``dense_int4`` over D-groups), grown to at least the sizes
    asked: f32 partials, and int32 counters each kernel leaves at 0. Calls
    run in the order of one stream, so one workspace per device serves
    them all."""
    ws, cnt = _workspaces.get(dev, (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.empty(max(floats, 1 << 16), dtype=torch.float32, device=dev)
    if cnt is None or cnt.numel() < counters:
        cnt = torch.zeros(max(counters, 1 << 12), dtype=torch.int32, device=dev)
    _workspaces[dev] = (ws, cnt)
    return ws, cnt


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check(err: int, name: str) -> None:
    """Raise on the cudaError_t a C entry point returned."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")

