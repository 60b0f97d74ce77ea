"""Metrics logging and profiling hooks (the port's own copy of
aria_tpu/utils/metrics.py): a JSONL writer, one line per step, echoed to
stdout; a step timer; and a ``torch.profiler`` trace in place of the JAX
profiler's.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, output_dir: str, echo: bool = True, enabled: bool = True):
        self.enabled = enabled
        self.echo = echo
        self._f = None
        if enabled:
            os.makedirs(output_dir, exist_ok=True)
            self._f = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        if not self.enabled:
            return
        rec = {"step": step, "time": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.echo:
            pretty = " ".join(f"{k}={float(v):.4g}" for k, v in metrics.items())
            print(f"[step {step}] {pretty}", flush=True)

    def close(self) -> None:
        if self._f:
            self._f.close()


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """Write a ``torch.profiler`` trace of the CPU and, where there is one,
    the card (a Chrome trace, ``trace.json`` in ``log_dir``) when
    ``log_dir`` is set; no-op otherwise."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling step timing (steps/s, tokens/s)."""

    def __init__(self):
        self._last = time.perf_counter()

    def lap(self, tokens: int = 0) -> Dict[str, float]:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        out = {"step_time_s": dt}
        if tokens:
            out["tokens_per_s"] = tokens / dt
        return out
