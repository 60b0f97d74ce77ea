#!/usr/bin/env python3
"""Where a decode step of the PyTorch port spends its time, on one GPU.

    python3 tools/profile_torch_decode.py [--steps 20]

Random-inits the full 28-layer int4 serving model on the card, prefills
a 48-token prompt, then decodes ``--steps`` tokens under
``torch.profiler``. Prints the host wall time per step, the device
time per step (sum of kernel times), the device's idle share, and the
kernels and host ops that take the most time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from aria_tpu_torch import AriaConfig
    from aria_tpu_torch.engine.sampling import sample
    from aria_tpu_torch.models.moe_lm import KVCache, init_lm_params_serving_int4, lm_forward

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_decode: needs a CUDA device", file=sys.stderr)
        return 1

    dev = torch.device("cuda", 0)
    text = AriaConfig().text
    gen = torch.Generator(device=dev).manual_seed(0)
    lm = init_lm_params_serving_int4(text, gen, device=dev)
    cache = KVCache.init(text, 1, 1024, torch.int8, device=dev)
    tokens = torch.full((1, 64), 11, dtype=torch.long, device=dev)

    def step(tok, pos):
        out = lm_forward(lm, text, tok[:, None].long(), positions=torch.full((1,), pos, device=dev),
                         cache=cache, cache_pos=pos)
        return sample(gen, out.logits[:, -1], 0.8, 200)

    with torch.inference_mode():
        out = lm_forward(lm, text, tokens, positions=torch.arange(64, device=dev), cache=cache,
                         cache_pos=0, logit_position=47, causal_flash=True)
        tok = sample(gen, out.logits[:, 0], 0.8, 200)
        pos = 48
        for _ in range(3):  # warm-up
            tok = step(tok, pos)
            pos += 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()  # wall time with the profiler off
        for _ in range(args.steps):
            tok = step(tok, pos)
            pos += 1
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                tok = step(tok, pos)
                pos += 1
            torch.cuda.synchronize()
            wall_profiled = (time.perf_counter() - t0) / args.steps

    events = prof.key_averages()
    device = sum(e.self_device_time_total for e in events  # device events only
                 if e.device_type == torch.autograd.DeviceType.CUDA) / args.steps / 1e6
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel") / args.steps
    print(f"{torch.cuda.get_device_name(0)}, {text.num_layers}-layer flagship model, "
          f"{args.steps} decode steps")
    print(f"wall per step: {wall * 1e3:.3f} ms (profiler off), {wall_profiled * 1e3:.3f} ms "
          f"(profiler on); device busy per step: {device * 1e3:.3f} ms; device idle share "
          f"(profiler off): {1 - device / wall:.3f}; kernel launches per step: {launches:.0f}")
    print(events.table(sort_by="self_device_time_total", row_limit=25))
    print(events.table(sort_by="self_cpu_time_total", row_limit=25))
    return 0


if __name__ == "__main__":
    sys.exit(main())
