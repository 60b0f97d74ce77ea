"""Plant faults in chip_smoke.py's train-mesh phase and show which held
check reads each.

    python3 tools/train_mesh_faults.py [--faults none,expert-sum,...] [--cpu]

Each fault runs the whole phase (``chip_smoke.run_train_mesh``: 8 ranks of
recipes/config_full.yaml's fsdp 2 x expert 4 mesh, then one rank on the
same batches) with the mesh's ranks changed as follows; one rank's run is
never changed:

- ``none``: no fault, the phase as it is;
- ``expert-sum``: every gradient of a leaf that is replicated over
  ``expert`` summed once more over ``expert`` (a port that forgot that the
  loss is replicated there);
- ``half-batch``: each rank trains on the first half of its rows;
- ``no-update``: the optimizer's moments move, the parameters do not;
- ``wrong-sign``: the parameters move by minus the update.

A fault run prints the phase's readings and the checks that failed; the
tool exits 1 if ``none`` fails or a fault passes. ``--cpu`` runs the phase
at ``AriaConfig.tiny()`` with a 980 px, 1-layer ViT on CPU ranks (a
rehearsal; the card's limits are set for bf16 at full width).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402

FAULTS = ("none", "expert-sum", "half-batch", "no-update", "wrong-sign")
_ENV = "TRAIN_MESH_FAULT"  # read by the spawned ranks, which inherit it
_rank_body = chip_smoke._train_mesh_rank


def _plant(fault: str) -> None:
    """Patch this rank's modules for ``fault``."""
    import torch

    from aria_tpu_torch.parallel import distributed as dd
    from aria_tpu_torch.parallel import fsdp
    from aria_tpu_torch.train import loop, step

    if fault == "expert-sum":
        reduce = fsdp.reduce_grads

        def summed(grads, mesh, specs, **kw):
            out = reduce(grads, mesh, specs, **kw)
            for path, g in out.items():
                if "expert" not in specs.get(path, ()):
                    dd.all_reduce(g, mesh.group("expert"))
            return out

        fsdp.reduce_grads = summed
    elif fault == "half-batch":
        rows = loop.local_batch_rows

        def half(*a, **kw):
            mine = rows(*a, **kw)
            return mine[:max(len(mine) // 2, 1)]

        loop.local_batch_rows = half
    elif fault in ("no-update", "wrong-sign"):
        adamw = step.Optimizer._adamw

        def changed(self, grads, state, params):
            before = {p: t.detach().clone() for p, t in self.trainable(params)}
            adamw(self, grads, state, params)
            with torch.no_grad():
                for p, t in self.trainable(params):
                    t.copy_(before[p] if fault == "no-update" else 2 * before[p] - t)

        step.Optimizer._adamw = changed
    elif fault != "none":
        raise ValueError(f"fault {fault!r}: one of {FAULTS}")


def faulty_rank(rank: int, *args) -> dict:
    """chip_smoke._train_mesh_rank with the fault named in the environment."""
    _plant(os.environ[_ENV])
    return _rank_body(rank, *args)


def _cpu_config():
    from aria_tpu_torch import AriaConfig

    cfg = AriaConfig.tiny()
    vision = dataclasses.replace(cfg.vision, image_size=980, num_layers=1)
    projector = dataclasses.replace(cfg.projector, patch_to_query=((1225, 128), (4900, 256)))
    return cfg.replace(vision=vision, projector=projector)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--faults", default=",".join(FAULTS))
    ap.add_argument("--cpu", action="store_true", help="a rehearsal on CPU ranks")
    args = ap.parse_args()
    import torch

    if args.cpu:
        device, cfg, gpu = torch.device("cpu"), _cpu_config(), "cpu"
    else:
        if not torch.cuda.is_available():
            print("train_mesh_faults: no CUDA device (use --cpu)", file=sys.stderr)
            return 1
        from aria_tpu_torch.ops import _build

        _build.build(verbose=False)
        _build.library()
        device, cfg, gpu = torch.device("cuda", 0), None, chip_smoke._gpu_info()
        print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {gpu}", flush=True)
    chip_smoke._train_mesh_rank = faulty_rank
    wrong = []
    for fault in args.faults.split(","):
        os.environ[_ENV] = fault
        print(f"=== fault: {fault}", flush=True)
        try:
            chip_smoke.run_train_mesh(device, gpu=gpu, cfg=cfg)
            print(f"=== {fault}: every check passed", flush=True)
            if fault != "none":
                wrong.append(f"{fault} passed")
        except AssertionError as exc:
            print(f"=== {fault}: failed: {exc}", flush=True)
            if fault == "none":
                wrong.append(f"none failed: {exc}")
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(f"train_mesh_faults: {'; '.join(wrong) if wrong else 'every fault read'}", flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
