"""Train CLI: ``python -m aria_tpu_torch.cli.train --config
recipes/config_lora.yaml [--key value ...]`` (counterpart of
aria_tpu/cli/train.py), any recipe key overridable on the command line.
On the card unless ``--device cpu`` (or ``--cpu``). When the recipe's mesh
(``mesh_data`` x ``mesh_fsdp`` x ``mesh_expert``) needs more than one
rank, the ranks are spawned on this host (``loop.train_on_ranks``): over
nccl when ``torch.cuda.device_count()`` gives each rank a card of its own,
else over gloo, the ranks sharing the card (or the CPU).
"""

from __future__ import annotations

import argparse
import sys


def parse_overrides(argv):
    out = {}
    i = 0
    while i < len(argv):
        if not argv[i].startswith("--"):
            raise SystemExit(f"unexpected argument {argv[i]}")
        key = argv[i][2:]
        if i + 1 >= len(argv) or argv[i + 1].startswith("--"):
            out[key] = "true"
            i += 1
        else:
            out[key] = argv[i + 1]
            i += 2
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(add_help=True)
    ap.add_argument("--config", default=None, help="recipe YAML path")
    ap.add_argument("--tiny", action="store_true", help="use the tiny test model config")
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    args, rest = ap.parse_known_args(argv)

    from aria_tpu_torch.config import AriaConfig
    from aria_tpu_torch.train.loop import recipe_mesh, train, train_on_ranks
    from aria_tpu_torch.train.recipe import load_recipe

    recipe = load_recipe(args.config, parse_overrides(rest))
    cfg = AriaConfig.tiny() if args.tiny else None
    device = "cpu" if args.cpu else args.device
    if recipe_mesh(recipe) is None:
        train(recipe, cfg=cfg, max_steps=args.max_steps, device=device)
    else:
        train_on_ranks(recipe, cfg=cfg, max_steps=args.max_steps, device=device)


if __name__ == "__main__":
    main()
