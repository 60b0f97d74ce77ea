"""Eval CLI (counterpart of aria_tpu/cli/eval.py):
``python -m aria_tpu_torch.cli.eval --task refcoco --dataset <dir> ...``

Runs a jsonl eval set (test.jsonl with GT in the final assistant message;
refcoco rows additionally carry "bbox" and "hw") through the serving engine
and prints the task metric — the analogue of examples/*/evaluation.py.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    from aria_tpu_torch.cli.infer import add_device_flag

    ap = argparse.ArgumentParser()
    ap.add_argument("--task", required=True, choices=["refcoco", "nlvr2", "nextqa"])
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--model-path", default=None)
    ap.add_argument("--tokenizer-path", default=None)
    ap.add_argument("--max-image-size", type=int, default=980, choices=[490, 980])
    ap.add_argument("--split-image", action="store_true")
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--max-seq-len", type=int, default=4096)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--tiny", action="store_true")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    from aria_tpu_torch.cli.infer import load_model_and_tokenizer
    from aria_tpu_torch.engine.generate import Engine
    from aria_tpu_torch.evals.runner import make_engine_generate_fn, run_eval

    ns = argparse.Namespace(
        model_path=args.model_path, tokenizer_path=args.tokenizer_path,
        lora_path=None, lora_r=8, lora_alpha=32.0, tiny=args.tiny, device=args.device,
    )
    params, cfg, tokenizer = load_model_and_tokenizer(ns)
    engine = Engine(params, cfg, max_seq_len=args.max_seq_len)
    generate_fn = make_engine_generate_fn(
        engine, tokenizer, max_image_size=args.max_image_size,
        split_image=args.split_image, max_new_tokens=args.max_new_tokens,
    )
    metrics = run_eval(args.task, args.dataset, generate_fn, limit=args.limit)
    print(json.dumps(metrics))


if __name__ == "__main__":
    main()
