"""HTTP serving CLI (counterpart of aria_tpu/cli/serve.py):
``python -m aria_tpu_torch.cli.serve --model-path ... --port 8000``.

Continuous-batching server (the vLLM-role component) fronted by a JSON API
(engine/http_server.py). The decoder serves in its int8 form unless
``--bf16`` or ``--tiny`` is given, shared experts fused in; an HF
checkpoint is imported and quantized a layer at a time. Runs on the card
unless ``--device cpu`` is given. ``build(args)`` makes the engine and the
tokenizer from parsed arguments, so a script can drive the same builder
without ``serve_forever``.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    from aria_tpu_torch.cli.infer import add_device_flag

    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", default=None)
    ap.add_argument("--tokenizer-path", default=None)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-lanes", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=2048)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=200)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--paged", action="store_true",
                    help="paged-KV engine: shared page pool + chunked prefill "
                    "+ automatic prefix caching (mixed/long prompts)")
    ap.add_argument("--page-size", type=int, default=256)
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--json-mode", action="store_true",
                    help="compile a JSON-grammar TokenFSM so requests with "
                    "response_format={'type':'json_object'} decode constrained")
    ap.add_argument("--json-schema", default=None, metavar="PATH",
                    help="compile a JSON-Schema TokenFSM (OpenAI structured "
                    "outputs: schema-ordered, all-required properties); "
                    "guided requests conform to this schema exactly")
    ap.add_argument("--logprobs", type=int, default=0, metavar="K",
                    help="report per-token logprobs with K alternatives "
                    "(OpenAI completions `logprobs` field)")
    ap.add_argument("--adapter", action="append", default=[],
                    metavar="NAME=PATH[:RANK[:ALPHA]]",
                    help="serve a LoRA adapter (repeatable): requests select "
                    "it via the OpenAI `model` field; default rank 8 alpha 32")
    add_device_flag(ap)
    return ap.parse_args(argv)


def build(args: argparse.Namespace, cfg=None):
    """(engine, tokenizer) from the parsed arguments (serve.py:42-99);
    ``cfg`` gives the model's shape where the flags do not (a reduced-depth
    checkpoint)."""
    from aria_tpu_torch.checkpoint.io import latest_step, load_checkpoint
    from aria_tpu_torch.cli.infer import load_model_and_tokenizer
    from aria_tpu_torch.engine.server import BatchedEngine, PagedBatchedEngine
    from aria_tpu_torch.ops import backend

    device = backend.device(args.device)
    ns = argparse.Namespace(
        model_path=args.model_path, tokenizer_path=args.tokenizer_path,
        lora_path=None, lora_r=8, lora_alpha=32.0, tiny=args.tiny, device=args.device,
    )
    form = "bf16" if args.bf16 or args.tiny else "int8"
    params, cfg, tokenizer = load_model_and_tokenizer(ns, form=form, cfg=cfg)
    fsm = None
    if args.json_schema:
        import json

        from aria_tpu_torch.engine.guided import schema_fsm

        with open(args.json_schema) as f:
            fsm = schema_fsm(json.load(f), tokenizer, [tokenizer.eos_token_id],
                             vocab_size=cfg.text.vocab_size, device=device)
    elif args.json_mode:
        from aria_tpu_torch.engine.guided import json_fsm

        fsm = json_fsm(tokenizer, [tokenizer.eos_token_id], vocab_size=cfg.text.vocab_size,
                       device=device)
    registry = None
    if args.adapter:
        from aria_tpu_torch.engine.multi_lora import AdapterRegistry
        from aria_tpu_torch.train.lora import LoraConfig

        named, scales = {}, {}
        for spec in args.adapter:
            name, _, rest = spec.partition("=")
            path, *opts = rest.split(":")
            r = int(opts[0]) if opts else 8
            alpha = float(opts[1]) if len(opts) > 1 else 32.0
            tree, _ = load_checkpoint(path, latest_step(path) or 0, device)
            named[name] = tree["lm"] if "lm" in tree else tree
            scales[name] = LoraConfig(rank=r, alpha=alpha).scale
        registry = AdapterRegistry(named, scales, device=device)
    if args.paged:
        engine = PagedBatchedEngine(
            params, cfg, max_lanes=args.max_lanes, max_seq_len=args.max_seq_len,
            page_size=args.page_size, temperature=args.temperature,
            top_k=args.top_k, prefix_cache=not args.no_prefix_cache,
            guided_fsm=fsm, adapters=registry,
        )
    else:
        engine = BatchedEngine(
            params, cfg, max_lanes=args.max_lanes, max_seq_len=args.max_seq_len,
            temperature=args.temperature, top_k=args.top_k, guided_fsm=fsm,
            adapters=registry, logprobs_topk=args.logprobs or None,
        )
    return engine, tokenizer


def main(argv=None):
    from aria_tpu_torch.engine.http_server import serve

    args = parse_args(argv)
    engine, tokenizer = build(args)
    serve(engine, tokenizer, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
