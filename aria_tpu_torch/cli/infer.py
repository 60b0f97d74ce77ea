"""Inference CLI (counterpart of aria_tpu/cli/infer.py; reference
aria/inference.py:30-153):

    python -m aria_tpu_torch.cli.infer --model-path <ckpt> --tokenizer-path <tok> \
        --image-path img.png --prompt "describe the image" [--lora-path ...]

Loads an HF safetensors or a native checkpoint (or random weights from
seed 0), optionally merges a LoRA adapter, renders the chat template, and
greedily/temperature-decodes with stop on <|im_end|>. Runs on the card
(``--device cuda``, the default) unless ``--device cpu`` is given; without
a card and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import os

import torch


def serving_form(params: dict, form: str, num_shared: int) -> dict:
    """A training tree in a serving form: the shared experts fused into the
    expert stacks, then for ``"int8"`` the decoder quantized
    (``quantize_params(fuse_shared_experts(params))``)."""
    from aria_tpu_torch.ops.quant import fuse_shared_experts, quantize_params

    if "shared_w1" in params["lm"]["layers"]:
        params = fuse_shared_experts(params, num_shared)
    return quantize_params(params) if form == "int8" else params


def load_model_and_tokenizer(args, form=None, cfg=None):
    """(params, cfg, tokenizer) on ``args.device``, with the branches of
    aria_tpu/cli/infer.py:16-48: an HF safetensors directory, a native
    checkpoint, random init, an optional LoRA merge, ``ByteTokenizer`` when
    no tokenizer path is given.

    ``form`` None returns a checkpoint's tree as the reference serves it
    (the training tree: float weights, shared experts unfused); ``"bf16"``
    or ``"int8"`` the serving form. Random weights are drawn in the served
    form (bf16 when ``form`` is None), slab by slab
    (``init_lm_params_serving``: no whole float stack exists beside the
    served one), unless a LoRA is to be merged into them; an HF checkpoint
    in a serving form is imported a decoder layer at a time
    (``import_hf_serving``). ``cfg`` is the model's shape when the flags'
    (``--tiny`` or the flagship) are not: an HF directory carries none.

    The config's ``image_token_id`` is the tokenizer's: the prompt's
    ``<|img|>`` id is what the image features replace (``ByteTokenizer``'s
    is 256, the flagship config's 9)."""
    from aria_tpu_torch.checkpoint.io import (
        import_hf_checkpoint,
        import_hf_serving,
        latest_step,
        load_checkpoint,
    )
    from aria_tpu_torch.config import AriaConfig
    from aria_tpu_torch.data.tokenizer import ByteTokenizer, load_tokenizer
    from aria_tpu_torch.models.aria import init_aria_params
    from aria_tpu_torch.models.moe_lm import init_lm_params_serving
    from aria_tpu_torch.models.projector import init_projector_params
    from aria_tpu_torch.models.vit import init_vit_params
    from aria_tpu_torch.ops import backend

    device = backend.device(args.device)
    cfg = cfg or (AriaConfig.tiny() if args.tiny else AriaConfig.aria_25b())
    dtype = torch.float32 if args.tiny else torch.bfloat16
    ns = cfg.text.num_shared_experts
    whole = form is None or args.lora_path  # a LoRA merges into the training tree
    served = False  # already in ``form``

    if args.model_path and os.path.isdir(args.model_path):
        if any(f.endswith(".safetensors") for f in os.listdir(args.model_path)):
            if whole:
                params = import_hf_checkpoint(args.model_path, cfg, dtype, device=device)
            else:
                params = import_hf_serving(args.model_path, cfg, form=form, dtype=dtype,
                                           device=device)
                served = True
        else:
            step = latest_step(args.model_path)
            params, saved_cfg = load_checkpoint(args.model_path, step or 0, device)
            cfg = saved_cfg or cfg
    else:
        gen = torch.Generator(device=device).manual_seed(0)
        if args.lora_path:
            params = init_aria_params(cfg, gen, device=device, dtype=dtype)
        else:  # drawn in the served form: bf16 (fused) unless int8 is asked for
            params = {"vision": init_vit_params(cfg.vision, gen, device=device, dtype=dtype),
                      "projector": init_projector_params(cfg.projector, gen, device=device,
                                                         dtype=dtype),
                      "lm": init_lm_params_serving(cfg.text, gen, form=form or "bf16",
                                                   device=device, dtype=dtype)}
            served = True

    if args.lora_path:
        from aria_tpu_torch.train.lora import LoraConfig, merge_lora

        lora, _ = load_checkpoint(args.lora_path, latest_step(args.lora_path) or 0, device)
        params = merge_lora(params, lora, LoraConfig(rank=args.lora_r, alpha=args.lora_alpha))
    if form is not None and not served:
        params = serving_form(params, form, ns)

    tokenizer = load_tokenizer(args.tokenizer_path) if args.tokenizer_path else ByteTokenizer()
    return params, cfg.replace(image_token_id=tokenizer.image_token_id), tokenizer


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu for a run without a card)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", default=None)
    ap.add_argument("--tokenizer-path", default=None)
    ap.add_argument("--lora-path", default=None)
    ap.add_argument("--lora-r", type=int, default=8)
    ap.add_argument("--lora-alpha", type=float, default=32.0)
    ap.add_argument("--image-path", default=None)
    ap.add_argument("--prompt", required=True)
    ap.add_argument("--max-image-size", type=int, default=980, choices=[490, 980])
    ap.add_argument("--split-image", action="store_true")
    ap.add_argument("--max-new-tokens", type=int, default=500)
    ap.add_argument("--temperature", type=float, default=0.9)
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--max-seq-len", type=int, default=4096)
    ap.add_argument("--tiny", action="store_true", help="random tiny model (smoke test)")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    from PIL import Image

    from aria_tpu_torch.data.chat import build_inference_prompt
    from aria_tpu_torch.data.processor import AriaProcessor
    from aria_tpu_torch.engine.generate import Engine, GenerationConfig

    params, cfg, tokenizer = load_model_and_tokenizer(args)

    content = []
    images = None
    if args.image_path:
        images = [Image.open(args.image_path).convert("RGB")]
        content.append({"type": "image"})
    content.append({"type": "text", "text": args.prompt})
    messages = [{"role": "user", "content": content}]
    prompt = build_inference_prompt(messages, [1] * (1 if images else 0))

    processor = AriaProcessor(tokenizer)
    out = processor(prompt, images=images, max_image_size=args.max_image_size,
                    split_image=args.split_image)

    engine = Engine(params, cfg, max_seq_len=args.max_seq_len)
    stop_ids = tuple(t for t in [getattr(tokenizer, "eos_token_id", None)] if t is not None)
    gen = GenerationConfig(
        max_new_tokens=args.max_new_tokens,
        temperature=0.0 if args.greedy else args.temperature,
        top_k=None if args.greedy else 200,
        stop_token_ids=stop_ids,
    )
    res = engine.generate(
        out.input_ids[0].tolist(), gen,
        pixel_values=out.pixel_values, pixel_mask=out.pixel_mask,
    )
    text = tokenizer.decode(res.tokens).split("<|im_end|>")[0]
    print(text)
    print(f"\n[{res.steps} tokens, prefill {res.prefill_s*1e3:.0f}ms, "
          f"{res.tokens_per_s:.1f} tok/s]")


if __name__ == "__main__":
    main()
