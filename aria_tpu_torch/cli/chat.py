"""Terminal chat REPL (counterpart of aria_tpu/cli/chat.py; reference
gptfast/chat.py:15-122): ``python -m aria_tpu_torch.cli.chat [--device cpu]``.

History is re-rendered through the chat template each turn; an optional image
attaches to the first user message. Commands: /exit, /reset, /image <path>.
"""

from __future__ import annotations

import argparse
from typing import Dict, List


class AriaChat:
    def __init__(self, engine, tokenizer, *, max_image_size: int = 980,
                 max_new_tokens: int = 512, temperature: float = 0.8):
        from aria_tpu_torch.data.processor import AriaProcessor
        from aria_tpu_torch.engine.generate import GenerationConfig

        self.engine = engine
        self.tokenizer = tokenizer
        self.processor = AriaProcessor(tokenizer)
        self.max_image_size = max_image_size
        self.history: List[Dict] = []
        self.images: List = []
        stop_ids = tuple(t for t in [getattr(tokenizer, "eos_token_id", None)] if t is not None)
        self.gen = GenerationConfig(
            max_new_tokens=max_new_tokens, temperature=temperature, top_k=200,
            stop_token_ids=stop_ids,
        )

    def reset(self):
        self.history = []
        self.images = []

    def add_image(self, image):
        self.images.append(image)

    def ask(self, text: str) -> str:
        from aria_tpu_torch.data.chat import build_inference_prompt

        content = []
        n_new_images = 0
        if len(self.images) > sum(
            1 for m in self.history for c in m["content"] if c["type"] == "image"
        ):
            content.append({"type": "image"})
            n_new_images = 1
        content.append({"type": "text", "text": text})
        self.history.append({"role": "user", "content": content})

        prompt = build_inference_prompt(self.history, [1] * len(self.images))
        out = self.processor(
            prompt, images=self.images or None, max_image_size=self.max_image_size
        )
        res = self.engine.generate(
            out.input_ids[0].tolist(), self.gen,
            pixel_values=out.pixel_values, pixel_mask=out.pixel_mask,
        )
        reply = self.tokenizer.decode(res.tokens).split("<|im_end|>")[0].strip()
        self.history.append(
            {"role": "assistant", "content": [{"type": "text", "text": reply}]}
        )
        return reply


def main(argv=None):
    from aria_tpu_torch.cli.infer import add_device_flag

    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", default=None)
    ap.add_argument("--tokenizer-path", default=None)
    ap.add_argument("--max-image-size", type=int, default=980, choices=[490, 980])
    ap.add_argument("--max-seq-len", type=int, default=4096)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--tiny", action="store_true")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    from PIL import Image

    from aria_tpu_torch.cli.infer import load_model_and_tokenizer
    from aria_tpu_torch.engine.generate import Engine

    ns = argparse.Namespace(
        model_path=args.model_path, tokenizer_path=args.tokenizer_path,
        lora_path=None, lora_r=8, lora_alpha=32.0, tiny=args.tiny, device=args.device,
    )
    params, cfg, tokenizer = load_model_and_tokenizer(ns)
    engine = Engine(params, cfg, max_seq_len=args.max_seq_len)
    chat = AriaChat(engine, tokenizer, max_image_size=args.max_image_size,
                    temperature=args.temperature)

    print("aria-tpu chat — /image <path> to attach, /reset, /exit")
    while True:
        try:
            line = input("> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not line:
            continue
        if line == "/exit":
            break
        if line == "/reset":
            chat.reset()
            print("(history cleared)")
            continue
        if line.startswith("/image "):
            path = line.split(" ", 1)[1].strip()
            chat.add_image(Image.open(path).convert("RGB"))
            print(f"(attached {path})")
            continue
        print(chat.ask(line))


if __name__ == "__main__":
    main()
