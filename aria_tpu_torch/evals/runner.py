"""Eval runner: drive a jsonl eval set through the engine and score it.

The port's copy of aria_tpu/evals/runner.py.

The analogue of the reference's per-task evaluation.py mains
(examples/{refcoco,nlvr2,nextqa}/evaluation.py): test.jsonl rows are rendered
with the chat template, generated greedily, and parsed/scored per task.

``generate_fn(prompt_text, images) -> str`` abstracts the model so the runner
is testable without weights; ``make_engine_generate_fn`` adapts the real
serving engine.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, List, Optional, Sequence

from PIL import Image

from aria_tpu_torch.data.chat import build_inference_prompt
from aria_tpu_torch.data.datasets import load_local_dataset
from aria_tpu_torch.evals.parsers import (
    multi_choice_score,
    nlvr2_score,
    parse_multi_choice,
    refcoco_score,
)

GenerateFn = Callable[[str, List[Image.Image]], str]


def _render(example: Dict, num_crops: Sequence[int]) -> str:
    return build_inference_prompt(example["messages"][:-1], num_crops)


def _load_images(example: Dict) -> List[Image.Image]:
    return [Image.open(p).convert("RGB") for p in (example.get("images") or [])]


def _gt_text(example: Dict) -> str:
    last = example["messages"][-1]
    return "".join(c.get("text") or "" for c in last["content"])


def run_eval(
    task: str,
    dataset_dir: str,
    generate_fn: GenerateFn,
    limit: Optional[int] = None,
    seed: int = 42,
) -> Dict[str, float]:
    ds = load_local_dataset(dataset_dir)
    rows = ds.get("test") or ds["train"]
    if limit:
        rows = rows[:limit]

    results = []
    rng = random.Random(seed)
    for ex in rows:
        images = _load_images(ex)
        prompt = _render(ex, [1] * len(images))
        pred = generate_fn(prompt, images)
        if task == "refcoco":
            results.append({"pred": pred, "bbox": ex["bbox"], "hw": ex["hw"]})
        elif task == "nlvr2":
            results.append({"pred": pred, "gt": _gt_text(ex)})
        elif task == "nextqa":
            index2ans = ex["index2ans"]
            all_choices = ex["all_choices"]
            parsed = parse_multi_choice(pred, all_choices, index2ans, rng)
            results.append({"pred": parsed, "gt": _gt_text(ex)})
        else:
            raise ValueError(f"unknown eval task {task}")

    if task == "refcoco":
        return refcoco_score(results)
    if task == "nlvr2":
        return nlvr2_score(results)
    return multi_choice_score(results)


def make_engine_generate_fn(
    engine, tokenizer, *, max_image_size: int = 980, split_image: bool = False,
    max_new_tokens: int = 64,
) -> GenerateFn:
    from aria_tpu_torch.data.processor import AriaProcessor
    from aria_tpu_torch.engine.generate import GenerationConfig

    processor = AriaProcessor(tokenizer)
    stop_ids = tuple(
        t for t in [getattr(tokenizer, "eos_token_id", None)] if t is not None
    )
    gen = GenerationConfig(
        max_new_tokens=max_new_tokens, temperature=0.0, top_k=None,
        stop_token_ids=stop_ids,
    )

    def generate(prompt: str, images: List[Image.Image]) -> str:
        out = processor(prompt, images=images or None, max_image_size=max_image_size,
                        split_image=split_image)
        res = engine.generate(
            out.input_ids[0].tolist(), gen,
            pixel_values=out.pixel_values, pixel_mask=out.pixel_mask,
        )
        text = tokenizer.decode(res.tokens)
        for stop in ("<|im_end|>",):
            text = text.split(stop)[0]
        return text

    return generate
