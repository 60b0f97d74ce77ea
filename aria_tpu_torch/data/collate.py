"""Training collation, jsonl examples -> a batch of numpy arrays (the
port's own copy of aria_tpu/data/collate.py): a video becomes one image
message per sampled frame, images become crops, and the chat template is
applied with label masking.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from aria_tpu_torch.data.chat import apply_chat_template_and_tokenize
from aria_tpu_torch.data.tokenizer import Tokenizer
from aria_tpu_torch.data.video import load_video
from aria_tpu_torch.data.vision_processor import AriaVisionProcessor


def _rewrite_video_example(example: Dict[str, Any]) -> Dict[str, Any]:
    """Replace video content with one image content per sampled frame
    (train.py:126-183)."""
    video = example["video"]
    num_frames = video["num_frames"]
    frames = load_video(video["path"], num_frames)
    if not frames:
        raise ValueError(f"no frames decoded from {video['path']}")
    messages = []
    for m in example["messages"]:
        content = []
        for c in m["content"]:
            if c["type"] == "video":
                content.extend({"type": "image"} for _ in frames)
            else:
                content.append(c)
        messages.append({"role": m["role"], "content": content})
    return {"messages": messages, "pil_images": frames}


def collate_fn(
    examples: Sequence[Dict[str, Any]],
    tokenizer: Tokenizer,
    image_processor: Optional[AriaVisionProcessor] = None,
    max_length: int = 1024,
    max_image_size: int = 980,
    split_image: bool = False,
) -> Dict[str, np.ndarray]:
    image_processor = image_processor or AriaVisionProcessor()
    messages_batch: List[List[Dict]] = []
    images: List[Image.Image] = []

    for ex in examples:
        if ex.get("video"):
            rewritten = _rewrite_video_example(ex)
            messages_batch.append(rewritten["messages"])
            images.extend(rewritten["pil_images"])
        else:
            messages_batch.append(ex["messages"])
            for p in ex.get("images") or []:
                images.append(Image.open(p).convert("RGB") if isinstance(p, str) else p)

    batch: Dict[str, np.ndarray] = {}
    if images:
        img_batch = image_processor(
            images, max_image_size=max_image_size, split_image=split_image
        )
        batch["pixel_values"] = img_batch.pixel_values
        batch["pixel_mask"] = img_batch.pixel_mask
        crop_iter = iter(img_batch.num_crops.tolist())
    else:
        crop_iter = iter(())

    batch.update(
        apply_chat_template_and_tokenize(
            messages_batch, tokenizer,
            num_image_crop=crop_iter,
            max_length=max_length, max_image_size=max_image_size,
        )
    )
    return batch
