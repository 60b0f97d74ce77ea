"""Combined text+image processor for inference (the port's copy of
aria_tpu/data/processor.py).

Parity target: reference AriaProcessor (processing_aria.py:41-205). Each
``<|img|>`` placeholder in the prompt is expanded first by the image's crop
count, then by 128 (490px) / 256 (980px) image tokens, and the prompt is
tokenized alongside the processed pixel values.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Sequence, Union

import numpy as np
from PIL import Image

from aria_tpu_torch.data.chat import expand_image_tokens, image_tokens_per_crop
from aria_tpu_torch.data.tokenizer import IMAGE_TOKEN, Tokenizer
from aria_tpu_torch.data.vision_processor import AriaVisionProcessor


@dataclasses.dataclass
class ProcessorOutput:
    input_ids: np.ndarray  # [B, S] int32 (padded if batched)
    attention_mask: np.ndarray  # [B, S] bool
    pixel_values: Optional[np.ndarray] = None  # [N, 3, S, S] float32
    pixel_mask: Optional[np.ndarray] = None  # [N, S, S] bool
    prompts: Optional[List[str]] = None


class AriaProcessor:
    def __init__(
        self,
        tokenizer: Tokenizer,
        image_processor: Optional[AriaVisionProcessor] = None,
    ):
        self.tokenizer = tokenizer
        self.image_processor = image_processor or AriaVisionProcessor()

    def __call__(
        self,
        text: Union[str, Sequence[str]],
        images: Optional[Sequence[Image.Image]] = None,
        max_image_size: int = 980,
        split_image: bool = False,
        pad_to_multiple: int = 1,
    ) -> ProcessorOutput:
        if isinstance(text, str):
            text = [text]
        prompts = list(text)
        pixel_values = pixel_mask = None

        if images is not None and len(images):
            batch = self.image_processor(
                images, max_image_size=max_image_size, split_image=split_image
            )
            pixel_values, pixel_mask = batch.pixel_values, batch.pixel_mask
            # Expand each <|img|> by its image's crop count, in order
            # (processing_aria.py:160-170).
            crop_iter = iter(batch.num_crops.tolist())
            prompts = [
                re.sub(
                    re.escape(IMAGE_TOKEN),
                    lambda _: IMAGE_TOKEN * next(crop_iter),
                    p,
                )
                for p in prompts
            ]
            per_crop = image_tokens_per_crop(max_image_size)
            prompts = [expand_image_tokens(p, per_crop) for p in prompts]

        encoded = [self.tokenizer.encode(p) for p in prompts]
        max_len = max(len(e) for e in encoded)
        if pad_to_multiple > 1:
            max_len = -(-max_len // pad_to_multiple) * pad_to_multiple
        pad_id = self.tokenizer.pad_token_id
        input_ids = np.full((len(encoded), max_len), pad_id, np.int32)
        attn = np.zeros((len(encoded), max_len), bool)
        for i, e in enumerate(encoded):
            # left-pad batched prompts (decoder-only convention used by the
            # reference eval harnesses, examples/refcoco/evaluation.py:68)
            input_ids[i, max_len - len(e):] = e
            attn[i, max_len - len(e):] = True

        return ProcessorOutput(input_ids, attn, pixel_values, pixel_mask, prompts)
