"""Chat templating and training tokenization (the port's own copy of
aria_tpu/data/chat.py): every message becomes
``<|im_start|>{role}\\n{text}<|im_end|>\\n``, image content
``<fim_prefix>{<|img|> * num_crops}<fim_suffix>`` with each ``<|img|>``
expanded 128x (490px) or 256x (980px); labels are -100 on user messages,
on padding and on the assistant prefix.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np

from aria_tpu_torch.data.tokenizer import (
    FIM_PREFIX,
    FIM_SUFFIX,
    IM_END,
    IM_START,
    IMAGE_TOKEN,
    Tokenizer,
)

IGNORE_TOKEN_ID = -100


def image_tokens_per_crop(max_image_size: int) -> int:
    if max_image_size == 490:
        return 128
    if max_image_size == 980:
        return 256
    raise ValueError(f"max_image_size must be either 490 or 980, got {max_image_size}")


def _content_to_text(content: Dict, num_image_crop: Iterator[int]) -> str:
    if content["type"] == "text":
        return content["text"]
    if content["type"] == "image":
        return FIM_PREFIX + IMAGE_TOKEN * next(num_image_crop) + FIM_SUFFIX
    raise ValueError(f"Unknown content type {content['type']} in message")


def build_inference_prompt(messages: Sequence[Dict], num_crops: Sequence[int] = ()) -> str:
    """Conversation -> prompt string ending with the assistant header."""
    crop_iter = iter(num_crops)
    parts = []
    for m in messages:
        text = "".join(_content_to_text(c, crop_iter) for c in m["content"])
        parts.append(f"{IM_START}{m['role']}\n{text}{IM_END}\n")
    parts.append(f"{IM_START}assistant\n")
    return "".join(parts)


def expand_image_tokens(text: str, tokens_per_crop: int) -> str:
    return text.replace(IMAGE_TOKEN, IMAGE_TOKEN * tokens_per_crop)


def apply_chat_template_and_tokenize(
    messages_batch: List[List[Dict]],
    tokenizer: Tokenizer,
    num_image_crop: Iterator[int] = iter(()),
    max_length: int = 1024,
    max_image_size: int = 980,
) -> Dict[str, np.ndarray]:
    """Training tokenization with label masking (reference data.py:29-120)."""
    im_start = tokenizer.encode(IM_START)
    user_toks = tokenizer.encode("user")
    assistant_toks = tokenizer.encode("assistant")
    im_end = tokenizer.encode(IM_END)
    nl = tokenizer.encode("\n")
    n_img_tokens = image_tokens_per_crop(max_image_size)

    def tokenize_message(role: str, text: str) -> List[int]:
        return (
            im_start
            + (user_toks if role == "user" else assistant_toks)
            + nl
            + tokenizer.encode(text)
            + im_end
            + nl
        )

    def make_target(role: str, ids: List[int]) -> List[int]:
        if role == "user":
            return [IGNORE_TOKEN_ID] * len(ids)
        if role == "assistant":
            prefix = len(im_start) + len(assistant_toks) + len(nl)
            return [IGNORE_TOKEN_ID] * prefix + ids[prefix:]
        raise ValueError(f"Unknown role: {role}")

    input_ids: List[List[int]] = []
    targets: List[List[int]] = []
    for messages in messages_batch:
        ids: List[int] = []
        tgt: List[int] = []
        for message in messages:
            role = message["role"]
            text = "".join(_content_to_text(c, num_image_crop) for c in message["content"])
            text = expand_image_tokens(text, n_img_tokens)
            mids = tokenize_message(role, text)
            ids.extend(mids)
            tgt.extend(make_target(role, mids))
        assert len(ids) == len(tgt)
        input_ids.append(ids)
        targets.append(tgt)

    max_batch_len = min(max(len(x) for x in input_ids), max_length)
    for i in range(len(input_ids)):
        pad = max_batch_len - len(input_ids[i])
        if pad > 0:
            input_ids[i] = input_ids[i] + [tokenizer.pad_token_id] * pad
            targets[i] = targets[i] + [IGNORE_TOKEN_ID] * pad
        else:
            input_ids[i] = input_ids[i][:max_batch_len]
            targets[i] = targets[i][:max_batch_len]

    arr = np.asarray(input_ids, np.int32)
    return {
        "input_ids": arr,
        "labels": np.asarray(targets, np.int32),
        "attention_mask": arr != tokenizer.pad_token_id,
    }
