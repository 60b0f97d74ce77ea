"""jsonl datasets and their mixer (the port's own copy of
aria_tpu/data/datasets.py). One json object per line:

    {"messages": [...], "images": ["rel/path.jpg", ...] | null,
     "video": {"path": "rel.mp4", "num_frames": N} | null}

``mix_datasets``: a fraction <= 1 takes the first frac * len rows, one
above 1 repeats the dataset int(frac) times; the concatenation is shuffled
with the seed.
"""

from __future__ import annotations

import json
import os
import random
import warnings
from typing import Any, Dict, Iterator, List, Mapping, Optional


def _read_jsonl(path: str) -> List[Dict[str, Any]]:
    items = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                items.append(json.loads(line))
    return items


def _absolutize(item: Dict[str, Any], root: str) -> Dict[str, Any]:
    if item.get("images") and item.get("video"):
        raise ValueError("Simultaneous input of images and video is not supported.")
    if item.get("images") is not None:
        item["images"] = [os.path.join(root, p) for p in item["images"]]
    if item.get("video") is not None:
        nf = item["video"].get("num_frames")
        if nf is None or nf <= 0:
            warnings.warn("`num_frames` defaulted to 8 (missing or non-positive).")
            item["video"]["num_frames"] = 8
        item["video"]["path"] = os.path.join(root, item["video"]["path"])
    return item


def load_local_dataset(path: str) -> Dict[str, Optional[List[Dict[str, Any]]]]:
    """Load {path}/train.jsonl (+ optional test.jsonl); image/video paths are
    made absolute relative to ``path``."""
    train_file = os.path.join(path, "train.jsonl")
    if not os.path.exists(train_file):
        raise FileNotFoundError(f"train.jsonl not found in {path}")
    ds: Dict[str, Optional[List[Dict[str, Any]]]] = {
        "train": [_absolutize(x, path) for x in _read_jsonl(train_file)]
    }
    test_file = os.path.join(path, "test.jsonl")
    ds["test"] = (
        [_absolutize(x, path) for x in _read_jsonl(test_file)]
        if os.path.exists(test_file)
        else None
    )
    return ds


def mix_datasets(
    dataset_config: Mapping[str, float], seed: int = 42
) -> Dict[str, Optional[List[Dict[str, Any]]]]:
    train: List[Dict[str, Any]] = []
    test: List[Dict[str, Any]] = []
    for path, frac in dataset_config.items():
        frac = float(frac)
        ds = load_local_dataset(path)
        rows = ds["train"] or []
        if frac <= 1:
            selected = rows[: int(frac * len(rows))]
        else:
            selected = rows * int(frac)
        train.extend(selected)
        if ds.get("test"):
            test.extend(ds["test"])
    rng = random.Random(seed)
    rng.shuffle(train)
    return {"train": train, "test": test or None}


def iter_batches(rows: List[Dict[str, Any]], batch_size: int, *, drop_last: bool = True) -> Iterator[List[Dict[str, Any]]]:
    for i in range(0, len(rows) - (batch_size - 1 if drop_last else 0), batch_size):
        batch = rows[i : i + batch_size]
        if batch:
            yield batch
