"""Answer parsers + metrics for the benchmark tasks, numpy-only.

The port's copy of aria_tpu/evals/parsers.py.

Behavioral parity with the reference eval harnesses:
- RefCOCO: "(x1,y1),(x2,y2)" bboxes /999-normalized, scaled to image hw,
  IoU >= 0.5 => correct (examples/refcoco/evaluation.py:135-203).
- NLVR2: yes/no normalization incl. y/n single chars and 4-char prefixes
  (examples/nlvr2/evaluation.py:155-199).
- NextQA: MMMU-style multi-choice parsing — bracketed letters, bare letters,
  dotted letters, content match, last-mention tie-break, random fallback
  (examples/nextqa/evaluation.py:163-262).
"""

from __future__ import annotations

import random
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------- refcoco

_BBOX_PATTERN = re.compile(r"\((.*?)\),\((.*?)\)")


def parse_bbox(pred: str) -> Tuple[float, float, float, float]:
    """Extract "(x1,y1),(x2,y2)" from model output; (0,0,0,0) on failure."""
    found = _BBOX_PATTERN.findall(pred)
    try:
        if not found or "," not in found[0][0] or "," not in found[0][1]:
            return (0.0, 0.0, 0.0, 0.0)
        x1, y1 = (float(t) for t in found[0][0].split(","))
        x2, y2 = (float(t) for t in found[0][1].split(","))
        return (x1, y1, x2, y2)
    except Exception:
        return (0.0, 0.0, 0.0, 0.0)


def box_iou(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two [4] boxes (x1, y1, x2, y2)."""
    area_a = max(a[2] - a[0], 0) * max(a[3] - a[1], 0)
    area_b = max(b[2] - b[0], 0) * max(b[3] - b[1], 0)
    lt = np.maximum(a[:2], b[:2])
    rb = np.minimum(a[2:], b[2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[0] * wh[1]
    union = area_a + area_b - inter
    return float(inter / union) if union > 0 else 0.0


def refcoco_score(results: Sequence[Dict]) -> Dict[str, float]:
    """results: [{"pred": str, "bbox": [4], "hw": (h, w)}]. Returns
    precision@1 (percent)."""
    if not results:
        return {"precision@1": 0}
    correct = 0
    for r in results:
        box = np.asarray(parse_bbox(r["pred"]), np.float32) / 999.0
        h, w = r["hw"]
        box[0::2] *= w
        box[1::2] *= h
        if box_iou(box, np.asarray(r["bbox"], np.float32)) >= 0.5:
            correct += 1
    return {"precision@1": correct / len(results) * 100}


# ---------------------------------------------------------------- nlvr2

def parse_yes_no(pred: str) -> str:
    p = pred.lower().strip().replace(".", "")
    if p in ("yes", "no"):
        return p
    if len(p) == 1:
        return {"y": "yes", "n": "no"}.get(p, "other")
    prefix = p[:4]
    if "yes" in prefix:
        return "yes"
    if "no" in prefix:
        return "no"
    return "other"


def nlvr2_score(results: Sequence[Dict]) -> Dict[str, float]:
    """results: [{"pred": str, "gt": str}]."""
    if not results:
        return {"acc": 0}
    correct = sum(
        1 for r in results
        if parse_yes_no(r["pred"]) == r["gt"].lower().strip().replace(".", "")
    )
    return {"acc": correct / len(results) * 100}


# ---------------------------------------------------------------- nextqa

def parse_multi_choice(
    response: str,
    all_choices: Sequence[str],
    index2ans: Dict[str, str],
    rng: Optional[random.Random] = None,
) -> str:
    """MMMU-style multi-choice answer extraction."""
    rng = rng or random
    for ch in [",", ".", "!", "?", ";", ":", "'"]:
        response = response.strip(ch)
    response = f" {response} "

    index_ans = True
    with_bracket = False
    candidates: List[str] = []
    for c in all_choices:
        if f"({c})" in response:
            candidates.append(c)
            with_bracket = True
    if not candidates:
        for c in all_choices:
            if f"{c} " in response:
                candidates.append(c)
    if not candidates:
        for c in all_choices:
            if f"{c}." in response:
                candidates.append(c)
    if not candidates and len(response.split()) > 5:
        for idx, ans in index2ans.items():
            if ans.lower() in response.lower():
                candidates.append(idx)
                index_ans = False

    if not candidates:
        return rng.choice(list(all_choices))
    if len(candidates) == 1:
        return candidates[0]

    starts = []
    if index_ans:
        if with_bracket:
            starts = [response.rfind(f"({c})") for c in candidates]
        else:
            starts = [response.rfind(f" {c} ") for c in candidates]
    else:
        starts = [response.lower().rfind(index2ans[c].lower()) for c in candidates]
    return candidates[int(np.argmax(starts))]


def multi_choice_score(results: Sequence[Dict]) -> Dict[str, float]:
    """results: [{"pred": parsed letter, "gt": letter-or-list}]."""
    if not results:
        return {"acc": 0}
    correct = 0
    for r in results:
        gold = r["gt"]
        golds = gold if isinstance(gold, list) else [gold]
        if r["pred"] in golds:
            correct += 1
    return {"acc": correct / len(results)}
