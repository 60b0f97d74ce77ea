"""Video frame sampling with OpenCV (the port's own copy of
aria_tpu/data/video.py): frame i of n is int(total_frames / n) * i.
"""

from __future__ import annotations

from typing import List

from PIL import Image

Image.MAX_IMAGE_PIXELS = None  # reference load_video.py:22 disables the bomb check


def load_video(video_file: str, num_frames: int = 8) -> List[Image.Image]:
    import cv2

    cap = cv2.VideoCapture(video_file)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {video_file}")
    try:
        duration = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        step = max(duration // num_frames, 1) if num_frames > 0 else 1
        frame_indices = [step * i for i in range(num_frames)]
        frames: List[Image.Image] = []
        for idx in frame_indices:
            if idx >= duration:
                break
            cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(Image.fromarray(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)))
        return frames
    finally:
        cap.release()


def count_frames(video_file: str) -> int:
    import cv2

    cap = cv2.VideoCapture(video_file)
    try:
        return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()
