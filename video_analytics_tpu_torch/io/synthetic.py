"""A synthetic dataset in UCF101's layout.

The port's own copy of ``video_analytics_tpu/io/synthetic.py``: with the
same seed it writes the same clips, the same layout and the same
annotation files.  The layout is UCF101's
(``videos/<Class>/v_<Class>_g01_c01.avi`` plus
``annotations/classInd.txt`` / ``trainlist01.txt`` / ``testlist01.txt``),
so split parsing, threaded decode and batched eval run against real
encoded containers without the real dataset.

Classes differ by motion, not appearance: every clip shows a textured
square over a textured background, moving along a class-specific
direction, so only the flow stream can tell them apart.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from video_analytics_tpu_torch.io.dataset import UCF101
from video_analytics_tpu_torch.io.video import synthesize_video

# Eight motion directions: enough classes to make top-1 non-trivial.
_DIRECTIONS: List[Tuple[int, int]] = [
    (2, 0), (-2, 0), (0, 2), (0, -2),
    (2, 2), (-2, -2), (2, -2), (-2, 2),
]
_CLASS_NAMES = ["Right", "Left", "Down", "Up",
                "DownRight", "UpLeft", "UpRight", "DownLeft"]


def _clip_frames(rng: np.random.Generator, num_frames: int, h: int,
                 w: int, step: Tuple[int, int],
                 size: int = 28) -> List[np.ndarray]:
    """A textured square bouncing along `step` over a textured
    background; appearance is randomized per clip so only motion
    separates the classes."""
    import cv2
    bg = rng.integers(30, 110, (h, w, 3)).astype(np.uint8)
    bg = cv2.GaussianBlur(bg, (9, 9), 0)
    tex = rng.integers(110, 255, (size, size, 3)).astype(np.uint8)
    x = int(rng.integers(4, max(5, w - size - 4)))
    y = int(rng.integers(4, max(5, h - size - 4)))
    dx, dy = step
    frames = []
    for _ in range(num_frames):
        f = bg.copy()
        f[y:y + size, x:x + size] = tex
        frames.append(f)
        # Bounce off the borders so motion persists for any length.
        if not (0 <= x + dx <= w - size):
            dx = -dx
        if not (0 <= y + dy <= h - size):
            dy = -dy
        x += dx
        y += dy
    return frames


def build_synthetic_ucf101(root: str,
                           num_classes: int = 4,
                           clips_per_class: int = 8,
                           num_frames: int = 48,
                           h: int = 240, w: int = 320,
                           fps: float = 25.0,
                           train_fraction: float = 0.5,
                           seed: int = 0) -> UCF101:
    """Write the dataset under `root` and return it as a UCF101 object.

    Layout (identical to the real dataset's):
      root/videos/<Class>/v_<Class>_g{group:02d}_c01.avi
      root/annotations/classInd.txt          (1-indexed)
      root/annotations/trainlist01.txt       ("<rel> <label>")
      root/annotations/testlist01.txt        ("<rel>")

    Clips alternate train/test within each class per `train_fraction`.
    Idempotent: existing files are reused (same seed → same content
    paths), so reruns do not re-encode every clip.
    """
    if not 1 <= num_classes <= len(_DIRECTIONS):
        raise ValueError(
            f"num_classes must be in [1, {len(_DIRECTIONS)}]")
    rng = np.random.default_rng(seed)
    videos = os.path.join(root, "videos")
    ann = os.path.join(root, "annotations")
    os.makedirs(ann, exist_ok=True)

    train_lines, test_lines = [], []
    n_train = max(1, int(round(clips_per_class * train_fraction))) \
        if train_fraction > 0 else 0
    for c in range(num_classes):
        name = _CLASS_NAMES[c]
        cdir = os.path.join(videos, name)
        os.makedirs(cdir, exist_ok=True)
        for g in range(clips_per_class):
            rel = f"{name}/v_{name}_g{g + 1:02d}_c01.avi"
            path = os.path.join(videos, rel)
            # Draw the clip's RNG state deterministically even when the
            # file already exists, so reruns stay reproducible.
            clip_rng = np.random.default_rng(rng.integers(2 ** 63))
            if not os.path.exists(path):
                frames = _clip_frames(clip_rng, num_frames, h, w,
                                      _DIRECTIONS[c])
                synthesize_video(path, frames, fps=fps)
            if g < n_train:
                train_lines.append(f"{rel} {c + 1}")
            else:
                test_lines.append(rel)

    with open(os.path.join(ann, "classInd.txt"), "w") as f:
        for c in range(num_classes):
            f.write(f"{c + 1} {_CLASS_NAMES[c]}\n")
    with open(os.path.join(ann, "trainlist01.txt"), "w") as f:
        f.write("\n".join(train_lines) + "\n")
    with open(os.path.join(ann, "testlist01.txt"), "w") as f:
        f.write("\n".join(test_lines) + "\n")
    return UCF101(videos_root=videos, annotations_root=ann, split=1)
