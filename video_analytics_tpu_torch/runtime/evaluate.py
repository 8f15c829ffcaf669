"""Classification of one clip file.

Port of ``classify_clip_file`` of
``video_analytics_tpu/runtime/evaluate.py``, what ``classify-clip`` runs.
The dataset evaluation of that module (``evaluate``, ``evaluate_batched``)
belongs to ``eval-ucf101`` and is not ported yet.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from video_analytics_tpu_torch.config import PipelineConfig
from video_analytics_tpu_torch.ingest.windows import apply_transport_crop
from video_analytics_tpu_torch.io.video import decode_snippet_windows
from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
from video_analytics_tpu_torch.runtime.pipeline import classify_batch


def classify_clip_file(path: str, model: TwoStreamModel, cfg: PipelineConfig,
                       device: Union[str, torch.device],
                       max_frames: int = 300, num_windows: int = 1,
                       plain: bool = False) -> np.ndarray:
    """Decode one clip, classify → class probs.

    num_windows=1: the centre window.  num_windows=N: N evenly-spaced
    windows, probabilities averaged: the classic two-stream multi-snippet
    protocol (temporal pooling is associative, so window probs reduce
    exactly via a mean).  The N windows are classified as one batch
    (``runtime.pipeline.classify_batch``).  Only the windows themselves
    are decoded when they cover a small part of the clip
    (``io.video.decode_snippet_windows``).  `model` lives on `device`;
    ``plain=True`` runs the flow kernels' plain versions.
    """
    # Window must cover flow_stack+1 frames to build one flow stack.
    win = max(cfg.window, cfg.preprocess.flow_stack + 1)
    wins = decode_snippet_windows(path, win, num_windows,
                                  max_frames=max_frames, repeat_short=False)
    # Transport crop: only the source window the fused resize+crop samples
    # crosses to the device.
    wins, cfg = apply_transport_crop(wins, cfg)
    probs = classify_batch(torch.from_numpy(wins).to(device), model, cfg,
                           plain=plain)
    return probs.mean(dim=0).cpu().numpy()
