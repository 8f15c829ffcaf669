"""The plain two-stream classifier on Video Swin streams (Liu et al.
2022): the benchmark's frozen reference of what a Video Swin cell's timed
path answers.

Per window of T uint8 RGB frames, as ``clip_pipeline.py`` does for
R(2+1)D: the resize of the short side and the centre crop of
``pipeline.py``; the RGB stream classifies the first T − 1 normalised
frames as one clip; the gray frames' (BT.601) consecutive-pair Farneback
flow is clipped to ±bound and scaled to [−1, 1], and the flow stream
classifies the T − 1 fields as one clip; late fusion is the weighted
mean of the two softmaxes.  Everything in float32, the transformers a
few clips at a time, TF32 off on the card (the controls:
``precision="fp8"``, every product of both transformers in float8,
``flow_dtype=torch.bfloat16``, the flow in bfloat16, and `leave_out`,
faults of ``reference/video_swin.py`` such as the relative position
bias or the shift mask left out).

Imports nothing of the program: the configuration is the benchmark's
JSON, the weights its state dicts.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

from bench_h100.reference import pipeline
from bench_h100.reference.clip_pipeline import volume
from bench_h100.reference.video_swin import VideoSwin


def classify(windows: torch.Tensor, cfg: dict,
             weights: Dict[str, Dict[str, torch.Tensor]],
             precision: str = "float32",
             flow: Optional[torch.Tensor] = None,
             flow_dtype: torch.dtype = torch.float32,
             leave_out: Iterable[str] = ()) -> torch.Tensor:
    """(B, T, H, W, 3) uint8 windows → (B, classes) fused probabilities.
    `weights` holds the ``spatial`` and ``temporal`` state dicts; a
    `flow` already computed for these windows may be passed in;
    ``classify.last_flow`` keeps the (B, T − 1, h, w, 2) flow of the last
    call, ``classify.last_logits`` its two streams' (B, classes)
    logits."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        pre, model = cfg["preprocess"], cfg["model"]
        B, T = windows.shape[:2]
        x = pipeline.resize_short_center_crop(
            windows.reshape(B * T, *windows.shape[2:]), pre["resize_short"],
            pre["crop"])
        x = x.reshape(B, T, *x.shape[1:])
        mean = torch.tensor(pre["mean"], dtype=torch.float32,
                            device=x.device)
        std = torch.tensor(pre["std"], dtype=torch.float32, device=x.device)
        window = tuple(model["window"])

        def swin(state):
            return VideoSwin(state, window, precision, model["ln_eps"],
                             leave_out=leave_out)
        s_logits = swin(weights["spatial"])((x[:, :-1] / 255.0 - mean) / std)
        if flow is None:
            flow = pipeline.flow_of(pipeline.gray(x), cfg, None, flow_dtype)
        classify.last_flow = flow
        t_logits = swin(weights["temporal"])(volume(flow,
                                                    pre["flow_bound"]))
        classify.last_logits = (s_logits, t_logits)
        ws, wt = model["fusion_weights"]
        return (ws * torch.softmax(s_logits, -1)
                + wt * torch.softmax(t_logits, -1)) / (ws + wt)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


classify.last_flow = None
classify.last_logits = None
