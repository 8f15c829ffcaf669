"""The plain two-stream classifier on clip streams (R(2+1)D, Tran et
al. 2018): the benchmark's frozen reference of what an R(2+1)D cell's
timed path answers.

Per window of T uint8 RGB frames: the resize of the short side and the
centre crop of ``pipeline.py``; the RGB stream classifies the first
T − 1 normalised frames as one clip; the gray frames' (BT.601)
consecutive-pair Farneback flow is clipped to ±bound and scaled to
[−1, 1], and the flow stream classifies the T − 1 fields as one clip;
late fusion is the weighted mean of the two softmaxes.  Everything in
float32, the CNNs a few clips at a time, TF32 off on the card (the
controls: ``precision="fp8"``, the CNNs in float8, and
``flow_dtype=torch.bfloat16``, the flow in bfloat16).

Imports nothing of the program: the configuration is the benchmark's
JSON, the weights its state dicts.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from bench_h100.reference import pipeline
from bench_h100.reference.r2plus1d import R2Plus1D34


def volume(flow: torch.Tensor, bound: float) -> torch.Tensor:
    """(..., h, w, 2) flow clipped to ±bound and divided by it."""
    return flow.clamp(-bound, bound) / bound


def classify(windows: torch.Tensor, cfg: dict,
             weights: Dict[str, Dict[str, torch.Tensor]],
             precision: str = "float32",
             flow: Optional[torch.Tensor] = None,
             flow_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, T, H, W, 3) uint8 windows → (B, classes) fused probabilities.
    `weights` holds the ``spatial`` and ``temporal`` state dicts; a
    `flow` already computed for these windows may be passed in;
    ``classify.last_flow`` keeps the (B, T − 1, h, w, 2) flow of the last
    call."""
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
        s_logits = R2Plus1D34(weights["spatial"], precision)(
            (x[:, :-1] / 255.0 - mean) / std)
        if flow is None:
            flow = pipeline.flow_of(pipeline.gray(x), cfg, None, flow_dtype)
        classify.last_flow = flow
        t_logits = R2Plus1D34(weights["temporal"], precision)(
            volume(flow, pre["flow_bound"]))
        ws, wt = model["fusion_weights"]
        return (ws * torch.softmax(s_logits, -1)
                + wt * torch.softmax(t_logits, -1)) / (ws + wt)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


classify.last_flow = None
