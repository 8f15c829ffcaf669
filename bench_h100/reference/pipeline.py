"""The plain two-stream classifier (Simonyan & Zisserman 2014) over clip
windows: the benchmark's frozen reference of what a cell's timed path
answers.

Per window of T uint8 RGB frames: resize the short side (bilinear, half-
pixel centres, clamped borders) and take the centre crop; the RGB stream
classifies every normalised frame (ImageNet statistics) and averages the
logits over time; the gray frames' (BT.601) consecutive-pair flow, by
TV-L1 or Farneback, is clipped to ±bound and scaled to [−1, 1], stacked
L fields at a time (2L channels, u and v interleaved), and the flow
stream averages its logits over the stacks; late fusion is the weighted
mean of the two softmaxes.  Everything in float32 (TF32 off on the card;
the controls: ``precision="fp8"``, the CNNs in float8 (``resnet``), and
``flow_dtype=torch.bfloat16``, the flow in bfloat16).

Imports nothing of the program: the configuration is the benchmark's
JSON, the weights its state dicts.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from bench_h100.reference import farneback, ops, resnet, tvl1

GRAY = (0.299, 0.587, 0.114)


def resize_short_center_crop(x: torch.Tensor, short: int, crop: int
                             ) -> torch.Tensor:
    """(N, H, W, 3) → (N, crop, crop, 3) float32."""
    h, w = x.shape[1:3]
    if h <= w:
        rh, rw = short, max(1, int(round(w * short / h)))
    else:
        rh, rw = max(1, int(round(h * short / w))), short
    y = ops.resize(x.float(), (rh, rw))
    top = int(round((rh - crop) / 2.0))
    left = int(round((rw - crop) / 2.0))
    return y[:, top:top + crop, left:left + crop]


def gray(x: torch.Tensor) -> torch.Tensor:
    w = torch.tensor(GRAY, dtype=torch.float32, device=x.device)
    return torch.tensordot(x, w, dims=([-1], [0]))


def flow_of(gray_seq: torch.Tensor, cfg: dict,
            rounds: Optional[list] = None,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, T, h, w) gray → (B, T−1, h, w, 2) float32 flow by the
    configured algorithm, computed in `dtype`; `rounds` receives TV-L1's
    levels."""
    flow_cfg = cfg["flow"]
    B, T = gray_seq.shape[:2]
    if flow_cfg["algo"] == "farneback":
        return farneback.farneback_sequence(
            gray_seq, flow_cfg["farneback"], dtype=dtype).float()
    prev = gray_seq[:, :-1].reshape(B * (T - 1), *gray_seq.shape[2:])
    nxt = gray_seq[:, 1:].reshape(B * (T - 1), *gray_seq.shape[2:])
    f = tvl1.tvl1(prev, nxt, flow_cfg["tvl1"], rounds=rounds,
                  dtype=dtype).float()
    return f.reshape(B, T - 1, *f.shape[1:])


def flow_stacks(flow: torch.Tensor, stack: int, bound: float
                ) -> torch.Tensor:
    """(T−1, h, w, 2) → (N, h, w, 2·stack) stacks of consecutive fields."""
    f = flow.clamp(-bound, bound) / bound
    n = f.shape[0] - stack + 1
    wins = torch.stack([f[s:s + stack] for s in range(n)])
    return wins.permute(0, 2, 3, 1, 4).reshape(n, *f.shape[1:3], 2 * stack)


def classify(windows: torch.Tensor, cfg: dict,
             weights: Dict[str, Dict[str, torch.Tensor]],
             precision: str = "float32", rounds: Optional[list] = None,
             flow: Optional[torch.Tensor] = None,
             flow_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, T, H, W, 3) uint8 windows → (B, classes) fused probabilities.
    `weights` holds the ``spatial`` and ``temporal`` state dicts;
    `precision` is the CNNs' (``"fp8"``: the CNN control) and
    `flow_dtype` the flow's (bfloat16: the flow control).  A `flow`
    already computed for these windows may be passed in (the CNN control
    shares the float32 flow); ``classify.last_flow`` keeps the flow of
    the last call.  TF32 is off while it runs."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _classify(windows, cfg, weights, precision, rounds, flow,
                         flow_dtype)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _classify(windows, cfg, weights, precision, rounds, flow, flow_dtype):
    pre, model = cfg["preprocess"], cfg["model"]
    B, T = windows.shape[:2]
    x = resize_short_center_crop(windows.reshape(B * T,
                                                 *windows.shape[2:]),
                                 pre["resize_short"], pre["crop"])
    mean = torch.tensor(pre["mean"], dtype=torch.float32, device=x.device)
    std = torch.tensor(pre["std"], dtype=torch.float32, device=x.device)
    spatial = resnet.ResNet18(weights["spatial"], precision)
    s_logits = spatial((x / 255.0 - mean) / std).reshape(B, T, -1).mean(1)
    if flow is None:
        flow = flow_of(gray(x).reshape(B, T, *x.shape[1:3]), cfg, rounds,
                       flow_dtype)
    classify.last_flow = flow
    temporal = resnet.ResNet18(weights["temporal"], precision)
    t_logits = torch.stack([
        temporal(flow_stacks(f, pre["flow_stack"], pre["flow_bound"])
                 ).mean(0) for f in flow])
    ws, wt = model["fusion_weights"]
    return (ws * torch.softmax(s_logits, -1)
            + wt * torch.softmax(t_logits, -1)) / (ws + wt)


classify.last_flow = None

