"""The two-stream classifier end to end on one device.

Port of ``video_analytics_tpu/runtime/pipeline.py`` (the TV-L1, Farneback
and SpyNet paths).  Decoded uint8 frames go to the device once;
preprocessing, optical flow (the hand-written CUDA kernels on a GPU),
both ResNet-18 streams, temporal pooling and fusion all run there, and
the flow stays on the device between the solver and the flow-stream CNN.

The reference vmaps ``classify_window`` over windows; here the batch is
written out: ``classify_batch`` runs the flow of every window's frame
pairs as one batch and each CNN once over all windows.  With TV-L1 an
image's flow does not depend on its batch (the per-image ε stop); with
Farneback every pixel's arithmetic is its own pair's.  So a window gets
the same flow alone or in a batch, and pairs never span two windows.

``classify_batch(..., plain=True)`` runs the flow through the kernels'
plain PyTorch versions even on CUDA tensors: the reference the kernels
are checked against.

A model whose streams take clip volumes (``TwoStreamModel.clip_input``,
R(2+1)D) gets each window of T frames as one clip of its first T − 1
frames and one volume of its T − 1 flow fields, clipped to ±bound and
scaled by it in the temporal stream's dtype (``va/volume``): one forward
pass of each stream a window, no temporal mean.

With ``flow_algo="spynet"`` the flow is the learned SpyNet
(``models/spynet``), passed as ``flow_net``: the port's counterpart of the
reference's ``variables["flow"]`` / ``flow_variables``.  It is an argument
of its own, not a part of ``TwoStreamModel``, so two-stream checkpoints
carry no SpyNet weights, as the reference's do not.  SpyNet reaches no
hand-written kernel (``plain`` changes nothing for it); cuDNN may pick
another convolution algorithm for another batch size, so on a GPU a
window's SpyNet flow alone and in a batch may differ in the last bits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from video_analytics_tpu_torch.config import PipelineConfig, PreprocessConfig
from video_analytics_tpu_torch.flow.farneback import (
    farneback, farneback_sequence)
from video_analytics_tpu_torch.flow.tvl1 import tvl1
from video_analytics_tpu_torch.models.resnet import ResNet
from video_analytics_tpu_torch.models.spynet import SpyNet
from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
from video_analytics_tpu_torch.ops import preprocess as pp
from video_analytics_tpu_torch.utils.spans import span


def _spynet_flow(prev: torch.Tensor, nxt: torch.Tensor,
                 flow_net: Optional[SpyNet]) -> torch.Tensor:
    if flow_net is None:
        raise ValueError(
            'flow_algo="spynet" needs a SpyNet: pass flow_net (CLI: --algo '
            "spynet loads --spynet-checkpoint or the bundled weights)")
    return flow_net(prev, nxt)


def compute_flow(gray_prev: torch.Tensor, gray_next: torch.Tensor,
                 cfg: PipelineConfig,
                 initial_flow: Optional[torch.Tensor] = None,
                 flow_net: Optional[SpyNet] = None) -> torch.Tensor:
    """(B, H, W) gray pairs → (B, H, W, 2) flow with the configured
    algorithm.  `initial_flow` (B, H, W, 2) seeds the coarsest level when
    the algorithm's config sets ``use_initial_flow``; `flow_net` is the
    SpyNet that ``flow_algo="spynet"`` needs."""
    if cfg.flow_algo == "spynet":
        return _spynet_flow(gray_prev, gray_next, flow_net)
    if cfg.flow_algo == "tvl1":
        return tvl1(gray_prev, gray_next, cfg.tvl1, initial_flow)
    return farneback(gray_prev, gray_next, cfg.farneback, initial_flow)


def _sequence_flow(gray: torch.Tensor, cfg: PipelineConfig, plain: bool,
                   flow_net: Optional[SpyNet] = None) -> torch.Tensor:
    """(B, T, H, W) gray sequences → (B, T-1, H, W, 2) consecutive-pair
    flow, all B·(T-1) pairs in one flow batch; pairs never span two
    sequences."""
    if cfg.flow_algo == "farneback":
        return farneback_sequence(gray, cfg.farneback, plain=plain)
    B, T = gray.shape[:2]
    prev = gray[:, :-1].reshape(B * (T - 1), *gray.shape[2:])
    nxt = gray[:, 1:].reshape(B * (T - 1), *gray.shape[2:])
    if cfg.flow_algo == "spynet":
        flow = _spynet_flow(prev, nxt, flow_net)
    else:
        flow = tvl1(prev, nxt, cfg.tvl1, plain=plain)
    return flow.reshape(B, T - 1, *flow.shape[1:])


def compute_flow_sequence(gray: torch.Tensor, cfg: PipelineConfig,
                          flow_net: Optional[SpyNet] = None) -> torch.Tensor:
    """(T, H, W) gray sequence → (T-1, H, W, 2) consecutive-pair flow.

    Same result as ``compute_flow(gray[:-1], gray[1:], cfg)``; for
    Farneback the per-frame pyramid prep and polynomial expansions run
    once per frame (``flow/farneback.farneback_sequence``) instead of
    once for each side of each pair."""
    return _sequence_flow(gray[None], cfg, False, flow_net)[0]


@torch.no_grad()
def flow_from_frames(frames: torch.Tensor, cfg: PipelineConfig,
                     flow_net: Optional[SpyNet] = None) -> torch.Tensor:
    """(T, H, W, 3) uint8 RGB → (T-1, H, W, 2) dense flow at input
    resolution (the compute-flow CLI surface)."""
    return compute_flow_sequence(pp.rgb_to_gray(frames), cfg, flow_net)


@torch.no_grad()
def rgb_features(frames: torch.Tensor, model: ResNet,
                 cfg: PreprocessConfig) -> torch.Tensor:
    """(T, H, W, 3) uint8 → (T, 512) ResNet-18 penultimate features."""
    return model(pp.preprocess_clip(frames, cfg), return_features=True)


def _crop(frames: torch.Tensor, cfg: PipelineConfig) -> torch.Tensor:
    """(..., H, W, 3) uint8 → (..., crop, crop, 3) float32 on [0, 255]:
    the eval resize + center crop that both streams start from."""
    pre = cfg.preprocess
    if pre.random_crop:
        # The reference's inference paths take the center crop only; the
        # random crop belongs to training (train_two_stream.build_examples).
        raise ValueError("random_crop is a training transform; inference "
                         "takes the center crop")
    return pp.resize_short_center_crop(frames, pre.resize_short, pre.crop,
                                       src_hw=pre.src_hw)


def _flow_stacks(x: torch.Tensor, cfg: PipelineConfig, plain: bool,
                 flow_net: Optional[SpyNet] = None,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B, T, h, w, 3) cropped windows → (B, N, h, w, 2L) normalised flow
    stacks in `dtype` (the temporal CNN's), with one flow batch over all
    B·(T-1) frame pairs."""
    with span("va/flow"):
        flow = _sequence_flow(pp.rgb_to_gray(x), cfg, plain, flow_net)
    pre = cfg.preprocess
    with span("va/stack"):
        return torch.stack([pp.stacked_flow_input(f, pre.flow_stack,
                                                  pre.flow_bound, dtype=dtype)
                            for f in flow])


@torch.no_grad()
def flow_features(frames: torch.Tensor, model: ResNet,
                  cfg: PipelineConfig,
                  flow_net: Optional[SpyNet] = None) -> torch.Tensor:
    """(T, H, W, 3) uint8 → (N, 512) flow-stream features: crop → gray →
    flow → stack → CNN."""
    stacks = _flow_stacks(_crop(frames, cfg)[None], cfg, False, flow_net,
                          model.dtype)[0]
    return model(stacks, return_features=True)


@torch.no_grad()
def classify_batch(windows: torch.Tensor, model: TwoStreamModel,
                   cfg: PipelineConfig, plain: bool = False,
                   flow_net: Optional[SpyNet] = None) -> torch.Tensor:
    """(B, T, H, W, 3) uint8 windows → (B, C) fused probs.  Both streams
    start from one resize + crop (the reference computes the same crop
    once per stream).  `flow_net`: the SpyNet of ``flow_algo="spynet"``."""
    B, T = windows.shape[:2]
    pre = cfg.preprocess
    with span("va/classify_batch"):
        with span("va/crop"):
            x = _crop(windows, cfg)                    # (B, T, h, w, 3)
            rgb = pp.normalize(x, pre.mean, pre.std)
        if model.clip_input:
            return _classify_clips(x, rgb, model, cfg, plain, flow_net)
        with span("va/spatial"):
            s_logits = model.spatial(rgb.reshape(B * T, *rgb.shape[2:]))
            s_logits = s_logits.reshape(B, T, -1).mean(dim=1)
        stacks = _flow_stacks(x, cfg, plain, flow_net,  # (B, N, h, w, 2L)
                              model.temporal.dtype)
        n = stacks.shape[1]
        with span("va/temporal"):
            t_logits = model.temporal(
                stacks.reshape(B * n, *stacks.shape[2:]))
            t_logits = t_logits.reshape(B, n, -1).mean(dim=1)
        with span("va/fuse"):
            return model.fuse(s_logits, t_logits)


def _classify_clips(x: torch.Tensor, rgb: torch.Tensor,
                    model: TwoStreamModel, cfg: PipelineConfig, plain: bool,
                    flow_net: Optional[SpyNet]) -> torch.Tensor:
    """``classify_batch`` for streams that take clip volumes: (B, T, h,
    w, 3) cropped windows and their normalised frames → (B, C)."""
    with span("va/spatial"):
        s_logits = model.spatial(rgb[:, :-1])
    with span("va/flow"):
        flow = _sequence_flow(pp.rgb_to_gray(x), cfg, plain, flow_net)
    with span("va/volume"):
        volume = pp.normalize_flow_stack(
            flow, cfg.preprocess.flow_bound).to(model.temporal.dtype)
    with span("va/temporal"):
        t_logits = model.temporal(volume)
    with span("va/fuse"):
        return model.fuse(s_logits, t_logits)


def classify_window(frames: torch.Tensor, model: TwoStreamModel,
                    cfg: PipelineConfig, plain: bool = False,
                    flow_net: Optional[SpyNet] = None) -> torch.Tensor:
    """One clip window (T, H, W, 3) uint8 → fused class probs (C,)."""
    return classify_batch(frames[None], model, cfg, plain=plain,
                          flow_net=flow_net)[0]


def sample_window(num_frames: int, window: int,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Host-side frame-index sampling: one evenly-spaced (eval) or
    random (train) window of `window` indices, clamped for short clips."""
    if num_frames >= window:
        if rng is None:
            start = (num_frames - window) // 2
        else:
            start = int(rng.integers(0, num_frames - window + 1))
        return np.arange(start, start + window)
    idx = np.arange(window)
    return np.clip(idx, 0, num_frames - 1)
