"""The program under test as the benchmark drives it: the only module of
the benchmark that imports ``video_analytics_tpu_torch``, and only the
public entries a user of the port calls (the pipeline, the flow
functions, the model constructor), plus ``tvl1.rounds``,
the program's record of the rounds its ε test ran.

Imports happen inside the functions, so the reference's tests and the
checks of what the benchmark imports can load this module without the
program.
"""

from __future__ import annotations

from typing import Dict

import torch


def pipeline_config(cfg: dict):
    """The program's ``PipelineConfig`` for a configuration file."""
    from video_analytics_tpu_torch.config import (
        FarnebackConfig, PipelineConfig, PreprocessConfig, TVL1Config)

    pre, flow, model = cfg["preprocess"], cfg["flow"], cfg["model"]
    t = flow["tvl1"]
    f = flow["farneback"]
    return PipelineConfig(
        preprocess=PreprocessConfig(
            resize_short=pre["resize_short"], crop=pre["crop"],
            mean=tuple(pre["mean"]), std=tuple(pre["std"]),
            flow_stack=pre["flow_stack"], flow_bound=pre["flow_bound"]),
        tvl1=TVL1Config(
            tau=t["tau"], lambda_=t["lambda"], theta=t["theta"],
            nscales=t["nscales"], warps=t["warps"], epsilon=t["epsilon"],
            inner_iterations=t["inner_iterations"],
            outer_iterations=t["outer_iterations"],
            scale_step=t["scale_step"],
            median_filtering=t["median_filtering"]),
        farneback=FarnebackConfig(
            pyr_scale=f["pyr_scale"], levels=f["levels"],
            winsize=f["winsize"], iterations=f["iterations"],
            poly_n=f["poly_n"], poly_sigma=f["poly_sigma"],
            gaussian_window=f["gaussian_window"]),
        flow_algo=flow["algo"], num_classes=model["num_classes"],
        fusion_weights=tuple(model["fusion_weights"]),
        window=cfg["window"], compute_dtype=model["dtype"])


def build_model(cfg: dict, weights: Dict[str, Dict[str, torch.Tensor]],
                device):
    """``TwoStreamModel.create`` at the configuration's sizes and compute
    dtype, on `device`, holding the benchmark's weights."""
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel

    m = cfg["model"]
    model = TwoStreamModel.create(
        num_classes=m["num_classes"], flow_stack=m["flow_stack"],
        fusion_weights=tuple(m["fusion_weights"]),
        dtype=getattr(torch, m["dtype"]), width=m["width"], arch=m["arch"])
    for stream in ("spatial", "temporal"):
        missing, unexpected = getattr(model, stream).load_state_dict(
            weights[stream], strict=False)
        if unexpected or any(not k.endswith("num_batches_tracked")
                             for k in missing):
            raise ValueError(f"{stream}: the program's parameters differ "
                             f"from the benchmark's: missing {missing}, "
                             f"unexpected {unexpected}")
    return model.to(device).eval()


def with_transport_crop(windows, pcfg):
    """``ingest.windows.apply_transport_crop``: the windows sliced to the
    source region the device crop samples, and the config that says so."""
    from video_analytics_tpu_torch.ingest.windows import apply_transport_crop

    return apply_transport_crop(windows, pcfg)


def device_prefetcher(batches, depth: int, device):
    """``ingest.prefetch.DevicePrefetcher``: the arrays of each item of
    `batches` copied to `device` through a pool of pinned buffers on a
    worker thread, `depth` items ahead."""
    from video_analytics_tpu_torch.ingest.prefetch import DevicePrefetcher

    return DevicePrefetcher(batches, depth=depth, device=device)


def classify_batch(x: torch.Tensor, model, pcfg) -> torch.Tensor:
    from video_analytics_tpu_torch.runtime.pipeline import classify_batch

    return classify_batch(x, model, pcfg)


def crop(x: torch.Tensor, pcfg) -> torch.Tensor:
    """The device resize and centre crop of (..., h, w, 3) uint8 windows
    as the pipeline takes it (``ops.preprocess``)."""
    from video_analytics_tpu_torch.ops import preprocess as pp

    pre = pcfg.preprocess
    return pp.resize_short_center_crop(x, pre.resize_short, pre.crop,
                                       src_hw=pre.src_hw)


def normalize(x: torch.Tensor, pcfg) -> torch.Tensor:
    from video_analytics_tpu_torch.ops import preprocess as pp

    return pp.normalize(x, pcfg.preprocess.mean, pcfg.preprocess.std)


def gray(x: torch.Tensor) -> torch.Tensor:
    from video_analytics_tpu_torch.ops import preprocess as pp

    return pp.rgb_to_gray(x)


def flow_stacks(flow: torch.Tensor, pcfg, dtype) -> torch.Tensor:
    """(B, T−1, h, w, 2) flow → (B·N, h, w, 2L) stacks in `dtype`."""
    from video_analytics_tpu_torch.ops import preprocess as pp

    pre = pcfg.preprocess
    return torch.cat([pp.stacked_flow_input(f, pre.flow_stack,
                                            pre.flow_bound, dtype=dtype)
                      for f in flow])


def batch_flow(gray_seq: torch.Tensor, pcfg) -> torch.Tensor:
    """(B, T, h, w) gray windows → (B, T−1, h, w, 2): the flow call the
    pipeline makes for a batch, through the public flow entries
    (``runtime.pipeline.compute_flow`` over every pair for TV-L1, whose
    images stop on their own; ``flow.farneback.farneback_sequence`` for
    Farneback, which expands each frame once)."""
    from video_analytics_tpu_torch.flow.farneback import farneback_sequence
    from video_analytics_tpu_torch.runtime.pipeline import compute_flow

    if pcfg.flow_algo == "farneback":
        return farneback_sequence(gray_seq, pcfg.farneback)
    B, T = gray_seq.shape[:2]
    prev = gray_seq[:, :-1].reshape(B * (T - 1), *gray_seq.shape[2:])
    nxt = gray_seq[:, 1:].reshape(B * (T - 1), *gray_seq.shape[2:])
    f = compute_flow(prev, nxt, pcfg)
    return f.reshape(B, T - 1, *f.shape[1:])


def recorded_rounds(fn):
    """Run ``fn()`` with the program's TV-L1 recording its rounds
    (``flow.tvl1.tvl1.rounds``); returns (fn's result, the levels)."""
    from video_analytics_tpu_torch.flow.tvl1 import tvl1

    log: list = []
    tvl1.rounds = log
    try:
        out = fn()
    finally:
        tvl1.rounds = None
    return out, log

