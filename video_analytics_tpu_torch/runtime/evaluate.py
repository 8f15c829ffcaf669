"""Clip classification and the UCF101 split evaluation (``eval-ucf101``).

Port of ``video_analytics_tpu/runtime/evaluate.py``: ``classify_clip_file``
(what ``classify-clip`` runs), the clip-by-clip loop ``evaluate`` (a
resumable manifest, a predictions file, ``limit``), the throughput loop
``evaluate_batched`` (threaded decode, batches of clips, the correct count
kept on the device), its form for a group of processes,
``evaluate_batched_multiprocess`` (each process evaluates its own shard of
the records; the counts are summed over the group once, at the end), and
``warm_batched``, which runs the batch function once at the shape
``evaluate_batched`` gives it.

Failure containment is narrower than the reference's.  A clip that cannot
be opened, decoded or shaped on the host is counted as ``failed`` and
named in ``failures``, and the run goes on; a failure of the device work
(a kernel launch, a CUDA error, a shape a kernel refuses) propagates, so
the command exits non-zero instead of counting the device's fault against
the clips.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from video_analytics_tpu_torch.config import PipelineConfig
from video_analytics_tpu_torch.ingest.prefetch import prefetch_clips
from video_analytics_tpu_torch.ingest.windows import (
    apply_transport_crop, host_resize_short, slice_crop_source)
from video_analytics_tpu_torch.io.dataset import ClipRecord, ProgressManifest
from video_analytics_tpu_torch.io.video import decode_snippet_windows
from video_analytics_tpu_torch.models.spynet import SpyNet
from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
from video_analytics_tpu_torch.parallel.mesh import (
    all_reduce_sum, global_batch_size, process_count, process_index,
    process_local_records)
from video_analytics_tpu_torch.runtime.pipeline import classify_batch
from video_analytics_tpu_torch.utils.logging import get_logger

log = get_logger("tpuva.eval")


@dataclasses.dataclass
class EvalResult:
    total: int = 0
    correct: int = 0
    failed: int = 0
    # (path, repr(exception)) for every clip that failed to load.
    failures: List = dataclasses.field(default_factory=list)

    @property
    def top1(self) -> float:
        return self.correct / max(self.total, 1)

    def as_dict(self) -> Dict[str, Any]:
        return {"total": self.total, "correct": self.correct,
                "failed": self.failed, "top1": self.top1,
                "failures": [{"path": p, "error": e}
                             for p, e in self.failures]}


def _window_frames(cfg: PipelineConfig) -> int:
    # A window must cover flow_stack + 1 frames to build one flow stack.
    return max(cfg.window, cfg.preprocess.flow_stack + 1)


def load_clip_windows(path: str, cfg: PipelineConfig, max_frames: int = 300,
                      num_windows: int = 1
                      ) -> Tuple[np.ndarray, PipelineConfig]:
    """The host half of ``classify_clip_file``: decode the clip's snippet
    windows and slice each to the source window the device's resize and
    crop sample (transport crop).  Returns (windows (N', T, h, w, 3) uint8,
    the config with that geometry recorded); N' is 1 for a clip shorter
    than its N windows.  Touches no device: whatever it raises is the
    clip's fault."""
    wins = decode_snippet_windows(path, _window_frames(cfg), num_windows,
                                  max_frames=max_frames, repeat_short=False)
    return apply_transport_crop(wins, cfg)


def classify_clip_file(path: str, model: TwoStreamModel, cfg: PipelineConfig,
                       device: Union[str, torch.device],
                       max_frames: int = 300, num_windows: int = 1,
                       plain: bool = False,
                       flow_net: Optional[SpyNet] = None) -> np.ndarray:
    """Decode one clip, classify → class probs.

    num_windows=1: the centre window.  num_windows=N: N evenly-spaced
    windows, probabilities averaged: the classic two-stream multi-snippet
    protocol (temporal pooling is associative, so window probs reduce
    exactly via a mean).  The N windows are classified as one batch
    (``runtime.pipeline.classify_batch``).  Only the windows themselves
    are decoded when they cover a small part of the clip
    (``io.video.decode_snippet_windows``).  `model` lives on `device`;
    ``plain=True`` runs the flow kernels' plain versions; `flow_net` is the
    SpyNet of ``flow_algo="spynet"``, on `device`.
    """
    wins, cfg = load_clip_windows(path, cfg, max_frames, num_windows)
    return batch_clip_probs(torch.from_numpy(wins[None]).to(device), model,
                            cfg, plain=plain,
                            flow_net=flow_net)[0].cpu().numpy()


def batch_clip_probs(windows: torch.Tensor, model: TwoStreamModel,
                     cfg: PipelineConfig, plain: bool = False,
                     flow_net: Optional[SpyNet] = None) -> torch.Tensor:
    """(B, N, T, H, W, 3) uint8 snippet windows → (B, C) clip probs: one
    ``classify_batch`` over all B·N windows (so all B·N·(T−1) frame pairs
    in one flow call), each clip's N window probabilities averaged."""
    B, N = windows.shape[:2]
    probs = classify_batch(windows.reshape(B * N, *windows.shape[2:]), model,
                           cfg, plain=plain, flow_net=flow_net)
    return probs.reshape(B, N, -1).mean(dim=1)


def batch_clip_metrics(windows: torch.Tensor, labels: torch.Tensor,
                       valid: torch.Tensor, model: TwoStreamModel,
                       cfg: PipelineConfig,
                       flow_net: Optional[SpyNet] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, T, H, W, 3) windows, (B,) labels and (B,) bool valid, on one
    device → (correct, preds): the number of valid clips whose top-1 class
    is their label, as a 0-d int64 tensor on that device (nothing is read
    back: the caller sums the counts there and reads one number at the
    end), and the (B,) predicted classes."""
    preds = batch_clip_probs(windows, model, cfg,
                             flow_net=flow_net).argmax(dim=-1)
    correct = ((preds == labels) & valid).sum()
    return correct, preds


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array to `device`; to a GPU from pinned memory, without
    waiting for the copy (the next batch's host work overlaps it)."""
    t = torch.from_numpy(arr)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def evaluate_batched(records: List[ClipRecord], model: TwoStreamModel,
                     cfg: PipelineConfig,
                     device: Union[str, torch.device],
                     batch_clips: int = 8,
                     num_workers: int = 2,
                     max_frames: int = 300,
                     num_windows: int = 1,
                     host_resize: bool = False,
                     flow_net: Optional[SpyNet] = None) -> EvalResult:
    """Throughput-oriented eval on one device: threaded decode
    (``ingest.prefetch_clips``) → `num_windows` evenly-spaced snippet
    windows per clip → batches of `batch_clips` clips, each one
    ``batch_clip_metrics`` call.  Protocol-identical to
    ``evaluate(num_windows=N)``.  In a group of more than one process
    (``parallel/mesh``) it is ``evaluate_batched_multiprocess``, as the
    reference routes a run over several processes.

    In the decode workers, `host_resize` resizes each window's short side
    to ``resize_short`` (``host_resize_short``), and every window is sliced
    to the source region the device's resize and crop sample
    (``slice_crop_source``, the same answers), so only consumed pixels
    cross to the device.  Clips are grouped by (window shape, source
    crop): a dataset of mixed resolutions fills one group per resolution
    and flushes each on its own.

    A clip that fails to load in a worker is contained and reported per
    path in ``failures``; a failure of the device work propagates.  The
    per-batch correct counts stay on the device and are read once, after
    the last batch, so the host never waits on a batch before launching
    the next.

    A group's last, partial batch is not padded to `batch_clips` (the
    reference pads so that XLA compiles one program; eager PyTorch
    compiles nothing, and padding would compute flow for the copies).  The
    answers do not depend on it: TV-L1 stops each image on its own ε test,
    and a Farneback pixel depends only on its own pair.  (SpyNet's
    convolutions may differ in the last bits with the batch size on a GPU,
    where cuDNN picks its algorithm per shape.)
    """
    if process_count() > 1:
        return evaluate_batched_multiprocess(
            records, model, cfg, device, batch_clips=batch_clips,
            num_workers=num_workers, max_frames=max_frames,
            num_windows=num_windows, host_resize=host_resize,
            flow_net=flow_net)
    result, correct = _evaluate_batches(
        records, model, cfg, torch.device(device), batch_clips, num_workers,
        max_frames, num_windows, host_resize, flow_net)
    result.correct = int(correct.item())
    return result


def _evaluate_batches(records, model, cfg, device, batch_clips, num_workers,
                      max_frames, num_windows, host_resize, flow_net
                      ) -> Tuple[EvalResult, torch.Tensor]:
    """``evaluate_batched``'s loop over `records` on this process: the
    result with ``total``, ``failed`` and ``failures`` filled, and the
    correct count as a 0-d int64 tensor on `device`, not yet read."""
    win = _window_frames(cfg)
    pre = cfg.preprocess
    by_path = {r.path: r for r in records}

    def loader(path):
        wins = decode_snippet_windows(path, win, num_windows,
                                      max_frames=max_frames)
        if host_resize:
            wins = np.stack([host_resize_short(w, pre.resize_short)
                             for w in wins])
        return slice_crop_source(wins, pre.resize_short, pre.crop)

    result = EvalResult()
    pending: Dict = {}
    correct = torch.zeros((), dtype=torch.int64, device=device)

    def flush(key):
        nonlocal correct
        group = pending.pop(key, [])
        if not group:
            return
        paths, winss, hws = zip(*group)
        windows, labels, valid = _place_batch(
            np.stack(winss), [by_path[p].label for p in paths], device)
        c, _ = batch_clip_metrics(windows, labels, valid, model,
                                  _with_src_hw(cfg, hws[0]),
                                  flow_net=flow_net)
        correct = correct + c
        result.total += len(paths)

    for path, (wins, hw), _dt in prefetch_clips(
            [r.path for r in records], loader,
            num_workers=num_workers, error_log=result.failures):
        key = (wins.shape, hw)
        pending.setdefault(key, []).append((path, wins, hw))
        if len(pending[key]) >= batch_clips:
            flush(key)
    for key in list(pending):
        flush(key)
    result.failed = len(result.failures)
    return result, correct


def _with_src_hw(cfg: PipelineConfig, src_hw) -> PipelineConfig:
    """`cfg` with the transport crop's source geometry recorded."""
    return dataclasses.replace(cfg, preprocess=dataclasses.replace(
        cfg.preprocess, src_hw=src_hw))


def _place_batch(windows: np.ndarray, labels, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One eval batch on `device` as ``evaluate_batched`` dispatches it:
    (n, N, T, h, w, 3) uint8 windows, (n,) int64 labels and (n,) bool
    valid, all True.  Shared with ``warm_batched``, which so warms the
    same calls."""
    n = windows.shape[0]
    return (_to_device(windows, device),
            _to_device(np.asarray(labels, np.int64), device),
            torch.ones(n, dtype=torch.bool, device=device))


def evaluate_batched_multiprocess(records: List[ClipRecord],
                                  model: TwoStreamModel,
                                  cfg: PipelineConfig,
                                  device: Union[str, torch.device],
                                  batch_clips: int = 8,
                                  num_workers: int = 2,
                                  max_frames: int = 300,
                                  num_windows: int = 1,
                                  host_resize: bool = False,
                                  flow_net: Optional[SpyNet] = None
                                  ) -> EvalResult:
    """``evaluate_batched`` over a group of processes (``parallel/mesh``),
    each on its own device.  `records` is the same global list, in the same
    order, on every process; each process decodes and evaluates only its
    round-robin shard (``process_local_records``), in batches of
    ``global_batch_size(batch_clips) / process_count()`` clips, the
    reference's share of a global batch.

    The reference dispatches every global batch as one collective, so it
    pads each process's stream with invalid rows to keep the processes in
    lockstep.  Here a batch involves no other process: the only collective
    is one all-reduce of (correct, total, failed-shard flag) after the
    last batch.  ``total`` and ``correct`` are global and the same on every
    process; ``failures`` and ``failed`` are this process's shard's, as in
    the reference.  A process none of whose clips could be decoded (or
    that has none) makes every process raise ``RuntimeError`` (the
    reference raises on that process alone; here none is left waiting
    for it)."""
    device = torch.device(device)
    procs, pid = process_count(), process_index()
    if not records:
        return EvalResult()
    local = process_local_records(records, pid, procs)
    result, correct = _evaluate_batches(
        local, model, cfg, device, global_batch_size(batch_clips, procs)
        // procs, num_workers, max_frames, num_windows, host_resize,
        flow_net)
    counts = torch.stack([correct, torch.tensor(result.total, device=device),
                          torch.tensor(int(result.total == 0),
                                       device=device)])
    correct, total, empty = all_reduce_sum(counts).tolist()
    if empty:
        raise RuntimeError(
            f"process {pid}: {empty} process(es) of {procs} decoded no clip "
            f"of their shard; this one decoded {result.total} of its "
            f"{len(local)} record(s) (failures: {result.failures[:3]})")
    result.correct, result.total = correct, total
    return result


def warm_batched(model: TwoStreamModel, cfg: PipelineConfig,
                 window_shape, src_hw, batch_clips: int,
                 device: Union[str, torch.device],
                 flow_net: Optional[SpyNet] = None) -> Tuple[int, ...]:
    """Run the batch function once, on zeros, at the shape that
    ``evaluate_batched`` dispatches for clips whose windows, after the
    decode worker's resize and transport crop, have `window_shape` =
    (N, T, h, w, 3) and source geometry `src_hw`: a full batch of
    `batch_clips` clips, or this process's share of the global batch in a
    group.  Returns the windows' shape.  What the first call at a shape
    costs on the card (the kernels' build, cuDNN's choice of algorithms,
    the allocator's first blocks) is paid here."""
    device = torch.device(device)
    procs = process_count()
    n = global_batch_size(batch_clips, procs) // procs
    arr = np.zeros((n,) + tuple(window_shape), np.uint8)
    windows, labels, valid = _place_batch(arr, np.zeros(n), device)
    c, _ = batch_clip_metrics(windows, labels, valid, model,
                              _with_src_hw(cfg, src_hw),
                              flow_net=flow_net)
    c.item()
    return tuple(windows.shape)


def evaluate(records: Iterable[ClipRecord], model: TwoStreamModel,
             cfg: PipelineConfig, device: Union[str, torch.device],
             manifest_path: Optional[str] = None,
             predictions_path: Optional[str] = None,
             limit: Optional[int] = None,
             num_windows: int = 1,
             flow_net: Optional[SpyNet] = None) -> EvalResult:
    """Top-1 clip accuracy over a record list, clip by clip.

    A clip done in an earlier run with the same `manifest_path` is
    skipped; each clip classified here is marked done there and, with
    `predictions_path`, appended to that file as a JSON line
    ``{"path", "label", "pred"}``.  `limit` stops after that many records
    (skipped ones included).  A clip that fails to load is counted and
    named in ``failures``; a failure of the device work propagates.
    """
    manifest = ProgressManifest(manifest_path) if manifest_path else None
    result = EvalResult()
    preds_f = open(predictions_path, "a") if predictions_path else None
    try:
        for i, rec in enumerate(records):
            if limit is not None and i >= limit:
                break
            key = rec.path
            if manifest is not None and manifest.is_done(key):
                continue
            try:
                wins, wcfg = load_clip_windows(rec.path, cfg,
                                               num_windows=num_windows)
            except Exception as e:  # a corrupt clip: log, count, continue
                log.warning("clip failed: %s (%s)", rec.path, e)
                result.failed += 1
                result.failures.append((rec.path, repr(e)))
                continue
            probs = batch_clip_probs(torch.from_numpy(wins[None]).to(device),
                                     model, wcfg, flow_net=flow_net)
            pred = int(probs[0].argmax())
            result.total += 1
            result.correct += int(pred == rec.label)
            if preds_f:
                preds_f.write(json.dumps(
                    {"path": rec.path, "label": rec.label,
                     "pred": pred}) + "\n")
            if manifest is not None:        # (an empty one is falsy)
                manifest.mark_done(key)
            if (i + 1) % 50 == 0:
                log.info("evaluated %d clips, top1=%.4f",
                         result.total, result.top1)
    finally:
        if preds_f:
            preds_f.close()
    return result
