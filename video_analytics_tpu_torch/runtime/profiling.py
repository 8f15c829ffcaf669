"""Tracing and stage timing.

Port of ``video_analytics_tpu/runtime/profiling.py``: ``trace`` records a
device trace with ``torch.profiler`` (a Chrome/Perfetto trace file in
place of XProf's), and ``StageTimer`` accumulates wall time per named
stage, fenced by a synchronisation of the device's current stream where
asked (the reference blocks on an array).

``span`` (from ``utils.spans``) names a stage of the program on the
profiler's clock while a profiler records, and costs a flag check when
none does.  The program's spans, outermost first:

  - ``va/classify_batch`` (``runtime.pipeline.classify_batch``), inside
    it ``va/crop``, ``va/spatial``, ``va/flow``, ``va/stack`` (or, for
    streams that take clip volumes, ``va/volume``), ``va/temporal`` and
    ``va/fuse``;
  - ``va/tvl1.pyramid`` and one ``va/tvl1.level.<h>x<w>`` per pyramid
    level (``flow.tvl1.tvl1``), or ``va/farneback.pyramid`` and one
    ``va/farneback.level.<h>x<w>`` per level (``flow.farneback``),
    inside ``va/flow`` on those paths;
  - ``va/r2p1d.stem``, ``va/r2p1d.stage<k>`` and ``va/r2p1d.head``
    (``models.video_resnet.VideoResNet``), inside ``va/spatial`` and
    ``va/temporal`` on that path;
  - ``va/prefetch.wait`` (``ingest.prefetch.DevicePrefetcher``): the
    consumer's wait for a placed batch.

``trace`` records them with the kernels, so its Perfetto file shows the
stages.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional, Union

import torch

from video_analytics_tpu_torch.utils.logging import get_logger
from video_analytics_tpu_torch.utils.spans import span  # noqa: F401

log = get_logger("tpuva.profiling")


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a host and device trace viewable in Perfetto or
    chrome://tracing, written to ``logdir/trace.json``; yields the
    profiler (``key_averages()`` sums by kernel)::

        with profiling.trace("/tmp/trace"):
            run_pipeline()
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("trace written to %s", path)


class StageTimer:
    """Accumulates wall time per named stage, with device fencing."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str,
              fence: Optional[Union[torch.device, torch.Tensor]] = None):
        """Time the block.  With `fence` (a device, or a tensor on it) the
        stage ends when that CUDA device's current stream has finished the
        work queued so far: device time, not the time to queue it."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence is not None:
                dev = fence.device if isinstance(fence, torch.Tensor) \
                    else torch.device(fence)
                if dev.type == "cuda":
                    torch.cuda.current_stream(dev).synchronize()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": v, "count": self.counts[k],
                    "mean_ms": 1e3 * v / max(self.counts[k], 1)}
                for k, v in sorted(self.totals.items())}
