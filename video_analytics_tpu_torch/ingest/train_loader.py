"""Threaded training-batch loader.

The port's copy of ``video_analytics_tpu/ingest/train_loader.py``: the
same sampling (worker ``w`` draws from ``np.random.default_rng(seed·7919 +
w)``), the same batches for the same seed with one worker, the same cache
files.  It feeds training the way ``evaluate_batched`` feeds evaluation:

- worker threads sample random clips, decode them (OpenCV releases the
  interpreter lock inside its decode loop, so the threads overlap the
  train step the main thread queues on the device), and crop a random
  window;
- the main thread assembles fixed-size batches from a bounded queue;
- ``ingest/prefetch.DevicePrefetcher`` then copies batch k+1 to the
  device while step k runs.

An optional window cache writes each clip's decoded frames to one ``.npy``
per clip on first touch; later epochs sample windows from a memory-mapped
array instead of decoding the container again.
"""

from __future__ import annotations

import hashlib
import os
import queue
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

from video_analytics_tpu_torch.io.dataset import ClipRecord
from video_analytics_tpu_torch.utils.logging import get_logger

log = get_logger("tpuva.train_loader")

# A worker that fails this many clips IN A ROW gives up (every record
# corrupt); random sampling makes isolated corrupt clips harmless.
_MAX_CONSECUTIVE_FAILURES = 20


class DecodeWorkersExited(RuntimeError):
    """Every decode worker gave up: each failed on
    ``_MAX_CONSECUTIVE_FAILURES`` clips in a row."""


class TrainWindowSampler:
    """Infinite stream of (window, label) training examples drawn by
    decode worker threads; iterate `batches()` for stacked batches.

    All windows share one (H, W): the first decoded clip pins it and
    later clips are host-resized to match (one batch shape).
    """

    def __init__(self, records: List[ClipRecord], window: int,
                 batch: int, seed: int = 0, max_frames: int = 120,
                 num_workers: int = 2, queue_depth: int = 64,
                 cache_dir: Optional[str] = None):
        if not records:
            raise ValueError("no training records")
        self.records = records
        self.window = window
        self.batch = batch
        self.max_frames = max_frames
        self.cache_dir = cache_dir
        self.stats = {"decodes": 0, "cache_hits": 0, "windows": 0,
                      "failures": 0}
        self._expected_hw: Optional[Tuple[int, int]] = None
        self._hw_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._stop = threading.Event()
        self._threads = []
        for w in range(num_workers):
            t = threading.Thread(
                target=self._worker,
                args=(np.random.default_rng(seed * 7919 + w),),
                daemon=True)
            t.start()
            self._threads.append(t)

    # -- clip loading -------------------------------------------------------

    def _cache_path(self, rec: ClipRecord) -> str:
        key = hashlib.sha1(
            f"{os.path.abspath(rec.path)}:{self.max_frames}"
            .encode()).hexdigest()[:16]
        stem = os.path.splitext(os.path.basename(rec.path))[0]
        return os.path.join(self.cache_dir, f"{stem}_{key}.npy")

    def _load_frames(self, rec: ClipRecord) -> np.ndarray:
        from video_analytics_tpu_torch.io.video import VideoReader
        if self.cache_dir:
            cp = self._cache_path(rec)
            if os.path.exists(cp):
                with self._stats_lock:
                    self.stats["cache_hits"] += 1
                return np.load(cp, mmap_mode="r")
        with VideoReader(rec.path) as r:
            frames = r.read_all(max_frames=self.max_frames)
        with self._stats_lock:
            self.stats["decodes"] += 1
        if self.cache_dir:
            os.makedirs(self.cache_dir, exist_ok=True)
            cp = self._cache_path(rec)
            # Write through a file handle so the temp name need not end
            # in ".npy" (np.save would append it) — a temp abandoned by
            # an interrupted worker then can't be mistaken for a cache
            # entry by *.npy consumers.
            tmp = cp + f".tmp{threading.get_ident()}"
            with open(tmp, "wb") as f:
                np.save(f, frames)
            os.replace(tmp, cp)       # atomic vs concurrent writers
        return frames

    def _sample_window(self, rng: np.random.Generator,
                       frames: np.ndarray) -> np.ndarray:
        import cv2
        start = int(rng.integers(0, max(1, len(frames) - self.window + 1)))
        sel = np.clip(np.arange(start, start + self.window), 0,
                      len(frames) - 1)
        w = np.asarray(frames[sel])
        with self._hw_lock:
            if self._expected_hw is None:
                self._expected_hw = w.shape[1:3]
            hw = self._expected_hw
        if w.shape[1:3] != hw:
            w = np.stack([cv2.resize(f, (hw[1], hw[0])) for f in w])
        return w

    # -- worker loop --------------------------------------------------------

    def _worker(self, rng: np.random.Generator) -> None:
        consecutive = 0
        while not self._stop.is_set():
            rec = self.records[int(rng.integers(len(self.records)))]
            try:
                frames = self._load_frames(rec)
                if len(frames) == 0:
                    raise IOError("zero frames")
                item = (self._sample_window(rng, frames), rec.label)
            except Exception as e:
                log.warning("train decode failed: %s (%s)", rec.path, e)
                with self._stats_lock:
                    self.stats["failures"] += 1
                consecutive += 1
                if consecutive >= _MAX_CONSECUTIVE_FAILURES:
                    log.error("worker giving up after %d consecutive "
                              "failures", consecutive)
                    return
                continue
            consecutive = 0
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue

    # -- consumer side ------------------------------------------------------

    def batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Infinite (windows (B,T,H,W,3) uint8, labels (B,) int32)
        stream; call stop() (or break) when trained."""
        while True:
            ws, ys = [], []
            while len(ws) < self.batch:
                try:
                    w, y = self._q.get(timeout=1.0)
                except queue.Empty:
                    if not any(t.is_alive() for t in self._threads):
                        raise DecodeWorkersExited(
                            "all decode workers exited (every record "
                            f"failing?); stats={self.stats}")
                    continue
                ws.append(w)
                ys.append(y)
            with self._stats_lock:
                self.stats["windows"] += len(ws)
            yield np.stack(ws), np.asarray(ys, np.int32)

    def qsize(self) -> int:
        """Examples decoded ahead and waiting (overlap visibility)."""
        return self._q.qsize()

    def stop(self) -> None:
        """Signal workers and wait for them to drain.

        Joining matters for the window cache: without it a worker can
        still be mid cache-write after ``with`` exits, leaving a .tmp
        file visible to whoever scans the cache dir next.  Workers
        re-check the stop flag every 0.2s while blocked on the queue,
        so the join bound is one in-flight decode+save."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=30.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
