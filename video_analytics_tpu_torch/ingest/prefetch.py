"""Threaded clip decode and host→device prefetch.

The port's copy of ``decode_worker`` and ``prefetch_clips`` from
``video_analytics_tpu/ingest/prefetch.py``, and ``DevicePrefetcher``
rebuilt for CUDA.  Decode runs in Python threads: OpenCV releases the
interpreter lock inside its decode loop, so the threads overlap each other
and the device work the consumer launches.  A clip that fails to load is
logged, recorded in ``error_log`` and skipped; the consumer never sees it.

``DevicePrefetcher`` copies batch k+1 to the GPU while the consumer's step
k runs: a worker thread copies each host batch into a pinned buffer and
issues the copy to the device on a side stream; the consumer's stream
waits for it on the device, never on the host.  The consumer's wait for a
placed batch is the span ``va/prefetch.wait`` while a profiler records.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, List, Optional, Union

import numpy as np
import torch

from video_analytics_tpu_torch.utils.logging import get_logger
from video_analytics_tpu_torch.utils.spans import span

log = get_logger("tpuva.ingest")

_SENTINEL = object()


def decode_worker(paths: Iterable[str], out_q: "queue.Queue",
                  loader: Callable[[str], Any],
                  error_log: Optional[List] = None,
                  stop: Optional[threading.Event] = None) -> None:
    """Load clips → `out_q` as (path, loaded, seconds), then a sentinel.
    A clip whose loader raises is logged and appended to `error_log` as
    (path, repr(exception)) (failure containment).  Stops early once
    `stop` is set."""
    for p in paths:
        if stop is not None and stop.is_set():
            break
        try:
            t0 = time.perf_counter()
            arr = loader(p)
            out_q.put((p, arr, time.perf_counter() - t0))
        except Exception as e:
            log.warning("decode failed: %s (%s)", p, e)
            if error_log is not None:
                error_log.append((p, repr(e)))
    out_q.put(_SENTINEL)


def prefetch_clips(paths: Iterable[str],
                   loader: Callable[[str], Any],
                   num_workers: int = 2,
                   queue_depth: int = 4,
                   error_log: Optional[List] = None) -> Iterator[Any]:
    """Threaded decode of many clips → (path, loaded, decode seconds)
    stream, each path once (worker i takes paths i, i + num_workers, ...).
    Order across workers is not guaranteed.  Load failures are appended to
    `error_log` as (path, repr(exception)), so callers can report exactly
    which clips failed.

    If the consumer stops early (an exception in its loop, or ``close()``)
    the workers are told to stop and joined before the exception goes on:
    no thread outlives the stream."""
    paths = list(paths)
    out_q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
    stop = threading.Event()
    threads = [threading.Thread(target=decode_worker,
                                args=(paths[i::num_workers], out_q, loader,
                                      error_log, stop), daemon=True)
               for i in range(num_workers)]
    for t in threads:
        t.start()
    done = 0
    try:
        while done < num_workers:
            item = out_q.get()
            if item is _SENTINEL:
                done += 1
                continue
            yield item
    finally:
        stop.set()
        while done < num_workers:      # unblock workers waiting to put
            if out_q.get() is _SENTINEL:
                done += 1
        for t in threads:
            t.join()


def _tree_map(fn: Callable[[Any], Any], item: Any) -> Any:
    """fn over the leaves of nested tuples, lists and dicts."""
    if isinstance(item, (tuple, list)):
        return type(item)(_tree_map(fn, x) for x in item)
    if isinstance(item, dict):
        return {k: _tree_map(fn, v) for k, v in item.items()}
    return fn(item)


class _Slot:
    """Pinned host buffers for one batch's arrays, and the event recorded
    after the copies that read them."""

    def __init__(self):
        self.buffers: List[torch.Tensor] = []
        self.event: Optional[torch.cuda.Event] = None


class DevicePrefetcher:
    """Wrap a host-batch iterator; the copy to `device` runs up to `depth`
    batches ahead on a worker thread.

    Usage::

        for windows, labels in DevicePrefetcher(host_batches(), depth=2):
            ...

    Each leaf of a batch (nested tuples, lists and dicts) that is a numpy
    array or a CPU tensor arrives as a tensor on `device`; other leaves
    (ints, strings, None, tensors already on a device) ride along.  On a
    CUDA device the worker copies each array into a pinned buffer from a
    pool of ``depth + 1``, issues ``.to(device, non_blocking=True)`` on a
    side stream and records an event; the consumer's current stream waits
    for that event, and each tensor is marked used on that stream
    (``record_stream``), so its memory is not reused before the consumer's
    work is done.  A pinned buffer is filled again only after the event of
    its last copy has completed.  On a CPU device the same thread and queue
    run with no stream.  An exception of the wrapped iterator reaches the
    consumer after the batches before it.  ``stats``: ``put_s``, the
    worker's seconds per batch summed (pinned copy and issuing the
    transfer), and ``batches``.
    """

    def __init__(self, it: Iterable[Any], depth: int = 2,
                 device: Union[str, torch.device] = "cuda"):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        if self._cuda and self._device.index is None:
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self.stats = {"put_s": 0.0, "batches": 0}
        if self._cuda:
            self._stream = torch.cuda.Stream(self._device)
            self._slots = [_Slot() for _ in range(depth + 1)]
        self._thread = threading.Thread(target=self._run, args=(iter(it),),
                                        daemon=True)
        self._thread.start()

    # -- worker side --------------------------------------------------------

    def _place_cpu(self, x: Any) -> Any:
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.array(x))
        return x

    def _place_cuda(self, item: Any, slot: _Slot):
        """(placed item, its device tensors, the event after their copies)."""
        if slot.event is not None:
            slot.event.synchronize()       # its last copies have read it
        placed: List[torch.Tensor] = []

        def place(x: Any) -> Any:
            if isinstance(x, np.ndarray):
                dtype = torch.from_numpy(np.empty(0, x.dtype)).dtype
            elif isinstance(x, torch.Tensor) and x.device.type == "cpu":
                dtype = x.dtype
            else:
                return x
            k = len(placed)
            if (k == len(slot.buffers) or slot.buffers[k].shape != x.shape
                    or slot.buffers[k].dtype != dtype):
                buf = torch.empty(x.shape, dtype=dtype, pin_memory=True)
                slot.buffers[k:k + 1] = [buf]
            buf = slot.buffers[k]
            if isinstance(x, np.ndarray):
                np.copyto(buf.numpy(), x, casting="no")
            else:
                buf.copy_(x)
            placed.append(buf.to(self._device, non_blocking=True))
            return placed[-1]

        with torch.cuda.stream(self._stream):
            out = _tree_map(place, item)
            slot.event = torch.cuda.Event()
            slot.event.record(self._stream)
        return out, placed, slot.event

    def _put(self, entry: Any) -> bool:
        """Queue `entry` unless the consumer has stopped; False if it has."""
        while not self._stop.is_set():
            try:
                self._q.put(entry, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, it: Iterator[Any]) -> None:
        try:
            if self._cuda:
                torch.cuda.set_device(self._device)
            for i, item in enumerate(it):
                if self._stop.is_set():
                    return
                t0 = time.perf_counter()
                if self._cuda:
                    entry = self._place_cuda(item,
                                             self._slots[i % len(self._slots)])
                else:
                    entry = (_tree_map(self._place_cpu, item), [], None)
                self.stats["put_s"] += time.perf_counter() - t0
                self.stats["batches"] += 1
                if not self._put(entry):
                    return
        except BaseException as e:  # surfaced on the consumer side
            self._exc = e
        finally:
            self._put(_SENTINEL)

    # -- consumer side ------------------------------------------------------

    def __iter__(self) -> Iterator[Any]:
        while True:
            with span("va/prefetch.wait"):
                entry = self._q.get()
                if entry is _SENTINEL:
                    self._thread.join()
                    if self._exc is not None:
                        raise self._exc
                    return
                item, tensors, event = entry
                if event is not None:
                    stream = torch.cuda.current_stream(self._device)
                    stream.wait_event(event)
                    for t in tensors:
                        t.record_stream(stream)
            yield item

    def close(self, timeout: float = 30.0) -> None:
        """Stop the worker after the batch it is placing and join it.  The
        wait is bounded: a worker blocked on the wrapped iterator (a
        sampler still running) ends when that iterator does."""
        self._stop.set()
        deadline = time.perf_counter() + timeout
        while self._thread.is_alive() and time.perf_counter() < deadline:
            try:
                self._q.get(timeout=0.2)
            except queue.Empty:
                pass
        self._thread.join(timeout=max(0.0, deadline - time.perf_counter()))
