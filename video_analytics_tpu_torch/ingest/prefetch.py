"""Threaded clip decode on the host.

The port's copy of ``decode_worker`` and ``prefetch_clips`` from
``video_analytics_tpu/ingest/prefetch.py``.  Decode runs in Python
threads: OpenCV releases the interpreter lock inside its decode loop, so
the threads overlap each other and the device work the consumer launches.
A clip that fails to load is logged, recorded in ``error_log`` and
skipped; the consumer never sees it.

The reference's ``DevicePrefetcher`` (host→device copies on a thread,
used by ``train``) is not ported with this module; it comes with the
training slice.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, List, Optional

from video_analytics_tpu_torch.utils.logging import get_logger

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
