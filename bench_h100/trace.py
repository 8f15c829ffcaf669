"""The traced slice of a ``--trace 1`` run: torch.profiler over a few
seconds of the cell's own traffic, reduced to device-busy time, idle
gaps named by what the host was doing, and the device operations that
took most time.

The benchmark's host clock and the profiler's are tied by two marker
ranges (``bench/mark``), recorded just after the profiler starts and
just before it stops.  The profiler on the card now and then drops a
session's records; ``Slice.busy`` is then 0 and the caller takes
another slice.
"""

from __future__ import annotations

import heapq
import time
from typing import Dict, List, Optional, Tuple

SLICE_S = 3.0


def _short(name: str) -> str:
    """A kernel name without its namespace and argument list."""
    name = name.split("(anonymous namespace)::", 1)[-1]
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return name[:i]
    return name[:80]


def union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merge intervals into disjoint ones, in order."""
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(spans, lo: float, hi: float) -> List[Tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in spans
            if min(b, hi) > max(a, lo)]


def overlap(a_spans, b_spans) -> float:
    """Total length of the intersection of two disjoint, sorted lists."""
    i = j = 0
    total = 0.0
    while i < len(a_spans) and j < len(b_spans):
        lo = max(a_spans[i][0], b_spans[j][0])
        hi = min(a_spans[i][1], b_spans[j][1])
        total += max(0.0, hi - lo)
        if a_spans[i][1] < b_spans[j][1]:
            i += 1
        else:
            j += 1
    return total


def label_gaps(gaps, host) -> Dict[str, float]:
    """Seconds of idle gap by the innermost host range active at each
    gap's midpoint (`host`: (start, end, name) in seconds).  The profiler
    records the ranges of the thread that started it: a gap while only
    another thread works reads "no traced host range"."""
    events = sorted(host)
    open_ranges: list = []          # (-start, end, name): latest start on top
    out: Dict[str, float] = {}
    k = 0
    for a, b in sorted(gaps):
        mid = 0.5 * (a + b)
        while k < len(events) and events[k][0] <= mid:
            s, e, n = events[k]
            heapq.heappush(open_ranges, (-s, e, n))
            k += 1
        # Ranges that closed before mid leave from the top; the top is
        # then the latest-started range still open: the innermost.
        while open_ranges and open_ranges[0][1] < mid:
            heapq.heappop(open_ranges)
        name = open_ranges[0][2] if open_ranges else "no traced host range"
        out[name] = out.get(name, 0.0) + (b - a)
    return out


class Slice:
    """One profiled slice.  ``start()`` / ``stop()`` around the cell's
    traffic; then ``window_s``, ``busy`` (disjoint device intervals, in
    host-clock seconds), ``device_ops`` and ``gaps_by_host``."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = 0.0
        self.window_s = 0.0
        self.busy: List[Tuple[float, float]] = []
        self.device_ops: Dict[str, float] = {}
        self.gaps_by_host: Dict[str, float] = {}

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()
        with torch.profiler.record_function("bench/mark"):
            pass

    def stop(self) -> None:
        import torch

        self.t1 = time.perf_counter()
        with torch.profiler.record_function("bench/mark"):
            pass
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        self._reduce()
        self.prof = None

    def _reduce(self) -> None:
        import torch

        dev = torch.autograd.DeviceType.CUDA
        marks, kernels, host = [], [], []
        for ev in self.prof.events():
            a, b = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
            if ev.device_type == dev:
                # A host range's mirror on the device timeline is no work.
                if not (ev.name.startswith("bench/")
                        or getattr(ev, "is_user_annotation", False)):
                    kernels.append((a, b, ev.name))
            elif ev.name == "bench/mark":
                marks.append(a)
            else:
                host.append((a, b, ev.name))
        if len(marks) < 2:
            return
        marks.sort()
        # Host clock = profiler clock + shift, from the first marker.
        shift = self.t0 - marks[0]
        lo, hi = self.t0, self.t0 + (marks[-1] - marks[0])
        self.window_s = hi - lo
        spans = [(a + shift, b + shift) for a, b, _ in kernels]
        self.busy = clip(union(spans), lo, hi)
        for a, b, name in kernels:
            if min(b + shift, hi) > max(a + shift, lo):
                n = _short(name)
                self.device_ops[n] = self.device_ops.get(n, 0.0) + (b - a)
        gaps, at = [], lo
        for a, b in self.busy:
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if hi > at:
            gaps.append((at, hi))
        self.gaps_by_host = label_gaps(
            gaps, [(a + shift, b + shift, n) for a, b, n in host])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    def breakdown(self) -> dict:
        def top(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(self.device_ops),
                "idle_gaps": top(self.gaps_by_host)}


def busy_seconds(fn, reps: int) -> Optional[float]:
    """Device-busy seconds a call of ``fn()``: the union of the device
    intervals of `reps` calls in one traced slice, after a warm call,
    over `reps`; None where the trace holds no device time (no card)."""
    import torch

    def run_slice(s: Slice) -> None:
        s.start()
        for _ in range(reps):
            fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        s.stop()

    fn()
    s = profiled(run_slice)
    return None if s is None else s.busy_s / reps


def profiled(run_slice, tries: int = 5) -> Optional[Slice]:
    """``run_slice(slice)`` under a new Slice until its trace holds device
    time, at most `tries` times (once without a card); None if none
    does."""
    import torch

    for _ in range(tries if torch.cuda.is_available() else 1):
        s = Slice()
        run_slice(s)
        if s.busy_s > 0:
            return s
    return None
