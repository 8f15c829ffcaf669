"""The program's own spans in a traced slice of a batch cell: the second
module of the benchmark that touches the program, and only through the
trace.  It imports nothing of ``video_analytics_tpu_torch``; it matches
the names of the program's ``record_function`` ranges (``va/...``) and of
the benchmark's own (``bench/...``) as strings.

On the first call of ``of(view)`` it profiles one more slice of the
cell's own traffic (``SpanSlice``: a ``trace.Slice`` that keeps, before
the profiler's events are dropped, each device operation with the host
range open on the launching thread when its launch call ran) and caches
the reduction on the view, so that the per-layer readers share one
slice.  Per-batch figures count the ``va/classify_batch`` spans that
began and ended inside the slice, and only the device operations those
spans launched.  A program without the spans gives no batch, and every
reader None.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from bench_h100 import harness, trace

BATCH = "va/classify_batch"
NO_RANGE = "no traced host range"
OWN = ("va/", "bench/")
SYNCS = ("cudaStreamSynchronize", "cudaEventSynchronize",
         "cudaDeviceSynchronize")


@dataclass
class Reduced:
    """What the readers take from one slice (seconds; sums over the
    complete batches where a name says ``batch``)."""

    batches: int = 0
    busy_s: float = 0.0
    idle_s: float = 0.0
    device_s: Dict[str, float] = field(default_factory=dict)
    kernels: int = 0
    idle_by_range: Dict[str, float] = field(default_factory=dict)
    idle_in_batch_s: float = 0.0
    batch_busy_s: float = 0.0
    sync_by_range: Dict[str, float] = field(default_factory=dict)


class _Stacks:
    """The nested ranges of one thread: which are open at a time."""

    def __init__(self, ranges: List[Tuple[float, float, str]]):
        # Boundaries in time order; at a tie a range closes before the
        # next opens.  Between two boundaries the open ranges hold still.
        # A range of no length holds nothing.
        kept = [i for i, (a, b, _) in enumerate(ranges) if b > a]
        marks = sorted([(ranges[i][0], 1, i) for i in kept]
                       + [(ranges[i][1], 0, i) for i in kept])
        self.times: List[float] = []
        self.stacks: List[Tuple[int, ...]] = []
        open_: List[int] = []
        for t, opening, i in marks:
            if opening:
                open_.append(i)
            elif i in open_:
                open_.remove(i)
            self.times.append(t)
            self.stacks.append(tuple(open_))

    def at(self, t: float) -> Tuple[int, ...]:
        """Indices of the ranges open at `t`, outermost first."""
        k = bisect.bisect_right(self.times, t) - 1
        return self.stacks[k] if k >= 0 else ()

    def idle(self, gaps):
        """(seconds, open ranges) of each piece of the sorted, disjoint
        `gaps` between two boundaries."""
        for a, b in gaps:
            k = bisect.bisect_right(self.times, a)
            while a < b:
                end = min(b, self.times[k]) if k < len(self.times) else b
                if end > a:
                    yield end - a, self.at(a)
                a = end
                k += 1


def reduce(kernels, launches, ranges, syncs, lo: float,
           hi: float) -> Reduced:
    """The slice [lo, hi] (seconds on the profiler's clock) from
    `kernels`: (start, end, name, correlation) device operations;
    `launches`: {correlation: time} of the launching thread's launch
    calls; `ranges`: (start, end, name) of that thread's ``va/`` and
    ``bench/`` ranges; `syncs`: (start, end) of its synchronising
    calls."""
    out = Reduced()
    stacks = _Stacks(ranges)
    complete = {i for i, (a, b, n) in enumerate(ranges)
                if n == BATCH and lo <= a and b <= hi}
    out.batches = len(complete)
    busy = trace.clip(trace.union([(a, b) for a, b, _, _ in kernels]),
                      lo, hi)
    out.busy_s = sum(b - a for a, b in busy)
    mine = []
    for a, b, name, corr in kernels:
        t = launches.get(corr)
        opened = stacks.at(t) if t is not None else ()
        if not complete.intersection(opened):
            continue
        mine.append((a, b))
        if not name.startswith(("Memcpy", "Memset")):
            out.kernels += 1
        for n in {ranges[i][2] for i in opened}:
            out.device_s[n] = out.device_s.get(n, 0.0) + (b - a)
    out.batch_busy_s = sum(b - a for a, b in
                           trace.clip(trace.union(mine), lo, hi))
    gaps, at = [], lo
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    out.idle_s = sum(b - a for a, b in gaps)
    for idle, opened in stacks.idle(gaps):
        name = ranges[opened[-1]][2] if opened else NO_RANGE
        out.idle_by_range[name] = out.idle_by_range.get(name, 0.0) + idle
        if complete.intersection(opened):
            out.idle_in_batch_s += idle
    for a, b in syncs:
        opened = stacks.at(a)
        name = ranges[opened[-1]][2] if opened else NO_RANGE
        out.sync_by_range[name] = out.sync_by_range.get(name, 0.0) + (b - a)
    return out


class SpanSlice(trace.Slice):
    """A traced slice that also reduces the program's spans
    (``reduced``) before the profiler's events are dropped."""

    reduced: Optional[Reduced] = None

    def _reduce(self) -> None:
        super()._reduce()
        import torch

        dev = torch.autograd.DeviceType.CUDA
        marks, kernels, calls, host = [], [], [], []
        for ev in self.prof.events():
            a, b = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
            if ev.device_type == dev:
                if not (ev.name.startswith(OWN)
                        or getattr(ev, "is_user_annotation", False)):
                    kernels.append((a, b, ev.name, ev.id))
            elif ev.name == "bench/mark":
                marks.append(a)
            elif ev.name.startswith(OWN):
                host.append((a, b, ev.name, ev.thread))
            elif ev.name.startswith("cu"):
                # A runtime call: its id is the correlation of the device
                # operation it launched.
                calls.append((a, b, ev.name, ev.id, ev.thread))
        if len(marks) < 2:
            return
        threads = {t for _, _, n, t in host if n == BATCH}
        thread = min(threads) if threads else None
        ranges = [(a, b, n) for a, b, n, t in host if t == thread]
        launches = {c: a for a, _, _, c, t in calls if t == thread}
        syncs = [(a, b) for a, b, n, _, t in calls
                 if t == thread and n in SYNCS]
        self.reduced = reduce(kernels, launches, ranges, syncs,
                              min(marks), max(marks))


def _profile(loop) -> Optional[SpanSlice]:
    """A SpanSlice over `trace.SLICE_S` of the loop's traffic whose trace
    holds device time, in at most five tries (one without a card), as
    ``trace.profiled`` takes its slices."""
    import torch

    for _ in range(5 if torch.cuda.is_available() else 1):
        s = SpanSlice()
        s.start()
        loop.drive(trace.SLICE_S, None)
        s.stop()
        if s.busy_s > 0:
            return s
    return None


def of(view) -> Optional[Reduced]:
    """The reduction of the view's span slice, taken on first use; None
    outside a batch view, without a device trace or without a complete
    ``va/classify_batch`` span in it."""
    if getattr(view, "kind", None) != "batch":
        return None
    if not hasattr(view, "_spans"):
        s = _profile(view._loop)
        view._spans = s.reduced if s is not None else None
        if view._spans is not None:
            harness.note(note(view._spans))
    r = view._spans
    return r if r is not None and r.batches else None


def note(r: Reduced) -> str:
    """One line: device and idle ms a batch by span, the synchronising
    calls' host ms a batch by the span they ran in, and the shares of the
    slice's busy time launched inside ``va/classify_batch`` and of its
    idle time under a ``va/`` or ``bench/`` range."""
    if not r.batches:
        return f"spans: no complete {BATCH} span in the slice"
    n = r.batches

    def ms(d):
        return ", ".join(f"{k} {1e3 * v / n:.3f}"
                         for k, v in sorted(d.items(), key=lambda kv: -kv[1]))
    named = sum(v for k, v in r.idle_by_range.items() if k != NO_RANGE)
    return (f"spans over {r.batches} batches: device ms a batch "
            f"[{ms(r.device_s)}]; idle ms a batch [{ms(r.idle_by_range)}]; "
            f"sync ms a batch [{ms(r.sync_by_range)}]; busy launched in "
            f"{BATCH} {100 * r.batch_busy_s / max(r.busy_s, 1e-12):.2f} %; "
            f"idle under va/ or bench/ "
            f"{100 * named / max(r.idle_s, 1e-12):.2f} %; busy ms a batch "
            f"{1e3 * r.busy_s / n:.3f}")
