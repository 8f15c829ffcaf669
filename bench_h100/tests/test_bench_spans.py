"""The reduction of the program's spans (``spans.py``) on hand-made
events, the profiler's events as ``SpanSlice`` reads them, and the four
readers' None where they have nothing to read."""

import time
from types import SimpleNamespace

import pytest
import torch

from bench_h100 import harness, program, spans, trace
from bench_h100 import run as runner
from bench_h100.tests import tiny

MS = 1e-3
READERS = ("flow_device_ms.batch", "cnn_device_ms.batch", "launches.batch",
           "idle_in_classify_ms.batch")

# Host ranges of the launching thread, in ms: a batch cut by the slice's
# start (E0), the wait for the next, two complete batches (B1, B2) and
# one cut by the slice's end (E3).
RANGES = [
    (-10, 6, "va/classify_batch"), (-8, 5, "va/flow"),
    (6, 14, "bench/fetch"),
    (14.5, 20, "bench/prefetch_wait"), (15, 19.5, "va/prefetch.wait"),
    (20, 50, "bench/classify"), (21, 49.5, "va/classify_batch"),
    (21, 23, "va/crop"), (23, 28, "va/spatial"), (28, 40, "va/flow"),
    (40, 42, "va/stack"), (42, 46, "va/temporal"), (46, 48, "va/fuse"),
    (50.5, 80, "bench/classify"), (51, 79.5, "va/classify_batch"),
    (51, 53, "va/crop"), (53, 58, "va/spatial"), (58, 70, "va/flow"),
    (59, 69, "va/tvl1.level.8x8"), (70, 72, "va/stack"),
    (72, 76, "va/temporal"), (76, 78, "va/fuse"),
    (80.5, 110, "bench/classify"), (81, 109, "va/classify_batch"),
    (82, 105, "va/flow"),
]
# Device operations (start, end, name, correlation) and the launch call
# of each (ms); the HtoD copy was launched on another thread.
KERNELS = [
    (0, 10, "void flow", 1, 4),
    (14, 15, "Memcpy HtoD (Pinned -> Device)", 2, None),
    (22, 24, "void crop", 11, 22), (24, 30, "void conv", 12, 24),
    (30, 36, "void pd_warp", 13, 29), (38, 44, "void pd_warp", 14, 37),
    (44, 45, "Memcpy DtoD (Device -> Device)", 15, 41),
    (45, 50, "void conv", 16, 43), (50, 51, "void fuse", 17, 47),
    (51, 54, "void crop", 21, 52), (54, 60, "void conv", 22, 54),
    (60, 66, "void pd_warp", 23, 59.5), (66, 74, "void pd_warp", 24, 67),
    (74, 75, "Memcpy DtoD (Device -> Device)", 25, 71),
    (75, 80, "void conv", 26, 73), (80, 81, "void fuse", 27, 77),
    (81, 95, "void pd_warp", 31, 83),
]
SYNCS = [(35, 36.5)]
LO, HI = 0, 100


def _reduced():
    return spans.reduce(
        [(a * MS, b * MS, n, c) for a, b, n, c, _ in KERNELS],
        {c: t * MS for _, _, _, c, t in KERNELS if t is not None},
        [(a * MS, b * MS, n) for a, b, n in RANGES],
        [(a * MS, b * MS) for a, b in SYNCS], LO * MS, HI * MS)


def _view(reduced):
    view = SimpleNamespace(kind="batch")
    view._spans = reduced
    return view


def _read(name, view):
    return harness.Spec().metric(name).read(view)


def test_the_reduction_of_two_batches():
    r = _reduced()
    assert r.batches == 2
    # Busy [0, 10], [14, 15], [22, 36], [38, 95]; idle the rest of [0, 100].
    assert r.busy_s == pytest.approx(82 * MS)
    assert r.idle_s == pytest.approx(18 * MS)
    # Only B1's and B2's operations: neither E0's, E3's nor the HtoD copy.
    assert r.device_s["va/classify_batch"] == pytest.approx(57 * MS)
    assert r.device_s["va/flow"] == pytest.approx(26 * MS)
    assert r.device_s["va/tvl1.level.8x8"] == pytest.approx(14 * MS)
    assert r.device_s["va/stack"] == pytest.approx(2 * MS)
    assert r.kernels == 12
    assert r.batch_busy_s == pytest.approx(57 * MS)
    assert r.idle_by_range == pytest.approx({
        "bench/fetch": 4 * MS, "va/prefetch.wait": 4.5 * MS,
        "bench/prefetch_wait": 0.5 * MS, "bench/classify": 1 * MS,
        "va/crop": 1 * MS, "va/flow": 7 * MS})
    # Inside a complete batch: [21, 22] under va/crop, [36, 38] under
    # B1's va/flow; not [95, 100], under E3's.
    assert r.idle_in_batch_s == pytest.approx(3 * MS)
    assert r.sync_by_range == pytest.approx({"va/flow": 1.5 * MS})


def test_the_four_readers():
    view = _view(_reduced())
    got = {name: _read(name, view) for name in READERS}
    assert got == pytest.approx({
        "flow_device_ms.batch": 13.0, "cnn_device_ms.batch": 11.0,
        "launches.batch": 6.0, "idle_in_classify_ms.batch": 1.5})
    busy_ms = 82.0 / 2
    assert got["flow_device_ms.batch"] + got["cnn_device_ms.batch"] \
        <= busy_ms


def test_the_note_names_each_span():
    line = spans.note(_reduced())
    for name in ("va/flow 13.000", "va/tvl1.level.8x8 7.000",
                 "va/prefetch.wait 2.250", "bench/fetch 2.000",
                 "busy launched in va/classify_batch 69.51 %"):
        assert name in line, (name, line)


def test_a_program_without_spans_gives_no_batch():
    r = spans.reduce(
        [(a * MS, b * MS, n, c) for a, b, n, c, _ in KERNELS], {},
        [(a * MS, b * MS, n) for a, b, n in RANGES
         if n.startswith("bench/")], [], LO * MS, HI * MS)
    assert r.batches == 0 and r.busy_s > 0
    assert spans.note(r) == ("spans: no complete va/classify_batch span "
                             "in the slice")
    view = _view(r)
    assert all(_read(name, view) is None for name in READERS)


def _event(a, b, name, dev, id_=0, annotation=False):
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    return SimpleNamespace(
        time_range=SimpleNamespace(start=a * 1e3, end=b * 1e3), name=name,
        device_type=cuda if dev else cpu, id=id_, thread=1,
        is_user_annotation=annotation)


def test_the_slice_ties_each_operation_to_its_launch_call():
    """The profiler's events as SpanSlice reads them: the launch call
    shares the operation's id; an aten op of the same id, a range's
    mirror on the device and a launch call before the first mark do not
    count."""
    events = [_event(0, 0, "bench/mark", False),
              _event(HI, HI, "bench/mark", False)]
    events += [_event(a, b, n, False) for a, b, n in RANGES]
    events += [_event(21, 49.5, "va/classify_batch", True, annotation=True)]
    for a, b, n, c, t in KERNELS:
        events.append(_event(a, b, n, True, c))
        if t is not None:
            events.append(_event(t, t + 0.1, "cudaLaunchKernel", False, c))
            events.append(_event(t, t + 0.05, "aten::mul", False, c))
    events += [_event(a, b, "cudaStreamSynchronize", False, 900 + i)
               for i, (a, b) in enumerate(SYNCS)]
    s = spans.SpanSlice()
    s.t0 = 5.0
    s.prof = SimpleNamespace(events=lambda: events)
    s._reduce()
    want = _reduced()
    got = s.reduced
    assert got.batches == want.batches and got.kernels == want.kernels
    for key in ("busy_s", "idle_s", "batch_busy_s", "idle_in_batch_s"):
        assert getattr(got, key) == pytest.approx(getattr(want, key)), key
    assert got.device_s == pytest.approx(want.device_s)
    assert got.idle_by_range == pytest.approx(want.idle_by_range)
    assert got.sync_by_range == pytest.approx(want.sync_by_range)
    assert s.busy_s == pytest.approx(82 * MS)


def test_readers_are_none_outside_a_batch_view_or_without_a_device_trace(
        tmp_path, monkeypatch):
    assert all(_read(name, SimpleNamespace(kind="serve")) is None
               for name in READERS)
    assert all(_read(name, _view(None)) is None for name in READERS)
    # A traced run of the tiny TV-L1 cell on the CPU: its slice holds no
    # device time, so the readers leave their metrics out.
    spec = tiny.make_spec(str(tmp_path))
    monkeypatch.setattr(trace, "SLICE_S", 0.2)
    res = runner.execute(runner.Run(spec, "tvl1_batch", 2**31 + 7, 0.3,
                                    True, torch.device("cpu"), program,
                                    time.perf_counter()))
    assert res["correct"]
    assert not set(READERS) & set(res["metrics"])
