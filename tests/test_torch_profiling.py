"""The port's spans (``runtime.profiling.span``) on the CPU: a shared null
context while no profiler records; under ``torch.profiler`` every span
of a TV-L1 ``classify_batch`` fed by a ``DevicePrefetcher``, and of a
Farneback one on R(2+1)D streams, nested as the stages are; and the same
probabilities, flow and rounds with the profiler on and off."""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from video_analytics_tpu_torch.config import (
    FarnebackConfig, PipelineConfig, PreprocessConfig, TVL1Config)
from video_analytics_tpu_torch.flow import farneback as fb_mod
from video_analytics_tpu_torch.flow import tvl1 as tvl1_mod
from video_analytics_tpu_torch.ingest.prefetch import DevicePrefetcher
from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
from video_analytics_tpu_torch.runtime import pipeline, profiling

torch.set_num_threads(1)

CFG = PipelineConfig(
    preprocess=PreprocessConfig(resize_short=36, crop=32, flow_stack=2),
    tvl1=TVL1Config(nscales=3, warps=2, inner_iterations=4,
                    outer_iterations=3),
    flow_algo="tvl1", num_classes=5)
STAGES = ("va/classify_batch", "va/crop", "va/spatial", "va/flow",
          "va/stack", "va/temporal", "va/fuse", "va/tvl1.pyramid",
          "va/prefetch.wait")


@pytest.fixture(scope="module")
def setup():
    torch.manual_seed(0)
    model = TwoStreamModel.create(num_classes=5, flow_stack=2,
                                  width=8).eval()
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, (2, 40, 52, 3)).astype(np.uint8)
    windows = np.stack([[np.roll(base[b], (t, 2 * t), axis=(0, 1))
                         for t in range(5)] for b in range(2)])
    return model, windows


def _classify(model, windows):
    """Probabilities of `windows` through a CPU DevicePrefetcher, and the
    rounds TV-L1 recorded."""
    log = []
    tvl1_mod.tvl1.rounds = log
    try:
        for (x,) in DevicePrefetcher(iter([(windows,)]), depth=1,
                                     device="cpu"):
            probs = pipeline.classify_batch(x, model, CFG)
    finally:
        tvl1_mod.tvl1.rounds = None
    return probs, log


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name.startswith("va/")]


def _inside(inner, outers):
    return any(o.thread == inner.thread
               and o.time_range.start <= inner.time_range.start
               and inner.time_range.end <= o.time_range.end
               for o in outers)


class _Unprintable:
    def __str__(self):
        raise AssertionError("a span's name was formatted")


def test_span_is_one_shared_null_context_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    a = profiling.span("va/classify_batch")
    b = profiling.span("va/tvl1.level.%sx%s", _Unprintable(), 3)
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a, b:
        pass


def test_span_formats_its_name_while_a_profiler_records():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("va/tvl1.level.%dx%d", 12, 34):
            torch.ones(2).add_(1)
    assert [e.name for e in prof.events()
            if e.name.startswith("va/")] == ["va/tvl1.level.12x34"]


def test_every_span_is_traced_and_nested(setup):
    model, windows = setup
    _, spans = _traced(lambda: _classify(model, windows))
    by_name = {}
    for e in spans:
        by_name.setdefault(e.name, []).append(e)
    for name in STAGES:
        assert name in by_name, (name, sorted(by_name))
    assert len(by_name["va/classify_batch"]) == 1
    batch = by_name["va/classify_batch"]
    for name in STAGES[1:-1]:
        for e in by_name[name]:
            assert _inside(e, batch), name
    flow = by_name["va/flow"]
    assert _inside(by_name["va/tvl1.pyramid"][0], flow)
    sizes = tvl1_mod._level_sizes(32, 32, CFG.tvl1)
    assert len(sizes) == 3
    levels = [e for e in spans if e.name.startswith("va/tvl1.level.")]
    assert sorted(e.name for e in levels) == sorted(
        f"va/tvl1.level.{h}x{w}" for h, w in sizes)
    assert all(_inside(e, flow) for e in levels)
    # The wait for the batch ends before the call it feeds begins.
    wait = by_name["va/prefetch.wait"][0]
    assert wait.time_range.end <= batch[0].time_range.start


def test_results_are_bit_identical_with_the_profiler_on_and_off(setup):
    model, windows = setup
    off_probs, off_rounds = _classify(model, windows)
    (on_probs, on_rounds), _ = _traced(lambda: _classify(model, windows))
    assert torch.equal(off_probs, on_probs)
    assert len(off_rounds) == len(on_rounds) == 3
    for a, b in zip(off_rounds, on_rounds):
        assert a.hw == b.hw and torch.equal(a.rounds, b.rounds)
    gray = torch.from_numpy(windows[0, :, :32, :32]).float().mean(-1)
    off_flow = tvl1_mod.tvl1(gray[:-1], gray[1:], CFG.tvl1)
    on_flow, _ = _traced(lambda: tvl1_mod.tvl1(gray[:-1], gray[1:],
                                               CFG.tvl1))
    assert torch.equal(off_flow, on_flow)


# -- R(2+1)D streams on Farneback -------------------------------------------

CLIP_CFG = PipelineConfig(
    preprocess=PreprocessConfig(resize_short=72, crop=64),
    farneback=FarnebackConfig(levels=2, iterations=1, winsize=5),
    flow_algo="farneback", num_classes=5, window=5)
CLIP_STAGES = ("va/classify_batch", "va/crop", "va/spatial", "va/flow",
               "va/volume", "va/temporal", "va/fuse", "va/farneback.pyramid",
               "va/r2p1d.stem", "va/r2p1d.stage1", "va/r2p1d.stage2",
               "va/r2p1d.stage3", "va/r2p1d.stage4", "va/r2p1d.head")


@pytest.fixture(scope="module")
def clip_setup():
    torch.manual_seed(1)
    model = TwoStreamModel.create(num_classes=5, width=4, arch="r2plus1d_34",
                                  fusion_weights=(1.0, 1.0)).eval()
    rng = np.random.default_rng(4)
    base = rng.integers(0, 256, (2, 72, 80, 3)).astype(np.uint8)
    windows = torch.from_numpy(np.stack(
        [[np.roll(base[b], (t, 2 * t), axis=(0, 1)) for t in range(5)]
         for b in range(2)]))
    return model, windows


def test_every_clip_span_is_traced_and_nested(clip_setup):
    model, windows = clip_setup
    _, spans = _traced(lambda: pipeline.classify_batch(windows, model,
                                                       CLIP_CFG))
    by_name = {}
    for e in spans:
        by_name.setdefault(e.name, []).append(e)
    for name in CLIP_STAGES:
        assert name in by_name, (name, sorted(by_name))
    assert "va/stack" not in by_name
    batch = by_name["va/classify_batch"]
    assert len(batch) == 1
    for name in CLIP_STAGES[1:]:
        for e in by_name[name]:
            assert _inside(e, batch), name
    # Each stream's stem, stages and head once, inside its stream's span.
    streams = by_name["va/spatial"] + by_name["va/temporal"]
    for name in CLIP_STAGES[8:]:
        assert len(by_name[name]) == 2, name
        assert all(_inside(e, streams) for e in by_name[name]), name
        assert sum(_inside(e, by_name["va/spatial"])
                   for e in by_name[name]) == 1, name
    flow = by_name["va/flow"]
    assert _inside(by_name["va/farneback.pyramid"][0], flow)
    sizes = fb_mod._level_sizes(64, 64, CLIP_CFG.farneback)
    assert len(sizes) == 2
    levels = [e for e in spans if e.name.startswith("va/farneback.level.")]
    assert [e.name for e in levels] == [f"va/farneback.level.{h}x{w}"
                                        for h, w, _ in sizes]
    assert all(_inside(e, flow) for e in levels)
    assert all(by_name["va/farneback.pyramid"][0].time_range.end
               <= e.time_range.start for e in levels)


def test_clip_results_are_bit_identical_with_the_profiler_on_and_off(
        clip_setup):
    model, windows = clip_setup
    off = pipeline.classify_batch(windows, model, CLIP_CFG)
    on, _ = _traced(lambda: pipeline.classify_batch(windows, model,
                                                    CLIP_CFG))
    assert torch.equal(off, on)
    gray = windows[0, :, :64, :64].float().mean(-1)
    off_flow = fb_mod.farneback_sequence(gray, CLIP_CFG.farneback)
    on_flow, _ = _traced(lambda: fb_mod.farneback_sequence(
        gray, CLIP_CFG.farneback))
    assert torch.equal(off_flow, on_flow)


# -- TimeSformer streams on Farneback ----------------------------------------

TSF_SPANS = ("va/tsf.embed", "va/tsf.time", "va/tsf.space", "va/tsf.mlp",
             "va/tsf.head")
TSF_DEPTH = 2


@pytest.fixture(scope="module")
def tsf_setup(clip_setup):
    from video_analytics_tpu_torch.models.timesformer import TimeSformer

    torch.manual_seed(2)
    kw = dict(num_classes=5, width=32, depth=TSF_DEPTH, heads=4, mlp=64,
              frames=CLIP_CFG.window - 1, image_size=CLIP_CFG.preprocess.crop)
    model = TwoStreamModel(TimeSformer(**kw),
                           TimeSformer(in_channels=2, **kw), (1.0, 1.0))
    for stream in (model.spatial, model.temporal):
        stream.init(torch.Generator().manual_seed(3))
    return model.eval(), clip_setup[1]


def test_every_timesformer_span_is_traced_and_nested(tsf_setup):
    """The five ``va/tsf.*`` spans in each stream's span: the embedding
    and the head once a stream, the time, space and MLP spans once a
    block."""
    model, windows = tsf_setup
    _, spans = _traced(lambda: pipeline.classify_batch(windows, model,
                                                       CLIP_CFG))
    by_name = {}
    for e in spans:
        by_name.setdefault(e.name, []).append(e)
    spatial, temporal = by_name["va/spatial"], by_name["va/temporal"]
    assert len(spatial) == len(temporal) == 1
    for name in TSF_SPANS:
        per_stream = 1 if name in ("va/tsf.embed", "va/tsf.head") \
            else TSF_DEPTH
        assert len(by_name.get(name, [])) == 2 * per_stream, name
        assert sum(_inside(e, spatial) for e in by_name[name]) \
            == sum(_inside(e, temporal) for e in by_name[name]) \
            == per_stream, name
    assert not {"va/r2p1d.stem", "va/stack"} & set(by_name)


def test_timesformer_results_are_bit_identical_with_the_profiler_on_and_off(
        tsf_setup):
    model, windows = tsf_setup
    off = pipeline.classify_batch(windows, model, CLIP_CFG)
    on, _ = _traced(lambda: pipeline.classify_batch(windows, model,
                                                    CLIP_CFG))
    assert torch.equal(off, on)
