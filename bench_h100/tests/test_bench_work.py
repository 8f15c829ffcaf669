"""The benchmark's frozen work count against tools/torch_roofline.py's
count today, at every cell's shapes, and the shares' refusal above
100 %."""

import importlib.util
import json
import os

import pytest
import torch
from video_analytics_tpu_torch.models.two_stream import TwoStreamModel

from bench_h100 import harness, program, work
from bench_h100.reference import tvl1 as ref_tvl1


@pytest.fixture(scope="module")
def tool():
    path = os.path.join(harness.ROOT, "tools", "torch_roofline.py")
    spec = importlib.util.spec_from_file_location("torch_roofline_tool", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def spec():
    return harness.Spec()


def _configs(spec):
    """Every configuration file of bench_h100/: those of the benchmark's
    cells and those kept for later cells (``r18x2_farneback``)."""
    folder = os.path.join(spec.bench, "configs")
    for f in sorted(os.listdir(folder)):
        with open(os.path.join(folder, f)) as fh:
            yield {"name": f[:-5]}, json.load(fh)


def _cells(spec):
    """Every configuration under every traffic mix of bench_h100/: the
    shapes of the benchmark's cells and of any others."""
    for c, cfg in _configs(spec):
        for mix in _mixes(spec):
            tr = spec.traffic(mix)
            seqs, src = tr["batch_clips"], (tr["content"]["height"],
                                            tr["content"]["width"])
            yield f"{c['name']}/{mix}", cfg, seqs, cfg["window"], src


def _mixes(spec):
    return sorted(f[:-5] for f in os.listdir(os.path.join(spec.bench,
                                                          "traffic")))


def test_peaks_equal_the_tools(tool):
    assert (work.BF16_FLOP_PER_S, work.F32_FLOP_PER_S,
            work.HBM_BYTES_PER_S) == (tool.BF16_FLOP_PER_S,
                                      tool.F32_FLOP_PER_S,
                                      tool.HBM_BYTES_PER_S)


def test_every_cells_count_equals_the_tools(tool, spec):
    n = 0
    for name, cfg, seqs, T, src in _cells(spec):
        pcfg = program.pipeline_config(cfg)
        with torch.device("meta"):
            model = TwoStreamModel.create(dtype=torch.bfloat16).eval()
        c = cfg["preprocess"]["crop"]
        stacks = seqs * (T - cfg["preprocess"]["flow_stack"])
        theirs_s = tool.cnn_work(model.spatial, torch.empty(
            (seqs * T, c, c, 3), device="meta"))
        theirs_t = tool.cnn_work(model.temporal, torch.empty(
            (stacks, c, c, 20), dtype=torch.bfloat16, device="meta"))
        mine_s, mine_t = work.model_cnn_work(cfg, seqs * T, stacks)
        assert (mine_s.bytes, mine_s.f32, mine_s.bf16) == (
            theirs_s.bytes, theirs_s.f32, theirs_s.bf16), name
        assert (mine_t.bytes, mine_t.bf16) == (theirs_t.bytes,
                                               theirs_t.bf16), name
        assert work.resize_crop_work(seqs * T, src, 256, c).f32 == \
            tool.resize_crop_work(seqs * T, src, 256, c).f32
        if cfg["flow"]["algo"] == "farneback":
            mine = work.two_stream_work(
                cfg, seqs, T, src,
                work.flow_work(cfg, seqs, T))
            theirs = tool.two_stream_work(model, pcfg, seqs, T, src, "meta",
                                          False)
            assert (mine.bytes, mine.f32, mine.bf16) == (
                theirs.bytes, theirs.f32, theirs.bf16), name
            n += 1
    farneback = [c for c, cfg in _configs(spec)
                 if cfg["flow"]["algo"] == "farneback"]
    assert farneback and n == len(farneback) * len(_mixes(spec))


def test_tvl1_count_at_fixed_rounds_equals_the_tools(tool, spec):
    cfg = spec.config("r18x2_tvl1")
    t = cfg["flow"]["tvl1"]
    levels = []
    for k, (h, w) in enumerate(reversed(ref_tvl1.level_sizes(224, 224, t))):
        rounds = (torch.arange(120 * 5) % (k + 3) + 1).reshape(120, 5)
        levels.append(ref_tvl1.LevelRounds((h, w), "warp", 0,
                                           rounds.int()))
    mine = work.tvl1_work(levels, t)
    theirs = tool.tvl1_work(levels, program.pipeline_config(cfg).tvl1)
    assert (mine.bytes, mine.f32) == (theirs.bytes, theirs.f32)
    assert mine.f32 > 0


def test_a_share_over_100_percent_raises():
    assert work.share("x", 1.0, 2.0) == 50.0
    with pytest.raises(RuntimeError, match="counted too high"):
        work.share("x", 2.0, 1.0)


def test_least_time_takes_the_roofs_in_turn():
    w = work.Work(bytes=0, f32=67e12, bf16=989e12)
    assert w.compute_seconds() == pytest.approx(2.0)
    assert work.Work(bytes=3.35e12 * 5).least_seconds() == pytest.approx(5.0)
