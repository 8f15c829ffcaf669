"""The TimeSformer cell's files on the CPU: the plain reference against
the port, the frozen work count against ``tools/torch_roofline.py``'s,
the new files found by name, and the comparison behind ``correct`` (the
program passes it; a broken timed path and each control do not), on the
cell's own frames (8 at 224²) at a small width and the cell's own
limits."""

import importlib.util
import json
import os
import shutil
import time

import pytest
import torch

from bench_h100 import (calibrate_tsf, clips, faults, harness, program,
                        trace, weights_tsf, work, work_tsf)
from bench_h100 import run as runner
from bench_h100.reference import timesformer as ref_net
from bench_h100.reference import tsf_pipeline as ref
from bench_h100.tests import tiny

CPU = torch.device("cpu")
CELL = "tsf8_fb_batch16"
CONFIG = "timesformer_b8x2_farneback"
METRICS = ("cnn_device_ms.tsf", "divided_attn_device_ms.tsf",
           "tsf_roofline", "divided_attn_roofline", "mfu_pct.tsf",
           "device_idle_pct.tsf", "launches.tsf")
SEED = 2**40 + 7
SMALL = {"num_classes": 11, "width": 64, "depth": 2, "heads": 4, "mlp": 256,
         "patch": 16, "clip": 3, "image_size": 32}


def tiny_config(width: int = 48, classes: int = 101) -> dict:
    """The cell's configuration at `width` (12 heads, MLP 4·width) on
    its own 9-frame windows of 224² crops, with a one-level Farneback."""
    cfg = harness.Spec().config(CONFIG)
    cfg["model"].update(width=width, mlp=4 * width, num_classes=classes)
    cfg["flow"]["farneback"].update(levels=1, winsize=5, iterations=2)
    return cfg


def make_spec(tmp: str) -> harness.Spec:
    """A checkout under `tmp` whose only cell is the TimeSformer cell on
    tiny traffic, with the real loops, metrics and the cell's limits."""
    bench = os.path.join(tmp, "bench")
    for sub in ("loops", "metrics", "limits"):
        shutil.copytree(os.path.join(harness.HERE, sub),
                        os.path.join(bench, sub))
    for sub in ("configs", "traffic"):
        os.makedirs(os.path.join(bench, sub))
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        data = json.load(f)
    path = os.path.join(bench, "configs", "tiny_tsf.json")
    with open(path, "w") as f:
        json.dump(tiny_config(), f)
    data["configs"] = [{"name": "tiny_tsf", "source": "test", "file": path,
                        "reduced": [], "why": "test"}]
    data["workloads"] = [{"name": CELL, "config": "tiny_tsf",
                          "traffic": "tiny_clips", "chips": 1, "why": "test"}]
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(data, f)
    with open(os.path.join(bench, "traffic", "tiny_clips.json"), "w") as f:
        # One distinct batch: every batch of a window, however short,
        # holds every checked window.
        json.dump({"loop": "tsf_batch", "batch_clips": 2, "frames": 9,
                   "pool_clips": 2, "content": tiny.TINY_CONTENT}, f)
    return harness.Spec(root=tmp, bench=bench)


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return make_spec(str(tmp_path_factory.mktemp("tsf")))


def _run(spec, prog=program, seconds=0.5, trace_on=False):
    return runner.execute(runner.Run(spec, CELL, SEED, seconds, trace_on,
                                     CPU, prog, time.perf_counter()))


# -- the reference --------------------------------------------------------------

@pytest.mark.parametrize("in_channels", [3, 2])
def test_reference_equals_the_port_in_float32(in_channels):
    from video_analytics_tpu_torch.models.timesformer import TimeSformer

    gen = torch.Generator().manual_seed(3)
    state = weights_tsf.make_stream(gen, CPU, in_channels, SMALL)
    net = TimeSformer(num_classes=11, in_channels=in_channels, width=64,
                      depth=2, heads=4, mlp=256, frames=3, image_size=32)
    net.load_state_dict(state)
    x = torch.randn((2, 3, 32, 32, in_channels), generator=gen)
    with torch.no_grad():
        got = net.eval()(x)
    want = ref_net.TimeSformer(state, heads=4)(x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    fp8 = ref_net.TimeSformer(state, heads=4, precision="fp8")(x)
    assert 0 < (fp8 - want).abs().max() < want.abs().max()


def test_reference_is_the_tests_reference():
    """``reference/timesformer.py`` is the copy of the port's test
    reference ``tests/torch_timesformer.py``: the same parameters and
    logits."""
    path = os.path.join(harness.ROOT, "tests", "torch_timesformer.py")
    spec = importlib.util.spec_from_file_location("torch_tsf_copy", path)
    theirs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(theirs)
    assert theirs.parameter_shapes(3, 101) == ref_net.parameter_shapes(3, 101)
    state = weights_tsf.make_stream(torch.Generator().manual_seed(5), CPU, 3,
                                    SMALL)
    x = torch.randn((1, 3, 32, 32, 3), generator=torch.Generator()
                    .manual_seed(6))
    assert torch.equal(theirs.TimeSformer(state, heads=4)(x),
                       ref_net.TimeSformer(state, heads=4)(x))


def test_weights_are_drawn_as_stated():
    cfg = harness.Spec().config(CONFIG)["model"]
    w = weights_tsf.make_weights(9, CPU, cfg)
    s, t = w["spatial"], w["temporal"]
    assert s["patch_embed.proj.weight"].shape == (768, 3, 16, 16)
    assert t["patch_embed.proj.weight"].shape == (768, 2, 16, 16)
    assert 0.018 < float(s["pos_embed"].std()) < 0.022
    qkv = s["blocks.3.attn.qkv.weight"]
    assert abs(float(qkv.std()) * 768 ** 0.5 - 1) < 0.01
    ln = s["blocks.0.norm2.weight"]
    assert 0.75 <= float(ln.min()) and float(ln.max()) <= 1.25
    bias = s["blocks.0.mlp.fc1.bias"]
    assert -0.1 <= float(bias.min()) and float(bias.max()) <= 0.1
    assert not torch.equal(s["head.weight"], t["head.weight"])


def test_pipeline_equals_classify_batch_in_float32():
    cfg = tiny_config(classes=7)
    cfg["model"]["dtype"] = "float32"
    w = weights_tsf.make_weights(5, CPU, cfg["model"])
    wins = torch.stack(clips.make_clips(5, [9, 9], tiny.TINY_CONTENT,
                                        CPU)).numpy()
    model = program.build_model(cfg, w, CPU)
    assert model.clip_input and model.spatial.width == 48
    x, pcfg = program.with_transport_crop(wins, program.pipeline_config(cfg))
    with torch.no_grad():
        got = program.classify_batch(torch.from_numpy(x), model, pcfg)
        want = ref.classify(torch.from_numpy(wins), cfg, w)
    assert ref.classify.last_flow.shape == (2, 8, 224, 224, 2)
    assert (got.log() - want.log()).abs().max() < 1e-4


# -- the work count ---------------------------------------------------------------

@pytest.fixture(scope="module")
def tool():
    path = os.path.join(harness.ROOT, "tools", "torch_roofline.py")
    spec = importlib.util.spec_from_file_location("torch_roofline_tsf", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_count_equals_the_tools(tool):
    s = harness.Spec()
    cfg = s.config(CONFIG)
    tr = s.traffic(s.cell(CELL)["traffic"])
    B, T, c = tr["batch_clips"], tr["frames"], cfg["preprocess"]["crop"]
    m = cfg["model"]
    for ch in (3, 2):
        mine = work_tsf.stream_ops(B, T - 1, (c, c), ch, m["num_classes"],
                                   m["width"], m["depth"], m["mlp"],
                                   m["patch"])
        theirs = tool.timesformer_ops(B, ch, m["num_classes"], m["width"])
        assert [(n, w.bytes, w.f32, w.bf16) for n, w in mine] == [
            (n, w.bytes, w.f32, w.bf16) for n, w in theirs], ch
    # 195.8 G and 195.5 G multiply-adds a clip, the RGB and flow streams.
    for ch, gmac in ((3, 195.8), (2, 195.5)):
        one = work_tsf.stream_ops(1, 8, (224, 224), ch, 101, 768, 12, 3072,
                                  16)
        assert round(work_tsf.total(one).bf16 / 2 / 1e9, 1) == gmac
    ops = work_tsf.cnn_ops(cfg, B, T - 1)
    halves = work_tsf.attn_ops(cfg, B, T - 1)
    assert len(ops) == 2 * (1 + 9 * 12 + 1) and len(halves) == 2 * 7 * 12
    assert 0 < work_tsf.least_seconds(halves) < work_tsf.least_seconds(ops)
    # The per-operation bound is at least the bound of the sums.
    assert work_tsf.least_seconds(ops) >= work_tsf.total(ops).least_seconds()
    whole = work_tsf.batch_work(cfg, B, T, (240, 320))
    assert whole.bf16 == work_tsf.total(ops).bf16
    assert whole.f32 > work_tsf.total(ops).f32 > 0
    with pytest.raises(RuntimeError, match="tsf_roofline"):
        work.share("tsf_roofline", work_tsf.least_seconds(ops),
                   0.5 * work_tsf.least_seconds(ops))


# -- the cell's files, found by name --------------------------------------------

def test_the_new_files_are_found_by_name():
    s = harness.Spec()
    cell = s.cell(CELL)
    assert cell["config"] == CONFIG and cell["chips"] == 1
    cfg = s.config(CONFIG)
    m = cfg["model"]
    assert m["arch"] == "timesformer_base" and cfg["reduced"] == []
    assert (m["width"], m["depth"], m["heads"], m["mlp"], m["patch"],
            m["clip"], m["image_size"]) == (768, 12, 12, 3072, 16, 8, 224)
    tr = s.traffic(cell["traffic"])
    assert (tr["batch_clips"], tr["frames"], tr["pool_clips"]) == (16, 9, 64)
    assert (tr["content"]["height"], tr["content"]["width"]) == (240, 320)
    assert hasattr(s.loop(tr["loop"]), "run")
    assert set(s.limits(CELL)) == {"logp_gap", "flow_epe_px"}
    assert [m["name"] for m in s.per_layer(CELL)] == list(METRICS)
    assert {m["name"] for m in s.end_to_end(CELL)} == {"clips_per_s",
                                                       "setup_s"}
    for name in METRICS:
        assert callable(s.metric(name).read)
    pcfg = program.pipeline_config(cfg)
    assert (pcfg.window, pcfg.preprocess.crop, pcfg.preprocess.resize_short,
            pcfg.fusion_weights) == (9, 224, 224, (1.0, 1.0))
    assert pcfg.preprocess.mean == (0.45,) * 3


# -- the comparison behind ``correct`` ------------------------------------------

def test_the_program_is_correct(spec):
    res = _run(spec)
    assert res["correct"], res["checks"]
    assert res["checks"]["answers_compared"]["value"] >= 1
    assert res["checks"]["flow_epe_px"]["value"] is not None
    assert set(res["metrics"]) == {"clips_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
def test_a_broken_timed_path_is_not_correct(spec, fault):
    res = _run(spec, faults.FAULTS[fault]())
    assert not res["correct"], res["checks"]
    assert res["checks"]["answers_compared"]["value"] >= 1
    assert res["checks"]["logp_gap"]["value"] > spec.limits(CELL)["logp_gap"]


@pytest.mark.parametrize("lower", ["cnn", "flow"])
def test_each_control_is_far_from_the_program(spec, lower):
    """The float8 products widen the log-probability gap, the bfloat16
    flow the flow's endpoint error, each far beyond the program's."""
    number = {"cnn": "logp_gap", "flow": "flow_epe_px"}[lower]
    ctl = calibrate_tsf.control_numbers(spec, CELL, SEED, CPU, lower)
    prog = _run(spec)["checks"][number]["value"]
    assert ctl[number] > 4 * prog and ctl[number] > 0, (ctl, prog)
    assert ctl["logit_sd_spatial"] > 0 and ctl["logit_sd_temporal"] > 0


def test_the_readers_take_a_traced_run_on_the_cpu(spec, monkeypatch):
    """Without device time the span and trace readers find nothing and
    leave their metrics out; the host clock's MFU is read."""
    monkeypatch.setattr(trace, "SLICE_S", 0.2)
    res = _run(spec, seconds=0.3, trace_on=True)
    assert res["correct"]
    assert set(res["metrics"]) == {"mfu_pct.tsf"}
    assert 0 < res["metrics"]["mfu_pct.tsf"]["value"] < 100
