"""The R(2+1)D cell's files on the CPU: the plain reference against the
port, the frozen work count against ``tools/torch_roofline.py``'s, the new
files found by name, and the comparison behind ``correct`` (the program
passes it; a broken timed path and each control do not), at full widths
on small frames and the cell's own limits."""

import importlib.util
import json
import os
import shutil
import time

import pytest
import torch

from bench_h100 import (calibrate_clips, clips, faults, harness, program,
                        trace, weights_r2p1d, work, work_r2p1d)
from bench_h100 import run as runner
from bench_h100.reference import clip_pipeline as ref
from bench_h100.reference import r2plus1d as ref_net
from bench_h100.tests import tiny

CPU = torch.device("cpu")
CELL = "r2p1d34_fb_batch16"
CONFIG = "r2p1d34x2_farneback"
METRICS = ("cnn_device_ms.r2p1d", "flow_device_ms.r2p1d",
           "conv2plus1d_roofline", "farneback_roofline", "mfu_pct.r2p1d",
           "device_idle_pct.r2p1d")
SEED = 2**40 + 5


def tiny_config(width: int = 64, classes: int = 101) -> dict:
    """The cell's configuration on 9-frame windows of 32² crops."""
    cfg = harness.Spec().config(CONFIG)
    cfg["model"].update(width=width, num_classes=classes)
    cfg["preprocess"].update(resize_short=36, crop=32)
    cfg["window"] = 9
    cfg["flow"]["farneback"].update(levels=1, winsize=5, iterations=2)
    return cfg


def make_spec(tmp: str, width: int = 64, classes: int = 101
              ) -> harness.Spec:
    """A checkout under `tmp` whose only cell is the R(2+1)D cell on tiny
    traffic, with the real loops, metrics and the cell's limits."""
    bench = os.path.join(tmp, "bench")
    for sub in ("loops", "metrics", "limits"):
        shutil.copytree(os.path.join(harness.HERE, sub),
                        os.path.join(bench, sub))
    for sub in ("configs", "traffic"):
        os.makedirs(os.path.join(bench, sub))
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        data = json.load(f)
    path = os.path.join(bench, "configs", "tiny_r2p1d.json")
    with open(path, "w") as f:
        json.dump(tiny_config(width, classes), f)
    data["configs"] = [{"name": "tiny_r2p1d", "source": "test", "file": path,
                        "reduced": [], "why": "test"}]
    data["workloads"] = [{"name": CELL, "config": "tiny_r2p1d",
                          "traffic": "tiny_clips", "chips": 1, "why": "test"}]
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(data, f)
    with open(os.path.join(bench, "traffic", "tiny_clips.json"), "w") as f:
        # One distinct batch: every batch of a window, however short,
        # holds every checked window.
        json.dump({"loop": "clip_batch", "batch_clips": 2, "frames": 9,
                   "pool_clips": 2, "content": tiny.TINY_CONTENT}, f)
    return harness.Spec(root=tmp, bench=bench)


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return make_spec(str(tmp_path_factory.mktemp("r2p1d")))


def _run(spec, prog=program, seconds=0.5, trace_on=False):
    return runner.execute(runner.Run(spec, CELL, SEED, seconds, trace_on,
                                     CPU, prog, time.perf_counter()))


# -- the reference --------------------------------------------------------------

@pytest.mark.parametrize("in_channels", [3, 2])
def test_reference_equals_the_port_in_float32(in_channels):
    from video_analytics_tpu_torch.models.video_resnet import r2plus1d_34

    gen = torch.Generator().manual_seed(3)
    state = weights_r2p1d.make_stream(gen, CPU, in_channels, 11, 8)
    net = r2plus1d_34(num_classes=11, in_channels=in_channels, width=8)
    missing, unexpected = net.load_state_dict(state, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked")
                                  for k in missing)
    x = torch.randn((2, 8, 32, 32, in_channels), generator=gen)
    with torch.no_grad():
        got = net.eval()(x)
    want = ref_net.R2Plus1D34(state)(x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    fp8 = ref_net.R2Plus1D34(state, precision="fp8")(x)
    assert 0 < (fp8 - want).abs().max() < want.abs().max()


def test_reference_is_the_tests_reference():
    """``reference/r2plus1d.py`` is the copy of the port's test reference
    ``tests/torch_r2plus1d.py``: the same parameters and logits."""
    path = os.path.join(harness.ROOT, "tests", "torch_r2plus1d.py")
    spec = importlib.util.spec_from_file_location("torch_r2plus1d_copy", path)
    theirs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(theirs)
    assert theirs.parameter_shapes(3, 101) == ref_net.parameter_shapes(3, 101)
    state = weights_r2p1d.make_stream(torch.Generator().manual_seed(5), CPU,
                                      3, 5, 4)
    x = torch.randn((1, 4, 24, 24, 3), generator=torch.Generator()
                    .manual_seed(6))
    assert torch.equal(theirs.R2Plus1D34(state)(x),
                       ref_net.R2Plus1D34(state)(x))


def test_pipeline_equals_classify_batch_in_float32():
    cfg = tiny_config(width=8, classes=7)
    cfg["model"]["dtype"] = "float32"
    w = weights_r2p1d.make_weights(5, CPU, cfg["model"])
    wins = torch.stack(clips.make_clips(5, [9, 9], tiny.TINY_CONTENT,
                                        CPU)).numpy()
    model = program.build_model(cfg, w, CPU)
    assert model.clip_input
    x, pcfg = program.with_transport_crop(wins, program.pipeline_config(cfg))
    with torch.no_grad():
        got = program.classify_batch(torch.from_numpy(x), model, pcfg)
        want = ref.classify(torch.from_numpy(wins), cfg, w)
    assert ref.classify.last_flow.shape == (2, 8, 32, 32, 2)
    assert (got.log() - want.log()).abs().max() < 1e-4


# -- the work count ---------------------------------------------------------------

@pytest.fixture(scope="module")
def tool():
    path = os.path.join(harness.ROOT, "tools", "torch_roofline.py")
    spec = importlib.util.spec_from_file_location("torch_roofline_r2p1d",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_count_equals_the_tools(tool):
    s = harness.Spec()
    cfg = s.config(CONFIG)
    tr = s.traffic(s.cell(CELL)["traffic"])
    B, T, c = tr["batch_clips"], tr["frames"], cfg["preprocess"]["crop"]
    m = cfg["model"]
    total = work.Work()
    for ch in (3, 2):
        mine = work_r2p1d.conv2plus1d_work(B, T - 1, (c, c), ch,
                                           m["num_classes"], m["width"], 2,
                                           True)
        theirs = tool.r2plus1d_work(B, T - 1, c, ch, m["num_classes"],
                                    m["width"])
        assert (mine.bytes, mine.f32, mine.bf16) == (
            theirs.bytes, theirs.f32, theirs.bf16), ch
        total += mine
    assert work_r2p1d.cnn_work(cfg, B, T - 1) == total
    # 152.4 G multiply-adds a stream and a 32-frame clip (the RGB stream).
    one = work_r2p1d.conv2plus1d_work(1, 32, (112, 112), 3, 101, 64, 2, True)
    assert round(one.bf16 / 2 / 1e9, 1) == 152.4
    assert m["midplanes"] == sorted({ref_net.midplanes(a, b) for a, b in
                                     [(64, 64), (64, 128), (128, 128),
                                      (128, 256), (256, 256), (256, 512),
                                      (512, 512)]})
    assert m["stem_midplanes"] == ref_net.STEM_MIDPLANES
    whole = work_r2p1d.batch_work(cfg, B, T, (128, 171))
    assert whole.bf16 == total.bf16
    assert whole.f32 > work_r2p1d.flow_work(cfg, B, T).f32 > 0


# -- the cell's files, found by name --------------------------------------------

def test_the_new_files_are_found_by_name():
    s = harness.Spec()
    cell = s.cell(CELL)
    assert cell["config"] == CONFIG and cell["chips"] == 1
    cfg = s.config(CONFIG)
    assert cfg["model"]["arch"] == "r2plus1d_34"
    assert cfg["model"]["stage_sizes"] == [3, 4, 6, 3]
    tr = s.traffic(cell["traffic"])
    assert (tr["batch_clips"], tr["frames"], tr["pool_clips"]) == (16, 33, 64)
    assert (tr["content"]["height"], tr["content"]["width"]) == (128, 171)
    assert hasattr(s.loop(tr["loop"]), "run")
    assert set(s.limits(CELL)) == {"logp_gap", "flow_epe_px"}
    assert [m["name"] for m in s.per_layer(CELL)] == list(METRICS)
    assert {m["name"] for m in s.end_to_end(CELL)} == {"clips_per_s",
                                                       "setup_s"}
    for name in METRICS:
        assert callable(s.metric(name).read)
    pcfg = program.pipeline_config(cfg)
    assert (pcfg.window, pcfg.preprocess.crop, pcfg.fusion_weights) == (
        33, 112, (1.0, 1.0))


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
    """The float8 CNNs widen the log-probability gap, the bfloat16 flow
    the flow's endpoint error, each far beyond the program's."""
    number = {"cnn": "logp_gap", "flow": "flow_epe_px"}[lower]
    ctl = calibrate_clips.control_numbers(spec, CELL, SEED, CPU, lower)
    prog = _run(spec)["checks"][number]["value"]
    assert ctl[number] > 4 * prog and ctl[number] > 0, (ctl, prog)


def test_the_readers_take_a_traced_run_on_the_cpu(spec, monkeypatch):
    """Without device time the span and trace readers find nothing and
    leave their metrics out; the host clock's MFU is read."""
    monkeypatch.setattr(trace, "SLICE_S", 0.2)
    res = _run(spec, seconds=0.3, trace_on=True)
    assert res["correct"]
    assert set(res["metrics"]) == {"mfu_pct.r2p1d"}
    assert 0 < res["metrics"]["mfu_pct.r2p1d"]["value"] < 100
