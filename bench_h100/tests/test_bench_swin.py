"""The Video Swin cell's files on the CPU: the plain reference against
the port, the frozen work count, the new files found by name, and the
comparison behind ``correct`` (the program passes it; a broken timed
path and each control do not), on 9-frame windows of 224² crops (8
frames a clip: 4×7×7-token windows) at width 8 and the cell's own
limits."""

import importlib.util
import json
import os
import shutil
import time

import pytest
import torch

from bench_h100 import (calibrate_swin, clips, faults, harness, program,
                        trace, weights_swin, work, work_swin)
from bench_h100 import run as runner
from bench_h100.reference import swin_pipeline as ref
from bench_h100.reference import video_swin as ref_net
from bench_h100.tests import tiny

CPU = torch.device("cpu")
CELL = "swin_b32_fb_batch16"
CONFIG = "video_swin_b32x2_farneback"
METRICS = ("cnn_device_ms.swin", "window_attn_device_ms.swin",
           "swin_roofline", "window_attn_roofline", "mfu_pct.swin",
           "device_idle_pct.swin", "launches.swin")
SEED = 2**40 + 7
SMALL = {"num_classes": 11, "width": 16, "depths": (2, 2, 2, 2),
         "heads": (2, 2, 4, 4), "window": (2, 3, 3), "patch": (2, 4, 4),
         "mlp_ratio": 4}


def tiny_config(width: int = 8, classes: int = 101) -> dict:
    """The cell's configuration at `width` (published depths, heads and
    window) on 9-frame windows of 224² crops, with a one-level
    Farneback."""
    cfg = harness.Spec().config(CONFIG)
    cfg["model"].update(width=width, num_classes=classes)
    cfg["window"] = 9
    cfg["flow"]["farneback"].update(levels=1, winsize=5, iterations=2)
    return cfg


def make_spec(tmp: str) -> harness.Spec:
    """A checkout under `tmp` whose only cell is the Video Swin cell on
    tiny traffic, with the real loops, metrics and the cell's limits."""
    bench = os.path.join(tmp, "bench")
    for sub in ("loops", "metrics", "limits"):
        shutil.copytree(os.path.join(harness.HERE, sub),
                        os.path.join(bench, sub))
    for sub in ("configs", "traffic"):
        os.makedirs(os.path.join(bench, sub))
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        data = json.load(f)
    path = os.path.join(bench, "configs", "tiny_swin.json")
    with open(path, "w") as f:
        json.dump(tiny_config(), f)
    data["configs"] = [{"name": "tiny_swin", "source": "test", "file": path,
                        "reduced": [], "why": "test"}]
    data["workloads"] = [{"name": CELL, "config": "tiny_swin",
                          "traffic": "tiny_clips", "chips": 1, "why": "test"}]
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(data, f)
    with open(os.path.join(bench, "traffic", "tiny_clips.json"), "w") as f:
        # One distinct batch: every batch of a window, however short,
        # holds every checked window.
        json.dump({"loop": "swin_batch", "batch_clips": 2, "frames": 9,
                   "pool_clips": 2, "content": tiny.TINY_CONTENT}, f)
    return harness.Spec(root=tmp, bench=bench)


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return make_spec(str(tmp_path_factory.mktemp("swin")))


def _run(spec, prog=program, seconds=0.5, trace_on=False):
    return runner.execute(runner.Run(spec, CELL, SEED, seconds, trace_on,
                                     CPU, prog, time.perf_counter()))


# -- the reference ------------------------------------------------------------

@pytest.mark.parametrize("in_channels", [3, 2])
def test_reference_equals_the_port_in_float32(in_channels):
    from video_analytics_tpu_torch.models.video_swin import VideoSwin

    gen = torch.Generator().manual_seed(3)
    state = weights_swin.make_stream(gen, CPU, in_channels, SMALL)
    net = VideoSwin(in_channels=in_channels, **{
        k: v for k, v in SMALL.items() if k != "mlp_ratio"})
    net.load_state_dict(state)
    x = torch.randn((2, 8, 96, 96, in_channels), generator=gen)
    with torch.no_grad():
        got = net.eval()(x)
    want = ref_net.VideoSwin(state, window=(2, 3, 3))(x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    fp8 = ref_net.VideoSwin(state, window=(2, 3, 3), precision="fp8")(x)
    assert 0 < (fp8 - want).abs().max() < want.abs().max()


def test_reference_is_the_tests_reference():
    """``reference/video_swin.py`` is the copy of the port's test
    reference ``tests/torch_video_swin.py``: the same parameters and
    logits."""
    path = os.path.join(harness.ROOT, "tests", "torch_video_swin.py")
    spec = importlib.util.spec_from_file_location("torch_swin_copy", path)
    theirs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(theirs)
    assert theirs.parameter_shapes(3, 101) == ref_net.parameter_shapes(3, 101)
    state = weights_swin.make_stream(torch.Generator().manual_seed(5), CPU,
                                     3, SMALL)
    x = torch.randn((1, 8, 96, 96, 3), generator=torch.Generator()
                    .manual_seed(6))
    assert torch.equal(theirs.VideoSwin(state, window=(2, 3, 3))(x),
                       ref_net.VideoSwin(state, window=(2, 3, 3))(x))


def test_weights_are_drawn_as_stated():
    cfg = harness.Spec().config(CONFIG)["model"]
    w = weights_swin.make_weights(9, CPU, cfg)
    s, t = w["spatial"], w["temporal"]
    assert s["patch_embed.proj.weight"].shape == (128, 3, 2, 4, 4)
    assert t["patch_embed.proj.weight"].shape == (128, 2, 2, 4, 4)
    table = s["layers.2.blocks.5.attn.relative_position_bias_table"]
    assert table.shape == (2535, 16)
    assert abs(float(table.std()) - weights_swin.TABLE_SD) < 0.05
    qkv = s["layers.2.blocks.3.attn.qkv.weight"]
    assert abs(float(qkv.std()) * 512 ** 0.5 - 1) < 0.01
    ln = s["layers.0.blocks.0.norm2.weight"]
    assert 0.75 <= float(ln.min()) and float(ln.max()) <= 1.25
    bias = s["layers.0.blocks.0.mlp.fc1.bias"]
    assert -0.1 <= float(bias.min()) and float(bias.max()) <= 0.1
    assert "layers.0.downsample.reduction.bias" not in s
    assert not torch.equal(s["cls_head.fc_cls.weight"],
                           t["cls_head.fc_cls.weight"])


def test_pipeline_equals_classify_batch_in_float32():
    cfg = tiny_config(classes=7)
    cfg["model"]["dtype"] = "float32"
    w = weights_swin.make_weights(5, CPU, cfg["model"])
    wins = torch.stack(clips.make_clips(5, [9, 9], tiny.TINY_CONTENT,
                                        CPU)).numpy()
    model = program.build_model(cfg, w, CPU)
    assert model.clip_input and model.spatial.width == 8
    x, pcfg = program.with_transport_crop(wins, program.pipeline_config(cfg))
    with torch.no_grad():
        got = program.classify_batch(torch.from_numpy(x), model, pcfg)
        want = ref.classify(torch.from_numpy(wins), cfg, w)
    assert ref.classify.last_flow.shape == (2, 8, 224, 224, 2)
    assert (got.log() - want.log()).abs().max() < 1e-4


# -- the work count -----------------------------------------------------------

def test_the_count_holds_the_published_multiply_adds():
    """281.3 G multiply-adds a view of Swin-B at 400 classes, 39.0 G of
    them the attention products; a batch's count is both streams'."""
    s = harness.Spec()
    cfg = s.config(CONFIG)
    m = cfg["model"]
    one = work_swin.stream_ops(1, 32, (224, 224), 3, 400, m["width"],
                               m["depths"], m["heads"], m["window"],
                               m["patch"], m["mlp_ratio"])
    total = work_swin.total(one)
    assert round((total.bf16 + total.f32) / 2 / 1e9, 1) == 281.3
    attn = sum(w.bf16 for n, w in one if n == "attn.attn")
    assert round(attn / 2 / 1e9, 1) == 39.0
    ops = work_swin.cnn_ops(cfg, 16, 32)
    window = work_swin.attn_ops(cfg, 16, 32)
    assert len(ops) == 2 * (1 + 5 * 24 + 3 + 1)
    assert len(window) == 2 * 3 * 24
    assert 0 < work_swin.least_seconds(window) < work_swin.least_seconds(ops)
    assert work_swin.least_seconds(ops) >= work_swin.total(ops).least_seconds()
    whole = work_swin.batch_work(cfg, 16, 33, (240, 320))
    assert whole.bf16 == work_swin.total(ops).bf16
    with pytest.raises(RuntimeError, match="swin_roofline"):
        work.share("swin_roofline", work_swin.least_seconds(ops),
                   0.5 * work_swin.least_seconds(ops))


# -- the cell's files, found by name ------------------------------------------

def test_the_new_files_are_found_by_name():
    s = harness.Spec()
    cell = s.cell(CELL)
    assert cell["config"] == CONFIG and cell["chips"] == 1
    cfg = s.config(CONFIG)
    m = cfg["model"]
    assert m["arch"] == "swin3d_b" and cfg["reduced"] == []
    assert (m["width"], m["depths"], m["heads"], m["window"], m["shift"],
            m["patch"], m["mlp_ratio"], m["clip"], m["image_size"]) == (
        128, [2, 2, 18, 2], [4, 8, 16, 32], [8, 7, 7], [4, 3, 3],
        [2, 4, 4], 4, 32, 224)
    tr = s.traffic(cell["traffic"])
    assert (tr["batch_clips"], tr["frames"], tr["pool_clips"]) == (16, 33, 64)
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
            pcfg.fusion_weights) == (33, 224, 224, (1.0, 1.0))
    assert pcfg.preprocess.mean == (0.485, 0.456, 0.406)


# -- the comparison behind ``correct`` ----------------------------------------

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


@pytest.mark.parametrize("lower", ["cnn", "flow", "bias", "mask"])
def test_each_control_is_far_from_the_program(spec, lower):
    """The float8 products, the bias left out and the mask left out widen
    the log-probability gap, the bfloat16 flow the flow's endpoint error,
    each far beyond the program's."""
    number = "flow_epe_px" if lower == "flow" else "logp_gap"
    ctl = calibrate_swin.control_numbers(spec, CELL, SEED, CPU, lower)
    prog = _run(spec)["checks"][number]["value"]
    assert ctl[number] > 4 * prog and ctl[number] > 0, (ctl, prog)
    assert ctl["logit_sd_spatial"] > 0 and ctl["logit_sd_temporal"] > 0


def test_the_readers_take_a_traced_run_on_the_cpu(spec, monkeypatch):
    """Without device time the span and trace readers find nothing and
    leave their metrics out; the host clock's MFU is read."""
    monkeypatch.setattr(trace, "SLICE_S", 0.2)
    res = _run(spec, seconds=0.3, trace_on=True)
    assert res["correct"]
    assert set(res["metrics"]) == {"mfu_pct.swin"}
    assert 0 < res["metrics"]["mfu_pct.swin"]["value"] < 100
