"""``tools/torch_eval_breakdown.py`` on the CPU: its ``ledger`` against the
arithmetic of ``tools/eval_breakdown.py`` written out here, ``breakdown``
on a small synthetic UCF101 (the sizes of tests/test_torch_eval.py) with
every key of the reference's JSON line, and ``main`` refusing to run
without a card when asked for one."""

import importlib.util
import math
import os
import re

import numpy as np
import pytest
import torch

from video_analytics_tpu_torch.config import (
    FarnebackConfig, PipelineConfig, PreprocessConfig)
from video_analytics_tpu_torch.ingest.windows import slice_crop_source
from video_analytics_tpu_torch.models.two_stream import TwoStreamModel

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(REPO, "tools", "eval_breakdown.py")


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_eval_breakdown",
        os.path.join(REPO, "tools", "torch_eval_breakdown.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


tool = _tool()


def reference_keys():
    """The keys of the reference's JSON line and of its ledger, in its
    order, read from its source."""
    with open(REFERENCE) as f:
        src = f.read()
    keys = list(dict.fromkeys(re.findall(r'res\["(\w+)"\] =', src)))
    literal = src[src.index("ledger = {"):src.index("accounted =")]
    ledger_keys = re.findall(r'"(\w+)":', literal) + list(
        dict.fromkeys(re.findall(r'ledger\["(\w+)"\] =', src)))
    return keys, ledger_keys


def reference_ledger(res):
    """tools/eval_breakdown.py:171-193, as written there (batches of 8
    clips, 2 decode workers)."""
    wall_clip = 1e3 / res["clips_per_sec_e2e"]
    ledger = {
        "wall_ms_per_clip": round(wall_clip, 2),
        "decode_per_clip_2workers": round(
            res["decode_ms_per_clip"] / 2, 2),
        "deviceput_per_clip": round(
            res["deviceput_ms_per_batch"] / 8, 2),
        "device_compute_per_clip": round(
            res["device_ms_per_batch_deep"] / 8, 2),
        "dispatch_rtt_per_clip": round(res["dispatch_rtt_ms"] / 8, 2),
        "hostprep_per_clip": round(
            res["hostprep_ms_per_batch"] / 8, 2),
    }
    accounted = sum(v for k, v in ledger.items()
                    if k != "wall_ms_per_clip"
                    and k != "decode_per_clip_2workers")
    consumer = accounted
    decode_eff = max(0.0, res["decode_ms_per_clip"] / 2 - consumer)
    ledger["decode_not_hidden"] = round(decode_eff, 2)
    ledger["unattributed"] = round(
        wall_clip - consumer - decode_eff, 2)
    return ledger


CASES = {
    # decode/2 = 6 ms a clip, under the consumer's 16.5: hidden.
    "decode_hidden": {"decode_ms_per_clip": 12.0,
                      "hostprep_ms_per_batch": 8.0,
                      "deviceput_ms_per_batch": 40.0,
                      "device_ms_per_batch_deep": 80.0,
                      "device_ms_per_batch_single": 84.0,
                      "dispatch_rtt_ms": 4.0, "clips_per_sec_e2e": 40.0},
    # decode/2 = 45.62 ms a clip, over the consumer's 4.2: 41.42 not hidden.
    "decode_not_hidden": {"decode_ms_per_clip": 91.234,
                          "hostprep_ms_per_batch": 3.917,
                          "deviceput_ms_per_batch": 6.131,
                          "device_ms_per_batch_deep": 21.77,
                          "device_ms_per_batch_single": 23.5,
                          "dispatch_rtt_ms": 1.73, "clips_per_sec_e2e": 17.3},
    # a launch-and-sync cost below 0 (single faster than deep), rounding
    # at every term.
    "negative_rtt": {"decode_ms_per_clip": 33.337,
                     "hostprep_ms_per_batch": 2.999,
                     "deviceput_ms_per_batch": 11.111,
                     "device_ms_per_batch_deep": 55.555,
                     "device_ms_per_batch_single": 55.5,
                     "dispatch_rtt_ms": -0.055, "clips_per_sec_e2e": 61.07},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ledger_is_the_reference_arithmetic(case):
    res = CASES[case]
    want = reference_ledger(res)
    got = tool.ledger(res, batch_clips=8, workers=2)
    assert got == want
    assert list(got) == reference_keys()[1]
    assert (got["decode_not_hidden"] == 0.0) == (case == "decode_hidden")


@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    """``breakdown`` on 4 test clips of 14 frames at 96x128 (2 classes),
    batches of 2, one timed pass; the sizes of tests/test_torch_eval.py."""
    from video_analytics_tpu_torch.io.synthetic import build_synthetic_ucf101
    root = str(tmp_path_factory.mktemp("breakdown_ucf"))
    records = build_synthetic_ucf101(
        root, num_classes=2, clips_per_class=2, num_frames=14, h=96, w=128,
        train_fraction=0.0).test_records()
    cfg = PipelineConfig(
        preprocess=PreprocessConfig(resize_short=64, crop=56, flow_stack=3),
        window=6, num_classes=3, flow_algo="farneback",
        farneback=FarnebackConfig(levels=0, iterations=1))
    model = TwoStreamModel.create(num_classes=3, flow_stack=3, width=8,
                                  dtype=torch.bfloat16)
    model.init(torch.Generator().manual_seed(0))
    reads = []
    res = tool.breakdown(records, model.eval(), cfg, "cpu", batch_clips=2,
                         passes=1, counters=(lambda: reads.append("zero"),
                                             lambda: len(reads)))
    return records, res


def test_breakdown_has_the_reference_keys(small_run):
    records, res = small_run
    keys, ledger_keys = reference_keys()
    assert len(records) == 4
    assert set(res) == set(keys) | {"launches_per_pass"}
    assert list(res["ledger"]) == ledger_keys
    for k in keys:
        if k not in ("e2e_passes", "ledger"):
            assert math.isfinite(res[k]), (k, res[k])
    assert all(math.isfinite(v) for v in res["ledger"].values())
    assert len(res["e2e_passes"]) == 1 and res["e2e_passes"][0] > 0
    # One timed pass, bracketed by the counters; a batch is 2 clips of 6
    # frames, each sliced to the source window of the resize and crop.
    assert res["launches_per_pass"] == [1]
    window = slice_crop_source(np.zeros((6, 96, 128, 3), np.uint8), 64,
                               56)[0]
    assert res["batch_mb"] == round(2 * window.nbytes / 2**20, 2)
    assert res["ledger"] == tool.ledger(res, 2, 2)


def test_breakdown_ledger_adds_up(small_run):
    _, res = small_run
    led = res["ledger"]
    parts = (led["deviceput_per_clip"] + led["device_compute_per_clip"]
             + led["dispatch_rtt_per_clip"] + led["hostprep_per_clip"]
             + led["decode_not_hidden"] + led["unattributed"])
    # Three terms are rounded to 0.01 apart: wall, decode_not_hidden and
    # unattributed.
    assert abs(led["wall_ms_per_clip"] - parts) <= 0.015 + 1e-9, led


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine without a GPU")
def test_main_needs_the_card_when_asked_for_it():
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main(["--device", "cuda"])
