"""The port's small modules against the JAX package on the same inputs.

- ``ingest/windows.window_starts`` / ``sliding_windows``: the four cases of
  ``tests/test_ingest.py`` run on both packages, and random
  ``(T, window, stride)`` equal to the reference's;
- ``runtime/metrics.MetricsWriter`` and ``utils/logging.MetricsWriter``:
  records equal to the reference writers' apart from ``ts``;
- ``ops/kernels.box_blur`` within 1e-6 of the reference's and of
  ``sepcorr`` with ``farneback_window_taps``' box taps;
- ``ops/preprocess.random_crop_flip`` exact given the reference's draws;
- ``io/video.open_video`` / ``iter_frames`` equal to the reference's;
- ``models/two_stream.top1``; ``models/resnet.init_resnet``'s tree shaped
  as the reference's;
- the four console entry points (``extract_frames_entry`` ...) through a
  subprocess, with the output of ``tpuva-torch <cmd>``.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_analytics_tpu import ingest as jax_ingest
from video_analytics_tpu.io import video as jax_video
from video_analytics_tpu.ops import kernels as jax_kernels
from video_analytics_tpu.ops.preprocess import (
    random_crop_flip as jax_random_crop_flip)
from video_analytics_tpu.runtime import metrics as jax_metrics
from video_analytics_tpu.utils import logging as jax_logging
from video_analytics_tpu_torch import ingest
from video_analytics_tpu_torch.cli.main import main
from video_analytics_tpu_torch.io import video
from video_analytics_tpu_torch.ops import kernels
from video_analytics_tpu_torch.ops import preprocess as pp
from video_analytics_tpu_torch.runtime import metrics
from video_analytics_tpu_torch.runtime.profiling import StageTimer
from video_analytics_tpu_torch.utils import logging as port_logging

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_BLUR = 1e-6         # box_blur, float32 on [0, 1) planes


# -- sliding windows ------------------------------------------------------------

PACKAGES = pytest.mark.parametrize("pkg", [jax_ingest, ingest],
                                   ids=["jax", "torch"])


@PACKAGES
def test_window_starts_cover_tail(pkg):
    starts = pkg.window_starts(100, 16, 8)
    assert starts[0] == 0 and starts[-1] == 84
    covered = set()
    for s in starts:
        covered.update(range(s, s + 16))
    assert covered == set(range(100))


@PACKAGES
def test_window_starts_short_clip(pkg):
    assert pkg.window_starts(5, 16, 8) == [0]


@PACKAGES
def test_sliding_windows_shapes(pkg):
    frames = np.arange(20 * 4 * 4 * 3).reshape(20, 4, 4, 3)
    wins = list(pkg.sliding_windows(frames, 16, 8))
    assert [w.shape for w in wins] == [(16, 4, 4, 3)] * 2
    np.testing.assert_array_equal(wins[1], frames[4:20])


@PACKAGES
def test_sliding_windows_pad_short(pkg):
    frames = np.arange(3 * 2 * 2 * 1).reshape(3, 2, 2, 1)
    wins = list(pkg.sliding_windows(frames, 8, 4))
    assert len(wins) == 1 and wins[0].shape == (8, 2, 2, 1)
    np.testing.assert_array_equal(wins[0][3:], np.repeat(frames[-1:], 5, 0))


def test_windows_match_reference_on_random_shapes(rng):
    for _ in range(200):
        t = int(rng.integers(1, 60))
        window = int(rng.integers(1, 20))
        stride = int(rng.integers(1, 20))
        assert ingest.window_starts(t, window, stride) == \
            jax_ingest.window_starts(t, window, stride), (t, window, stride)
        frames = rng.integers(0, 255, (t, 3, 2, 1)).astype(np.uint8)
        ours = list(ingest.sliding_windows(frames, window, stride))
        ref = list(jax_ingest.sliding_windows(frames, window, stride))
        assert len(ours) == len(ref) >= 1
        for a, b in zip(ours, ref):
            assert a.shape == (window, 3, 2, 1) and np.array_equal(a, b)


# -- the metrics sinks ----------------------------------------------------------

def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_runtime_metrics_writer_matches_reference(tmp_path):
    assert metrics.MetricsWriter().path == jax_metrics.MetricsWriter().path \
        == os.path.join(REPO, "bench", "results", "metrics.jsonl")
    timer = StageTimer()
    for name in ("decode", "flow", "decode"):
        with timer.stage(name):
            pass
    paths = {}
    for tag, mod in (("ours", metrics), ("ref", jax_metrics)):
        paths[tag] = str(tmp_path / tag / "m.jsonl")
        w = mod.MetricsWriter(paths[tag])
        rec = w.emit("fps", 12.5, "frames/s", algo="tvl1", windows=8)
        assert rec["ts"] == round(rec["ts"], 3)
        w.emit_stage_timings(timer.totals, run=3)
    ours, ref = _records(paths["ours"]), _records(paths["ref"])
    assert len(ours) == 3
    for a, b in zip(ours, ref):
        assert a.pop("ts") <= b.pop("ts") + 1.0
        assert a == b
    assert ours[1] == {"metric": "stage_decode", "unit": "s", "run": 3,
                       "value": timer.totals["decode"]}


def test_logging_metrics_writer_matches_reference(tmp_path):
    for path in (None, str(tmp_path / "sub" / "m.jsonl")):
        ours = port_logging.MetricsWriter(path)
        ref = jax_logging.MetricsWriter(path)
        recs = [(w.emit("loss", 0.25, "", extra={"step": 4}),
                 w.emit("acc", 1.0, "%"))
                for w in (ours, ref)]
        for a, b in zip(*recs):
            assert a.pop("ts") <= b.pop("ts") and a == b
    assert recs[0][0] == {"metric": "loss", "value": 0.25, "unit": "",
                          "step": 4}
    lines = _records(path)
    assert len(lines) == 4 and lines[0]["step"] == 4
    assert not os.path.exists(tmp_path / "None")


# -- ops ------------------------------------------------------------------------

@pytest.mark.parametrize("winsize", [1, 5, 15])
@pytest.mark.parametrize("border", ["edge", "reflect"])
def test_box_blur_matches_reference(winsize, border, rng):
    x = rng.random((2, 23, 31)).astype(np.float32)
    got = kernels.box_blur(torch.from_numpy(x), winsize, border).numpy()
    want = np.asarray(jax_kernels.box_blur(jnp.asarray(x), winsize, border))
    np.testing.assert_allclose(got, want, atol=TOL_BLUR, rtol=0)
    taps = np.asarray(kernels.farneback_window_taps(winsize, False),
                      np.float32)
    via_taps = kernels.sepcorr(torch.from_numpy(x), taps, taps, border)
    np.testing.assert_allclose(got, via_taps.numpy(), atol=TOL_BLUR, rtol=0)


def _jax_draw(key, h, w, crop, flip):
    """The reference's random_crop_flip draws from `key`."""
    k1, k2, k3 = jax.random.split(key, 3)
    top = int(jax.random.randint(k1, (), 0, h - crop + 1))
    left = int(jax.random.randint(k2, (), 0, w - crop + 1))
    do_flip = bool(jax.random.bernoulli(k3)) if flip else False
    return (torch.tensor([top]), torch.tensor([left]),
            torch.tensor([do_flip]))


@pytest.mark.parametrize("shape", [(20, 27, 3), (4, 20, 27, 3),
                                   (2, 3, 20, 27, 2)])
@pytest.mark.parametrize("flip", [True, False])
def test_random_crop_flip_matches_reference_given_its_draws(
        shape, flip, rng, monkeypatch):
    x = rng.integers(0, 255, shape).astype(np.uint8)
    flipped = 0
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        draw = _jax_draw(key, 20, 27, 16, flip)
        flipped += int(draw[2][0])
        monkeypatch.setattr(pp, "sample_crop_flip",
                            lambda *a, d=draw: d)
        got = pp.random_crop_flip(torch.from_numpy(x), 16, None, flip)
        want = np.asarray(jax_random_crop_flip(jnp.asarray(x), 16, key,
                                               flip=flip))
        assert got.shape == want.shape == (*shape[:-3], 16, 16, shape[-1])
        assert np.array_equal(got.numpy(), want)
    assert flipped > 0 or not flip


def test_random_crop_flip_draws_from_the_generator(rng):
    x = torch.from_numpy(rng.integers(0, 255, (5, 30, 40, 3)).astype(
        np.uint8))
    got = pp.random_crop_flip(x, 24, torch.Generator().manual_seed(3))
    draws = pp.sample_crop_flip(torch.Generator().manual_seed(3), 1, 30, 40,
                                24, True)
    assert torch.equal(got, pp.crop_flip(x[None], *draws, 24)[0])
    with pytest.raises(ValueError, match="cannot crop"):
        pp.random_crop_flip(x, 41, torch.Generator())


# -- io, models -------------------------------------------------------------------

@pytest.mark.parametrize("max_frames", [None, 5])
def test_iter_frames_matches_reference(tiny_clip, max_frames):
    ours = list(video.iter_frames(tiny_clip, max_frames))
    ref = list(jax_video.iter_frames(tiny_clip, max_frames))
    assert len(ours) == len(ref) == (max_frames or 12)
    assert all(np.array_equal(a, b) for a, b in zip(ours, ref))
    with video.open_video(tiny_clip) as r, \
            jax_video.open_video(tiny_clip) as jr:
        assert (r.size, r.frame_count) == (jr.size, jr.frame_count)
        assert np.array_equal(r.read_all(max_frames),
                              jr.read_all(max_frames))


def test_top1_matches_reference(rng):
    from video_analytics_tpu.models.two_stream import top1 as jax_top1
    from video_analytics_tpu_torch.models.two_stream import top1
    p = rng.random((7, 11)).astype(np.float32)
    assert np.array_equal(top1(torch.from_numpy(p)).numpy(),
                          np.asarray(jax_top1(jnp.asarray(p))))
    assert int(top1(torch.from_numpy(p[3]))) == int(jax_top1(p[3]))


def _shapes(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_shapes(tree[k], f"{path}/{k}"))
        return out
    return {path: tuple(np.shape(tree))}


@pytest.mark.parametrize("in_channels", [3, 6])
def test_init_resnet_tree_matches_reference(in_channels):
    from video_analytics_tpu.models import resnet as jax_resnet
    from video_analytics_tpu_torch.models import convert
    from video_analytics_tpu_torch.models import resnet
    ours = resnet.init_resnet(
        resnet.resnet18(num_classes=5, in_channels=in_channels, width=8),
        torch.Generator().manual_seed(0), (32, 32))
    ref = jax_resnet.init_resnet(
        jax_resnet.resnet18(num_classes=5, in_channels=in_channels, width=8),
        jax.random.PRNGKey(0), (32, 32))
    assert _shapes(ours) == _shapes(jax.tree_util.tree_map(np.asarray, ref))
    again = resnet.resnet18(num_classes=5, in_channels=in_channels, width=8)
    again.load_state_dict(convert.flax_to_torch(ours))
    assert np.array_equal(convert.torch_to_flax(again.state_dict())[
        "params"]["conv1"]["kernel"], ours["params"]["conv1"]["kernel"])


# -- the console entry points ---------------------------------------------------

ENTRY = "import sys; from video_analytics_tpu_torch.cli.main import {0}; {0}()"
SMALL = ["--num-classes", "5", "--width", "8", "--flow-stack", "2",
         "--resize-short", "40", "--crop", "32"]
FLOW = ["--algo", "farneback", "--fb-levels", "1", "--fb-iterations", "1"]


def test_entry_points_match_the_command(tmp_path, tiny_clip, capsys):
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
    from video_analytics_tpu_torch.runtime.checkpoint import save_variables
    ckpt = str(tmp_path / "two_stream.msgpack")
    save_variables(ckpt, TwoStreamModel.create(
        num_classes=5, flow_stack=2, width=8).init(
            torch.Generator().manual_seed(0)).flax_variables())
    frames = str(tmp_path / "frames")
    assert main(["extract-frames", tiny_clip, frames, "--max-frames",
                 "5"]) == 0
    capsys.readouterr()

    def argv(cmd, out):
        return {
            "extract-frames": [tiny_clip, out, "--max-frames", "4"],
            "compute-flow": [frames, out, *FLOW, "--device", "cpu"],
            "extract-features": [frames, out + ".npz", "--stream", "both",
                                 *SMALL, *FLOW, "--checkpoint", ckpt,
                                 "--device", "cpu"],
            "classify-clip": [tiny_clip, *SMALL, *FLOW, "--checkpoint", ckpt,
                              "--window", "4", "--device", "cpu"]}[cmd]

    entries = {"extract-frames": "extract_frames_entry",
               "compute-flow": "compute_flow_entry",
               "extract-features": "extract_features_entry",
               "classify-clip": "classify_clip_entry"}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    for cmd, fn in entries.items():
        rc = main([cmd, *argv(cmd, os.path.join(tmp_path, "main", fn))])
        want = capsys.readouterr().out.strip().splitlines()[-1]
        proc = subprocess.run(
            [sys.executable, "-c", ENTRY.format(fn),
             *argv(cmd, os.path.join(tmp_path, "entry", fn))], cwd=REPO,
            env=env, capture_output=True, text=True, timeout=240)
        assert proc.returncode == rc == 0, proc.stderr[-2000:]
        got = proc.stdout.strip().splitlines()[-1].replace(
            os.path.join(str(tmp_path), "entry", ""),
            os.path.join(str(tmp_path), "main", ""))
        assert got == want, (cmd, got, want)
