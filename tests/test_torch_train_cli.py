"""The port's training command and what feeds it, on the CPU: the window
sampler against the JAX package's on the same files, the window cache,
failure containment, ``DevicePrefetcher`` (the CPU form: same thread and
queue, no stream), ``tpuva-torch train --device cpu`` with its checkpoint
read by both packages' ``classify-clip``, and a learning test: the
reference's 3-class moving-square task trained through the port's
``build_examples`` and steps reaches above-chance held-out accuracy."""

import json
import math
import os
import time

import numpy as np
import pytest
import torch

from tests.fixtures import moving_square_frames
from video_analytics_tpu_torch.cli.main import main
from video_analytics_tpu_torch.config import (
    FarnebackConfig, PipelineConfig, PreprocessConfig)
from video_analytics_tpu_torch.ingest.prefetch import DevicePrefetcher
from video_analytics_tpu_torch.ingest.train_loader import (
    DecodeWorkersExited, TrainWindowSampler)
from video_analytics_tpu_torch.io.dataset import ClipRecord
from video_analytics_tpu_torch.io.video import synthesize_video
from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
from video_analytics_tpu_torch.runtime import train_two_stream as tts
from video_analytics_tpu_torch.runtime.pipeline import classify_window

torch.set_num_threads(1)

MODEL = ["--num-classes", "3", "--flow-stack", "3", "--resize-short", "72",
         "--crop", "64", "--width", "8"]
FB = ["--fb-levels", "2", "--fb-iterations", "2", "--fb-winsize", "9"]


@pytest.fixture(scope="module")
def ucf(tmp_path_factory):
    """The port's synthetic UCF101: 3 classes x 2 training clips of 12
    frames at 60x80."""
    from video_analytics_tpu_torch.io.synthetic import build_synthetic_ucf101
    root = str(tmp_path_factory.mktemp("train_ucf"))
    ds = build_synthetic_ucf101(root, num_classes=3, clips_per_class=4,
                                num_frames=12, h=60, w=80)
    return ds


def _records(ucf, tmp_path):
    """The training records, a clip of another size (resized to the first
    clip's) and a corrupt one."""
    records = list(ucf.train_records())
    odd = str(tmp_path / "odd.mp4")
    synthesize_video(odd, moving_square_frames(9, 52, 70, size=12), fps=8)
    bad = str(tmp_path / "bad.avi")
    with open(bad, "wb") as f:
        f.write(b"junk")
    return records + [ClipRecord(odd, 1, "odd"), ClipRecord(bad, 0, "bad")]


def _take(sampler, n):
    it = sampler.batches()
    return [next(it) for _ in range(n)]


# -- (f) the window sampler -----------------------------------------------------

def test_sampler_matches_reference(ucf, tmp_path):
    """One worker and one seed: the reference's batches, windows and
    labels exactly, a corrupt clip counted and skipped in both."""
    from video_analytics_tpu.ingest.train_loader import (
        TrainWindowSampler as JaxSampler)
    from video_analytics_tpu.io.dataset import ClipRecord as JaxRecord
    records = _records(ucf, tmp_path)
    jax_records = [JaxRecord(r.path, r.label, r.class_name) for r in records]
    kw = dict(window=4, batch=3, seed=5, max_frames=10, num_workers=1,
              queue_depth=4)
    with TrainWindowSampler(records, **kw) as ours, \
            JaxSampler(jax_records, **kw) as theirs:
        got, want = _take(ours, 12), _take(theirs, 12)
    for (w, y), (w_ref, y_ref) in zip(got, want):
        assert w.dtype == np.uint8 and w.shape == (3, 4, 60, 80, 3)
        assert np.array_equal(w, w_ref) and np.array_equal(y, y_ref)
        assert y.dtype == np.int32
    assert ours.stats["windows"] == theirs.stats["windows"] == 36
    assert ours.stats["failures"] >= 1 and theirs.stats["failures"] >= 1


def test_sampler_cache_second_pass_decodes_nothing(ucf, tmp_path):
    records = list(ucf.train_records())
    cache = str(tmp_path / "cache")
    kw = dict(window=4, batch=3, seed=1, num_workers=2, cache_dir=cache)
    with TrainWindowSampler(records, **kw) as first:
        it = first.batches()
        for _ in range(20):                   # until every clip is cached
            next(it)
            names = [n for n in os.listdir(cache) if n.endswith(".npy")]
            if len(names) == len(records):
                break
    assert len(names) == len(records) and first.stats["decodes"] >= 6
    assert not [n for n in os.listdir(cache) if ".tmp" in n]
    with TrainWindowSampler(records, **kw) as second:
        batches = _take(second, 4)
    assert second.stats["decodes"] == 0 and second.stats["cache_hits"] >= 4
    assert batches[0][0].shape == (3, 4, 60, 80, 3)


def test_sampler_all_corrupt_raises(tmp_path):
    bad = []
    for i in range(2):
        p = str(tmp_path / f"bad{i}.mp4")
        with open(p, "wb") as f:
            f.write(b"junk")
        bad.append(ClipRecord(path=p, label=0, class_name="x"))
    with TrainWindowSampler(bad, window=4, batch=2, num_workers=2) as s:
        with pytest.raises(RuntimeError, match="decode workers"):
            next(s.batches())
        assert s.stats["failures"] >= 20
    assert not any(t.is_alive() for t in s._threads)
    with pytest.raises(ValueError):
        TrainWindowSampler([], window=4, batch=2)


# -- (g) DevicePrefetcher on the CPU --------------------------------------------

def test_prefetcher_order_stats_and_leaves():
    batches = [(np.full((4, 4), i, np.float32), {"i": i, "y": np.arange(i)},
                "meta", None) for i in range(12)]
    pf = DevicePrefetcher(batches, depth=3, device="cpu")
    out = list(pf)
    assert len(out) == 12 and pf.stats["batches"] == 12
    assert pf.stats["put_s"] >= 0
    for i, (x, d, s, n) in enumerate(out):
        assert isinstance(x, torch.Tensor) and torch.equal(
            x, torch.full((4, 4), float(i)))
        assert d["i"] == i and torch.equal(d["y"], torch.arange(i))
        assert s == "meta" and n is None


def test_prefetcher_stays_within_its_depth_and_closes():
    """A slow consumer: the worker runs at most `depth` batches ahead (plus
    the one it holds), and close() ends it."""
    pulled = []

    def gen():
        for i in range(100):
            pulled.append(i)
            yield np.full(2, i)

    depth = 2
    pf = DevicePrefetcher(gen(), depth=depth, device="cpu")
    it = iter(pf)
    first = next(it)
    time.sleep(0.5)
    assert int(first[0]) == 0 and len(pulled) <= depth + 2, pulled
    assert [int(next(it)[0]) for _ in range(3)] == [1, 2, 3]
    pf.close()
    assert not pf._thread.is_alive() and len(pulled) < 100
    with pytest.raises(ValueError):
        DevicePrefetcher([], depth=0, device="cpu")


def test_prefetcher_exception_reaches_consumer():
    def gen():
        yield np.zeros(3)
        yield np.ones(3)
        raise IOError("boom")

    pf = DevicePrefetcher(gen(), depth=2, device="cpu")
    got = []
    with pytest.raises(IOError, match="boom"):
        for x in pf:
            got.append(x)
    assert len(got) == 2 and not pf._thread.is_alive()


# -- (h) the train command ----------------------------------------------------

def _run(capsys, fn, argv):
    capsys.readouterr()
    rc = fn(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1]) if out else None


def test_train_command_writes_checkpoints_both_packages_read(ucf, tmp_path,
                                                             capsys):
    from video_analytics_tpu.cli.main import main as jax_main
    base = ["train", "--videos", ucf.videos_root, "--annotations",
            ucf.annotations_root, "--device", "cpu", "--batch", "2",
            "--max-frames", "10", "--log-every", "1", *MODEL]
    rgb = str(tmp_path / "rgb.msgpack")
    rc, res = _run(capsys, main, base + ["--out", rgb, "--stream", "rgb",
                                         "--steps", "2"])
    assert rc == 0 and os.path.exists(rgb)
    assert set(res) == {"steps", "checkpoint", "stream", "ingest",
                        "final_loss_rgb"}
    assert res["steps"] == 2 and res["checkpoint"] == rgb
    assert res["stream"] == "rgb" and math.isfinite(res["final_loss_rgb"])
    assert set(res["ingest"]) == {"decodes", "cache_hits", "windows",
                                  "failures"}
    assert res["ingest"]["windows"] >= 4

    flow = str(tmp_path / "flow.msgpack")
    assert base[-2:] == ["--width", "8"]
    rc, res = _run(capsys, main, base[:-2] + [
        "--width", "16", "--out", flow, "--stream", "flow", "--algo",
        "farneback", "--steps", "1", "--no-flip", *FB])
    assert rc == 0 and res["steps"] == 1 and res["stream"] == "flow"
    assert set(res) == {"steps", "checkpoint", "stream", "ingest",
                        "final_loss_flow"}
    assert math.isfinite(res["final_loss_flow"])

    # Both packages' classify-clip read the checkpoints and agree.
    clip = ucf.train_records()[0].path
    for ckpt, width in ((rgb, "8"), (flow, "16")):
        argv = ["classify-clip", clip, "--checkpoint", ckpt, *MODEL[:-2],
                "--width", width, "--window", "4", "--algo", "farneback",
                *FB]
        rc, ours = _run(capsys, main, argv + ["--device", "cpu"])
        assert rc == 0
        rc, theirs = _run(capsys, jax_main, argv)
        assert rc == 0 and ours["top1"] == theirs["top1"]
        for a, b in zip(ours["topk"], theirs["topk"]):
            assert a["class_id"] == b["class_id"]
            assert a["prob"] == pytest.approx(b["prob"], abs=1e-4)


def test_train_command_spynet(ucf, tmp_path, capsys):
    """train --algo spynet: the flow stream learns on the frozen bundled
    SpyNet's flow and the checkpoint classifies with SpyNet in both
    packages."""
    from video_analytics_tpu.cli.main import main as jax_main
    out = str(tmp_path / "spy.msgpack")
    rc, res = _run(capsys, main, [
        "train", "--videos", ucf.videos_root, "--annotations",
        ucf.annotations_root, "--device", "cpu", "--batch", "2",
        "--max-frames", "10", "--steps", "1", "--stream", "flow",
        "--algo", "spynet", "--out", out, *MODEL])
    assert rc == 0 and os.path.exists(out)
    assert res["steps"] == 1 and math.isfinite(res["final_loss_flow"])
    argv = ["classify-clip", ucf.train_records()[0].path, "--checkpoint",
            out, *MODEL, "--window", "4", "--algo", "spynet"]
    rc, ours = _run(capsys, main, argv + ["--device", "cpu"])
    assert rc == 0
    rc, theirs = _run(capsys, jax_main, argv)
    assert rc == 0
    for a, b in zip(ours["topk"], theirs["topk"]):
        assert a["class_id"] == b["class_id"]
        assert a["prob"] == pytest.approx(b["prob"], abs=1e-4)


def test_train_command_refusals(ucf, tmp_path, capsys):
    base = ["train", "--videos", ucf.videos_root, "--annotations",
            ucf.annotations_root, "--out", str(tmp_path / "x.msgpack"),
            "--steps", "1", *MODEL]
    capsys.readouterr()
    missing = str(tmp_path / "missing_spynet.msgpack")
    assert main(base + ["--algo", "spynet", "--spynet-checkpoint", missing,
                        "--device", "cpu"]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert missing in err[-1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            main(base + ["--device", "cuda"])
    assert not os.path.exists(str(tmp_path / "x.msgpack"))


def test_train_command_from_init_checkpoint(ucf, tmp_path, capsys):
    """--init-checkpoint: the weights start from the file; the stream
    that is not trained leaves unchanged."""
    from video_analytics_tpu_torch.runtime.checkpoint import (
        load_variables, save_variables)
    init = str(tmp_path / "init.msgpack")
    m = TwoStreamModel.create(num_classes=3, flow_stack=3, width=8)
    m.init(torch.Generator().manual_seed(9))
    save_variables(init, m.flax_variables())
    out = str(tmp_path / "out.msgpack")
    rc, res = _run(capsys, main, [
        "train", "--videos", ucf.videos_root, "--annotations",
        ucf.annotations_root, "--device", "cpu", "--batch", "2", "--steps",
        "1", "--stream", "rgb", "--init-checkpoint", init, "--out", out,
        *MODEL])
    assert rc == 0 and res["steps"] == 1
    before, after = load_variables(init), load_variables(out)
    t0 = before["temporal"]["params"]["conv1"]["kernel"]
    assert np.array_equal(t0, after["temporal"]["params"]["conv1"]["kernel"])
    s0 = before["spatial"]["params"]["conv1"]["kernel"]
    assert not np.array_equal(s0,
                              after["spatial"]["params"]["conv1"]["kernel"])


# -- (i) learning ------------------------------------------------------------

H, W, SQ = 48, 64, 12
STEPS = {0: (2, 0), 1: (0, 2), 2: (-2, 0)}          # right / down / left
CFG = PipelineConfig(
    preprocess=PreprocessConfig(resize_short=40, crop=32, flow_stack=5,
                                random_crop=True),
    farneback=FarnebackConfig(levels=2, iterations=2, winsize=9),
    flow_algo="farneback", window=6, num_classes=3)


def _clip(label: int, start, seed: int) -> np.ndarray:
    return np.stack(moving_square_frames(num=6, h=H, w=W,
                                         step=STEPS[label], size=SQ,
                                         start=start, seed=seed))


def _dataset(rng: np.random.Generator, per_class: int):
    clips, labels = [], []
    for label in range(3):
        for _ in range(per_class):
            start = (int(rng.integers(12, W - SQ - 12)),
                     int(rng.integers(12, H - SQ - 12)))
            clips.append(_clip(label, start, seed=int(rng.integers(1e6))))
            labels.append(label)
    return np.stack(clips), np.asarray(labels, np.int64)


def test_two_stream_learns_held_out_motion():
    """The reference's tests/test_two_stream_train.py through the port:
    the same data, config, 80 steps of 9 windows with the learning rate's
    cosine decay from 0.05, momentum 0.9; the fused classifier's held-out
    accuracy at least 0.66 (chance 0.33)."""
    rng = np.random.default_rng(7)
    train_x, train_y = _dataset(rng, per_class=8)
    model = TwoStreamModel.create(num_classes=3, flow_stack=5, width=16)
    model.init(torch.Generator().manual_seed(0))
    states = tts.create_two_stream_states(model, 0.05, "both")
    steps = tts.make_two_stream_train_steps(states)
    gen = torch.Generator().manual_seed(1)
    assert tts.train_window_len(CFG) == 6
    for it in range(80):
        lr = 0.05 * 0.5 * (1 + math.cos(math.pi * it / 80))
        for s in states.values():
            for group in s.optimizer.param_groups:
                group["lr"] = lr
        idx = rng.choice(len(train_x), size=9, replace=False)
        x = torch.from_numpy(train_x[idx])
        ex = tts.build_examples(x, CFG, "both", tts.draw_crops(gen, x, CFG))
        y = torch.from_numpy(train_y[idx])
        for name, step in steps.items():
            step(ex[name], y)
    model.eval()
    test_x, test_y = _dataset(np.random.default_rng(99), per_class=4)
    eval_cfg = PipelineConfig(
        preprocess=PreprocessConfig(resize_short=40, crop=32, flow_stack=5),
        farneback=CFG.farneback, flow_algo="farneback", window=6,
        num_classes=3)
    correct = sum(int(classify_window(torch.from_numpy(c), model,
                                      eval_cfg).argmax()) == y
                  for c, y in zip(test_x, test_y))
    acc = correct / len(test_y)
    assert acc >= 0.66, f"held-out fused accuracy {acc} (chance 0.33)"


# -- runtime/profiling --------------------------------------------------------

def test_stage_timer_and_trace(tmp_path):
    from video_analytics_tpu_torch.runtime.profiling import StageTimer, trace
    t = StageTimer()
    with t.stage("a"):
        sum(range(1000))
    with t.stage("a"):
        pass
    with t.stage("b", fence=torch.ones(4)):
        pass
    with t.stage("c", fence=torch.device("cpu")):
        pass
    rep = t.report()
    assert rep["a"]["count"] == 2 and rep["b"]["count"] == 1
    assert rep["a"]["total_s"] >= 0 and set(rep) == {"a", "b", "c"}
    with pytest.raises(KeyError):
        with t.stage("d"):
            raise KeyError("inside")
    assert t.report()["d"]["count"] == 1
    with trace(str(tmp_path / "tr")) as prof:
        torch.ones(64).sum()
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    assert prof.key_averages() is not None
