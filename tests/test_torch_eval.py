"""The port's UCF101 evaluation on the CPU (``--device cpu``), held against
the JAX package on the same files: the dataset readers, the synthetic
generator, threaded decode and the host resize, ``evaluate`` (Farneback,
and TV-L1 at ε = 0: with ε > 0 the reference's XLA solver stops a batch on
its slowest pair, the port each pair on its own), ``evaluate_batched``
against the port's ``evaluate``, the ``eval-ucf101`` and
``convert-weights`` commands against the JAX commands, and the runbook
``convert-weights`` → ``eval-ucf101 --batched`` on the port alone.  All at
small sizes (a crop of 56, windows of 6 frames, width 8)."""

import dataclasses
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from tests.fixtures import moving_square_frames
from video_analytics_tpu.cli.main import main as jax_main
from video_analytics_tpu_torch.cli.main import main
from video_analytics_tpu_torch.config import (
    FarnebackConfig, PipelineConfig, PreprocessConfig, TVL1Config)
from video_analytics_tpu_torch.io import dataset
from video_analytics_tpu_torch.io.video import synthesize_video
from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
from video_analytics_tpu_torch.runtime import evaluate as ev
from video_analytics_tpu_torch.runtime.checkpoint import (
    load_variables, save_variables)

torch.set_num_threads(1)

CPU = ["--device", "cpu"]
MODEL = ["--num-classes", "3", "--width", "8", "--flow-stack", "3",
         "--resize-short", "64", "--crop", "56", "--window", "6"]
ALGOS = {"farneback": ["--algo", "farneback", "--fb-levels", "0",
                       "--fb-iterations", "1"],
         "tvl1": ["--algo", "tvl1", "--tv-nscales", "2", "--tv-warps", "1",
                  "--tv-outer", "2", "--tv-inner", "3", "--tv-epsilon", "0"]}
PRE = PreprocessConfig(resize_short=64, crop=56, flow_stack=3)
CFGS = {"farneback": PipelineConfig(
            preprocess=PRE, window=6, num_classes=3, flow_algo="farneback",
            farneback=FarnebackConfig(levels=0, iterations=1)),
        "tvl1": PipelineConfig(
            preprocess=PRE, window=6, num_classes=3, flow_algo="tvl1",
            tvl1=TVL1Config(nscales=2, warps=1, outer_iterations=2,
                            inner_iterations=3, epsilon=0.0))}


def _jax_cfg(cfg: PipelineConfig):
    """The JAX package's config with the port config's values."""
    from video_analytics_tpu import config as jc
    return jc.PipelineConfig(**{
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)},
        "preprocess": jc.PreprocessConfig(
            **dataclasses.asdict(cfg.preprocess)),
        "farneback": jc.FarnebackConfig(**dataclasses.asdict(cfg.farneback)),
        "tvl1": jc.TVL1Config(**dataclasses.asdict(cfg.tvl1))})


def run_cli(capsys, fn, argv):
    capsys.readouterr()
    rc = fn(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1]) if out else None


def write_truncated(src: str, dst: str) -> str:
    """A corrupt clip: the first 256 bytes of a real one."""
    with open(src, "rb") as f:
        head = f.read(256)
    with open(dst, "wb") as f:
        f.write(head)
    return dst


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A checkpoint of a small two-stream model written by the port from a
    seed, BatchNorm statistics away from 0 and 1."""
    tm = TwoStreamModel.create(num_classes=3, flow_stack=3, width=8)
    tm.init(torch.Generator().manual_seed(21))
    g = torch.Generator().manual_seed(22)
    with torch.no_grad():
        for name, buf in tm.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0, 0.1, generator=g)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=g)
    path = str(tmp_path_factory.mktemp("eval_ckpt") / "two_stream.msgpack")
    save_variables(path, tm.flax_variables())
    return path


@pytest.fixture(scope="module")
def port_model(checkpoint):
    model = TwoStreamModel.create(num_classes=3, flow_stack=3, width=8)
    model.load_flax_variables(load_variables(checkpoint,
                                             model.flax_variables()))
    return model.eval()


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Five 20-frame clips whose square moves along three directions
    (labels 0, 1, 2, 0, 1), as tests/test_parallel.py builds them, at the
    synthetic UCF101's 96x128 (so the JAX package compiles one classify
    program for them and the commands' clips), and two of 120x160."""
    d = tmp_path_factory.mktemp("eval_clips")
    records = []
    for i in range(7):
        h, w = (96, 128) if i < 5 else (120, 160)
        p = str(d / f"c{i}.mp4")
        synthesize_video(p, moving_square_frames(
            20, h, w, step=(2 - i % 3, 1)), fps=10)
        records.append(dataset.ClipRecord(path=p, label=i % 3,
                                          class_name=str(i % 3)))
    return records


@pytest.fixture(scope="module")
def ucf(tmp_path_factory):
    """The synthetic UCF101 of tests/test_cli.py: 2 classes, 2 test clips
    of 14 frames at 96x128, built by the port."""
    from video_analytics_tpu_torch.io.synthetic import build_synthetic_ucf101
    root = str(tmp_path_factory.mktemp("ucf"))
    build_synthetic_ucf101(root, num_classes=2, clips_per_class=2,
                           num_frames=14, h=96, w=128)
    return root


# -- dataset files, synthetic dataset, decode and resize ----------------------

def test_dataset_readers_match_reference(tmp_path):
    from video_analytics_tpu.io import dataset as jax_dataset
    ann = tmp_path / "ann"
    ann.mkdir()
    (ann / "classInd.txt").write_text("1 Archery\n2 Biking\n\n3 YoYo\n")
    (ann / "trainlist02.txt").write_text(
        "Biking/v_Biking_g01_c01.avi 2\n\nYoYo/v_YoYo_g02_c03.avi 3\n")
    (ann / "testlist02.txt").write_text(
        "Archery/v_Archery_g03_c01.avi\nYoYo/v_YoYo_g04_c02.avi\n")
    ours = dataset.UCF101("/v", str(ann), split=2)
    ref = jax_dataset.UCF101("/v", str(ann), split=2)
    assert ours.class_index == ref.class_index
    assert ours.classes == ref.classes == ["Archery", "Biking", "YoYo"]
    for which in ("train_records", "test_records"):
        got = [dataclasses.astuple(r) for r in getattr(ours, which)()]
        want = [dataclasses.astuple(r) for r in getattr(ref, which)()]
        assert got == want and len(got) == 2
    assert ours.train_records()[1].label == 2
    assert ours.test_records()[0] == dataset.ClipRecord(
        "/v/Archery/v_Archery_g03_c01.avi", 0, "Archery")
    assert (dataset.read_split_list(str(ann / "testlist02.txt"), "/w",
                                    ours.class_index)
            == [dataset.ClipRecord(*dataclasses.astuple(r)) for r in
                jax_dataset.read_split_list(str(ann / "testlist02.txt"),
                                            "/w", ref.class_index)])

    # Resume: what one manifest recorded, a reopened one of either package
    # reads back; a key marked twice is written once.
    path = str(tmp_path / "sub" / "manifest.txt")
    m = dataset.ProgressManifest(path)
    for key in ("/a.avi", "/b.avi", "/a.avi"):
        m.mark_done(key)
    again, ref_m = dataset.ProgressManifest(path), \
        jax_dataset.ProgressManifest(path)
    assert len(again) == len(ref_m) == 2
    assert again.is_done("/b.avi") and ref_m.is_done("/b.avi")
    assert not again.is_done("/c.avi")
    with open(path) as f:
        assert f.read() == "/a.avi\n/b.avi\n"


def test_synthetic_dataset_matches_reference(tmp_path):
    from video_analytics_tpu.io.synthetic import (
        build_synthetic_ucf101 as jax_build)
    from video_analytics_tpu.io.video import VideoReader as JaxReader
    from video_analytics_tpu_torch.io.synthetic import build_synthetic_ucf101
    from video_analytics_tpu_torch.io.video import VideoReader
    kw = dict(num_classes=3, clips_per_class=2, num_frames=6, h=48, w=64,
              seed=3)
    ours = build_synthetic_ucf101(str(tmp_path / "ours"), **kw)
    ref = jax_build(str(tmp_path / "ref"), **kw)
    for name in ("classInd.txt", "trainlist01.txt", "testlist01.txt"):
        with open(os.path.join(ours.annotations_root, name)) as a, \
                open(os.path.join(ref.annotations_root, name)) as b:
            assert a.read() == b.read(), name
    rel = "Right/v_Right_g01_c01.avi"
    with VideoReader(os.path.join(ours.videos_root, rel)) as r:
        got = r.read_all()
    with JaxReader(os.path.join(ref.videos_root, rel)) as r:
        want = r.read_all()
    assert got.shape == (6, 48, 64, 3) and np.array_equal(got, want)
    assert [r.label for r in ours.test_records()] == [0, 1, 2]
    with pytest.raises(ValueError, match="num_classes"):
        build_synthetic_ucf101(str(tmp_path / "bad"), num_classes=9)


def test_prefetch_clips_each_path_once_failures_logged():
    """More workers than cores and a short switch interval: every good
    path comes out exactly once, every failing one lands in error_log."""
    from video_analytics_tpu_torch.ingest.prefetch import prefetch_clips
    paths = [f"clip{i}" for i in range(200)]

    def loader(p):
        if int(p[4:]) % 7 == 3:
            raise IOError(f"corrupt {p}")
        return np.full(3, int(p[4:]))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        errors, seen = [], []
        for p, arr, dt in prefetch_clips(paths, loader, num_workers=16,
                                         queue_depth=2, error_log=errors):
            assert arr[0] == int(p[4:]) and dt >= 0
            seen.append(p)
    finally:
        sys.setswitchinterval(interval)
    bad = [p for p in paths if int(p[4:]) % 7 == 3]
    assert sorted(seen) == sorted(set(paths) - set(bad))
    assert len(seen) == len(set(seen))
    assert sorted(p for p, _ in errors) == sorted(bad)
    assert all("corrupt" in e for _, e in errors)


def decode_threads():
    return [t for t in threading.enumerate() if "decode_worker" in t.name]


def test_prefetch_clips_stops_its_workers_when_the_consumer_stops():
    from video_analytics_tpu_torch.ingest.prefetch import prefetch_clips
    assert decode_threads() == []
    stream = prefetch_clips([str(i) for i in range(50)], lambda p: p,
                            num_workers=3, queue_depth=1)
    assert next(stream)[0] in {"0", "1", "2"}
    assert len(decode_threads()) >= 1
    stream.close()
    assert decode_threads() == []


@pytest.mark.parametrize("hw", [(50, 70), (70, 50), (30, 40)])
def test_host_resize_short_matches_reference(hw):
    from video_analytics_tpu.ingest.windows import (
        host_resize_short as jax_resize)
    from video_analytics_tpu_torch.ingest.windows import host_resize_short
    frames = np.random.default_rng(1).integers(
        0, 256, (3, *hw, 3)).astype(np.uint8)
    got, want = host_resize_short(frames, 32), jax_resize(frames, 32)
    assert got.shape == want.shape and np.array_equal(got, want)
    assert min(got.shape[1:3]) == min(32, min(hw))


# -- evaluate and evaluate_batched --------------------------------------------

@pytest.mark.parametrize("algo", ["farneback", "tvl1"])
def test_evaluate_matches_reference(tmp_path, clips, checkpoint, port_model,
                                    algo):
    """Five clips, three windows each: the same predictions file and the
    same counts as the JAX package's evaluate."""
    from video_analytics_tpu.cli.main import _load_two_stream as jax_load
    from video_analytics_tpu.io.dataset import ClipRecord as JaxRecord
    from video_analytics_tpu.runtime.evaluate import evaluate as jax_evaluate
    cfg = CFGS[algo]
    records = clips[:5]
    ours_p, ref_p = str(tmp_path / "ours.jsonl"), str(tmp_path / "ref.jsonl")
    ours = ev.evaluate(records, port_model, cfg, "cpu",
                       predictions_path=ours_p, num_windows=3)
    jax_model, variables = jax_load(checkpoint, 3, 3, width=8,
                                    input_hw=(56, 56))
    ref = jax_evaluate([JaxRecord(*dataclasses.astuple(r)) for r in records],
                       variables, jax_model,
                       _jax_cfg(cfg),
                       predictions_path=ref_p, num_windows=3)
    assert (ours.total, ours.correct, ours.failed) == \
        (ref.total, ref.correct, ref.failed) == (5, ref.correct, 0)
    with open(ours_p) as a, open(ref_p) as b:
        got, want = a.read(), b.read()
    assert got == want and len(got.splitlines()) == 5


def test_evaluate_batched_matches_evaluate(tmp_path, clips, port_model,
                                           monkeypatch):
    """A partial last batch (5 clips of one resolution in batches of 4: 4,
    then 1, not padded), a second resolution (its own group), a corrupt
    clip (contained and named), and the correct count summed from the 0-d
    tensors each batch leaves on the device."""
    cfg = CFGS["farneback"]
    bad = write_truncated(clips[0].path, str(tmp_path / "bad.mp4"))
    records = [*clips, dataset.ClipRecord(bad, 1, "1")]
    serial = ev.evaluate(records, port_model, cfg, "cpu", num_windows=3)
    assert (serial.total, serial.failed) == (7, 1)
    assert serial.failures[0][0] == bad

    calls = []
    real = ev.batch_clip_metrics

    def spy(windows, labels, valid, *a, **kw):
        correct, preds = real(windows, labels, valid, *a, **kw)
        calls.append((tuple(windows.shape), correct))
        return correct, preds

    monkeypatch.setattr(ev, "batch_clip_metrics", spy)
    batched = ev.evaluate_batched(records, port_model, cfg, "cpu",
                                  batch_clips=4, num_windows=3)
    assert (batched.total, batched.correct) == (serial.total, serial.correct)
    assert batched.failed == 1 and batched.failures[0][0] == bad
    assert "could not open" in batched.as_dict()["failures"][0]["error"]
    sizes = sorted((s[0], s[3:5]) for s, _ in calls)
    assert [n for n, _ in sizes] == [1, 2, 4]
    assert len({hw for _, hw in sizes}) == 2
    for _, c in calls:
        assert isinstance(c, torch.Tensor) and c.ndim == 0
        assert c.dtype == torch.int64
    assert sum(int(c) for _, c in calls) == batched.correct


def test_device_failures_propagate(clips, port_model, monkeypatch):
    """A failure of the classify work is not counted as a corrupt clip:
    both evaluation loops raise it, and the batched one leaves no decode
    thread behind."""
    def broken(*a, **kw):
        raise RuntimeError("CUDA launch failed: device-side fault")

    monkeypatch.setattr(ev, "classify_batch", broken)
    with pytest.raises(RuntimeError, match="device-side fault"):
        ev.evaluate(clips[:2], port_model, CFGS["farneback"], "cpu")
    with pytest.raises(RuntimeError, match="device-side fault"):
        ev.evaluate_batched(clips, port_model, CFGS["farneback"], "cpu",
                            batch_clips=2)
    assert decode_threads() == []


# -- the commands --------------------------------------------------------------

@pytest.mark.parametrize("algo", ["farneback", "tvl1"])
def test_eval_ucf101_matches_reference(tmp_path, ucf, checkpoint, capsys,
                                       algo):
    """The same output JSON and predictions file as the JAX command, clip
    by clip and --batched; a rerun on the same manifest skips every clip
    done."""
    args = ["eval-ucf101", "--videos", f"{ucf}/videos", "--annotations",
            f"{ucf}/annotations", *MODEL, *ALGOS[algo], "--checkpoint",
            checkpoint, "--windows", "3"]
    ours_p, ref_p = str(tmp_path / "ours.jsonl"), str(tmp_path / "ref.jsonl")
    manifest = str(tmp_path / "manifest.txt")
    rc, ours = run_cli(capsys, main, [*args, "--predictions", ours_p,
                                      "--manifest", manifest, *CPU])
    assert rc == 0
    rc, ref = run_cli(capsys, jax_main, [*args, "--predictions", ref_p])
    assert rc == 0 and ours == ref and ours["total"] == 2
    assert ours["failures"] == [] and ours["failed"] == 0
    with open(ours_p) as a, open(ref_p) as b:
        got, want = a.read(), b.read()
    assert got == want and len(got.splitlines()) == 2
    for line in got.splitlines():
        entry = json.loads(line)
        assert entry["path"].startswith(f"{ucf}/videos/")
        assert 0 <= entry["pred"] < 3
    assert json.loads(got.splitlines()[0])["label"] == 0

    rc, again = run_cli(capsys, main, [*args, "--predictions", ours_p,
                                       "--manifest", manifest, *CPU])
    assert rc == 0 and again["total"] == again["failed"] == 0
    with open(ours_p) as f:
        assert f.read() == got

    batched = ["--batched", "--batch-clips", "2"]
    rc, ours_b = run_cli(capsys, main, [*args, *batched, *CPU])
    assert rc == 0 and ours_b == ours
    if algo == "farneback":
        # The JAX command's batched program (TV-L1's costs ~10 s to compile
        # on this CPU) gives its sequential answer (tests/test_parallel.py).
        rc, ref_b = run_cli(capsys, jax_main, [*args, *batched])
        assert rc == 0 and ref_b == ours_b


def test_eval_ucf101_spynet_batched_matches_reference(tmp_path, ucf,
                                                     checkpoint, capsys):
    """--algo spynet --batched on the bundled SpyNet weights: the output
    JSON equals the JAX command's, and the port's clip-by-clip run's."""
    args = ["eval-ucf101", "--videos", f"{ucf}/videos", "--annotations",
            f"{ucf}/annotations", *MODEL, "--algo", "spynet",
            "--checkpoint", checkpoint, "--windows", "2", "--batched",
            "--batch-clips", "2"]
    rc, ours = run_cli(capsys, main, [*args, *CPU])
    assert rc == 0 and ours["total"] == 2 and ours["failed"] == 0
    rc, ref = run_cli(capsys, jax_main, args)
    assert rc == 0 and ref == ours
    rc, serial = run_cli(capsys, main, [a for a in args
                                        if a not in ("--batched",)] + CPU)
    assert rc == 0 and serial == ours


def test_eval_ucf101_refusals(ucf, capsys, monkeypatch):
    """A missing --spynet-checkpoint and missing annotations exit 1, and the
    default device is CUDA: without a card the command fails and never
    carries on on the CPU."""
    args = ["eval-ucf101", "--videos", f"{ucf}/videos", "--annotations",
            f"{ucf}/annotations", *MODEL]
    assert main([*args, "--algo", "spynet", "--spynet-checkpoint",
                 f"{ucf}/missing.msgpack", *CPU]) == 1
    assert main(["eval-ucf101", "--videos", f"{ucf}/videos",
                 "--annotations", f"{ucf}/missing", *MODEL, *CPU]) == 1
    capsys.readouterr()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--batched"]):
        with pytest.raises(RuntimeError, match="is_available"):
            main([*args, *extra])
    assert capsys.readouterr().out == ""


def test_convert_weights_matches_reference(tmp_path, capsys):
    """Every converted leaf of the port's file equals the JAX command's
    (atol 0); the classifier, not in the state_dict at this class count,
    is the only leaf left to each package's own init."""
    from tests.torch_resnet import random_torch_resnet18
    tm = random_torch_resnet18(seed=5)
    pth = str(tmp_path / "rn18.pth")
    torch.save(tm.state_dict(), pth)
    ours_f, ref_f = str(tmp_path / "ours.msgpack"), str(tmp_path /
                                                        "ref.msgpack")
    args = ["--num-classes", "11"]
    rc, ours = run_cli(capsys, main, ["convert-weights", pth, ours_f, *args])
    assert rc == 0
    rc, ref = run_cli(capsys, jax_main, ["convert-weights", pth, ref_f,
                                         *args])
    assert rc == 0
    assert {**ours, "out": None} == {**ref, "out": None}
    assert ours["spatial_leaves_converted"] == 100
    assert ours["temporal_leaves_converted"] == 100
    assert ours["fc_converted"] is False
    assert ours["fc_classes_in_state_dict"] == 1000
    got, want = load_variables(ours_f), load_variables(ref_f)

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        else:
            yield path, np.asarray(tree)

    flat_got, flat_want = dict(leaves(got)), dict(leaves(want))
    assert flat_got.keys() == flat_want.keys()
    compared = 0
    for path, a in flat_got.items():
        assert a.shape == flat_want[path].shape and a.dtype == np.float32
        if "fc" not in path:
            assert np.array_equal(a, flat_want[path]), path
            compared += 1
    assert compared == 200
    stem = flat_got[("temporal", "params", "conv1", "kernel")]
    rgb = flat_got[("spatial", "params", "conv1", "kernel")]
    assert stem.shape == (7, 7, 20, 64)
    assert np.array_equal(stem, np.repeat(rgb.mean(axis=2, keepdims=True),
                                          20, axis=2))
    with pytest.raises(KeyError):
        main(["convert-weights", pth, str(tmp_path / "x.msgpack"), "--arch",
              "resnet34"])
    with pytest.raises(ValueError, match="wrong --arch/--width"):
        main(["convert-weights", pth, str(tmp_path / "x.msgpack"),
              "--width", "32"])


def test_convert_weights_fc_and_wrappers(tmp_path, capsys):
    """At the state_dict's own class count the classifier converts too
    (transposed); a whole pickled model and a {"state_dict": ...} wrapper
    give the same file."""
    from tests.torch_resnet import random_torch_resnet18
    tm = random_torch_resnet18(seed=7)
    outs = []
    for name, obj in (("model.pth", tm),
                      ("wrapped.pth", {"state_dict": tm.state_dict()})):
        pth, out = str(tmp_path / name), str(tmp_path / (name + ".msgpack"))
        torch.save(obj, pth)
        rc, res = run_cli(capsys, main, ["convert-weights", pth, out,
                                         "--num-classes", "1000",
                                         "--flow-stack", "2"])
        assert rc == 0 and res["fc_converted"] is True
        assert res["spatial_leaves_converted"] == 102
        with open(out, "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1]
    fc = load_variables(str(tmp_path / "model.pth.msgpack"))["spatial"][
        "params"]["fc"]
    assert np.array_equal(fc["kernel"], tm.fc.weight.detach().numpy().T)
    assert np.array_equal(fc["bias"], tm.fc.bias.detach().numpy())


def test_runbook_convert_then_eval_batched(tmp_path, ucf, capsys):
    """The two commands for the day real weights and data arrive,
    `convert-weights` then `eval-ucf101 --batched`, on the port alone (as
    tests/test_cli.py wires them for the JAX package)."""
    from tests.torch_resnet import random_torch_resnet18
    pth = str(tmp_path / "rn18.pth")
    torch.save(random_torch_resnet18(seed=5).state_dict(), pth)
    ckpt = str(tmp_path / "two_stream.msgpack")
    rc, res = run_cli(capsys, main, ["convert-weights", pth, ckpt,
                                     "--num-classes", "2"])
    assert rc == 0 and res["spatial_leaves_converted"] == 100
    rc, out = run_cli(capsys, main, [
        "eval-ucf101", "--videos", f"{ucf}/videos",
        "--annotations", f"{ucf}/annotations", "--checkpoint", ckpt,
        "--num-classes", "2", "--algo", "farneback", "--batched",
        "--batch-clips", "2", "--crop", "56", "--resize-short", "64",
        "--window", "6", "--fb-levels", "0", "--fb-iterations", "1", *CPU])
    assert rc == 0
    assert out["total"] == 2 and out["failed"] == 0
    assert 0.0 <= out["top1"] <= 1.0
