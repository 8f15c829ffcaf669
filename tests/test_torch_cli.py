"""The port's command line on the CPU (``--device cpu``): extract-frames,
compute-flow, extract-features, classify-clip and serve, driven end to
end on a synthetic clip, in the pattern of tests/test_cli.py.
compute-flow is also held against the JAX package's command at the
native resolution (``--no-bucket`` in both; the default bucketing is
tests/test_torch_bucketing.py's): Farneback within 1e-4 end-point error,
as in tests/test_torch_farneback.py.  extract-features (frames
and stored flow) and classify-clip are held against the JAX package's
commands on the same clip and the same checkpoint file, with Farneback
and with TV-L1 at ε = 0 (with ε > 0 the reference's XLA solver stops a
batch on its slowest pair, the port each pair on its own)."""

import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from video_analytics_tpu.cli.main import main as jax_main
from video_analytics_tpu_torch.cli.main import main
from video_analytics_tpu_torch.io.flowio import read_flo

torch.set_num_threads(1)

CPU = ["--device", "cpu"]
TV_FAST = ["--tv-nscales", "2", "--tv-warps", "1", "--tv-outer", "2",
           "--tv-inner", "3"]


def run_cli(capsys, argv):
    rc = main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1]) if out else None


def test_extract_frames(tmp_path, tiny_clip, capsys):
    out_dir = str(tmp_path / "frames")
    rc, res = run_cli(capsys, ["extract-frames", tiny_clip, out_dir,
                               "--max-frames", "5"])
    assert rc == 0
    assert res["frames"] == 5 and res["height"] == 120 and res["width"] == 160
    files = sorted(os.listdir(out_dir))
    assert files[0] == "frame_000001.jpg" and len(files) == 5


def test_compute_flow_flo_matches_reference(tmp_path, tiny_clip, capsys):
    ours_dir, ref_dir = str(tmp_path / "ours"), str(tmp_path / "ref")
    args = ["--algo", "farneback", "--max-frames", "4", "--batch", "2",
            "--no-bucket"]
    rc, res = run_cli(capsys, ["compute-flow", tiny_clip, ours_dir, *args,
                               *CPU])
    assert rc == 0 and res == {"flows": 3, "algo": "farneback",
                               "format": "flo", "out_dir": ours_dir}
    assert jax_main(["compute-flow", tiny_clip, ref_dir, *args,
                     "--exact"]) == 0
    capsys.readouterr()
    for i in (1, 2, 3):
        ours = read_flo(os.path.join(ours_dir, f"flow_{i:06d}.flo"))
        ref = read_flo(os.path.join(ref_dir, f"flow_{i:06d}.flo"))
        assert ours.shape == (120, 160, 2)
        # On the square's flat background the solve rests on its
        # regulariser; compare where the flow is defined, and bound the
        # rest loosely.
        sq = (slice(12, 30), slice(12, 30))
        assert np.linalg.norm(ours[sq] - ref[sq], axis=-1).max() < 1e-4
        assert np.abs(ours - ref).max() < 1e-2
    # The square moves (2, 1) px per frame.
    sq = read_flo(os.path.join(ours_dir, "flow_000001.flo"))[12:30, 12:30]
    assert abs(np.median(sq[..., 0]) - 2.0) < 0.6
    assert abs(np.median(sq[..., 1]) - 1.0) < 0.6


@pytest.mark.parametrize("algo,extra", [("farneback", []),
                                        ("tvl1", TV_FAST)])
def test_compute_flow_jpg_quantized(tmp_path, tiny_clip, capsys, algo, extra):
    out_dir = str(tmp_path / "flowq")
    rc, res = run_cli(capsys, [
        "compute-flow", tiny_clip, out_dir, "--algo", algo, "--format",
        "jpg", "--max-frames", "3", *extra, *CPU])
    assert rc == 0 and res["flows"] == 2 and res["algo"] == algo
    assert os.path.exists(os.path.join(out_dir, "flow_x_000001.jpg"))
    assert os.path.exists(os.path.join(out_dir, "flow_y_000002.jpg"))


def test_compute_flow_viz_from_frames_dir(tmp_path, tiny_clip, capsys):
    """--format viz renders HSV colour-wheel PNGs; the moving square must
    stand out from the static background.  The source is a frames
    directory written by extract-frames."""
    import cv2
    frames_dir, out_dir = str(tmp_path / "frames"), str(tmp_path / "viz")
    assert main(["extract-frames", tiny_clip, frames_dir,
                 "--max-frames", "3"]) == 0
    capsys.readouterr()
    rc, res = run_cli(capsys, [
        "compute-flow", frames_dir, out_dir, "--algo", "farneback",
        "--format", "viz", "--bound", "4", *CPU])
    assert rc == 0 and res["flows"] == 2
    img = cv2.imread(os.path.join(out_dir, "flow_viz_000001.png"))
    assert img is not None and img.shape == (120, 160, 3)
    sq = img[12:30, 12:30].astype(np.float32)
    bg = img[60:100, 80:140].astype(np.float32)
    assert sq.max(axis=-1).mean() > bg.max(axis=-1).mean() + 50


def test_compute_flow_spynet_matches_reference(tmp_path, tiny_clip, capsys):
    """--algo spynet at the native resolution (``--no-bucket`` in both
    commands: the default pads to multiples of 64, which moves SpyNet's
    border pixels), on the bundled weights and on a --spynet-checkpoint
    file: .flo files within 1e-4 px."""
    from video_analytics_tpu_torch.models.spynet import (
        default_spynet_checkpoint)
    for extra in ([], ["--spynet-checkpoint", default_spynet_checkpoint()]):
        ours_dir = str(tmp_path / f"ours{len(extra)}")
        ref_dir = str(tmp_path / f"ref{len(extra)}")
        args = ["--algo", "spynet", "--max-frames", "4", "--batch", "2",
                "--no-bucket", *extra]
        rc, res = run_cli(capsys, ["compute-flow", tiny_clip, ours_dir,
                                   *args, *CPU])
        assert rc == 0 and res == {"flows": 3, "algo": "spynet",
                                   "format": "flo", "out_dir": ours_dir}
        assert jax_main(["compute-flow", tiny_clip, ref_dir, *args]) == 0
        capsys.readouterr()
        for i in (1, 2, 3):
            ours = read_flo(os.path.join(ours_dir, f"flow_{i:06d}.flo"))
            ref = read_flo(os.path.join(ref_dir, f"flow_{i:06d}.flo"))
            assert ours.shape == (120, 160, 2)
            np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
    # The square moves (2, 1) px a frame: SpyNet sees it.
    assert np.abs(ours[15:30, 15:30]).max() > 0.5


def test_compute_flow_errors(tmp_path, tiny_clip, capsys, monkeypatch):
    """< 2 frames exit 2; a missing file (clip or --spynet-checkpoint)
    exits 1; the default device is CUDA and fails without a card."""
    out = str(tmp_path / "x")
    assert main(["compute-flow", tiny_clip, out, "--max-frames", "1",
                 *CPU]) == 2
    assert main(["compute-flow", tiny_clip, out, "--algo", "spynet",
                 "--spynet-checkpoint", str(tmp_path / "missing.msgpack"),
                 *CPU]) == 1
    assert main(["compute-flow", str(tmp_path / "missing.mp4"), out,
                 *CPU]) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        main(["compute-flow", tiny_clip, out, "--algo", "farneback"])


def test_compute_flow_cv2_param_surface(tmp_path, tiny_clip, capsys):
    """The --fb-* flags reach the algorithm.  The reference's --exact and
    --no-bucket are accepted (what they write is
    tests/test_torch_bucketing.py's)."""
    d1, d2, d3 = (str(tmp_path / n) for n in ("a", "b", "c"))
    base = ["--algo", "farneback", "--max-frames", "3", "--batch", "2", *CPU]
    rc1, _ = run_cli(capsys, ["compute-flow", tiny_clip, d1, *base])
    rc2, res = run_cli(capsys, [
        "compute-flow", tiny_clip, d2, *base, "--fb-winsize", "9",
        "--fb-gaussian", "--fb-iterations", "2"])
    assert rc1 == 0 and rc2 == 0 and res["flows"] == 2
    a, b = (read_flo(os.path.join(d, "flow_000001.flo")) for d in (d1, d2))
    assert np.abs(a - b).max() > 1e-6
    for flag in ("--exact", "--no-bucket"):
        rc, res = run_cli(capsys, ["compute-flow", tiny_clip, d3, *base,
                                   flag])
        assert rc == 0 and res["flows"] == 2


def test_serve_farneback_on_cpu(monkeypatch, capsys, tiny_clip, tmp_path):
    """serve with Farneback answers a request and names the classes from
    a classInd.txt read by the port's own reader (held to the JAX
    package's)."""
    from video_analytics_tpu.io.dataset import read_class_index as jax_read
    from video_analytics_tpu_torch.io.dataset import read_class_index
    names = ["Archery", "Biking", "Diving", "Rowing", "YoYo"]
    class_index = tmp_path / "classInd.txt"
    class_index.write_text("".join(f"{i + 1} {n}\n\n"
                                   for i, n in enumerate(names)))
    assert read_class_index(str(class_index)) == jax_read(str(class_index))
    stdin = io.StringIO(json.dumps({"path": tiny_clip, "id": 1}) + "\n"
                        + json.dumps({"cmd": "shutdown"}) + "\n")
    monkeypatch.setattr(sys, "stdin", stdin)
    rc = main(["serve", "--algo", "farneback", "--warmup", "--topk", "2",
               "--num-classes", "5", "--resize-short", "72", "--crop", "64",
               "--flow-stack", "3", "--window", "4", "--width", "8",
               "--fb-levels", "1", "--class-index", str(class_index), *CPU])
    assert rc == 0
    lines = [json.loads(ln)
             for ln in capsys.readouterr().out.strip().splitlines()]
    assert lines[0]["ready"] is True
    assert lines[1]["id"] == 1 and 0 <= lines[1]["top1"] < 5
    assert len(lines[1]["topk"]) == 2
    for entry in lines[1]["topk"]:
        assert entry["class_name"] == names[entry["class_id"]]
    assert lines[2]["ok"] is True


# -- the stage chain: extract-features and classify-clip ----------------------

MODEL = ["--num-classes", "5", "--width", "8", "--flow-stack", "3",
         "--resize-short", "72", "--crop", "64"]
ALGOS = {"farneback": ["--algo", "farneback", "--fb-levels", "1",
                       "--fb-iterations", "1"],
         "tvl1": ["--algo", "tvl1", *TV_FAST, "--tv-epsilon", "0"],
         "spynet": ["--algo", "spynet"]}     # the bundled weights
TOL_FEATURES = 2e-4      # features and logits, as tests/test_torch_models.py
TOL_PROBS = 1e-4         # fused probabilities, as classify_window there


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A checkpoint of a small two-stream model, written by the port from
    a seed, with BatchNorm statistics away from their initial 0 and 1."""
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
    from video_analytics_tpu_torch.runtime.checkpoint import save_variables
    tm = TwoStreamModel.create(num_classes=5, flow_stack=3, width=8)
    tm.init(torch.Generator().manual_seed(11))
    g = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for name, buf in tm.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0, 0.1, generator=g)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=g)
    path = str(tmp_path_factory.mktemp("ckpt") / "two_stream.msgpack")
    save_variables(path, tm.flax_variables())
    return path


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory, tiny_clip):
    out = str(tmp_path_factory.mktemp("stage") / "frames")
    assert main(["extract-frames", tiny_clip, out, "--max-frames", "6"]) == 0
    return out


def run_jax_cli(capsys, argv):
    capsys.readouterr()
    rc = jax_main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1]) if out else None


@pytest.mark.parametrize("algo", ["farneback", "tvl1", "spynet"])
def test_extract_features_from_frames_matches_reference(
        tmp_path, frames_dir, checkpoint, capsys, algo):
    ours_npz, ref_npz = str(tmp_path / "ours.npz"), str(tmp_path / "ref.npz")
    args = ["--stream", "both", *MODEL, *ALGOS[algo], "--checkpoint",
            checkpoint]
    rc, res = run_cli(capsys, ["extract-features", frames_dir, ours_npz,
                               *args, *CPU])
    assert rc == 0
    assert res == {"rgb": [6, 64], "flow": [3, 64], "out": ours_npz}
    rc, ref_res = run_jax_cli(capsys, ["extract-features", frames_dir,
                                       ref_npz, *args])
    assert rc == 0 and ref_res == {**res, "out": ref_npz}
    ours, ref = np.load(ours_npz), np.load(ref_npz)
    for stream in ("rgb", "flow"):
        assert np.isfinite(ours[stream]).all()
        np.testing.assert_allclose(ours[stream], ref[stream],
                                   rtol=TOL_FEATURES, atol=TOL_FEATURES)


@pytest.mark.parametrize("fmt", ["flo", "jpg"])
def test_extract_features_from_flow_dir_matches_reference(
        tmp_path, frames_dir, checkpoint, capsys, fmt):
    """compute-flow's output directory is extract-features' input: the
    stored flow is resized to the model's crop with its values rescaled
    per axis, as in the reference."""
    flow_dir = str(tmp_path / "flow")
    rc, _ = run_cli(capsys, ["compute-flow", frames_dir, flow_dir, "--algo",
                             "farneback", "--format", fmt, *CPU])
    assert rc == 0
    ours_npz, ref_npz = str(tmp_path / "ours.npz"), str(tmp_path / "ref.npz")
    args = ["--stream", "flow", *MODEL, "--checkpoint", checkpoint]
    rc, res = run_cli(capsys, ["extract-features", flow_dir, ours_npz, *args,
                               *CPU])
    assert rc == 0
    assert res == {"flow": [3, 64], "out": ours_npz, "source": "flow_dir"}
    rc, ref_res = run_jax_cli(capsys, ["extract-features", flow_dir, ref_npz,
                                       *args])
    assert rc == 0 and ref_res == {**res, "out": ref_npz}
    ours, ref = np.load(ours_npz)["flow"], np.load(ref_npz)["flow"]
    assert np.abs(ours).max() > 1e-3
    np.testing.assert_allclose(ours, ref, rtol=TOL_FEATURES,
                               atol=TOL_FEATURES)
    # --max-frames caps the stored flows that are read.
    rc, res = run_cli(capsys, ["extract-features", flow_dir, ours_npz, *args,
                               "--max-frames", "4", *CPU])
    assert rc == 0 and res["flow"] == [2, 64]


@pytest.mark.parametrize("algo", ["farneback", "tvl1", "spynet"])
def test_classify_clip_matches_reference(tmp_path, tiny_clip, checkpoint,
                                         capsys, algo):
    args = [*MODEL, *ALGOS[algo], "--checkpoint", checkpoint, "--window", "4",
            "--windows", "2", "--topk", "5"]
    rc, res = run_cli(capsys, ["classify-clip", tiny_clip, *args, *CPU])
    assert rc == 0 and res["video"] == tiny_clip
    rc, ref = run_jax_cli(capsys, ["classify-clip", tiny_clip, *args])
    assert rc == 0
    ours_p = {e["class_id"]: e["prob"] for e in res["topk"]}
    ref_p = {e["class_id"]: e["prob"] for e in ref["topk"]}
    assert sorted(ours_p) == sorted(ref_p) == list(range(5))
    assert abs(sum(ours_p.values()) - 1.0) < 1e-5
    for i in range(5):
        assert abs(ours_p[i] - ref_p[i]) <= TOL_PROBS, (i, ours_p, ref_p)
    probs = [e["prob"] for e in res["topk"]]
    assert probs == sorted(probs, reverse=True)
    assert res["top1"] == res["topk"][0]["class_id"]
    if ref["topk"][0]["prob"] - ref["topk"][1]["prob"] > 2 * TOL_PROBS:
        assert res["top1"] == ref["top1"]
    assert all(e["class_name"] is None for e in res["topk"])


def test_fold_bn_and_arch_flags(tmp_path, frames_dir, checkpoint, capsys):
    """--fold-bn answers as the unfolded model (an exact composition in
    float32, so the features' own 2e-4); --arch reaches the model."""
    outs = [str(tmp_path / n) for n in ("a.npz", "b.npz", "c.npz")]
    base = ["--stream", "rgb", *MODEL, "--max-frames", "2", *CPU]
    with_ckpt = [*base, "--checkpoint", checkpoint]
    assert main(["extract-features", frames_dir, outs[0], *with_ckpt]) == 0
    assert main(["extract-features", frames_dir, outs[1], *with_ckpt,
                 "--fold-bn"]) == 0
    rc, res = run_cli(capsys, ["extract-features", frames_dir, outs[2], *base,
                               "--arch", "resnet50"])
    assert rc == 0 and res["rgb"] == [2, 256]
    a, b = (np.load(o)["rgb"] for o in outs[:2])
    assert np.abs(a).max() > 1e-3
    np.testing.assert_allclose(b, a, rtol=TOL_FEATURES, atol=TOL_FEATURES)
    # A checkpoint of another architecture is refused, not half loaded.
    with pytest.raises(ValueError, match="does not match the model"):
        main(["extract-features", frames_dir, outs[2], *with_ckpt, "--arch",
              "resnet50"])


def test_serve_loads_checkpoint(monkeypatch, capsys, tiny_clip, checkpoint):
    """serve --checkpoint answers with the probabilities classify-clip
    gives for the same clip and file, whatever --seed says."""
    args = [*MODEL, *ALGOS["farneback"], "--checkpoint", checkpoint,
            "--window", "4", "--topk", "5", *CPU]
    rc, one = run_cli(capsys, ["classify-clip", tiny_clip, *args])
    assert rc == 0
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        json.dumps({"path": tiny_clip, "id": 7}) + "\n"
        + json.dumps({"cmd": "shutdown"}) + "\n"))
    assert main(["serve", *args, "--seed", "5", "--raw"]) == 0
    lines = [json.loads(ln)
             for ln in capsys.readouterr().out.strip().splitlines()]
    served = next(ln for ln in lines if ln.get("id") == 7)
    got = {e["class_id"]: e["prob"] for e in served["topk"]}
    want = {e["class_id"]: e["prob"] for e in one["topk"]}
    for i in range(5):
        assert abs(got[i] - want[i]) <= 1e-6, (i, got, want)


def test_stage_commands_errors(tmp_path, tiny_clip, frames_dir, capsys,
                               monkeypatch):
    """Too few frames or stored flows and rgb features from a flow
    directory exit 2; a missing --spynet-checkpoint exits 1; the default
    device is CUDA and fails without a card."""
    out = str(tmp_path / "o.npz")
    small = [*MODEL, *CPU]
    assert main(["extract-features", tiny_clip, out, "--stream", "flow",
                 "--max-frames", "3", *small]) == 2
    flow_dir = tmp_path / "flowdir"
    flow_dir.mkdir()
    (flow_dir / "flow_x_000001.jpg").write_bytes(b"x")
    assert main(["extract-features", str(flow_dir), out, "--stream", "rgb",
                 *small]) == 2
    stored = str(tmp_path / "stored")
    assert main(["compute-flow", frames_dir, stored, "--algo", "farneback",
                 "--max-frames", "3", *CPU]) == 0
    assert main(["extract-features", stored, out, "--stream", "flow",
                 *small]) == 2
    missing = str(tmp_path / "missing.msgpack")
    for cmd in (["extract-features", tiny_clip, out, "--stream", "flow"],
                ["classify-clip", tiny_clip]):
        assert main([*cmd, "--algo", "spynet", "--spynet-checkpoint",
                     missing, *small]) == 1
    capsys.readouterr()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in (["extract-features", tiny_clip, out], ["classify-clip",
                                                       tiny_clip]):
        with pytest.raises(RuntimeError, match="is_available"):
            main([*cmd, *MODEL])


# -- the video arch: R(2+1)D-34 streams on clip volumes -----------------------

R2P1D = ["--arch", "r2plus1d_34", "--num-classes", "5", "--width", "4",
         "--resize-short", "36", "--crop", "32", "--window", "9",
         *ALGOS["farneback"]]


@pytest.fixture(scope="module")
def r2p1d_checkpoint(tmp_path_factory):
    """(path, model): a checkpoint of a small two-stream R(2+1)D-34 written
    from a seed, BatchNorm statistics away from 0 and 1."""
    from tests.test_torch_r2plus1d import seeded
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
    from video_analytics_tpu_torch.runtime.checkpoint import save_variables
    tm = TwoStreamModel.create(num_classes=5, width=4, arch="r2plus1d_34")
    seeded(tm.spatial, 21)
    seeded(tm.temporal, 22)
    path = str(tmp_path_factory.mktemp("r2p1d") / "two_stream.msgpack")
    save_variables(path, tm.flax_variables())
    return path, tm


def _plain_clip_probs(video, model, num_windows):
    """The plain pipeline's clip probabilities for `video` under R2P1D's
    flags: the command's windows and crop, then the reference model on
    the port's plain Farneback, Kinetics statistics, fusion 1 : 1."""
    from tests.test_torch_r2plus1d import plain_clip_probs, state
    from video_analytics_tpu_torch.cli.main import (
        _pipeline_config, build_parser)
    from video_analytics_tpu_torch.flow.farneback import farneback_sequence
    from video_analytics_tpu_torch.ops import preprocess as pp
    from video_analytics_tpu_torch.runtime.evaluate import load_clip_windows

    cfg = _pipeline_config(build_parser().parse_args(
        ["classify-clip", video, *R2P1D]))
    assert cfg.preprocess.mean == (0.43216, 0.394666, 0.37645)
    assert cfg.fusion_weights == (1.0, 1.0)
    wins, cfg = load_clip_windows(video, cfg, num_windows=num_windows)
    pre = cfg.preprocess
    x = pp.resize_short_center_crop(torch.from_numpy(wins), pre.resize_short,
                                    pre.crop, src_hw=pre.src_hw)
    with torch.no_grad():
        probs = plain_clip_probs(
            x, state(model.spatial), state(model.temporal), pre.mean,
            pre.std, pre.flow_bound, cfg.fusion_weights,
            lambda g: farneback_sequence(g, cfg.farneback, plain=True))
    return probs.mean(0).numpy()


def test_classify_clip_r2plus1d_34(tiny_clip, r2p1d_checkpoint, capsys):
    """--arch r2plus1d_34 answers as the plain pipeline on its
    checkpoint."""
    path, model = r2p1d_checkpoint
    rc, res = run_cli(capsys, ["classify-clip", tiny_clip, *R2P1D,
                               "--checkpoint", path, "--windows", "2",
                               "--topk", "5", *CPU])
    assert rc == 0
    got = {e["class_id"]: e["prob"] for e in res["topk"]}
    want = _plain_clip_probs(tiny_clip, model, 2)
    assert sorted(got) == list(range(5))
    for i in range(5):
        assert abs(got[i] - want[i]) <= 1e-5, (i, got, want)
    assert res["top1"] == int(np.argmax(want))


def test_eval_ucf101_batched_r2plus1d_34(tmp_path, r2p1d_checkpoint,
                                         capsys):
    """eval-ucf101 --batched --arch r2plus1d_34 counts as the clip-by-clip
    command, whose correct count is the plain pipeline's."""
    from video_analytics_tpu_torch.io.dataset import UCF101
    from video_analytics_tpu_torch.io.synthetic import build_synthetic_ucf101
    root = str(tmp_path / "ucf")
    build_synthetic_ucf101(root, num_classes=2, clips_per_class=2,
                           num_frames=14, h=96, w=128)
    path, model = r2p1d_checkpoint
    args = ["eval-ucf101", "--videos", f"{root}/videos", "--annotations",
            f"{root}/annotations", *R2P1D, "--checkpoint", path, *CPU]
    rc, batched = run_cli(capsys, [*args, "--batched", "--batch-clips", "2"])
    assert rc == 0 and batched["failed"] == 0 and batched["total"] >= 2
    rc, serial = run_cli(capsys, args)
    assert rc == 0 and serial == batched
    records = UCF101(videos_root=f"{root}/videos",
                     annotations_root=f"{root}/annotations").test_records()
    correct = sum(int(np.argmax(_plain_clip_probs(r.path, model, 1))
                      == r.label) for r in records)
    assert serial["correct"] == correct and serial["total"] == len(records)


# -- the video transformer: TimeSformer streams on clip volumes ---------------

TSF = ["--arch", "timesformer_base", "--num-classes", "5", "--width", "48",
       *ALGOS["farneback"]]


@pytest.fixture(scope="module")
def tsf_model():
    """The two-stream TimeSformer that the commands build from TSF's flags
    without --checkpoint: width 48 (12 heads of 4), 12 blocks, 8 frames
    at 224², weights from seed 0."""
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
    tm = TwoStreamModel.create(num_classes=5, width=48,
                               arch="timesformer_base")
    return tm.init(torch.Generator().manual_seed(0)).eval()


def _plain_tsf_probs(video, model, num_windows):
    """The plain pipeline's clip probabilities for `video` under TSF's
    flags: the arch's own windows and crop (9 frames, 224² from a short
    side of 224), then the reference model on the port's plain Farneback,
    statistics 0.45 / 0.225, fusion 1 : 1."""
    from tests.test_torch_timesformer import plain_clip_probs
    from video_analytics_tpu_torch.cli.main import (
        _pipeline_config, build_parser)
    from video_analytics_tpu_torch.flow.farneback import farneback_sequence
    from video_analytics_tpu_torch.ops import preprocess as pp
    from video_analytics_tpu_torch.runtime.evaluate import load_clip_windows

    cfg = _pipeline_config(build_parser().parse_args(
        ["classify-clip", video, *TSF]))
    pre = cfg.preprocess
    assert (pre.resize_short, pre.crop, cfg.window) == (224, 224, 9)
    assert pre.mean == (0.45,) * 3 and cfg.fusion_weights == (1.0, 1.0)
    wins, cfg = load_clip_windows(video, cfg, num_windows=num_windows)
    pre = cfg.preprocess
    x = pp.resize_short_center_crop(torch.from_numpy(wins), pre.resize_short,
                                    pre.crop, src_hw=pre.src_hw)
    with torch.no_grad():
        probs = plain_clip_probs(
            x, model.spatial.state_dict(), model.temporal.state_dict(),
            pre.mean, pre.std, pre.flow_bound, cfg.fusion_weights,
            lambda g: farneback_sequence(g, cfg.farneback, plain=True),
            heads=12)
    return probs.mean(0).numpy()


def test_classify_clip_timesformer_base(tiny_clip, tsf_model, capsys):
    """--arch timesformer_base answers as the plain pipeline on the
    weights of its seed."""
    rc, res = run_cli(capsys, ["classify-clip", tiny_clip, *TSF,
                               "--windows", "2", "--topk", "5", *CPU])
    assert rc == 0
    got = {e["class_id"]: e["prob"] for e in res["topk"]}
    want = _plain_tsf_probs(tiny_clip, tsf_model, 2)
    assert sorted(got) == list(range(5))
    for i in range(5):
        assert abs(got[i] - want[i]) <= 1e-5, (i, got, want)
    assert res["top1"] == int(np.argmax(want))


def test_eval_ucf101_batched_timesformer_base(tmp_path, tsf_model, capsys):
    """eval-ucf101 --batched --arch timesformer_base counts as the
    clip-by-clip command, whose correct count is the plain pipeline's."""
    from video_analytics_tpu_torch.io.dataset import UCF101
    from video_analytics_tpu_torch.io.synthetic import build_synthetic_ucf101
    root = str(tmp_path / "ucf")
    build_synthetic_ucf101(root, num_classes=2, clips_per_class=2,
                           num_frames=12, h=96, w=128)
    args = ["eval-ucf101", "--videos", f"{root}/videos", "--annotations",
            f"{root}/annotations", *TSF, *CPU]
    rc, batched = run_cli(capsys, [*args, "--batched", "--batch-clips", "2"])
    assert rc == 0 and batched["failed"] == 0 and batched["total"] >= 2
    rc, serial = run_cli(capsys, args)
    assert rc == 0 and serial == batched
    records = UCF101(videos_root=f"{root}/videos",
                     annotations_root=f"{root}/annotations").test_records()
    correct = sum(int(np.argmax(_plain_tsf_probs(r.path, tsf_model, 1))
                      == r.label) for r in records)
    assert serial["correct"] == correct and serial["total"] == len(records)


def test_fold_bn_checkpoint_and_convert_weights_refuse_timesformer(
        tiny_clip, tmp_path, capsys):
    """TimeSformer has no BatchNorm to fold and no layout in the JAX
    package's checkpoints: --fold-bn, --checkpoint and convert-weights
    refuse it with a message that names it."""
    for flag in (["--fold-bn"], ["--checkpoint", str(tmp_path / "x")]):
        with pytest.raises(ValueError, match="timesformer_base"):
            main(["classify-clip", tiny_clip, *TSF, *flag, *CPU])
    with pytest.raises(SystemExit):
        main(["convert-weights", str(tmp_path / "a.pth"),
              str(tmp_path / "b.msgpack"), "--arch", "timesformer_base"])
    assert "timesformer_base" in capsys.readouterr().err
