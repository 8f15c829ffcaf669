"""The port's command line on the CPU (``--device cpu``): extract-frames,
compute-flow and serve with Farneback, driven end to end on a synthetic
clip, in the pattern of tests/test_cli.py.  compute-flow is also held
against the JAX package's command at the native resolution
(``--no-bucket``): Farneback within 1e-4 end-point error, as in
tests/test_torch_farneback.py."""

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
    args = ["--algo", "farneback", "--max-frames", "4", "--batch", "2"]
    rc, res = run_cli(capsys, ["compute-flow", tiny_clip, ours_dir, *args,
                               *CPU])
    assert rc == 0 and res == {"flows": 3, "algo": "farneback",
                               "format": "flo", "out_dir": ours_dir}
    assert jax_main(["compute-flow", tiny_clip, ref_dir, *args,
                     "--no-bucket", "--exact"]) == 0
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


def test_compute_flow_errors(tmp_path, tiny_clip, capsys, monkeypatch):
    """< 2 frames and the unported algorithm exit 2; a missing file exits
    1; the default device is CUDA and fails without a card."""
    out = str(tmp_path / "x")
    assert main(["compute-flow", tiny_clip, out, "--max-frames", "1",
                 *CPU]) == 2
    assert main(["compute-flow", tiny_clip, out, "--algo", "spynet",
                 *CPU]) == 2
    assert main(["compute-flow", str(tmp_path / "missing.mp4"), out,
                 *CPU]) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        main(["compute-flow", tiny_clip, out, "--algo", "farneback"])


def test_compute_flow_cv2_param_surface(tmp_path, tiny_clip, capsys):
    """The --fb-* flags reach the algorithm.  The reference's --exact and
    --no-bucket choose between paths the port does not have (its warp is
    always the exact gather, its flow always at the native resolution):
    the parser refuses them."""
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
        with pytest.raises(SystemExit) as exc:
            main(["compute-flow", tiny_clip, d3, *base, flag])
        assert exc.value.code == 2
    capsys.readouterr()


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
